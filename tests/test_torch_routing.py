"""Routing options of the port's main path against the JAX package, on the
CPU: plan reuse (``plan_refresh_every``) and the §7.3 low-noise DDPM gate
(``ddpm_low_noise_only``).

The engines load the ensemble of ``tests/test_torch_serve.py`` (eight
jittered reduced DiT experts, 2 DDPM + 6 FM, and a router, written by the
JAX package's ``save_checkpoint``) and serve the same request: the same
text and the exact noise the JAX engine draws.  Top-2, CFG 7.5, batch 4,
4 Euler steps.

Tolerances: latents ``max |Δ| ≤ 1e-4 · max |latent|``, as in
``test_torch_serve.py`` (float32 GEMMs summed in another order than XLA,
amplified by CFG 7.5 and compounded over four steps).  Fusion weights
``1e-6`` absolute: the same float32 posterior goes through the same
top-k, product and renormalizing divide on both sides.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fusion as jfus
from repro.core.sampling import SamplerConfig as JSamplerConfig
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro_torch.core import dispatch, fusion, sampling
from repro_torch.core.sampling import SamplerConfig
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServingEngine
from repro_torch.models.config import dit_b2, router_b2
from test_torch_serve import (  # noqa: F401  (one_torch_thread: a fixture)
    BATCH, MIX, SLICE_REL, STEPS, _write_ensemble, one_torch_thread)

HETERO = [o for o, _ in MIX]


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("routing"))
    cfg = dit_b2().reduced(latent_size=8)
    _write_ensemble(path, cfg, router_b2(num_clusters=8).reduced(
        latent_size=8))
    text = np.random.default_rng(1).standard_normal(
        (BATCH, cfg.text_len, cfg.text_dim)).astype(np.float32)
    return dict(path=path, text=text)


def _engines(path, engine="auto", **sampler):
    """The JAX engine and the port's, both top-2, CFG 7.5, ``STEPS``."""
    kw = dict(num_steps=STEPS, cfg_scale=7.5, top_k=2, **sampler)
    jeng = JServingEngine.from_checkpoint_dir(
        path, dit_cfg=j_dit_b2().reduced(latent_size=8),
        router_cfg=j_router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=JSamplerConfig(**kw), engine=engine)
    eng = ServingEngine.from_checkpoint_dir(
        path, dit_cfg=dit_b2().reduced(latent_size=8),
        router_cfg=router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=SamplerConfig(**kw), engine=engine, device="cpu")
    return jeng, eng


def _served_pair(ensemble, seed, **sampler):
    """(JAX latents, port latents, port engine) of one request."""
    jeng, eng = _engines(ensemble["path"], **sampler)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jeng.generate(key, ensemble["text"], BATCH))
    noise = np.asarray(jax.random.normal(key, (BATCH, 8, 8, 4),
                                         dtype=jnp.float32))
    got = eng.generate(0, ensemble["text"], BATCH, noise=noise).numpy()
    return want, got, eng


def _assert_close(got, want):
    assert got.shape == want.shape == (BATCH, 8, 8, 4)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= SLICE_REL * np.abs(want).max(), (err, np.abs(want).max())


def _count_router_calls(eng) -> list:
    calls = []
    router = eng.router_fn

    def counted(x, t):
        calls.append(float(t[0]))
        return router(x, t)

    eng.router_fn = counted
    return calls


@pytest.mark.parametrize("refresh", [2, 3])
def test_plan_reuse_matches_jax_engine(ensemble, refresh):
    """The router runs on steps ``i % R == 0`` only, and the latents match
    the JAX engine's, whose scan carries the plan between refreshes."""
    jeng, eng = _engines(ensemble["path"], plan_refresh_every=refresh)
    calls = _count_router_calls(eng)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jeng.generate(key, ensemble["text"], BATCH))
    noise = np.asarray(jax.random.normal(key, (BATCH, 8, 8, 4),
                                         dtype=jnp.float32))
    got = eng.generate(0, ensemble["text"], BATCH, noise=noise).numpy()
    _assert_close(got, want)
    grid = sampling._time_grid(STEPS).tolist()
    assert calls == [grid[i] for i in range(0, STEPS, refresh)]
    assert eng.stats["plan_refreshes"] == jeng.stats["plan_refreshes"] \
        == -(-STEPS // refresh)


def test_plan_refresh_one_is_the_per_step_loop(ensemble):
    """R = 1 is the loop written out step by step — router, plan, routed
    predictions, one fused step kernel — bit for bit."""
    _, eng = _engines(ensemble["path"], plan_refresh_every=1)
    rng = np.random.default_rng(4)
    noise = torch.from_numpy(
        rng.standard_normal((BATCH, 8, 8, 4)).astype(np.float32))
    text = torch.from_numpy(ensemble["text"])
    got = eng.generate(0, ensemble["text"], BATCH, noise=noise.numpy())

    conv = eng.sampler.conversion
    ts = sampling._time_grid(STEPS)
    tables = sampling.coeff_tables_cached(
        tuple(HETERO), tuple(s for _, s in MIX), STEPS, conv)
    executor = dispatch.RaggedExecutor(eng.experts[0].ragged_apply_fn,
                                       eng.param_store, conv)
    cond_g = sampling._cfg_grouped_cond({"text_emb": text},
                                        {"text_emb": None}, BATCH)
    x = noise
    for i in range(STEPS):
        tb = ts[i].expand(BATCH)
        w = fusion.fusion_weights(eng.experts, eng.router_fn, x, tb,
                                  strategy="topk", top_k=2)
        plan = dispatch.make_dispatch_plan(w, 2)
        preds, w_all, idx = executor.predictions(plan, x, tb, cond_g, 2,
                                                 tables[i])
        x = ops.fused_step(preds, x, w_all,
                           dispatch.slot_coef(tables[i], idx),
                           ts[i] - ts[i + 1], g=2, cfg_scale=7.5,
                           clamp=conv.clamp, alpha_min=conv.alpha_min)
    assert torch.equal(got, x)


@pytest.mark.parametrize("override,engine", [
    (dict(plan_refresh_every=0), "auto"),
    (dict(plan_refresh_every=2, time_map="snr_match"), "auto"),
    (dict(plan_refresh_every=2), "reference"),
], ids=["R0", "R2_snr_match", "R2_reference_engine"])
def test_plan_reuse_errors_match_the_reference(ensemble, override, engine):
    """The reference's ``ValueError``, with its message, raised where the
    reference raises it: plan reuse refused by the engine resolution
    (``snr_match`` and the reference engine recompute routing every
    step), and ``R = 0`` refused by the fused engine."""
    jeng, eng = _engines(ensemble["path"], engine=engine, **override)
    with pytest.raises(ValueError) as jerr:
        jeng.generate(jax.random.PRNGKey(0), ensemble["text"], BATCH)
    with pytest.raises(ValueError) as err:
        eng.generate(0, ensemble["text"], BATCH)
    assert str(err.value) == str(jerr.value)


def _specs(mod, objectives):
    return [mod.ExpertSpec(name=f"e{i}", objective=o, schedule="linear",
                           apply_fn=None, cluster_id=i)
            for i, o in enumerate(objectives)]


@pytest.mark.parametrize("strategy,k", [("topk", 2), ("top1", 1),
                                        ("full", 8)])
@pytest.mark.parametrize("gate", [0.3, 0.7])
def test_ddpm_gate_fusion_weights_match_jax(gate, strategy, k):
    """Times on both sides of the gate and exactly at it; row 0 routes to
    the two DDPM experts only, so above the gate it keeps all-zero
    weights, as in the reference."""
    rng = np.random.default_rng(int(gate * 10))
    p = rng.uniform(0, 1, (7, 8)).astype(np.float32)
    p[0, :2] = 50.0
    p /= p.sum(-1, keepdims=True)
    t = np.float32([0.95, 0.9, gate, 0.5, 0.2, 0.0, 1.0])
    objectives = ["ddpm", "ddpm", "fm", "fm", "fm", "ddpm", "fm", "fm"]
    got = fusion.fusion_weights(
        _specs(fusion, objectives), lambda x, tt: torch.from_numpy(p),
        torch.zeros(7, 2), torch.from_numpy(t), strategy=strategy,
        top_k=k, ddpm_low_noise_only=gate).numpy()
    want = np.asarray(jfus.fusion_weights(
        _specs(jfus, objectives), lambda x, tt: jnp.asarray(p),
        jnp.zeros((7, 2)), jnp.asarray(t), strategy=strategy, top_k=k,
        ddpm_low_noise_only=gate))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ddpm = np.array([o == "ddpm" for o in objectives])
    assert (got[t > gate][:, ddpm] == 0).all()
    if strategy != "full":
        assert (got[0] == 0).all() and (want[0] == 0).all()


@pytest.mark.parametrize("refresh", [1, 2])
def test_gated_request_matches_jax_engine(ensemble, refresh):
    """``ddpm_low_noise_only = 0.5``: the DDPM experts drop out of the two
    high-noise steps (t = 1, 0.75), alone and with plan reuse."""
    want, got, _ = _served_pair(ensemble, 5, ddpm_low_noise_only=0.5,
                                plan_refresh_every=refresh)
    _assert_close(got, want)
    _, ungated, _ = _served_pair(ensemble, 5, plan_refresh_every=refresh)
    assert np.abs(got - ungated).max() > 1e-3      # the gate did something
