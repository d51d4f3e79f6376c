"""The port's unfused step path (``step_fused=False``: the velocity kernel,
``cfg_combine`` and ``x − u·dt``) and its two-pass CFG
(``batched_cfg=False``) against the JAX package's, on the CPU.

The same numpy inputs, drawn from a seed, go through the JAX kernel (in
Pallas interpret mode) or the JAX engine and through the port.

Tolerances:

* ``hetero_fuse_coeffs`` — elementwise float32 with a K-term sum, where
  XLA may contract ``a·b + c`` into one FMA and PyTorch does not:
  ``max |Δ| ≤ 1e-6 · max |out|``;
* the slice (4 steps, CFG 7.5) — float32 GEMMs summed in another order,
  amplified by CFG: ``max |Δ| ≤ 1e-4 · max|latent|``, as the fused path;
* the port's unfused path against its own fused path: bitwise.  The
  fused kernel's plain version runs the same ops in the same order, and
  on the card both kernels are built without FMA contraction.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as jsampling
from repro.core.sampling import SamplerConfig as JSamplerConfig
from repro.kernels import ops as jops
from repro.kernels.hetero_fuse import hetero_fuse_coeffs as j_coeffs
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro.training import checkpoint as jckpt
from repro_torch.core import sampling
from repro_torch.core.sampling import SamplerConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import dit as D
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.tree import tree_map
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

COEFFS_REL = 1e-6
SLICE_REL = 1e-4
BATCH, STEPS = 4, 4
MIX = [("ddpm", "cosine")] * 2 + [("fm", "linear")] * 6


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_rel(got, want, rel):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _coeffs_inputs(k, b, t, seed):
    rng = np.random.default_rng(seed)
    preds = (4.0 * rng.standard_normal((k, b, t))).astype(np.float32)
    x = (3.0 * rng.standard_normal((b, t))).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (b, k)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    coef = rng.uniform(-1.5, 1.5, (5, k, b)).astype(np.float32)
    coef[0, 0] = 0.001            # alpha below alpha_min: the safe floor
    coef[1, 0] = 1.0              # with x/alpha large: the ±clamp bites
    if k > 1:
        coef[:, 1] = np.array([1, 0, 0, 1, 1], np.float32)[:, None]  # FM
    return preds, x, w, coef


@pytest.mark.parametrize("k,b,t", [(2, 3, 256), (1, 4, 1024), (3, 2, 2048),
                                   (8, 3, 512)])
def test_ref_hetero_fuse_coeffs_matches_jax_kernel(k, b, t):
    preds, x, w, coef = _coeffs_inputs(k, b, t, seed=k + b)
    kw = dict(clamp=20.0, alpha_min=0.01)
    want = np.asarray(j_coeffs(*(jnp.asarray(a) for a in (preds, x, w, coef)),
                               interpret=True, **kw))
    got = ref.ref_hetero_fuse_coeffs(*(_t(a) for a in (preds, x, w, coef)),
                                     **kw).numpy()
    x0 = (x[None] - coef[1, 0, :, None] * preds[0]) / 0.01
    assert (np.abs(x0) > 20.0).any()          # the clamp is exercised
    assert_rel(got, want, COEFFS_REL)


def test_fused_velocity_matches_jax_ops(monkeypatch):
    """The wrapper's latent reshapes: ``(K, B, H, W, C)`` predictions."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    rng = np.random.default_rng(2)
    k, b, lat = 2, 4, (4, 4, 4)
    preds = rng.standard_normal((k, b) + lat).astype(np.float32)
    x = rng.standard_normal((b,) + lat).astype(np.float32)
    w = rng.uniform(0, 1, (b, k)).astype(np.float32)
    coef = rng.uniform(0.05, 1.5, (5, k, b)).astype(np.float32)
    want = np.asarray(jops.fused_velocity(
        *(jnp.asarray(a) for a in (preds, x, w, coef)), clamp=20.0,
        alpha_min=0.01))
    got = ops.fused_velocity(*(_t(a) for a in (preds, x, w, coef)),
                             clamp=20.0, alpha_min=0.01)
    assert got.shape == x.shape
    assert_rel(got.numpy(), want, COEFFS_REL)


def test_unfused_chain_is_the_fused_step_bitwise():
    """``fused_velocity`` → ``cfg_combine`` → ``x − u·dt`` equals the
    step-fused op exactly, for the batched layout ``[cond; uncond]``."""
    preds, _, w, coef = _coeffs_inputs(2, 6, 512, seed=5)
    x = _t(np.random.default_rng(6).standard_normal((3, 512)).astype(
        np.float32))
    preds, w, coef = _t(preds), _t(w), _t(coef)
    dt = torch.tensor(0.125)
    u = ops.fused_velocity(preds, torch.cat([x, x]), w, coef)
    chain = x - sampling.cfg_combine(u[:3], u[3:], 7.5) * dt
    fused = ops.fused_step(preds, x, w, coef, dt, g=2, cfg_scale=7.5)
    assert torch.equal(chain, fused)
    want = np.asarray(jsampling.cfg_combine(
        jnp.asarray(u[:3].numpy()), jnp.asarray(u[3:].numpy()), 7.5))
    np.testing.assert_array_equal(
        sampling.cfg_combine(u[:3], u[3:], 7.5).numpy(), want)


# ---------------------------------------------------------------------------
# The serving slice
# ---------------------------------------------------------------------------


def _numpy_params(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    return tree_map(
        lambda a: (a + 0.02 * torch.randn(a.shape, generator=gen)).numpy(),
        D.init(cfg, gen))


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("unfused_ensemble"))
    cfg = dit_b2().reduced(latent_size=8)
    rcfg = router_b2(num_clusters=8).reduced(latent_size=8)
    for i, (obj, sched) in enumerate(MIX):
        jckpt.save_checkpoint(
            os.path.join(path, f"expert{i}.npz"), _numpy_params(cfg, i),
            metadata=jckpt.expert_metadata(
                name=f"e{i}", objective=obj, schedule=sched, cluster_id=i,
                arch=cfg.name))
    jckpt.save_checkpoint(os.path.join(path, "router.npz"),
                          _numpy_params(rcfg, 99), metadata={})
    key = jax.random.PRNGKey(3)
    return dict(
        path=path, key=key,
        text=np.random.default_rng(1).standard_normal(
            (BATCH, cfg.text_len, cfg.text_dim)).astype(np.float32),
        noise=np.asarray(jax.random.normal(key, (BATCH, 8, 8, 4),
                                           dtype=jnp.float32)))


def _jax_latents(ens, **kw):
    eng = JServingEngine.from_checkpoint_dir(
        ens["path"], dit_cfg=j_dit_b2().reduced(latent_size=8),
        router_cfg=j_router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=JSamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2,
                               **kw))
    return np.asarray(eng.generate(ens["key"], ens["text"], BATCH))


def _port_latents(ens, **kw):
    eng = ServingEngine.from_checkpoint_dir(
        ens["path"], dit_cfg=dit_b2().reduced(latent_size=8),
        router_cfg=router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=SamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2, **kw),
        device="cpu")
    out = eng.generate(0, ens["text"], BATCH, noise=ens["noise"])
    assert out.shape == (BATCH, 8, 8, 4) and torch.isfinite(out).all()
    return out.numpy()


@pytest.mark.parametrize("kw", [
    dict(step_fused=False), dict(batched_cfg=False),
    dict(batched_cfg=False, step_fused=False)],
    ids=["unfused", "two_pass_cfg", "two_pass_cfg_unfused"])
def test_engine_matches_jax_engine(ensemble, kw):
    want = _jax_latents(ensemble, **kw)
    got = _port_latents(ensemble, **kw)
    assert_rel(got, want, SLICE_REL)


@pytest.mark.parametrize("batched_cfg", [True, False],
                         ids=["batched_cfg", "two_pass_cfg"])
def test_unfused_engine_is_bitwise_the_fused_one(ensemble, batched_cfg):
    fused = _port_latents(ensemble, batched_cfg=batched_cfg)
    unfused = _port_latents(ensemble, batched_cfg=batched_cfg,
                            step_fused=False)
    np.testing.assert_array_equal(unfused, fused)
