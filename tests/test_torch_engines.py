"""The port's other strategies, engines and executors against the JAX
package's serving engine, on the CPU.

Both engines load the ensemble of ``tests/test_torch_serve.py`` (eight
jittered reduced DiT experts, 2 DDPM + 6 FM, and a router, written by the
JAX package's ``save_checkpoint``) and serve one request: the same text
and the exact noise the JAX engine draws.  CFG 7.5, batch 4, 4 Euler
steps.  The paths:

* ``full`` — ``strategy='full'``, which resolves to the dense engine
  (every expert, the dense executor, all eight slots fused);
* ``dense_topk`` — ``engine='dense'`` with top-2 weights: every expert
  runs, the unrouted slots weigh exactly 0;
* ``threshold`` / ``threshold_int8`` — the §3.3 two-expert router, a
  batch-uniform plan through the gathered executor, from the native and
  the int8 store;
* ``reference`` — the per-expert two-pass engine, top-2;
* ``snr_match`` — ``time_map='snr_match'`` (the reference engine with the
  DDPM experts queried at SNR-matched times);
* ``grouped`` / ``gathered`` — top-2 through those executors.

Each runs with the step-fused kernel and with ``step_fused=False``; the
JAX engine's two forms are bit-identical, so both port forms are held to
its step-fused latents.

Tolerance: ``max |Δ| ≤ 1e-4 · max |latent|``, as in
``test_torch_serve.py`` (float32 GEMMs summed in another order than XLA,
amplified by CFG 7.5 over four steps; observed 2e-6 to 4e-6).  The int8
threshold path is held to the same bound, not the quantized ragged
slice's 5e-3: the gathered executor expands the int8 store (bitwise the
reference's) and runs the float32 dense forward, so no activation is
quantized and no rounding can flip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.sampling import SamplerConfig as JSamplerConfig
from repro.launch.serve import ServingEngine as JServingEngine
from repro.models.config import dit_b2 as j_dit_b2
from repro.models.config import router_b2 as j_router_b2
from repro_torch.core.sampling import SamplerConfig
from repro_torch.launch.serve import ServingEngine
from repro_torch.models.config import dit_b2, router_b2
from test_torch_serve import (  # noqa: F401  (one_torch_thread: a fixture)
    BATCH, SLICE_REL, STEPS, _write_ensemble, one_torch_thread)

#: path -> (sampler overrides, engine, param_dtype)
PATHS = {
    "full": (dict(strategy="full"), "auto", "native"),
    "dense_topk": ({}, "dense", "native"),
    "threshold": (dict(strategy="threshold"), "auto", "native"),
    "threshold_int8": (dict(strategy="threshold"), "auto", "int8"),
    "reference": ({}, "reference", "native"),
    "snr_match": (dict(time_map="snr_match"), "auto", "native"),
    "grouped": (dict(dispatch="grouped"), "auto", "native"),
    "gathered": (dict(dispatch="gathered"), "auto", "native"),
}
KEY_SEED = 11


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("engines"))
    cfg = dit_b2().reduced(latent_size=8)
    _write_ensemble(path, cfg, router_b2(num_clusters=8).reduced(
        latent_size=8))
    text = np.random.default_rng(3).standard_normal(
        (BATCH, cfg.text_len, cfg.text_dim)).astype(np.float32)
    key = jax.random.PRNGKey(KEY_SEED)
    noise = np.asarray(jax.random.normal(key, (BATCH, 8, 8, 4),
                                         dtype=jnp.float32))
    return dict(path=path, text=text, key=key, noise=noise, jax={},
                port={})


def _sampler_kw(name, **extra):
    override, _, param_dtype = PATHS[name]
    return dict(num_steps=STEPS, cfg_scale=7.5, top_k=2,
                param_dtype=param_dtype, **override, **extra)


def _jax_engine(ens, name, **kw):
    return JServingEngine.from_checkpoint_dir(
        ens["path"], dit_cfg=j_dit_b2().reduced(latent_size=8),
        router_cfg=j_router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=JSamplerConfig(**_sampler_kw(name)), engine=PATHS[name][1],
        **kw)


def _port_engine(ens, name, step_fused=True, **kw):
    return ServingEngine.from_checkpoint_dir(
        ens["path"], dit_cfg=dit_b2().reduced(latent_size=8),
        router_cfg=router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=SamplerConfig(**_sampler_kw(name, step_fused=step_fused)),
        engine=PATHS[name][1], device="cpu", **kw)


def _jax_run(ens, name):
    """The JAX engine of the path (counting its rows) and the latents of
    its one request, computed once per module."""
    if name not in ens["jax"]:
        eng = _jax_engine(ens, name, track_padding=True)
        out = np.asarray(eng.generate(ens["key"], ens["text"], BATCH))
        ens["jax"][name] = eng, out
    return ens["jax"][name]


def _jax_latents(ens, name):
    return _jax_run(ens, name)[1]


def _port_latents(ens, name, step_fused=True):
    if (name, step_fused) not in ens["port"]:
        eng = _port_engine(ens, name, step_fused)
        ens["port"][name, step_fused] = eng.generate(
            0, ens["text"], BATCH, noise=ens["noise"]).numpy()
    return ens["port"][name, step_fused]


def _assert_close(got, want, rel=SLICE_REL):
    assert got.shape == want.shape == (BATCH, 8, 8, 4)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("step_fused", [True, False],
                         ids=["fused", "unfused"])
@pytest.mark.parametrize("name", list(PATHS))
def test_engine_path_matches_jax_engine(ensemble, name, step_fused):
    _assert_close(_port_latents(ensemble, name, step_fused),
                  _jax_latents(ensemble, name))


def test_paths_of_one_function_agree_and_the_others_differ(ensemble):
    """``dense_topk``, ``grouped``, ``gathered`` and ``reference`` compute
    the native top-2 request's function (the routed ragged path); ``full``,
    ``threshold`` and ``snr_match`` compute others, and differ from it by
    far more than the tolerance."""
    eng = ServingEngine.from_checkpoint_dir(
        ensemble["path"], dit_cfg=dit_b2().reduced(latent_size=8),
        router_cfg=router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=SamplerConfig(num_steps=STEPS, cfg_scale=7.5, top_k=2),
        device="cpu")
    native = eng.generate(0, ensemble["text"], BATCH,
                          noise=ensemble["noise"]).numpy()
    for name in ("dense_topk", "grouped", "gathered", "reference"):
        _assert_close(_port_latents(ensemble, name), native)
    for name in ("full", "threshold", "snr_match"):
        err = np.abs(_port_latents(ensemble, name) - native).max()
        assert err > 100 * SLICE_REL * np.abs(native).max(), name
    # the int8 store moves the threshold path (its DDPM experts' ε→v
    # conversion at t near 1 divides by alpha_min = 0.01, so the
    # quantization error grows to O(1) there)
    assert not np.array_equal(_port_latents(ensemble, "threshold_int8"),
                              _port_latents(ensemble, "threshold"))


#: executed rows a step of one request: the dense engines run every
#: expert over ``g·B`` rows (the reference engine over ``B`` rows per CFG
#: branch); the threshold plan runs one expert over ``g·B``; the gathered
#: executor each routed expert over exactly its segment, the routed rows.
#: The grouped executor's rows depend on the plans (see the test).
EXECUTED_PER_STEP = {"full": 8 * 2 * BATCH, "dense_topk": 8 * 2 * BATCH,
                     "reference": 8 * 2 * BATCH, "snr_match": 8 * 2 * BATCH,
                     "threshold": 2 * BATCH, "threshold_int8": 2 * BATCH,
                     "gathered": 2 * 2 * BATCH}


def _next_pow2(n):
    return 1 << max(n - 1, 0).bit_length()


@pytest.mark.parametrize("name", list(PATHS))
def test_padding_stats_count_executed_rows(ensemble, name, monkeypatch):
    """``track_padding`` counts the rows every expert forward runs against
    the rows the plans route; for the grouped executor that is each
    non-empty segment rounded up to its power-of-two bucket, computed
    here from the step's plan.

    The routed rows equal the JAX engine's.  Its executed rows are not a
    reference here: its counter adds from ``jax.debug.callback``s that
    XLA may run concurrently (observed: 60 or 63 rows a step where 64
    run, varying from run to run, on the dense and reference engines),
    and under the gathered executor's ``vmap`` a callback fires once per
    vmapped call, counting ``g`` rows for ``B`` lanes.
    """
    jeng, _ = _jax_run(ensemble, name)
    plans = []
    if name == "grouped":
        from repro_torch.core import sampling

        def recording(w, k, **kw):
            plans.append(make_plan(w, k, **kw))
            return plans[-1]

        make_plan = sampling.make_dispatch_plan
        monkeypatch.setattr(sampling, "make_dispatch_plan", recording)
    eng = _port_engine(ensemble, name, track_padding=True)
    eng.generate(0, ensemble["text"], BATCH, noise=ensemble["noise"])
    got = eng.padding_stats()
    assert got["routed_rows_per_step"] == \
        jeng.padding_stats()["routed_rows_per_step"]
    if name == "grouped":
        g = 2
        want = sum(_next_pow2(g * int(c))
                   for p in plans for c in p.slot_idx.reshape(-1).bincount(
                       minlength=8) if c) / STEPS
        assert len(plans) == STEPS
        assert 2 * 2 * BATCH <= want < 2 * 2 * 2 * BATCH
    else:
        want = EXECUTED_PER_STEP[name]
    assert got["padded_rows_per_step"] == want
    assert got["padding_overhead"] == \
        want / got["routed_rows_per_step"] - 1.0


@pytest.mark.parametrize("override,engine", [
    (dict(strategy="full"), "auto"),
    ({}, "dense"),
    ({}, "reference"),
], ids=["full", "dense", "reference"])
def test_quantized_store_refuses_the_dense_engines(ensemble, override,
                                                   engine):
    """The dense and reference engines run from the per-expert list, which
    a quantized store replaces: the reference's ``ValueError``, letter for
    letter."""
    kw = dict(num_steps=STEPS, **override)
    with pytest.raises(ValueError) as jerr:
        JServingEngine.from_checkpoint_dir(
            ensemble["path"], dit_cfg=j_dit_b2().reduced(latent_size=8),
            router_cfg=j_router_b2(num_clusters=8).reduced(latent_size=8),
            sampler=JSamplerConfig(**kw), engine=engine,
            param_dtype="int8")
    with pytest.raises(ValueError) as err:
        ServingEngine.from_checkpoint_dir(
            ensemble["path"], dit_cfg=dit_b2().reduced(latent_size=8),
            router_cfg=router_b2(num_clusters=8).reduced(latent_size=8),
            sampler=SamplerConfig(**kw), engine=engine,
            param_dtype="int8", device="cpu")
    assert str(err.value) == str(jerr.value)
