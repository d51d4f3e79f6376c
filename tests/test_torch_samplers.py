"""The port's single-expert and DDPM samplers, its SNR time map, its
per-expert conversions and fusion helpers, and its engine resolution,
against the JAX package on the CPU.

Inputs are seeded numpy arrays (or JAX PRNG draws through ``np.asarray``)
handed to both packages; the samplers run jittered reduced DiT experts
(``tests/test_torch_dit.py``'s parameters) from the noise the JAX sampler
draws.

Tolerances, each with its reason:

* ``snr_matched_time``: bitwise, except where one bisection compare
  went the other way, with every timestep row ``round(999·t')`` equal.
  The 40-step bisection compares ``log`` of ``cos``/``sin`` ratios, and
  PyTorch's and XLA's ``log``, ``cos`` and ``sin`` each differ by up to
  one ulp (measured on 1e5 float32 inputs), so a compare within a few
  ulps of the root can flip.  The result ``0.5·(lo+hi)`` of the final
  adjacent pair rounds to the even float, so a flip moves it by exactly
  2 ulps and 1 ulp cannot occur; the test asserts all of that, and that
  the float between the two answers lies within ``8·eps`` of the root
  in float64 (measured: at most 3.2·eps, against up to 39·eps at the
  answers themselves).  Measured: 13, 9 and 7 of the 257 points read 2
  ulps for linear→cosine, cosine→linear and cosine→cosine;
* conversions and fusion: float32 elementwise chains with those
  transcendentals in the schedule coefficients, ``rtol = atol = 1e-6``
  (relative to values of order 1–20);
* samplers: ``max |Δ| ≤ 1e-4 · max |latent|``, as the serving slice
  (float32 GEMMs in another order than XLA, CFG amplifying the branch
  difference over four steps);
* error messages: letter for letter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conversion as JC
from repro.core import fusion as jfus
from repro.core import sampling as JS
from repro.core import schedules as JSch
from repro.models import dit as JD
from repro.models.config import dit_b2 as j_dit_b2
from repro_torch.core import conversion as C
from repro_torch.core import fusion, sampling
from repro_torch.core import schedules as Sch
from repro_torch.models import dit as D
from repro_torch.models.config import dit_b2
from repro_torch.weights import params_from_numpy
from test_torch_dit import jittered_numpy_params
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

SLICE_REL = 1e-4
TOL = dict(rtol=1e-6, atol=1e-6)
B, STEPS = 2, 4


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("source,target", [("linear", "cosine"),
                                           ("cosine", "linear"),
                                           ("cosine", "cosine")])
def test_snr_matched_time_matches_jax(source, target):
    t = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    want = np.asarray(JSch.snr_matched_time(
        JSch.get_schedule(source), JSch.get_schedule(target),
        jnp.asarray(t)))
    got = Sch.snr_matched_time(Sch.get_schedule(source),
                               Sch.get_schedule(target),
                               torch.from_numpy(t)).numpy()
    assert got.dtype == want.dtype == np.float32
    # every answer is the even float of its final (lo, hi) pair
    assert not (got.view(np.int32) & 1).any()
    assert not (want.view(np.int32) & 1).any()
    ulps = _ulps(got, want)
    assert set(np.unique(ulps)) <= {0, 2}
    # where they differ, the compare at the float between them was within
    # float32 rounding of the root: a flipped compare, not a wrong root
    flip = np.nonzero(ulps)[0]
    between = ((got[flip].view(np.int32).astype(np.int64)
                + want[flip].view(np.int32)) // 2).astype(np.int32)
    between = torch.from_numpy(between.view(np.float32)).double()
    root = torch.log(Sch.get_schedule(source).snr(
        torch.from_numpy(t[flip]).double()) + 1e-20)
    at = torch.log(Sch.get_schedule(target).snr(between) + 1e-20)
    eps = float(np.finfo(np.float32).eps)
    assert bool(((at - root).abs()
                 <= 8 * eps * root.abs().clamp(min=1.0)).all())
    np.testing.assert_array_equal(
        Sch.to_ddpm_timestep(torch.from_numpy(got)).numpy(),
        np.asarray(JSch.to_ddpm_timestep(jnp.asarray(want))))
    idx = np.arange(0, 1000, 37)
    np.testing.assert_array_equal(
        Sch.from_ddpm_timestep(torch.from_numpy(idx)).numpy(),
        np.asarray(JSch.from_ddpm_timestep(idx)))


def _conv_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((5, 4, 4, 2)).astype(np.float32)
    pred = rng.standard_normal((5, 4, 4, 2)).astype(np.float32)
    t = np.float32([0.0, 0.05, 0.5, 0.9, 1.0])
    return x, pred, t


@pytest.mark.parametrize("objective", ["ddpm", "fm"])
@pytest.mark.parametrize("schedule", ["cosine", "linear"])
@pytest.mark.parametrize("derivative_mode", ["analytic", "fd"])
def test_unify_prediction_matches_jax(objective, schedule, derivative_mode):
    x, pred, t = _conv_inputs()
    want = np.asarray(JC.unify_prediction(
        jnp.asarray(pred), jnp.asarray(x), jnp.asarray(t),
        objective=objective, schedule=JSch.get_schedule(schedule),
        cfg=JC.ConversionConfig(derivative_mode=derivative_mode)))
    got = C.unify_prediction(
        torch.from_numpy(pred), torch.from_numpy(x), torch.from_numpy(t),
        objective=objective, schedule=Sch.get_schedule(schedule),
        cfg=C.ConversionConfig(derivative_mode=derivative_mode)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="unknown objective"):
        C.unify_prediction(torch.from_numpy(pred), torch.from_numpy(x),
                           torch.from_numpy(t), objective="x",
                           schedule=Sch.get_schedule(schedule))


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_velocity_to_x0_matches_jax(schedule):
    x, v, t = _conv_inputs(1)
    want = np.asarray(JC.velocity_to_x0(jnp.asarray(x), jnp.asarray(v),
                                        JSch.get_schedule(schedule),
                                        jnp.asarray(t)))
    got = C.velocity_to_x0(torch.from_numpy(x), torch.from_numpy(v),
                           Sch.get_schedule(schedule),
                           torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _toy_apply(xp):
    """A native prediction that depends on the input and the time it is
    queried at, written for either package."""
    def apply_fn(p, x, t, **cond):
        tt = xp.reshape(t, (-1, 1, 1, 1))
        return p["a"] * x + tt * p["b"] + cond.get("bias", 0.0)
    return apply_fn


@pytest.mark.parametrize("objective,schedule", [("ddpm", "cosine"),
                                                ("fm", "cosine"),
                                                ("fm", "linear")])
def test_snr_rebased_velocity_matches_jax(objective, schedule):
    x, b, t = _conv_inputs(2)
    t = np.float32([0.02, 0.3, 0.5, 0.8, 0.97])
    want = np.asarray(JC.snr_rebased_velocity(
        _toy_apply(jnp), {"a": 0.7, "b": jnp.asarray(b)}, jnp.asarray(x),
        jnp.asarray(t), objective=objective,
        expert_schedule=JSch.get_schedule(schedule),
        path_schedule=JSch.get_schedule("linear"),
        cond={"bias": 0.25}))
    got = C.snr_rebased_velocity(
        _toy_apply(torch), {"a": 0.7, "b": torch.from_numpy(b)},
        torch.from_numpy(x), torch.from_numpy(t), objective=objective,
        expert_schedule=Sch.get_schedule(schedule),
        path_schedule=Sch.get_schedule("linear"),
        cond={"bias": 0.25}).numpy()
    # t' within 2 ulps moves the schedule coefficients by ~1e-7 relative
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 8])
def test_threshold_router_weights_match_jax(k):
    t = np.float32([0.0, 0.3, 0.5, np.nextafter(np.float32(0.5), 1),
                    0.75, 1.0])
    for thr in (0.5, 0.3):
        want = np.asarray(jfus.threshold_router_weights(jnp.asarray(t), k,
                                                        threshold=thr))
        got = fusion.threshold_router_weights(torch.from_numpy(t), k,
                                              threshold=thr).numpy()
        np.testing.assert_array_equal(got, want)
    # a scalar time gives one row
    np.testing.assert_array_equal(
        fusion.threshold_router_weights(torch.tensor(0.9), k).numpy(),
        np.asarray(jfus.threshold_router_weights(jnp.float32(0.9), k)))


def test_fuse_predictions_and_conflict_match_jax():
    rng = np.random.default_rng(4)
    preds = rng.standard_normal((8, 3, 4, 4, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (3, 8)).astype(np.float32)
    w[0, 3:] = 0.0
    w /= w.sum(-1, keepdims=True)
    for fn, jfn in ((fusion.fuse_predictions, jfus.fuse_predictions),
                    (fusion.prediction_conflict, jfus.prediction_conflict)):
        got = fn(torch.from_numpy(preds), torch.from_numpy(w)).numpy()
        want = np.asarray(jfn(jnp.asarray(preds), jnp.asarray(w)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def test_threshold_fusion_weights_need_no_router():
    t = np.float32([0.2, 0.8])
    specs = [fusion.ExpertSpec(name=f"e{i}", objective="fm",
                               schedule="linear", apply_fn=None)
             for i in range(3)]
    jspecs = [jfus.ExpertSpec(name=f"e{i}", objective="fm",
                              schedule="linear", apply_fn=None)
              for i in range(3)]
    for gate in (0.0, 0.5):
        got = fusion.fusion_weights(
            specs, None, torch.zeros(2, 1), torch.from_numpy(t),
            strategy="threshold", threshold=0.4,
            ddpm_low_noise_only=gate).numpy()
        want = np.asarray(jfus.fusion_weights(
            jspecs, None, jnp.zeros((2, 1)), jnp.asarray(t),
            strategy="threshold", threshold=0.4,
            ddpm_low_noise_only=gate))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Samplers over a reduced DiT expert
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def expert():
    cfg = dit_b2().reduced(latent_size=8)
    params = jittered_numpy_params(cfg, 5)
    text = np.random.default_rng(6).standard_normal(
        (B, cfg.text_len, cfg.text_dim)).astype(np.float32)
    return dict(cfg=cfg, jcfg=j_dit_b2().reduced(latent_size=8),
                params=params_from_numpy(params, "cpu"),
                jparams=jax.tree.map(jnp.asarray, params), text=text)


def _assert_close(got, want):
    assert got.shape == want.shape == (B, 8, 8, 4)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= SLICE_REL * np.abs(want).max(), (err, np.abs(want).max())


def _conds(ex, with_cfg, xp):
    if not with_cfg:
        return None, None
    text = torch.from_numpy(ex["text"]) if xp is torch else \
        jnp.asarray(ex["text"])
    return {"text_emb": text}, {"text_emb": None}


@pytest.mark.parametrize("objective,schedule", [("fm", "linear"),
                                                ("ddpm", "cosine")])
def test_sample_single_expert_matches_jax(expert, objective, schedule):
    """The dense engine over one expert (Table 3's single-expert rows),
    CFG 7.5 with text, from the noise the JAX sampler draws."""
    key = jax.random.PRNGKey(21)
    shape = (B, 8, 8, 4)
    jspec = jfus.ExpertSpec(name="e", objective=objective,
                            schedule=schedule,
                            apply_fn=JD.make_expert_apply(expert["jcfg"]))
    spec = fusion.ExpertSpec(name="e", objective=objective,
                             schedule=schedule,
                             apply_fn=D.make_expert_apply(expert["cfg"]))
    jcond, jnull = _conds(expert, True, jnp)
    want = np.asarray(JS.sample_single_expert(
        key, jspec, expert["jparams"], shape, cond=jcond, null_cond=jnull,
        config=JS.SamplerConfig(num_steps=STEPS, cfg_scale=7.5)))
    cond, null = _conds(expert, True, torch)
    noise = np.array(jax.random.normal(key, shape, dtype=jnp.float32))
    got = sampling.sample_single_expert(
        spec, expert["params"], shape, cond=cond, null_cond=null,
        config=sampling.SamplerConfig(num_steps=STEPS, cfg_scale=7.5),
        init_noise=torch.from_numpy(noise)).numpy()
    _assert_close(got, want)


@pytest.mark.parametrize("with_cfg", [True, False], ids=["cfg6", "nocfg"])
def test_sample_ddpm_ancestral_matches_jax(expert, with_cfg):
    key = jax.random.PRNGKey(22)
    shape = (B, 8, 8, 4)
    jcond, jnull = _conds(expert, with_cfg, jnp)
    want = np.asarray(JS.sample_ddpm_ancestral(
        key, JD.make_expert_apply(expert["jcfg"]), expert["jparams"], shape,
        cond=jcond, null_cond=jnull, num_steps=STEPS))
    cond, null = _conds(expert, with_cfg, torch)
    noise = np.array(jax.random.normal(key, shape, dtype=jnp.float32))
    got = sampling.sample_ddpm_ancestral(
        D.make_expert_apply(expert["cfg"]), expert["params"], shape,
        init_noise=torch.from_numpy(noise), cond=cond, null_cond=null,
        num_steps=STEPS).numpy()
    _assert_close(got, want)
    with pytest.raises(ValueError, match="generator= or init_noise="):
        sampling.sample_ddpm_ancestral(D.make_expert_apply(expert["cfg"]),
                                       expert["params"], shape)


# ---------------------------------------------------------------------------
# Engine resolution
# ---------------------------------------------------------------------------


def _specs(mod, n, shared=True):
    fns = [lambda *a: None] * n if shared else \
        [(lambda i: lambda *a: i)(i) for i in range(n)]
    return [mod.ExpertSpec(name=f"e{i}", objective="fm", schedule="linear",
                           apply_fn=fns[i]) for i in range(n)]


@pytest.mark.parametrize("engine,override,n,shared", [
    ("nope", {}, 2, True),
    ("reference", dict(dispatch="grouped"), 2, True),
    ("reference", dict(plan_refresh_every=2), 2, True),
    ("routed", dict(time_map="snr_match"), 2, True),
    ("auto", dict(time_map="snr_match", dispatch="ragged"), 2, True),
    ("auto", dict(time_map="snr_match", plan_refresh_every=3), 2, True),
    ("routed", dict(strategy="full"), 2, True),
    ("routed", {}, 1, True),
    ("routed", {}, 3, False),
], ids=["unknown", "reference_dispatch", "reference_R2", "snr_routed",
        "snr_dispatch", "snr_R3", "routed_full", "routed_one",
        "routed_hetero"])
def test_resolve_engine_errors_match_the_reference(engine, override, n,
                                                   shared):
    with pytest.raises(ValueError) as jerr:
        JS._resolve_engine(engine, _specs(jfus, n, shared), None,
                           JS.SamplerConfig(**override))
    with pytest.raises(ValueError) as err:
        sampling._resolve_engine(engine, _specs(fusion, n, shared), None,
                                 sampling.SamplerConfig(**override))
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("engine,override,n,shared,want", [
    ("auto", {}, 2, True, "routed"),
    ("auto", dict(strategy="full"), 2, True, "dense"),
    ("auto", dict(strategy="threshold"), 3, False, "routed"),
    ("auto", {}, 3, False, "dense"),
    ("auto", {}, 1, True, "dense"),
    ("auto", dict(time_map="snr_match"), 2, True, "reference"),
    ("dense", {}, 2, True, "dense"),
    ("reference", dict(strategy="threshold"), 2, True, "reference"),
])
def test_resolve_engine_modes_match_the_reference(engine, override, n,
                                                  shared, want):
    assert JS._resolve_engine(engine, _specs(jfus, n, shared), None,
                              JS.SamplerConfig(**override)) == want
    assert sampling._resolve_engine(engine, _specs(fusion, n, shared), None,
                                    sampling.SamplerConfig(**override)) \
        == want


def test_store_only_reference_engine_raises_as_the_reference():
    shape = (1, 2, 2, 1)
    with pytest.raises(ValueError) as jerr:
        JS.sample_ensemble(jax.random.PRNGKey(0), _specs(jfus, 2), None,
                           None, shape, engine="reference")
    with pytest.raises(ValueError) as err:
        sampling.sample_ensemble(_specs(fusion, 2), None, None, shape,
                                 engine="reference",
                                 init_noise=torch.zeros(shape))
    assert str(err.value) == str(jerr.value)


def test_params_are_stackable_matches_the_reference():
    a = {"w": np.zeros((2, 3), np.float32), "b": [np.zeros(3, np.float32)]}
    cases = [
        [a, a],
        [a, {"w": np.zeros((2, 4), np.float32),
             "b": [np.zeros(3, np.float32)]}],
        [a, {"w": np.zeros((2, 3), np.int32),
             "b": [np.zeros(3, np.float32)]}],
        [a, {"w": np.zeros((2, 3), np.float32)}],
        [a],
    ]
    for params in cases:
        got = sampling.params_are_stackable(
            [params_from_numpy(p, "cpu") for p in params])
        assert got == JS.params_are_stackable(params)
