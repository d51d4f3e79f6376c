"""Parity of the port's schedules, conversion tables, routing and dispatch
with the JAX package, on the CPU.

Tolerances: the time grid, timestep indices, masks and plan permutations
must be equal; float32 tables built from ``sin``/``cos`` (whose libm
implementations differ by an ulp) are compared at ``rtol = 1e-6``,
``atol = 1e-7`` — except the §8.3.3 finite-difference derivatives, where
one ulp of ``cos`` near 1 (6e-8) divided by ``2h = 2e-4`` is 3e-4, so
they get ``atol = 6e-4`` (two ulps); fusion weights ``rtol = 1e-6``;
the toy samplers of both packages (every engine, the grouped executor,
the threshold and full strategies, ``snr_match``) ``max |Δ| ≤ 1e-5 ·
max |latent|``; ``resolve_dispatch``'s table: the same backend or the
same message.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import dispatch as jdisp
from repro.core import fusion as jfus
from repro.core import sampling as jsamp
from repro.core.conversion import ConversionConfig as JConv
from repro.core.conversion import unified_coeff_tables as j_tables
from repro.core.conversion import velocity_scale as j_vscale
from repro.core.sampling import _time_grid as j_time_grid
from repro.core.schedules import get_schedule as j_get_schedule
from repro.core.schedules import to_ddpm_timestep as j_to_ddpm
from repro_torch.core import dispatch, fusion, sampling
from repro_torch.core.conversion import ConversionConfig
from repro_torch.core.conversion import unified_coeff_tables, velocity_scale
from repro_torch.core.schedules import get_schedule, to_ddpm_timestep
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

TABLE_TOL = dict(rtol=1e-6, atol=1e-7)
FD_TOL = dict(rtol=1e-6, atol=6e-4)
HETERO = [("ddpm", "cosine")] * 2 + [("fm", "linear")] * 6


@pytest.mark.parametrize("steps", [1, 3, 4, 7, 8, 20, 25, 50, 75, 100, 250,
                                   1000])
def test_time_grid_is_byte_equal_to_jnp_linspace(steps):
    got = sampling._time_grid(steps).numpy()
    want = np.asarray(j_time_grid(steps))
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    # and so every step's timestep-table row agrees
    np.testing.assert_array_equal(
        to_ddpm_timestep(torch.from_numpy(got)).numpy(),
        np.asarray(j_to_ddpm(jnp.asarray(want))))


def test_to_ddpm_timestep_rounds_half_to_even():
    t = np.array([0.0, 0.5 / 999, 1.5 / 999, 2.5 / 999, 0.5, 1.0, 1.2, -0.1],
                 np.float32)
    got = to_ddpm_timestep(torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_to_ddpm(jnp.asarray(t))))
    ints = torch.tensor([-3, 5, 2000])
    np.testing.assert_array_equal(to_ddpm_timestep(ints).numpy(),
                                  [0, 5, 999])


@pytest.mark.parametrize("mode", ["piecewise", "sigmoid", "none"])
def test_velocity_scale_matches_jax(mode):
    t = np.concatenate([np.linspace(0, 1, 41, dtype=np.float32),
                        np.float32([0.6, 0.85])])
    np.testing.assert_allclose(
        velocity_scale(torch.from_numpy(t), mode).numpy(),
        np.asarray(j_vscale(jnp.asarray(t), mode)), **TABLE_TOL)


@pytest.mark.parametrize("steps", [4, 8, 50])
@pytest.mark.parametrize("derivative_mode", ["analytic", "fd"])
def test_unified_coeff_tables_match_jax(steps, derivative_mode):
    objs = [o for o, _ in HETERO]
    scheds = [s for _, s in HETERO]
    ts = np.array(j_time_grid(steps))[:-1]
    want = np.asarray(j_tables(objs, [j_get_schedule(s) for s in scheds],
                               jnp.asarray(ts),
                               JConv(derivative_mode=derivative_mode)))
    got = unified_coeff_tables(objs, [get_schedule(s) for s in scheds],
                               torch.from_numpy(ts),
                               ConversionConfig(
                                   derivative_mode=derivative_mode)).numpy()
    assert got.shape == want.shape == (steps, 5, 8)
    deriv_tol = TABLE_TOL if derivative_mode == "analytic" else FD_TOL
    np.testing.assert_allclose(got[:, :2], want[:, :2], **TABLE_TOL)
    np.testing.assert_allclose(got[:, 2:4], want[:, 2:4], **deriv_tol)
    np.testing.assert_allclose(got[:, 4], want[:, 4], **TABLE_TOL)
    # FM columns are exactly the identity coefficients
    np.testing.assert_array_equal(got[:, :, 2:],
                                  np.broadcast_to([[1], [0], [0], [1], [1]],
                                                  (steps, 5, 6)))


def _probs_with_ties(seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, (6, 8)).astype(np.float32)
    p[0, [1, 3, 6]] = 0.9          # three-way tie for the top two slots
    p[1, :] = 0.125                # all tied
    p[2, [0, 7]] = 0.95            # tie at the top, lowest index first
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_select_topk_ties_match_jax(k):
    p = _probs_with_ties()
    w, mask = fusion.select_topk(torch.from_numpy(p), k)
    jw, jmask = jfus.select_topk(jnp.asarray(p), k)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert (mask.sum(-1) == k).all()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)


def test_topk_slots_and_plan_match_jax():
    p = _probs_with_ties(1)
    w, _ = fusion.select_topk(torch.from_numpy(p), 2)
    jw, _ = jfus.select_topk(jnp.asarray(p), 2)
    idx, sw = dispatch.topk_slots(w, 2)
    jidx, jsw = jdisp.topk_slots(jw, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(sw.numpy(), np.asarray(jsw), rtol=1e-6)
    for g in (1, 2):
        plan = dispatch.tile_plan(dispatch.plan_from_slots(idx, sw, 8), g)
        jplan = jdisp.tile_plan(jdisp.plan_from_slots(jidx, jsw, 8), g)
        for name in ("slot_idx", "sort_order", "unsort_order",
                     "segment_offsets"):
            np.testing.assert_array_equal(
                getattr(plan, name).numpy(), np.asarray(getattr(jplan, name)),
                err_msg=name)


def test_plan_invariants():
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 5, (7, 3)))
    plan = dispatch.plan_from_slots(idx, torch.ones(7, 3), 5)
    off = plan.segment_offsets
    assert off[0] == 0 and off[-1] == 21
    assert (off[1:] >= off[:-1]).all()
    n = plan.num_assignments
    assert torch.equal(plan.sort_order[plan.unsort_order], torch.arange(n))
    flat = idx.reshape(-1)[plan.sort_order]
    for e in range(5):
        assert (flat[off[e]:off[e + 1]] == e).all()


def _spec(cid):
    return fusion.ExpertSpec(name=f"e{cid}", objective="fm",
                             schedule="linear", apply_fn=None,
                             cluster_id=cid)


def _jspec(cid):
    return jfus.ExpertSpec(name=f"e{cid}", objective="fm",
                           schedule="linear", apply_fn=None, cluster_id=cid)


@pytest.mark.parametrize("strategy,k", [("topk", 2), ("top1", 1),
                                        ("full", 2)])
@pytest.mark.parametrize("cids", [list(range(8)), [3, 1, 0, 2, 7, 6, 5, 4]],
                         ids=["positional", "permuted"])
def test_fusion_weights_match_jax(strategy, k, cids):
    p = _probs_with_ties(2)
    got = fusion.fusion_weights(
        [_spec(c) for c in cids], lambda x, t: torch.from_numpy(p),
        torch.zeros(6, 2), torch.zeros(6), strategy=strategy, top_k=k)
    want = jfus.fusion_weights(
        [_jspec(c) for c in cids], lambda x, t: jnp.asarray(p),
        jnp.zeros((6, 2)), jnp.zeros(6), strategy=strategy, top_k=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _toy_ragged_np(view, x_p, t_p, cond, pe, g, xp):
    """A ragged forward whose output identifies (pair, replica, expert):
    ``x·(e+1) + t + 10·j + text-sum`` — any permutation slip shows."""
    out = []
    for q in range(x_p.shape[0]):
        for j in range(g):
            out.append(x_p[q] * (view["scale"][pe[q]] + 1.0) + t_p[q]
                       + 10.0 * j + cond["text_emb"][q, j].sum())
    return xp.stack(out)


@pytest.mark.parametrize("g", [1, 2])
def test_ragged_executor_regrouping_matches_jax(g):
    rng = np.random.default_rng(g)
    b, k, kk = 5, 2, 4
    x = rng.standard_normal((b, 3, 3, 2)).astype(np.float32)
    tb = np.full((b,), 0.7, np.float32)
    text = rng.standard_normal((b, g, 4, 3)).astype(np.float32)
    idx = np.array([[2, 0], [1, 2], [3, 1], [2, 3], [0, 2]], np.int64)
    sw = rng.uniform(0, 1, (b, k)).astype(np.float32)
    scale = np.arange(kk, dtype=np.float32)

    def jfn(view, x_p, t_p, cond, pe, g_):
        return _toy_ragged_np(view, x_p, t_p, cond, pe, g_, jnp)

    def tfn(view, x_p, t_p, cond, pe, g_):
        return _toy_ragged_np(view, x_p, t_p, cond, pe, g_, torch)

    from repro.core.param_store import DenseStore as JDense
    jex = jdisp.RaggedExecutor(jfn, JDense.from_stacked(
        {"scale": jnp.asarray(scale)}), JConv())
    tex = dispatch.RaggedExecutor(tfn, dispatch.DenseStore.from_stacked(
        {"scale": torch.from_numpy(scale)}), ConversionConfig())
    jp, jw, ji = jex.predictions(
        jdisp.plan_from_slots(jnp.asarray(idx, jnp.int32), jnp.asarray(sw),
                              kk),
        jnp.asarray(x), jnp.asarray(tb), {"text_emb": jnp.asarray(text)}, g,
        None)
    tp, tw, ti = tex.predictions(
        dispatch.plan_from_slots(torch.from_numpy(idx), torch.from_numpy(sw),
                                 kk),
        torch.from_numpy(x), torch.from_numpy(tb),
        {"text_emb": torch.from_numpy(text)}, g, None)
    assert tp.shape == (k, g * b, 3, 3, 2)
    # float sums in another order: ulps; a permutation slip is O(1)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_resolve_dispatch_serves_ragged_only():
    """The whole rule table of ``resolve_dispatch`` against the
    reference's: every (dispatch, mode, stackable, uniform, ragged_ok)
    gives the same backend or the same ``ValueError`` message."""
    n = 0
    for args in itertools.product(
            dispatch.DISPATCH_BACKENDS + ("nope",), ("routed", "dense"),
            (True, False), (True, False), (True, False)):
        try:
            want = jdisp.resolve_dispatch(*args)
        except ValueError as e:
            with pytest.raises(ValueError) as err:
                dispatch.resolve_dispatch(*args)
            assert str(err.value) == str(e), args
        else:
            assert dispatch.resolve_dispatch(*args) == want, args
            n += 1
    assert n == 42                          # of 96 cases; 54 raise
    assert dispatch.resolve_dispatch("auto", "routed", True, False,
                                     True) == "ragged"


# ---------------------------------------------------------------------------
# Small samplers run by both packages: four toy experts (2 DDPM on the
# cosine schedule, 2 FM on the linear one) and a toy router, each a few
# elementwise ops written for either package.  Tolerance: float32 ops in
# the same order but for XLA's fusions and the sum over experts,
# ``max |Δ| ≤ 1e-5 · max |latent|``.
# ---------------------------------------------------------------------------

TOY_MIX = [("ddpm", "cosine")] * 2 + [("fm", "linear")] * 2
TOY_REL = 1e-5


def _toy_params(k):
    rng = np.random.default_rng(30 + k)
    return {"a": np.float32(rng.uniform(0.3, 1.2, (1,))),
            "b": rng.standard_normal((2, 2, 1)).astype(np.float32),
            "u": rng.standard_normal((3,)).astype(np.float32)}


def _toy_apply(xp):
    """``a·x + t·b + 0.1·text``, the null text where ``drop_mask``, for
    the package ``xp`` (``jnp`` or ``torch``)."""
    def apply_fn(p, x, t, text_emb=None, drop_mask=None):
        b = x.shape[0]
        out = p["a"] * x + t.reshape(b, 1, 1, 1) * p["b"]
        if text_emb is not None:
            c = (text_emb * p["u"]).reshape(b, -1).sum(-1)
            if drop_mask is not None:
                c = xp.where(drop_mask, 0.0, c)
            out = out + 0.1 * c.reshape(b, 1, 1, 1)
        return out
    return apply_fn


def _toy_router(xp, softmax):
    w = np.random.default_rng(40).standard_normal((8, 4)).astype(np.float32)

    def router_fn(x, t):
        h = x.reshape(x.shape[0], -1) @ xp(w) + t.reshape(-1, 1)
        return softmax(h)

    return router_fn


def _toy_run(override, engine="auto"):
    """(JAX latents, port latents) of one toy sampling run."""
    shape = (3, 2, 2, 2)
    rng = np.random.default_rng(41)
    noise = rng.standard_normal(shape).astype(np.float32)
    text = rng.standard_normal((3, 2, 3)).astype(np.float32)
    params = [_toy_params(k) for k in range(4)]
    kw = dict(num_steps=3, cfg_scale=4.0, **override)
    japply, apply = _toy_apply(jnp), _toy_apply(torch)
    jspecs = [jfus.ExpertSpec(name=f"e{i}", objective=o, schedule=sc,
                              apply_fn=japply, cluster_id=i)
              for i, (o, sc) in enumerate(TOY_MIX)]
    want = np.asarray(jsamp.sample_ensemble(
        jax.random.PRNGKey(0), jspecs,
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        _toy_router(jnp.asarray, jax.nn.softmax), shape,
        cond={"text_emb": jnp.asarray(text)}, null_cond={"text_emb": None},
        config=jsamp.SamplerConfig(**kw), engine=engine,
        init_noise=jnp.asarray(noise)))
    specs = [fusion.ExpertSpec(name=f"e{i}", objective=o, schedule=sc,
                               apply_fn=apply, cluster_id=i)
             for i, (o, sc) in enumerate(TOY_MIX)]
    got = sampling.sample_ensemble(
        specs, [{k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
                for p in params],
        _toy_router(torch.from_numpy, lambda h: torch.softmax(h, -1)),
        shape, cond={"text_emb": torch.from_numpy(text)},
        null_cond={"text_emb": None}, config=sampling.SamplerConfig(**kw),
        engine=engine, init_noise=torch.from_numpy(noise)).numpy()
    return want, got


def _assert_toy_close(want, got):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= TOY_REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("override", [
    dict(dispatch="grouped"), dict(strategy="threshold"),
    dict(time_map="snr_match"), dict(strategy="full"),
], ids=lambda d: next(iter(d)))
def test_unported_sampler_options_raise(override):
    """Once unported, these options now run: each matches the JAX
    sampler on the toy ensemble (grouped top-2, the threshold router, the
    SNR time map, the full ensemble), with the step fused and not."""
    for fused in (True, False):
        want, got = _toy_run(dict(override, step_fused=fused))
        _assert_toy_close(want, got)
    # and each is another function than plain top-2 routing
    _, plain = _toy_run({})
    assert np.abs(got - plain).max() > 1e-3 or override == dict(
        dispatch="grouped")


def test_unported_engines_raise():
    """Once unported, the dense and reference engines now run: each
    matches the JAX sampler's on the toy ensemble, top-2 and full."""
    for engine in ("dense", "reference"):
        for override in ({}, dict(strategy="full")):
            _assert_toy_close(*_toy_run(override, engine))
