"""Continuous batching in the port: the rolling mixed-timestep step and
scheduler, on the CPU, against the JAX package and against the port's own
``generate``.

* ``sample_ensemble_step`` against the JAX function, step by step, over a
  batch whose rows sit at different steps (some frozen), on the
  reference's closed-form toy ensemble (latents within ``1e-5 · max
  |latent|``: the schedules' coefficient tables and the toy router's
  softmax round differently in XLA and ATen by an ulp, which CFG 3
  amplifies over eight steps; step indices and routed slots equal) and
  on the reduced DiT
  ensemble of ``test_torch_serve.py`` (``1e-4 · max |latent|``, the
  served slice's tolerance).
* Rolling against ``generate`` in the port: bitwise on the toy ensemble
  (every op is row-independent); on the reduced DiT ensemble within
  ``1e-4 · max |latent|``, because the router's dense GEMMs sum by the
  batch's row count (a row's posterior alone differs from the same row
  in a batch of 4 by ~1e-8, in MKL as in cuBLAS on the card), and a
  rolling batch of 4 runs other row counts than a request of 1 or 2
  (the test prints whether it is bitwise).
* Admission, FIFO order and backpressure; failing buckets; the router
  running only on ticks where some row refreshes; the scheduler's line
  and ``percentile`` equal to the reference's; ``python -m
  repro_torch.serving --device cpu`` and the CLI's ``--continuous`` lines.
"""

from __future__ import annotations

import itertools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import sampling as jsampling
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.launch.sharded_parity import toy_ensemble as jtoy_ensemble
from repro.serving import ContinuousScheduler as JContinuousScheduler
from repro.serving import metrics as jmetrics
from repro_torch.core import dispatch, sampling
from repro_torch.core.sampling import SamplerConfig
from repro_torch.kernels import ops
from repro_torch.launch import faults, serve
from repro_torch.models.config import dit_b2, router_b2
from repro_torch.serving import (AdmissionError, ContinuousScheduler,
                                 QueueBackpressure, metrics)
from test_torch_serve import (  # noqa: F401  (one_torch_thread: a fixture)
    REPO, SLICE_REL, _write_ensemble, one_torch_thread)

LATENT = (4, 4, 2)
TEXT_TAIL = (5, 6)
TOY = dict(num_steps=6, cfg_scale=3.0, strategy="topk", top_k=2)


def _toy_engine(k=8, sampler=None, **kw):
    experts, params, router_fn, latent = faults.toy_ensemble(8, "cpu")
    return serve.ServingEngine(
        experts=experts[:k], expert_params=params[:k], router_fn=router_fn,
        latent_shape=latent, sampler=sampler or SamplerConfig(**TOY),
        device="cpu", **kw)


def _text(i, bs, tail=TEXT_TAIL):
    return np.random.default_rng(100 + i).standard_normal(
        (bs,) + tail).astype(np.float32)


def _fake_clock():
    c = itertools.count()
    return lambda: float(next(c))


# --- sample_ensemble_step against the JAX function ------------------------------


def _row_state(rng, b, k_slots, steps):
    x = rng.standard_normal((b,) + LATENT).astype(np.float32)
    t_idx = np.array([0, 3, steps, 1, 5, steps][:b], np.int64)
    return x, t_idx, np.zeros((b, k_slots), np.int64), np.zeros(
        (b, k_slots), np.float32)


@pytest.mark.parametrize("refresh,with_text,capacity", [
    (1, True, None), (2, True, None), (3, False, None), (1, True, 8)],
    ids=["R1_cfg", "R2_cfg", "R3_uncond", "R1_capacity"])
def test_step_matches_jax_step_by_step(refresh, with_text, capacity):
    """Six rows at steps 0, 3, done, 1, 5, done advance eight steps; each
    step's outputs against the JAX step fed the same state.  With
    ``capacity`` 8 over 6 experts the store, tables and cluster map are
    the elastic engine's (slot 2 evicted)."""
    cfg = dict(TOY, plan_refresh_every=refresh)
    kw, jkw = {}, {}
    experts, params, router_fn, _ = faults.toy_ensemble(8, "cpu")
    jexperts, jparams, jrouter, _ = jtoy_ensemble(8)
    if capacity:
        eng = _toy_engine(6, SamplerConfig(**cfg), capacity=capacity)
        jeng = jserve.ServingEngine(
            experts=jexperts[:6], expert_params=jparams[:6],
            router_fn=jrouter, latent_shape=LATENT,
            sampler=jsampling.SamplerConfig(**cfg), capacity=capacity)
        eng.evict_expert(2)
        jeng.evict_expert(2)
        experts, params, jexperts, jparams = (eng.experts, None,
                                              jeng.experts, None)
        _, store, tables, cmap, _ = eng._membership()
        _, jst, jtab, jcmap = jeng._membership()
        kw = dict(stacked_params=store, coeff_tables=tables,
                  cluster_map=cmap)
        jkw = dict(stacked_params=jst, coeff_tables=jtab,
                   cluster_map=jcmap)
    rng = np.random.default_rng(refresh)
    x, t_idx, si, sw = _row_state(rng, 6, 2, cfg["num_steps"])
    text = rng.standard_normal((6,) + TEXT_TAIL).astype(np.float32)
    cond = {"text_emb": torch.from_numpy(text)} if with_text else None
    null = {"text_emb": None} if with_text else None
    jcond = {"text_emb": jnp.asarray(text)} if with_text else None
    state = tuple(torch.from_numpy(a) for a in (x, t_idx, si, sw))
    jstate = tuple(jnp.asarray(a) for a in (x, t_idx.astype(np.int32),
                                            si.astype(np.int32), sw))
    jstep = jax.jit(lambda *a: jsampling.sample_ensemble_step(
        jexperts, jparams, jrouter, *a, cond=jcond, null_cond=null,
        config=jsampling.SamplerConfig(**cfg), **jkw))
    for _ in range(8):
        state = sampling.sample_ensemble_step(
            experts, params, router_fn, *state, cond=cond, null_cond=null,
            config=SamplerConfig(**cfg), **kw)
        jstate = jstep(*jstate)
        want = np.asarray(jstate[0])
        err = np.abs(state[0].numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err
        for a, b in zip(state[1:3], jstate[1:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(state[3].numpy(), np.asarray(jstate[3]),
                                   rtol=1e-6)
    assert (state[1].numpy() == cfg["num_steps"]).all()


def test_dit_step_matches_jax(tmp_path):
    """The reduced DiT ensemble (ragged executor, batched CFG 7.5), four
    rows at steps 0, 2, done, 1 advancing three steps: latents within
    ``1e-4 · max |latent|`` of the JAX step's, slots equal."""
    from repro.models.config import dit_b2 as j_dit_b2
    from repro.models.config import router_b2 as j_router_b2

    path = str(tmp_path)
    cfg = dit_b2().reduced(latent_size=8)
    _write_ensemble(path, cfg, router_b2(num_clusters=8).reduced(
        latent_size=8))
    sampler = dict(num_steps=4, cfg_scale=7.5, top_k=2)
    eng = serve.ServingEngine.from_checkpoint_dir(
        path, dit_cfg=cfg,
        router_cfg=router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=SamplerConfig(**sampler), device="cpu")
    jeng = jserve.ServingEngine.from_checkpoint_dir(
        path, dit_cfg=j_dit_b2().reduced(latent_size=8),
        router_cfg=j_router_b2(num_clusters=8).reduced(latent_size=8),
        sampler=jsampling.SamplerConfig(**sampler))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    text = rng.standard_normal((4, cfg.text_len, cfg.text_dim)).astype(
        np.float32)
    t_idx = np.array([0, 2, 4, 1])
    state = (torch.from_numpy(x), torch.from_numpy(t_idx),
             torch.zeros(4, 2, dtype=torch.int64), torch.zeros(4, 2))
    jstate = (jnp.asarray(x), jnp.asarray(t_idx, jnp.int32),
              jnp.zeros((4, 2), jnp.int32), jnp.zeros((4, 2)))
    jstep = jax.jit(lambda *a: jsampling.sample_ensemble_step(
        jeng.experts, jeng.expert_params, jeng.router_fn, *a,
        cond={"text_emb": jnp.asarray(text)},
        null_cond={"text_emb": None}, config=jeng.sampler,
        stacked_params=jeng.param_store))
    for _ in range(3):
        state = sampling.sample_ensemble_step(
            eng.experts, eng.expert_params, eng.router_fn, *state,
            cond={"text_emb": torch.from_numpy(text)},
            null_cond={"text_emb": None}, config=eng.sampler,
            stacked_params=eng.param_store)
        jstate = jstep(*jstate)
        want = np.asarray(jstate[0])
        err = np.abs(state[0].numpy() - want).max()
        assert err <= SLICE_REL * np.abs(want).max(), err
        np.testing.assert_array_equal(state[2].numpy(),
                                      np.asarray(jstate[2]))
    assert state[1].tolist() == [3, 4, 4, 4]


@pytest.mark.parametrize("change", [
    dict(strategy="threshold"), dict(strategy="full"),
    dict(step_fused=False), "slots", "engine"])
def test_step_misuse_raises_the_reference_message(change):
    experts, params, router_fn, _ = faults.toy_ensemble(4, "cpu")
    jexperts, jparams, jrouter, _ = jtoy_ensemble(4)
    cfg = dict(TOY, **change) if isinstance(change, dict) else TOY
    k = 3 if change == "slots" else 2
    engine = "dense" if change == "engine" else "auto"
    with pytest.raises(ValueError) as want:
        jsampling.sample_ensemble_step(
            jexperts, jparams, jrouter, jnp.zeros((2,) + LATENT),
            jnp.zeros(2, jnp.int32), jnp.zeros((2, k), jnp.int32),
            jnp.zeros((2, k)), config=jsampling.SamplerConfig(**cfg),
            engine=engine)
    with pytest.raises(ValueError) as got:
        sampling.sample_ensemble_step(
            experts, params, router_fn, torch.zeros((2,) + LATENT),
            torch.zeros(2, dtype=torch.int64),
            torch.zeros(2, k, dtype=torch.int64), torch.zeros(2, k),
            config=SamplerConfig(**cfg), engine=engine)
    assert str(got.value) == str(want.value)


def test_router_runs_only_on_refresh_ticks():
    """R 2: rows at steps 1 and 3 need no router; one row at step 2 makes
    the step run it (over the whole batch); the host mirror decides."""
    experts, params, router_fn, _ = faults.toy_ensemble(4, "cpu")
    calls = []

    def counted(x, t):
        calls.append(x.shape[0])
        return router_fn(x, t)

    cfg = SamplerConfig(**dict(TOY, plan_refresh_every=2))
    state = (torch.zeros((3,) + LATENT), torch.tensor([1, 3, 6]),
             torch.zeros(3, 2, dtype=torch.int64), torch.zeros(3, 2))
    out = sampling.sample_ensemble_step(experts, params, counted, *state,
                                        config=cfg)
    assert calls == [] and torch.equal(out[2], state[2])
    out = sampling.sample_ensemble_step(
        experts, params, counted, *out, config=cfg,
        t_host=np.array([2, 4, 6]))
    assert calls == [3]
    assert out[1].tolist() == [3, 5, 6]


# --- the per-row dt and the per-row tables -----------------------------------------


def _step_operands(seed=5, k=3, g=2, b=4):
    rng = np.random.default_rng(seed)
    preds = rng.standard_normal((k, g * b) + LATENT).astype(np.float32)
    x = rng.standard_normal((b,) + LATENT).astype(np.float32)
    w = rng.dirichlet(np.ones(k), size=g * b).astype(np.float32)
    coef = (rng.standard_normal((5, k, g * b)) * 0.5 + 1.0).astype(
        np.float32)
    return preds, x, w, coef


def test_fused_step_per_row_dt_matches_jax():
    """A mixed ``(B,)`` dt: each row equals a scalar-dt launch at its dt
    bitwise, and the JAX step at ``rtol 1e-6``."""
    preds, x, w, coef = _step_operands()
    dts = np.array([0.1, 0.25, 0.05, 0.4], np.float32)
    args = [torch.from_numpy(a) for a in (preds, x, w, coef)]
    mixed = ops.fused_step(*args, torch.from_numpy(dts), g=2,
                           cfg_scale=3.0)
    for r in range(4):
        one = ops.fused_step(*args, torch.tensor(dts[r]), g=2,
                             cfg_scale=3.0)
        assert torch.equal(mixed[r], one[r]), r
    want = jops.fused_step(*(jnp.asarray(a) for a in (preds, x, w, coef)),
                           jnp.asarray(dts), g=2, cfg_scale=3.0)
    np.testing.assert_allclose(mixed.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_slot_coef_rows_matches_jax_and_slot_coef():
    rng = np.random.default_rng(2)
    tabs = rng.standard_normal((6, 5, 8)).astype(np.float32)
    idx = rng.integers(0, 8, (6, 2))
    got = dispatch.slot_coef_rows(torch.from_numpy(tabs),
                                  torch.from_numpy(idx))
    want = jdispatch.slot_coef_rows(jnp.asarray(tabs), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    uniform = torch.from_numpy(tabs[0])
    assert torch.equal(
        dispatch.slot_coef_rows(uniform.expand(6, 5, 8),
                                torch.from_numpy(idx)),
        dispatch.slot_coef(uniform, torch.from_numpy(idx)))


# --- rolling against generate --------------------------------------------------


def _staggered(sched, specs, tail=TEXT_TAIL):
    handles, inputs = [], []
    tick = 0
    mixed = False
    for arrive, bs in specs:
        while tick < arrive:
            sched.step()
            tick += 1
        text = None if tail is None else _text(len(handles), bs, tail)
        handles.append(sched.submit(200 + len(handles), text, bs))
        inputs.append((200 + len(handles) - 1, text, bs))
    while sched.queue_depth or sched.num_resident:
        sched.step()
        for b in sched._buckets.values():
            live = {int(t) for i, t in enumerate(b.t_idx_host())
                    if b.rows[i] is not None and t < b.num_steps}
            mixed |= len(live) >= 2
    return handles, inputs, mixed


@pytest.mark.parametrize("spt", [1, 2, 4])
def test_rolling_equals_generate_bitwise(spt):
    """Staggered arrivals through a batch of 4 on the toy ensemble,
    ``steps_per_tick`` 1, 2 and 4 (4 finishes requests mid-tick): every
    request equals ``generate`` from its seed bitwise, with mixed
    timesteps seen in flight, one ``fused_step`` launch per step."""
    eng = _toy_engine()
    sched = ContinuousScheduler(eng, max_resident=4, steps_per_tick=spt)
    handles, inputs, mixed = _staggered(
        sched, [(0, 1), (1, 2), (2, 1), (4, 1), (5, 2), (8, 1)])
    assert mixed or spt > 1
    twin = _toy_engine()
    for h, (seed, text, bs) in zip(handles, inputs):
        assert h.state == "DONE"
        assert torch.equal(h.result(), twin.generate(seed, text, bs))


def test_rolling_no_text_with_plan_reuse_bitwise():
    """Unconditioned requests at R 3: each row keeps its own phase."""
    cfg = SamplerConfig(**dict(TOY, num_steps=8, plan_refresh_every=3))
    eng = _toy_engine(sampler=cfg)
    sched = ContinuousScheduler(eng, max_resident=3)
    handles, inputs, _ = _staggered(sched, [(i, 1) for i in range(4)],
                                    tail=None)
    twin = _toy_engine(sampler=cfg)
    for h, (seed, _, bs) in zip(handles, inputs):
        assert torch.equal(h.result(), twin.generate(seed, None, bs))


def test_rolling_dit_matches_generate(tmp_path):
    """The reduced DiT ensemble (ragged executor, CFG 7.5): requests of 1
    and 2 rows through a rolling batch of 4 against ``generate``, within
    ``1e-4 · max |latent|`` (see the module docstring)."""
    path = str(tmp_path)
    cfg = dit_b2().reduced(latent_size=8)
    rcfg = router_b2(num_clusters=8).reduced(latent_size=8)
    _write_ensemble(path, cfg, rcfg)
    kw = dict(dit_cfg=cfg, router_cfg=rcfg, device="cpu",
              sampler=SamplerConfig(num_steps=4, cfg_scale=7.5, top_k=2))
    eng = serve.ServingEngine.from_checkpoint_dir(path, **kw)
    sched = ContinuousScheduler(eng, max_resident=4)
    tail = (cfg.text_len, cfg.text_dim)
    handles, inputs, mixed = _staggered(sched, [(0, 1), (1, 2), (2, 1)],
                                        tail=tail)
    assert mixed
    twin = serve.ServingEngine.from_checkpoint_dir(path, **kw)
    for h, (seed, text, bs) in zip(handles, inputs):
        want = twin.generate(seed, text, bs)
        err = (h.result() - want).abs().max().item()
        print(f"rolling vs generate, batch {bs}: max |Δ| {err}"
              f"{' (bitwise)' if err == 0 else ''}")
        assert err <= SLICE_REL * want.abs().max().item(), err


def test_rolling_elastic_epochs_keep_their_snapshot(tmp_path):
    """An eviction mid-flight: the resident request resolves under its
    admission epoch, one submitted after under the new one — each bitwise
    its twin engine's ``generate``; a DRAINING slot is freed when the
    scheduler drains."""
    eng = _toy_engine(6, capacity=8)
    sched = ContinuousScheduler(eng, max_resident=2)
    h1 = sched.submit(80, _text(80, 1))
    sched.step()
    sched.step()
    assert h1.state == "RESIDENT"
    eng.evict_expert(0)
    eng.retire_expert(1)
    h2 = sched.submit(81, _text(81, 1))
    assert len({sched._sig(h1), sched._sig(h2)}) == 2
    sched.run_until_idle()
    old = _toy_engine(6, capacity=8)
    assert torch.equal(h1.result(), old.generate(80, _text(80, 1), 1))
    new = _toy_engine(6, capacity=8)
    new.evict_expert(0)
    new.evict_expert(1)
    assert torch.equal(h2.result(), new.generate(81, _text(81, 1), 1))
    assert eng.expert_health[1] == "EVICTED"
    assert len(sched._buckets) == 1          # the old epoch's bucket went


# --- admission ---------------------------------------------------------------------


def test_admission_residency_and_backpressure():
    eng = _toy_engine()
    sched = ContinuousScheduler(eng, max_resident=2, max_queue_depth=3)
    with pytest.raises(AdmissionError, match="max_resident"):
        sched.submit(1, batch_size=3)
    handles = [sched.submit(10 + i, batch_size=1) for i in range(2)]
    assert all(h.state == "QUEUED" for h in handles)
    sched.step()
    assert all(h.state == "RESIDENT" for h in handles)
    assert sched.num_resident == 2
    queued = [sched.submit(20 + i, batch_size=1) for i in range(3)]
    sched.step()
    assert all(h.state == "QUEUED" for h in queued)
    assert sched.queue_depth == 3
    with pytest.raises(QueueBackpressure):
        sched.submit(30, batch_size=1)
    sched.run_until_idle()
    assert all(h.state == "DONE" and bool(torch.isfinite(h.result()).all())
               for h in handles + queued)
    assert sched.queue_depth == 0 and sched.num_resident == 0


def test_admission_is_fifo_by_submission():
    eng = _toy_engine()
    sched = ContinuousScheduler(eng, max_resident=1)
    handles = [sched.submit(50 + i, batch_size=1) for i in range(3)]
    order = []
    while sched.queue_depth or sched.num_resident:
        sched.step()
        order += [h.seq for h in handles if h.done and h.seq not in order]
    assert order == sorted(order)


@pytest.mark.parametrize("budget,state", [(1, "QUEUED"), (0, "FAILED")])
def test_failing_bucket_requeues_in_seq_order(monkeypatch, budget, state):
    eng = _toy_engine(max_request_requeues=budget)
    sched = ContinuousScheduler(eng, max_resident=4)
    handles = [sched.submit(60 + i, _text(i, 1)) for i in range(3)]

    def boom(bucket):
        raise RuntimeError("injected")

    monkeypatch.setattr(sched, "_advance", boom)
    sched.step()
    assert [h.state for h in handles] == [state] * 3
    assert [r.seq for r in sched._queue] == sorted(r.seq for r in
                                                   sched._queue)
    if state == "FAILED":
        assert eng.stats["failed_requests"] == 3
        with pytest.raises(RuntimeError, match="injected"):
            handles[0].result()


def test_scheduler_rejects_what_cannot_roll():
    for sampler, kw in ((dict(strategy="full"), {}),
                        (dict(step_fused=False), {}),
                        ({}, dict(engine="dense"))):
        eng = _toy_engine(sampler=SamplerConfig(**dict(TOY, **sampler)),
                          **kw)
        with pytest.raises(ValueError):
            ContinuousScheduler(eng)
    with pytest.raises(ValueError, match="max_resident"):
        ContinuousScheduler(_toy_engine(), max_resident=0)


# --- observability: the reference's percentiles and line ------------------------


def test_percentile_is_the_reference_nearest_rank():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 100):
        vals = rng.standard_normal(n).tolist()
        for q in (0, 1, 50, 95, 99, 100):
            assert metrics.percentile(vals, q) == jmetrics.percentile(
                vals, q)
    assert metrics.percentile([float(v) for v in range(1, 101)], 95) == 95.0
    assert metrics.percentile([], 50) is None


def test_scheduler_line_and_stats_equal_the_reference():
    """The same staggered traffic through the port's and the reference's
    scheduler, each on a fake clock: the lines are equal word for word,
    cold and after the run, and so are the published stats."""
    experts, params, router_fn, _ = jtoy_ensemble(8)
    jeng = jserve.ServingEngine(
        experts=experts, expert_params=params, router_fn=router_fn,
        latent_shape=LATENT, sampler=jsampling.SamplerConfig(**TOY))
    eng = _toy_engine()
    scheds = [ContinuousScheduler(eng, max_resident=2, clock=_fake_clock()),
              JContinuousScheduler(jeng, max_resident=2,
                                   clock=_fake_clock())]
    assert scheds[0].line() == scheds[1].line()
    for i, bs in enumerate([1, 2, 1, 1]):
        text = _text(i, bs)
        scheds[0].submit(300 + i, text)
        scheds[1].submit(jax.random.PRNGKey(300 + i), jnp.asarray(text))
        for s in scheds:
            s.step()
    for s in scheds:
        s.run_until_idle()
    assert scheds[0].line() == scheds[1].line()
    keys = [k for k in jeng.stats if k.startswith(("latency", "queue_wait",
                                                   "completed",
                                                   "throughput"))]
    assert len(keys) >= 14
    assert {k: eng.stats[k] for k in keys} == {k: jeng.stats[k]
                                               for k in keys}
    assert eng.stats["scheduler_steps"] == jeng.stats["scheduler_steps"]


# --- entry points -------------------------------------------------------------------


def test_serving_self_check_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "smoke OK: 6 staggered requests bitwise" in proc.stdout


def _blank(text: str) -> list[str]:
    out = []
    for line in text.strip().splitlines():
        line = re.sub(r" traces=\d+", "", line)
        line = re.sub(r"[0-9.]+ imgs in [0-9.]+s \([0-9.]+ img/s\)",
                      "N imgs in Ts (R img/s)", line)
        line = re.sub(r"\([0-9.]+ img/s\)", "(R img/s)", line)
        line = re.sub(r"e2e p50=\S+ p95=\S+ ms", "e2e p50=X p95=X ms", line)
        out.append(line)
    return out


@pytest.mark.parametrize("mode", [
    [], ["--capacity", "10", "--journal-dir", "J"]], ids=["plain", "journal"])
def test_cli_continuous_lines_match_the_reference(tmp_path, capsys,
                                                  monkeypatch, mode):
    """``--continuous`` against the reference CLI's lines (wall-clock
    figures blanked, ``traces=`` dropped)."""
    path = str(tmp_path / "ckpt")
    _write_ensemble(path, dit_b2().reduced(latent_size=8),
                    router_b2(num_clusters=8).reduced(latent_size=8))
    base = ["--ckpt-dir", path, "--batch", "2", "--requests", "3",
            "--steps", "2", "--continuous", "--max-resident", "4",
            "--arrival-every", "1"]
    outs = []
    for name, main in (("jax", jserve.main), ("port", serve.main)):
        argv = base + [str(tmp_path / f"{name}_{m}") if m == "J" else m
                       for m in mode]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["serve"] + argv)
            main()
        else:
            main(argv + ["--device", "cpu"])
        outs.append(_blank(capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[1][-1 if not mode else -2].startswith(
        "scheduler: step=") and "done=3" in outs[1][-1 if not mode else -2]
    if mode:
        events = open(tmp_path / "port_J" / "journal.jsonl").read()
        assert events.count('"ev": "resolve"') == 3
