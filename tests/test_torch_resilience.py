"""The port's serving resilience layer on the CPU: deadlines, the
watchdog on a fake clock, the circuit breaker's trip → probe → restore
cycle, the crash-recovery journal and a short chaos soak, on the
reference's closed-form toy ensemble (``launch.faults.toy_ensemble``).

Held against the reference where the two can be compared exactly: the
journal's records and file names (the same traffic through both
packages' resilient schedulers writes the same events, the submit
payload aside, which holds a seed here and a PRNG key there), the
backoff schedule of a seeded policy, and the named errors.  Within the
port: a restored run continues bitwise as an uninterrupted twin.
"""

from __future__ import annotations

import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sampling import SamplerConfig as JSamplerConfig
from repro.launch import chaos as jchaos
from repro.launch import serve as jserve
from repro.launch.sharded_parity import toy_ensemble as jtoy_ensemble
from repro.serving import ResiliencePolicy as JResiliencePolicy
from repro.serving import ResilientScheduler as JResilientScheduler
from repro_torch.core.sampling import SamplerConfig
from repro_torch.launch import chaos, faults, serve
from repro_torch.serving import (DeadlineExceeded, JournalRestoreError,
                                 RequestFailed, RequestTimeout,
                                 ResiliencePolicy, ResilientScheduler)
from test_torch_serve import one_torch_thread  # noqa: F401  (a fixture)

SAMPLER = dict(num_steps=4, cfg_scale=3.0, strategy="topk", top_k=2)


def _engine(**kw):
    experts, params, router_fn, latent = faults.toy_ensemble(8, "cpu")
    return serve.ServingEngine(
        experts=experts, expert_params=params, router_fn=router_fn,
        latent_shape=latent, sampler=SamplerConfig(**SAMPLER),
        device="cpu", **kw)


def _build(**kw):
    return chaos.build_engine(device="cpu", **kw)


def _fake_clock():
    c = itertools.count()
    return lambda: float(next(c))


# --- deadlines ---------------------------------------------------------------


def test_max_steps_deadline_expires_resident():
    sched = ResilientScheduler(_engine(), max_resident=2,
                               clock=_fake_clock())
    h = sched.submit(0, None, 1, max_steps=3)
    for _ in range(3):
        sched.step()
    assert h.state == "RESIDENT"
    sched.step()                        # expires at the next boundary
    assert h.state == "DEADLINE_EXCEEDED"
    with pytest.raises(DeadlineExceeded) as ei:
        h.result()
    assert ei.value.seq == h.seq and ei.value.requeues == 0
    assert f"seq={h.seq}" in str(ei.value)
    assert sched.engine.stats["deadline_exceeded"] == 1
    assert sched.num_resident == 0


def test_generous_max_steps_resolves():
    sched = ResilientScheduler(_engine(), max_resident=2,
                               clock=_fake_clock())
    h = sched.submit(0, None, 1, max_steps=4 * SAMPLER["num_steps"])
    sched.run_until_idle()
    assert h.state == "DONE" and bool(torch.isfinite(h.result()).all())


def test_deadline_s_expires_queued_request():
    sched = ResilientScheduler(_engine(), max_resident=1,
                               clock=_fake_clock())
    h0 = sched.submit(0, None, 1)                       # holds the row
    h1 = sched.submit(1, None, 1, deadline_s=2.0)       # starves queued
    sched.step()
    assert h0.state == "RESIDENT" and h1.state == "QUEUED"
    for _ in range(4):
        sched.step()
    assert h1.state == "DEADLINE_EXCEEDED"
    with pytest.raises(DeadlineExceeded):
        h1.result()
    sched.run_until_idle()
    assert h0.state == "DONE"


@pytest.mark.parametrize("change", ["degraded", "midflight_eviction"])
def test_deadline_under_membership_changes(change):
    eng = _engine(capacity=8)
    if change == "degraded":
        for e in range(1, 8):
            eng.evict_expert(e)
    sched = ResilientScheduler(eng, max_resident=2, clock=_fake_clock())
    h = sched.submit(0, None, 1, max_steps=3)
    sched.step()
    if change == "midflight_eviction":
        eng.evict_expert(5)
    h2 = sched.submit(1, None, 1)
    for _ in range(3):
        sched.step()
    assert h.state == "DEADLINE_EXCEEDED"
    sched.run_until_idle()
    assert h2.state == "DONE" and bool(torch.isfinite(h2.result()).all())
    if change == "degraded":
        assert eng.stats["degraded_steps"] > 0


def test_result_timeout_and_flush_deadline():
    sched = ResilientScheduler(_engine(), max_resident=2,
                               clock=_fake_clock())
    h = sched.submit(0, None, 1)
    with pytest.raises(RequestTimeout) as ei:
        h.result(timeout=0.05)          # nobody ticks the scheduler
    assert ei.value.seq == h.seq and "QUEUED" in str(ei.value)
    sched.run_until_idle()
    assert bool(torch.isfinite(h.result(timeout=1.0)).all())
    eng = _engine()
    late = eng.submit(0, None, 1, deadline_s=0.0)
    live = eng.submit(1, None, 1)
    eng.flush()
    assert late.state == "DEADLINE_EXCEEDED" and live.state == "DONE"


def test_failed_carries_seq_and_requeues():
    eng = _build(max_request_requeues=1)
    sched = chaos.ChaosScheduler(eng, max_resident=2,
                                 clock=chaos.FakeClock(),
                                 fail_ticks=range(1, 40))
    h = sched.submit(0, None, 1)
    for _ in range(40):
        sched.step()
        if h.state == "FAILED":
            break
    with pytest.raises(RequestFailed) as ei:
        h.result()
    assert ei.value.seq == h.seq and ei.value.requeues == h.requeues == 2
    assert "injected dispatch failure" in str(ei.value)


# --- watchdog + backoff against the reference ----------------------------------


def test_watchdog_trips_and_request_recovers():
    eng = _build()
    sched = chaos.ChaosScheduler(
        eng, policy=ResiliencePolicy(tick_budget_s=0.25, seed=0),
        max_resident=2, clock=chaos.FakeClock(), slow_ticks={1})
    h = sched.submit(0, None, 1)
    sched.step()                        # slow tick -> watchdog trip
    assert eng.stats["watchdog_trips"] == 1
    assert h.state == "QUEUED" and h.requeues == 1
    until, attempt = sched._backoff[sched._sig(h)]
    assert attempt == 1 and until > sched.step_count
    sched.run_until_idle()
    assert h.state == "DONE" and bool(torch.isfinite(h.result()).all())
    assert eng.stats["request_requeues"] == 1


def test_backoff_schedule_equals_the_reference():
    """Four slow ticks in a row under a seeded policy: the same retry
    windows and attempts as the reference's scheduler."""
    def trace(sched):
        sched.submit(*((0, None, 1) if isinstance(sched, chaos.ChaosScheduler)
                       else (jax.random.PRNGKey(0), None, 1)))
        out = []
        for _ in range(12):
            sched.step()
            out += [(sched.step_count,) + v for v in sched._backoff.values()]
        return out

    got = trace(chaos.ChaosScheduler(
        _build(), policy=ResiliencePolicy(tick_budget_s=0.25, seed=7),
        max_resident=2, clock=chaos.FakeClock(), slow_ticks={1, 2, 3, 4}))
    want = trace(jchaos.ChaosScheduler(
        jchaos.build_engine(),
        policy=JResiliencePolicy(tick_budget_s=0.25, seed=7),
        max_resident=2, clock=jchaos.FakeClock(), slow_ticks={1, 2, 3, 4}))
    assert got == want and len(got) > 4


# --- circuit breakers -------------------------------------------------------------


def test_breaker_trip_probation_restore():
    """A poisoned slot: the escape trips it (and its co-routed slot) into
    PROBATION, the request re-queues under a fresh snapshot and resolves
    finite; the innocent slot's canary restores it; the poisoned slot's
    canaries fail until it is healed, then restore it."""
    eng = _build()
    sched = ResilientScheduler(eng, policy=ResiliencePolicy(
        probe_base_ticks=1, seed=0), max_resident=2, clock=_fake_clock())
    h = sched.submit(0, None, 1)
    sched.run_until_idle()
    assert h.state == "DONE" and sched._probe(0) is True
    epoch = eng.membership_epoch
    sched._buckets.clear()      # the next admission snapshots the poison
    clean = faults.poison_expert_runtime(eng, 7)
    h2 = sched.submit(2, None, 2)
    for _ in range(chaos.NUM_STEPS + 1):
        sched.step()
    assert eng.expert_health[7] == "PROBATION"
    assert eng.membership_epoch > epoch
    sched.run_until_idle()
    assert h2.state == "DONE" and h2.requeues == 1
    assert bool(torch.isfinite(h2.result()).all())
    for _ in range(6):
        sched.step()
    assert eng.expert_health[7] == "PROBATION"
    assert sched._probe(7) is False
    faults.heal_expert_runtime(eng, 7, clean)
    for _ in range(40):
        sched.step()
        if eng.expert_health[7] == "ACTIVE":
            break
    assert eng.expert_health[7] == "ACTIVE" and 7 not in sched.breaker.probation
    s = eng.stats
    assert s["breaker_probes"] >= 2 and s["breaker_restores"] >= 1
    assert s["degraded_steps"] == 0     # canaries bypass the counters
    assert f"trips={s['breaker_trips']}" in eng.membership_line()


def test_breaker_never_trips_the_last_live_expert():
    eng = _build()
    for e in range(1, 8):
        eng.evict_expert(e)
    sched = ResilientScheduler(eng, max_resident=2, clock=_fake_clock())
    sched._trip([0])
    assert eng.expert_health[0] == "ACTIVE"
    assert eng.stats["breaker_trips"] == 0


def test_trip_and_restore_engine_api_matches_the_reference():
    eng, jeng = _build(), jchaos.build_engine()
    for e in (eng, jeng):
        e.trip_expert(5, reason="test")
    assert eng.expert_health == jeng.expert_health
    assert eng.quarantine == jeng.quarantine
    assert eng.membership_line() == jeng.membership_line()
    for e in (eng, jeng):
        e.restore_expert(5)
    assert eng.membership_epoch == jeng.membership_epoch == 2
    assert eng.membership_line() == jeng.membership_line()


# --- the journal --------------------------------------------------------------------


@pytest.mark.parametrize("kill_at", [1, 2, 3, 4, 5])
def test_kill_and_restore_bitwise(kill_at, tmp_path):
    v = chaos.run_kill_restore(0, str(tmp_path), kill_at=kill_at,
                               device="cpu")
    assert v["bitwise_identical"] and v["requests"] == 3


def test_journal_records_equal_the_reference(tmp_path):
    """The same traffic through both resilient schedulers: the same
    journal events (tick, admit, resolve, snapshot, deadline, ...) and
    the same file names."""
    def run(sched, j):
        texts = np.random.default_rng(5).standard_normal(
            (2, 5, 6)).astype(np.float32)
        args = [(0, None, 1, {}), (1, texts, 2, {}),
                (2, None, 1, dict(max_steps=2))]
        for seed, text, bs, kw in args:
            seed = jax.random.PRNGKey(seed) if j else seed
            sched.submit(seed, None if text is None else
                         (jnp.asarray(text) if j else text), bs, **kw)
            sched.step()
        sched.run_until_idle()
        sched.journal.close()

    run(ResilientScheduler(_build(), journal_dir=str(tmp_path / "port"),
                           max_resident=2, clock=_fake_clock()), False)
    run(JResilientScheduler(jchaos.build_engine(),
                            journal_dir=str(tmp_path / "ref"),
                            max_resident=2, clock=_fake_clock()), True)

    def events(d):
        with open(tmp_path / d / "journal.jsonl") as f:
            return [json.loads(line) for line in f]

    assert events("port") == events("ref")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref"))
    assert any(e["ev"] == "deadline" for e in events("port"))


def test_restore_resumes_max_steps_deadline(tmp_path):
    d = str(tmp_path / "j")
    sched = ResilientScheduler(_build(), journal_dir=d, max_resident=2,
                               clock=_fake_clock())
    h = sched.submit(0, None, 1, max_steps=4)
    sched.step()
    sched.step()
    sched.journal.close()
    sched2 = ResilientScheduler.restore(_build(), d, clock=_fake_clock())
    assert sched2.step_count == 2
    h2 = {r.seq: r for b in sched2._buckets.values()
          for r in b.resident_requests()}[h.seq]
    assert h2.max_steps == 4
    sched2.step()
    sched2.step()
    assert h2.state == "RESIDENT"
    sched2.step()
    assert h2.state == "DEADLINE_EXCEEDED"


def test_restore_refuses_diverged_membership(tmp_path):
    d = str(tmp_path / "j")
    sched = ResilientScheduler(_build(), journal_dir=d, max_resident=2,
                               clock=_fake_clock())
    sched.submit(0, None, 1)
    sched.step()
    sched.journal.close()
    eng2 = _build()
    eng2.evict_expert(2)
    with pytest.raises(JournalRestoreError, match="diverged"):
        eng2.restore(d, clock=_fake_clock())


def test_restore_requeues_a_never_admitted_submit(tmp_path):
    d = str(tmp_path / "j")
    sched = ResilientScheduler(_build(), journal_dir=d, max_resident=1,
                               clock=_fake_clock())
    h0 = sched.submit(0, None, 1)
    h1 = sched.submit(1, None, 1)
    sched.step()
    assert h1.state == "QUEUED"
    sched.journal.close()
    twin = ResilientScheduler(_build(), max_resident=1, clock=_fake_clock())
    t0, t1 = twin.submit(0, None, 1), twin.submit(1, None, 1)
    twin.run_until_idle()
    sched2 = _build().restore(d, clock=_fake_clock())
    assert [r.seq for r in sched2._queue] == [h1.seq]
    restored = {r.seq: r for b in sched2._buckets.values()
                for r in b.resident_requests()}
    restored.update({r.seq: r for r in sched2._queue})
    sched2.run_until_idle()
    for seq, t in ((h0.seq, t0), (h1.seq, t1)):
        assert torch.equal(restored[seq].result(), t.result())


def test_journal_needs_a_replayable_seed(tmp_path):
    sched = ResilientScheduler(_build(), journal_dir=str(tmp_path),
                               max_resident=2, clock=_fake_clock())
    with pytest.raises(ValueError, match="int seed or noise"):
        sched.submit(torch.Generator().manual_seed(0), None, 1)
    h = sched.submit(None, None, 1, noise=np.ones((1, 4, 4, 2), np.float32))
    sched.run_until_idle()
    assert h.state == "DONE"


# --- the chaos soak and the fault scenario --------------------------------------


def test_short_chaos_soak(tmp_path):
    v = chaos.run_soak(60, 0, str(tmp_path), device="cpu")
    assert v["breaker_trips"] >= 1 and v["breaker_restores"] >= 1
    assert v["watchdog_trips"] >= 1 and v["deadline_exceeded"] >= 1
    assert v["done"] + v["failed"] + v["deadline_exceeded"] == \
        v["submitted"]


def test_faults_scenario_runs_on_the_cpu(capsys):
    faults.main(["--device", "cpu"])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("assembly_quarantine", "inflight_snapshot", "retire_drain",
                "add_expert_quarantine", "flush_isolation"):
        assert verdict[key] == "ok"


def test_cold_scheduler_line_has_no_garbage():
    sched = ResilientScheduler(_engine(), max_resident=2)
    line = sched.line()
    assert "p50=-" in line and "done=0" in line
    assert not any(k.startswith("latency_p") for k in sched.engine.stats)


def test_ported_toy_ensemble_is_the_reference_one():
    experts, params, router_fn, latent = faults.toy_ensemble(4, "cpu")
    jexperts, jparams, jrouter, jlatent = jtoy_ensemble(4)
    assert latent == jlatent
    assert [(e.name, e.objective, e.schedule, e.cluster_id)
            for e in experts] == [(e.name, e.objective, e.schedule,
                                   e.cluster_id) for e in jexperts]
    x = np.random.default_rng(0).standard_normal((3,) + latent).astype(
        np.float32)
    t = np.full(3, 0.5, np.float32)
    text = np.ones((3, 5, 6), np.float32)
    for p, jp in zip(params, jparams):
        np.testing.assert_allclose(
            experts[0].apply_fn(p, torch.from_numpy(x), torch.from_numpy(t),
                                text_emb=torch.from_numpy(text)).numpy(),
            np.asarray(jexperts[0].apply_fn(jp, jnp.asarray(x),
                                            jnp.asarray(t),
                                            text_emb=jnp.asarray(text))),
            rtol=1e-6)
    np.testing.assert_allclose(
        router_fn(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
        np.asarray(jrouter(jnp.asarray(x), jnp.asarray(t))), rtol=1e-6)
    jeng = jserve.ServingEngine(
        experts=jexperts, expert_params=jparams, router_fn=jrouter,
        latent_shape=jlatent, sampler=JSamplerConfig(**SAMPLER))
    eng = serve.ServingEngine(
        experts=experts, expert_params=params, router_fn=router_fn,
        latent_shape=latent, sampler=SamplerConfig(**SAMPLER), device="cpu")
    assert eng.membership_line() == jeng.membership_line()
