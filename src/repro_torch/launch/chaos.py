"""Chaos soak harness for the serving resilience layer.

Drives a few hundred ticks of mixed traffic through a
:class:`~repro_torch.serving.resilience.ResilientScheduler` under a
seeded fault schedule — every fault class the resilience layer claims to
survive, fired together:

* **expert poisoning** — ``faults.poison_expert_runtime`` NaN-fills a
  resident expert mid-soak (no load-time check fires); the breaker must
  charge the escapes, trip the slot into PROBATION, and, once the slot
  is healed, restore it through a passing canary probe.
* **dispatch failures** — injected tick crashes on scheduled ticks; only
  the bucket at fault fails, its residents re-queue under the cap behind
  the backoff window.
* **slow ticks** — on scheduled ticks the step burns more fake wall
  clock than ``tick_budget_s``; the watchdog must trip and isolate the
  bucket.
* **deadline pressure** — a slice of the traffic carries ``max_steps`` or
  ``deadline_s`` bounds it cannot meet and must land in
  DEADLINE_EXCEEDED, never hang.
* **kill-and-restore** — a scheduler is abandoned mid-flight and rebuilt
  from its journal; the restored run's outputs must equal an
  uninterrupted twin's bitwise.

The verdict (one JSON line): no hung request, terminal states within
{DONE, FAILED, DEADLINE_EXCEEDED}, re-queues within the cap, the breaker
cycle trip → probe → restore observed, and journal-restore parity exact.

Deterministic: traffic and faults come from one ``numpy`` Generator
seeded by ``--seed``, time from a fake monotonic clock, request seeds
from the request's index.  Runs on the GPU (``--device cpu`` for the
CPU)::

    PYTHONPATH=src python -m repro_torch.launch.chaos --ticks 220 \\
        --out OUT_DIR [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.core.sampling import SamplerConfig
from repro_torch.launch.faults import (heal_expert_runtime,
                                       poison_expert_runtime, toy_ensemble)
from repro_torch.launch.serve import ServingEngine
from repro_torch.serving import (QueueBackpressure, ResiliencePolicy,
                                 ResilientScheduler)

#: grid of the soak sampler: long enough that requests overlap faults in
#: flight, short enough that 200+ ticks stay a smoke test.
NUM_STEPS = 6
TEXT_TAILS = (None, (5, 6))
#: a conditioning shape used only after the poison tick, so its bucket
#: snapshots the poisoned store (older buckets keep their snapshot and
#: would hide the fault).
POISON_TAIL = (7, 6)


class FakeClock:
    """Deterministic monotonic clock: a fixed increment per read, plus
    ``advance`` for injected stalls."""

    def __init__(self, dt: float = 1e-3) -> None:
        self.t = 0.0
        self.dt = dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class ChaosScheduler(ResilientScheduler):
    """ResilientScheduler plus a seeded tick-fault injector, at the seam
    the tick calls (``_get_rolling_step``), so the watchdog and failure
    handling under test are the production path."""

    def __init__(self, engine, *, fail_ticks=(), slow_ticks=(),
                 **kwargs) -> None:
        super().__init__(engine, **kwargs)
        self.fail_ticks = set(fail_ticks)
        self.slow_ticks = set(slow_ticks)

    def _get_rolling_step(self, has_text, text_tail):
        fn = super()._get_rolling_step(has_text, text_tail)
        if self.step_count in self.fail_ticks:
            def crashing(*a):
                raise RuntimeError("chaos: injected dispatch failure")
            return crashing
        if self.step_count in self.slow_ticks \
                and self.policy.tick_budget_s is not None:
            def stalled(*a):
                # the tick itself burns the budget; the watchdog times it
                # on its own clock reads
                self.clock.advance(2.0 * self.policy.tick_budget_s)
                return fn(*a)
            return stalled
        return fn


def build_engine(k: int = 8, capacity: int = 8,
                 max_request_requeues: int = 2,
                 device=None) -> ServingEngine:
    """A fresh elastic toy engine, the same parameters on every call (what
    makes the kill-and-restore twin comparison exact)."""
    experts, params, router_fn, latent = toy_ensemble(k, device)
    sampler = SamplerConfig(num_steps=NUM_STEPS, cfg_scale=3.0,
                            strategy="topk", top_k=2)
    return ServingEngine(
        experts=experts, expert_params=params, router_fn=router_fn,
        latent_shape=latent, sampler=sampler, capacity=capacity,
        max_request_requeues=max_request_requeues, device=device)


def _text(seed: int, batch: int, tail: tuple[int, ...]) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (batch,) + tail).astype(np.float32)


# --------------------------------------------------------------------------
# Phase A: the soak
# --------------------------------------------------------------------------


def run_soak(ticks: int, seed: int, journal_dir: str, device=None) -> dict:
    rng = np.random.default_rng(seed)
    eng = build_engine(device=device)
    policy = ResiliencePolicy(tick_budget_s=0.25, probe_base_ticks=2,
                              seed=seed)
    poison_tick = ticks * 3 // 10
    heal_tick = ticks * 6 // 10
    fail_ticks = sorted(rng.choice(  # lint: allow-host-sync — numpy rng
        np.arange(5, ticks - 10), size=max(3, ticks // 40),
        replace=False).tolist())
    slow_ticks = sorted(rng.choice(  # lint: allow-host-sync — numpy rng
        np.arange(5, ticks - 10), size=max(2, ticks // 60),
        replace=False).tolist())
    sched = ChaosScheduler(
        eng, policy=policy, journal_dir=journal_dir,
        max_resident=4, clock=FakeClock(),
        fail_ticks=fail_ticks, slow_ticks=slow_ticks,
    )

    handles = []
    shed = 0
    clean_params = None
    # the toy router's logits grow with the slot index, so the top slot is
    # routed by nearly every sample: poisoning it makes sure the NaN
    # escape reaches resolved latents
    poison_slot = 7

    for tick in range(ticks):
        if tick == poison_tick:
            clean_params = poison_expert_runtime(eng, poison_slot)
        if tick == heal_tick and clean_params is not None:
            heal_expert_runtime(eng, poison_slot, clean_params)
        # mixed traffic: 0-2 submits a tick, varied shape and bounds
        for _ in range(int(rng.integers(0, 3))):
            n = len(handles)
            batch = int(rng.integers(1, 3))
            if tick >= poison_tick and rng.random() < 0.4:
                tail = POISON_TAIL
            else:
                tail = TEXT_TAILS[int(rng.integers(0, len(TEXT_TAILS)))]
            text = None if tail is None else _text(seed * 100_000 + n,
                                                   batch, tail)
            kw: dict = {}
            r = rng.random()
            if r < 0.15:
                kw["max_steps"] = int(rng.integers(2, 5))  # can't finish
            elif r < 0.25:
                kw["deadline_s"] = 0.02                    # ~2 ticks wall
            elif r < 0.35:
                kw["max_steps"] = 10 * NUM_STEPS           # generous
            try:
                handles.append(sched.submit(seed * 100_000 + n, text,
                                            batch, **kw))
            except QueueBackpressure:
                shed += 1
        sched.step()

    # drain — bounded, so a hung request fails loudly instead of looping
    sched.run_until_idle(max_steps=ticks + 600)
    # let outstanding probations resolve (the healed slot must come back)
    extra = 0
    while sched.breaker.probation and extra < 300:
        sched.step()
        extra += 1

    terminal = {"DONE", "FAILED", "DEADLINE_EXCEEDED"}
    states = {h.state for h in handles}
    assert states <= terminal, f"hung/unknown request states: {states}"
    for h in handles:
        assert h.requeues <= eng.max_request_requeues + 1, \
            f"seq={h.seq} requeued {h.requeues}x past the cap"
        if h.state == "DONE":
            assert bool(torch.isfinite(h.result()).all()), \
                f"seq={h.seq} resolved non-finite latents"
    s = eng.stats
    assert s["breaker_trips"] >= 1, "poisoning never tripped the breaker"
    assert s["breaker_restores"] >= 1, "no slot ever restored from probation"
    assert s["deadline_exceeded"] >= 1, "deadline pressure never expired"
    assert s["watchdog_trips"] >= 1, "slow ticks never tripped the watchdog"
    assert eng.expert_health[poison_slot] == "ACTIVE", \
        f"healed slot stuck {eng.expert_health[poison_slot]}"

    return {
        "ticks": sched.step_count,
        "submitted": len(handles),
        "shed": shed,
        "done": sum(h.state == "DONE" for h in handles),
        "failed": sum(h.state == "FAILED" for h in handles),
        "deadline_exceeded": sum(
            h.state == "DEADLINE_EXCEEDED" for h in handles),
        "breaker_trips": s["breaker_trips"],
        "breaker_probes": s["breaker_probes"],
        "breaker_restores": s["breaker_restores"],
        "watchdog_trips": s["watchdog_trips"],
        "request_requeues": s["request_requeues"],
        "journal_snapshots": s["journal_snapshots"],
        "membership": eng.membership_line(),
    }


# --------------------------------------------------------------------------
# Phase B: kill-and-restore bitwise parity
# --------------------------------------------------------------------------


def run_kill_restore(seed: int, journal_dir: str, kill_at: int = 3,
                     device=None) -> dict:
    """Crash a journaled scheduler mid-flight; the restored run must equal
    an uninterrupted twin bitwise."""
    base = 1000 + seed
    policy = ResiliencePolicy(snapshot_every=1, seed=seed)

    def submit_traffic(sched):
        return [sched.submit(base, None, 1),
                sched.submit(base + 1, _text(base + 1, 2, (5, 6)), 2),
                sched.submit(base + 2, None, 1, max_steps=10 * NUM_STEPS)]

    # the run that dies: journaled, abandoned after `kill_at` ticks with
    # every request in flight
    d_dead = os.path.join(journal_dir, "dead")
    sched1 = ResilientScheduler(build_engine(device=device), policy=policy,
                                journal_dir=d_dead, max_resident=4,
                                clock=FakeClock())
    submit_traffic(sched1)
    for _ in range(kill_at):
        sched1.step()
    assert sched1.num_resident > 0, "kill point must be mid-flight"
    sched1.journal.close()
    del sched1                                # crash: no drain

    # the twin that never dies
    sched2 = ResilientScheduler(build_engine(device=device), policy=policy,
                                journal_dir=None, max_resident=4,
                                clock=FakeClock())
    twin = submit_traffic(sched2)
    sched2.run_until_idle()
    twin_out = {h.seq: h.result() for h in twin}

    # restore onto a fresh engine from the dead run's journal
    sched3 = ResilientScheduler.restore(build_engine(device=device), d_dead,
                                        policy=policy, clock=FakeClock())
    assert sched3.step_count == kill_at
    restored = {r.seq: r for b in sched3._buckets.values()
                for r in b.resident_requests()}
    restored.update({r.seq: r for r in sched3._queue})
    assert set(restored) == set(twin_out), \
        f"restore lost requests: {sorted(restored)} != {sorted(twin_out)}"
    sched3.run_until_idle()
    mismatched = [seq for seq, h in restored.items()
                  if not torch.equal(h.result(), twin_out[seq])]
    assert not mismatched, \
        f"restored outputs diverge from uninterrupted twin: {mismatched}"
    return {"kill_at": kill_at, "requests": len(restored),
            "bitwise_identical": True}


# --------------------------------------------------------------------------


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.chaos",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--ticks", type=int, default=220,
                    help="soak length in scheduler ticks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="journal/artifact dir (default: a temp dir)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    out_dir = args.out or tempfile.mkdtemp(prefix="repro_torch_chaos_")
    os.makedirs(out_dir, exist_ok=True)
    verdict = {"seed": args.seed, "out": out_dir}
    verdict["soak"] = run_soak(args.ticks, args.seed,
                               os.path.join(out_dir, "soak"), args.device)
    verdict["kill_restore"] = run_kill_restore(
        args.seed, os.path.join(out_dir, "restore"), device=args.device)
    with open(os.path.join(out_dir, "chaos_verdict.json"), "w") as f:
        json.dump(verdict, f, indent=2)
    print(json.dumps(verdict))


if __name__ == "__main__":
    main()
