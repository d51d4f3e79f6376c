"""Serving resilience layer: deadlines, watchdogs, breakers, journal.

The rolling scheduler (``serving.scheduler``) keeps traffic moving when
everything works; this module keeps it moving when things break, in the
decentralized deployment the paper assumes (loosely coupled experts,
unreliable contributors, hosts that crash):

* **request deadlines** — ``submit(..., deadline_s=, max_steps=)`` bounds
  a request's lifetime in wall-clock seconds and/or scheduler ticks,
  enforced at tick boundaries for queued and resident requests alike:
  the request lands in DEADLINE_EXCEEDED and ``result()`` raises
  :class:`DeadlineExceeded`.
* **step watchdog** — a wall-clock budget around each bucket's tick,
  timed on the host: no ``torch.cuda.synchronize()`` is added inside
  the tick.  The host time covers the card's work up to the tick's last
  blocking read: on the ragged path the router's reads at the start of
  each step (the grouped and gathered executors also read the segment
  bounds), so the previous tick's expert forwards and step are paid
  here, and this tick's after its router are paid by the next blocking
  read (a full-width tick of 8 rows: 32 ms on the host clock, 64 ms to
  a synchronize, on an H100).  A tick over budget fails only its bucket,
  whose residents re-queue under the engine's ``max_request_requeues``,
  and the bucket's signature waits out a bounded exponential backoff
  (jitter from the scheduler's seeded ``numpy`` Generator) before
  re-admission.
* **expert circuit breakers** — per-slot rolling fault scores fed by
  NaN/Inf escapes (charged to the slots the request's first step routed
  to) and by failed or slow bucket ticks.  A slot over the threshold
  trips into ``PROBATION`` through the engine's ``trip_expert`` (a new
  store with the slot masked), then single-sample canary requests probe
  it on a backoff schedule and ``restore_expert`` brings it back on a
  finite pass.
* **crash-recoverable journal** — an append-only ``journal.jsonl`` of
  submit/admit/tick/resolve/failed/deadline/trip/restore records plus
  per-request row-state snapshots (``npz``, written atomically).  Event
  records come from host state only; the snapshot cadence is the one
  place latents are read back.  :meth:`ResilientScheduler.restore`
  re-admits in-flight requests at their last snapshot, and the
  continuation equals an uninterrupted run's bitwise (rows are
  independent and the shapes do not change).

Everything times through the scheduler's injectable ``clock``, so
deadlines and the watchdog are deterministic under a fake clock; backoff
jitter and canary seeds come from ``ResiliencePolicy.seed``.

On an ``("expert", "data")`` mesh each rank runs its own scheduler, and
what a rank's clock decides is agreed before it acts: the deadline sweep
takes one host agreement a tick (a request expired on any rank expires on
every rank), a slow or failed bucket tick fails the bucket on every rank
through the base scheduler's tick agreement, and a failed bucket's
faults are charged to rank 0's view of its routed slots.  The
resolution gate, the breaker and the probes read values that are the
same on every rank (the gathered latents, the replicated router), so
they decide alike without one.  Only rank 0 writes the journal; the
snapshot's gathers run on every rank; ``restore`` rebuilds the same
scheduler on every rank from that one journal.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import time

import numpy as np
import torch

from repro_torch.core.dispatch import routed_slots
from repro_torch.core.fusion import fusion_weights
from repro_torch.core.sampling import _time_grid, sample_ensemble
from repro_torch.serving.batch import RollingBatch
from repro_torch.serving.metrics import RequestTiming
from repro_torch.serving.scheduler import ContinuousScheduler


# --------------------------------------------------------------------------
# Named terminal errors
# --------------------------------------------------------------------------


class RequestError(RuntimeError):
    """Base for per-request terminal errors; carries the request id
    (``seq``) and how many automatic re-queues it burned."""

    def __init__(self, message: str, *, seq: int = -1,
                 requeues: int = 0) -> None:
        super().__init__(message)
        self.seq = seq
        self.requeues = requeues


class RequestFailed(RequestError):
    """Terminal FAILED: the request exhausted its re-queue budget (or
    produced non-finite latents past recovery)."""


class DeadlineExceeded(RequestError):
    """Terminal DEADLINE_EXCEEDED: the request outlived its
    ``deadline_s``/``max_steps`` bound before resolving."""


class RequestTimeout(RequestError):
    """``result(timeout=...)`` gave up waiting — the request is still in
    flight (nobody ticked the scheduler or flushed the engine)."""


class TickBudgetExceeded(RuntimeError):
    """Watchdog: one bucket's tick exceeded the tick budget."""


class JournalRestoreError(RuntimeError):
    """The journal cannot be replayed onto this engine (missing snapshot
    payloads, or membership diverged from the recorded mask)."""


# --------------------------------------------------------------------------
# Policy
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Tuning knobs for :class:`ResilientScheduler` (all host-side)."""

    #: wall-clock budget per bucket tick; None disables the watchdog.
    tick_budget_s: float | None = None
    #: failed-bucket re-admission backoff: base * 2^(attempt-1) ticks,
    #: capped, plus up to ``retry_jitter`` fraction of jitter.
    retry_base_ticks: int = 1
    retry_max_ticks: int = 32
    retry_jitter: float = 0.25
    #: breaker: trip a slot when its rolling fault score crosses the
    #: threshold; scores decay multiplicatively every tick.
    breaker_threshold: float = 2.0
    breaker_decay: float = 0.8
    #: fault weights: one NaN/Inf escape trips at once (2.0 >=
    #: threshold); dispatch failures need two in quick succession.
    nonfinite_fault: float = 2.0
    dispatch_fault: float = 1.0
    #: canary probe schedule for PROBATION slots (ticks, doubling).
    probe_base_ticks: int = 2
    probe_max_ticks: int = 64
    #: check resolved latents for finiteness on the host at resolution
    #: (one read per resolved request; the base scheduler reads none).
    check_numerics: bool = True
    #: journal snapshot cadence in ticks (1 = every step boundary).
    snapshot_every: int = 1
    #: seeds the backoff-jitter Generator and the canary noise.
    seed: int = 0


# --------------------------------------------------------------------------
# Circuit breaker
# --------------------------------------------------------------------------


class CircuitBreaker:
    """Per-expert-slot rolling fault scores and probation bookkeeping.

    Host state only: ``record_fault`` bumps scores and returns the slots
    that just crossed the trip threshold; ``decay`` ages every score once
    per tick.
    """

    def __init__(self, policy: ResiliencePolicy,
                 rng: np.random.Generator) -> None:
        self.policy = policy
        self.rng = rng
        self.scores: dict[int, float] = {}
        #: slot -> {"next": tick, "backoff": ticks, "probes": n}
        self.probation: dict[int, dict] = {}

    def record_fault(self, slots, weight: float) -> list[int]:
        tripped = []
        for s in slots:
            s = int(s)
            self.scores[s] = self.scores.get(s, 0.0) + weight
            if (self.scores[s] >= self.policy.breaker_threshold
                    and s not in self.probation):
                tripped.append(s)
        return tripped

    def decay(self) -> None:
        for s in list(self.scores):
            self.scores[s] *= self.policy.breaker_decay
            if self.scores[s] < 1e-3:
                del self.scores[s]

    def start_probation(self, slot: int, tick: int) -> None:
        b = self.policy.probe_base_ticks
        self.probation[slot] = {"next": tick + b, "backoff": b,
                                "probes": 0}

    def due_probes(self, tick: int) -> list[int]:
        return sorted(s for s, p in self.probation.items()
                      if tick >= p["next"])

    def probe_failed(self, slot: int, tick: int) -> None:
        p = self.probation[slot]
        p["probes"] += 1
        p["backoff"] = min(p["backoff"] * 2, self.policy.probe_max_ticks)
        p["next"] = tick + p["backoff"] + int(self.rng.integers(0, 2))

    def end_probation(self, slot: int) -> None:
        self.probation.pop(slot, None)
        self.scores.pop(slot, None)


# --------------------------------------------------------------------------
# Crash-recovery journal
# --------------------------------------------------------------------------


class RequestJournal:
    """Append-only on-disk journal.

    Layout under ``journal_dir``::

        journal.jsonl       one JSON record per line, append-only
        req_<seq>.npz       submit payload (seed or noise, text, bounds)
        snap_<tick>.npz     per-request row state + meta

    ``npz`` payloads are written to a temporary file and moved into place
    with ``os.replace``, so a crash mid-write never leaves a half-readable
    file (the jsonl tail may be torn: the reader drops an undecodable last
    line).  A journaled request needs an int seed or explicit noise: a
    ``torch.Generator``'s state is not recorded.
    """

    def __init__(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self.path = path
        self._f = open(os.path.join(path, "journal.jsonl"), "a",
                       buffering=1)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def event(self, ev: str, **fields) -> None:
        self._f.write(json.dumps({"ev": ev, **fields}) + "\n")

    def _atomic_savez(self, name: str, **arrays) -> None:
        tmp = os.path.join(self.path, f".tmp_{name}")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, os.path.join(self.path, name))

    @staticmethod
    def check_replayable(req) -> None:
        """Raise unless ``req`` can be replayed from the journal."""
        if req.noise is None and not isinstance(req.seed,
                                                (int, np.integer)):
            raise ValueError(
                "a journaled request needs an int seed or noise= (a "
                "torch.Generator's state cannot be replayed)")

    def record_submit(self, req, tick: int, text_emb) -> None:
        self.check_replayable(req)
        payload = {"batch_size": np.int64(req.batch_size)}
        if req.noise is not None:
            payload["noise"] = np.asarray(torch.as_tensor(req.noise).cpu())
        else:
            payload["seed"] = np.int64(req.seed)
        if text_emb is not None:
            payload["text"] = np.asarray(torch.as_tensor(text_emb).cpu())
        if req.deadline_s is not None:
            payload["deadline_s"] = np.float64(req.deadline_s)
        if req.max_steps is not None:
            payload["max_steps"] = np.int64(req.max_steps)
        self._atomic_savez(f"req_{req.seq:06d}.npz", **payload)
        self.event("submit", seq=req.seq, tick=tick,
                   batch=req.batch_size, deadline_s=req.deadline_s,
                   max_steps=req.max_steps)

    def load_submit(self, seq: int) -> dict | None:
        p = os.path.join(self.path, f"req_{seq:06d}.npz")
        if not os.path.exists(p):
            return None
        with np.load(p, allow_pickle=False) as z:
            def get(name, conv):
                return conv(z[name]) if name in z.files else None

            return {
                "seed": get("seed", int),
                "noise": get("noise", np.asarray),
                "batch_size": int(z["batch_size"]),
                "text": get("text", np.asarray),
                "deadline_s": get("deadline_s", float),
                "max_steps": get("max_steps", int),
            }

    def write_snapshot(self, tick: int, arrays: dict, meta: dict) -> None:
        arrays = dict(arrays)
        arrays["meta"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
        self._atomic_savez(f"snap_{tick:06d}.npz", **arrays)
        self.event("snapshot", tick=tick,
                   resident=[r["seq"] for r in meta["resident"]])

    def events(self) -> list[dict]:
        p = os.path.join(self.path, "journal.jsonl")
        if not os.path.exists(p):
            return []
        out = []
        with open(p) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    break            # torn tail record from a crash
        return out

    def latest_snapshot(self) -> tuple[dict, dict] | None:
        """(arrays, meta) of the newest readable snapshot, or None."""
        paths = sorted(glob.glob(os.path.join(self.path, "snap_*.npz")))
        for p in reversed(paths):
            try:
                with np.load(p, allow_pickle=False) as z:
                    arrays = {k: np.asarray(z[k]) for k in z.files
                              if k != "meta"}
                    meta = json.loads(bytes(z["meta"]).decode())
                return arrays, meta
            except Exception:        # noqa: BLE001 — torn snapshot
                continue
        return None


# --------------------------------------------------------------------------
# Resilient scheduler
# --------------------------------------------------------------------------


class ResilientScheduler(ContinuousScheduler):
    """Rolling scheduler plus deadlines, watchdog, breakers and journal.

    Admission consults the per-bucket backoff windows, every admitted and
    resolved request is journaled, and resolved latents pass a host
    finiteness gate that charges escapes to the routed expert slots.  All
    policy state is host-side; on the fault-free path the step and its
    outputs are the base scheduler's.  On a mesh only rank 0 holds the
    ``journal`` (``None`` on the others; ``journaled`` says whether the
    scheduler keeps one).
    """

    def __init__(self, engine, *, policy: ResiliencePolicy | None = None,
                 journal_dir: str | None = None, **kwargs) -> None:
        super().__init__(engine, **kwargs)
        self.policy = policy if policy is not None else ResiliencePolicy()
        self.rng = np.random.default_rng(self.policy.seed)
        self.breaker = CircuitBreaker(self.policy, self.rng)
        self.journaled = journal_dir is not None
        lead = engine.mesh is None or engine.mesh.rank == 0
        self.journal = (RequestJournal(journal_dir)
                        if self.journaled and lead else None)
        #: failed-bucket signature -> (retry-at tick, attempt count)
        self._backoff: dict[tuple, tuple[int, int]] = {}
        self._probe_count = 0
        if self.journal is not None:
            self.journal.event("open", tick=self.step_count)

    # -- submission ---------------------------------------------------------

    def submit(self, seed_or_generator, text_emb=None,
               batch_size: int | None = None, *, noise=None,
               deadline_s: float | None = None,
               max_steps: int | None = None):
        """Enqueue a request with optional lifetime bounds: ``deadline_s``
        on the scheduler's ``clock`` and ``max_steps`` ticks, both from
        submit.  Either expiring before resolution moves the request to
        DEADLINE_EXCEEDED at the next tick boundary."""
        req = super().submit(seed_or_generator, text_emb, batch_size,
                             noise=noise)
        req.deadline_s = deadline_s
        req.max_steps = max_steps
        req.submit_t = self._timings[req.seq].submit_t
        if self.journal is not None:
            self.journal.record_submit(req, self.step_count, text_emb)
        elif self.journaled:
            RequestJournal.check_replayable(req)     # as rank 0 does
        return req

    # -- tick ---------------------------------------------------------------

    def step(self) -> int:
        self._expire_deadlines()
        self._run_probes()
        resolved = super().step()
        self.breaker.decay()
        if self.journal is not None:
            self.journal.event(
                "tick", tick=self.step_count,
                epoch=self.engine.membership_epoch,
                resolved=resolved, resident=self.num_resident,
                queued=len(self._queue),
            )
        if self.journaled and (
                self.step_count % max(1, self.policy.snapshot_every) == 0
                and (self.num_resident or self._queue)):
            self._write_snapshot()
        return resolved

    # -- deadlines ----------------------------------------------------------

    def _expired(self, req, now: float) -> bool:
        tm = self._timings.get(req.seq)
        if tm is None:
            return False
        if req.max_steps is not None \
                and self.step_count - tm.submit_step >= req.max_steps:
            return True
        if req.deadline_s is not None \
                and now - tm.submit_t >= req.deadline_s:
            return True
        return False

    def _expire_deadlines(self) -> None:
        """Tick-boundary deadline sweep over queued and resident requests
        (host bookkeeping; an expired resident's rows go back to the
        sentinel).  On a mesh the ranks' verdicts are agreed first: a
        request expired on any rank's clock expires on every rank."""
        now = self.clock()
        resident = [(b, r) for b in self._buckets.values()
                    for r in b.resident_requests()]
        flags = [self._expired(r, now) for r in self._queue] + \
            [self._expired(r, now) for _, r in resident]
        if self.engine.mesh is not None:
            flags = self.engine.mesh.agree(flags)
        nq = len(self._queue)
        expired_q = [r for r, f in zip(self._queue, flags[:nq]) if f]
        if expired_q:
            # identity filter: the dataclass __eq__ would compare tensors
            dead = {id(r) for r in expired_q}
            self._queue = [r for r in self._queue if id(r) not in dead]
            for req in expired_q:
                self._deadline(req)
        for (bucket, req), f in zip(resident, flags[nq:]):
            if f:
                bucket.release(req)
                self._deadline(req)

    def _deadline(self, req) -> None:
        tm = self._timings.pop(req.seq, None)
        waited = self.step_count - tm.submit_step if tm else -1
        req.state = "DEADLINE_EXCEEDED"
        req.error = DeadlineExceeded(
            f"request seq={req.seq} exceeded its deadline after "
            f"{waited} tick(s) ({req.requeues} requeue(s); "
            f"deadline_s={req.deadline_s}, max_steps={req.max_steps})",
            seq=req.seq, requeues=req.requeues,
        )
        self.engine.stats["deadline_exceeded"] += 1
        if self.journal is not None:
            self.journal.event("deadline", seq=req.seq,
                               tick=self.step_count)

    # -- watchdog + bucket retry backoff ------------------------------------

    def _advance(self, bucket: RollingBatch) -> None:
        budget = self.policy.tick_budget_s
        t0 = self.clock()
        super()._advance(bucket)
        if budget is not None and self.clock() - t0 > budget:
            # host wall time of the tick (see the module docstring); a
            # slow tick fails only this bucket (``step`` isolates the
            # raise into ``_fail_bucket``)
            self.engine.stats["watchdog_trips"] += 1
            raise TickBudgetExceeded(
                f"bucket launch took {self.clock() - t0:.3f}s > tick "
                f"budget {budget}s"
            )

    def _fail_bucket(self, sig: tuple, bucket: RollingBatch, e) -> None:
        self._attribute_dispatch_fault(bucket)
        residents = bucket.resident_requests()
        super()._fail_bucket(sig, bucket, e)
        until, attempt = self._backoff.get(sig, (0, 0))
        attempt += 1
        delay = min(self.policy.retry_base_ticks * (2 ** (attempt - 1)),
                    self.policy.retry_max_ticks)
        delay += int(round(delay * self.policy.retry_jitter
                           * float(self.rng.random())))
        self._backoff[sig] = (self.step_count + delay, attempt)
        if self.journal is not None:
            self.journal.event("bucket_failed", tick=self.step_count,
                               error=repr(e), backoff_ticks=delay,
                               attempt=attempt)
            for req in residents:
                self.journal.event(
                    "failed" if req.state == "FAILED" else "requeued",
                    seq=req.seq, tick=self.step_count,
                    requeues=req.requeues,
                )

    def _admission_blocked(self, sig: tuple) -> bool:
        until, _ = self._backoff.get(sig, (0, 0))
        return self.step_count < until

    def _attribute_dispatch_fault(self, bucket: RollingBatch) -> None:
        """Charge a bucket failure to the slots its in-flight rows last
        routed through.  Rows that never advanced carry no routing yet
        (zeroed slot buffers) and are skipped, not charged to slot 0.  On
        a mesh every rank charges rank 0's slots (a tick that failed on
        one rank after its last agreement has advanced on the others)."""
        rows = [i for i, r in enumerate(bucket.rows)
                if r is not None
                and 0 < int(bucket.t_host[i]) < bucket.num_steps]
        slots = []
        if rows:
            # a device read, on the fault path only
            si = bucket.slot_idx[rows].cpu()
            slots = sorted({int(s) for s in si.reshape(-1)})
        if self.engine.mesh is not None:
            slots = self.engine.mesh.broadcast_object(slots)
        if not slots:
            return
        tripped = self.breaker.record_fault(slots,
                                            self.policy.dispatch_fault)
        self._trip(tripped)

    # -- admit / resolve hooks ----------------------------------------------

    def _on_admit(self, req, bucket: RollingBatch) -> None:
        if self.journal is not None:
            self.journal.event("admit", seq=req.seq,
                               tick=self.step_count,
                               rows=bucket.rows_of(req.seq))

    def _accept_result(self, bucket: RollingBatch, req, out,
                       rows) -> bool:
        if self.policy.check_numerics and not bool(
                torch.isfinite(out).all()):       # the resolution gate
            self._reject_nonfinite(bucket, req, rows)
            return False
        self._backoff.pop(self._sig(req), None)
        if self.journal is not None:
            self.journal.event("resolve", seq=req.seq,
                               tick=self.step_count)
        return True

    def _first_step_slots(self, req, bucket: RollingBatch) -> list[int]:
        """Recompute the routing of the request's *first* step.

        Once non-finite latents reach the router, the carried slots
        refresh into junk (top-k over NaN) and no longer name the
        culprit.  The first step's routing follows exactly from what the
        host knows — the request's noise through ``fusion_weights`` under
        the bucket's admission-time membership — and a poisoned store
        corrupts from the first step, so its routed slots are the
        suspects."""
        eng = self.engine
        membership = bucket.membership
        store = membership[1] if membership is not None else eng.param_store
        cmap = membership[3] if membership is not None else None
        valid = store.routing_mask()
        cfg = eng.sampler
        noise = eng._noise(req.seed, req.batch_size, req.noise)
        t0 = _time_grid(cfg.num_steps)[0].to(eng.device).expand(
            req.batch_size)
        w = fusion_weights(
            eng.experts, eng.router_fn, noise, t0,
            strategy=cfg.strategy, top_k=cfg.top_k,
            threshold=cfg.threshold,
            ddpm_low_noise_only=cfg.ddpm_low_noise_only,
            valid=valid, cluster_map=cmap,
        )
        idx, wgt = routed_slots(w, bucket.slot_idx.shape[-1], valid=valid)
        idx = idx.reshape(-1).tolist()  # lint: allow-host-sync — fault path
        wgt = wgt.reshape(-1).tolist()  # lint: allow-host-sync — fault path
        return sorted({int(s) for s, g in zip(idx, wgt) if g > 0})

    def _reject_nonfinite(self, bucket: RollingBatch, req, rows) -> None:
        """A NaN/Inf escape at resolution: charge it to the routed slots,
        trip the breaker, and re-queue the request under a *fresh*
        membership snapshot (its admission-time one still holds the
        faulty store and would fail the same way)."""
        eng = self.engine
        slots = self._first_step_slots(req, bucket)
        tripped = self.breaker.record_fault(slots,
                                            self.policy.nonfinite_fault)
        self._trip(tripped)
        req.requeues += 1
        if req.requeues > eng.max_request_requeues:
            req.state = "FAILED"
            req.error = RequestFailed(
                f"request seq={req.seq} failed after {req.requeues} "
                f"dispatch attempt(s): non-finite latents escaped the "
                f"compiled step (routed slots {slots})",
                seq=req.seq, requeues=req.requeues,
            )
            eng.stats["failed_requests"] += 1
            self._timings.pop(req.seq, None)
        else:
            req.state = "QUEUED"
            req._membership = eng._membership()
            eng.stats["request_requeues"] += 1
            self._queue.append(req)
            self._queue.sort(key=lambda r: r.seq)
        if self.journal is not None:
            self.journal.event(
                "failed" if req.state == "FAILED" else "requeued",
                seq=req.seq, tick=self.step_count, nonfinite=True,
                slots=slots,
            )

    # -- breaker trip / canary probes ---------------------------------------

    def _trip(self, slots) -> None:
        eng = self.engine
        if not eng.elastic:
            return
        for s in slots:
            if eng.expert_health[s] != "ACTIVE":
                continue
            if eng.num_live_experts <= 1:
                # never trip the last live expert: degraded serving
                # beats serving nothing
                continue
            eng.trip_expert(s)
            self.breaker.start_probation(s, self.step_count)
            if self.journal is not None:
                self.journal.event("trip", slot=s, tick=self.step_count)

    def _run_probes(self) -> None:
        eng = self.engine
        if not eng.elastic:
            return
        for slot in self.breaker.due_probes(self.step_count):
            eng.stats["breaker_probes"] += 1
            if self._probe(slot):
                eng.restore_expert(slot)
                self.breaker.end_probation(slot)
                eng.stats["breaker_restores"] += 1
                if self.journal is not None:
                    self.journal.event("restore", slot=slot,
                                       tick=self.step_count)
            else:
                self.breaker.probe_failed(slot, self.step_count)

    def _probe(self, slot: int) -> bool:
        """Synthetic canary: one unconditioned sample routed through
        ``slot`` alone (a one-hot liveness mask over the same store), run
        by the sampler directly so it adds nothing to ``degraded_steps``
        or the request counters."""
        eng = self.engine
        self._probe_count += 1
        store = eng.param_store
        onehot = torch.zeros((store.num_experts,), dtype=torch.bool,
                             device=eng.device)
        onehot[slot] = True
        lo = store.first_expert
        probe = store.with_valid(onehot[lo:lo + store.num_resident])
        if store.routing_valid is not None:        # a resident slice
            probe = dataclasses.replace(probe, routing_valid=onehot)
        gen = torch.Generator(device=eng.device)
        gen.manual_seed(self.policy.seed * 1_000_003 + self._probe_count)
        try:
            out = sample_ensemble(
                eng.experts, eng.expert_params, eng.router_fn,
                (1,) + tuple(eng.latent_shape), generator=gen,
                config=eng.sampler, engine=eng.engine,
                stacked_params=probe,
                coeff_tables=eng._coeff_tables,
                cluster_map=eng._cluster_map, mesh=eng.mesh)
            return bool(torch.isfinite(out).all())
        except Exception:            # noqa: BLE001 — a crashing probe fails
            return False

    # -- journal snapshot / restore -----------------------------------------

    def _write_snapshot(self) -> None:
        """Every resident request's row state and the scheduler's meta to
        the journal.  On a mesh every rank runs the gathers (the latent of
        a bucket split over "data") and rank 0 writes."""
        eng = self.engine
        wholes = [(sig, bucket, bucket.whole_x())
                  for sig, bucket in self._buckets.items()
                  if bucket.num_resident]
        if self.journal is None:
            eng.stats["journal_snapshots"] += 1
            return
        arrays: dict = {}
        resident_meta = []
        for sig, bucket, whole in wholes:
            for req in bucket.resident_requests():
                st = bucket.row_state(req.seq, whole)
                arrays[f"r{req.seq}_x"] = st["x"]
                arrays[f"r{req.seq}_t"] = st["t"]
                arrays[f"r{req.seq}_si"] = st["slot_idx"]
                arrays[f"r{req.seq}_sw"] = st["slot_w"]
                tm = self._timings[req.seq]
                resident_meta.append({
                    "seq": req.seq, "batch": req.batch_size,
                    "submit_step": tm.submit_step,
                    "admit_step": tm.admit_step, "epoch": sig[2],
                    "requeues": req.requeues,
                })
        meta = {
            "tick": self.step_count,
            "resident": resident_meta,
            "queued": [
                {"seq": r.seq,
                 "submit_step": self._timings[r.seq].submit_step,
                 "requeues": r.requeues}
                for r in self._queue
            ],
            "epoch": eng.membership_epoch,
            # health-derived live mask — no device read on the event path
            "live_mask": [h == "ACTIVE" for h in eng.expert_health]
            if eng.elastic else None,
            "next_seq": eng._seq,
            "steps_per_tick": self.steps_per_tick,
            "max_resident": self.max_resident,
        }
        self.journal.write_snapshot(self.step_count, arrays, meta)
        eng.stats["journal_snapshots"] += 1

    @classmethod
    def restore(cls, engine, journal_dir: str, *,
                policy: ResiliencePolicy | None = None,
                clock=time.perf_counter, **kwargs) -> "ResilientScheduler":
        """Rebuild a scheduler from a journal and re-admit in-flight work.

        ``engine`` must hold the expert set the journal was written
        under; membership is checked against the snapshot's live mask
        and a mismatch raises :class:`JournalRestoreError`.

        Resident requests re-enter at their last snapshot's row state
        (the continuation equals an uninterrupted run's bitwise); queued
        submits re-enter the queue in seq order.  ``max_steps`` deadlines
        resume exactly (submit ticks are journaled); ``deadline_s``
        budgets restart at the restore (the dead process's wall time is
        unknowable).
        """
        reader = RequestJournal(journal_dir)
        try:
            events = reader.events()
            if not events:
                raise JournalRestoreError(
                    f"{journal_dir}: no journal records")
            snap = reader.latest_snapshot()
            terminal = {
                e["seq"] for e in events
                if e["ev"] in ("resolve", "failed", "deadline")
            }
            submits = {e["seq"]: e for e in events if e["ev"] == "submit"}
        finally:
            reader.close()
        if engine.mesh is not None:
            # every rank has read the journal before rank 0 appends to it
            engine.mesh.barrier()

        arrays, meta = snap if snap is not None else ({}, None)
        if meta is not None and meta.get("live_mask") is not None:
            if not engine.elastic:
                raise JournalRestoreError(
                    "journal was written by an elastic engine; restore "
                    "target is fixed-membership"
                )
            current = [h == "ACTIVE" for h in engine.expert_health]
            if current != meta["live_mask"]:
                raise JournalRestoreError(
                    f"membership diverged from the snapshot: engine "
                    f"live mask {current} != journaled "
                    f"{meta['live_mask']} — rebuild the engine from the "
                    f"same checkpoints (and membership ops) first"
                )
        if meta is not None:
            kwargs.setdefault("max_resident", meta["max_resident"])
            kwargs.setdefault("steps_per_tick", meta["steps_per_tick"])
        sched = cls(engine, policy=policy, journal_dir=journal_dir,
                    clock=clock, **kwargs)
        sched.step_count = meta["tick"] if meta is not None else max(
            (e.get("tick", 0) for e in events), default=0)

        from repro_torch.launch.serve import PendingRequest

        def rebuild(seq: int, extra: dict | None):
            payload = reader.load_submit(seq)
            if payload is None:
                raise JournalRestoreError(
                    f"journal names request seq={seq} but its submit "
                    f"payload req_{seq:06d}.npz is missing/unreadable"
                )
            req = PendingRequest(
                seed=payload["seed"],
                text_emb=engine._cached_cond(payload["text"]),
                batch_size=payload["batch_size"],
                noise=payload["noise"],
                _membership=engine._membership(),
                seq=seq,
            )
            req.deadline_s = payload["deadline_s"]
            req.max_steps = payload["max_steps"]
            now = sched.clock()
            req.submit_t = now
            info = extra or {}
            req.requeues = info.get("requeues", 0)
            sched._timings[seq] = RequestTiming(
                submit_t=now,
                submit_step=info.get("submit_step",
                                     submits[seq].get("tick", 0)),
            )
            return req

        restored_resident = set()
        for info in sorted((meta or {}).get("resident", []),
                           key=lambda r: r["seq"]):
            seq = info["seq"]
            if seq in terminal:
                continue
            req = rebuild(seq, info)
            sig = sched._sig(req)
            bucket = sched._buckets.get(sig)
            if bucket is None:
                bucket = sched._make_bucket(sig, req)
                sched._buckets[sig] = bucket
            bucket.admit_restored(
                req, arrays[f"r{seq}_x"], arrays[f"r{seq}_t"],
                arrays[f"r{seq}_si"], arrays[f"r{seq}_sw"],
            )
            req.state = "RESIDENT"
            tm = sched._timings[seq]
            tm.admit_t = sched.clock()
            tm.admit_step = info.get("admit_step", tm.submit_step)
            restored_resident.add(seq)

        queued_meta = {q["seq"]: q for q in (meta or {}).get("queued", [])}
        pending = sorted(s for s in submits
                         if s not in terminal and s not in restored_resident)
        for seq in pending:
            sched._queue.append(rebuild(seq, queued_meta.get(seq)))
        engine._seq = max(
            [s + 1 for s in submits]
            + [(meta or {}).get("next_seq", 0), engine._seq])
        if sched.journal is not None:
            sched.journal.event(
                "restored", tick=sched.step_count,
                resident=sorted(restored_resident), queued=pending,
            )
        return sched
