"""Continuous batching scheduler: a rolling mixed-timestep batch.

``ServingEngine.flush()`` is *lockstep*: requests coalesce into one batch
that enters and leaves the sampler together, so a late request waits a
whole ``num_steps`` dispatch.  :class:`ContinuousScheduler` keeps the
batch **rolling** instead: every tick advances all resident rows one
Euler step (``core.sampling.sample_ensemble_step``), each row at its own
``t_idx``; requests join at the next step boundary as soon as rows free,
and finished rows are sliced out and resolved at once.

* **admission control** — requests queue FIFO by ``PendingRequest.seq``
  (the engine's global submission counter) and are admitted when their
  bucket has ``batch_size`` free rows.  ``submit`` raises
  :class:`QueueBackpressure` past ``max_queue_depth`` and
  :class:`AdmissionError` for a request wider than a bucket.
* **shape buckets** — keyed on the conditioning signature (text present,
  its trailing shape) and, on an elastic engine, the membership epoch the
  request was admitted under.  Each bucket owns one
  :class:`~repro_torch.serving.batch.RollingBatch` of ``max_resident``
  rows.
* **states** — QUEUED → RESIDENT → DONE, or FAILED after
  ``engine.max_request_requeues`` re-queues; a failing bucket re-queues
  its residents in seq order.
* **snapshots** — a bucket keeps its admission-time membership, so
  membership changes in flight cannot change its requests' outputs; a
  new epoch opens a new bucket while the old one drains.
* **observability** — ``metrics`` records queue wait and end-to-end
  latency per request, in seconds and ticks; each tick folds the
  percentiles into ``engine.stats`` and :meth:`line` renders them.
* **hooks** — :meth:`_admission_blocked`, :meth:`_on_admit` and
  :meth:`_accept_result` are the seams the resilience layer
  (``serving.resilience.ResilientScheduler``) builds on.

A tick reads nothing from the device to schedule: completion and the
router-skip decision run off each bucket's host mirror of ``t_idx``.
"""

from __future__ import annotations

import time

from repro_torch.core.sampling import sample_ensemble_step
from repro_torch.serving.batch import RollingBatch, advanced
from repro_torch.serving.metrics import LatencyRecorder, RequestTiming


class AdmissionError(RuntimeError):
    """A request the admission controller can never schedule."""


class QueueBackpressure(AdmissionError):
    """Queue depth hit ``max_queue_depth`` — shed load and retry later."""


class ContinuousScheduler:
    """Rolling mixed-timestep scheduler over a ``ServingEngine``.

    Construction checks the engine against the rolling step's
    restrictions (routed engine, per-sample strategy, step-fused), so a
    misconfiguration fails at build time.  ``steps_per_tick`` Euler steps
    run per tick (one ``fused_step`` launch each); rows that finish
    mid-tick freeze.  ``clock`` is injectable for deterministic tests.
    """

    def __init__(
        self,
        engine,
        *,
        max_resident: int = 8,
        max_queue_depth: int = 256,
        steps_per_tick: int = 1,
        clock=time.perf_counter,
    ) -> None:
        if max_resident < 1:
            raise ValueError(f"max_resident must be >= 1, got {max_resident}")
        if steps_per_tick < 1:
            raise ValueError(
                f"steps_per_tick must be >= 1, got {steps_per_tick}"
            )
        cfg = engine.sampler
        if cfg.strategy not in ("top1", "topk"):
            raise ValueError(
                f"continuous batching requires per-sample routing "
                f"(strategy 'top1' or 'topk'); got {cfg.strategy!r}"
            )
        if not cfg.step_fused:
            raise ValueError(
                "continuous batching runs on the step-fused hot path "
                "only; construct the engine with step_fused=True"
            )
        if engine.engine not in ("auto", "routed"):
            raise ValueError(
                f"continuous batching requires the routed engine; got "
                f"engine={engine.engine!r}"
            )
        if engine.param_store is None or len(engine.experts) <= 1:
            raise ValueError(
                "continuous batching needs a homogeneous ensemble of "
                ">= 2 experts (stacked param store)"
            )
        self.engine = engine
        self.max_resident = max_resident
        self.max_queue_depth = max_queue_depth
        self.steps_per_tick = steps_per_tick
        self.clock = clock
        self.metrics = LatencyRecorder()
        self.step_count = 0
        K = len(engine.experts)
        self.k_slots = 1 if cfg.strategy == "top1" else min(cfg.top_k, K)
        self._queue: list = []                       # QUEUED, seq order
        self._buckets: dict[tuple, RollingBatch] = {}
        self._timings: dict[int, RequestTiming] = {}

    # -- submission ---------------------------------------------------------

    def submit(self, seed_or_generator, text_emb=None,
               batch_size: int | None = None, *, noise=None):
        """Enqueue a request; returns the engine's ``PendingRequest``.

        The noise is drawn from the request's own seed at admission (or
        is ``noise``), so the resolved samples are what ``generate``
        from that seed returns.  Raises :class:`QueueBackpressure` when
        the queue is full and :class:`AdmissionError` when
        ``batch_size`` exceeds ``max_resident``.
        """
        from repro_torch.launch.serve import PendingRequest

        eng = self.engine
        if batch_size is None:
            batch_size = text_emb.shape[0] if text_emb is not None else 1
        if text_emb is not None and text_emb.shape[0] != batch_size:
            raise ValueError(
                f"text_emb batch {text_emb.shape[0]} != batch_size "
                f"{batch_size}"
            )
        if batch_size > self.max_resident:
            raise AdmissionError(
                f"batch_size {batch_size} > max_resident "
                f"{self.max_resident}: the request can never fit a "
                f"rolling bucket — split it or raise max_resident"
            )
        if len(self._queue) >= self.max_queue_depth:
            raise QueueBackpressure(
                f"scheduler queue is full ({self.max_queue_depth} "
                f"requests waiting); retry after step() drains it"
            )
        req = PendingRequest(
            seed=seed_or_generator, text_emb=eng._cached_cond(text_emb),
            batch_size=batch_size, noise=noise,
            _membership=eng._membership(), seq=eng._next_seq(),
        )
        self._timings[req.seq] = RequestTiming(
            submit_t=self.clock(), submit_step=self.step_count
        )
        self._queue.append(req)
        eng.stats["requests"] += 1
        return req

    # -- scheduling tick ----------------------------------------------------

    def step(self) -> int:
        """One tick: admit, advance every bucket ``steps_per_tick`` Euler
        steps, resolve finished requests.  Returns the number resolved."""
        self.step_count += 1
        self._admit()
        for sig, bucket in list(self._buckets.items()):
            if bucket.num_resident == 0:
                continue
            try:
                self._advance(bucket)
            except Exception as e:          # noqa: BLE001 — isolate bucket
                self._fail_bucket(sig, bucket, e)
        resolved = self._collect()
        self._gc_buckets()
        self.engine.stats.update(self.metrics.snapshot())
        self.engine.stats["scheduler_steps"] = self.step_count
        return resolved

    def run_until_idle(self, max_steps: int = 100_000) -> int:
        """Tick until queue and buckets are empty; returns the number
        resolved.  ``max_steps`` bounds a livelocked loop loudly."""
        total = 0
        while self._queue or self.num_resident:
            if self.step_count >= max_steps:
                raise RuntimeError(
                    f"scheduler not idle after {max_steps} steps: "
                    f"queued={len(self._queue)} "
                    f"resident={self.num_resident}"
                )
            total += self.step()
        return total

    # -- introspection ------------------------------------------------------

    @property
    def num_resident(self) -> int:
        return sum(b.num_resident for b in self._buckets.values())

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def max_pending_wait_steps(self) -> int:
        """Ticks the oldest still-queued request has waited (0 if none)."""
        waits = [
            self.step_count - self._timings[r.seq].submit_step
            for r in self._queue
        ]
        return max(waits, default=0)

    def line(self) -> str:
        """One-line scheduler summary (the serve CLI prints it).

        Percentile fields are absent from the snapshot until the first
        request resolves (empty-window percentiles are None, not 0.0 —
        see ``metrics.percentile``), so the line degrades to "-" rather
        than printing garbage or raising on a cold scheduler."""
        s = self.metrics.snapshot()

        def f(key, scale=1.0, fmt=".0f"):
            v = s.get(key)
            return "-" if v is None else format(v * scale, fmt)

        return (
            f"scheduler: step={self.step_count} "
            f"resident={self.num_resident}/{self.max_resident} "
            f"queued={len(self._queue)} "
            f"done={self.metrics.completed} "
            f"({s['throughput_img_s']:.1f} img/s) "
            f"wait p50={f('queue_wait_p50_steps')} "
            f"p95={f('queue_wait_p95_steps')} steps "
            f"e2e p50={f('latency_p50_s', 1e3)} "
            f"p95={f('latency_p95_s', 1e3)} ms"
        )

    # -- internals ----------------------------------------------------------

    def _sig(self, req) -> tuple:
        has_text = req.text_emb is not None
        tail = tuple(req.text_emb.shape[1:]) if has_text else ()
        epoch = req._membership[0] if req._membership is not None else -1
        return (has_text, tail, epoch)

    def _admit(self) -> None:
        """FIFO admission with per-bucket head-of-line blocking: a request
        that does not fit blocks later requests of the same bucket, not
        other buckets."""
        eng = self.engine
        blocked: set[tuple] = set()
        rest: list = []
        for req in self._queue:
            sig = self._sig(req)
            if sig in blocked or self._admission_blocked(sig):
                rest.append(req)
                continue
            bucket = self._buckets.get(sig)
            if bucket is None:
                bucket = self._make_bucket(sig, req)
                self._buckets[sig] = bucket
            if bucket.free_count() < req.batch_size:
                blocked.add(sig)
                rest.append(req)
                continue
            bucket.admit(req, eng._noise(req.seed, req.batch_size,
                                         req.noise))
            req.state = "RESIDENT"
            tm = self._timings[req.seq]
            tm.admit_t = self.clock()
            tm.admit_step = self.step_count
            # each admitted request refreshes its routing ⌈S/R⌉ times
            r = max(1, eng.sampler.plan_refresh_every)
            eng.stats["plan_refreshes"] += -(-eng.sampler.num_steps // r)
            self._on_admit(req, bucket)
        self._queue = rest

    # -- resilience hooks (no-ops here; ResilientScheduler overrides) -------

    def _admission_blocked(self, sig: tuple) -> bool:
        """Extra per-bucket admission gate (e.g. retry backoff windows)."""
        return False

    def _on_admit(self, req, bucket: RollingBatch) -> None:
        """Called once per admitted request (e.g. journal the admit)."""

    def _accept_result(self, bucket: RollingBatch, req, out, rows) -> bool:
        """Vet a finished request's latents before it resolves DONE.

        ``rows`` are the bucket rows the request occupied (already
        released).  Return False to veto: the hook owns the terminal
        state and bookkeeping, and ``_collect`` skips the DONE path."""
        return True

    def _make_bucket(self, sig: tuple, req) -> RollingBatch:
        has_text, tail, _epoch = sig
        return RollingBatch(
            capacity=self.max_resident,
            latent_shape=self.engine.latent_shape,
            k_slots=self.k_slots,
            num_steps=self.engine.sampler.num_steps,
            device=self.engine.device,
            text_tail=tail if has_text else None,
            membership=req._membership,
        )

    def _advance(self, bucket: RollingBatch) -> None:
        eng = self.engine
        fn = self._get_rolling_step(bucket.text is not None,
                                    bucket.text_tail)
        if eng.elastic:
            eng._note_degraded(bucket.membership, steps=self.steps_per_tick)
        bucket.store_state(*fn(bucket.x, bucket.t_idx, bucket.slot_idx,
                               bucket.slot_w, bucket.t_host, bucket.text,
                               bucket.membership))
        bucket.advance_host(self.steps_per_tick)

    def _get_rolling_step(self, has_text: bool, text_tail):
        """The tick's step function ``fn(x, t_idx, slot_idx, slot_w,
        t_host, text, membership)``: ``steps_per_tick`` calls of
        ``sample_ensemble_step``, the host mirror advanced between them.
        The seam fault injection wraps (``launch.chaos``)."""
        eng = self.engine
        spt = self.steps_per_tick
        S = eng.sampler.num_steps

        def tick(x, t_idx, slot_idx, slot_w, t_host, text, membership):
            cond = {"text_emb": text} if has_text else None
            null = {"text_emb": None} if has_text else None
            store, tables, cmap = eng.param_store, None, None
            if membership is not None:
                _, store, tables, cmap, _ = membership
            state = (x, t_idx, slot_idx, slot_w)
            for _ in range(spt):
                state = sample_ensemble_step(
                    eng.experts, eng.expert_params, eng.router_fn, *state,
                    t_host=t_host, cond=cond, null_cond=null,
                    config=eng.sampler, engine=eng.engine,
                    stacked_params=store, coeff_tables=tables,
                    cluster_map=cmap)
                t_host = advanced(t_host, S, 1)
            return state

        return tick

    def _collect(self) -> int:
        """Resolve every request whose rows all reached the grid end."""
        resolved = 0
        for bucket in self._buckets.values():
            if bucket.num_resident == 0:
                continue
            for req in bucket.finished_requests():
                rows = bucket.rows_of(req.seq)
                out = bucket.resolve(req)
                if not self._accept_result(bucket, req, out, rows):
                    continue
                req._result = out
                req.done = True
                req.state = "DONE"
                tm = self._timings.pop(req.seq)
                now = self.clock()
                self.metrics.observe(
                    queue_wait_s=tm.admit_t - tm.submit_t,
                    e2e_s=now - tm.submit_t,
                    queue_wait_steps=tm.admit_step - tm.submit_step,
                    e2e_steps=self.step_count - tm.submit_step,
                    images=req.batch_size,
                    now=now,
                )
                resolved += 1
        return resolved

    def _fail_bucket(self, sig: tuple, bucket: RollingBatch, e) -> None:
        """Isolate a failing bucket: release and re-queue its residents in
        seq order (FAILED past the re-queue budget) and drop the bucket
        (its buffers may be poisoned)."""
        eng = self.engine
        for req in bucket.resident_requests():
            bucket.release(req)
            req.requeues += 1
            if req.requeues > eng.max_request_requeues:
                req.state = "FAILED"
                req.error = e
                eng.stats["failed_requests"] += 1
                self._timings.pop(req.seq, None)
            else:
                req.state = "QUEUED"
                eng.stats["request_requeues"] += 1
                self._queue.append(req)
        self._queue.sort(key=lambda r: r.seq)
        del self._buckets[sig]

    def _gc_buckets(self) -> None:
        """Drop drained buckets of old epochs; complete DRAINING slots
        (``retire_expert``) once nothing in flight holds them."""
        eng = self.engine
        if not eng.elastic:
            return
        for sig in [
            s for s, b in self._buckets.items()
            if b.num_resident == 0 and s[2] != eng.membership_epoch
        ]:
            del self._buckets[sig]
        if not self._queue and self.num_resident == 0:
            for i, h in enumerate(eng.expert_health):
                if h == "DRAINING":
                    eng.expert_health[i] = "EVICTED"
