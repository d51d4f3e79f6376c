"""Latency/throughput observability for the continuous-batching scheduler.

The engine's ``stats`` dict counts discrete events (requests, cache
hits).  Continuous batching adds *distributions*: how
long a request queued before admission and how long it took end to end,
in both wall-clock seconds and scheduler steps.  This module is the
recorder behind ``ServingEngine.stats``'s ``latency_*``/``queue_wait_*``
percentile fields and ``scheduler_line()``.

Percentiles use the deterministic nearest-rank definition (the smallest
recorded value with at least ``q``% of samples at or below it), so tests
can assert exact values and two runs over the same trace agree bit-for-
bit — no interpolation.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RequestTiming:
    """Per-request clock/step marks, keyed by ``PendingRequest.seq``.

    ``submit_*`` is stamped when the request enters the scheduler queue,
    ``admit_*`` when it becomes resident in a rolling batch; resolution
    closes the record into the recorder's series.
    """

    submit_t: float
    submit_step: int
    admit_t: float | None = None
    admit_step: int | None = None


def percentile(values: list[float], q: float) -> float | None:
    """Nearest-rank percentile: smallest value covering ``q``% of samples.

    ``rank = ceil(q/100 · n)`` (1-indexed) over the sorted values.
    Deterministic, interpolation-free, and exact for test assertions.
    An empty series has no percentiles: returns None (never a made-up
    0.0 that would read as "zero latency" in ``engine.stats``); a
    single-sample series returns that sample for every ``q``.
    """
    if not values:
        return None
    s = sorted(values)
    rank = max(1, -(-int(q * len(s)) // 100))  # ceil(q*n/100), >= 1
    return s[min(rank, len(s)) - 1]


class LatencyRecorder:
    """Accumulates per-request latency samples and derives summary stats.

    Series (all per *request*, recorded once at resolution):

    * ``queue_wait_s`` / ``queue_wait_steps`` — submit → admission;
    * ``e2e_s`` / ``e2e_steps`` — submit → resolution (the user-visible
      latency, including queue wait).

    ``snapshot()`` folds them into a flat dict of floats suitable for
    merging into ``ServingEngine.stats`` and for the BENCH JSON.
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.queue_wait_s: list[float] = []
        self.queue_wait_steps: list[float] = []
        self.e2e_s: list[float] = []
        self.e2e_steps: list[float] = []
        self.images = 0
        self.first_t: float | None = None
        self.last_t: float | None = None

    def observe(
        self,
        *,
        queue_wait_s: float,
        e2e_s: float,
        queue_wait_steps: int,
        e2e_steps: int,
        images: int,
        now: float,
    ) -> None:
        """Record one resolved request (``images`` samples) at time ``now``."""
        self.queue_wait_s.append(float(queue_wait_s))
        self.queue_wait_steps.append(float(queue_wait_steps))
        self.e2e_s.append(float(e2e_s))
        self.e2e_steps.append(float(e2e_steps))
        self.images += int(images)
        if self.first_t is None:
            # throughput window opens at the first *resolution* minus its
            # own e2e time (~ the first submit), so a single-request run
            # still reports a finite rate.
            self.first_t = now - float(e2e_s)
        self.last_t = now

    @property
    def completed(self) -> int:
        return len(self.e2e_s)

    def throughput(self) -> float:
        """Resolved images per second over the observation window."""
        if self.first_t is None or self.last_t is None:
            return 0.0
        span = self.last_t - self.first_t
        if span <= 0.0:
            return 0.0
        return self.images / span

    def snapshot(self) -> dict:
        """Flat summary dict (merged into ``ServingEngine.stats``).

        Percentile keys are OMITTED while their series is empty —
        publishing a placeholder would poison ``engine.stats`` with
        fake zero-latency figures that dashboards can't tell from real
        ones.
        """
        out = {
            "completed_requests": float(self.completed),
            "completed_images": float(self.images),
            "throughput_img_s": self.throughput(),
        }
        for name, series, unit in (
            ("queue_wait", self.queue_wait_s, "s"),
            ("latency", self.e2e_s, "s"),
            ("queue_wait", self.queue_wait_steps, "steps"),
            ("latency", self.e2e_steps, "steps"),
        ):
            for q in (50, 95, 99):
                p = percentile(series, q)
                if p is not None:
                    out[f"{name}_p{q}_{unit}"] = p
        return out
