"""Continuous batching over the port's serving engine (the rolling
mixed-timestep scheduler, admission control, shape buckets, latency
percentiles) and the resilience layer (request deadlines, the step
watchdog, expert circuit breakers, the crash-recoverable journal).

``python -m repro_torch.serving`` runs a self-check: staggered requests
through the rolling batch must equal sequential ``generate`` bitwise.
"""

from repro_torch.serving.batch import RollingBatch
from repro_torch.serving.metrics import (LatencyRecorder, RequestTiming,
                                         percentile)
from repro_torch.serving.resilience import (
    CircuitBreaker,
    DeadlineExceeded,
    JournalRestoreError,
    RequestError,
    RequestFailed,
    RequestJournal,
    RequestTimeout,
    ResiliencePolicy,
    ResilientScheduler,
    TickBudgetExceeded,
)
from repro_torch.serving.scheduler import (
    AdmissionError,
    ContinuousScheduler,
    QueueBackpressure,
)

__all__ = [
    "AdmissionError",
    "CircuitBreaker",
    "ContinuousScheduler",
    "DeadlineExceeded",
    "JournalRestoreError",
    "LatencyRecorder",
    "QueueBackpressure",
    "RequestError",
    "RequestFailed",
    "RequestJournal",
    "RequestTimeout",
    "RequestTiming",
    "ResiliencePolicy",
    "ResilientScheduler",
    "RollingBatch",
    "TickBudgetExceeded",
    "percentile",
]
