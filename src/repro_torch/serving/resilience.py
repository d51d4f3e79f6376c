"""Named terminal errors of a served request.

``ServingEngine.submit`` returns a ``PendingRequest`` whose ``result()``
raises one of these instead of hanging its caller: the request's group
failed past its re-queues (``RequestFailed``), it outlived its
``deadline_s`` (``DeadlineExceeded``), or ``result(timeout=...)`` gave up
waiting (``RequestTimeout``).  The rest of the reference's resilience
layer (watchdogs, breakers, the journal) is ROADMAP.md, module queue A.6.
"""

from __future__ import annotations


class RequestError(RuntimeError):
    """Base for per-request terminal errors; carries the request id
    (``seq``) and how many automatic re-queues it burned."""

    def __init__(self, message: str, *, seq: int = -1,
                 requeues: int = 0) -> None:
        super().__init__(message)
        self.seq = seq
        self.requeues = requeues


class RequestFailed(RequestError):
    """Terminal FAILED: the request exhausted its re-queue budget."""


class DeadlineExceeded(RequestError):
    """Terminal DEADLINE_EXCEEDED: the request outlived its ``deadline_s``
    before it was dispatched."""


class RequestTimeout(RequestError):
    """``result(timeout=...)`` gave up waiting — the request is still in
    flight (nobody flushed the engine)."""
