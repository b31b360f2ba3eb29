"""Typed failure taxonomy of the serving runtime
(``bigdl_tpu/serving/errors.py``, host-only copy).

Every way a request can fail has its own exception type carrying a
machine-readable ``reason`` string:

* :class:`ShedError` subtypes — rejected synchronously at ``submit()``
  before any work was queued (admission control);
* post-admission failures (:class:`DeadlineExceededError`,
  :class:`ForwardFailedError`, :class:`PackFailedError`) — delivered
  through the request's future; the batch around them is unaffected.

``InvalidRequestError`` subclasses ``ValueError`` too.
"""

from __future__ import annotations


class ServingError(RuntimeError):
    """Base of every serving-runtime failure."""

    reason = "error"


class ShedError(ServingError):
    """Admission rejected the request synchronously (load shedding)."""

    reason = "shed"


class QueueFullError(ShedError):
    """The bounded request queue is at capacity (backpressure)."""

    reason = "queue_full"


class DeadlineUnmeetableError(ShedError):
    """Even dispatched immediately, the best-case observed service time
    would overrun the request's deadline."""

    reason = "deadline_unmeetable"


class BreakerOpenError(ShedError):
    """Every worker's circuit breaker is open: the forward path is
    known-broken, so the request fails fast."""

    reason = "breaker_open"


class DrainingError(ShedError):
    """The server is draining (or closed): admission has stopped."""

    reason = "draining"


class SlotCapacityError(ShedError):
    """A generation request can never fit the KV cache: its prompt plus
    ``max_new`` exceeds the cache length, its prompt the largest prefill
    bucket, or its tokens the whole page pool.  Admitting it would overrun
    the cache, so ``ContinuousGenerator`` sheds it at ``submit()``."""

    reason = "over_capacity"


class MemoryBudgetError(ShedError):
    """The tenant's device-memory budget cannot cover the request's KV
    bytes (pages for ``prompt + max_new``), even after the degradation
    ladder (budgeter reclaimers, prefix-cache leaves, idle-session parking)
    has run.  Byte starvation sheds typed instead of surfacing later as a
    device out-of-memory crash; neighbour tenants' budgets are untouched."""

    reason = "byte_starved"


class UnknownTenantError(ShedError):
    """The fleet's admission plane has no tenant by that name: it was never
    registered, or was deregistered while the client still held the
    handle.  Shed synchronously and attributably, so a request for a
    rolled-out model never lands in another tenant's queue."""

    reason = "unknown_tenant"


class InvalidRequestError(ServingError, ValueError):
    """The request's feature payload has the wrong shape or size for the
    classifier's batch shape — rejected at ``submit()``."""

    reason = "invalid"


class DeadlineExceededError(ServingError):
    """Accepted, but the deadline expired while queued — cancelled before
    device dispatch."""

    reason = "expired"


class PackFailedError(ServingError):
    """Host-side batch packing failed (does not count against the device
    circuit breaker)."""

    reason = "pack_failed"


class ForwardFailedError(ServingError):
    """The device forward for this request's batch failed after any
    configured retries; counts toward opening the circuit breaker."""

    reason = "forward_failed"
