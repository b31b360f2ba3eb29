"""Circuit breaker around the device forward worker
(``bigdl_tpu/serving/breaker.py``, host-only copy).

The training path survives faults by retrying (``resilience.retry``);
an online path additionally needs *failure isolation*: once the forward
is failing consistently (a wedged device runtime, a poisoned
executable), every further dispatch wastes queue time and device slots
on work that will die anyway.  The breaker converts that state into
fast, typed failures:

* **closed** — healthy; every batch dispatches.  ``failure_threshold``
  CONSECUTIVE forward failures (transient one-offs are absorbed by the
  retry layer underneath) trip it open.
* **open** — dispatch is known-broken: new submissions and already
  queued requests fail fast with :class:`BreakerOpenError` until
  ``reset_timeout_s`` has elapsed.
* **half-open** — one probe batch is allowed through; success closes
  the breaker, failure re-opens it (with a fresh cooldown).

Each worker of the pool owns one breaker and runs one batch at a time,
so "one probe at a time" is structural.  Transitions are reported
through ``on_transition(old, new, failures)``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:

    def __init__(self, failure_threshold: int = 3,
                 reset_timeout_s: float = 1.0,
                 on_transition: Optional[Callable[[str, str, int],
                                                  None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive
        self._opened_at = 0.0

    # -- internals ----------------------------------------------------------

    def _transition(self, new: str):
        """Caller holds the lock.  Returns the ``(old, new, failures)``
        callback payload (or None); the caller fires it via
        :meth:`_notify` AFTER releasing the lock — the server's callback
        does synchronous ledger I/O, which must never block concurrent
        ``admits()`` checks on the lock."""
        old, self._state = self._state, new
        if new == OPEN:
            self._opened_at = self._clock()
        if old != new and self._on_transition is not None:
            return (old, new, self._failures)
        return None

    def _notify(self, fire) -> None:
        if fire is not None:
            self._on_transition(*fire)

    # -- queries ------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._failures

    def admits(self) -> bool:
        """Admission-time check: False only while OPEN with the cooldown
        still running (requests admitted after cooldown become the probe
        traffic that can close the breaker)."""
        with self._lock:
            if self._state != OPEN:
                return True
            return self._clock() - self._opened_at >= self.reset_timeout_s

    # -- dispatch protocol --------------------------------------------------

    def before_dispatch(self) -> str:
        """Called by the worker immediately before a batch forward.
        Returns ``"ok"`` (dispatch normally), ``"probe"`` (dispatch as
        the half-open probe) or ``"open"`` (fail the batch fast)."""
        fire = None
        with self._lock:
            if self._state == CLOSED:
                return "ok"
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.reset_timeout_s:
                    return "open"
                fire = self._transition(HALF_OPEN)
        self._notify(fire)
        return "probe"              # HALF_OPEN (single worker: one probe)

    def record_success(self) -> None:
        fire = None
        with self._lock:
            self._failures = 0
            if self._state != CLOSED:
                fire = self._transition(CLOSED)
        self._notify(fire)

    def record_failure(self) -> None:
        fire = None
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN:
                fire = self._transition(OPEN)   # failed probe: re-open
            elif (self._state == CLOSED
                  and self._failures >= self.failure_threshold):
                fire = self._transition(OPEN)
        self._notify(fire)
