"""Bounded request queue with admission control
(``bigdl_tpu/serving/queue.py``, host-only copy).

A request is turned away synchronously when the queue is at capacity, when
the server is draining, or when its deadline is provably unmeetable (even
the best-case observed service time would overrun it).  Everything admitted
is eventually resolved — drain flushes, it never drops.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional

from bigdl_tpu_torch.serving.errors import (DeadlineUnmeetableError,
                                            DrainingError, QueueFullError)

_rids = itertools.count(1)


class Request:
    """One admitted inference request.  ``deadline`` is an absolute
    ``time.monotonic()`` instant (or None); the result or typed failure is
    delivered through ``future``.  The fleet's admission plane stamps each
    request with its ``(tenant, priority, deadline_class)`` triple:
    ``priority`` is a 0-based class index (0 = most urgent, popped first),
    the other two are census tags."""

    __slots__ = ("rid", "features", "deadline", "future", "t_submit",
                 "tenant", "priority", "deadline_class")

    def __init__(self, features, deadline: Optional[float] = None,
                 tenant: Optional[str] = None,
                 priority: int = 0,
                 deadline_class: Optional[str] = None):
        self.rid = next(_rids)
        self.features = features
        self.deadline = deadline
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.tenant = tenant
        self.priority = int(priority)
        self.deadline_class = deadline_class

    def slack(self, now: float) -> Optional[float]:
        """Seconds until the deadline (None when unbounded)."""
        return None if self.deadline is None else self.deadline - now


class AdmissionQueue:
    """Bounded FIFO of :class:`Request` with reject-at-the-door admission.

    ``floor_fn`` returns the server's best-case service time; a deadline
    closer than that floor sheds immediately.  ``on_depth`` (if given) is
    called with the new depth after every enqueue and dequeue — the
    queue-depth gauge hook.

    ``levels`` > 1 arms priority classes (the fleet's admission plane): a
    request lands in the level of its ``Request.priority`` (clamped into
    range; 0 = most urgent) and ``take`` pops the lowest non-empty level
    first, FIFO within it.  The capacity bound covers all levels together.
    ``levels=1`` (the default) is the plain FIFO.
    """

    def __init__(self, capacity: int,
                 floor_fn: Optional[Callable[[], float]] = None,
                 on_depth: Optional[Callable[[int], None]] = None,
                 levels: int = 1):
        if capacity <= 0:
            raise ValueError(f"queue capacity must be > 0, got {capacity}")
        if levels < 1:
            raise ValueError(f"priority levels must be >= 1, got {levels}")
        self.capacity = int(capacity)
        self.levels = int(levels)
        self._floor_fn = floor_fn
        self._on_depth = on_depth
        self._qs = [deque() for _ in range(self.levels)]
        self._cond = threading.Condition()
        self._closed = False

    def offer(self, req: Request, now: Optional[float] = None) -> None:
        """Admit ``req`` or raise a typed ``ShedError`` — never blocks."""
        with self._cond:
            if self._closed:
                raise DrainingError("server is draining; request rejected")
            depth = sum(len(q) for q in self._qs)
            if depth >= self.capacity:
                raise QueueFullError(
                    f"request queue full ({self.capacity} pending)")
            if req.deadline is not None:
                floor = self._floor_fn() if self._floor_fn else 0.0
                now = time.monotonic() if now is None else now
                if req.deadline - now < floor:
                    raise DeadlineUnmeetableError(
                        f"deadline {req.deadline - now:.4f}s away but the "
                        f"best-case service time is {floor:.4f}s — "
                        "provably unmeetable")
            level = min(max(int(getattr(req, "priority", 0)), 0),
                        self.levels - 1)
            self._qs[level].append(req)
            self._cond.notify()
            depth += 1
        if self._on_depth is not None:
            self._on_depth(depth)

    def take(self, timeout: Optional[float] = None) -> Optional[Request]:
        """Pop the oldest request, blocking up to ``timeout`` seconds
        (forever with None).  Returns None on timeout or when the queue is
        closed AND empty."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not any(self._qs):
                if self._closed:
                    return None
                if end is None:
                    self._cond.wait()
                else:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)
            req = next(q for q in self._qs if q).popleft()
            depth = sum(len(q) for q in self._qs)
        if self._on_depth is not None:
            self._on_depth(depth)
        return req

    def close(self) -> None:
        """Stop admitting and wake every blocked consumer; queued requests
        remain takeable."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def depth(self) -> int:
        with self._cond:
            return sum(len(q) for q in self._qs)

    def depth_by_level(self) -> list:
        """Per-priority-level depths."""
        with self._cond:
            return [len(q) for q in self._qs]
