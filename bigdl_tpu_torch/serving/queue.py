"""Bounded request queue with admission control
(``bigdl_tpu/serving/queue.py``, host-only copy without the fleet's
priority levels).

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
    delivered through ``future``."""

    __slots__ = ("rid", "features", "deadline", "future", "t_submit")

    def __init__(self, features, deadline: Optional[float] = None):
        self.rid = next(_rids)
        self.features = features
        self.deadline = deadline
        self.future: Future = Future()
        self.t_submit = time.monotonic()

    def slack(self, now: float) -> Optional[float]:
        """Seconds until the deadline (None when unbounded)."""
        return None if self.deadline is None else self.deadline - now


class AdmissionQueue:
    """Bounded FIFO of :class:`Request` with reject-at-the-door admission.

    ``floor_fn`` returns the server's best-case service time; a deadline
    closer than that floor sheds immediately.
    """

    def __init__(self, capacity: int,
                 floor_fn: Optional[Callable[[], float]] = None):
        if capacity <= 0:
            raise ValueError(f"queue capacity must be > 0, got {capacity}")
        self.capacity = int(capacity)
        self._floor_fn = floor_fn
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False

    def offer(self, req: Request, now: Optional[float] = None) -> None:
        """Admit ``req`` or raise a typed ``ShedError`` — never blocks."""
        with self._cond:
            if self._closed:
                raise DrainingError("server is draining; request rejected")
            if len(self._q) >= self.capacity:
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
            self._q.append(req)
            self._cond.notify()

    def take(self, timeout: Optional[float] = None) -> Optional[Request]:
        """Pop the oldest request, blocking up to ``timeout`` seconds
        (forever with None).  Returns None on timeout or when the queue is
        closed AND empty."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._q:
                if self._closed:
                    return None
                if end is None:
                    self._cond.wait()
                else:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)
            return self._q.popleft()

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
            return len(self._q)
