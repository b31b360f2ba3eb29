"""Deadline-aware dynamic batch formation
(``bigdl_tpu/serving/batcher.py``, host-only copy).

The fixed-shape forward of ``api.DLClassifier`` wants full batches (the
same argument that pads tail chunks in the offline path).  Online traffic
does not arrive in batches, so the batcher trades latency for
occupancy under an explicit policy: a batch dispatches when

* it is **full** (``batch_size`` requests), or
* the **oldest request has waited** ``max_delay_s`` (the idle-traffic
  latency cap), or
* the **tightest deadline's slack runs out**: for every member with a
  deadline the dispatch instant is pulled forward to
  ``deadline - est_fn()`` (estimated batch service time), so waiting
  for more traffic can never be the thing that makes an admitted
  request miss its deadline, or
* the queue is **draining** and empty — partial flush, nothing waits
  for traffic that will never come.

The batcher only *forms* batches; expiry cancellation, packing and the
breaker gate happen at dispatch, in
:mod:`bigdl_tpu_torch.serving.scheduler.pool`.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from bigdl_tpu_torch.serving.queue import AdmissionQueue, Request


class DeadlineBatcher:

    def __init__(self, queue: AdmissionQueue, batch_size: int,
                 max_delay_s: float = 0.005,
                 est_fn: Optional[Callable[[], float]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.queue = queue
        self.batch_size = int(batch_size)
        self.max_delay_s = float(max_delay_s)
        self.est_fn = est_fn or (lambda: 0.0)
        self.clock = clock

    def _tighten(self, limit: float, req: Request) -> float:
        """Pull the dispatch instant forward for a deadline-carrying
        member: the batch must leave early enough that the estimated
        service time still fits inside the member's deadline."""
        if req.deadline is not None:
            limit = min(limit, req.deadline - self.est_fn())
        return limit

    def next_batch(self) -> Optional[List[Request]]:
        """Block until a batch is ready (or return None: drained).  The
        returned list is non-empty, at most ``batch_size`` long, in
        arrival order.

        The linger window is anchored at the OLDEST member's submit
        instant (``Request.t_submit``, same ``time.monotonic`` clock as
        the default ``clock``), so a request that already queued behind
        a backlog for ``max_delay_s`` is never made to wait again.  Once
        the window has passed, already-queued requests are still drained
        without waiting — an expired linger caps *waiting for new
        traffic*, not batch fill from a hot queue."""
        first = self.queue.take()           # blocks; None == closed+empty
        if first is None:
            return None
        batch = [first]
        limit = self._tighten(first.t_submit + self.max_delay_s, first)
        while len(batch) < self.batch_size:
            wait = limit - self.clock()
            req = self.queue.take(timeout=max(wait, 0.0))
            if req is None:
                if self.queue.closed:
                    break                   # draining: flush the partial
                if wait <= 0:
                    break                   # linger over AND queue empty
                continue                    # timed out; loop re-checks limit
            batch.append(req)
            limit = self._tighten(limit, req)
        return batch
