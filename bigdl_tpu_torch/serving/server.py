"""In-process online-inference server over a ``DLClassifier`` forward
(``bigdl_tpu/serving/server.py``).

Kept from the reference: admission control (bounded queue, typed
synchronous sheds), deadline-aware dynamic batching, a batch-bucket
ladder, a worker pool with per-worker circuit breakers, forward retries
within the deadline, expiry cancellation before dispatch, and graceful
drain that loses no admitted request.  The run ledger, tracer, fault
injector, live ``/metrics`` endpoint, SLO tracker and trace captures are
not part of this server; they come with the port's host-subsystems slice,
and the constructor takes none of their knobs.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.serving.batcher import DeadlineBatcher
from bigdl_tpu_torch.serving.counters import Counters, percentile
from bigdl_tpu_torch.serving.errors import (BreakerOpenError, DrainingError,
                                            InvalidRequestError, ShedError)
from bigdl_tpu_torch.serving.queue import AdmissionQueue, Request
from bigdl_tpu_torch.serving.scheduler.buckets import (BucketLadder,
                                                       BucketedRunner)
from bigdl_tpu_torch.serving.scheduler.pool import WorkerPool

logger = logging.getLogger("bigdl_tpu_torch.serving")

# request and forward latencies kept for stats() percentiles
_LATENCY_WINDOW = 4096


class InferenceServer:
    """Online front for a :class:`bigdl_tpu_torch.api.DLClassifier`.

    ``submit(row, deadline_s=...)`` either raises a typed ``ShedError``
    (or ``InvalidRequestError``) synchronously or returns a ``Future`` that
    resolves to the 1-based predicted class or to a typed
    ``ServingError``.  Use as a context manager, or call :meth:`drain`.

    ``device`` must name the classifier's device; like every entry point of
    the port it defaults to ``"cuda"`` and raises when CUDA is absent.
    """

    def __init__(self, classifier,
                 queue_capacity: int = 256,
                 max_delay_s: float = 0.005,
                 default_deadline_s: Optional[float] = None,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 1.0,
                 forward_retries: int = 0,
                 retry_backoff_s: float = 0.01,
                 warmup: bool = True,
                 num_workers: int = 1,
                 batch_buckets: Optional[Sequence[int]] = None,
                 device="cuda"):
        dev = resolve_device(device)
        if dev.type != classifier.device.type:
            raise ValueError(f"server device {dev} does not match the "
                             f"classifier's device {classifier.device}")
        self.device = dev
        self.classifier = classifier
        self.ladder = BucketLadder(
            batch_buckets if batch_buckets is not None
            else [classifier.batch_shape[0]])
        self.batch_size = self.ladder.max
        self.default_deadline_s = default_deadline_s
        self.forward_retries = int(forward_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.runner = BucketedRunner(classifier, self.ladder)

        self.metrics = Counters()
        self._lat_lock = threading.Lock()
        self._pool_lock = threading.Lock()
        self._latencies: collections.deque = \
            collections.deque(maxlen=_LATENCY_WINDOW)
        self._forwards: Dict[int, collections.deque] = {
            b: collections.deque(maxlen=_LATENCY_WINDOW) for b in self.ladder}
        self._est_s = 0.0           # EWMA batch service time (planning)
        self._floor_s = 0.0         # best observed (admission proof)
        self._batch_seq = 0
        self._seq_lock = threading.Lock()
        self._closed = False

        self.queue = AdmissionQueue(queue_capacity,
                                    floor_fn=lambda: self._floor_s)
        self.batcher = DeadlineBatcher(
            self.queue, self.batch_size, max_delay_s=max_delay_s,
            est_fn=lambda: self._est_s)
        self.pool = WorkerPool(self, num_workers,
                               breaker_threshold=breaker_threshold,
                               breaker_reset_s=breaker_reset_s)
        timings = self.pool.start(warmup=warmup)
        if warmup:
            self._update_estimates()
            logger.info("serving warmup: %s",
                        ", ".join(f"bucket {b}={t:.4f}s"
                                  for b, t in sorted(timings.items())))

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.drain()

    def _update_estimates(self) -> None:
        self._floor_s = self.runner.floor_s()
        self._est_s = self.runner.est_s()

    def _next_seq(self) -> int:
        with self._seq_lock:
            seq = self._batch_seq
            self._batch_seq += 1
            return seq

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, flush every queued and in-flight request to a
        terminal state, join the dispatcher and every worker.  Idempotent;
        False if the pool did not join within ``timeout``."""
        self._closed = True
        self.queue.close()
        return self.pool.join(timeout)

    close = drain

    @property
    def draining(self) -> bool:
        return self._closed

    @property
    def breaker(self):
        """Worker 0's circuit breaker."""
        return self.pool.workers[0].breaker

    # -- admission ----------------------------------------------------------

    def _shed(self, exc: ShedError) -> None:
        self.metrics.incr(f"serve.shed.{exc.reason}")
        raise exc

    def submit(self, row: Any,
               deadline_s: Optional[float] = None) -> Future:
        """Admit one request or raise a typed error synchronously."""
        if self._closed:
            self._shed(DrainingError("server is draining"))
        feats = self.classifier._features(row)
        mismatch = self.classifier._row_mismatch(feats)
        if mismatch is not None:
            self.metrics.incr("serve.invalid")
            raise InvalidRequestError(mismatch)
        if not self.pool.admits():
            self._shed(BreakerOpenError(
                "every worker's circuit breaker is open: forward path "
                f"is failing (states={self.pool.breaker_states()})"))
        now = time.monotonic()
        ddl = deadline_s if deadline_s is not None \
            else self.default_deadline_s
        req = Request(feats, deadline=None if ddl is None else now + ddl)
        try:
            self.queue.offer(req, now=now)
        except ShedError as e:
            self._shed(e)
        self.metrics.incr("serve.submitted")
        return req.future

    def predict(self, rows: Iterable[Any],
                deadline_s: Optional[float] = None) -> np.ndarray:
        """Submit every row and block for the ordered predictions; raises
        the first per-request failure."""
        futures = [self.submit(r, deadline_s=deadline_s) for r in rows]
        return np.asarray([f.result() for f in futures])

    # -- worker-pool services ------------------------------------------------

    def _on_breaker_transition(self, wid: int, old: str, new: str,
                               failures: int) -> None:
        self.metrics.incr(f"serve.breaker.{new}")
        logger.warning("circuit breaker (worker %d) %s -> %s (%d "
                       "consecutive forward failures)", wid, old, new,
                       failures)

    def _observe_forward(self, bucket: int, rows: int, dur_s: float) -> None:
        with self._lat_lock:
            self._forwards[bucket].append((rows, dur_s))

    def _finish(self, req: Request, status: str,
                result: Optional[int] = None,
                exc: Optional[Exception] = None) -> None:
        """Deliver one request's terminal state.  A future the client
        already cancelled is recorded as such and never aborts delivery
        for the rest of the batch."""
        dur = time.monotonic() - req.t_submit
        try:
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(result)
        except InvalidStateError:
            status = "cancelled"
            self.metrics.incr("serve.cancelled")
        with self._lat_lock:
            self._latencies.append((status, dur))

    def _fail_batch(self, requests: List[Request], status: str,
                    make_exc) -> None:
        for r in requests:
            self._finish(r, status, exc=make_exc())

    def _fail_fleet_open(self, batch: List[Request]) -> None:
        """Every worker's breaker refuses: fail the batch fast."""
        for r in batch:
            if not r.future.set_running_or_notify_cancel():
                self.metrics.incr("serve.cancelled")
                continue
            self.metrics.incr("serve.shed.breaker_open")
            self._finish(r, "breaker_open", exc=BreakerOpenError(
                "every worker's circuit breaker is open: forward path is "
                "failing"))
        self.metrics.incr("serve.batches")

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Snapshot: counters, request-latency percentiles over the window,
        per-bucket forward census, per-worker breaker states."""
        with self._lat_lock:
            lats = sorted(d for s, d in self._latencies if s == "ok")
            fwds = {b: list(v) for b, v in self._forwards.items()}
        buckets = {}
        for b, recs in fwds.items():
            durs = sorted(d for _, d in recs)
            rows = sum(n for n, _ in recs)
            busy = sum(durs)
            buckets[b] = {"batches": len(recs), "rows": rows,
                          "forward_p50_s": percentile(durs, 50),
                          "forward_p99_s": percentile(durs, 99),
                          "rows_per_s": rows / busy if busy > 0 else 0.0}
        with self._pool_lock:
            workers = {w.wid: {"breaker": w.breaker.state,
                               "pending": w.pending,
                               "batches": w.batches}
                       for w in self.pool.workers}
        return {
            "counters": self.metrics.snapshot(),
            "queue_depth": self.queue.depth,
            "breaker": self.pool.workers[0].breaker.state,
            "workers": workers,
            "buckets": buckets,
            "batches": self._batch_seq,
            "est_batch_s": self._est_s,
            "floor_s": self._floor_s,
            "latency_p50_s": percentile(lats, 50),
            "latency_p95_s": percentile(lats, 95),
            "latency_p99_s": percentile(lats, 99),
        }
