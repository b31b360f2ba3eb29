"""In-process online-inference server over a ``DLClassifier`` forward
(``bigdl_tpu/serving/server.py``).

Kept from the reference: admission control (bounded queue, typed
synchronous sheds), deadline-aware dynamic batching, a batch-bucket
ladder, a worker pool with per-worker circuit breakers, forward retries
within the deadline, expiry cancellation before dispatch, graceful drain
that loses no admitted request, and the telemetry: ledger spans
(``serve.warmup``, ``serve.dispatch``, ``serve.pack``, ``serve.forward``),
per-request ``serve.request`` and per-batch ``serve.batch`` records,
breaker and shed events, ``Metrics`` under the reference's names, the live
``/metrics`` endpoint (``metrics_port``), periodic ``.prom`` snapshots,
the SLO tracker and its trace captures.  The fault injector's serving
sites (``serve.pack``, ``serve.forward``, ``serve.worker<i>.forward``) are
the pool's (``scheduler/pool.py``); ``forward_retries`` retries a forward
that raised one of ``RETRYABLE_IO_ERRORS``, as in the reference.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.observability import tracer
from bigdl_tpu_torch.observability.live import (LiveMetricsServer,
                                                MetricsSnapshotter,
                                                SLOTracker)
from bigdl_tpu_torch.observability.prometheus import metrics_to_prometheus
# the nearest-rank percentile run-report uses, so the live stats() and the
# rendered report never disagree
from bigdl_tpu_torch.observability.report import _percentile
from bigdl_tpu_torch.optim.metrics import LATENCY_BUCKETS_S, Metrics
from bigdl_tpu_torch.serving.batcher import DeadlineBatcher
from bigdl_tpu_torch.serving.errors import (BreakerOpenError, DrainingError,
                                            InvalidRequestError, ShedError)
from bigdl_tpu_torch.serving.queue import AdmissionQueue, Request
from bigdl_tpu_torch.serving.scheduler.buckets import (BucketLadder,
                                                       BucketedRunner)
from bigdl_tpu_torch.serving.scheduler.pool import WorkerPool

logger = logging.getLogger("bigdl_tpu_torch.serving")

# request and forward latencies kept for stats() percentiles
_LATENCY_WINDOW = 4096

# capture files are pid-qualified and numbered across the process, so
# two servers in one process never collide
_capture_ids = itertools.count(1)


class InferenceServer:
    """Online front for a :class:`bigdl_tpu_torch.api.DLClassifier`.

    ``submit(row, deadline_s=...)`` either raises a typed ``ShedError``
    (or ``InvalidRequestError``) synchronously or returns a ``Future`` that
    resolves to the 1-based predicted class or to a typed
    ``ServingError``.  Use as a context manager, or call :meth:`drain`.

    ``device`` must name the classifier's device; like every entry point of
    the port it defaults to ``"cuda"`` and raises when CUDA is absent.

    Live telemetry: ``metrics_port`` starts a stdlib HTTP ``/metrics``
    endpoint serving the Prometheus text live (0 = an ephemeral port, see
    ``metrics_url``; None = off) bound to ``metrics_host``;
    ``snapshot_interval_s`` writes periodic ``.prom`` snapshots next to
    the ledger (0/None = off); the ``slo_*`` knobs configure the
    deadline-hit-rate tracker, whose ``slo.burn`` event, with the ledger
    on, flushes the last ``capture_window_s`` seconds as a Chrome-trace
    capture file.
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
                 metrics_port: Optional[int] = None,
                 metrics_host: str = "127.0.0.1",
                 snapshot_interval_s: float = 5.0,
                 slo_target: float = 0.99,
                 slo_window: int = 128,
                 slo_min_samples: int = 16,
                 slo_burn_threshold: float = 1.0,
                 slo_p99_threshold_s: Optional[float] = None,
                 capture_window_s: float = 30.0,
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

        self.metrics = Metrics()
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

        self.queue = AdmissionQueue(
            queue_capacity, floor_fn=lambda: self._floor_s,
            on_depth=lambda d: self.metrics.set("serve.queue depth", d,
                                                unit="scalar"))
        self.batcher = DeadlineBatcher(
            self.queue, self.batch_size, max_delay_s=max_delay_s,
            est_fn=lambda: self._est_s)
        self.pool = WorkerPool(self, num_workers,
                               breaker_threshold=breaker_threshold,
                               breaker_reset_s=breaker_reset_s)
        # -- live telemetry (observability.live) --
        self.capture_window_s = float(capture_window_s)
        self._captures: List[threading.Thread] = []
        self.slo = SLOTracker(target=slo_target, window=slo_window,
                              min_samples=slo_min_samples,
                              burn_threshold=slo_burn_threshold,
                              p99_threshold_s=slo_p99_threshold_s,
                              on_trigger=self._on_slo_burn)
        self.live: Optional[LiveMetricsServer] = None
        self._snapshotter: Optional[MetricsSnapshotter] = None

        if warmup:
            # each worker warms every rung in its own thread
            with tracer.span("serve.warmup", buckets=list(self.ladder)):
                timings = self.pool.start(warmup=True)
            self._update_estimates()
            logger.info("serving warmup: %s",
                        ", ".join(f"bucket {b}={t:.4f}s"
                                  for b, t in sorted(timings.items())))
        else:
            self.pool.start(warmup=False)
        # endpoint and snapshotter start once construction can no longer
        # fail (the warmup can raise)
        if metrics_port is not None:
            self.live = LiveMetricsServer(
                lambda: metrics_to_prometheus(self.metrics),
                host=metrics_host, port=metrics_port)
        led = run_ledger.get_ledger()
        if led is not None and snapshot_interval_s:
            self._snapshotter = MetricsSnapshotter(
                lambda: metrics_to_prometheus(self.metrics),
                os.path.join(led.dir,
                             f"metrics-serving-{os.getpid()}.prom"),
                interval_s=snapshot_interval_s)
        self.pool.open()

    @property
    def metrics_url(self) -> Optional[str]:
        """The live ``/metrics`` endpoint's URL (None without
        ``metrics_port``)."""
        return self.live.url if self.live is not None else None

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
        joined = self.pool.join(timeout)
        if self.live is not None:
            self.live.close()
        if self._snapshotter is not None:
            self._snapshotter.close()     # final on-disk snapshot
        for t in self._captures:          # captures durable by shutdown
            t.join(timeout=10.0)
        run_ledger.flush()
        return joined

    close = drain

    @property
    def draining(self) -> bool:
        return self._closed

    @property
    def breaker(self):
        """Worker 0's circuit breaker."""
        return self.pool.workers[0].breaker

    def ledger_tags(self) -> dict:
        """Census tags merged into every ``serve.batch``/``serve.shed``
        record the worker pipeline writes for this server.  The
        single-tenant server tags nothing (the reference's fleet front
        returns ``{"tenant": name}``)."""
        return {}

    # -- admission ----------------------------------------------------------

    def _shed(self, exc: ShedError) -> None:
        self.metrics.incr(f"serve.shed.{exc.reason}")
        run_ledger.emit("event", kind="serve.shed", reason=exc.reason)
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
            run_ledger.emit("event", kind="serve.shed", reason="invalid")
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
        run_ledger.emit_critical("event", kind="serve.breaker",
                                 **{"from": old, "to": new,
                                    "failures": failures, "worker": wid})
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
        if status == "ok":
            # the fixed-ladder latency histogram (aggregatable across
            # workers)
            self.metrics.observe("serve.latency", dur, LATENCY_BUCKETS_S)
        run_ledger.emit("serve.request", rid=req.rid, status=status,
                        dur_s=dur)
        # every terminal outcome is a hit or a miss of the deadline
        # objective; a cancel is the client's choice, not a miss
        if status != "cancelled":
            self.slo.observe(status == "ok", dur)

    def _on_slo_burn(self, info: dict) -> None:
        """SLO breach trigger: flush a trace-export capture of the last
        ``capture_window_s`` seconds next to the ledger, on a thread of
        its own (the request-completion path that saw the burn must not
        wait on file I/O); ``drain()`` joins outstanding captures."""
        led = run_ledger.get_ledger()
        if led is None:
            return
        seq = next(_capture_ids)
        path = os.path.join(
            led.dir, f"capture-{os.getpid()}-{seq}.json")

        def _capture():
            from bigdl_tpu_torch.observability import trace as run_trace
            out = run_trace.export_file(led.dir, path,
                                        since_s=self.capture_window_s)
            if out is not None:
                run_ledger.emit_critical("trace.capture", path=out,
                                         reason=info.get("reason"),
                                         burn=info.get("burn"),
                                         window_s=self.capture_window_s)

        t = threading.Thread(target=_capture, daemon=True,
                             name="bigdl-torch-trace-capture")
        self._captures = [c for c in self._captures if c.is_alive()]
        self._captures.append(t)
        t.start()

    def _fail_batch(self, requests: List[Request], status: str,
                    make_exc) -> None:
        for r in requests:
            self._finish(r, status, exc=make_exc())

    def _fail_fleet_open(self, seq: int, batch: List[Request]) -> None:
        """Every worker's breaker refuses: fail the batch fast."""
        run_ledger.emit("event", kind="serve.shed",
                        reason="breaker_open", count=len(batch))
        run_ledger.emit("serve.batch", seq=seq, size=len(batch),
                        capacity=self.batch_size,
                        occupancy=len(batch) / self.batch_size,
                        status="breaker_open")
        for r in batch:
            if not r.future.set_running_or_notify_cancel():
                self.metrics.incr("serve.cancelled")
                continue
            self.metrics.incr("serve.shed.breaker_open")
            self._finish(r, "breaker_open", exc=BreakerOpenError(
                "every worker's circuit breaker is open: forward path is "
                "failing"))
        self.metrics.incr("serve.batches")

    def _emit_run_start(self) -> None:
        run_ledger.emit("run.start", kind="InferenceServer",
                        pid=os.getpid(),
                        thread=threading.get_ident(),
                        trace=run_ledger.trace_id(),
                        batch=self.batch_size,
                        buckets=list(self.ladder),
                        workers=len(self.pool.workers),
                        queue_capacity=self.queue.capacity,
                        metrics_url=self.metrics_url,
                        slo_target=self.slo.target)

    def _run_end(self, wall_s: float) -> None:
        with self._lat_lock:
            lats = sorted(d for s, d in self._latencies if s == "ok")
        # ns values (no unit) export as _seconds gauges, like the trainers
        self.metrics.set("serve.latency p50", _percentile(lats, 50) * 1e9)
        self.metrics.set("serve.latency p95", _percentile(lats, 95) * 1e9)
        self.metrics.set("serve.latency p99", _percentile(lats, 99) * 1e9)
        slo = self.slo.snapshot()
        self.metrics.set("serve.slo hit rate", slo["hit_rate"],
                         unit="scalar")
        led = run_ledger.get_ledger()
        if led is None:
            return
        run_ledger.emit("run.end", kind="InferenceServer",
                        pid=os.getpid(), wall_s=wall_s,
                        batches=self._batch_seq,
                        workers=len(self.pool.workers),
                        slo=slo)
        from bigdl_tpu_torch.observability.prometheus import \
            write_prometheus
        write_prometheus(self.metrics,
                         os.path.join(
                             led.dir,
                             f"metrics-serving-{os.getpid()}.prom"))
        led.flush()

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
                          "forward_p50_s": _percentile(durs, 50),
                          "forward_p99_s": _percentile(durs, 99),
                          "rows_per_s": rows / busy if busy > 0 else 0.0}
        with self._pool_lock:
            workers = {w.wid: {"breaker": w.breaker.state,
                               "pending": w.pending,
                               "batches": w.batches}
                       for w in self.pool.workers}
        local, _, _ = self.metrics.snapshot()
        return {
            "counters": {name: v for name, (v, _p) in local.items()},
            "queue_depth": self.queue.depth,
            "breaker": self.pool.workers[0].breaker.state,
            "workers": workers,
            "buckets": buckets,
            "batches": self._batch_seq,
            "est_batch_s": self._est_s,
            "floor_s": self._floor_s,
            "latency_p50_s": _percentile(lats, 50),
            "latency_p95_s": _percentile(lats, 95),
            "latency_p99_s": _percentile(lats, 99),
            "slo": self.slo.snapshot(),
            "metrics_url": self.metrics_url,
        }
