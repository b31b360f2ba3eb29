"""Device worker pool: per-worker breakers behind one admission queue
(``bigdl_tpu/serving/scheduler/pool.py``).

N :class:`DeviceWorker` threads, each with its own circuit breaker and
inbox, are fed by one dispatcher thread that forms batches through the
``DeadlineBatcher``.  A formed batch goes to the admitting worker with the
fewest batches in flight; only when no worker admits does a batch fail
fast with ``BreakerOpenError``.

The pool owns the serving run's ``run.start``/``run.end`` ledger records.
The dispatcher's ``serve.dispatch`` span rides to the worker as a trace
link (``observability.trace.current_wire``), so a worker's ``serve.pack``
and ``serve.forward`` spans stitch back to the dispatch that routed them;
every batch writes one ``serve.batch`` record.  ``serve.forward`` closes
after the predictions reach the host, so on the card it spans the
forward's device time.

Fault sites (``resilience/fault_injector.py``), each checked with the
batch's sequence number: ``serve.pack`` inside the pack span (it fails only
its batch, typed ``PackFailedError``, and never the breaker), then
``serve.worker<i>.forward`` (worker ``i``'s forwards only: the seam that
proves one faulted worker does not stall the pool) and ``serve.forward``
inside the retried forward, so an ``=OSError`` fault is retried away by
``forward_retries``.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from typing import List, Optional

from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.observability import trace as run_trace
from bigdl_tpu_torch.observability import tracer
from bigdl_tpu_torch.resilience import RETRYABLE_IO_ERRORS, retry
from bigdl_tpu_torch.resilience.fault_injector import FaultInjector
from bigdl_tpu_torch.serving.breaker import CircuitBreaker
from bigdl_tpu_torch.serving.errors import (BreakerOpenError,
                                            DeadlineExceededError,
                                            ForwardFailedError,
                                            PackFailedError)

logger = logging.getLogger("bigdl_tpu_torch.serving")


class _Warmup:
    """An inbox item that runs a bucket warmup (``fn``, a runner's
    ``warmup``) IN the worker's thread: PyTorch keeps its cuDNN and cuBLAS
    handles per thread, so a rung warmed in another thread still pays their
    set-up on its first served batch."""

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.timings: Optional[dict] = None
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self.timings = self.fn()
        except Exception as e:           # re-raised in the server's thread
            self.error = e
        finally:
            self.done.set()


class DeviceWorker:
    """One serving worker: a thread, an inbox, a breaker.  It pulls
    ``(seq, batch, trace_ctx)`` items (``trace_ctx`` is the dispatcher's
    shipped trace context, possibly None) and runs the dispatch pipeline for each: expiry
    and cancel filtering, its own breaker's gate, bucket pick and pack, the
    retried device forward, ordered delivery.  ``None`` is the drain
    sentinel."""

    def __init__(self, wid: int, server,
                 breaker_threshold: int, breaker_reset_s: float):
        self.wid = wid
        self.server = server
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_threshold,
            reset_timeout_s=breaker_reset_s,
            on_transition=self._on_transition)
        self.inbox: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self.pending = 0                 # batches enqueued, not yet done
        self.batches = 0                 # processed (any status)
        self.thread = threading.Thread(
            target=self._loop, name=f"bigdl-torch-serve-w{wid}", daemon=True)

    def start(self) -> None:
        self.thread.start()

    def _loop(self) -> None:
        while True:
            item = self.inbox.get()
            if item is None:
                break
            if isinstance(item, _Warmup):
                item.run()
                continue
            seq, batch, ctx = item
            try:
                with run_trace.attach(ctx):
                    self.process(seq, batch)
            except Exception:            # the worker must never die
                logger.exception("serving worker %d: unexpected error",
                                 self.wid)
            finally:
                with self.server._pool_lock:
                    self.pending -= 1
                    self.batches += 1

    def _on_transition(self, old: str, new: str, failures: int) -> None:
        self.server._on_breaker_transition(self.wid, old, new, failures)

    def _emit_batch(self, seq: int, size: int, status: str,
                    bucket: Optional[int] = None,
                    dur_s: Optional[float] = None) -> None:
        s = self.server
        fields = dict(seq=seq, size=size, capacity=s.batch_size,
                      occupancy=size / s.batch_size, worker=self.wid,
                      status=status)
        if bucket is not None:
            fields["bucket"] = bucket
            fields["padding_efficiency"] = size / bucket
        if dur_s is not None:
            fields["dur_s"] = dur_s
        fields.update(s.ledger_tags())
        run_ledger.emit("serve.batch", **fields)

    def process(self, seq: int, batch: List) -> None:
        s = self.server
        now = time.monotonic()

        # 1. claim each member; cancel what can no longer meet its
        # deadline BEFORE the device dispatch
        live = []
        for r in batch:
            if not r.future.set_running_or_notify_cancel():
                s.metrics.incr("serve.cancelled")
                run_ledger.emit("serve.request", rid=r.rid,
                                status="cancelled",
                                dur_s=time.monotonic() - r.t_submit,
                                **s.ledger_tags())
                continue
            slack = r.slack(now)
            if slack is not None and slack < s._floor_s:
                s.metrics.incr("serve.expired")
                s._finish(r, "expired", exc=DeadlineExceededError(
                    f"deadline expired while queued (slack "
                    f"{slack * 1e3:.2f}ms < best-case forward "
                    f"{s._floor_s * 1e3:.2f}ms)"))
            else:
                live.append(r)
        if not live:
            # still a dispatch cycle: the counter and the serve.batch
            # census stay in agreement
            s.metrics.incr("serve.batches")
            self._emit_batch(seq, 0, "expired")
            return

        # 2. this worker's breaker gate
        gate = self.breaker.before_dispatch()
        if gate == "open":
            s.metrics.incr("serve.shed.breaker_open", len(live))
            s.metrics.incr("serve.batches")
            run_ledger.emit("event", kind="serve.shed",
                            reason="breaker_open", count=len(live),
                            worker=self.wid, **s.ledger_tags())
            self._emit_batch(seq, len(live), "breaker_open")
            s._fail_batch(live, "breaker_open", lambda: BreakerOpenError(
                f"circuit breaker is open on worker {self.wid}: "
                "forward path is failing"))
            return

        # 3. bucket + pack (host side; never a breaker failure)
        bucket = s.ladder.pick(len(live))
        try:
            with tracer.span("serve.pack", seq=seq, size=len(live),
                             bucket=bucket, worker=self.wid):
                FaultInjector.fire("serve.pack", step=seq)
                x = s.runner.pack([r.features for r in live], bucket)
        except Exception as e:
            s.metrics.incr("serve.failed.pack", len(live))
            s.metrics.incr("serve.batches")
            self._emit_batch(seq, len(live), "pack_failed", bucket=bucket)
            s._fail_batch(live, "pack_failed", lambda: PackFailedError(
                f"batch packing failed: {type(e).__name__}: {e}"))
            return

        # 4. device forward, retried within the tightest member deadline
        # minus this bucket's best-case service time
        slacks = [sl for sl in (r.slack(now) for r in live)
                  if sl is not None]
        budget = max(0.0, min(slacks) - s.runner.floor_s(bucket)) \
            if slacks else None

        def fwd():
            FaultInjector.fire(f"serve.worker{self.wid}.forward", step=seq)
            FaultInjector.fire("serve.forward", step=seq)
            # .cpu() waits for the device, surfacing device errors inside
            # the retry rather than at delivery
            return s.runner.run(x, bucket).cpu().numpy()

        t_fwd = time.monotonic()
        try:
            with tracer.span("serve.forward", seq=seq, size=len(live),
                             bucket=bucket, worker=self.wid,
                             probe=(gate == "probe")):
                preds = retry(fwd, retries=s.forward_retries,
                              backoff=s.retry_backoff_s,
                              retryable=RETRYABLE_IO_ERRORS,
                              deadline=budget, label="serve.forward")
        except Exception as e:
            self.breaker.record_failure()
            s.metrics.incr("serve.failed.forward", len(live))
            s.metrics.incr("serve.batches")
            self._emit_batch(seq, len(live), "failed", bucket=bucket)
            s._fail_batch(
                live, "forward_failed", lambda: ForwardFailedError(
                    f"device forward failed on worker {self.wid}: "
                    f"{type(e).__name__}: {e}"))
            return
        dur_fwd = time.monotonic() - t_fwd

        if preds.ndim < 1 or len(preds) < len(live):
            self.breaker.record_failure()
            s.metrics.incr("serve.failed.forward", len(live))
            s.metrics.incr("serve.batches")
            got = 0 if preds.ndim < 1 else len(preds)
            self._emit_batch(seq, len(live), "failed", bucket=bucket)
            s._fail_batch(
                live, "forward_failed", lambda: ForwardFailedError(
                    f"model produced {got} predictions for "
                    f"{len(live)} rows"))
            return

        # 5. deliver in order; feed the service-time model
        self.breaker.record_success()
        s.runner.observe(bucket, dur_fwd)
        s._update_estimates()
        s._observe_forward(bucket, len(live), dur_fwd)
        for r, p in zip(live, preds[:len(live)]):
            s.metrics.incr("serve.completed")
            s._finish(r, "ok", result=int(p))
        s.metrics.incr("serve.batches")
        s.metrics.incr("serve.batch.rows", len(live))
        s.metrics.incr(f"serve.bucket.{bucket}")
        s.metrics.set("serve.batch occupancy",
                      len(live) / s.batch_size, unit="scalar")
        s.metrics.set("serve.padding efficiency",
                      len(live) / bucket, unit="scalar")
        self._emit_batch(seq, len(live), "ok", bucket=bucket,
                         dur_s=dur_fwd)


class WorkerPool:
    """N device workers behind one dispatcher thread.  ``drain`` order:
    close the queue -> the batcher flushes partials and returns ``None`` ->
    sentinel every inbox -> join workers -> ``run.end``."""

    def __init__(self, server, num_workers: int,
                 breaker_threshold: int, breaker_reset_s: float):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.server = server
        self.workers = [DeviceWorker(i, server, breaker_threshold,
                                     breaker_reset_s)
                        for i in range(num_workers)]
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="bigdl-torch-serve-dispatch",
            daemon=True)

    def start(self, warmup: bool = True) -> dict:
        """Start the workers and let each warm every rung in its own
        thread (when ``warmup``); :meth:`open` then starts the dispatcher.
        Returns worker 0's {bucket: steady-state seconds} ({} without
        warmup); a warmup failure stops the workers and re-raises."""
        for w in self.workers:
            w.start()
        timings: dict = {}
        if warmup:
            jobs = [_Warmup(self.server.runner.warmup)
                    for _ in self.workers]
            for w, job in zip(self.workers, jobs):
                w.inbox.put(job)
            for job in jobs:
                job.done.wait()
            err = next((j.error for j in jobs if j.error is not None), None)
            if err is not None:
                for w in self.workers:
                    w.inbox.put(None)
                raise err
            timings = jobs[0].timings
        return timings

    def open(self) -> None:
        """Start the dispatcher: the server takes traffic from here."""
        self._dispatcher.start()

    def admits(self) -> bool:
        """True while at least one worker can take traffic."""
        return any(w.breaker.admits() for w in self.workers)

    def breaker_states(self) -> dict:
        return {w.wid: w.breaker.state for w in self.workers}

    def _pick(self) -> Optional[DeviceWorker]:
        """The admitting worker with the fewest batches in flight, or None
        when no breaker admits.  Ties break on the lowest worker id."""
        with self.server._pool_lock:
            cands = [w for w in self.workers if w.breaker.admits()]
            if not cands:
                return None
            w = min(cands, key=lambda w: (w.pending, w.wid))
            w.pending += 1
            return w

    def _dispatch_loop(self) -> None:
        s = self.server
        if run_ledger.enabled():
            s._emit_run_start()
        t0 = time.monotonic()
        while True:
            h = tracer.begin_span("serve.dispatch", seq=s._batch_seq)
            try:
                batch = s.batcher.next_batch()
                if batch is None:
                    h.end()
                    break
                seq = s._next_seq()
                w = self._pick()
                if w is None:
                    s._fail_fleet_open(seq, batch)
                else:
                    w.inbox.put((seq, batch, run_trace.current_wire()))
                h.end()
            except Exception as e:       # the dispatcher must never die
                h.end(error=type(e).__name__)
                logger.exception("serving dispatcher: unexpected error")
        for w in self.workers:
            w.inbox.put(None)
        for w in self.workers:
            w.thread.join()
        s._run_end(time.monotonic() - t0)

    def join(self, timeout: Optional[float] = None) -> bool:
        self._dispatcher.join(timeout)
        return not self._dispatcher.is_alive()
