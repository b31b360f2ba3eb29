"""Multi-tenant serving fleet: one admission plane, weighted-fair dispatch,
worker allocations (``bigdl_tpu/serving/fleet/server.py``).

* One admission plane: ``submit(tenant, row, priority_class=...,
  deadline_class=...)``.  Tenant resolution, class and row validation,
  deadline arithmetic and every typed shed happen at the door, attributed
  to the tenant (``serve.shed`` events carry ``tenant=``).
* Weighted-fair dispatch (:mod:`.dispatch`): each tenant's batcher forms
  batches under its own latency policy; one dispatcher picks the next
  tenant by stride scheduling over the declared weights, then the least
  loaded worker within that tenant's allocation.
* Worker allocations: the fleet owns ``max_workers`` :class:`FleetWorker`
  threads, each with its own circuit breaker; every classify tenant holds
  an exclusive allocation of ``min_workers`` to ``max_workers`` of them.
  The rest are parked, and the :class:`~.autoscaler.Autoscaler` hands them
  out under load.  ``worker_seconds()`` integrates the allocation over
  time.
* Live tenancy (:mod:`.registry`): ``register`` and ``deregister`` while
  traffic runs; a ``kind="generate"`` tenant's ``ContinuousGenerator``
  rides the same plane with its own scheduler thread.

A worker serves a batch as the tenant that owns it: the single-tenant
pool's per-batch pipeline (``DeviceWorker.process``: expiry, breaker gate,
bucket pack, retried forward, ordered delivery) runs unchanged, billed to
the tenant.  Every rung a worker serves is first run in that worker's
thread (at ``register`` for the first allocation, at ``scale_up`` before
the dispatcher routes to the new worker), since PyTorch keeps its cuDNN
and cuBLAS handles per thread.  All workers launch on the device's current
stream.  Ledger: ``run.start``/``run.end kind=FleetServer``,
``fleet.dispatch`` records, ``fleet.register``/``fleet.deregister``/
``fleet.scale``/``fleet.reap`` events and tenant-tagged ``serve.*``
records, which ``run-report`` renders as the per-tenant fleet census.
"""

from __future__ import annotations

import logging
import os
import queue as _queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.observability import trace as run_trace
from bigdl_tpu_torch.observability import tracer
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.serving.errors import (BreakerOpenError, DrainingError,
                                            InvalidRequestError,
                                            MemoryBudgetError, ShedError,
                                            UnknownTenantError)
from bigdl_tpu_torch.serving.fleet.dispatch import StrideScheduler
from bigdl_tpu_torch.serving.fleet.registry import (GenerativeTenant,
                                                    ModelRegistry, Tenant,
                                                    TenantSpec)
from bigdl_tpu_torch.serving.queue import Request
from bigdl_tpu_torch.serving.scheduler.pool import DeviceWorker, _Warmup

logger = logging.getLogger("bigdl_tpu_torch.serving")

# every worker's breaker: open after BREAKER_THRESHOLD consecutive forward
# failures, half-open after BREAKER_RESET_S; a worker takes DISPATCH_DEPTH
# batches in flight before formed batches wait in the tenant's ready deque,
# where the stride scheduler still arbitrates them, a newly allocated worker
# can take them and the autoscaler's backlog sees them; a tenant formed
# READY_BOUND batches ahead holds its former, so an overload backs up into
# the bounded AdmissionQueue and sheds typed at the door
BREAKER_THRESHOLD, BREAKER_RESET_S = 3, 1.0
DISPATCH_DEPTH, READY_BOUND = 2, 4


class FleetWorker(DeviceWorker):
    """One fleet worker: a :class:`DeviceWorker` (own breaker, own inbox,
    the per-batch pipeline) whose inbox items carry the tenant the batch
    belongs to; the worker serves that tenant as ``self.server`` for the
    batch.  Only the worker's thread reads or writes that binding."""

    def __init__(self, wid: int, fleet: "FleetServer"):
        super().__init__(wid, fleet, BREAKER_THRESHOLD, BREAKER_RESET_S)
        self.fleet = fleet
        self.tenant_name: Optional[str] = None
        self._killed = False

    def kill(self) -> None:
        """Abrupt worker death (the drill's kill): the thread takes no more
        work once its current batch is done, abandoning its inbox.  The
        dispatcher's reap finds the dead thread, puts the abandoned batches
        back at the front of the tenant's ready batches and backfills the
        allocation from the parked workers."""
        self._killed = True
        self.inbox.put(None)         # wake a blocked get()

    def _loop(self) -> None:
        while True:
            item = self.inbox.get()
            if self._killed:
                if isinstance(item, _Warmup):
                    item.error = RuntimeError(
                        f"fleet worker {self.wid} was killed")
                    item.done.set()
                elif item is not None:
                    self.inbox.put(item)   # salvaged by the reaper
                break
            if item is None:
                break
            if isinstance(item, _Warmup):
                item.run()
                continue
            tenant, seq, batch, ctx = item
            self.tenant_name = tenant.name
            self.server = tenant
            try:
                with run_trace.attach(ctx):
                    self.process(seq, batch)
            except BaseException:        # the worker must never die
                logger.exception("fleet worker %d (tenant %s): "
                                 "unexpected error", self.wid,
                                 tenant.name)
            finally:
                self.server = self.fleet
                self.tenant_name = None
                with self.fleet._pool_lock:
                    self.pending -= 1
                    tenant.inflight -= 1
                    self.batches += 1
                # wake the dispatcher: this worker is back under its
                # dispatch depth (after the pool lock, never inside it: the
                # dispatcher takes them in the other order)
                with self.fleet._ready_cond:
                    self.fleet._ready_cond.notify_all()

    def _on_transition(self, old: str, new: str, failures: int) -> None:
        self.fleet._on_breaker_transition(self.wid, old, new, failures,
                                          tenant=self.tenant_name)


class FleetServer:
    """N tenants, one admission plane, ``max_workers`` device workers on
    ``device`` (CUDA by default; without CUDA it raises unless the caller
    passes ``device="cpu"``).

    ``specs`` are :class:`~.registry.TenantSpec`; more can be registered
    live.  ``autoscale=True`` arms the :class:`~.autoscaler.Autoscaler`
    (its knobs in ``autoscaler_kwargs``); ``autoscale=False`` keeps every
    tenant at ``min_workers``.  ``budgeter`` (a ``MemoryBudgeter``) charges
    every tenant's parameters and, for generate tenants, KV pages under its
    name.  The reference also charges each warm rung's compiled program
    (``rung_executables``) and reclaims them under pressure; the port
    compiles no program per rung, so that class stays 0.
    """

    def __init__(self, specs: Sequence[TenantSpec], *,
                 max_workers: Optional[int] = None,
                 autoscale: bool = False,
                 autoscaler_kwargs: Optional[dict] = None,
                 budgeter=None,
                 device="cuda"):
        self.device = resolve_device(device)
        specs = list(specs)
        classify = [s for s in specs if s.kind == "classify"]
        if max_workers is None:
            max_workers = max(1, sum(s.min_workers for s in classify))
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got "
                             f"{max_workers}")
        need = sum(s.min_workers for s in classify)
        if need > max_workers:
            raise ValueError(
                f"sum of tenant min_workers ({need}) exceeds the fleet "
                f"pool ({max_workers} workers)")
        self.max_workers = int(max_workers)
        self.budgeter = budgeter
        self.registry = ModelRegistry()
        self.stride = StrideScheduler()
        self.metrics = Metrics()

        self._pool_lock = threading.Lock()
        self._ready_cond = threading.Condition()
        self._seq_lock = threading.Lock()
        self._batch_seq = 0
        self._closed = False

        # worker-seconds: the integral of allocated workers over time
        self._ws_lock = threading.Lock()
        self._ws_total = 0.0
        self._ws_last = time.monotonic()
        self._alloc_total = 0

        self.workers = [FleetWorker(i, self)
                        for i in range(self.max_workers)]
        # parked kept descending, so pop() hands out the lowest wid
        self._parked: List[FleetWorker] = sorted(
            self.workers, key=lambda w: -w.wid)
        self._dead: List[FleetWorker] = []
        self._pending_reaps: List[dict] = []
        for w in self.workers:
            w.start()

        try:
            for spec in specs:
                self.register(spec)
        except BaseException:
            # a failed spec must not leak the started threads: no reference
            # escapes a raising constructor, so nothing else could drain them
            for t in self.registry.tenants():
                if t.kind == "classify":
                    t.queue.close()
                else:
                    t.generator.drain(5.0)
            with self._ready_cond:
                self._ready_cond.notify_all()
            for t in self.registry.tenants():
                if getattr(t, "_former", None) is not None:
                    t._former.join(5.0)
            for w in self.workers:
                w.inbox.put(None)
            for w in self.workers:
                w.thread.join(5.0)
            raise

        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="bigdl-torch-fleet-dispatch",
            daemon=True)
        self._dispatcher.start()

        self.autoscaler = None
        if autoscale:
            from bigdl_tpu_torch.serving.fleet.autoscaler import Autoscaler
            self.autoscaler = Autoscaler(self,
                                         **(autoscaler_kwargs or {}))

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "FleetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.drain()

    def register(self, spec: TenantSpec):
        """Add a tenant live: build its runtime, give it ``min_workers``
        workers and run every rung in each of their threads, charge the
        budgeter, enter it into the stride schedule, start its batch
        former.  Raises, with nothing changed, when the parked workers
        cannot cover ``min_workers``."""
        if self._closed:
            raise DrainingError("fleet is draining; cannot register "
                                f"tenant {spec.name!r}")
        if spec.name in self.registry:
            raise ValueError(f"tenant {spec.name!r} is already registered")
        if spec.kind == "generate":
            return self._register_generate(spec)
        if spec.classifier is not None and \
                spec.classifier.device.type != self.device.type:
            raise ValueError(f"tenant {spec.name!r}: the classifier is on "
                             f"{spec.classifier.device}, the fleet on "
                             f"{self.device}")
        t = Tenant(spec, device=self.device)
        with self._ready_cond:
            if len(self._parked) < spec.min_workers:
                raise ValueError(
                    f"cannot register tenant {spec.name!r}: needs "
                    f"{spec.min_workers} worker(s), only "
                    f"{len(self._parked)} parked")
            # a parked worker can be dead (killed while parked), so the
            # count above is not enough: roll back on a short allocation
            got = []
            for _ in range(spec.min_workers):
                w = self._allocate_locked(t)
                if w is None:
                    for live in got:
                        self._release_locked(t, live)
                    raise ValueError(
                        f"cannot register tenant {spec.name!r}: the "
                        "parked pool has no live worker left")
                got.append(w)
        try:
            # the tenant is in no schedule yet: its workers are idle
            with tracer.span("serve.warmup", buckets=list(t.ladder),
                             tenant=t.name):
                self._warm_on(got, t.runner.warmup)
            t._update_estimates()
            if self.budgeter is not None:
                pbytes = self._tenant_param_bytes(t)
                self.budgeter.admit(t.name, pbytes, what="register")
                self.budgeter.charge(t.name, "params", pbytes)
            with self._ready_cond:
                self.registry.add(t)
                self.stride.add(t.name, t.weight)
                t._former_done = False
                t._former = threading.Thread(
                    target=self._former_loop, args=(t,),
                    name=f"bigdl-torch-fleet-former-{t.name}", daemon=True)
                t._former.start()
                self._ready_cond.notify_all()
        except BaseException:
            with self._ready_cond:
                for w in list(t.workers):
                    self._release_locked(t, w)
            if self.budgeter is not None and t.name not in self.registry:
                self.budgeter.drop_tenant(t.name)
            raise
        run_ledger.emit("event", kind="fleet.register", tenant=t.name,
                        tenant_kind="classify", weight=t.weight,
                        buckets=list(t.ladder),
                        workers=[w.wid for w in t.workers],
                        priority_classes=list(spec.priority_classes),
                        deadline_classes=dict(spec.deadline_classes),
                        quantize=spec.quantize,
                        slo_target=spec.slo_target)
        self.metrics.set(f"fleet.alloc.{t.name}", len(t.workers),
                         unit="scalar")
        return t

    def _register_generate(self, spec: TenantSpec) -> GenerativeTenant:
        t = GenerativeTenant(spec, budgeter=self.budgeter,
                             device=self.device)
        if self.budgeter is not None:
            pbytes = self._tenant_param_bytes(t)
            try:
                self.budgeter.admit(t.name, pbytes, what="register")
            except MemoryBudgetError:
                # the half-built generator must not leak its thread
                t.generator.drain(5.0)
                raise
            self.budgeter.charge(t.name, "params", pbytes)
        try:
            self.registry.add(t)
        except BaseException:
            t.generator.drain(5.0)
            raise
        run_ledger.emit("event", kind="fleet.register",
                        tenant=t.name, tenant_kind="generate",
                        weight=t.weight, quantize=spec.quantize)
        return t

    def _warm_on(self, workers, fn) -> None:
        """Run ``fn`` (a runner's warmup) in each of ``workers``' threads at
        once and wait; re-raises the first error.  The workers must be
        idle: none is in a tenant's schedule."""
        jobs = [_Warmup(fn) for _ in workers]
        for w, job in zip(workers, jobs):
            w.inbox.put(job)
        for job in jobs:
            job.done.wait()
        err = next((j.error for j in jobs if j.error is not None), None)
        if err is not None:
            raise err

    # -- memory budget -------------------------------------------------------

    @staticmethod
    def _tenant_param_bytes(t) -> int:
        """Device bytes of the tenant's (packed) parameter tree, the
        ``param_bytes_by_dtype`` census summed."""
        from bigdl_tpu_torch.ops.quant import param_bytes_by_dtype
        if t.kind == "generate":
            model = t.generator.model
        else:
            clf = t.classifier
            model = clf.qmodel if clf.qmodel is not None else clf.model
        return int(sum(param_bytes_by_dtype(model).values()))

    def deregister(self, name: str, timeout: float = 30.0) -> bool:
        """Remove a tenant live: stop its admission, bring every accepted
        request to a terminal state, park its workers.  False when in-flight
        work did not settle within ``timeout``: the tenant is removed all
        the same, and its undispatched batches fail typed
        ``DrainingError``."""
        t = self.registry.get(name)
        drained = True
        if t.kind == "generate":
            drained = t.generator.drain(timeout)
        else:
            t.queue.close()
            t._former.join(timeout)
            with self._ready_cond:
                self._ready_cond.notify_all()
            deadline = time.monotonic() + timeout
            while (t.ready or t.inflight) \
                    and time.monotonic() < deadline:
                time.sleep(0.002)
            drained = not t.ready and not t.inflight
            with self._ready_cond:
                # the former, if it outlived its join, fails what it still
                # forms instead of publishing it to a dead schedule
                t._evicted = True
                self.stride.remove(name)
                for w in list(t.workers):
                    self._release_locked(t, w)
                stranded = []
                while t.ready:
                    stranded.append(t.ready.popleft())
                self._ready_cond.notify_all()
            for batch in stranded:
                self._fail_batch_draining(
                    t, batch, f"tenant {name!r} deregistered before "
                    "dispatch")
        self.registry.remove(name)
        if self.budgeter is not None:
            self.budgeter.drop_tenant(name)
        run_ledger.emit("event", kind="fleet.deregister", tenant=name,
                        drained=drained)
        return drained

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop all admission, bring every tenant's
        accepted requests to terminal states, join the dispatcher and every
        worker.  Idempotent."""
        self._closed = True
        if self.autoscaler is not None:
            self.autoscaler.close()
        for t in self.registry.tenants():
            if t.kind == "generate":
                t.generator.drain(timeout)
            else:
                t.queue.close()
        with self._ready_cond:
            self._ready_cond.notify_all()
        for t in self.registry.tenants():
            if t._former is not None:
                t._former.join(timeout)
        with self._ready_cond:
            self._ready_cond.notify_all()
        self._dispatcher.join(timeout)
        run_ledger.flush()
        return not self._dispatcher.is_alive()

    close = drain

    @property
    def draining(self) -> bool:
        return self._closed

    # -- worker allocation (callers hold self._ready_cond) -------------------

    def _ws_tick(self, delta: int) -> None:
        with self._ws_lock:
            now = time.monotonic()
            self._ws_total += (now - self._ws_last) * self._alloc_total
            self._ws_last = now
            self._alloc_total += delta

    def worker_seconds(self) -> float:
        """Allocated worker-seconds so far."""
        self._ws_tick(0)
        with self._ws_lock:
            return self._ws_total

    def _take_parked_locked(self) -> Optional[FleetWorker]:
        while self._parked:
            w = self._parked.pop()
            if w.thread.ident is not None and not w.thread.is_alive():
                self._dead.append(w)     # died parked: never handed out
                continue
            return w
        return None

    def _allocate_locked(self, t: Tenant) -> Optional[FleetWorker]:
        w = self._take_parked_locked()
        if w is not None:
            t.workers.append(w)
            self._ws_tick(+1)
        return w

    def _release_locked(self, t: Tenant, w: FleetWorker) -> None:
        t.workers.remove(w)
        self._parked.append(w)
        self._parked.sort(key=lambda x: -x.wid)
        self._ws_tick(-1)

    def _full(self, t: Tenant) -> bool:
        return t.spec.max_workers is not None \
            and len(t.workers) >= t.spec.max_workers

    def scale_up(self, t: Tenant, reason: str = "", **info) -> bool:
        """Grow ``t``'s allocation by one parked worker.  The worker runs
        every rung of the tenant's ladder in its own thread before it joins
        the allocation, so traffic never reaches a cold rung; the
        ``fleet.scale`` event carries that ``prewarm_s``."""
        with self._ready_cond:
            if self._full(t):
                return False
            w = self._take_parked_locked()
            if w is None:
                return False
        t0 = time.monotonic()
        try:
            self._warm_on([w], t.runner.warmup)
        except BaseException:
            with self._ready_cond:
                self._parked.append(w)
                self._parked.sort(key=lambda x: -x.wid)
            raise
        prewarm_s = time.monotonic() - t0
        with self._ready_cond:
            if t._evicted or self._closed or self._full(t):
                self._parked.append(w)
                self._parked.sort(key=lambda x: -x.wid)
                return False
            t.workers.append(w)
            self._ws_tick(+1)
            n = len(t.workers)
            self._ready_cond.notify_all()
        run_ledger.emit("event", kind="fleet.scale", tenant=t.name,
                        direction="up", workers=n, worker=w.wid,
                        reason=reason, prewarm_s=prewarm_s, **info)
        self.metrics.set(f"fleet.alloc.{t.name}", n, unit="scalar")
        return True

    def scale_down(self, t: Tenant, reason: str = "", **info) -> bool:
        """Shrink ``t``'s allocation by one worker, never below
        ``min_workers``.  The released worker finishes its inbox, billed to
        the tenant, before it idles."""
        with self._ready_cond:
            if len(t.workers) <= t.spec.min_workers:
                return False
            w = max(t.workers, key=lambda x: x.wid)
            self._release_locked(t, w)
            n = len(t.workers)
        run_ledger.emit("event", kind="fleet.scale", tenant=t.name,
                        direction="down", workers=n, worker=w.wid,
                        reason=reason, **info)
        self.metrics.set(f"fleet.alloc.{t.name}", n, unit="scalar")
        return True

    def _reap_dead_locked(self) -> None:
        """Find allocated workers whose thread died, put the batches left
        in their inboxes back at the front of the owning tenant's ready
        deque in sequence order, and backfill the allocation from the
        parked workers.  A killed worker finished the batch it was running
        (delivering its answers), so what its inbox holds was never
        started: those requests are re-dispatched once and answered once.
        The records go out in :meth:`_flush_reaps`, outside the
        condition."""
        for t in self.registry.tenants():
            if t.kind != "classify":
                continue
            dead = [w for w in t.workers
                    if w.thread.ident is not None
                    and not w.thread.is_alive()]
            for w in dead:
                salvaged = []
                while True:
                    try:
                        item = w.inbox.get_nowait()
                    except _queue.Empty:
                        break
                    if isinstance(item, tuple):
                        salvaged.append(item)
                salvaged.sort(key=lambda it: it[1])      # seq order
                with self._pool_lock:
                    t.inflight -= len(salvaged)
                t.ready.extendleft(
                    batch for _t, _s, batch, _c in reversed(salvaged))
                self._release_locked(t, w)
                self._parked.remove(w)   # dead: never handed out again
                self._dead.append(w)
                replacement = None
                if self._parked:
                    replacement = self._allocate_locked(t)
                self._pending_reaps.append(
                    {"tenant": t.name, "worker": w.wid,
                     "salvaged": len(salvaged),
                     "replacement": (replacement.wid
                                     if replacement else None),
                     "workers": len(t.workers)})

    def _flush_reaps(self) -> None:
        while self._pending_reaps:
            ev = self._pending_reaps.pop(0)
            run_ledger.emit("event", kind="fleet.reap", **ev)
            self.metrics.incr("fleet.reaped")
            self.metrics.incr("fleet.salvaged", ev["salvaged"])
            self.metrics.set(f"fleet.alloc.{ev['tenant']}",
                             ev["workers"], unit="scalar")
            logger.warning(
                "fleet reap: worker %d (tenant %s) died; salvaged "
                "%d batch(es), replacement %s", ev["worker"],
                ev["tenant"], ev["salvaged"],
                ev["replacement"] if ev["replacement"] is not None
                else "none parked")

    # -- admission -----------------------------------------------------------

    def _shed(self, tenant_name: Optional[str], metrics, exc) -> None:
        if metrics is not None:
            metrics.incr(f"serve.shed.{exc.reason}")
        run_ledger.emit("event", kind="serve.shed", reason=exc.reason,
                        tenant=tenant_name)
        raise exc

    def submit(self, tenant: str, row, *,
               priority_class: Optional[str] = None,
               deadline_class: Optional[str] = None,
               deadline_s: Optional[float] = None,
               max_new: Optional[int] = None,
               session: Optional[str] = None):
        """Admit one request for ``tenant`` or raise a typed
        :class:`ShedError` synchronously.  A classify tenant takes a
        feature ``row`` and its future resolves to the 1-based class; a
        generate tenant takes a prompt and ``max_new``."""
        if self._closed:
            self._shed(tenant, self.metrics,
                       DrainingError("fleet is draining"))
        try:
            t = self.registry.get(tenant)
        except UnknownTenantError as e:
            self._shed(tenant, self.metrics, e)
        if t.kind == "generate":
            if max_new is None:
                raise ValueError(
                    f"tenant {tenant!r} is a generate tenant: "
                    "submit(tenant, prompt, max_new=...)")
            t.resolve_priority(priority_class)
            if deadline_s is not None:
                raise InvalidRequestError(
                    f"tenant {tenant!r} is a generate tenant: "
                    "per-request deadline_s is not enforced on the "
                    "generator path")
            t.resolve_deadline(deadline_class, None, time.monotonic())
            fut = t.submit(row, max_new, session=session)
            t.accepted += 1
            return fut
        if session is not None:
            raise InvalidRequestError(
                f"tenant {tenant!r} is a classify tenant: sessions "
                "(retained KV) only exist on the generate path")
        feats = np.asarray(t.classifier._features(row), np.float32)
        mismatch = t.classifier._row_mismatch(feats)
        if mismatch is not None:
            t.metrics.incr("serve.invalid")
            run_ledger.emit("event", kind="serve.shed", reason="invalid",
                            tenant=t.name)
            raise InvalidRequestError(mismatch)
        # the allocation as of the condition the reaper and the autoscaler
        # change it under
        with self._ready_cond:
            workers = list(t.workers)
        if not any(w.breaker.admits() for w in workers
                   if w.thread.is_alive()):
            self._shed(t.name, t.metrics, BreakerOpenError(
                f"every worker allocated to tenant {t.name!r} has an "
                "open circuit breaker"))
        now = time.monotonic()
        prio = t.resolve_priority(priority_class)
        ddl = t.resolve_deadline(deadline_class, deadline_s, now)
        req = Request(feats, deadline=ddl, tenant=t.name,
                      priority=prio, deadline_class=deadline_class)
        try:
            t.queue.offer(req, now=now)
        except ShedError as e:
            self._shed(t.name, t.metrics, e)
        t.metrics.incr("serve.submitted")
        t.accepted += 1
        return req.future

    # -- batch formation and dispatch ----------------------------------------

    def _next_seq(self) -> int:
        with self._seq_lock:
            seq = self._batch_seq
            self._batch_seq += 1
            return seq

    def _former_loop(self, t: Tenant) -> None:
        """Per-tenant batch former: the tenant's DeadlineBatcher publishes
        formed batches to the dispatcher, until the tenant's queue closes
        and its last partial batch is out."""
        while True:
            batch = t.batcher.next_batch()
            evicted = None
            with self._ready_cond:
                if batch is None:
                    t._former_done = True
                    self._ready_cond.notify_all()
                    return
                # backpressure: hold the batch until dispatch makes room
                # (requests meanwhile queue, and shed typed, at the door);
                # not on the fleet's drain, so the last flush cannot stall
                while len(t.ready) >= READY_BOUND \
                        and not self._closed and not t._evicted:
                    self._ready_cond.wait(0.1)
                if t._evicted:
                    evicted = batch
                else:
                    t.ready.append(batch)
                    self._ready_cond.notify_all()
            if evicted is not None:
                self._fail_batch_draining(
                    t, evicted, f"tenant {t.name!r} deregistered "
                    "before dispatch")

    def _routable(self, t) -> bool:
        """A tenant whose next ready batch can make progress now: an
        admitting worker sits under the dispatch depth, or no worker admits
        at all (the batch fails fast, typed)."""
        if t.kind != "classify":
            return False
        with self._pool_lock:
            admitting = [w for w in t.workers
                         if w.thread.is_alive() and w.breaker.admits()]
            return not admitting or any(
                w.pending < DISPATCH_DEPTH for w in admitting)

    def _pick_worker_locked(self, t: Tenant) -> Optional[FleetWorker]:
        with self._pool_lock:
            cands = [w for w in t.workers
                     if w.thread.is_alive() and w.breaker.admits()]
            if not cands:
                return None
            w = min(cands, key=lambda w: (w.pending, w.wid))
            w.pending += 1
            t.inflight += 1
            return w

    def _fail_batch_draining(self, t: Tenant, batch: List,
                             why: str) -> None:
        t.metrics.incr("serve.shed.draining", len(batch))
        run_ledger.emit("event", kind="serve.shed", reason="draining",
                        count=len(batch), tenant=t.name)
        t._fail_batch(batch, "draining", lambda: DrainingError(why))

    def _fail_tenant_open(self, t: Tenant, seq: int, batch: List) -> None:
        t.metrics.incr("serve.shed.breaker_open", len(batch))
        t.metrics.incr("serve.batches")
        run_ledger.emit("event", kind="serve.shed",
                        reason="breaker_open", count=len(batch),
                        tenant=t.name)
        run_ledger.emit("serve.batch", seq=seq, size=len(batch),
                        capacity=t.batch_size,
                        occupancy=len(batch) / t.batch_size,
                        status="breaker_open", tenant=t.name)
        t._fail_batch(batch, "breaker_open", lambda: BreakerOpenError(
            f"every worker allocated to tenant {t.name!r} has an open "
            "circuit breaker"))

    def _dispatch_loop(self) -> None:
        if run_ledger.enabled():
            self._emit_run_start()
        t0 = time.monotonic()
        while True:
            try:
                shutdown = False
                with self._ready_cond:
                    ready = None
                    while True:
                        self._reap_dead_locked()
                        if self._pending_reaps:
                            break        # flush outside the condition
                        ready = [t for t in self.registry.tenants()
                                 if t.ready and self._routable(t)]
                        if ready:
                            break
                        classify = [t for t in self.registry.tenants()
                                    if t.kind == "classify"]
                        if self._closed and all(
                                getattr(t, "_former_done", True)
                                for t in classify) and not any(
                                t.ready for t in classify):
                            shutdown = True
                            break
                        self._ready_cond.wait(0.1)
                    if not shutdown and ready:
                        name = self.stride.pick({t.name for t in ready})
                        t = next(x for x in ready if x.name == name)
                        batch = t.ready.popleft()
                        self._ready_cond.notify_all()  # wake formers
                        seq = self._next_seq()
                        w = self._pick_worker_locked(t)
                self._flush_reaps()
                if shutdown:
                    break
                if not ready:
                    continue
                with tracer.span("serve.dispatch", seq=seq,
                                 tenant=t.name,
                                 worker=(w.wid if w else None)):
                    run_ledger.emit("fleet.dispatch", seq=seq,
                                    tenant=t.name,
                                    worker=(w.wid if w else None),
                                    size=len(batch),
                                    queue_depth=t.queue.depth,
                                    ready=len(t.ready))
                    if w is None:
                        self._fail_tenant_open(t, seq, batch)
                    else:
                        w.inbox.put((t, seq, batch,
                                     run_trace.current_wire()))
            except BaseException:        # the dispatcher must never die
                logger.exception("fleet dispatcher: unexpected error")
        for w in self.workers:
            w.inbox.put(None)
        for w in self.workers:
            w.thread.join()
        self._run_end(time.monotonic() - t0)

    # -- observability -------------------------------------------------------

    def _on_breaker_transition(self, wid: int, old: str, new: str,
                               failures: int,
                               tenant: Optional[str] = None) -> None:
        self.metrics.incr(f"serve.breaker.{new}")
        run_ledger.emit_critical("event", kind="serve.breaker",
                                 **{"from": old, "to": new,
                                    "failures": failures, "worker": wid,
                                    "tenant": tenant})
        logger.warning("fleet breaker (worker %d, tenant %s) %s -> %s "
                       "(%d consecutive forward failures)", wid, tenant,
                       old, new, failures)

    def ledger_tags(self) -> dict:
        # a worker between tenants reports fleet-level
        return {}

    def _emit_run_start(self) -> None:
        run_ledger.emit(
            "run.start", kind="FleetServer", pid=os.getpid(),
            thread=threading.get_ident(), trace=run_ledger.trace_id(),
            max_workers=self.max_workers,
            tenants={t.name: {"kind": t.kind, "weight": t.weight,
                              "workers": [w.wid for w in t.workers]}
                     for t in self.registry.tenants()})

    def _run_end(self, wall_s: float) -> None:
        led = run_ledger.get_ledger()
        if led is None:
            return
        tenants = {}
        for t in self.registry.tenants():
            if t.kind == "classify":
                tenants[t.name] = {"accepted": t.accepted,
                                   "slo": t.slo.snapshot(),
                                   "workers": len(t.workers)}
            else:
                tenants[t.name] = {"accepted": t.accepted}
        run_ledger.emit("run.end", kind="FleetServer", pid=os.getpid(),
                        wall_s=wall_s, dispatches=self._batch_seq,
                        worker_seconds=self.worker_seconds(),
                        tenants=tenants)
        from bigdl_tpu_torch.observability.prometheus import \
            write_prometheus
        write_prometheus(self.metrics,
                         os.path.join(
                             led.dir,
                             f"metrics-fleet-{os.getpid()}.prom"))
        led.flush()

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._ready_cond:
            parked = len(self._parked)
            alloc = {t.name: [w.wid for w in t.workers]
                     for t in self.registry.tenants()}
        return {
            "tenants": {t.name: t.stats()
                        for t in self.registry.tenants()},
            "allocations": alloc,
            "parked": parked,
            "max_workers": self.max_workers,
            "dispatches": self._batch_seq,
            "worker_seconds": self.worker_seconds(),
            "weights": self.stride.weights(),
        }
