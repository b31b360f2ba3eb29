"""Tenant model registry: several models behind one admission plane
(``bigdl_tpu/serving/fleet/registry.py``).

A tenant is one served model and its traffic contract: its own bucket
ladder and ``BucketedRunner`` (or its own ``ContinuousGenerator`` for an LM
tenant), its packed copy at any ``ops.quant.RUNG_BUDGETS`` rung, its
priority and deadline classes, its weight, its SLO target and its worker
bounds for the autoscaler.  Tenants register and deregister live.

A classify :class:`Tenant` offers the surface that
``scheduler.pool.DeviceWorker.process`` drives (metrics, ``_finish``,
``_observe_forward``, the ladder, runner and floors), so the fleet's workers
run the single-tenant pool's per-batch pipeline, billed to the tenant that
owns the batch (``ledger_tags`` stamps every ``serve.*`` record with
``tenant=``).
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import InvalidStateError
from typing import Dict, List, Optional, Sequence

from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.observability.live import SLOTracker
from bigdl_tpu_torch.observability.report import _percentile
from bigdl_tpu_torch.optim.metrics import LATENCY_BUCKETS_S, Metrics
from bigdl_tpu_torch.serving.batcher import DeadlineBatcher
from bigdl_tpu_torch.serving.errors import (InvalidRequestError,
                                            UnknownTenantError)
from bigdl_tpu_torch.serving.queue import AdmissionQueue, Request
from bigdl_tpu_torch.serving.scheduler.buckets import (BucketLadder,
                                                       BucketedRunner)

# request and forward latencies kept per tenant for stats()
_LATENCY_WINDOW = 4096


class TenantSpec:
    """Declared configuration of one tenant, validated at construction;
    the fleet builds the runtime from it.

    ``kind="classify"`` serves a ``DLClassifier`` through the fleet's shared
    workers (pass a ready ``classifier``, or ``model`` + ``batch_shape`` and
    optionally ``quantize``/``calibration_rows``, and the fleet builds one
    on its device).  ``kind="generate"`` serves a ``TransformerLM``
    (``model``) through the tenant's own ``ContinuousGenerator``
    (``generator_kwargs``; with
    ``quantize``, ``calibration_prompts`` for ``"w8a8"``), whose scheduler
    thread takes the place of the workers for this tenant.

    ``priority_classes`` is ordered (index 0 dispatches first);
    ``deadline_classes`` maps a class name to a relative deadline in
    seconds (None = unbounded).  ``quantize`` must name a declared
    ``RUNG_BUDGETS`` rung.
    """

    def __init__(self, name: str, model=None, *,
                 classifier=None,
                 batch_shape=None,
                 kind: str = "classify",
                 generator_kwargs: Optional[dict] = None,
                 weight: int = 1,
                 batch_buckets: Optional[Sequence[int]] = None,
                 priority_classes: Sequence[str] = ("default",),
                 deadline_classes: Optional[Dict[str, Optional[float]]]
                 = None,
                 default_deadline_s: Optional[float] = None,
                 slo_target: float = 0.99,
                 slo_window: int = 128,
                 slo_min_samples: int = 16,
                 min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 queue_capacity: int = 256,
                 max_delay_s: float = 0.005,
                 quantize: Optional[str] = None,
                 calibration_rows=None,
                 calibration_prompts=None):
        if not name or not isinstance(name, str):
            raise ValueError(f"tenant name must be a non-empty string, "
                             f"got {name!r}")
        if kind not in ("classify", "generate"):
            raise ValueError(f"tenant kind {kind!r} not in "
                             "('classify', 'generate')")
        if int(weight) < 1:
            raise ValueError(f"tenant weight must be >= 1, got {weight}")
        if not priority_classes:
            raise ValueError("priority_classes must name at least one "
                             "class")
        if len(set(priority_classes)) != len(tuple(priority_classes)):
            raise ValueError(f"duplicate priority classes: "
                             f"{tuple(priority_classes)}")
        if quantize is not None:
            from bigdl_tpu_torch.ops import quant
            mode = quant.normalize_mode(quantize)
            if mode not in quant.RUNG_BUDGETS:
                raise ValueError(
                    f"tenant {name!r} declares quantize={quantize!r}, "
                    f"which is not a declared quant.RUNG_BUDGETS rung "
                    f"({sorted(quant.RUNG_BUDGETS)}) — every tenant "
                    "precision must carry a declared accuracy budget")
        if kind == "classify":
            if classifier is None and (model is None
                                       or batch_shape is None):
                raise ValueError(
                    f"tenant {name!r}: pass classifier= or "
                    "model= + batch_shape=")
        else:
            if model is None:
                raise ValueError(
                    f"tenant {name!r}: pass model= (+ generator_kwargs) "
                    "for kind='generate'")
            finite = {k: v for k, v in (deadline_classes or {}).items()
                      if v is not None}
            if finite or default_deadline_s is not None:
                raise ValueError(
                    f"tenant {name!r}: generate tenants cannot declare "
                    "finite deadlines (the ContinuousGenerator path "
                    f"does not enforce them): {finite or default_deadline_s}")
        if int(min_workers) < 1 and kind == "classify":
            raise ValueError(f"min_workers must be >= 1, got "
                             f"{min_workers}")
        if max_workers is not None and int(max_workers) < int(min_workers):
            raise ValueError(f"max_workers {max_workers} < min_workers "
                             f"{min_workers}")
        self.name = name
        self.kind = kind
        self.model = model
        self.classifier = classifier
        self.batch_shape = batch_shape
        self.generator_kwargs = dict(generator_kwargs or {})
        self.weight = int(weight)
        self.batch_buckets = (list(batch_buckets)
                              if batch_buckets is not None else None)
        self.priority_classes = tuple(priority_classes)
        self.deadline_classes = dict(deadline_classes or {})
        self.default_deadline_s = default_deadline_s
        self.slo_target = float(slo_target)
        self.slo_window = int(slo_window)
        self.slo_min_samples = int(slo_min_samples)
        self.min_workers = int(min_workers)
        self.max_workers = (int(max_workers) if max_workers is not None
                            else None)
        self.queue_capacity = int(queue_capacity)
        self.max_delay_s = float(max_delay_s)
        self.quantize = quantize
        self.calibration_rows = calibration_rows
        self.calibration_prompts = calibration_prompts

    def build_classifier(self, device="cuda"):
        if self.classifier is not None:
            return self.classifier
        from bigdl_tpu_torch.api import DLClassifier
        return DLClassifier(self.model, batch_shape=self.batch_shape,
                            quantize=self.quantize,
                            calibration_rows=self.calibration_rows,
                            device=device)

    def build_generator(self, budgeter=None, device="cuda"):
        from bigdl_tpu_torch.serving.scheduler.continuous import \
            ContinuousGenerator
        kw = dict(self.generator_kwargs)
        if self.quantize is not None:
            kw.setdefault("quantize", self.quantize)
            if self.calibration_prompts is not None:
                kw.setdefault("calibration_prompts",
                              self.calibration_prompts)
        kw.setdefault("ledger_tags", {"tenant": self.name})
        if budgeter is not None:
            # the generator charges its pages under this tenant's name
            kw.setdefault("budgeter", budgeter)
            kw.setdefault("budget_tenant", self.name)
        kw.setdefault("device", device)
        return ContinuousGenerator(self.model, **kw)


class _ClassResolution:
    """The ``(priority_class, deadline_class)`` resolution both tenant
    kinds run at the door: an undeclared class is a typed
    :class:`InvalidRequestError`."""

    def resolve_priority(self, priority_class: Optional[str]) -> int:
        classes = self.spec.priority_classes
        if priority_class is None:
            return 0
        try:
            return classes.index(priority_class)
        except ValueError:
            raise InvalidRequestError(
                f"tenant {self.name!r} has no priority class "
                f"{priority_class!r} (declared: {classes})")

    def resolve_deadline(self, deadline_class: Optional[str],
                         deadline_s: Optional[float],
                         now: float) -> Optional[float]:
        """The absolute deadline of a request of ``deadline_class`` (an
        explicit relative ``deadline_s`` wins)."""
        if deadline_s is None and deadline_class is not None:
            if deadline_class not in self.spec.deadline_classes:
                raise InvalidRequestError(
                    f"tenant {self.name!r} has no deadline class "
                    f"{deadline_class!r} (declared: "
                    f"{sorted(self.spec.deadline_classes)})")
            deadline_s = self.spec.deadline_classes[deadline_class]
        if deadline_s is None:
            deadline_s = self.spec.default_deadline_s
        return None if deadline_s is None else now + float(deadline_s)


class Tenant(_ClassResolution):
    """Runtime of one ``kind="classify"`` tenant: its queue, batcher,
    runner, SLO tracker and worker allocation; the "server" the fleet's
    workers bill each of its batches to."""

    kind = "classify"

    def __init__(self, spec: TenantSpec, device="cuda"):
        self.spec = spec
        self.name = spec.name
        self.weight = spec.weight
        self.classifier = spec.build_classifier(device)
        self.ladder = BucketLadder(
            spec.batch_buckets if spec.batch_buckets is not None
            else [self.classifier.batch_shape[0]])
        self.batch_size = self.ladder.max
        self.runner = BucketedRunner(self.classifier, self.ladder)
        # the pool's forward reads these; a tenant's forward is not retried
        self.forward_retries = 0
        self.retry_backoff_s = 0.0
        self.metrics = Metrics()
        self._lat_lock = threading.Lock()
        self._latencies: collections.deque = \
            collections.deque(maxlen=_LATENCY_WINDOW)
        self._forwards: Dict[int, collections.deque] = {
            b: collections.deque(maxlen=_LATENCY_WINDOW)
            for b in self.ladder}
        self._est_s = 0.0
        self._floor_s = 0.0
        self.queue = AdmissionQueue(
            spec.queue_capacity,
            floor_fn=lambda: self._floor_s,
            on_depth=lambda d: self.metrics.set(
                "serve.queue depth", d, unit="scalar"),
            levels=len(spec.priority_classes))
        self.batcher = DeadlineBatcher(
            self.queue, self.batch_size, max_delay_s=spec.max_delay_s,
            est_fn=lambda: self._est_s)
        self.slo = SLOTracker(target=spec.slo_target,
                              window=spec.slo_window,
                              min_samples=spec.slo_min_samples)
        # owned by the fleet: the allocation (FleetWorker list), formed
        # batches not yet dispatched, batches in flight
        self.workers: List = []
        self.ready: collections.deque = collections.deque()
        self.inflight = 0
        self.accepted = 0
        self._former: Optional[threading.Thread] = None
        self._evicted = False    # set by FleetServer.deregister

    # -- the server surface DeviceWorker.process drives ----------------------

    def ledger_tags(self) -> dict:
        return {"tenant": self.name}

    def _update_estimates(self) -> None:
        self._floor_s = self.runner.floor_s()
        self._est_s = self.runner.est_s()

    def _observe_forward(self, bucket: int, rows: int, dur_s: float) -> None:
        with self._lat_lock:
            self._forwards[bucket].append((rows, dur_s))

    def _finish(self, req: Request, status: str,
                result: Optional[int] = None,
                exc: Optional[Exception] = None) -> None:
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
            self.metrics.observe("serve.latency", dur, LATENCY_BUCKETS_S)
        run_ledger.emit("serve.request", rid=req.rid, status=status,
                        dur_s=dur, tenant=self.name,
                        priority=req.priority,
                        deadline_class=req.deadline_class)
        if status != "cancelled":
            self.slo.observe(status == "ok", dur)

    def _fail_batch(self, requests: List[Request], status: str,
                    make_exc) -> None:
        for r in requests:
            self._finish(r, status, exc=make_exc())

    # -- introspection -------------------------------------------------------

    def latency_percentiles(self) -> dict:
        with self._lat_lock:
            lats = sorted(d for s, d in self._latencies if s == "ok")
        return {"p50_s": _percentile(lats, 50),
                "p95_s": _percentile(lats, 95),
                "p99_s": _percentile(lats, 99)}

    def forward_census(self) -> dict:
        """Per bucket: forwards, rows and the rows a second of forward
        time."""
        with self._lat_lock:
            fwds = {b: list(v) for b, v in self._forwards.items()}
        out = {}
        for b, recs in fwds.items():
            rows = sum(n for n, _ in recs)
            busy = sum(d for _, d in recs)
            out[b] = {"batches": len(recs), "rows": rows, "busy_s": busy,
                      "rows_per_s": rows / busy if busy > 0 else 0.0}
        return out

    def stats(self) -> dict:
        local, _, _ = self.metrics.snapshot()
        return {
            "kind": self.kind,
            "weight": self.weight,
            "counters": {name: v for name, (v, _p) in local.items()},
            "queue_depth": self.queue.depth,
            "queue_depth_by_level": self.queue.depth_by_level(),
            "priority_classes": list(self.spec.priority_classes),
            "deadline_classes": dict(self.spec.deadline_classes),
            "workers": [w.wid for w in self.workers],
            "ready_batches": len(self.ready),
            "inflight": self.inflight,
            "slo": self.slo.snapshot(),
            "latency": self.latency_percentiles(),
            "buckets": self.forward_census(),
            "quantize": self.spec.quantize,
        }


class GenerativeTenant(_ClassResolution):
    """Runtime of one ``kind="generate"`` tenant: a ``ContinuousGenerator``
    whose own scheduler thread takes the place of the worker pool.  The
    fleet's admission plane still fronts it (tenant resolution, typed
    sheds, the census), and its records carry the tenant tag through the
    generator's ``ledger_tags``."""

    kind = "generate"

    def __init__(self, spec: TenantSpec, budgeter=None, device="cuda"):
        self.spec = spec
        self.name = spec.name
        self.weight = spec.weight
        self.generator = spec.build_generator(budgeter, device)
        self.workers: List = []          # never pool-allocated
        self.ready: collections.deque = collections.deque()
        self.inflight = 0
        self.accepted = 0
        self._former = None

    def ledger_tags(self) -> dict:
        return {"tenant": self.name}

    def submit(self, prompt, max_new: int,
               session: Optional[str] = None):
        return self.generator.submit(prompt, max_new, session=session)

    def stats(self) -> dict:
        st = self.generator.stats()
        st.update(kind=self.kind, weight=self.weight,
                  quantize=self.spec.quantize)
        return st


class ModelRegistry:
    """Thread-safe name -> tenant map with live add and remove.  The fleet
    owns the lifecycle; the registry owns resolution: ``get`` raises the
    typed :class:`UnknownTenantError`, so a request for a deregistered model
    dies at the door, attributably."""

    def __init__(self):
        self._reg_lock = threading.Lock()
        self._tenants: Dict[str, object] = {}

    def add(self, tenant) -> None:
        with self._reg_lock:
            if tenant.name in self._tenants:
                raise ValueError(f"tenant {tenant.name!r} is already "
                                 "registered")
            self._tenants[tenant.name] = tenant

    def remove(self, name: str):
        with self._reg_lock:
            return self._tenants.pop(name)

    def get(self, name: str):
        with self._reg_lock:
            t = self._tenants.get(name)
            known = sorted(self._tenants) if t is None else None
        if t is None:
            raise UnknownTenantError(
                f"unknown tenant {name!r} (registered: {known})")
        return t

    def names(self) -> List[str]:
        with self._reg_lock:
            return sorted(self._tenants)

    def tenants(self) -> List:
        with self._reg_lock:
            return list(self._tenants.values())

    def __contains__(self, name: str) -> bool:
        with self._reg_lock:
            return name in self._tenants

    def __len__(self) -> int:
        with self._reg_lock:
            return len(self._tenants)
