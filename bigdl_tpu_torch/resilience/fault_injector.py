"""Deterministic fault injection (``bigdl_tpu/resilience/fault_injector.py``):
the proof harness of every recovery path the port has.

The code plants normally inert injection sites and this module arms them.
A site is a dotted string checked where the real fault would strike:

============================  =============================================
site                          where it fires
============================  =============================================
``train.step``                ``LocalOptimizer``'s loop, after step N-1's
                              update, validation and snapshot (``@N`` =
                              ``neval`` N): a preemption between steps
``grad.nan``                  query site: step N's batch is poisoned as
                              ``jnp.full_like(data, nan)`` poisons it, so
                              the in-step non-finite guard must skip it
``serve.forward``             every serving worker's forward
                              (``serving/scheduler/pool.py``; ``@N`` =
                              batch sequence N, inside the retried forward:
                              ``=OSError`` is retried by ``forward_retries``)
``serve.worker<i>.forward``   worker ``i``'s forward only: the pool drill's
                              seam (its breaker opens, the others serve)
``serve.pack``                a serving worker's host-side batch packing
                              (fails only that batch; never the breaker)
``io.read``                   a record file's open in ``dataset/seqfile``
                              (inside the retried open: ``=OSError`` is
                              retried)
``mt.worker``                 an ``MTTransformer`` thread, before its chunk
``prefetch.producer``         ``PrefetchToDevice``'s producer thread, per
                              batch
``prefetch.put``              the copy of a batch to the device inside that
                              thread (retried as a transient ``OSError``;
                              the consumer never sees it)
``ingest.worker``             a sharded-ingest worker PROCESS, before it
                              touches its chunk (raises; propagates as
                              itself)
``ingest.worker.kill``        query site in the same worker: a hard
                              ``os._exit`` mid-chunk, the real death; the
                              consumer gets a typed ``IngestWorkerDied``,
                              never a hang
``ingest.stage``              the staging ring's stager thread, before it
                              copies a batch into a pinned slot
                              (``dataset/staging``)
============================  =============================================

The reference's ``checkpoint.save`` site fires in ``save_sharded``, its
orbax snapshots of ``DistriOptimizer``; it comes with them (``ROADMAP.md``
Queue 1 item 12).  Each injection is logged, kept in the injector's
``fired`` list and written to the run ledger as a flushed
``fault.injected`` event.

Arming is programmatic (``FaultInjector.install(...)``) or by environment,
for a relaunched process::

    BIGDL_TPU_FAULTS="train.step@5;io.read*2=OSError;grad.nan@3"

``site@N`` fires at step N (a site checked without a step takes ``@N`` as
"the Nth check"), ``site*K`` fires the first K times (default 1), and
``=Name`` picks the exception (``InjectedFault``, ``OSError``,
``TimeoutError``, ``RuntimeError``).  Spawned ingest workers inherit the
variable and arm themselves at their first check, each with its own counts.
Every match is deterministic.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import List, Optional

from bigdl_tpu_torch.observability import ledger as run_ledger

logger = logging.getLogger("bigdl_tpu_torch.resilience")


class InjectedFault(RuntimeError):
    """Raised by an armed injection site (the default exception type)."""


# the exception types an environment spec can name: a transient (retried)
# type and a hard one take different recovery paths
_EXC_TYPES = {"InjectedFault": InjectedFault, "OSError": OSError,
              "TimeoutError": TimeoutError, "RuntimeError": RuntimeError}


class Fault:
    """One armed fault: fire at ``site`` (at ``step``, or the first
    ``count`` checks), raising ``exc``."""

    def __init__(self, site: str, step: Optional[int] = None,
                 count: int = 1, exc: type = InjectedFault):
        self.site = site
        self.step = step
        self.count = count
        self.exc = exc
        self._seen = 0          # checks seen (a step-less site's @N)

    def matches(self, site: str, step: Optional[int]) -> bool:
        if site != self.site or self.count <= 0:
            return False
        if self.step is None:
            return True
        if step is None:
            self._seen += 1
            return self._seen == self.step
        return step == self.step

    @classmethod
    def parse(cls, spec: str) -> "Fault":
        """``site[@step][*count][=ExcName]``."""
        exc = InjectedFault
        if "=" in spec:
            spec, name = spec.split("=", 1)
            if name not in _EXC_TYPES:
                raise ValueError(
                    f"unknown fault exception {name!r}; choose from "
                    f"{sorted(_EXC_TYPES)}")
            exc = _EXC_TYPES[name]
        count = 1
        if "*" in spec:
            spec, c = spec.split("*", 1)
            count = int(c)
        step = None
        if "@" in spec:
            spec, s = spec.split("@", 1)
            step = int(s)
        if not spec:
            raise ValueError("fault spec has an empty site")
        return cls(spec, step=step, count=count, exc=exc)


class FaultInjector:
    """The process's armed faults.  Every check goes through the
    classmethods, so a site costs one ``is None`` test when nothing is
    armed.  ``install`` replaces the active injector, ``clear`` disarms;
    a fresh process arms itself from ``BIGDL_TPU_FAULTS`` at its first
    check."""

    _active: Optional["FaultInjector"] = None
    _env_loaded = False
    _lock = threading.Lock()

    def __init__(self, faults: Optional[List[Fault]] = None):
        self.faults = list(faults or [])
        self.fired: List[str] = []      # the sites that fired, in order

    def add(self, site: str, step: Optional[int] = None, count: int = 1,
            exc: type = InjectedFault) -> "FaultInjector":
        self.faults.append(Fault(site, step=step, count=count, exc=exc))
        return self

    @classmethod
    def install(cls, injector: Optional["FaultInjector"]) -> None:
        with cls._lock:
            cls._active = injector
            cls._env_loaded = True      # an explicit install wins

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._active = None
            cls._env_loaded = True

    @classmethod
    def from_env(cls, spec: str) -> "FaultInjector":
        return cls([Fault.parse(s) for s in spec.split(";") if s.strip()])

    @classmethod
    def active(cls) -> Optional["FaultInjector"]:
        if not cls._env_loaded:
            with cls._lock:
                if not cls._env_loaded:
                    spec = os.environ.get("BIGDL_TPU_FAULTS", "")
                    if spec:
                        cls._active = cls.from_env(spec)
                        logger.warning(
                            "FaultInjector armed from BIGDL_TPU_FAULTS=%r",
                            spec)
                    cls._env_loaded = True
        return cls._active

    @classmethod
    def fire(cls, site: str, step: Optional[int] = None) -> None:
        """Raise if a fault is armed for ``site`` (at ``step``)."""
        inj = cls.active()
        if inj is None:
            return
        with cls._lock:
            for f in inj.faults:
                if f.matches(site, step):
                    f.count -= 1
                    inj.fired.append(site)
                    logger.warning("injecting fault at %s (step %s): %s",
                                   site, step, f.exc.__name__)
                    _ledger_event(site, step, f.exc.__name__)
                    raise f.exc(f"injected fault at {site}"
                                + (f" step {step}" if step is not None
                                   else ""))

    @classmethod
    def should(cls, site: str, step: Optional[int] = None) -> bool:
        """The non-raising form: True where the caller should act out the
        fault itself (``ingest.worker.kill`` exits the process)."""
        inj = cls.active()
        if inj is None:
            return False
        with cls._lock:
            for f in inj.faults:
                if f.matches(site, step):
                    f.count -= 1
                    inj.fired.append(site)
                    logger.warning("injecting fault at %s (step %s)",
                                   site, step)
                    _ledger_event(site, step, None)
                    return True
        return False


def _ledger_event(site: str, step: Optional[int], exc: Optional[str]) -> None:
    """Record an injected fault in the run ledger, flushed: the fault often
    kills the process it was injected into."""
    fields = {"site": site}
    if step is not None:
        fields["step"] = step
    if exc is not None:
        fields["exc"] = exc
    run_ledger.emit_critical("event", kind="fault.injected", **fields)
