"""Device-memory budgeter (``bigdl_tpu/serving/scheduler/membudget.py``).

One ledger of device bytes per tenant, so that byte pressure becomes
policy instead of an out-of-memory crash:

* **charge classes** — ``kv_pages`` (private KV pages of live and resident
  sessions), ``prefix_pages`` (shared prefix-cache pages), ``params``,
  ``rung_executables`` and ``host_offload`` (parked sessions' pages in
  host RAM: reported, not counted against the device budget, which is why
  parking frees headroom).  The fleet charges each tenant's ``params``;
  the port charges no ``rung_executables`` (it compiles no program per
  rung, so a warm rung holds no device bytes of its own); the class stays
  so the census has the reference's keys.
* **typed enforcement** — :meth:`require_possible` sheds a request whose
  bytes exceed the tenant's whole budget (``MemoryBudgetError``, reason
  ``byte_starved``); :meth:`admit` sheds one that cannot fit after the
  reclaim ladder ran.  Tenants' budgets are independent.
* **reclaim ladder** — :meth:`reclaim` runs registered reclaimers in
  priority order.  The generator's own rungs (prefix-cache leaves, idle
  session parking) run inline on its scheduler thread instead, which owns
  the pool.

One ``RLock`` guards the maps; reclaimers run outside it, because they
discharge through this same budgeter.  The budgeter never touches a
device: it is bookkeeping and policy, testable on the CPU.

Every state change lands in the run ledger as a ``mem.budget`` record
(``action`` = ``charge`` / ``discharge`` / ``transfer`` / ``shed`` /
``reclaim`` / ``budget``), the trail behind run-report's memory census
and ``mem_drill``'s census check.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.serving.errors import MemoryBudgetError

#: charge classes, in the order the census reports them.  Everything
#: except ``host_offload`` counts against the device budget.
CHARGE_CLASSES = ("kv_pages", "prefix_pages", "params",
                  "rung_executables", "host_offload")

DEVICE_CLASSES = ("kv_pages", "prefix_pages", "params",
                  "rung_executables")


class MemoryBudgeter:
    """Per-tenant device-byte accounting with typed enforcement and a
    pluggable reclaim ladder.

    ``default_budget`` (bytes, None = unlimited) applies to tenants
    with no explicit :meth:`set_budget`; per-tenant budgets override.
    The budgeter never touches a device itself — it is pure
    bookkeeping plus policy, so it is exactly testable on CPU.
    """

    def __init__(self, default_budget: Optional[int] = None):
        if default_budget is not None and default_budget <= 0:
            raise ValueError(
                f"default_budget must be > 0 bytes, got {default_budget}")
        self._lock = threading.RLock()
        self._default = default_budget
        self._budgets: Dict[str, Optional[int]] = {}
        # tenant -> class -> bytes
        self._charged: Dict[str, Dict[str, int]] = {}
        # reclaim ladder: (priority, name, fn) — fn(tenant, need) -> freed
        self._reclaimers: List[Tuple[int, str,
                                     Callable[[str, int], int]]] = []
        # census counters (exact, for the run-report memory section)
        self._sheds: Dict[str, int] = {}        # tenant -> shed count
        self._reclaims: Dict[str, int] = {}     # reclaimer name -> calls
        self._reclaimed_bytes: Dict[str, int] = {}

    # -- budgets ------------------------------------------------------------

    def set_budget(self, tenant: str, budget: Optional[int]) -> None:
        """Set (or clear, with None) ``tenant``'s device byte budget."""
        if budget is not None and budget <= 0:
            raise ValueError(
                f"budget must be > 0 bytes or None, got {budget}")
        with self._lock:
            self._budgets[tenant] = budget
        run_ledger.emit("mem.budget", action="budget", tenant=tenant,
                        budget=budget)

    def budget(self, tenant: str) -> Optional[int]:
        with self._lock:
            return self._budgets.get(tenant, self._default)

    # -- charges ------------------------------------------------------------

    def charge(self, tenant: str, cls: str, nbytes: int, **detail) -> None:
        """Record ``nbytes`` of class ``cls`` against ``tenant``.

        Charging is unconditional — enforcement happens at admission
        (:meth:`admit`), not here: the bytes already exist on the
        device by the time they are charged, and lying about them
        would defeat the ledger."""
        self._delta(tenant, cls, int(nbytes), "charge", detail)

    def discharge(self, tenant: str, cls: str, nbytes: int,
                  **detail) -> None:
        """Return ``nbytes`` of class ``cls``; raises if the tenant
        never held that much — an accounting bug must fail loudly."""
        self._delta(tenant, cls, -int(nbytes), "discharge", detail)

    def transfer(self, tenant: str, src: str, dst: str, nbytes: int,
                 **detail) -> None:
        """Move ``nbytes`` between classes (e.g. private KV pages
        published into the prefix cache, or parked to host RAM) —
        one atomic ledger record instead of a discharge/charge pair
        that could be observed half-applied."""
        nbytes = int(nbytes)
        if nbytes == 0:
            return
        with self._lock:
            self._apply(tenant, src, -nbytes)
            self._apply(tenant, dst, nbytes)
            dev = self._device_total(tenant)
        run_ledger.emit("mem.budget", action="transfer", tenant=tenant,
                        src=src, dst=dst, bytes=nbytes,
                        device_bytes=dev, **detail)

    def _delta(self, tenant: str, cls: str, delta: int, action: str,
               detail: dict) -> None:
        if delta == 0:
            return
        with self._lock:
            total = self._apply(tenant, cls, delta)
            dev = self._device_total(tenant)
        run_ledger.emit("mem.budget", action=action, tenant=tenant,
                        cls=cls, bytes=abs(delta), charged=total,
                        device_bytes=dev, **detail)

    def _apply(self, tenant: str, cls: str, delta: int) -> int:
        if cls not in CHARGE_CLASSES:
            raise ValueError(f"unknown charge class {cls!r} "
                             f"(expected one of {CHARGE_CLASSES})")
        per = self._charged.setdefault(tenant, {})
        total = per.get(cls, 0) + delta
        if total < 0:
            raise ValueError(
                f"discharge below zero: tenant {tenant!r} class {cls} "
                f"holds {per.get(cls, 0)} bytes, delta {delta}")
        per[cls] = total
        return total

    def _device_total(self, tenant: str) -> int:
        per = self._charged.get(tenant, {})
        return sum(per.get(c, 0) for c in DEVICE_CLASSES)

    # -- reads --------------------------------------------------------------

    def charged(self, tenant: str, cls: Optional[str] = None) -> int:
        with self._lock:
            per = self._charged.get(tenant, {})
            if cls is not None:
                return per.get(cls, 0)
            return self._device_total(tenant)

    def headroom(self, tenant: str) -> Optional[float]:
        """Bytes left under the budget (None when unlimited)."""
        with self._lock:
            b = self._budgets.get(tenant, self._default)
            if b is None:
                return None
            return b - self._device_total(tenant)

    def occupancy(self, tenant: str) -> float:
        """Device bytes / budget, 0.0 when unlimited — the autoscaler's
        bytes-pressure signal and the lease telemetry's ``mem`` block."""
        with self._lock:
            b = self._budgets.get(tenant, self._default)
            if not b:
                return 0.0
            return self._device_total(tenant) / b

    # -- enforcement --------------------------------------------------------

    def require_possible(self, tenant: str, nbytes: int, *,
                         what: str = "request") -> None:
        """Submit-time never-fit check: shed typed iff ``nbytes``
        exceeds the tenant's WHOLE budget — no reclaim, park or evict
        could ever seat it, so admitting it would only waste queue
        capacity before the same shed happens at placement.  A request
        that merely doesn't fit *right now* passes — placement's
        degradation ladder is the authority on current pressure."""
        nbytes = int(nbytes)
        budget = self.budget(tenant)
        if budget is None or nbytes <= budget:
            return
        with self._lock:
            self._sheds[tenant] = self._sheds.get(tenant, 0) + 1
            dev = self._device_total(tenant)
        run_ledger.emit("mem.budget", action="shed", tenant=tenant,
                        what=what, bytes=nbytes, device_bytes=dev,
                        budget=budget)
        raise MemoryBudgetError(
            f"tenant {tenant!r}: {what} needs {nbytes} device bytes "
            f"but the whole budget is {budget} — can never fit, shed "
            f"typed at submit")

    def admit(self, tenant: str, nbytes: int, *, what: str = "request",
              reclaim: bool = True) -> None:
        """Shed typed if ``nbytes`` more device bytes can never fit
        ``tenant``'s budget.

        Order: fits → return; over → run the reclaim ladder (when
        ``reclaim``) and re-check; still over → count the shed, emit
        the attribution record, raise
        :class:`~bigdl_tpu_torch.serving.errors.MemoryBudgetError`.  A
        request larger than the whole budget is shed immediately —
        no amount of reclaim could ever seat it."""
        nbytes = int(nbytes)
        head = self.headroom(tenant)
        if head is None or nbytes <= head:
            return
        budget = self.budget(tenant)
        if reclaim and budget is not None and nbytes <= budget:
            self.reclaim(tenant, nbytes - int(head))
            head = self.headroom(tenant)
            if head is None or nbytes <= head:
                return
        with self._lock:
            self._sheds[tenant] = self._sheds.get(tenant, 0) + 1
            dev = self._device_total(tenant)
        run_ledger.emit("mem.budget", action="shed", tenant=tenant,
                        what=what, bytes=nbytes, device_bytes=dev,
                        budget=budget)
        raise MemoryBudgetError(
            f"tenant {tenant!r}: {what} needs {nbytes} device bytes but "
            f"only {max(int(head), 0)} of the {budget}-byte budget "
            f"remain (holding {dev}) — byte-starved, shed typed")

    # -- reclaim ladder ------------------------------------------------------

    def register_reclaimer(self, name: str,
                           fn: Callable[[str, int], int],
                           priority: int = 0) -> None:
        """Add ``fn(tenant, need_bytes) -> freed_bytes`` to the ladder.

        Lower ``priority`` runs first (rung executables at 0 — cheap
        to re-warm — before anything costlier).  Reclaimers MUST be
        safe from the calling thread: the scheduler-owned rungs
        (prefix eviction, parking) run inline in the generator instead
        of registering here."""
        with self._lock:
            self._reclaimers.append((int(priority), name, fn))
            self._reclaimers.sort(key=lambda t: t[0])

    def reclaim(self, tenant: str, need: int) -> int:
        """Run the ladder until ``need`` device bytes were freed (or
        the ladder is dry); returns bytes freed.  Called outside the
        lock — reclaimers discharge through this same budgeter."""
        with self._lock:
            ladder = list(self._reclaimers)
        freed = 0
        for _, name, fn in ladder:
            if freed >= need:
                break
            got = int(fn(tenant, need - freed) or 0)
            if got <= 0:
                continue
            freed += got
            with self._lock:
                self._reclaims[name] = self._reclaims.get(name, 0) + 1
                self._reclaimed_bytes[name] = \
                    self._reclaimed_bytes.get(name, 0) + got
            run_ledger.emit("mem.budget", action="reclaim",
                            tenant=tenant, reclaimer=name, bytes=got)
        return freed

    # -- lifecycle / census --------------------------------------------------

    def drop_tenant(self, tenant: str) -> None:
        """Forget a deregistered tenant's budget and charges (its
        buffers were freed with it; census counters survive)."""
        with self._lock:
            self._budgets.pop(tenant, None)
            self._charged.pop(tenant, None)

    def snapshot(self) -> dict:
        """Point-in-time census: per-tenant charged bytes by class,
        budgets, occupancy, shed/reclaim counters — the ``stats()``
        block and the lease telemetry's ``mem`` payload."""
        with self._lock:
            tenants = {}
            for t in sorted(set(self._charged) | set(self._budgets)):
                per = self._charged.get(t, {})
                b = self._budgets.get(t, self._default)
                dev = self._device_total(t)
                tenants[t] = {
                    "charged": {c: per.get(c, 0) for c in CHARGE_CLASSES},
                    "device_bytes": dev,
                    "budget": b,
                    "occupancy": (dev / b) if b else 0.0,
                    "sheds": self._sheds.get(t, 0),
                }
            return {
                "tenants": tenants,
                "device_bytes": sum(v["device_bytes"]
                                    for v in tenants.values()),
                "sheds": sum(self._sheds.values()),
                "reclaims": dict(self._reclaims),
                "reclaimed_bytes": dict(self._reclaimed_bytes),
            }
