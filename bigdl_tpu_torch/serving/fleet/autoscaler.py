"""SLO-driven autoscaling of the fleet's worker allocations
(``bigdl_tpu/serving/fleet/autoscaler.py``).

The :class:`Autoscaler` evaluates every classify tenant on a fixed cadence
and moves parked workers in and out of tenant allocations:

* grow when a tenant's SLO burn rate is at or over ``burn_hi`` or its
  backlog reaches ``backlog_hi`` batches per allocated worker, for
  ``grow_after`` evaluations in a row; the new worker runs every rung of
  the tenant's ladder before the dispatcher routes to it;
* shrink when burn is at or under ``burn_lo`` and backlog at or under
  ``backlog_lo`` for ``shrink_after`` evaluations in a row, never below
  ``min_workers``; a released worker finishes its inbox first.

The grow and shrink thresholds are apart (hysteresis), a run of
evaluations is needed, and after any action the tenant waits
``cooldown_s``.  With the fleet's ``MemoryBudgeter``, a tenant at or over
``bytes_hi`` of its budget is memory-bound until it falls to ``bytes_lo``:
its grows are held (a ``direction="hold"`` event), since another worker
cannot cure byte starvation.  Every action is a ``fleet.scale`` ledger
event.  ``evaluate(now)`` is public and deterministic; the thread only
calls it on the cadence.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from bigdl_tpu_torch.observability import ledger as run_ledger


class Autoscaler:

    def __init__(self, fleet, *,
                 interval_s: float = 0.25,
                 burn_hi: float = 1.0,
                 burn_lo: float = 0.25,
                 backlog_hi: float = 2.0,
                 backlog_lo: float = 0.5,
                 grow_after: int = 2,
                 shrink_after: int = 4,
                 cooldown_s: float = 1.0,
                 bytes_hi: float = 0.9,
                 bytes_lo: float = 0.7):
        if not burn_lo < burn_hi:
            raise ValueError(f"hysteresis requires burn_lo < burn_hi "
                             f"({burn_lo} !< {burn_hi})")
        if not backlog_lo < backlog_hi:
            raise ValueError(f"hysteresis requires backlog_lo < "
                             f"backlog_hi ({backlog_lo} !< {backlog_hi})")
        if not bytes_lo < bytes_hi:
            raise ValueError(f"hysteresis requires bytes_lo < "
                             f"bytes_hi ({bytes_lo} !< {bytes_hi})")
        self.fleet = fleet
        self.interval_s = float(interval_s)
        self.burn_hi = float(burn_hi)
        self.burn_lo = float(burn_lo)
        self.backlog_hi = float(backlog_hi)
        self.backlog_lo = float(backlog_lo)
        self.grow_after = max(1, int(grow_after))
        self.shrink_after = max(1, int(shrink_after))
        self.cooldown_s = float(cooldown_s)
        self.bytes_hi = float(bytes_hi)
        self.bytes_lo = float(bytes_lo)
        self._over: Dict[str, int] = {}     # evaluations under pressure
        self._under: Dict[str, int] = {}    # evaluations idle
        self._cool_until: Dict[str, float] = {}
        self._mem_bound: Dict[str, bool] = {}   # the bytes band's latch
        self.actions = 0
        self.suppressed = 0    # grows held for memory-bound tenants
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="bigdl-torch-fleet-autoscale",
            daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:              # scaling must never kill it
                logging.getLogger("bigdl_tpu_torch.serving").exception(
                    "autoscaler: evaluation error")

    def _signals(self, t) -> Dict[str, float]:
        """Backlog in batches per allocated worker: queued rows as batches,
        formed batches not dispatched, and batches in flight."""
        n = max(1, len(t.workers))
        backlog = (t.queue.depth / t.batch_size + len(t.ready)
                   + t.inflight) / n
        budgeter = getattr(self.fleet, "budgeter", None)
        occ = budgeter.occupancy(t.name) if budgeter is not None else 0.0
        return {"burn": t.slo.snapshot()["burn_rate"],
                "backlog": backlog,
                "bytes": occ,
                "inflight": t.inflight}

    def evaluate(self, now: Optional[float] = None) -> int:
        """One pass over every classify tenant; returns the scale actions
        taken."""
        now = time.monotonic() if now is None else now
        acted = 0
        for t in self.fleet.registry.tenants():
            if t.kind != "classify":
                continue
            sig = self._signals(t)
            pressure = (sig["burn"] >= self.burn_hi
                        or sig["backlog"] >= self.backlog_hi)
            idle = (sig["burn"] <= self.burn_lo
                    and sig["backlog"] <= self.backlog_lo)
            if sig["bytes"] >= self.bytes_hi:
                self._mem_bound[t.name] = True
            elif sig["bytes"] <= self.bytes_lo:
                self._mem_bound[t.name] = False
            self._over[t.name] = self._over.get(t.name, 0) + 1 \
                if pressure else 0
            self._under[t.name] = self._under.get(t.name, 0) + 1 \
                if idle else 0
            if now < self._cool_until.get(t.name, -float("inf")):
                continue
            if self._over[t.name] >= self.grow_after:
                if self._mem_bound.get(t.name, False):
                    run_ledger.emit(
                        "event", kind="fleet.scale", tenant=t.name,
                        direction="hold", reason="memory_bound",
                        burn=sig["burn"], backlog=sig["backlog"],
                        bytes_occupancy=sig["bytes"])
                    self.suppressed += 1
                    self._over[t.name] = 0
                    continue
                if self.fleet.scale_up(
                        t, reason="burn" if sig["burn"] >= self.burn_hi
                        else "backlog",
                        burn=sig["burn"], backlog=sig["backlog"],
                        bytes_occupancy=sig["bytes"]):
                    self._cool_until[t.name] = now + self.cooldown_s
                    self._over[t.name] = 0
                    self._under[t.name] = 0
                    self.actions += 1
                    acted += 1
            elif self._under[t.name] >= self.shrink_after:
                if self.fleet.scale_down(
                        t, reason="idle",
                        burn=sig["burn"], backlog=sig["backlog"]):
                    self._cool_until[t.name] = now + self.cooldown_s
                    self._over[t.name] = 0
                    self._under[t.name] = 0
                    self.actions += 1
                    acted += 1
        return acted

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
