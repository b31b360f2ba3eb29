"""Weighted-fair tenant dispatch by stride scheduling
(``bigdl_tpu/serving/fleet/dispatch.py``).

The fleet picks the next TENANT by stride scheduling (Waldspurger and
Weihl), then routes that tenant's oldest formed batch least-loaded within
the tenant's own worker allocation:

* every tenant declares an integer ``weight``; its stride is
  ``STRIDE_ONE // weight``;
* each tenant carries a pass value; the scheduler picks the ready tenant
  with the least pass (ties on the name, so drills are deterministic) and
  advances the winner's pass by its stride;
* a newly registered or newly ready tenant enters at the virtual time (the
  least pass among the tenants that stayed ready), so it is neither starved
  by its late arrival nor handed a burst of the passes it never used.

Starvation bound: between two dispatches of a continuously ready tenant of
weight ``w``, at most ``ceil(W / w) + 1`` dispatches land, ``W`` the sum of
the registered weights (:meth:`StrideScheduler.starvation_bound`).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

# one dispatch of a weight-1 tenant moves its pass by STRIDE_ONE; large so
# integer strides stay exact for any sane weight
STRIDE_ONE = 1 << 20


class StrideScheduler:
    """Weighted-fair pick order over named tenants.  Thread-safe; the share
    of dispatches a tenant gets under contention is
    ``weight / sum(ready weights)``."""

    def __init__(self):
        self._sched_lock = threading.Lock()
        self._stride: Dict[str, int] = {}
        self._pass: Dict[str, int] = {}
        self._weight: Dict[str, int] = {}
        self._was_ready: set = set()

    def add(self, name: str, weight: int) -> None:
        w = int(weight)
        if w < 1:
            raise ValueError(f"tenant weight must be >= 1, got {weight}")
        with self._sched_lock:
            if name in self._stride:
                raise ValueError(f"tenant {name!r} already scheduled")
            self._stride[name] = STRIDE_ONE // w
            self._weight[name] = w
            # enter at virtual time: fair from the first pick
            self._pass[name] = min(self._pass.values(), default=0)

    def remove(self, name: str) -> None:
        with self._sched_lock:
            self._stride.pop(name, None)
            self._pass.pop(name, None)
            self._weight.pop(name, None)

    def pick(self, ready: Iterable[str]) -> Optional[str]:
        """The next tenant to dispatch among ``ready`` (least pass, ties on
        the name), advancing its pass; None when nothing is ready."""
        with self._sched_lock:
            cands = [n for n in ready if n in self._stride]
            if not cands:
                self._was_ready = set()
                return None
            # a tenant that sat idle re-enters at virtual time, the least
            # pass among the tenants that stayed ready: its parked low pass
            # must not buy it a run of back dispatches
            staying = [n for n in cands if n in self._was_ready]
            vt = min(self._pass[n] for n in (staying or cands))
            for n in cands:
                if n not in self._was_ready and self._pass[n] < vt:
                    self._pass[n] = vt
            self._was_ready = set(cands)
            winner = min(cands, key=lambda n: (self._pass[n], n))
            self._pass[winner] += self._stride[winner]
            return winner

    def weights(self) -> Dict[str, int]:
        with self._sched_lock:
            return dict(self._weight)

    def starvation_bound(self, name: str) -> int:
        """The most dispatches that can land between two dispatches of
        ``name`` while it stays ready: ``ceil(W / w) + 1``."""
        with self._sched_lock:
            w = self._weight[name]
            total = sum(self._weight.values())
        return -(-total // w) + 1
