"""Thread-safe named counters and the nearest-rank percentile, kept by the
serving fronts (``InferenceServer``, ``ContinuousGenerator``) for their
``stats()``."""

from __future__ import annotations

import collections
import math
import threading
from typing import Dict, List


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile (ceil(q/100 * n)) on an ascending list."""
    if not sorted_vals:
        return 0.0
    rank = math.ceil(q / 100.0 * len(sorted_vals))
    return sorted_vals[min(len(sorted_vals) - 1, max(0, rank - 1))]


class Counters:
    """Thread-safe named counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[str, int] = collections.Counter()

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)
