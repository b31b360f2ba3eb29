"""Training metrics counters (``bigdl_tpu/optim/metrics.py``).

Parity: ``optim/Metrics.scala:27-117`` — named counters with three scopes
(local atomic, aggregated scalar, per-node array): ``local`` (host
scalar) and ``distributed`` (per-node array) within a process, the fixed
latency-histogram ladder, and ``summary()``.  The metric *names* set by
the trainers and the serving front match the reference's ("computing
time average", "serve.latency", ...) so dashboards and logs read the
same.  The port runs one process: ``gathered()`` is the one-process view.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Sequence, Tuple

# The fixed serving-latency bucket ladder (seconds).  FIXED on purpose:
# Prometheus histograms aggregate across scrape targets only when every
# worker exports the same ``le`` boundaries — a per-worker adaptive
# ladder would make fleet-wide p99 queries silently wrong.  Log-spaced
# 1ms..10s, the range online inference lives in.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0)


class Metrics:

    def __init__(self):
        self._local: Dict[str, List[float]] = {}
        self._dist: Dict[str, List[float]] = {}
        self._units: Dict[str, str] = {}
        self._hist: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def set(self, name: str, value, parallel: int = 1, unit: str = None):
        """Register/overwrite a metric.  A list value registers a
        per-node/distributed metric.  ``unit``: per-metric display unit;
        metrics carrying one are printed raw (no ns->s scaling) — used
        for non-time counters like the per-iteration comm traffic."""
        with self._lock:
            if isinstance(value, (list, tuple)):
                self._dist[name] = [float(v) for v in value]
            else:
                self._local[name] = [float(value), float(parallel)]
            if unit is not None:
                self._units[name] = unit

    def incr(self, name: str, n: int = 1):
        """Increment an event counter (registered with the raw ``count``
        unit so ``summary()`` never ns-scales it).  Used for the
        resilience accounting: skipped non-finite steps, retried I/O,
        injected faults — the TPU-native ledger of the reference's
        dropped-gradient counts (``DistriOptimizer.scala:244-272``)."""
        with self._lock:
            self._units.setdefault(name, "count")
            if name in self._local:
                self._local[name][0] += n
            else:
                self._local[name] = [float(n), 1.0]

    def add(self, name: str, value):
        """Accumulate into a metric.  Scalar metrics add a scalar; a
        DISTRIBUTED metric accumulates element-wise from a same-length
        per-node list (appending instead — the pre-PR-2 behavior — grew
        the array on every add and silently broke the cross-process
        gather shape invariant documented above).  A shape/kind mismatch
        raises rather than corrupting the counter."""
        with self._lock:
            if name in self._dist:
                cur = self._dist[name]
                if not isinstance(value, (list, tuple)):
                    raise TypeError(
                        f"Metrics.add({name!r}): metric is distributed "
                        f"(per-node array of {len(cur)}); pass a list of "
                        f"{len(cur)} per-node increments, not a scalar")
                if len(value) != len(cur):
                    raise ValueError(
                        f"Metrics.add({name!r}): {len(value)} increments "
                        f"for a {len(cur)}-node metric — element counts "
                        "must match (the gather shape invariant)")
                self._dist[name] = [a + float(b)
                                    for a, b in zip(cur, value)]
            elif isinstance(value, (list, tuple)):
                if name in self._local:
                    raise TypeError(
                        f"Metrics.add({name!r}): metric is a scalar; "
                        "pass a scalar increment, not a list")
                self._dist[name] = [float(v) for v in value]
            elif name in self._local:
                self._local[name][0] += float(value)
            else:
                self._local[name] = [float(value), 1.0]

    def observe(self, name: str, value: float,
                buckets: Sequence[float] = LATENCY_BUCKETS_S):
        """Record one observation into a histogram metric (exported in
        Prometheus histogram exposition: cumulative ``_bucket{le=...}``
        lines plus ``_sum``/``_count``).  The bucket ladder is fixed at
        the metric's first observation; re-observing with a different
        ladder raises — mixed ladders cannot be aggregated across
        workers, which is the whole point of a histogram export."""
        b = tuple(float(x) for x in buckets)
        if list(b) != sorted(set(b)):
            raise ValueError(f"histogram buckets must be ascending and "
                             f"unique, got {list(buckets)}")
        with self._lock:
            h = self._hist.get(name)
            if h is None:
                h = self._hist[name] = {
                    "buckets": b,
                    # one count per finite bucket + the +Inf overflow
                    "counts": [0] * (len(b) + 1),
                    "sum": 0.0, "count": 0}
            elif h["buckets"] != b:
                raise ValueError(
                    f"Metrics.observe({name!r}): bucket ladder "
                    f"{list(b)} differs from the registered "
                    f"{list(h['buckets'])} — the ladder is fixed so "
                    "scrapes aggregate across workers")
            h["counts"][bisect.bisect_left(h["buckets"],
                                           float(value))] += 1
            h["sum"] += float(value)
            h["count"] += 1

    def hist_snapshot(self) -> Dict[str, dict]:
        """Consistent copy of the histogram state (exporter surface)."""
        with self._lock:
            return {n: {"buckets": h["buckets"],
                        "counts": list(h["counts"]),
                        "sum": h["sum"], "count": h["count"]}
                    for n, h in self._hist.items()}

    def get(self, name: str):
        if name in self._local:
            v, p = self._local[name]
            return v / p
        if name in self._dist:
            return list(self._dist[name])
        raise KeyError(name)

    def snapshot(self) -> Tuple[Dict[str, List[float]],
                                Dict[str, List[float]], Dict[str, str]]:
        """Consistent copy of ``(local, dist, units)`` — the exporter
        surface (``observability.prometheus``) without reaching into the
        lock-guarded internals."""
        with self._lock:
            return ({n: list(v) for n, v in self._local.items()},
                    {n: list(v) for n, v in self._dist.items()},
                    dict(self._units))

    def gathered(self) -> Tuple[Dict[str, Tuple[float, List[float]]],
                                Dict[str, List[float]]]:
        """Cross-process merged view: ``(scalars, arrays)`` with
        ``scalars[name] = (mean over processes, [per-process value])``
        and ``arrays[name]`` every process's entries.  The port runs one
        process, so this is the one-entry view of the local counters; the
        gather over a process group comes with ``DistriOptimizer``
        (``ROADMAP.md`` Queue 1 item 12)."""
        with self._lock:
            local = {n: list(v) for n, v in self._local.items()}
            dist = {n: list(v) for n, v in self._dist.items()}
        return ({n: (v / p, [v / p]) for n, (v, p) in local.items()},
                dist)

    def summary(self, unit: str = "s", scale: float = 1e9,
                across_processes: bool = False) -> str:
        def _fmt(name, value, per=None):
            u = self._units.get(name)
            s = 1.0 if u is not None else scale     # unit-tagged: raw
            u = u if u is not None else unit
            line = f"{name} : {value / s} {u}"
            if per is not None:
                line += f" (per node: {[v / s for v in per]})"
            return line

        lines = ["========== Metrics Summary =========="]
        if across_processes:
            scalars, arrays = self.gathered()
            for name, (mean, per) in sorted(scalars.items()):
                lines.append(_fmt(name, mean, per))
            for name, vals in sorted(arrays.items()):
                avg = sum(vals) / max(1, len(vals))
                lines.append(_fmt(name, avg, vals))
        else:
            for name, (v, p) in sorted(self._local.items()):
                lines.append(_fmt(name, v / p))
            for name, vals in sorted(self._dist.items()):
                avg = sum(vals) / max(1, len(vals))
                lines.append(_fmt(name, avg, vals))
        lines.append("=====================================")
        return "\n".join(lines)
