"""Prometheus text-format export of ``optim.Metrics``
(``bigdl_tpu/observability/prometheus.py``: the same ``bigdl_tpu`` prefix,
so a scrape reads the same names from either package;
``fleet_to_prometheus`` comes with the serving fleet).

The reference printed its Metrics to the log; a production run
wants them scrapeable.  This renders the counter state in the Prometheus
exposition format (text/plain version 0.0.4) — either to a string for an
HTTP handler, or dumped to ``<run_dir>/metrics-<pid>.prom`` at the end
of training (the trainers do this automatically when the ledger is on)
for node-exporter's textfile collector.

Unit handling mirrors ``Metrics.summary()``: metrics without a
registered unit are nanosecond timings and export as ``_seconds``
gauges; ``count`` metrics export as ``_total``; any other unit tags the
metric name verbatim.
"""

from __future__ import annotations

import re
from typing import Optional


def _sanitize(name: str) -> str:
    return re.sub(r"_+", "_",
                  re.sub(r"[^a-zA-Z0-9_]", "_",
                         name.strip().lower())).strip("_")


def metrics_to_prometheus(metrics, prefix: str = "bigdl_tpu") -> str:
    """Render a ``Metrics`` object as Prometheus exposition text."""
    local, dist, units = metrics.snapshot()
    lines = []

    def _emit(name: str, value, per=None):
        unit = units.get(name)
        if unit is None:            # unitless = nanosecond wall timing
            metric = f"{prefix}_{_sanitize(name)}_seconds"
            scale = 1e9
        elif unit == "count":
            metric = f"{prefix}_{_sanitize(name)}_total"
            scale = 1.0
        elif unit == "scalar":      # dimensionless (e.g. loss): no
            metric = f"{prefix}_{_sanitize(name)}"   # suffix, no scaling
            scale = 1.0
        else:
            metric = f"{prefix}_{_sanitize(name)}_{_sanitize(unit)}"
            scale = 1.0
        lines.append(f"# HELP {metric} {name}"
                     + (f" [{unit}]" if unit else " [seconds]"))
        lines.append(f"# TYPE {metric} gauge")
        if per is None:
            lines.append(f"{metric} {value / scale}")
        else:
            for i, v in enumerate(per):
                lines.append(f'{metric}{{node="{i}"}} {v / scale}')
    for name in sorted(local):
        v, p = local[name]
        _emit(name, v / max(p, 1.0))
    for name in sorted(dist):
        vals = dist[name]
        _emit(name, None, per=vals)

    # histogram metrics (``Metrics.observe``): real Prometheus histogram
    # exposition — cumulative le buckets + _sum/_count.  The fixed
    # bucket ladder (LATENCY_BUCKETS_S) is what makes a fleet of
    # serving workers aggregatable in one scrape query.
    hists = getattr(metrics, "hist_snapshot", None)
    for name, h in sorted((hists() if hists is not None else {}).items()):
        metric = f"{prefix}_{_sanitize(name)}_seconds"
        lines.append(f"# HELP {metric} {name} [histogram, seconds]")
        lines.append(f"# TYPE {metric} histogram")
        cum = 0
        for le, c in zip(h["buckets"], h["counts"]):
            cum += c
            lines.append(f'{metric}_bucket{{le="{le}"}} {cum}')
        cum += h["counts"][len(h["buckets"])]
        lines.append(f'{metric}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{metric}_sum {h['sum']}")
        lines.append(f"{metric}_count {h['count']}")
    return "\n".join(lines) + "\n"


def write_prometheus(metrics, path: str,
                     prefix: str = "bigdl_tpu") -> Optional[str]:
    """Dump the exposition text to ``path``; returns the path (None on
    I/O failure — the export must never fail a training run)."""
    try:
        with open(path, "w", encoding="utf-8") as f:
            f.write(metrics_to_prometheus(metrics, prefix=prefix))
        return path
    except OSError:
        return None
