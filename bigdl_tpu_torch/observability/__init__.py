"""Run observability of the port (``bigdl_tpu/observability``): spans, the
run ledger, trace export, summaries, Prometheus, live ``/metrics`` and the
SLO tracker, and the run report.

Every run with ``BIGDL_TPU_RUN_DIR`` set (or :func:`set_run_dir` called)
appends a durable JSONL event ledger — tracing spans over the hot seams,
per-step records, scalar summaries, kernel-build ``compile`` records and
the resilience events — that ``python -m bigdl_tpu_torch.cli run-report
<dir>`` turns back into a per-phase time breakdown, step-time
percentiles, throughput and an event census.  The records, the report
and the trace export are the reference's, so one run directory reads the
same through either package.
"""

from bigdl_tpu_torch.observability.costs import (cost_probe, emit_cost,
                                                 sample_hbm)
from bigdl_tpu_torch.observability.ledger import (RunLedger, emit,
                                                  emit_critical, enabled,
                                                  flush, get_ledger,
                                                  set_run_dir, trace_id)
from bigdl_tpu_torch.observability.live import (LiveMetricsServer,
                                                MetricsSnapshotter,
                                                SLOTracker)
from bigdl_tpu_torch.observability.prometheus import (metrics_to_prometheus,
                                                      write_prometheus)
from bigdl_tpu_torch.observability.summary import (Summary, TFEventWriter,
                                                   TrainSummary,
                                                   ValidationSummary)
from bigdl_tpu_torch.observability.tracer import (begin_span, current_span,
                                                  record_compile, span)

__all__ = [
    "RunLedger", "emit", "emit_critical", "enabled", "flush",
    "get_ledger", "set_run_dir", "trace_id",
    "span", "begin_span", "current_span", "record_compile",
    "Summary", "TrainSummary", "ValidationSummary", "TFEventWriter",
    "metrics_to_prometheus", "write_prometheus",
    "cost_probe", "emit_cost", "sample_hbm",
    "LiveMetricsServer", "MetricsSnapshotter", "SLOTracker",
]
