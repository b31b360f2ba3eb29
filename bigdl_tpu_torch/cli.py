"""``python -m bigdl_tpu_torch.cli <subcommand>`` (``bigdl_tpu/cli.py``).

``run-report`` and ``trace-export`` read a run directory's ledger; both
are pure file reading and import neither torch nor numpy, so they start
in a fraction of a second on any machine.  The reference's other
subcommands come with later parts of ``ROADMAP.md`` Queue 1 item 13 (or
item 12), and raise ``NotImplementedError`` naming theirs until then.
"""

from __future__ import annotations

import sys


def run_report(argv=None) -> int:
    """Render a run-ledger directory — per-phase time breakdown,
    step-time percentiles, throughput, and the resilience event census."""
    from bigdl_tpu_torch.observability.report import main as report_main
    return report_main(argv)


def trace_export(argv=None) -> int:
    """Stitch a run directory's per-pid ledger files into ONE
    Chrome/Perfetto trace-event JSON: spans on their real pid/tid rows,
    compile/io/serve records beside them, and every cross-process link as
    a flow arrow — load it at https://ui.perfetto.dev."""
    from bigdl_tpu_torch.observability.trace import main as trace_main
    return trace_main(argv)


# the reference's other subcommands, each with the part of the port it
# waits for (ROADMAP.md Queue 1)
_Q = "ROADMAP.md Queue 1 item"
_LATER = {
    "fleet-report": f"comes with the serving fleet ({_Q} 13)",
    "fleet-drill": f"comes with the serving fleet ({_Q} 13)",
    "rollout-drill": f"comes with the serving fleet ({_Q} 13)",
    "train-drill": f"comes with the resilience part of {_Q} 13",
    "serve-drill": f"comes with serving/drill.py ({_Q} 13)",
    "bench-serve": f"comes with serving/bench_serve.py ({_Q} 13)",
    "bench-infer": f"comes with bench_quant ({_Q} 13)",
    "tune": f"comes with ops/tuning.py and bench_tune.py ({_Q} 13)",
    "mem-drill": f"comes with the rest of cli.py ({_Q} 13)",
    "bench-ingest": f"comes with the rest of cli.py ({_Q} 13)",
    "mesh-explain": f"comes with the parallel strategies ({_Q} 12)",
    "lint": "is not ported (graftlint, the reference's analysis/)",
}


def main(argv=None) -> int:
    """The subcommand dispatcher."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m bigdl_tpu_torch.cli run-report <run_dir> "
              "[--json] [--strict]\n"
              "       python -m bigdl_tpu_torch.cli trace-export <run_dir> "
              "[--out PATH] [--since-s S]")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "run-report":
        return run_report(rest)
    if cmd == "trace-export":
        return trace_export(rest)
    if cmd in _LATER:
        raise NotImplementedError(f"cli {cmd} {_LATER[cmd]}")
    print(f"unknown subcommand {cmd!r} (expected: run-report, "
          "trace-export)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
