"""``python -m bigdl_tpu_torch.cli <subcommand>`` and the console wrappers of
the mains (``bigdl_tpu/cli.py``).

Subcommands:

* ``run-report`` and ``trace-export`` read a run directory's ledger; both
  are pure file reading and import neither torch nor numpy, so they start
  in a fraction of a second on any machine;
* ``serve-drill`` (``serving/drill.py``): the serving chaos drill, phases
  1-12, over the pool's fault sites and the multi-tenant fleet
  (``--fleet-smoke``: phase 12 alone);
* ``bench-serve`` (``serving/bench_serve.py``): static, bucketed and
  continuous generation with the paged ablations; ``--fleet`` the fleet's
  bench (``serving/fleet/bench_fleet.py``);
* ``bench-infer`` (``bench_quant.py``): int8 against bf16 forwards behind
  the accuracy budget, exit 1 over it;
* ``mem-drill`` (``serving/scheduler/mem_drill.py``): the memory-pressure
  drill;
* ``bench-ingest`` (``dataset/bench_ingest.py``): the sharded feed's
  records/s by worker count.

The drills and benches run on ``--device`` (CUDA by default) and write no
file unless asked (``--out``, ``--run-dir``).  The reference's other
subcommands come with later parts of ``ROADMAP.md`` Queue 1 and raise
``NotImplementedError`` naming theirs (``_LATER``).

The console wrappers (``lenet_train`` ... ``seqfile``) call a main and drop
its programmatic return (a trained model, a result dict), so a console
script built on one exits 0 on success, as in the reference; the imports
are lazy, so each pays only for its own module.
"""

from __future__ import annotations

import sys


def _wrap(import_path: str, attr: str):
    def run(argv=None):
        import importlib
        fn = getattr(importlib.import_module(import_path), attr)
        fn(argv)
        return None
    run.__name__ = attr
    run.__doc__ = f"console wrapper for {import_path}.{attr}"
    return run


_M = "bigdl_tpu_torch.models."
lenet_train = _wrap(_M + "lenet", "train_main")
lenet_test = _wrap(_M + "lenet", "test_main")
inception_train = _wrap(_M + "inception", "train_main")
inception_test = _wrap(_M + "inception", "test_main")
resnet_train = _wrap(_M + "resnet", "train_main")
resnet_test = _wrap(_M + "resnet", "test_main")
vgg_train = _wrap(_M + "vgg", "train_main")
vgg_test = _wrap(_M + "vgg", "test_main")
rnn_train = _wrap(_M + "rnn", "train_main")
rnn_test = _wrap(_M + "rnn", "test_main")
autoencoder_train = _wrap(_M + "autoencoder", "train_main")
transformer_train = _wrap(_M + "transformer", "train_main")
transformer_generate = _wrap(_M + "transformer", "generate_main")
perf = _wrap(_M + "perf", "main")
imageclassification = _wrap("bigdl_tpu_torch.example.imageclassification",
                            "main")
loadmodel = _wrap("bigdl_tpu_torch.example.loadmodel", "main")
textclassification = _wrap("bigdl_tpu_torch.example.textclassification",
                           "main")
seqfile = _wrap("bigdl_tpu_torch.dataset.seqfile", "main")


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


def serve_drill(argv=None) -> int:
    """The deterministic serving chaos drill: injected pack and forward
    faults, malformed rows, unmeetable deadlines, the breaker's open and
    recovery, overload expiry, drain, the worker pool's isolation, the
    paged generator under token pressure and the multi-tenant fleet's
    noisy neighbour and worker kill; exit 0 when every check holds."""
    from bigdl_tpu_torch.serving.drill import main as drill_main
    return drill_main(argv)


def bench_serve(argv=None) -> int:
    """Static vs bucketed vs continuous-batching generation over a
    shared-system-prompt mix, with the paged, kernel, prefix-cache and
    speculative ablations: useful tokens/s, p95 latency, prefix-hit and
    draft-accept rates.  ``--fleet``: the fleet's autoscaled, static-peak
    and noisy-neighbour runs behind their gates."""
    from bigdl_tpu_torch.serving.bench_serve import main as bench_main
    return bench_main(argv)


def bench_infer(argv=None) -> int:
    """int8 vs bf16 forwards (tokens/s, images/s, resident bytes, top-1 and
    logit deltas) behind the declared accuracy budget: exit 1 over it."""
    from bigdl_tpu_torch.bench_quant import main as bench_main
    return bench_main(argv)


def mem_drill(argv=None) -> int:
    """The memory-pressure drill: sessions parked to host RAM past the page
    pool, typed byte-starved sheds, exact budget accounting."""
    from bigdl_tpu_torch.serving.scheduler.mem_drill import main as drill
    return drill(argv)


def bench_ingest(argv=None) -> int:
    """The sharded feed's records/s at each worker count, with the per-stage
    attribution pass; exit 0 when it ran."""
    from bigdl_tpu_torch.dataset.bench_ingest import main as bench_main
    bench_main(argv)
    return 0


# the reference's other subcommands, each with the part of the port it
# waits for (ROADMAP.md Queue 1)
_Q = "ROADMAP.md Queue 1 item"
_LATER = {
    "fleet-report": f"comes with the cross-host cluster ({_Q} 13, part 3b)",
    "fleet-drill": f"comes with the cross-host cluster ({_Q} 13, part 3b)",
    "rollout-drill": f"comes with the live rollout ({_Q} 13, part 3c)",
    "train-drill": f"comes with DistriOptimizer and elastic training "
                   f"({_Q} 12)",
    "tune": f"comes with ops/tuning.py and bench_tune.py ({_Q} 13)",
    "mesh-explain": f"comes with the parallel strategies ({_Q} 12)",
    "lint": "is not ported (graftlint, the reference's analysis/)",
}

_COMMANDS = {"run-report": run_report, "trace-export": trace_export,
             "serve-drill": serve_drill, "bench-serve": bench_serve,
             "bench-infer": bench_infer, "mem-drill": mem_drill,
             "bench-ingest": bench_ingest}


def main(argv=None) -> int:
    """The subcommand dispatcher."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m bigdl_tpu_torch.cli run-report <run_dir> "
              "[--json] [--strict]\n"
              "       python -m bigdl_tpu_torch.cli trace-export <run_dir> "
              "[--out PATH] [--since-s S]\n"
              "       python -m bigdl_tpu_torch.cli serve-drill "
              "[--batch-size N] [--forward-delay-ms MS] [--workers N] "
              "[--device D] [--run-dir DIR] [--fleet-smoke]\n"
              "       python -m bigdl_tpu_torch.cli bench-serve "
              "[--requests N] [--batch N] [--smoke] [--device D] "
              "[--out PATH]\n"
              "       python -m bigdl_tpu_torch.cli bench-serve --fleet "
              "[--smoke] [--device D] [--out PATH]\n"
              "       python -m bigdl_tpu_torch.cli bench-infer "
              "[--smoke] [--device D] [--out PATH]\n"
              "       python -m bigdl_tpu_torch.cli mem-drill "
              "[--smoke] [--sessions N] [--num-pages N] [--device D] "
              "[--out PATH]\n"
              "       python -m bigdl_tpu_torch.cli bench-ingest "
              "[--records N] [--workers-list 0,1,2,4] [--smoke] "
              "[--device D] [--out PATH]")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd in _COMMANDS:
        return _COMMANDS[cmd](rest)
    if cmd in _LATER:
        raise NotImplementedError(f"cli {cmd} {_LATER[cmd]}")
    print(f"unknown subcommand {cmd!r} (expected: "
          f"{', '.join(_COMMANDS)})")
    return 2

if __name__ == "__main__":
    sys.exit(main())
