"""The port's serving drill, its benches and the cli around them
(``bigdl_tpu_torch/serving/drill.py``, ``serving/bench_serve.py``,
``bench_quant.py``, ``cli.py``) on the CPU, against the JAX package's.

* ``serve-drill`` (phases 1-12) exits 0 and its ledger gives the serving
  and fleet census that ``tests/test_serving.py::
  test_serve_drill_passes_and_report_renders`` asserts; ``--fleet-smoke``
  runs phase 12 alone, and ``bench-serve --cluster`` raises naming the
  cross-host cluster.
* ``bench-serve --smoke`` writes the artifact that
  ``tests/test_scheduler.py::test_bench_serve_smoke`` asserts; its traffic
  is bit-equal to the reference's for the same seed.
* ``bench-infer --smoke`` passes its gate and leaves nonzero int8 FLOP
  rows in the ledger, as ``tests/test_quant.py``'s smoke test asks;
  ``BUDGET``, ``_quality`` and ``_gate`` equal the reference's on the same
  inputs, exactly (the same numpy arithmetic).
* Every subcommand and console wrapper dispatches to the port's main.
"""

import json

import numpy as np
import pytest
import torch

from bigdl_tpu import bench_quant as jbench_quant
from bigdl_tpu.serving import bench_serve as jbench_serve
from bigdl_tpu_torch import bench_quant, cli
from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.observability.report import (build_report, load_ledger,
                                                  render_report)
from bigdl_tpu_torch.resilience import FaultInjector
from bigdl_tpu_torch.serving import bench_serve

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_injector():
    FaultInjector.clear()
    yield
    FaultInjector.clear()


# -- serve-drill ----------------------------------------------------------------

def test_serve_drill_passes_and_report_renders(tmp_path):
    run_dir = str(tmp_path / "drill")
    try:
        assert cli.serve_drill(["--run-dir", run_dir, "--device", "cpu",
                                "--forward-delay-ms", "12",
                                "--breaker-reset-ms", "150"]) == 0
    finally:
        run_ledger.set_run_dir(None)

    records, bad = load_ledger(run_dir, strict=True)
    assert bad == 0
    rep = build_report(records)
    serving = rep["serving"]
    assert serving is not None
    assert serving["requests"]["ok"] > 0
    assert serving["requests"]["forward_failed"] > 0
    assert serving["requests"]["pack_failed"] > 0
    assert serving["requests"]["expired"] > 0
    assert serving["shed"]["breaker_open"] > 0
    assert serving["shed"]["deadline_unmeetable"] > 0
    # two opens: the single-worker phase 5 and the pool phase's worker 0;
    # only the single-worker breaker recovers
    assert serving["breaker"]["closed->open"] == 2
    assert serving["breaker"]["open->half_open"] == 1
    assert serving["breaker"]["half_open->closed"] == 1
    assert serving["batches"]["count"] > 0
    assert serving["latency"]["p50_s"] > 0
    # the pool phase: both pool workers dispatched, worker 0 holds every
    # pool-phase failure, worker 1 is clean; the partial wave landed in
    # the small bucket.  (The fleet phase adds its own workers to the
    # census: its batches are the tenant-tagged ones.)
    assert {0, 1} <= set(serving["workers"])
    assert serving["workers"][0]["failed"] > 0
    assert serving["workers"][1]["failed"] == 0
    assert serving["workers"][1]["ok"] > 0
    assert len(serving["buckets"]) == 2     # small rung + full rung
    starts = [(r.get("workers"), r.get("buckets")) for r in records
              if r.get("type") == "run.start" and "workers" in r]
    assert starts == [(1, [4]), (2, [2, 4])]
    # phase 11's paged generator: the never-fit floods shed at the door
    assert serving["shed"]["over_capacity"] == 3
    assert "breaker" in render_report(rep)
    # the fault rate over the single-server and pool phases' batches (the
    # fleet phase's tenant-tagged batches are fault-free)
    fault_batches = sum(1 for r in records if r.get("type") == "serve.batch"
                        and r.get("status") in ("failed", "pack_failed")
                        and "tenant" not in r)
    dispatched = sum(1 for r in records if r.get("type") == "serve.batch"
                     and "tenant" not in r)
    assert fault_batches / dispatched >= 0.10
    # phase 12: the per-tenant census, every shed the flooding tenant's,
    # the killed worker reaped
    fleet = rep["fleet"]
    assert fleet is not None
    assert {"flood", "steady"} <= set(fleet["tenants"])
    assert fleet["tenants"]["flood"]["sheds"].get("queue_full", 0) > 0
    assert not fleet["tenants"]["steady"]["sheds"]
    assert fleet["tenants"]["steady"]["requests"].get("ok", 0) > 0
    assert fleet["reaps"] >= 1


def test_fleet_smoke_raises_naming_the_fleet(capsys):
    # the fleet is ported: --fleet-smoke runs phase 12 alone and passes;
    # only the cross-host cluster's bench still raises, naming its part
    assert cli.main(["serve-drill", "--fleet-smoke", "--device",
                     "cpu"]) == 0
    assert "fleet smoke): all checks passed" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="cross-host cluster"):
        cli.main(["bench-serve", "--cluster", "--smoke"])


# -- bench-serve ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_traffic_is_the_references(seed):
    args = (48, 96, 80, 0.75, 256, (8, 24), (32, 48), 0.25)
    want = jbench_serve._traffic(np.random.RandomState(seed), *args)
    got = bench_serve._traffic(np.random.RandomState(seed), *args)
    assert len(got) == len(want) == 48
    for (gp, gn), (wp, wn) in zip(got, want):
        assert gp.dtype == wp.dtype and gn == wn
        np.testing.assert_array_equal(gp, wp)


def test_bench_serve_smoke(tmp_path, capsys):
    out = str(tmp_path / "serve.json")
    assert cli.bench_serve(["--smoke", "--device", "cpu",
                            "--out", out]) == 0
    with open(out) as f:
        rep = json.load(f)
    assert set(rep["modes"]) == {"static", "bucketed", "continuous"}
    assert set(rep["ablations"]) == {"paged", "paged_kernel",
                                     "paged_prefix", "paged_prefix_spec"}
    for mode in list(rep["modes"].values()) + \
            list(rep["ablations"].values()):
        assert mode["tokens_per_s"] > 0
        assert mode["latency_p95_s"] > 0
        assert mode["useful_tokens"] == \
            rep["modes"]["static"]["useful_tokens"]
        assert mode["kernel_launches"] == {}    # plain versions on the CPU
    assert 0 < rep["modes"]["continuous"]["mean_slot_occupancy"] <= 1
    assert 0 < rep["modes"]["static"]["mean_padding_efficiency"] <= 1
    acc = rep["acceptance"]
    assert "best_vs_row_slot_tokens_per_s" in acc
    assert set(acc["per_feature_vs_row_slot"]) == set(rep["ablations"])
    assert 0 < acc["prefix_hit_rate"] <= 1
    assert 0 < acc["draft_accept_rate"] <= 1
    assert acc["outputs_bit_equal_across_variants"] is True
    assert acc["live_endpoint_mid_traffic"] is True
    assert rep["meta"]["smoke"] and rep["meta"]["platform"] == "cpu"


def test_bench_serve_writes_no_file_without_out(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.chdir(tmp_path)
    assert bench_serve.main(["--smoke", "--device", "cpu",
                             "--requests", "6"]) == 0
    assert list(tmp_path.iterdir()) == []
    assert '"bench": "serve_r11"' in capsys.readouterr().out


# -- bench-infer ----------------------------------------------------------------

def test_budget_quality_and_gate_are_the_references():
    assert bench_quant.BUDGET == jbench_quant.BUDGET
    rng = np.random.RandomState(4)
    f32 = rng.standard_normal((6, 9, 11)).astype(np.float32)
    bf16 = f32 + 0.01 * rng.standard_normal(f32.shape).astype(np.float32)
    int8 = f32 + 0.2 * rng.standard_normal(f32.shape).astype(np.float32)
    got = bench_quant._quality(f32, bf16, int8)
    assert got == jbench_quant._quality(f32, bf16, int8)
    rows = [{"config": "a", "quality_vs_bf16": got},
            {"config": "b", "quality_vs_bf16": bench_quant._quality(
                f32, bf16, bf16)}]
    assert bench_quant._gate(rows) == jbench_quant._gate(rows)
    assert bench_quant._gate(rows)           # "a" is over the budget
    assert not bench_quant._gate(rows[1:])


def test_bench_infer_smoke_gate_and_cost_rows(tmp_path):
    out = tmp_path / "infer.json"
    run_dir = str(tmp_path / "run")
    run_ledger.set_run_dir(run_dir)
    try:
        rc = cli.main(["bench-infer", "--smoke", "--device", "cpu",
                       "--out", str(out)])
    finally:
        run_ledger.set_run_dir(None)
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["smoke"] and data["gate"]["passed"]
    assert data["accuracy_budget"] == jbench_quant.BUDGET
    lm = data["lm"][0]
    assert lm["int8_tokens_per_sec"] > 0
    assert lm["resident_param_bytes"]["ratio_int8_vs_bf16"] < 0.8
    assert "top1_drop_vs_bf16" in lm["quality_vs_bf16"]
    assert data["image"][0]["int8_imgs_per_sec"] > 0
    records, bad = load_ledger(run_dir, strict=True)
    assert bad == 0
    rep = build_report(records)
    int8 = {k: v for k, v in rep["costs"].items() if ".int8[" in k}
    assert set(int8) == {"lm.score.int8[tlm-smoke]",
                         "image.pred.int8[lenet5-smoke]"}
    # ATen's FLOPs (the plain versions of the kernels run on the CPU);
    # the port has no bytes model, so bytes and intensity stay 0
    for co in int8.values():
        assert co["flops"] > 0
    assert "lm.score.int8[tlm-smoke]" in render_report(rep)


def test_bench_infer_exits_1_over_the_budget(monkeypatch, tmp_path,
                                             capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(bench_quant.BUDGET, "max_mean_abs_logit_delta",
                        0.0)
    assert bench_quant.main(["--smoke", "--device", "cpu"]) == 1
    assert "gate FAILED" in capsys.readouterr().out
    assert list(tmp_path.iterdir()) == []      # no --out, no file


# -- cli dispatch ---------------------------------------------------------------

@pytest.mark.parametrize("cmd,module", [
    ("serve-drill", "bigdl_tpu_torch.serving.drill"),
    ("bench-serve", "bigdl_tpu_torch.serving.bench_serve"),
    ("bench-infer", "bigdl_tpu_torch.bench_quant"),
    ("mem-drill", "bigdl_tpu_torch.serving.scheduler.mem_drill"),
    ("bench-ingest", "bigdl_tpu_torch.dataset.bench_ingest"),
])
def test_subcommands_dispatch_to_the_ports_mains(cmd, module, monkeypatch):
    import importlib
    mod = importlib.import_module(module)
    seen = []
    monkeypatch.setattr(mod, "main", lambda argv: seen.append(argv) or 0)
    assert cli.main([cmd, "--smoke", "x"]) == 0
    assert seen == [["--smoke", "x"]]


def test_mem_drill_runs_through_the_cli(tmp_path):
    assert cli.main(["mem-drill", "--smoke", "--device", "cpu",
                     "--run-dir", str(tmp_path / "run")]) == 0


def test_bench_ingest_returns_0_over_its_result(monkeypatch):
    from bigdl_tpu_torch.dataset import bench_ingest
    monkeypatch.setattr(bench_ingest, "main", lambda argv: {"curve": {}})
    assert cli.main(["bench-ingest"]) == 0


WRAPPERS = [
    ("lenet_train", "models.lenet", "train_main"),
    ("lenet_test", "models.lenet", "test_main"),
    ("inception_train", "models.inception", "train_main"),
    ("inception_test", "models.inception", "test_main"),
    ("resnet_train", "models.resnet", "train_main"),
    ("resnet_test", "models.resnet", "test_main"),
    ("vgg_train", "models.vgg", "train_main"),
    ("vgg_test", "models.vgg", "test_main"),
    ("rnn_train", "models.rnn", "train_main"),
    ("rnn_test", "models.rnn", "test_main"),
    ("autoencoder_train", "models.autoencoder", "train_main"),
    ("transformer_train", "models.transformer", "train_main"),
    ("transformer_generate", "models.transformer", "generate_main"),
    ("perf", "models.perf", "main"),
    ("imageclassification", "example.imageclassification", "main"),
    ("loadmodel", "example.loadmodel", "main"),
    ("textclassification", "example.textclassification", "main"),
    ("seqfile", "dataset.seqfile", "main"),
]


def test_wrappers_are_the_references():
    from bigdl_tpu import cli as jcli
    names = {n for n, v in vars(jcli).items()
             if getattr(v, "__doc__", "") and
             str(v.__doc__).startswith("console wrapper for")}
    assert names == {w[0] for w in WRAPPERS}


@pytest.mark.parametrize("name,module,attr", WRAPPERS)
def test_console_wrappers_call_the_ports_mains(name, module, attr,
                                               monkeypatch):
    import importlib
    mod = importlib.import_module("bigdl_tpu_torch." + module)
    seen = []
    monkeypatch.setattr(mod, attr, lambda argv: seen.append(argv) or
                        object())
    wrapper = getattr(cli, name)
    assert wrapper.__name__ == attr
    assert wrapper(["-x", "1"]) is None      # the main's return dropped
    assert seen == [["-x", "1"]]
