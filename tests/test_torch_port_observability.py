"""The port's observability (``bigdl_tpu_torch.observability``, ``optim.
Metrics``, ``utils.profiler``, ``resilience.watchdog``, ``cli``) against
the JAX package's on the CPU.

The core tests are ports of ``tests/test_observability.py`` (all but the
distributed smoke; the compile-hook test becomes the kernel-build record
test), ``tests/test_profiler.py``'s profiler and step-timer tests and
``tests/test_resilience.py``'s watchdog tests.  The parity tests feed the
same inputs to both packages and require equal outputs, exactly: one
synthetic ledger holding every record type the run report reads, over two
pids with links, gives the same report JSON, report text and trace JSON;
the reference's own LeNet ledger reports the same through the port; the
same scalars at the same wall times give byte-identical tfevents files;
the same ``Metrics`` calls give the same Prometheus text; the same hit and
miss sequence gives the same SLO burn events.
"""

import json
import os
import struct
import threading
import time

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.transformer import MiniBatch as JMiniBatch
from bigdl_tpu.observability import ledger as jledger
from bigdl_tpu.observability import live as jlive
from bigdl_tpu.observability import report as jreport
from bigdl_tpu.observability import summary as jsummary
from bigdl_tpu.observability import trace as jtrace
from bigdl_tpu.observability.prometheus import \
    metrics_to_prometheus as jmetrics_to_prometheus
from bigdl_tpu.optim import Metrics as JMetrics
from bigdl_tpu.resilience.fault_injector import \
    FaultInjector as JFaultInjector
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.transformer import MiniBatch
from bigdl_tpu_torch.observability import costs, live, summary, tracer
from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.observability import trace as run_trace
from bigdl_tpu_torch.observability import (TrainSummary, ValidationSummary,
                                           metrics_to_prometheus,
                                           set_run_dir, span)
from bigdl_tpu_torch.observability.report import (build_report,
                                                  load_ledger,
                                                  main as report_main,
                                                  render_report)
from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Metrics,
                                   Top1Accuracy, Trigger)
from bigdl_tpu_torch.optim.local_optimizer import SKIPPED_STEPS
from bigdl_tpu_torch.resilience.fault_injector import FaultInjector
from bigdl_tpu_torch.resilience.watchdog import Watchdog, WatchdogTimeout

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_ledger():
    """Every test starts and ends with both packages' ledgers off and
    both fault injectors disarmed."""
    set_run_dir(None)
    jledger.set_run_dir(None)
    yield
    set_run_dir(None)
    jledger.set_run_dir(None)
    FaultInjector.clear()
    JFaultInjector.clear()


def _read_lines(run_dir):
    """Every ledger line, parsed strictly (NaN/Infinity spellings fail)."""
    recs = []
    for name in sorted(os.listdir(run_dir)):
        if not name.endswith(".jsonl"):
            continue
        with open(os.path.join(run_dir, name)) as f:
            for line in f:
                recs.append(json.loads(
                    line, parse_constant=lambda c: pytest.fail(
                        f"non-strict JSON constant {c!r} in ledger")))
    return recs


# -- ledger core --------------------------------------------------------------

def test_ledger_disabled_is_noop(tmp_path):
    assert run_ledger.get_ledger() is None
    with span("anything", k=1) as sid:
        assert sid is None
    run_ledger.emit("event", kind="dropped.on.floor")
    assert not list(tmp_path.iterdir())


def test_ledger_env_activation(tmp_path, monkeypatch):
    run_dir = str(tmp_path / "run")
    monkeypatch.setenv("BIGDL_TPU_RUN_DIR", run_dir)
    monkeypatch.setattr(run_ledger, "_env_checked", False)
    monkeypatch.setattr(run_ledger, "_active", None)
    led = run_ledger.get_ledger()
    assert led is not None and led.dir == run_dir
    run_ledger.emit("event", kind="env.works")
    led.flush()
    assert any(r.get("kind") == "env.works" for r in _read_lines(run_dir))
    led.close()


def test_ledger_lines_are_strict_json_even_for_nan(tmp_path):
    led = set_run_dir(str(tmp_path))
    run_ledger.emit("step", loss=float("nan"))
    run_ledger.emit("event", kind="fine", obj=object())
    led.flush()
    recs = _read_lines(str(tmp_path))
    assert "ledger.unserializable" in [r["type"] for r in recs]
    assert any(r.get("kind") == "fine" for r in recs)


def test_ledger_overflow_drops_oldest_and_counts(tmp_path):
    led = run_ledger.RunLedger(str(tmp_path), capacity=4)
    for i in range(100):
        led.emit({"type": "event", "kind": "flood", "i": i})
    led.close()
    recs = _read_lines(str(tmp_path))
    survived = [r for r in recs if r["type"] != "ledger.dropped"]
    dropped = [r for r in recs if r["type"] == "ledger.dropped"]
    assert len(survived) + (dropped[0]["count"] if dropped else 0) == 101


# -- spans --------------------------------------------------------------------

def test_span_nesting_parent_links_and_error(tmp_path):
    led = set_run_dir(str(tmp_path))
    with span("outer") as outer_id:
        with span("inner", step=3) as inner_id:
            pass
    with pytest.raises(RuntimeError):
        with span("exploding"):
            raise RuntimeError("boom")
    led.flush()
    by_name = {r["name"]: r for r in _read_lines(str(tmp_path))
               if r["type"] == "span"}
    assert by_name["inner"]["parent"] == outer_id
    assert by_name["inner"]["span"] == inner_id
    assert by_name["inner"]["attrs"] == {"step": 3}
    assert "parent" not in by_name["outer"]
    assert by_name["exploding"]["error"] == "RuntimeError"
    assert by_name["exploding"]["dur_s"] >= 0


def test_begin_span_handle_nests_children(tmp_path):
    led = set_run_dir(str(tmp_path))
    h = tracer.begin_span("setup")
    with span("child"):
        pass
    h.end()
    led.flush()
    by_name = {r["name"]: r for r in _read_lines(str(tmp_path))
               if r["type"] == "span"}
    assert by_name["child"]["parent"] == by_name["setup"]["span"]
    assert by_name["setup"]["dur_s"] >= by_name["child"]["dur_s"]


def test_kernel_builds_write_compile_records(tmp_path, monkeypatch):
    """The port's counterpart of the reference's XLA compile hook: a host
    build (``g++``, as the native helpers build) that runs writes one
    ``compile`` record under the open span; a cached one writes none."""
    from bigdl_tpu_torch.ops import _build
    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int bigdl_tiny(void) { return 7; }\n')
    monkeypatch.setattr(_build, "HOST_ROOT", tmp_path / "host")
    run_dir = str(tmp_path / "run")
    led = set_run_dir(run_dir)
    with span("init") as sid:
        _build.build_host(src, "libtiny.so", [([], [])])
    _build.build_host(src, "libtiny.so", [([], [])])      # cached
    tracer.record_compile("nvcc", 1.5, sources=10)
    led.flush()
    comp = [r for r in _read_lines(run_dir) if r["type"] == "compile"]
    assert [r["event"] for r in comp] == ["g++", "nvcc"]
    assert comp[0]["span"] == sid and comp[0]["source"] == "tiny.cpp"
    assert comp[0]["dur_s"] > 0 and "span" not in comp[1]
    rep = build_report(load_ledger(run_dir)[0])
    assert rep["compile"]["count"] == 2
    set_run_dir(None)
    tracer.record_compile("nvcc", 1.0)          # ledger off: no-op


# -- trainer smoke runs -------------------------------------------------------

def _check_smoke_ledger(run_dir, metrics, n_steps, expect_skipped):
    recs = _read_lines(run_dir)
    steps = [r for r in recs if r["type"] == "step"]
    assert len(steps) == n_steps
    ids = [r["step"] for r in steps]
    assert ids == sorted(ids) and len(set(ids)) == len(ids)
    for r in steps:
        for key in ("step", "epoch", "records", "dur_s", "records_per_s",
                    "skipped", "ts", "mono"):
            assert key in r, f"step record missing {key}: {r}"
    assert any(r["type"] == "run.start" for r in recs)
    assert any(r["type"] == "run.end" for r in recs)
    rep = build_report(load_ledger(run_dir, strict=True)[0])
    assert rep["coverage"] is not None and rep["coverage"] >= 0.90, rep
    assert rep["steps"]["count"] == n_steps
    assert rep["steps"]["p50_s"] <= rep["steps"]["p95_s"] \
        <= rep["steps"]["p99_s"]
    assert rep["steps"]["records_per_s"] > 0
    assert "train.step" in rep["phases"]
    skipped_metric = int(metrics.get(SKIPPED_STEPS)) \
        if expect_skipped else 0
    assert rep["events"].get("step.skipped", 0) == skipped_metric \
        == expect_skipped
    assert rep["steps"]["skipped"] == expect_skipped
    assert report_main([run_dir, "--strict"]) == 0
    proms = [n for n in os.listdir(run_dir) if n.endswith(".prom")]
    assert proms, "metrics-*.prom not written"
    text = open(os.path.join(run_dir, proms[0])).read()
    assert "bigdl_tpu_computing_time_average_seconds" in text


def _lenet_batches(n_batches=6, bs=8, seed=0, cls=MiniBatch):
    rng = np.random.RandomState(seed)
    return [cls(rng.rand(bs, 784).astype(np.float32),
                (np.arange(bs) % 10 + 1).astype(np.float32))
            for _ in range(n_batches)]


def test_lenet_local_smoke_produces_parseable_ledger(tmp_path):
    """The reference injects a NaN gradient at step 2 (its ``grad.nan``
    site comes with the port's resilience slice); here the third batch
    carries NaN data, which the guard skips the same way."""
    from bigdl_tpu_torch.models import LeNet5
    run_dir = str(tmp_path / "run")
    set_run_dir(run_dir)
    batches = _lenet_batches()
    batches[2] = MiniBatch(np.full_like(batches[2].data, np.nan),
                           batches[2].labels)
    opt = LocalOptimizer(LeNet5(10).reset(1), tnn.ClassNLLCriterion(),
                         DataSet.array(batches), Trigger.max_iteration(6),
                         device="cpu")
    opt.set_optim_method(SGD(learning_rate=0.01))
    opt.set_validation(Trigger.every_epoch(),
                       DataSet.array(_lenet_batches()), [Top1Accuracy()])
    ts = TrainSummary(str(tmp_path / "tb"), "lenet")
    vs = ValidationSummary(str(tmp_path / "tb"), "lenet")
    opt.set_train_summary(ts).set_val_summary(vs)
    opt.optimize()
    run_ledger.flush()
    _check_smoke_ledger(run_dir, opt.metrics, n_steps=6, expect_skipped=1)
    assert len(ts.read_scalar("Throughput")) == 6
    assert len(ts.read_scalar("Loss")) == 5      # NaN loss not teed
    assert len(vs.read_scalar("Top1Accuracy")) == 1
    scalar_tags = {r["tag"] for r in _read_lines(run_dir)
                   if r["type"] == "scalar"}
    assert {"Loss", "Throughput", "LearningRate",
            "Top1Accuracy"} <= scalar_tags
    costs_recs = [r for r in _read_lines(run_dir)
                  if r["type"] == "cost.analysis"]
    assert len(costs_recs) == 1 and costs_recs[0]["flops"] > 0
    assert costs_recs[0]["label"] == "train.step"


def test_run_report_cli_errors(tmp_path):
    assert report_main([str(tmp_path)]) == 2
    p = tmp_path / "events-1.jsonl"
    p.write_text('{"type":"event","kind":"ok","ts":1.0,"mono":1.0}\n'
                 'NOT JSON\n')
    assert report_main([str(tmp_path)]) == 0
    with pytest.raises(ValueError):
        load_ledger(str(tmp_path), strict=True)


def test_cli_main_dispatch(tmp_path):
    from bigdl_tpu_torch import cli
    (tmp_path / "events-1.jsonl").write_text(
        '{"type":"step","step":0,"dur_s":0.1,"records":8,'
        '"ts":1.0,"mono":1.0}\n')
    assert cli.main(["run-report", str(tmp_path)]) == 0
    assert cli.main(["trace-export", str(tmp_path)]) == 0
    assert cli.main(["no-such-command"]) == 2
    # the reference's other subcommands name the part they wait for
    for cmd, item in (("fleet-report", "item 13, part 3b"),
                      ("fleet-drill", "item 13, part 3b"),
                      ("rollout-drill", "item 13, part 3c"),
                      ("train-drill", "item 12"),
                      ("tune", "item 13"), ("mesh-explain", "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            cli.main([cmd])
    with pytest.raises(NotImplementedError, match="part 3b"):
        run_trace.main([str(tmp_path), "--fleet"])


def test_ledger_readers_import_no_torch():
    """``run-report`` and ``trace-export`` are pure file reading: the cli
    and the report and trace modules pull in neither torch nor numpy."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import bigdl_tpu_torch.cli, bigdl_tpu_torch.observability.report"
            ", bigdl_tpu_torch.observability.trace\n"
            "print(sorted(m for m in ('torch', 'numpy', 'jax') "
            "if m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _linear_model():
    return tnn.Sequential().add(tnn.Linear(4, 2)).add(tnn.LogSoftMax())


def test_summary_trigger_aligns_with_checkpoint_triggers(tmp_path):
    """``several_iteration(2)`` on a summary tag fires on the steps it
    would fire a checkpoint: after completed steps 2, 4, 6, the scalars
    of executed steps 1, 3, 5."""
    set_run_dir(str(tmp_path / "run"))
    rng = np.random.RandomState(0)
    batches = [MiniBatch(rng.rand(4, 4).astype(np.float32),
                         (np.arange(4) % 2 + 1).astype(np.float32))
               for _ in range(6)]
    opt = LocalOptimizer(_linear_model(), tnn.ClassNLLCriterion(),
                         DataSet.array(batches), Trigger.max_iteration(6),
                         device="cpu")
    ts = TrainSummary(str(tmp_path / "tb"), "t")
    ts.set_summary_trigger("Loss", Trigger.several_iteration(2))
    ts.set_summary_trigger("LearningRate", Trigger.every_epoch())
    opt.set_train_summary(ts)
    opt.optimize()
    assert [s for s, _, _ in ts.read_scalar("Loss")] == [1, 3, 5]
    assert len(ts.read_scalar("Throughput")) == 6
    assert [s for s, _, _ in ts.read_scalar("LearningRate")] == [5]


def test_step_record_inf_loss_is_strict_json(tmp_path):
    led = set_run_dir(str(tmp_path))
    opt = LocalOptimizer(object(), object(), object(), device="cpu")
    opt._emit_step_record(0, float("inf"), 8, 0.1, clr=0.05)
    opt._emit_step_record(1, float("nan"), 8, 0.1, clr=0.05)
    led.flush()
    recs = _read_lines(str(tmp_path))
    steps = [r for r in recs if r["type"] == "step"]
    assert [r["loss"] for r in steps] == [None, None]
    assert not any(r["type"] == "ledger.unserializable" for r in recs)


def _write(path, recs):
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))


def test_report_coverage_ignores_crashed_runs(tmp_path):
    crashed = [
        {"type": "run.start", "thread": 1, "ts": 1.0, "mono": 0.0},
        {"type": "span", "name": "train.step", "span": 1, "thread": 1,
         "ts": 1.0, "mono": 0.1, "dur_s": 50.0},
    ]
    completed = [
        {"type": "run.start", "thread": 2, "ts": 9.0, "mono": 100.0},
        {"type": "span", "name": "train.step", "span": 1, "thread": 2,
         "ts": 9.1, "mono": 100.1, "dur_s": 9.5},
        {"type": "run.end", "thread": 2, "ts": 19.0, "mono": 110.0},
    ]
    _write(tmp_path / "events-1.jsonl", crashed)
    _write(tmp_path / "events-2.jsonl", completed)
    rep = build_report(load_ledger(str(tmp_path))[0])
    assert rep["runs"] == 2 and rep["completed_runs"] == 1
    assert rep["wall_s"] == pytest.approx(10.0)
    assert rep["coverage"] == pytest.approx(0.95)
    assert "1 did not complete" in render_report(rep)


def test_report_crashed_run_same_pid_does_not_steal_next_end(tmp_path):
    recs = [
        {"type": "run.start", "thread": 1, "ts": 1.0, "mono": 0.0},
        {"type": "span", "name": "train.step", "span": 1, "thread": 1,
         "ts": 1.0, "mono": 0.1, "dur_s": 2.0},
        {"type": "run.start", "thread": 1, "ts": 9.0, "mono": 100.0},
        {"type": "span", "name": "train.step", "span": 2, "thread": 1,
         "ts": 9.1, "mono": 100.1, "dur_s": 9.5},
        {"type": "run.end", "thread": 1, "ts": 19.0, "mono": 110.0},
    ]
    _write(tmp_path / "events-7.jsonl", recs)
    rep = build_report(load_ledger(str(tmp_path))[0])
    assert rep["runs"] == 2 and rep["completed_runs"] == 1
    assert rep["wall_s"] == pytest.approx(10.0)
    assert rep["coverage"] == pytest.approx(0.95)


def test_emit_critical_survives_closed_ledger(tmp_path):
    led = set_run_dir(str(tmp_path))
    run_ledger.emit_critical("event", kind="watchdog.timeout", label="x")
    led.close()
    run_ledger.emit_critical("event", kind="after.close")
    assert any(r.get("kind") == "watchdog.timeout"
               for r in _read_lines(str(tmp_path)))


# -- exporters ----------------------------------------------------------------

def test_train_summary_triggers_and_tfevents(tmp_path):
    s = TrainSummary(str(tmp_path), "app")
    s.set_summary_trigger("Loss", Trigger.several_iteration(2))
    for i in range(4):
        s.add_scalar("Loss", float(i), i)
    assert [v for _, v, _ in s.read_scalar("Loss")] == [0.0, 1.0, 2.0, 3.0]
    assert s.trigger_for("Loss") is not None
    s.close()
    files = os.listdir(os.path.join(str(tmp_path), "app", "train"))
    assert len(files) == 1 and files[0].startswith("events.out.tfevents.")
    data = open(os.path.join(str(tmp_path), "app", "train",
                             files[0]), "rb").read()
    off, n = 0, 0
    while off < len(data):
        (ln,) = struct.unpack("<Q", data[off:off + 8])
        assert struct.unpack("<I", data[off + 8:off + 12])[0] == \
            summary._masked_crc(data[off:off + 8])
        payload = data[off + 12:off + 12 + ln]
        assert struct.unpack(
            "<I", data[off + 12 + ln:off + 16 + ln])[0] == \
            summary._masked_crc(payload)
        off += 16 + ln
        n += 1
    assert n == 5


def test_prometheus_rendering_units():
    m = Metrics()
    m.set("computing time average", 2e9)
    m.incr("skipped steps (non-finite)", 3)
    m.set("get weights wire traffic per node", 1.5, unit="MB/iteration")
    m.set("computing time for each node", [1e9, 2e9])
    text = metrics_to_prometheus(m)
    assert "bigdl_tpu_computing_time_average_seconds 2.0" in text
    assert "bigdl_tpu_skipped_steps_non_finite_total 3.0" in text
    assert "mb_iteration 1.5" in text
    assert 'bigdl_tpu_computing_time_for_each_node_seconds{node="0"} 1.0' \
        in text
    for line in text.splitlines():
        assert line.startswith(("#", "bigdl_tpu_"))


def test_steptimer_phase_attributes_failed_steps():
    from bigdl_tpu_torch.utils.profiler import StepTimer
    m = Metrics()
    t = StepTimer(m)
    with pytest.raises(RuntimeError):
        with t.phase("computing time for each node"):
            raise RuntimeError("step died")
    assert m.get("computing time for each node") >= 0


def test_metrics_add_distributed_is_elementwise():
    m = Metrics()
    m.set("per node", [1.0, 2.0], unit="count")
    m.add("per node", [10.0, 20.0])
    assert m.get("per node") == [11.0, 22.0]
    with pytest.raises(ValueError):
        m.add("per node", [1.0, 2.0, 3.0])
    with pytest.raises(TypeError):
        m.add("per node", 5.0)
    m.set("scalar", 1.0)
    with pytest.raises(TypeError):
        m.add("scalar", [1.0, 2.0])
    m.add("fresh dist", [1.0, 2.0])
    assert m.get("fresh dist") == [1.0, 2.0]


def test_metrics_gathered_single_process():
    m = Metrics()
    m.set("a", 10.0, parallel=2)
    m.set("b", [1.0, 2.0, 3.0])
    scalars, arrays = m.gathered()
    assert scalars["a"] == (5.0, [5.0])
    assert arrays["b"] == [1.0, 2.0, 3.0]
    assert "per node" in m.summary(across_processes=True)


def test_metrics_snapshot_is_a_copy():
    m = Metrics()
    m.set("x", 1.0)
    local, dist, units = m.snapshot()
    local["x"][0] = 999.0
    assert m.get("x") == 1.0


# -- ledger edge paths --------------------------------------------------------

def test_emit_critical_flushes_under_concurrent_writers(tmp_path):
    set_run_dir(str(tmp_path))
    start = threading.Barrier(5)

    def flood(tid):
        start.wait()
        for i in range(2000):
            run_ledger.emit("event", kind="noise", t=tid, i=i)

    writers = [threading.Thread(target=flood, args=(t,))
               for t in range(4)]
    for t in writers:
        t.start()
    start.wait()
    for k in range(8):
        run_ledger.emit_critical("event", kind="critical", k=k)
        on_disk = [r for r in _read_lines(str(tmp_path))
                   if r.get("kind") == "critical"]
        assert any(r["k"] == k for r in on_disk), k
    for t in writers:
        t.join(timeout=60)
        assert not t.is_alive()
    set_run_dir(None)
    recs = _read_lines(str(tmp_path))
    assert sum(1 for r in recs if r.get("kind") == "critical") == 8


def test_relaunched_pid_file_collision_appends_history(tmp_path):
    from bigdl_tpu_torch.observability.report import ledger_files
    led1 = run_ledger.RunLedger(str(tmp_path))
    led1.emit({"type": "event", "kind": "first.life"})
    led1.close()
    led2 = run_ledger.RunLedger(str(tmp_path))
    led2.emit({"type": "event", "kind": "second.life"})
    led2.close()
    assert len(ledger_files(str(tmp_path))) == 1
    recs = _read_lines(str(tmp_path))
    kinds = [r.get("kind") for r in recs]
    assert kinds.index("first.life") < kinds.index("second.life")
    assert sum(1 for r in recs if r["type"] == "trace.bind") == 2


def test_ledger_overflow_accounting_with_final_flood(tmp_path):
    led = run_ledger.RunLedger(str(tmp_path), capacity=8)
    for i in range(500):
        led.emit({"type": "event", "kind": "f2", "i": i})
    led.close()
    recs = _read_lines(str(tmp_path))
    got = sorted(r["i"] for r in recs if r.get("kind") == "f2")
    binds = sum(1 for r in recs if r["type"] == "trace.bind")
    dropped = sum(r["count"] for r in recs
                  if r["type"] == "ledger.dropped")
    assert len(got) + binds + dropped == 501
    assert got[-1] == 499


# -- trace context and export -------------------------------------------------

def test_span_link_fields_via_attach(tmp_path):
    set_run_dir(str(tmp_path))
    with span("submitter") as sid:
        wire = run_trace.current_wire()
    assert wire is not None and wire[1] == os.getpid() and wire[2] == sid

    def worker():
        with run_trace.attach(wire):
            with span("work.outer"):
                with span("work.inner"):
                    pass

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    run_ledger.flush()
    recs = _read_lines(str(tmp_path))
    outer = next(r for r in recs if r.get("name") == "work.outer")
    inner = next(r for r in recs if r.get("name") == "work.inner")
    assert outer["link"] == sid and outer["link_pid"] == os.getpid()
    assert "link" not in inner and inner["parent"] == outer["span"]


def test_attach_none_is_noop_and_free():
    assert run_trace.current_wire() is None
    with run_trace.attach(None):
        with span("x") as sid:
            assert sid is None


def test_trace_export_cli_on_synthetic_ledger(tmp_path):
    from bigdl_tpu_torch.cli import trace_export
    set_run_dir(str(tmp_path))
    with span("parent"):
        run_ledger.emit("event", kind="mark")
    run_ledger.flush()
    set_run_dir(None)
    out = tmp_path / "t.json"
    assert trace_export([str(tmp_path), "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    names = {e["name"] for e in payload["traceEvents"]}
    assert "parent" in names and "mark" in names
    assert payload["otherData"]["trace_id"]
    assert trace_export([str(tmp_path / "void")]) == 2


class _ObsAugment:
    """A module-level (spawn-picklable) pass-through augment chain: it
    makes the ingest workers write ingest.augment spans."""

    def __call__(self, it):
        for s in it:
            yield s

    def clone_transformer(self):
        return self

    def reseed(self, seed):
        pass


def test_trace_export_stitches_two_worker_training_run(tmp_path):
    """A 2-ingest-worker training run's per-pid ledgers export as one
    Chrome trace whose span rows cover the trainer's pid and every worker
    pid that the pool's own census shows served a chunk (one spawn worker
    may take every chunk), with every cross-process link intact."""
    from bigdl_tpu_torch.cli import trace_export
    from bigdl_tpu_torch.dataset import ShardedDataSet
    from bigdl_tpu_torch.dataset.transformer import Sample, SampleToBatch
    from bigdl_tpu_torch.models import LeNet5

    rng = np.random.RandomState(0)
    samples = [Sample(rng.rand(784).astype(np.float32),
                      np.float32(i % 10 + 1)) for i in range(48)]
    run_dir = str(tmp_path / "run")
    set_run_dir(run_dir)
    try:
        ds = ShardedDataSet(samples, augment=_ObsAugment(),
                            batcher=SampleToBatch(8), workers=2, chunk=6,
                            device="cpu")
        opt = LocalOptimizer(LeNet5(10).reset(1), tnn.ClassNLLCriterion(),
                             ds, Trigger.max_iteration(10), device="cpu")
        opt.set_optim_method(SGD(learning_rate=0.01))
        opt.optimize()
        run_ledger.flush()
    finally:
        set_run_dir(None)
    served = {p for p, n in ds.stats["chunks_by_pid"].items() if n > 0}
    assert served and os.getpid() not in served

    records, bad = load_ledger(run_dir)
    assert bad == 0
    st = run_trace.stitch_stats(records)
    assert st["pids"] >= 1 + len(served), st
    assert st["link_edges"] >= 1 and st["cross_pid_edges"] >= 1
    assert st["resolved_edges"] == st["link_edges"]

    out = tmp_path / "trace.json"
    assert trace_export([run_dir, "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    events = payload["traceEvents"]
    span_pids = {e["pid"] for e in events if e.get("ph") == "X"}
    assert {os.getpid()} | served <= span_pids
    starts = {e["id"]: e for e in events if e.get("ph") == "s"}
    finishes = {e["id"]: e for e in events if e.get("ph") == "f"}
    assert starts and set(starts) == set(finishes)
    assert any(starts[i]["pid"] != finishes[i]["pid"] for i in starts)
    worker_names = {e["name"] for e in events if e.get("ph") == "X"
                    and e["pid"] != os.getpid()}
    assert "ingest.augment" in worker_names
    assert len(payload["otherData"]["trace_ids"]) == 1
    roles = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert any("ingest-worker" in v for v in roles.values())
    assert any("LocalOptimizer" in v for v in roles.values())


# -- cost and memory attribution ----------------------------------------------

def test_emit_cost_records_and_dedupes(tmp_path):
    set_run_dir(str(tmp_path))
    x = torch.ones(16, 16)

    def f(a):
        return (a @ a.T).sum()

    probe = costs.cost_probe("unit.exe", x)
    with probe:
        y = f(x)
    assert float(y) == 16 * 16 * 16
    r1 = costs.emit_cost(probe)
    assert r1 is not None and r1["flops"] == 2 * 16 * 16 * 16
    assert r1["bytes_accessed"] == 0.0
    assert costs.cost_probe("unit.exe", x) is None          # deduped
    assert costs.emit_cost(None) is None
    probe = costs.cost_probe("unit.exe", torch.ones(8, 8))  # new shape
    with probe:
        f(torch.ones(8, 8))
    assert costs.emit_cost(probe, kind="unit")["flops"] == 2 * 8 * 8 * 8
    run_ledger.flush()
    recs = [r for r in _read_lines(str(tmp_path))
            if r["type"] == "cost.analysis"]
    assert len(recs) == 2 and recs[1]["kind"] == "unit"


def test_costs_disabled_paths(tmp_path, monkeypatch):
    assert not costs.costs_enabled()
    assert costs.cost_probe("x", torch.ones(2)) is None
    set_run_dir(str(tmp_path))
    monkeypatch.setenv("BIGDL_TPU_COSTS", "0")
    assert not costs.costs_enabled()
    monkeypatch.delenv("BIGDL_TPU_COSTS")
    assert costs.costs_enabled()


def test_hbm_sampling_noop_on_cpu_and_report_section(tmp_path):
    set_run_dir(str(tmp_path))
    costs.sample_hbm("cpu", step=0, force=True)
    assert costs.hbm_stats("cpu") is None
    run_ledger.flush()
    assert not any(r["type"] == "mem.hbm"
                   for r in _read_lines(str(tmp_path)))
    run_ledger.emit("mem.hbm", step=16, peak_bytes=3 * 10**9,
                    bytes_in_use=2 * 10**9, devices=[])
    run_ledger.emit("mem.hbm", step=32, peak_bytes=4 * 10**9,
                    bytes_in_use=2 * 10**9, devices=[])
    run_ledger.flush()
    rep = build_report(load_ledger(str(tmp_path))[0])
    assert rep["hbm"]["samples"] == 2
    assert rep["hbm"]["peak_bytes"] == 4 * 10**9
    assert "hbm high watermark" in render_report(rep)


def test_run_report_json_carries_all_sections(tmp_path, capsys):
    set_run_dir(str(tmp_path))
    with span("phase.a"):
        pass
    run_ledger.emit("step", step=0, loss=1.0, records=8, dur_s=0.01)
    run_ledger.emit("cost.analysis", label="x", flops=10.0,
                    bytes_accessed=5.0, output_bytes=1.0,
                    intensity_flops_per_byte=2.0)
    run_ledger.flush()
    set_run_dir(None)
    assert report_main([str(tmp_path), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    for key in ("phases", "steps", "events", "compile", "io", "scalars",
                "serving", "fleet", "fleet_hosts", "rollout",
                "fleet_trace", "fleet_telemetry", "param_bytes",
                "ingest", "lint", "mesh", "elastic", "tuning", "costs",
                "hbm", "slo", "trace_ids", "link_edges", "coverage",
                "wall_s", "record_count", "malformed_lines"):
        assert key in rep, key
    assert rep["costs"]["x"]["flops"] == 10.0
    assert rep["phases"]["phase.a"]["count"] == 1


def test_metrics_histogram_prometheus_exposition():
    from bigdl_tpu_torch.optim.metrics import LATENCY_BUCKETS_S
    m = Metrics()
    for v in (0.0005, 0.004, 0.004, 0.3, 99.0):
        m.observe("serve.latency", v, LATENCY_BUCKETS_S)
    text = metrics_to_prometheus(m)
    assert "# TYPE bigdl_tpu_serve_latency_seconds histogram" in text
    assert 'bigdl_tpu_serve_latency_seconds_bucket{le="0.001"} 1' in text
    assert 'bigdl_tpu_serve_latency_seconds_bucket{le="0.005"} 3' in text
    assert 'bigdl_tpu_serve_latency_seconds_bucket{le="0.5"} 4' in text
    assert 'bigdl_tpu_serve_latency_seconds_bucket{le="+Inf"} 5' in text
    assert "bigdl_tpu_serve_latency_seconds_count 5" in text
    assert "bigdl_tpu_serve_latency_seconds_sum" in text


def test_metrics_histogram_fixed_ladder_contract():
    m = Metrics()
    m.observe("lat", 0.1, buckets=(0.1, 1.0))
    with pytest.raises(ValueError):
        m.observe("lat", 0.1, buckets=(0.2, 1.0))
    with pytest.raises(ValueError):
        m.observe("other", 0.1, buckets=(1.0, 0.1))
    w1, w2 = Metrics(), Metrics()
    for v in (0.05, 0.2):
        w1.observe("lat", v, buckets=(0.1, 1.0))
    for v in (0.07, 5.0):
        w2.observe("lat", v, buckets=(0.1, 1.0))
    h1 = w1.hist_snapshot()["lat"]
    h2 = w2.hist_snapshot()["lat"]
    assert h1["buckets"] == h2["buckets"]
    assert [a + b for a, b in zip(h1["counts"], h2["counts"])] == [2, 1, 1]
    assert h1["count"] + h2["count"] == 4


# -- live telemetry -----------------------------------------------------------

def test_live_metrics_server_scrape_and_snapshots(tmp_path):
    m = Metrics()
    m.incr("serve.completed", 5)
    srv = live.LiveMetricsServer(lambda: metrics_to_prometheus(m), port=0)
    try:
        assert srv.port > 0 and srv.url.endswith("/metrics")
        text = live.scrape(srv.url)
        assert "bigdl_tpu_serve_completed_total 5.0" in text
        m.incr("serve.completed")
        assert "bigdl_tpu_serve_completed_total 6.0" in live.scrape(srv.url)
        assert live.scrape(srv.url.replace("/metrics", "/nope")) is None
    finally:
        srv.close()
    assert live.scrape(None) is None
    path = str(tmp_path / "m.prom")
    snap = live.MetricsSnapshotter(lambda: metrics_to_prometheus(m), path,
                                   interval_s=60.0)
    snap.close()                     # the final snapshot
    assert "bigdl_tpu_serve_completed_total 6.0" in open(path).read()


# -- profiler -----------------------------------------------------------------

def test_trace_writes_profile_artifacts(tmp_path):
    from bigdl_tpu_torch.utils.profiler import annotate, trace
    logdir = str(tmp_path / "prof")
    with trace(logdir, device="cpu"):
        with annotate("toy-matmul"):
            x = torch.ones(64, 64)
            (x @ x).sum().item()
    found = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert found, "no profiler trace written"
    events = json.load(open(os.path.join(logdir, found[0])))
    assert any(e.get("name") == "toy-matmul"
               for e in events["traceEvents"])


def test_step_timer_accumulates_reference_metric_names():
    from bigdl_tpu_torch.utils.profiler import StepTimer
    m = Metrics()
    t = StepTimer(m)
    for _ in range(3):
        with t.phase("computing time for each node"):
            pass
    assert m.get("computing time for each node") >= 0
    v = t.block_and_time("get weights average", torch.ones(4))
    np.testing.assert_array_equal(np.asarray(v), np.ones((4,)))
    assert t.block_and_time("get weights average", torch.ones(1)) == 1.0
    assert m.get("get weights average") >= 0
    assert "computing time for each node" in m.summary()


# -- watchdog -----------------------------------------------------------------

def test_watchdog_fires_on_hung_step(tmp_path):
    led = set_run_dir(str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(WatchdogTimeout, match="watchdog"):
        with Watchdog(0.2, label="hung step"):
            time.sleep(3)
    assert time.monotonic() - t0 < 10
    led.flush()
    fired = [r for r in _read_lines(str(tmp_path))
             if r.get("kind") == "watchdog.timeout"]
    assert fired and fired[0]["label"] == "hung step"


def test_watchdog_disarmed_and_fast_path():
    with Watchdog(None):
        pass
    with Watchdog(30.0, label="quick"):
        x = 1 + 1
    assert x == 2


def test_watchdog_on_timeout_callback():
    fired = []
    with Watchdog(0.05, on_timeout=lambda: fired.append(1)):
        time.sleep(0.3)
    assert fired == [1]


# -- parity with the reference --------------------------------------------------

def _synthetic_records(seed=0):
    """A two-process ledger with every record type the run report reads,
    linked across the pids, from a numpy seed."""
    rs = np.random.RandomState(seed)
    a, b = 101, 202
    t = [1000.0]

    def ts(step=0.01):
        t[0] += float(rs.uniform(0.5, 1.5)) * step
        return round(t[0], 6)

    A = [{"type": "trace.bind", "trace": "feedc0de00000001", "pid": a},
         {"type": "run.start", "kind": "LocalOptimizer", "pid": a,
          "thread": 1, "trace": "feedc0de00000001", "platform": "gpu"}]
    B = [{"type": "trace.bind", "trace": "feedc0de00000001", "pid": b}]
    sid = 1
    for step in range(8):
        parent = sid
        A.append({"type": "span", "name": "data.next", "span": sid,
                  "thread": 1, "dur_s": float(rs.uniform(0.001, 0.01))})
        sid += 1
        for name in ("ingest.decode", "ingest.augment"):
            B.append({"type": "span", "name": name, "span": 1000 + sid,
                      "thread": 7, "link": parent, "link_pid": a,
                      "attrs": {"chunk": step, "records": 8},
                      "dur_s": float(rs.uniform(0.01, 0.05))})
            sid += 1
        for name in ("ingest.pack", "ingest.stage", "ingest.h2d"):
            A.append({"type": "span", "name": name, "span": sid,
                      "thread": 2, "attrs": {"records": 8},
                      "dur_s": float(rs.uniform(0.001, 0.02))})
            sid += 1
        A.append({"type": "span", "name": "h2d", "span": sid, "thread": 1,
                  "attrs": {"staged": True}, "dur_s": 0.0005})
        sid += 1
        outer = sid
        A.append({"type": "span", "name": "train.step", "span": sid,
                  "thread": 1, "attrs": {"step": step},
                  "dur_s": float(rs.uniform(0.05, 0.09))})
        sid += 1
        A.append({"type": "span", "name": "inner.work", "span": sid,
                  "parent": outer, "thread": 1,
                  "dur_s": float(rs.uniform(0.001, 0.04))})
        sid += 1
        loss = float(rs.uniform(0.5, 2.5)) if step != 3 else None
        A.append({"type": "step", "step": step, "epoch": 1 + step // 4,
                  "loss": loss, "records": 8,
                  "dur_s": float(rs.uniform(0.05, 0.1)),
                  "records_per_s": float(rs.uniform(80, 160)),
                  "skipped": step == 3})
        if step % 4 == 0:
            A.append({"type": "mem.hbm", "step": step,
                      "peak_bytes": int(rs.randint(10**8, 10**9)),
                      "bytes_in_use": int(rs.randint(10**7, 10**8)),
                      "devices": []})
        for tag in ("Loss", "Throughput"):
            A.append({"type": "scalar", "src": "train", "tag": tag,
                      "value": float(rs.uniform(0, 100)), "step": step})
    A += [
        {"type": "event", "kind": "step.skipped", "step": 3, "total": 1},
        {"type": "event", "kind": "fault.injected", "site": "io.read"},
        {"type": "event", "kind": "retry", "label": "seqfile.read",
         "attempt": 1, "exc": "OSError"},
        {"type": "event", "kind": "watchdog.timeout", "label": "step 9",
         "timeout_s": 2.0},
        {"type": "compile", "event": "nvcc", "dur_s": 41.5, "span": 1},
        {"type": "compile", "event": "g++", "dur_s": 3.25},
        {"type": "io", "name": "seqfile.read", "dur_s": 0.125,
         "file": "part-0.seq", "records": 64},
        {"type": "cost.analysis", "label": "train.step", "flops": 3.2e12,
         "bytes_accessed": 0.0, "output_bytes": 0.0,
         "intensity_flops_per_byte": 0.0, "kind": "LocalOptimizer"},
        {"type": "mem.params", "kind": "DLClassifier",
         "bytes_by_dtype": {"int8": 6000000, "float32": 250000},
         "total_bytes": 6250000, "mode": "w8"},
        {"type": "scalar", "src": "validation", "tag": "Top1Accuracy",
         "value": 0.5, "step": 8},
        {"type": "run.end", "kind": "LocalOptimizer", "pid": a,
         "wall_s": 1.25, "steps": 8, "epoch": 3, "skipped": 1},
    ]
    # serving: the server in process b, its spans linked to a's submitter
    B.append({"type": "run.start", "kind": "InferenceServer", "pid": b,
              "thread": 3, "batch": 8, "buckets": [4, 8], "workers": 2})
    for seq in range(6):
        size = int(rs.randint(1, 9))
        bucket = 4 if size <= 4 else 8
        B.append({"type": "span", "name": "serve.dispatch",
                  "span": 5000 + seq, "thread": 3, "attrs": {"seq": seq},
                  "dur_s": float(rs.uniform(0.001, 0.01))})
        B.append({"type": "span", "name": "serve.forward",
                  "span": 6000 + seq, "thread": 4 + seq % 2,
                  "link": 5000 + seq, "link_pid": b,
                  "attrs": {"seq": seq, "bucket": bucket},
                  "dur_s": float(rs.uniform(0.002, 0.02))})
        B.append({"type": "serve.batch", "seq": seq, "size": size,
                  "capacity": 8, "occupancy": size / 8,
                  "worker": seq % 2, "status": "ok", "bucket": bucket,
                  "padding_efficiency": size / bucket,
                  "dur_s": float(rs.uniform(0.002, 0.02))})
        for r in range(size):
            B.append({"type": "serve.request", "rid": seq * 10 + r,
                      "status": "ok" if r else "expired",
                      "dur_s": float(rs.uniform(0.001, 0.05))})
    B += [
        {"type": "event", "kind": "serve.shed", "reason": "queue_full"},
        {"type": "event", "kind": "serve.breaker", "from": "closed",
         "to": "open", "failures": 3, "worker": 1},
        {"type": "slo.burn", "burn": 2.5, "hit_rate": 0.975, "target": 0.99,
         "window": 40, "misses": 1, "p99_s": 0.045, "reason": "burn_rate",
         "seq": 1},
        {"type": "trace.capture", "path": "capture-202-1.json",
         "reason": "burn_rate", "burn": 2.5, "window_s": 30.0},
        {"type": "serve.slots", "chunk": 1, "active": 2, "slots": 4,
         "occupancy": 0.5, "tokens": 8, "tenant": "t0"},
        {"type": "serve.pages", "chunk": 1, "tokens_held": 40,
         "capacity_tokens": 64, "token_occupancy": 0.625,
         "pages_used": 5, "pages_total": 8, "prefix_pages": 2},
        {"type": "serve.cache", "event": "admit", "rid": 1,
         "lookup_pages": 3, "hit_pages": 2, "shared_tokens": 16,
         "inserted": 1},
        {"type": "serve.cache", "event": "evict", "pages": 2},
        {"type": "serve.spec", "chunk": 2, "proposed": 12, "accepted": 9,
         "emitted": 13},
        {"type": "mem.budget", "action": "budget", "tenant": "t0",
         "budget": 4096},
        {"type": "mem.budget", "action": "charge", "tenant": "t0",
         "cls": "kv_pages", "bytes": 2048, "charged": 2048,
         "device_bytes": 2048},
        {"type": "mem.budget", "action": "transfer", "tenant": "t0",
         "src": "kv_pages", "dst": "host_offload", "bytes": 1024,
         "device_bytes": 1024, "sid": "s1"},
        {"type": "mem.budget", "action": "discharge", "tenant": "t0",
         "cls": "kv_pages", "bytes": 512, "charged": 512,
         "device_bytes": 512},
        {"type": "mem.budget", "action": "shed", "tenant": "t0",
         "what": "rid:9", "bytes": 9000, "device_bytes": 512,
         "budget": 4096},
        {"type": "mem.budget", "action": "reclaim", "tenant": "t0",
         "reclaimer": "rungs", "bytes": 256},
        {"type": "mem.offload", "action": "park", "sid": "s1", "pages": 2,
         "bytes": 1024, "reason": "pressure", "kv_pos": 9},
        {"type": "mem.offload", "action": "resume", "sid": "s1",
         "pages": 2, "bytes": 1024, "kv_pos": 9},
        {"type": "mem.offload", "action": "close", "sid": "s1",
         "kv_pos": 9},
        {"type": "run.end", "kind": "InferenceServer", "pid": b,
         "wall_s": 0.75, "batches": 6, "workers": 2,
         "slo": {"hit_rate": 0.975}},
    ]
    for recs in (A, B):
        for r in recs:
            r.setdefault("ts", ts())
            r.setdefault("mono", t[0] - 900.0)
    return A, B


def _write_synthetic(run_dir):
    os.makedirs(run_dir, exist_ok=True)
    A, B = _synthetic_records()
    _write(__import__("pathlib").Path(run_dir) / "events-101.jsonl", A)
    _write(__import__("pathlib").Path(run_dir) / "events-202.jsonl", B)


def _dump(obj):
    return json.dumps(obj, sort_keys=True, default=str)


def test_synthetic_ledger_report_and_trace_match_reference(tmp_path):
    run_dir = str(tmp_path / "run")
    _write_synthetic(run_dir)
    recs, bad = load_ledger(run_dir, strict=True)
    jrecs, jbad = jreport.load_ledger(run_dir, strict=True)
    assert bad == jbad == 0 and _dump(recs) == _dump(jrecs)
    rep, jrep = build_report(recs), jreport.build_report(jrecs)
    # every section the reference fills is filled here too
    for key in ("steps", "hbm", "param_bytes", "memory", "slo",
                "ingest", "costs", "serving"):
        assert rep[key], key
    assert rep["ingest"]["bound_stage"] in rep["ingest"]["stages"]
    assert _dump(rep) == _dump(jrep)
    assert render_report(rep) == jreport.render_report(jrep)
    tr, jtr = run_trace.build_trace(recs), jtrace.build_trace(jrecs)
    assert tr["otherData"]["stitch"]["cross_pid_edges"] > 0
    assert _dump(tr) == _dump(jtr)
    assert _dump(run_trace.build_trace(recs, since_s=0.05)) == \
        _dump(jtrace.build_trace(jrecs, since_s=0.05))


def test_reference_lenet_ledger_reports_the_same_through_the_port(
        tmp_path):
    """The ledger of the reference's own LeNet local smoke run (an
    injected NaN step, summaries, validation), reported by the port, gives
    the reference's report."""
    from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
    from bigdl_tpu.observability import TrainSummary as JTrainSummary
    from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.optim import Top1Accuracy as JTop1Accuracy
    from bigdl_tpu.optim import Trigger as JTrigger

    run_dir = str(tmp_path / "run")
    jledger.set_run_dir(run_dir)
    try:
        JFaultInjector.install(JFaultInjector().add("grad.nan", step=2))
        batches = _lenet_batches(cls=JMiniBatch)
        opt = JLocalOptimizer(JLeNet5(10).build(seed=1),
                              jnn.ClassNLLCriterion(),
                              JDataSet.array(batches),
                              JTrigger.max_iteration(6))
        opt.set_optim_method(JSGD(learning_rate=0.01))
        opt.set_validation(JTrigger.every_epoch(), JDataSet.array(batches),
                           [JTop1Accuracy()])
        opt.set_train_summary(JTrainSummary(str(tmp_path / "tb"), "l"))
        opt.optimize()
        jledger.flush()
    finally:
        jledger.set_run_dir(None)
    recs, _ = load_ledger(run_dir, strict=True)
    jrecs, _ = jreport.load_ledger(run_dir, strict=True)
    rep, jrep = build_report(recs), jreport.build_report(jrecs)
    assert rep["steps"]["count"] == 6 and rep["events"]["step.skipped"] == 1
    assert _dump(rep) == _dump(jrep)
    assert render_report(rep) == jreport.render_report(jrep)
    assert _dump(run_trace.build_trace(recs)) == \
        _dump(jtrace.build_trace(jrecs))


def test_tfevents_bytes_match_reference(tmp_path, monkeypatch):
    rs = np.random.RandomState(3)
    values = [(tag, float(v), int(step)) for step, (tag, v) in enumerate(
        zip(["Loss", "Throughput", "LearningRate"] * 4,
            rs.uniform(-10, 1000, 12)))]
    files = []
    for cls, root in ((TrainSummary, "port"),
                      (jsummary.TrainSummary, "ref")):
        # the same wall clock for both: one tick a call
        clock = iter(np.arange(1.7e9, 1.7e9 + 1000, 0.25).tolist())
        monkeypatch.setattr(time, "time", lambda: next(clock))
        s = cls(str(tmp_path / root), "app")
        for tag, v, step in values:
            s.add_scalar(tag, v, step)
        s.add_scalar("NaN", float("nan"), 99)
        s.close()
        d = tmp_path / root / "app" / "train"
        (name,) = os.listdir(d)
        files.append((name, (d / name).read_bytes()))
    # same wall clock, same pid: the same file name and the same bytes
    (pname, port), (jname, ref) = files
    assert pname.split(".")[3] == jname.split(".")[3]
    assert len(port) > 12 * 16 and port == ref


def test_prometheus_text_matches_reference():
    from bigdl_tpu.optim.metrics import LATENCY_BUCKETS_S as JLADDER
    from bigdl_tpu_torch.optim.metrics import LATENCY_BUCKETS_S
    assert LATENCY_BUCKETS_S == JLADDER
    rs = np.random.RandomState(5)
    pm, jm = Metrics(), JMetrics()
    for m in (pm, jm):
        m.set("computing time average", 2.5e9)
        m.set("serve.queue depth", 3, unit="scalar")
        m.set("get weights wire traffic per node", 1.5, unit="MB/iteration")
        m.set("computing time for each node", [1e9, 2e9])
        m.add("computing time for each node", [5e8, 1e8])
        m.set("loss", 0.25, parallel=2)
    for v in rs.uniform(0, 3, 40).tolist():
        for m in (pm, jm):
            m.observe("serve.latency", v)
            m.incr("serve.completed")
            m.add("computing time average", v * 1e9)
    for m in (pm, jm):
        m.incr("skipped steps (non-finite)", 2)
    text = metrics_to_prometheus(pm)
    assert text == jmetrics_to_prometheus(jm)
    assert pm.summary() == jm.summary()
    assert pm.gathered() == jm.gathered()


def test_slo_tracker_burn_events_match_reference(tmp_path):
    rs = np.random.RandomState(9)
    seq = [(bool(ok), float(d)) for ok, d in zip(
        rs.uniform(size=300) > 0.03, rs.uniform(0.001, 0.2, 300))]
    got = []
    for mod, led, root in ((live, run_ledger, "port"),
                           (jlive, jledger, "ref")):
        run_dir = str(tmp_path / root)
        led.set_run_dir(run_dir)
        fired = []
        tr = mod.SLOTracker(target=0.99, window=64, min_samples=16,
                            burn_threshold=1.0, p99_threshold_s=0.19,
                            cooldown_s=0.0, on_trigger=fired.append)
        infos = [tr.observe(ok, d) for ok, d in seq]
        led.flush()
        led.set_run_dir(None)
        recs = [{k: v for k, v in r.items() if k not in ("ts", "mono")}
                for r in _read_lines(run_dir) if r["type"] == "slo.burn"]
        got.append((infos, fired, recs, tr.snapshot()))
    port, ref = got
    assert sum(i is not None for i in port[0]) >= 2
    assert port == ref
