"""The port's run-ledger hooks in the trainer, the serving stack, the
memory budget, quantization and the data feed, against the JAX package on
the CPU.

The trainer's and the server's record census (record types, span names and
their parents' names, event kinds) equals the reference's on the same
inputs, the kernel-build ``compile`` records aside; the trainer's step
records agree step for step.  The other tests port the ledger parts of
``tests/test_scheduler.py`` (the pool's and the continuous generator's
records), ``tests/test_paging.py`` (pages, cache and speculation records),
``tests/test_membudget.py`` (the run report's memory census, held against
the reference's exactly), ``tests/test_quant.py`` (``quant.calibration``
and ``mem.params``), ``tests/test_ingest.py`` (the bound stage of a staged
sharded feed) and the seqfile-read test of ``tests/test_observability.py``,
plus the knobs this slice makes work: ``ContinuousGenerator(ledger_tags=)``,
the server's live ``/metrics`` and SLO capture, the step watchdog and the
injector's and retry's records.
"""

import collections
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.api import DLClassifier as JDLClassifier
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.transformer import MiniBatch as JMiniBatch
from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.observability import ledger as jledger
from bigdl_tpu.observability import report as jreport
from bigdl_tpu.ops import quant as jquant
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Top1Accuracy as JTop1Accuracy
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.serving import InferenceServer as JInferenceServer
from bigdl_tpu.serving.scheduler.membudget import \
    MemoryBudgeter as JMemoryBudgeter
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.api import DLClassifier
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.transformer import MiniBatch
from bigdl_tpu_torch.models import LeNet5, TransformerLM
from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.observability import live
from bigdl_tpu_torch.observability.report import (build_report,
                                                  load_ledger,
                                                  render_report)
from bigdl_tpu_torch.ops import quant
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Top1Accuracy, Trigger
from bigdl_tpu_torch.resilience import (FaultInjector, InjectedFault,
                                        WatchdogTimeout, retry)
from bigdl_tpu_torch.serving import (ContinuousGenerator, InferenceServer,
                                     MemoryBudgetError)
from bigdl_tpu_torch.serving.scheduler.membudget import MemoryBudgeter

torch.set_num_threads(1)

BSZ = 8


@pytest.fixture(autouse=True)
def _clean_ledger():
    run_ledger.set_run_dir(None)
    jledger.set_run_dir(None)
    yield
    run_ledger.set_run_dir(None)
    jledger.set_run_dir(None)
    FaultInjector.clear()


def _records(run_dir):
    recs, bad = load_ledger(run_dir, strict=True)
    assert bad == 0
    return recs


def _census(records):
    """(type, span name, parent's span name, event kind) -> count, over
    one process's records, the kernel-build records aside."""
    names = {(r.get("_pid"), r["span"]): r.get("name") for r in records
             if r.get("type") == "span"}
    out = collections.Counter()
    for r in records:
        t = r.get("type")
        if t == "compile":
            continue
        parent = names.get((r.get("_pid"), r.get("parent"))) \
            if "parent" in r else None
        out[(t, r.get("name") if t == "span" else None, parent,
             r.get("kind") if t == "event" else None)] += 1
    return out


def _lenet_pair(seed=9):
    jm = JLeNet5(10)
    jm.build(seed=seed)
    tm = load_jax_params(LeNet5(10), jax.tree_util.tree_map(np.asarray,
                                                            jm.params))
    return jm, tm


def _lenet_batches(cls, n=6, bs=8, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(rng.rand(bs, 28, 28).astype(np.float32),
                (np.arange(bs) % 10 + 1).astype(np.float32))
            for _ in range(n)]


# -- the trainer ----------------------------------------------------------------

def test_trainer_record_census_matches_reference(tmp_path):
    """LeNet-5 for 6 steps (an epoch of 3 batches twice), validation and a
    snapshot every epoch, a train summary: the port's ledger has the
    reference's records, spans and parents in the same numbers, and the
    same step records, losses to 1e-5."""
    jm, tm = _lenet_pair()
    runs = {}
    for side in ("ref", "port"):
        run_dir = str(tmp_path / side)
        if side == "ref":
            from bigdl_tpu.observability import TrainSummary as JTS
            jledger.set_run_dir(run_dir)
            opt = JLocalOptimizer(jm, jnn.ClassNLLCriterion(),
                                  JDataSet.array(_lenet_batches(JMiniBatch,
                                                                3)),
                                  JTrigger.max_iteration(6))
            opt.set_optim_method(JSGD(learning_rate=0.05))
            opt.set_validation(JTrigger.every_epoch(),
                               JDataSet.array(_lenet_batches(JMiniBatch, 2,
                                                             seed=1)),
                               [JTop1Accuracy()])
            opt.set_checkpoint(str(tmp_path / "jckpt"),
                               JTrigger.every_epoch())
            opt.set_train_summary(JTS(str(tmp_path / "jtb"), "l"))
            opt.optimize()
            jledger.set_run_dir(None)
        else:
            from bigdl_tpu_torch.observability import TrainSummary
            run_ledger.set_run_dir(run_dir)
            opt = LocalOptimizer(tm, tnn.ClassNLLCriterion(),
                                 DataSet.array(_lenet_batches(MiniBatch,
                                                              3)),
                                 Trigger.max_iteration(6), device="cpu")
            opt.set_optim_method(SGD(learning_rate=0.05))
            opt.set_validation(Trigger.every_epoch(),
                               DataSet.array(_lenet_batches(MiniBatch, 2,
                                                            seed=1)),
                               [Top1Accuracy()])
            opt.set_checkpoint(str(tmp_path / "tckpt"),
                               Trigger.every_epoch())
            opt.set_train_summary(TrainSummary(str(tmp_path / "ttb"), "l"))
            opt.optimize()
            run_ledger.set_run_dir(None)
        runs[side] = _records(run_dir)
    ref, port = runs["ref"], runs["port"]
    assert _census(port) == _census(ref)
    census = _census(port)
    for name, parent in (("init", None), ("data.next", None),
                         ("h2d", None), ("train.step", None),
                         ("cost.analysis", None),
                         ("loop.bookkeeping", None),
                         ("validate", "loop.bookkeeping"),
                         ("checkpoint.save", "loop.bookkeeping")):
        assert census[("span", name, parent, None)] >= 1, name

    def steps(recs):
        return [r for r in recs if r["type"] == "step"]

    keys = ("step", "epoch", "records", "skipped")
    assert [[r[k] for k in keys] for r in steps(port)] == \
        [[r[k] for k in keys] for r in steps(ref)]
    np.testing.assert_allclose([r["loss"] for r in steps(port)],
                               [r["loss"] for r in steps(ref)], rtol=1e-5)
    scalars = collections.Counter((r["src"], r["tag"]) for r in port
                                  if r["type"] == "scalar")
    assert scalars == collections.Counter(
        (r["src"], r["tag"]) for r in ref if r["type"] == "scalar")
    end = next(r for r in port if r["type"] == "run.end")
    assert end["steps"] == 6 and end["epoch"] == 3
    rep = build_report(port)
    assert rep["coverage"] >= 0.9 and rep["steps"]["count"] == 6
    assert rep["costs"]["train.step"]["flops"] > 0


def test_step_timeout_fires_in_the_trainer(tmp_path):
    """``set_step_timeout`` arms the watchdog over ``train.step``: a step
    that hangs ends the run in ``WatchdogTimeout``, with its ledger record
    and the span's error."""

    class SlowNLL(tnn.ClassNLLCriterion):
        calls = 0

        def forward(self, x, y):
            SlowNLL.calls += 1
            if SlowNLL.calls == 2:
                time.sleep(2.0)
            return super().forward(x, y)

    run_dir = str(tmp_path / "run")
    run_ledger.set_run_dir(run_dir)
    opt = LocalOptimizer(LeNet5(10).reset(1), SlowNLL(),
                         DataSet.array(_lenet_batches(MiniBatch, 3)),
                         Trigger.max_iteration(3), device="cpu")
    opt.set_step_timeout(0.3)
    t0 = time.monotonic()
    with pytest.raises(WatchdogTimeout, match="train step 1"):
        opt.optimize()
    assert time.monotonic() - t0 < 10
    run_ledger.flush()
    recs = _records(run_dir)
    fired = [r for r in recs if r.get("kind") == "watchdog.timeout"]
    assert fired and fired[0]["label"] == "train step 1"
    steps = [r for r in recs if r.get("type") == "span"
             and r.get("name") == "train.step"]
    assert steps[-1].get("error") in ("WatchdogTimeout",
                                      "KeyboardInterrupt")


def test_step_timeout_default_from_the_environment(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_STEP_TIMEOUT", "12.5")
    opt = LocalOptimizer(object(), object(), object(), device="cpu")
    assert opt.step_timeout == 12.5
    monkeypatch.setenv("BIGDL_TPU_STEP_TIMEOUT", "soon")
    with pytest.raises(ValueError, match="seconds"):
        LocalOptimizer(object(), object(), object(), device="cpu")


# -- the serving front ----------------------------------------------------------

def _rows(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(28, 28).astype(np.float32) for _ in range(n)]


def test_server_record_census_matches_reference(tmp_path):
    """40 requests through one worker over a (4, 8) ladder: the same
    record types, spans and parents; every request and row accounted."""
    jm, tm = _lenet_pair()
    rows = _rows(40, seed=1)
    runs = {}
    for side in ("ref", "port"):
        run_dir = str(tmp_path / side)
        if side == "ref":
            jledger.set_run_dir(run_dir)
            srv = JInferenceServer(JDLClassifier(jm, (BSZ, 28, 28)),
                                   batch_buckets=(4, 8), max_delay_s=0.002)
        else:
            run_ledger.set_run_dir(run_dir)
            srv = InferenceServer(DLClassifier(tm, (BSZ, 28, 28),
                                               device="cpu"),
                                  batch_buckets=(4, 8), max_delay_s=0.002,
                                  device="cpu")
        try:
            got = srv.predict(rows)
        finally:
            assert srv.drain(timeout=60)
            (jledger if side == "ref" else run_ledger).set_run_dir(None)
        runs[side] = (got, _records(run_dir))
    (pgot, port), (jgot, ref) = runs["port"], runs["ref"]
    np.testing.assert_array_equal(pgot, jgot)

    def kinds(recs):
        return set(_census(recs))

    assert kinds(port) == kinds(ref)
    for recs in (port, ref):
        c = _census(recs)
        assert c[("serve.request", None, None, None)] == 40
        assert c[("run.start", None, None, None)] == 1
        assert c[("run.end", None, None, None)] == 1
        assert c[("span", "serve.warmup", None, None)] == 1
        batches = [r for r in recs if r["type"] == "serve.batch"]
        assert sum(b["size"] for b in batches) == 40
        assert c[("span", "serve.forward", None, None)] == len(batches)
    rep, jrep = build_report(port), jreport.build_report(ref)
    assert rep["serving"]["requests"] == jrep["serving"]["requests"] \
        == {"ok": 40}


def test_pool_pred_parity_with_buckets_and_ledger(tmp_path):
    """Partial waves through 3 workers and a 3-rung ladder: the ledger's
    serve.batch records carry worker, bucket and padding efficiency, and
    the report's per-worker and per-bucket censuses render them."""
    _, tm = _lenet_pair()
    run_dir = str(tmp_path / "pool")
    run_ledger.set_run_dir(run_dir)
    try:
        clf = DLClassifier(tm, (8, 28, 28), device="cpu")
        server = InferenceServer(clf, num_workers=3, batch_buckets=[2, 4, 8],
                                 max_delay_s=0.003, device="cpu")
        rows = _rows(34)
        got = server.predict(rows)
        np.testing.assert_array_equal(got, clf.predict(rows))
        st = server.stats()
        assert set(st["workers"]) == {0, 1, 2}
        assert server.drain(timeout=10)
    finally:
        run_ledger.set_run_dir(None)
    records = _records(run_dir)
    batches = [r for r in records if r.get("type") == "serve.batch"
               and r.get("status") == "ok"]
    assert batches
    for b in batches:
        assert b["worker"] in (0, 1, 2)
        assert b["bucket"] in (2, 4, 8)
        assert 0.0 < b["padding_efficiency"] <= 1.0
        assert b["size"] <= b["bucket"]
    assert any(b["bucket"] < 8 for b in batches)
    rep = build_report(records)["serving"]
    assert set(rep["workers"]) <= {0, 1, 2} and rep["workers"]
    assert rep["buckets"]
    for e in rep["buckets"].values():
        assert 0.0 < e["mean_padding_efficiency"] <= 1.0
    # the workers' spans link back to the dispatches that routed them
    fwd = [r for r in records if r.get("name") == "serve.forward"]
    assert fwd and all("link" in r for r in fwd)


def test_server_live_metrics_and_slo_capture(tmp_path):
    """``metrics_port=0`` serves the live counters; an SLO burn writes its
    ``slo.burn`` event and a trace capture of the window."""
    _, tm = _lenet_pair()
    run_dir = str(tmp_path / "live")
    run_ledger.set_run_dir(run_dir)
    try:
        srv = InferenceServer(
            DLClassifier(tm, (BSZ, 28, 28), device="cpu"),
            max_delay_s=0.002, metrics_port=0, slo_target=0.9,
            slo_min_samples=4, slo_p99_threshold_s=1e-9,
            snapshot_interval_s=0.2, capture_window_s=30.0, device="cpu")
        try:
            srv.predict(_rows(24))
            url = srv.metrics_url
            text = live.scrape(url)
            assert "bigdl_tpu_serve_completed_total 24.0" in text
            assert "bigdl_tpu_serve_latency_seconds_count 24" in text
            assert srv.stats()["slo"]["samples"] == 24
        finally:
            assert srv.drain(timeout=30)
    finally:
        run_ledger.set_run_dir(None)
    assert live.scrape(url, timeout=1.0) is None          # closed
    records = _records(run_dir)
    burns = [r for r in records if r["type"] == "slo.burn"]
    caps = [r for r in records if r["type"] == "trace.capture"]
    assert burns and burns[0]["reason"] == "p99"
    assert caps and os.path.exists(caps[0]["path"])
    assert json.load(open(caps[0]["path"]))["traceEvents"]
    proms = [n for n in os.listdir(run_dir) if n.endswith(".prom")]
    assert proms == [f"metrics-serving-{os.getpid()}.prom"]
    rep = build_report(records)
    assert rep["serving"]["requests"] == {"ok": 24}
    assert rep["slo"]["burn_events"] == len(burns)


# -- the continuous generator ---------------------------------------------------

VOCAB, EMBED = 64, 32


def _lm(max_len=64, layers=2, seed=0):
    jm = JTransformerLM(VOCAB, max_len=max_len, embed_dim=EMBED,
                        num_heads=4, num_layers=layers)
    params, state = jm.init(jax.random.PRNGKey(seed))
    tm = TransformerLM(VOCAB, max_len=max_len, embed_dim=EMBED, num_heads=4,
                       num_layers=layers)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, state, tm.evaluate()


def test_continuous_occupancy_and_report(tmp_path):
    _, _, _, tm = _lm()
    run_dir = str(tmp_path / "gen")
    run_ledger.set_run_dir(run_dir)
    try:
        rs = np.random.RandomState(4)
        with ContinuousGenerator(tm, num_slots=2, seq_buckets=[8],
                                 steps_per_sync=2, device="cpu") as g:
            futs = [g.submit(rs.randint(1, 65, size=5).astype(np.int32),
                             int(rs.randint(2, 8))) for _ in range(6)]
            for f in futs:
                assert f.result(timeout=60) is not None
            st = g.stats()
            assert st["completed"] == 6
            assert 0.0 < st["mean_occupancy"] <= 1.0
    finally:
        run_ledger.set_run_dir(None)
    records = _records(run_dir)
    slots = [r for r in records if r.get("type") == "serve.slots"]
    assert slots and all(0 <= s["occupancy"] <= 1 for s in slots)
    spans = {r.get("name") for r in records if r.get("type") == "span"}
    assert {"serve.warmup", "serve.prefill", "serve.decode"} <= spans
    rep = build_report(records)["serving"]
    assert rep["slots"]["capacity"] == 2
    assert rep["slots"]["tokens"] > 0
    assert 0.0 < rep["slots"]["mean_occupancy"] <= 1.0
    reqs = [r for r in records if r.get("type") == "serve.request"]
    assert sum(1 for r in reqs if r["status"] == "ok") == 6
    end = next(r for r in records if r.get("type") == "run.end")
    assert end["kind"] == "ContinuousGenerator" and end["completed"] == 6
    assert f"metrics-generate-{os.getpid()}.prom" in os.listdir(run_dir)


def test_token_occupancy_counts_shared_pages_once(tmp_path):
    _, _, _, tm = _lm(max_len=32, layers=1)
    rs = np.random.RandomState(14)
    head = rs.randint(1, 65, size=16).astype(np.int32)
    prompts = [np.concatenate([head, rs.randint(1, 65, size=4)
                               .astype(np.int32)]) for _ in range(2)]
    run_dir = str(tmp_path / "occ")
    run_ledger.set_run_dir(run_dir)
    try:
        with ContinuousGenerator(tm, num_slots=2, max_len=32, page_size=8,
                                 num_pages=6, seq_buckets=[8, 32],
                                 steps_per_sync=1, device="cpu") as g:
            for f in [g.submit(p, 8) for p in prompts]:
                assert f.result(timeout=60) is not None
    finally:
        run_ledger.set_run_dir(None)
    pages = [r for r in _records(run_dir) if r.get("type") == "serve.pages"]
    assert pages
    assert max(p["tokens_held"] for p in pages) <= 48
    assert all(0 <= p["token_occupancy"] <= 1 for p in pages)
    assert max(p["pages_used"] for p in pages) == 6


def test_paged_ledger_records_and_report(tmp_path):
    """serve.pages, serve.cache and serve.spec reach the ledger; the report
    renders token occupancy, the prefix hit rate and the draft accept rate
    (a one-layer draft of the same model)."""
    jm, params, state, tm = _lm(max_len=96, layers=2)
    td = TransformerLM(VOCAB, max_len=96, embed_dim=EMBED, num_heads=4,
                       num_layers=1)
    load_jax_params(td, jax.tree_util.tree_map(np.asarray, {
        "tok": params["tok"], "pos": params["pos"],
        "blocks": params["blocks"][:1], "ln_f": params["ln_f"]}))
    rs = np.random.RandomState(11)
    head = rs.randint(1, 65, size=24).astype(np.int32)
    prompts = [np.concatenate([head, rs.randint(1, 65, size=4)
                               .astype(np.int32)]) for _ in range(4)]
    run_dir = str(tmp_path / "paged")
    run_ledger.set_run_dir(run_dir)
    try:
        with ContinuousGenerator(tm, num_slots=2, page_size=8,
                                 seq_buckets=[8, 32], steps_per_sync=2,
                                 draft_model=td.evaluate(), spec_k=3,
                                 device="cpu") as g:
            for f in [g.submit(p, 6) for p in prompts]:
                assert f.result(timeout=120) is not None
            counters = g.stats()["counters"]
            assert counters["serve.gen.prefix.hit_pages"] > 0
            assert counters["serve.gen.spec.proposed"] > 0
    finally:
        run_ledger.set_run_dir(None)
    records = _records(run_dir)
    start = next(r for r in records if r.get("type") == "run.start")
    assert start["paged"] and start["prefix_cache"] \
        and start["speculative"] and start["spec_k"] == 3
    pages = [r for r in records if r.get("type") == "serve.pages"]
    assert pages and all(0 <= p["token_occupancy"] <= 1 for p in pages)
    admits = [r for r in records if r.get("type") == "serve.cache"
              and r.get("event") == "admit"]
    assert len(admits) == 4
    assert sum(r["hit_pages"] for r in admits) == 9   # 3 pages x 3 hits
    specs = [r for r in records if r.get("type") == "serve.spec"]
    assert specs and all(s["proposed"] >= s["accepted"] for s in specs)
    end = next(r for r in records if r.get("type") == "run.end")
    assert end["mean_token_occupancy"] > 0
    assert end["prefix_hit_rate"] == pytest.approx(9 / 12)
    assert end["draft_accept_rate"] is not None
    rep = build_report(records)["serving"]
    assert 0 < rep["pages"]["mean_token_occupancy"] <= 1
    assert rep["pages"]["capacity_tokens"] > 0


def test_ledger_tags_reach_every_generator_record(tmp_path):
    """``ledger_tags={"tenant": ...}``: every record the generator writes
    carries the tag, and the budget tenant defaults to it (its
    ``mem.budget`` records and the budgeter's census name it)."""
    _, _, _, tm = _lm()
    bud = MemoryBudgeter()
    run_dir = str(tmp_path / "tags")
    run_ledger.set_run_dir(run_dir)
    try:
        rs = np.random.RandomState(2)
        with ContinuousGenerator(tm, num_slots=2, seq_buckets=[16],
                                 steps_per_sync=2, page_size=4,
                                 budgeter=bud, ledger_tags={"tenant": "t7"},
                                 device="cpu") as g:
            futs = [g.submit(rs.randint(1, 65, size=6), 4, session=f"s{i}")
                    for i in range(3)]
            for f in futs:
                f.result(timeout=60)
            g.park("s0").result(timeout=30)
            g.submit(rs.randint(1, 65, size=3), 3,
                     session="s0").result(timeout=60)
            g.close_session("s1").result(timeout=30)
            assert g.stats()["budget"] == bud.snapshot()["tenants"]["t7"]
    finally:
        run_ledger.set_run_dir(None)
    records = _records(run_dir)
    mine = [r for r in records if r["type"] in (
        "run.start", "run.end", "serve.request", "serve.slots",
        "serve.pages", "mem.offload")]
    assert {r["type"] for r in mine} >= {"run.start", "run.end",
                                         "serve.request", "mem.offload"}
    assert all(r.get("tenant") == "t7" for r in mine)
    actions = collections.Counter(r["action"] for r in records
                                  if r["type"] == "mem.offload")
    assert actions["park"] >= 1 and actions["resume"] >= 1 \
        and actions["close"] >= 1
    budget = [r for r in records if r["type"] == "mem.budget"]
    assert budget and all(r["tenant"] == "t7" for r in budget)
    mem = build_report(records)["memory"]
    assert "t7" in mem["tenants"] and mem["parks"] >= 1


def test_run_report_memory_census_exact_json(tmp_path):
    """The same budget and offload trail through both packages gives the
    same memory census, exactly, in the shape dashboards key on."""
    reps = []
    for led, bud_cls, rep_mod, exc in (
            (run_ledger, MemoryBudgeter, None, MemoryBudgetError),
            (jledger, JMemoryBudgeter, jreport,
             __import__("bigdl_tpu.serving.errors", fromlist=["x"])
             .MemoryBudgetError)):
        run_dir = str(tmp_path / ("port" if rep_mod is None else "ref"))
        led.set_run_dir(run_dir)
        try:
            b = bud_cls()
            b.set_budget("a", 1000)
            b.charge("a", "kv_pages", 600)
            b.transfer("a", "kv_pages", "prefix_pages", 200)
            b.transfer("a", "kv_pages", "host_offload", 300)
            b.discharge("a", "kv_pages", 100)
            with pytest.raises(exc):
                b.require_possible("a", 2000, what="monster")
            led.emit("mem.offload", action="park", sid="s0", pages=2,
                     bytes=300, reason="pressure", kv_pos=9)
            led.emit("mem.offload", action="resume", sid="s0", pages=2,
                     bytes=300, kv_pos=9)
            led.emit("mem.offload", action="close", sid="s0", kv_pos=9)
            led.flush()
        finally:
            led.set_run_dir(None)
        if rep_mod is None:
            reps.append(build_report(load_ledger(run_dir)[0]))
        else:
            reps.append(rep_mod.build_report(rep_mod.load_ledger(
                run_dir)[0]))
    rep, jrep = reps
    mem = rep["memory"]
    assert sorted(mem) == ["closes", "park_bytes", "parks", "reclaims",
                           "resume_bytes", "resumes", "sheds", "tenants"]
    assert mem["tenants"]["a"]["charged"] == {
        "kv_pages": 0, "prefix_pages": 200, "host_offload": 300}
    assert mem["tenants"]["a"]["budget"] == 1000
    assert mem["tenants"]["a"]["sheds"] == 1
    assert (mem["parks"], mem["resumes"], mem["closes"]) == (1, 1, 1)
    assert json.dumps(mem, sort_keys=True) == \
        json.dumps(jrep["memory"], sort_keys=True)
    text = render_report(rep)
    assert "-- memory (budget & offload census) --" in text
    assert "tenant a" in text and "byte-shed" in text


# -- quantization records -------------------------------------------------------

def test_calibration_record_matches_reference(tmp_path):
    jm = JTransformerLM(300, max_len=64, embed_dim=64, num_heads=4,
                        num_layers=2)
    params, state = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(300, max_len=64, embed_dim=64, num_heads=4,
                       num_layers=2)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    toks = np.random.RandomState(1).randint(1, 301, (2, 24))
    got = []
    for side in ("port", "ref"):
        run_dir = str(tmp_path / side)
        led = run_ledger if side == "port" else jledger
        led.set_run_dir(run_dir)
        try:
            calib = quant.calibrate(tm.evaluate(), [toks]) \
                if side == "port" else jquant.calibrate(jm, params, state,
                                                        [toks])
            led.flush()
        finally:
            led.set_run_dir(None)
        recs = [r for r in _records(run_dir)
                if r["type"] == "quant.calibration"]
        assert len(recs) == 1 and recs[0]["sites"] == len(calib)
        assert recs[0]["batches"] == 1
        got.append(recs[0])
    port, ref = got
    assert "blocks.0.attn.wq" in port["scales"]
    assert port["sites"] == ref["sites"] and \
        set(port["scales"]) == set(ref["scales"])
    for k, v in ref["scales"].items():
        assert port["scales"][k] == pytest.approx(v, rel=1e-5)


def test_mem_params_record_and_report_line(tmp_path):
    jm, tm = _lenet_pair()
    recs = []
    for side in ("port", "ref"):
        run_dir = str(tmp_path / side)
        led = run_ledger if side == "port" else jledger
        led.set_run_dir(run_dir)
        try:
            if side == "port":
                DLClassifier(tm, (16, 28, 28), quantize="w8", device="cpu")
            else:
                JDLClassifier(jm, (16, 28, 28), quantize="w8")
            led.flush()
        finally:
            led.set_run_dir(None)
        recs.append([r for r in _records(run_dir)
                     if r["type"] == "mem.params"])
    port, ref = recs
    assert port and port[-1]["kind"] == "DLClassifier"
    bd = port[-1]["bytes_by_dtype"]
    assert bd.get("int8", 0) > 0 and port[-1]["total_bytes"] == \
        sum(bd.values())
    assert bd == ref[-1]["bytes_by_dtype"]
    rep = build_report(_records(str(tmp_path / "port")))
    assert rep["param_bytes"]["DLClassifier"]["bytes_by_dtype"] == bd
    text = render_report(rep)
    assert "resident params (DLClassifier, w8)" in text and "int8" in text


# -- the data feed --------------------------------------------------------------

def _samples(n, dim=784, seed=0):
    from bigdl_tpu_torch.dataset.transformer import Sample
    rng = np.random.RandomState(seed)
    return [Sample(rng.rand(dim).astype(np.float32),
                   np.float32(i % 10 + 1)) for i in range(n)]


def test_trainer_over_staged_sharded_dataset_and_report_names_bound_stage(
        tmp_path):
    from bigdl_tpu_torch.dataset import ShardedDataSet
    from bigdl_tpu_torch.dataset.transformer import SampleToBatch
    run_dir = str(tmp_path / "run")
    run_ledger.set_run_dir(run_dir)
    try:
        ds = ShardedDataSet(_samples(48), batcher=SampleToBatch(8),
                            staging=True, device="cpu", workers=2, chunk=6)
        opt = LocalOptimizer(LeNet5(10).reset(1), tnn.ClassNLLCriterion(),
                             ds, Trigger.max_iteration(10), device="cpu")
        opt.set_optim_method(SGD(learning_rate=0.01))
        opt.optimize()
        run_ledger.flush()
    finally:
        run_ledger.set_run_dir(None)
    records = _records(run_dir)
    rep = build_report(records)
    ingest = rep["ingest"]
    assert ingest is not None
    assert {"ingest.pack", "ingest.stage",
            "ingest.h2d"} <= set(ingest["stages"])
    assert ingest["bound_stage"] in ingest["stages"]
    for st in ingest["stages"].values():
        assert st["records"] > 0 and st["capacity_records_per_s"] > 0
    txt = render_report(rep)
    assert "ingest pipeline" in txt and ingest["bound_stage"] in txt
    # the staged batches lie where the step runs: the trainer's h2d span
    # says so
    h2d = [r for r in records if r.get("name") == "h2d"]
    assert h2d and all(r["attrs"]["staged"] for r in h2d)


def test_seqfile_read_emits_io_records_not_spans(tmp_path):
    from bigdl_tpu_torch.dataset.image import LabeledImage
    from bigdl_tpu_torch.dataset.seqfile import (BGRImgToLocalSeqFile,
                                                 LocalSeqFileToBytes)
    rs = np.random.RandomState(0)
    imgs = [LabeledImage(rs.randint(0, 256, (4, 4, 3)).astype(np.float32),
                         1.0) for _ in range(8)]
    files = list(BGRImgToLocalSeqFile(8, str(tmp_path / "part"))
                 .apply(iter(imgs)))
    led = run_ledger.set_run_dir(str(tmp_path / "run"))
    assert len(list(LocalSeqFileToBytes().apply(iter(files)))) == 8
    led.flush()
    recs = _records(str(tmp_path / "run"))
    ios = [r for r in recs if r["type"] == "io"]
    assert len(ios) == 1 and ios[0]["records"] == 8
    rep = build_report(recs)
    assert "seqfile.read" in rep["io"]
    assert "seqfile.read" not in rep["phases"]
    assert "seqfile.read" in render_report(rep)


def test_injected_faults_and_retries_reach_the_ledger(tmp_path):
    run_dir = str(tmp_path / "run")
    run_ledger.set_run_dir(run_dir)
    FaultInjector.install(FaultInjector().add("io.read", step=None,
                                              count=2, exc=OSError)
                          .add("ingest.worker.kill", step=3))
    calls = []

    def read():
        calls.append(1)
        FaultInjector.fire("io.read")
        return "ok"

    assert retry(read, retries=3, backoff=0.0, label="unit.read") == "ok"
    assert FaultInjector.should("ingest.worker.kill", 3)
    FaultInjector.install(FaultInjector().add("io.read", count=5,
                                              exc=OSError))
    with pytest.raises(OSError):
        retry(read, retries=1, backoff=0.0, label="unit.giveup")
    with pytest.raises(InjectedFault):
        FaultInjector.install(FaultInjector().add("ingest.stage"))
        FaultInjector.fire("ingest.stage")
    # flushed at the moment of the fault: on disk before any flush call
    recs = _records(run_dir)
    kinds = collections.Counter(r.get("kind") for r in recs
                                if r["type"] == "event")
    assert kinds["fault.injected"] == 6
    assert kinds["retry"] == 3 and kinds["retry.giveup"] == 1
    kill = [r for r in recs if r.get("site") == "ingest.worker.kill"]
    assert kill and kill[0]["step"] == 3 and "exc" not in kill[0]
    rep = build_report(recs)
    assert rep["events"]["fault.injected"] == 6
