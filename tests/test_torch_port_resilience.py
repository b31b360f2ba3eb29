"""The port's trainer and serving fault sites (``grad.nan``, ``train.step``,
``serve.pack``, ``serve.forward``, ``serve.worker<i>.forward``) against the
JAX package's, case for case with ``tests/test_resilience.py`` (the NaN
guard, auto-resume equal to an uninterrupted run) and
``tests/test_scheduler.py`` (one faulted pool worker).

Both trainers start from the same weights (built in ``bigdl_tpu`` and
copied with ``load_jax_params``) and take the same batches.  A poisoned
step keeps every weight bit for bit; the port's weights agree with the
reference's to atol 1e-5 after the same steps in float32 (sums in another
order); the port's resumed run equals its own uninterrupted run to atol
1e-6, the reference's own tolerance.  The poisoned batch equals
``jnp.full_like(data, jnp.nan)`` exactly, NaN for NaN, in every dtype, and
a poisoned batch of token ids (zeros) trains as the reference's does, to
atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.api import DLClassifier as JDLClassifier
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import MiniBatch as JMiniBatch
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim.local_optimizer import SKIPPED_STEPS as JSKIPPED_STEPS
from bigdl_tpu.resilience import FaultInjector as JFaultInjector
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.api import DLClassifier
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.observability.report import build_report, load_ledger
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.optim.local_optimizer import SKIPPED_STEPS, nan_like
from bigdl_tpu_torch.resilience import FaultInjector, InjectedFault
from bigdl_tpu_torch.serving import (ForwardFailedError, InferenceServer,
                                     PackFailedError)

torch.set_num_threads(1)

FEATURES = 4


@pytest.fixture(autouse=True)
def _clean_injectors():
    FaultInjector.clear()
    JFaultInjector.clear()
    yield
    FaultInjector.clear()
    JFaultInjector.clear()


def _jmodel():
    """``tests/test_resilience.py``'s model."""
    m = jnn.Sequential()
    m.add(jnn.Linear(4, 8))
    m.add(jnn.Tanh())
    m.add(jnn.Linear(8, 2))
    m.add(jnn.LogSoftMax())
    m.build(jax.random.PRNGKey(3))
    return m


def _tmodel(jm):
    m = tnn.Sequential()
    m.add(tnn.Linear(4, 8))
    m.add(tnn.Tanh())
    m.add(tnn.Linear(8, 2))
    m.add(tnn.LogSoftMax())
    return load_jax_params(m, jax.tree_util.tree_map(np.asarray, jm.params))


def _batches(cls, n=8):
    # identical batches isolate state-restore checks from data order
    rng = np.random.RandomState(0)
    x = rng.rand(8, 4).astype(np.float32)
    y = (np.arange(8) % 2 + 1).astype(np.float32)
    return [cls(x, y) for _ in range(n)]


def _jleaves(m):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(m.params)]


def _tleaves(m):
    return [np.asarray(x) for x in
            jax.tree_util.tree_leaves(export_params(m))]


def _jtrainer(m, iters, momentum=0.0):
    opt = JLocalOptimizer(m, jnn.ClassNLLCriterion(),
                          JDataSet.array(_batches(JMiniBatch)),
                          end_when=JTrigger.max_iteration(iters))
    kw = dict(momentum=momentum, dampening=0.0) if momentum else {}
    opt.set_optim_method(JSGD(learning_rate=0.1, **kw))
    return opt


def _ttrainer(m, iters, momentum=0.0):
    opt = LocalOptimizer(m, tnn.ClassNLLCriterion(),
                         DataSet.array(_batches(MiniBatch)),
                         end_when=Trigger.max_iteration(iters),
                         device="cpu")
    kw = dict(momentum=momentum, dampening=0.0) if momentum else {}
    opt.set_optim_method(SGD(learning_rate=0.1, **kw))
    return opt


# -- grad.nan: the poisoned batch and the non-finite guard --------------------

@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int32",
                                   "int64", "uint8", "bool"])
def test_poisoned_batch_equals_the_reference(dtype):
    x = (np.arange(12).reshape(3, 4) % 5).astype(dtype)
    want = np.asarray(jnp.full_like(jnp.asarray(x), jnp.nan))
    got = nan_like(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    if dtype.startswith("int") or dtype == "uint8":
        assert not got.any()           # the cast of NaN: zeros


def test_poisoned_batch_equals_the_reference_in_bf16():
    x = torch.arange(6, dtype=torch.bfloat16)
    want = np.asarray(jnp.full_like(jnp.asarray(x.float().numpy(),
                                                jnp.bfloat16), jnp.nan),
                      np.float32)
    got = nan_like(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_poisoned_token_batch_trains_as_the_reference_does():
    """``grad.nan`` on a batch of token ids: both packages poison it to
    zeros (NaN cast to an integer), ``LookupTable`` gathers row 0 - 1, the
    last, for every id, the step stays finite and is not skipped, and the
    weights agree after it."""
    rng = np.random.RandomState(2)
    ids = rng.randint(1, 11, size=8).astype(np.int32)
    y = (np.arange(8) % 2 + 1).astype(np.float32)
    jm = jnn.Sequential()
    jm.add(jnn.LookupTable(10, 4))
    jm.add(jnn.Linear(4, 2))
    jm.add(jnn.LogSoftMax())
    jm.build(jax.random.PRNGKey(5))
    tm = tnn.Sequential()
    tm.add(tnn.LookupTable(10, 4))
    tm.add(tnn.Linear(4, 2))
    tm.add(tnn.LogSoftMax())
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    table = _tleaves(tm)[0]
    JFaultInjector.install(JFaultInjector().add("grad.nan", step=0))
    jopt = JLocalOptimizer(jm, jnn.ClassNLLCriterion(),
                           JDataSet.array([JMiniBatch(ids, y)] * 2),
                           end_when=JTrigger.max_iteration(1))
    jopt.set_optim_method(JSGD(learning_rate=0.5))
    jopt.optimize()
    FaultInjector.install(FaultInjector().add("grad.nan", step=0))
    opt = LocalOptimizer(tm, tnn.ClassNLLCriterion(),
                         DataSet.array([MiniBatch(ids, y)] * 2),
                         end_when=Trigger.max_iteration(1), device="cpu")
    opt.set_optim_method(SGD(learning_rate=0.5))
    opt.optimize()
    assert opt.state.get("skippedSteps", 0) == \
        jopt.state.get("skippedSteps", 0) == 0
    assert FaultInjector.active().fired == ["grad.nan"]
    for a, b in zip(_tleaves(tm), _jleaves(jm)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    # only the last row of the table moved: every id read it
    moved = np.flatnonzero(np.any(_tleaves(tm)[0] != table, axis=1))
    assert moved.tolist() == [9]


def test_nan_guard_skips_and_counts_like_the_reference():
    jm = _jmodel()
    tm = _tmodel(jm)
    before = _tleaves(tm)
    JFaultInjector.install(JFaultInjector().add("grad.nan", step=0))
    jopt = _jtrainer(jm, 3)
    jopt.optimize()
    # step 0 poisoned: its update is a no-op, steps 1-2 train on
    FaultInjector.install(FaultInjector().add("grad.nan", step=0))
    opt = _ttrainer(tm, 3)
    opt.optimize()
    assert FaultInjector.active().fired == ["grad.nan"]
    assert opt.state["skippedSteps"] == jopt.state["skippedSteps"] == 1
    assert opt.metrics.get(SKIPPED_STEPS) == \
        jopt.metrics.get(JSKIPPED_STEPS) == 1
    assert opt.state["neval"] == jopt.state["neval"] == 3
    after = _tleaves(tm)
    assert any(not np.allclose(a, b) for a, b in zip(before, after)), \
        "healthy steps must still have trained"
    for a, b in zip(after, _jleaves(jm)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_a_poisoned_only_step_leaves_every_weight_bit_unchanged():
    FaultInjector.install(FaultInjector().add("grad.nan", step=0))
    tm = _tmodel(_jmodel())
    before = _tleaves(tm)
    opt = _ttrainer(tm, 1, momentum=0.9)
    opt.optimize()
    assert opt.state["skippedSteps"] == 1
    for a, b in zip(before, _tleaves(tm)):
        np.testing.assert_array_equal(a, b)
    # the optimizer state took no NaN either
    assert all(torch.isfinite(v).all() for vs in opt.opt_state.values()
               for v in vs if isinstance(v, torch.Tensor))


# -- train.step: preemption after the snapshot, auto-resume -------------------

def _resumable(m, path, iters):
    opt = _ttrainer(m, iters, momentum=0.9)
    opt.set_checkpoint(path, Trigger.several_iteration(1), auto_resume=True)
    return opt


def test_auto_resume_matches_uninterrupted_and_the_reference(tmp_path):
    path = str(tmp_path / "files")
    jm = _jmodel()
    FaultInjector.install(FaultInjector().add("train.step", step=2))
    with pytest.raises(InjectedFault, match="train.step step 2"):
        _resumable(_tmodel(jm), path, 4).optimize()
    FaultInjector.clear()
    assert sorted(p.name for p in (tmp_path / "files").iterdir()) == [
        "model.1", "model.2", "state.1", "state.2"]

    m2 = _tmodel(jm)
    opt2 = _resumable(m2, path, 4)
    opt2.optimize()
    assert opt2.state["neval"] == 4

    m3 = _tmodel(jm)
    _ttrainer(m3, 4, momentum=0.9).optimize()
    for a, b in zip(_tleaves(m2), _tleaves(m3)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)

    jopt = _jtrainer(jm, 4, momentum=0.9)
    jopt.optimize()
    for a, b in zip(_tleaves(m2), _jleaves(jm)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_train_step_fault_armed_from_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("BIGDL_TPU_FAULTS", "train.step@2")
    # a fresh process arms itself at its first check
    monkeypatch.setattr(FaultInjector, "_active", None)
    monkeypatch.setattr(FaultInjector, "_env_loaded", False)
    opt = _resumable(_tmodel(_jmodel()), str(tmp_path / "f"), 4)
    with pytest.raises(InjectedFault):
        opt.optimize()
    assert opt.state["neval"] == 2
    assert FaultInjector.active().fired == ["train.step"]


# -- serving: the pool's sites ------------------------------------------------

def _jserving_model():
    """``tests/test_scheduler.py``'s model."""
    m = jnn.Sequential()
    m.add(jnn.Linear(FEATURES, 3))
    m.add(jnn.LogSoftMax())
    m.build(jax.random.PRNGKey(0))
    return m


def _serving_pair():
    jm = _jserving_model()
    tm = tnn.Sequential()
    tm.add(tnn.Linear(FEATURES, 3))
    tm.add(tnn.LogSoftMax())
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _rows(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(FEATURES).astype(np.float32) for _ in range(n)]


def _settle(server, timeout=5.0):
    import time
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if all(w["pending"] == 0
               for w in server.stats()["workers"].values()):
            return
        time.sleep(0.001)


def test_pool_isolates_one_faulted_worker():
    """``tests/test_scheduler.py::test_pool_isolates_one_faulted_worker``:
    worker 0's forwards killed through its own site open its breaker only,
    the other worker answers as the reference's eager forward, drain loses
    nothing."""
    jm, tm = _serving_pair()
    server = InferenceServer(DLClassifier(tm, (4, FEATURES), device="cpu"),
                             num_workers=2, max_delay_s=0.05,
                             breaker_threshold=2, breaker_reset_s=60.0,
                             device="cpu")
    accepted = []
    try:
        FaultInjector.install(
            FaultInjector().add("serve.worker0.forward", count=2))
        for _ in range(2):                # sequential: tie-break -> w0
            futs = [server.submit(r) for r in _rows(4)]
            accepted += futs
            for f in futs:
                assert isinstance(f.exception(timeout=10),
                                  ForwardFailedError)
            _settle(server)
        ws = server.stats()["workers"]
        assert ws[0]["breaker"] == "open"
        assert ws[1]["breaker"] == "closed"
        rows = _rows(8, seed=7)
        futs = [server.submit(r) for r in rows]
        accepted += futs
        got = [f.result(timeout=10) for f in futs]
        eager = np.argmax(np.asarray(jm.forward(np.stack(rows))),
                          axis=1) + 1
        assert got == [int(v) for v in eager]
        assert server.stats()["workers"][0]["breaker"] == "open"
    finally:
        FaultInjector.clear()
        assert server.drain(timeout=10)
    assert all(f.done() for f in accepted)


def test_forward_os_error_is_retried_to_retry_events(tmp_path):
    """``serve.forward*2=OSError`` under ``forward_retries=2``: both faults
    are retried away, the answers equal the reference's classifier, and
    the ledger holds two ``retry`` events and two ``fault.injected``."""
    jm, tm = _serving_pair()
    rows = _rows(4, seed=3)
    want = [int(v) for v in JDLClassifier(jm, (4, FEATURES)).predict(rows)]
    run_dir = str(tmp_path / "run")
    run_ledger.set_run_dir(run_dir)
    try:
        FaultInjector.install(FaultInjector.from_env(
            "serve.forward*2=OSError"))
        server = InferenceServer(
            DLClassifier(tm, (4, FEATURES), device="cpu"),
            max_delay_s=0.05, forward_retries=2, retry_backoff_s=0.001,
            device="cpu")
        try:
            futs = [server.submit(r) for r in rows]
            got = [f.result(timeout=10) for f in futs]
            assert server.breaker.state == "closed"
        finally:
            assert server.drain(timeout=10)
        run_ledger.flush()
    finally:
        run_ledger.set_run_dir(None)
    assert got == want
    assert FaultInjector.active().fired == ["serve.forward"] * 2
    records, bad = load_ledger(run_dir, strict=True)
    assert bad == 0
    retries = [r for r in records if r.get("kind") == "retry"]
    assert [r["label"] for r in retries] == ["serve.forward"] * 2
    faults = [r for r in records if r.get("kind") == "fault.injected"]
    assert [(r["site"], r["exc"]) for r in faults] == \
        [("serve.forward", "OSError")] * 2
    rep = build_report(records)
    assert rep["serving"]["requests"] == {"ok": 4}


def test_pack_fault_fails_its_batch_and_spares_the_breaker():
    _, tm = _serving_pair()
    server = InferenceServer(DLClassifier(tm, (4, FEATURES), device="cpu"),
                             max_delay_s=0.05, breaker_threshold=1,
                             device="cpu")
    try:
        FaultInjector.install(FaultInjector().add("serve.pack", count=1))
        futs = [server.submit(r) for r in _rows(4)]
        assert all(isinstance(f.exception(timeout=10), PackFailedError)
                   for f in futs)
        assert server.breaker.state == "closed"
        futs = [server.submit(r) for r in _rows(4)]
        assert all(f.exception(timeout=10) is None for f in futs)
    finally:
        assert server.drain(timeout=10)
