"""The port's ``DLClassifier`` and ``InferenceServer`` on the CPU, against
the JAX package's ``DLClassifier`` on the same rows and weights, plus the
serving runtime's typed sheds, breaker, deadlines and drain, and the rule
that no entry point runs on the CPU unless asked to."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.api import DLClassifier as JDLClassifier
from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
from bigdl_tpu_torch.api import DLClassifier
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models import LeNet5
from bigdl_tpu_torch.serving import (AdmissionQueue, BreakerOpenError,
                                     DeadlineExceededError,
                                     DeadlineUnmeetableError, DrainingError,
                                     ForwardFailedError, InferenceServer,
                                     InvalidRequestError, QueueFullError,
                                     Request)
from bigdl_tpu_torch.serving.scheduler import (BucketedRunner, BucketLadder,
                                               pad_to_bucket)

# the suite runs several pytest workers on one host: keep torch from
# taking every core inside each of them
torch.set_num_threads(1)

BSZ = 8


def _rows(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(28, 28).astype(np.float32) for _ in range(n)]


def _model(seed=0):
    return LeNet5(10).reset(seed)


def _clf(model=None, cls=DLClassifier, **kw):
    return cls(model if model is not None else _model(), (BSZ, 28, 28),
               device="cpu", **kw)


def _server(clf=None, **kw):
    kw.setdefault("max_delay_s", 0.002)
    return InferenceServer(clf if clf is not None else _clf(),
                           device="cpu", **kw)


class _Slow(DLClassifier):
    """A forward with a known fixed cost."""
    delay_s = 0.03

    def _run(self, x):
        time.sleep(self.delay_s)
        return super()._run(x)


class _Faulty(DLClassifier):
    """A forward that fails while ``failing`` is set."""
    failing = False

    def _run(self, x):
        if self.failing:
            raise RuntimeError("injected forward failure")
        return super()._run(x)


@pytest.mark.parametrize("buckets", [None, (2, 8)])
def test_server_answers_like_the_jax_classifier(buckets):
    jm = JLeNet5(10)
    jm.build(seed=9)
    tm = load_jax_params(LeNet5(10), jax.tree_util.tree_map(np.asarray,
                                                            jm.params))
    rows = _rows(40, seed=1)
    want = JDLClassifier(jm, (BSZ, 28, 28)).predict(rows)
    server = _server(_clf(tm), batch_buckets=buckets)
    try:
        got = server.predict(rows)
        st = server.stats()
    finally:
        assert server.drain(timeout=30)
    np.testing.assert_array_equal(got, want)
    assert st["counters"]["serve.completed"] == 40
    assert st["breaker"] == "closed"
    assert sum(b["rows"] for b in st["buckets"].values()) == 40


def test_classifier_transform_pads_the_tail_and_keeps_dict_rows():
    clf = _clf()
    rows = [{"features": r, "id": i} for i, r in enumerate(_rows(BSZ + 3))]
    out = list(clf.transform(rows))
    assert [o["id"] for o in out] == list(range(BSZ + 3))
    one = DLClassifier(_model(), (BSZ, 28, 28), pipeline_depth=1,
                       device="cpu")
    np.testing.assert_array_equal(
        [o["predict"] for o in out],
        one.predict([r["features"] for r in rows]))
    assert all(1 <= o["predict"] <= 10 for o in out)
    with pytest.raises(ValueError, match="row 2 has shape"):
        clf.predict(_rows(2) + [np.zeros(5, np.float32)])


@pytest.mark.parametrize("kw,match", [
    # quantize= itself is served (tests/test_torch_port_quant.py); with a
    # mesh it waits for the parallel-strategies slice
    (dict(quantize="int8", mesh=object()), "quantized-inference"),
    (dict(mesh=object()), "parallel-strategies"),
    (dict(sharding=object()), "parallel-strategies"),
])
def test_later_slice_options_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        _clf(**kw)


def test_no_entry_point_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DLClassifier(_model(), (BSZ, 28, 28))
    clf = _clf()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(clf)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _model().to()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _model().to("cuda")


def test_invalid_row_is_rejected_at_submit():
    server = _server(warmup=False)
    try:
        with pytest.raises(InvalidRequestError, match="per-row shape"):
            server.submit(np.zeros(28 * 28 + 1, np.float32))
        assert server.stats()["counters"]["serve.invalid"] == 1
    finally:
        assert server.drain(timeout=30)


def test_queue_full_sheds_typed_and_loses_nothing():
    server = _server(queue_capacity=4, batch_buckets=(4,))
    futs = []
    try:
        # hold the pool lock: the dispatcher forms one batch of at most 4
        # and then blocks handing it to a worker, so the queue must fill
        with server._pool_lock:
            with pytest.raises(QueueFullError):
                for r in _rows(4 + 4 + 1):
                    futs.append(server.submit(r))
        assert 4 <= len(futs) <= 8
        preds = [f.result(timeout=30) for f in futs]
        assert all(1 <= p <= 10 for p in preds)
        assert server.stats()["counters"]["serve.shed.queue_full"] == 1
    finally:
        assert server.drain(timeout=30)


def test_queue_unit_rejects_full_draining_and_unmeetable():
    q = AdmissionQueue(2, floor_fn=lambda: 0.5)
    q.offer(Request(np.zeros(4)))
    q.offer(Request(np.zeros(4)))
    with pytest.raises(QueueFullError):
        q.offer(Request(np.zeros(4)))
    with pytest.raises(DeadlineUnmeetableError):
        AdmissionQueue(4, floor_fn=lambda: 0.5).offer(
            Request(np.zeros(4), deadline=time.monotonic() + 0.01))
    q.close()
    with pytest.raises(DrainingError):
        q.offer(Request(np.zeros(4)))
    assert q.take() is not None and q.take() is not None
    assert q.take() is None


def test_drain_flushes_every_accepted_request_then_sheds():
    server = _server(_clf(cls=_Slow), queue_capacity=64)
    futs = [server.submit(r) for r in _rows(3 * BSZ + 5)]
    assert server.drain(timeout=30)
    assert all(f.done() and f.exception() is None for f in futs)
    assert server.queue.depth == 0
    with pytest.raises(DrainingError):
        server.submit(_rows(1)[0])
    assert server.stats()["counters"]["serve.shed.draining"] == 1
    assert server.drain(timeout=30)           # idempotent


def test_breaker_opens_fails_fast_and_recovers():
    clf = _clf(cls=_Faulty)
    server = _server(clf, max_delay_s=0.2, breaker_threshold=2,
                     breaker_reset_s=0.05)
    try:
        clf.failing = True
        for _ in range(2):                    # two full batches fail
            futs = [server.submit(r) for r in _rows(BSZ)]
            for f in futs:
                assert isinstance(f.exception(timeout=30),
                                  ForwardFailedError)
        assert server.breaker.state == "open"
        with pytest.raises(BreakerOpenError):
            server.submit(_rows(1)[0])
        clf.failing = False
        time.sleep(0.07)                      # cooldown -> half-open probe
        assert server.predict(_rows(BSZ)).shape == (BSZ,)
        assert server.breaker.state == "closed"
        c = server.stats()["counters"]
        assert c["serve.breaker.open"] == 1
        assert c["serve.breaker.closed"] == 1
    finally:
        assert server.drain(timeout=30)


def test_unmeetable_deadline_sheds_and_queued_deadline_expires():
    server = _server(_clf(cls=_Slow), queue_capacity=64)
    delay = _Slow.delay_s
    try:
        assert server.stats()["floor_s"] >= delay   # warmup seeded it
        with pytest.raises(DeadlineUnmeetableError):
            server.submit(_rows(1)[0], deadline_s=delay / 100.0)
        ahead = [server.submit(r) for r in _rows(2 * BSZ)]
        doomed = [server.submit(r, deadline_s=2.0 * delay)
                  for r in _rows(BSZ, seed=9)]
        for f in ahead:
            assert f.exception(timeout=30) is None
        for f in doomed:
            assert isinstance(f.exception(timeout=30),
                              DeadlineExceededError)
        assert server.stats()["counters"]["serve.expired"] == BSZ
    finally:
        assert server.drain(timeout=30)


def test_warmup_runs_in_the_worker_thread():
    seen = set()

    class Spy(DLClassifier):
        def _run(self, x):
            seen.add(threading.current_thread().name)
            return super()._run(x)

    server = _server(_clf(cls=Spy), num_workers=2)
    try:
        assert seen == {"bigdl-torch-serve-w0", "bigdl-torch-serve-w1"}
    finally:
        assert server.drain(timeout=30)


def test_bucket_ladder_picks_the_nearest_rung():
    ladder = BucketLadder([32, 8])
    assert list(ladder) == [8, 32]
    assert [ladder.pick(n) for n in (1, 8, 9, 32)] == [8, 8, 32, 32]
    with pytest.raises(ValueError):
        ladder.pick(33)
    with pytest.raises(ValueError):
        BucketLadder([8, 8])
    assert pad_to_bucket(np.ones((3, 2)), 8).shape == (8, 2)


def test_bucketed_runner_takes_only_ladder_rungs_at_their_size():
    clf = _clf()
    runner = BucketedRunner(clf, BucketLadder([4, BSZ]))
    x = torch.zeros((4, 28, 28))
    assert tuple(runner.run(x, 4).shape) == (4,)
    with pytest.raises(ValueError, match="not a ladder rung"):
        runner.run(torch.zeros((2, 28, 28)), 2)
    with pytest.raises(ValueError, match="batch of 4 rows"):
        runner.run(x, BSZ)


def test_batches_go_to_the_least_loaded_admitting_worker():
    server = _server(num_workers=3, warmup=False)
    try:
        pool = server.pool
        with server._pool_lock:
            pool.workers[0].pending += 2
            pool.workers[1].pending += 1
        assert pool._pick().wid == 2          # fewest in flight
        assert pool._pick().wid == 1          # tie 1/1 -> lowest id
        for _ in range(3):
            pool.workers[1].breaker.record_failure()
        assert pool._pick().wid == 2          # an open breaker gets nothing
        with server._pool_lock:
            for w in pool.workers:
                w.pending = 0
    finally:
        assert server.drain(timeout=30)
