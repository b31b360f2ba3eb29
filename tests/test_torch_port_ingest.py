"""The port's sharded multi-process feed (``dataset/sharded.py``,
``ingest_pool.py``, ``staging.py``), its fault sites and ``bench_ingest``
against the JAX package's.

Mirrors ``tests/test_ingest.py`` case for case.  Exact throughout: the
partitions tile the records; the sample stream (order and augmented
pixels, f32) at workers 0, 1 and 2 equals the reference's
``ShardedDataSet`` on the same records and seed, with and without
``pack_in_workers``; the staging ring yields the host batches bit for bit,
its bf16 cast equals the reference's ring's (round to nearest even); a
trainer over a staged sharded set takes the losses of the same trainer
over the same batches in memory.  Failures are typed: a worker's own
exception, ``IngestWorkerDied`` for a killed worker (and interpreter exit
does not hang, in a subprocess), ``InjectedFault`` at ``ingest.stage``.
The report of the bound stage from the run ledger is held against the
reference in ``tests/test_torch_port_obs_hooks.py``.  Worker pools stay at 2 processes or fewer (each
spawned worker imports torch).
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset.sharded import ShardedDataSet as JShardedDataSet
from bigdl_tpu.dataset.staging import StagingRing as JStagingRing
from bigdl_tpu.dataset.transformer import MiniBatch as JMiniBatch
from bigdl_tpu_torch.dataset import image as timage
from bigdl_tpu_torch.dataset import ingest_config
from bigdl_tpu_torch.dataset.image import (BGRImgCropper, BGRImgToBatch,
                                           HFlip, LabeledImage)
from bigdl_tpu_torch.dataset.ingest_pool import (IngestPool,
                                                 IngestWorkerDied, fold_seed)
from bigdl_tpu_torch.dataset.prefetch import MTTransformer
from bigdl_tpu_torch.dataset.sharded import (ShardedDataSet,
                                             partition_range, worker_shard)
from bigdl_tpu_torch.dataset.staging import StagingRing
from bigdl_tpu_torch.dataset.transformer import (Lambda, MiniBatch, Sample,
                                                 SampleToBatch, Transformer)
from bigdl_tpu_torch.resilience.fault_injector import (FaultInjector,
                                                       InjectedFault)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    FaultInjector.clear()
    yield
    FaultInjector.clear()


def _images(n, h=8, w=8, seed=0):
    rng = np.random.RandomState(seed)
    return [LabeledImage(rng.rand(h, w, 3).astype(np.float32),
                         float(i % 10) + 1) for i in range(n)]


def _jimages(imgs):
    return [jimage.LabeledImage(i.data, i.label) for i in imgs]


def _samples(n, dim=784, seed=0):
    rng = np.random.RandomState(seed)
    return [Sample(rng.rand(dim).astype(np.float32),
                   np.float32(i % 10 + 1)) for i in range(n)]


# -- the partitions -----------------------------------------------------------

def test_partition_range_tiles_exactly():
    from bigdl_tpu.dataset.sharded import partition_range as jpartition
    for n in (0, 1, 2, 5, 7, 24, 97, 100):
        for count in (1, 2, 3, 5, 8, 13):
            parts = [partition_range(n, i, count) for i in range(count)]
            assert [x for r in parts for x in r] == list(range(n))
            sizes = [len(r) for r in parts]
            assert max(sizes) - min(sizes) <= 1
            assert parts == [jpartition(n, i, count) for i in range(count)]


def test_partition_range_rejects_bad_index():
    with pytest.raises(ValueError):
        partition_range(10, 3, 3)
    with pytest.raises(ValueError):
        partition_range(10, -1, 3)


def test_worker_shard_every_record_once_across_hosts_and_workers():
    items = list(range(101))      # uneven: 3 hosts x 4 workers
    seen = []
    for h in range(3):
        for w in range(4):
            seen += worker_shard(items, h, 3, w, 4)
    assert sorted(seen) == items and len(seen) == len(items)


def test_sharded_dataset_hosts_partition_records():
    items = _images(11)
    streams = []
    for h in range(3):
        ds = ShardedDataSet(items, workers=0, chunk=4, host_index=h,
                            host_count=3)
        streams.append([r.label for r in ds.data(train=False)])
        assert ds.size() == len(streams[-1])
        want = JShardedDataSet(_jimages(items), workers=0, chunk=4,
                               host_index=h, host_count=3)
        assert streams[-1] == [r.label for r in want.data(train=False)]
    assert sorted(l for s in streams for l in s) == \
        sorted(r.label for r in items)


# -- seeded reproducibility against the reference -----------------------------

def _stream(cls, items, workers, seed=7, chunk=5, epochs=1):
    """The whole augmented stream (random crop and flip, the draws that
    must not depend on the worker count)."""
    mod = jimage if cls is JShardedDataSet else timage
    ds = cls(items, augment=mod.BGRImgCropper(4, 4, seed=seed) >>
             mod.HFlip(seed=seed + 1), workers=workers, chunk=chunk,
             seed=seed)
    out = []
    try:
        for _ in range(epochs):
            out.append([(r.label, np.asarray(r.data).copy())
                        for r in ds.data(train=True)])
            ds.shuffle()
    finally:
        ds.close()
    return out


def test_worker_count_never_changes_the_sample_stream():
    items = _images(37)
    ref = _stream(JShardedDataSet, _jimages(items), workers=0, epochs=2)
    for workers in (0, 1, 2):
        got = _stream(ShardedDataSet, items, workers=workers, epochs=2)
        for e, (eb, eg) in enumerate(zip(ref, got)):
            assert [l for l, _ in eb] == [l for l, _ in eg], (e, workers)
            for (_, xb), (_, xg) in zip(eb, eg):
                assert np.array_equal(xb, xg), (e, workers)


def test_epochs_and_seeds_do_change_augmentation():
    items = _images(16)
    (e0, e1) = _stream(ShardedDataSet, items, workers=0, epochs=2)
    assert [l for l, _ in e0] != [l for l, _ in e1]
    other = _stream(ShardedDataSet, items, workers=0, seed=99)[0]
    same = _stream(ShardedDataSet, items, workers=0)[0]
    assert any(not np.array_equal(x, y)
               for (_, x), (_, y) in zip(same, other))


def test_fold_seed_distinct_across_epoch_and_chunk():
    from bigdl_tpu.dataset.ingest_pool import fold_seed as jfold
    seen = {fold_seed(1, e, c) for e in range(32) for c in range(32)}
    assert len(seen) == 32 * 32
    assert all(fold_seed(s, e, c) == jfold(s, e, c)
               for s in (0, 1, 7, 2**40) for e in range(3) for c in range(5))


def test_reseed_gives_each_chain_leaf_a_distinct_stream():
    a, b = BGRImgCropper(4, 4), BGRImgCropper(4, 4)
    chain = a >> b
    chain.reseed(123)
    assert a._rng.randint(1 << 30) != b._rng.randint(1 << 30)
    chain.reseed(123)
    first = (a._rng.randint(1 << 30), b._rng.randint(1 << 30))
    chain.reseed(123)
    assert first == (a._rng.randint(1 << 30), b._rng.randint(1 << 30))
    ja, jb = jimage.BGRImgCropper(4, 4), jimage.BGRImgCropper(4, 4)
    (ja >> jb).reseed(123)
    assert first == (ja._rng.randint(1 << 30), jb._rng.randint(1 << 30))


def _batches_of(cls, items, batcher, pack_in_workers, workers, seed=3,
                augment=None):
    ds = cls(items, augment=augment, batcher=batcher,
             pack_in_workers=pack_in_workers, workers=workers, chunk=5,
             seed=seed)
    try:
        return [(np.asarray(b.data).copy(), np.asarray(b.labels).copy())
                for b in ds.data(train=False)]
    finally:
        ds.close()


def test_pack_in_workers_identical_batches_to_parent_pack():
    items = _images(43, h=10, w=10)
    ref = _batches_of(JShardedDataSet, _jimages(items),
                      jimage.BGRImgToBatch(8), False, 0,
                      augment=jimage.BGRImgCropper(6, 6, seed=3))
    assert [d.shape[0] for d, _ in ref] == [8, 8, 8, 8, 8, 3]
    for pw, w in ((False, 0), (True, 0), (True, 2)):
        got = _batches_of(ShardedDataSet, items, BGRImgToBatch(8), pw, w,
                          augment=BGRImgCropper(6, 6, seed=3))
        assert len(got) == len(ref)
        for (dr, lr), (dg, lg) in zip(ref, got):
            assert np.array_equal(dr, dg) and np.array_equal(lr, lg)


def test_from_seq_folder_counts_records_and_streams_images(tmp_path):
    from bigdl_tpu_torch.dataset.seqfile import BGRImgToLocalSeqFile
    rng = np.random.RandomState(2)
    imgs = [LabeledImage(rng.randint(0, 256, (6, 5, 3)).astype(np.float32),
                         float(i % 4 + 1)) for i in range(10)]
    d = tmp_path / "seq"
    d.mkdir()
    files = list(BGRImgToLocalSeqFile(4, str(d / "part")).apply(iter(imgs)))
    assert len(files) == 3                 # 4 + 4 + 2
    ds = ShardedDataSet.from_seq_folder(str(d), workers=0)
    ref = JShardedDataSet.from_seq_folder(str(d), workers=0)
    try:
        assert ds.size() == ref.size() == 10      # records, not files
        out = list(ds.data(train=False))
        assert [r.label for r in out] == [i.label for i in imgs]
        assert out[0].data.shape == (6, 5, 3)
        for a, b in zip(out, ref.data(train=False)):
            assert np.array_equal(a.data, b.data)
    finally:
        ds.close()


def test_pack_in_workers_needs_sized_batcher():
    with pytest.raises(ValueError, match="batch_size"):
        ShardedDataSet(_images(4), batcher=Lambda(lambda x: x),
                       pack_in_workers=True, workers=0)


def test_pack_in_workers_drop_last_drops_once_not_per_chunk():
    items = _images(43, h=10, w=10)
    ref = _batches_of(JShardedDataSet, _jimages(items),
                      jimage.BGRImgToBatch(8, drop_last=True), False, 0)
    assert [d.shape[0] for d, _ in ref] == [8] * 5    # 3 dropped, once
    for pw, w in ((False, 0), (True, 0), (True, 2)):
        got = _batches_of(ShardedDataSet, items,
                          BGRImgToBatch(8, drop_last=True), pw, w)
        assert [d.shape[0] for d, _ in got] == [8] * 5
        for (dr, lr), (dg, lg) in zip(ref, got):
            assert np.array_equal(dr, dg) and np.array_equal(lr, lg)


def test_pack_in_workers_rejects_dynamic_padding_batcher():
    """The reference refuses ``pack_in_workers`` with a batcher that pads
    each batch to its own longest record; the port's only padding batcher,
    ``SampleToBatch``'s, refuses padding itself until the DistriOptimizer
    slice, so no such batcher reaches ``ShardedDataSet``."""
    with pytest.raises(NotImplementedError, match="DistriOptimizer slice"):
        ShardedDataSet(_samples(8), batcher=SampleToBatch(
            4, feature_padding=0.0), pack_in_workers=True, workers=0)


# -- the ingest knobs ---------------------------------------------------------

def test_ingest_env_defaults_and_arg_precedence(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_INGEST_DEPTH", "5")
    monkeypatch.setenv("BIGDL_TPU_INGEST_WORKERS", "7")
    monkeypatch.setenv("BIGDL_TPU_INGEST_CHUNK", "11")
    assert ingest_config.depth() == 5
    assert ingest_config.workers() == 7
    assert ingest_config.chunk() == 11
    assert ingest_config.depth(3) == 3
    assert ingest_config.workers(0) == 0
    assert ingest_config.chunk(2) == 2
    assert ShardedDataSet(_images(2)).workers == 7


def test_ingest_env_strict_parsing(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_INGEST_DEPTH", "two")
    with pytest.raises(ValueError):
        ingest_config.depth()
    monkeypatch.setenv("BIGDL_TPU_INGEST_DEPTH", "1")
    with pytest.raises(ValueError):
        ingest_config.depth()
    monkeypatch.setenv("BIGDL_TPU_INGEST_DTYPE", "f64")
    with pytest.raises(ValueError):
        ingest_config.pack_dtype()
    with pytest.raises(ValueError):
        ingest_config.depth(1)
    with pytest.raises(ValueError):
        ingest_config.start_method("thread")


def test_ingest_dtype_spellings(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_INGEST_DTYPE", "bf16")
    assert ingest_config.pack_dtype() == torch.bfloat16
    monkeypatch.setenv("BIGDL_TPU_INGEST_DTYPE", "f32")
    assert ingest_config.pack_dtype() == torch.float32
    monkeypatch.delenv("BIGDL_TPU_INGEST_DTYPE")
    assert ingest_config.pack_dtype() is None
    assert StagingRing(dtype="bf16", device="cpu").dtype == torch.bfloat16


def test_prefetch_and_mt_read_the_env(monkeypatch):
    from bigdl_tpu_torch.dataset.prefetch import PrefetchToDevice
    monkeypatch.setenv("BIGDL_TPU_INGEST_DEPTH", "4")
    monkeypatch.setenv("BIGDL_TPU_INGEST_WORKERS", "3")
    monkeypatch.setenv("BIGDL_TPU_INGEST_CHUNK", "9")
    assert PrefetchToDevice(device="cpu").depth == 4
    assert StagingRing(device="cpu").depth == 4
    mt = MTTransformer(Lambda(lambda x: x))
    assert mt.workers == 3 and mt.chunk == 9


def test_mt_transformer_workers_zero_runs_in_process():
    mt = MTTransformer(Lambda(lambda x: x * 2), workers=0)
    assert list(mt(iter(range(10)))) == [x * 2 for x in range(10)]


# -- the staging ring ---------------------------------------------------------

def _batches(n, bs=4, shape=(3, 6, 6), seed=0):
    rng = np.random.RandomState(seed)
    return [MiniBatch(rng.rand(bs, *shape).astype(np.float32),
                      (np.arange(bs) % 3 + 1).astype(np.float32))
            for _ in range(n)]


def test_staging_ring_roundtrip_and_device_residency():
    src = _batches(5)
    out = list(StagingRing(depth=2, device="cpu").apply(iter(src)))
    assert len(out) == 5
    for s, o in zip(src, out):
        assert isinstance(o.data, torch.Tensor) and o.data.device.type == \
            "cpu"
        assert torch.equal(o.data, torch.from_numpy(s.data))
        assert torch.equal(o.labels, torch.from_numpy(s.labels))
    # each batch is its own copy: later refills never show through
    assert len({o.data.data_ptr() for o in out}) == 5
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA is not available (card present)")
        StagingRing()


def test_staging_ring_bf16_cast_parity_with_f32_path():
    import ml_dtypes
    src = _batches(3, seed=3)
    staged = list(StagingRing(depth=2, dtype="bf16", device="cpu").apply(
        iter(MiniBatch(b.data.copy(), b.labels.copy()) for b in src)))
    ref = list(JStagingRing(depth=2, dtype="bf16").apply(
        iter(JMiniBatch(b.data.copy(), b.labels.copy()) for b in src)))
    for s, o, r in zip(src, staged, ref):
        assert o.data.dtype == torch.bfloat16
        want = torch.from_numpy(s.data).to(torch.bfloat16)
        assert torch.equal(o.data, want)
        # the reference's host cast (round to nearest even), bit for bit
        assert np.array_equal(o.data.view(torch.int16).numpy(),
                              np.asarray(r.data).astype(ml_dtypes.bfloat16)
                              .view(np.int16))
        assert o.labels.dtype == torch.float32


def test_staging_ring_short_trailing_batch_ok():
    src = _batches(3) + [MiniBatch(
        np.ones((2, 3, 6, 6), np.float32), np.ones(2, np.float32))]
    out = list(StagingRing(depth=2, device="cpu").apply(iter(src)))
    assert [b.size() for b in out] == [4, 4, 4, 2]
    assert torch.equal(out[3].data, torch.ones(2, 3, 6, 6))


def test_staging_ring_oversize_batch_raises():
    src = [MiniBatch(np.ones((2, 3, 4, 4), np.float32),
                     np.ones(2, np.float32)),
           MiniBatch(np.ones((5, 3, 4, 4), np.float32),
                     np.ones(5, np.float32))]
    with pytest.raises(ValueError, match="slot capacity"):
        list(StagingRing(depth=2, device="cpu").apply(iter(src)))


def test_pinned_ring_grows_a_slot_unless_fixed():
    """``PrefetchToDevice``'s ring grows a slot for a larger batch (a short
    batch may come first); the staging ring, whose first batch fixes its
    capacity, raises."""
    from bigdl_tpu_torch.dataset.prefetch import _PinnedRing
    short, full = _batches(1, bs=2)[0], _batches(1, bs=4, seed=1)[0]
    ring = _PinnedRing(2, torch.bfloat16, torch.device("cpu"))
    for b in (short, full, short, full):
        data, labels, event = ring.put(b)
        assert event is None
        assert torch.equal(data, torch.from_numpy(b.data).bfloat16())
        assert torch.equal(labels, torch.from_numpy(b.labels))
    it = StagingRing(depth=2, device="cpu").apply(iter([short, full]))
    assert torch.equal(next(it).data, torch.from_numpy(short.data))
    with pytest.raises(ValueError, match="slot capacity"):
        next(it)


def test_staging_ring_backpressure_bounds_upstream():
    pulled = [0]

    def src():
        for b in _batches(64):
            pulled[0] += 1
            yield b

    it = StagingRing(depth=2, device="cpu").apply(src())
    next(it)                      # the consumer takes one batch, stalls
    time.sleep(0.5)
    # depth slots + depth ready + the two threads' batches in hand
    assert pulled[0] <= 2 * 2 + 3, pulled[0]
    it.close()                    # abandoned: the threads let go


def test_staging_ring_upstream_error_propagates_typed():
    class Boom(RuntimeError):
        pass

    def src():
        yield _batches(1)[0]
        raise Boom("decode failed")

    with pytest.raises(Boom):
        list(StagingRing(depth=2, device="cpu").apply(src()))
    with pytest.raises(TypeError, match="MiniBatch"):
        list(StagingRing(depth=2, device="cpu").apply(iter([1, 2])))


def test_staging_ring_stage_fault_site():
    FaultInjector.install(FaultInjector().add("ingest.stage"))
    with pytest.raises(InjectedFault, match="injected fault"):
        list(StagingRing(depth=2, device="cpu").apply(iter(_batches(3))))


# -- the process pool: errors and deaths --------------------------------------

class _BadDecode(Transformer):
    """Top-level, so spawn can pickle it into the worker."""

    def apply(self, prev):
        for r in prev:
            raise KeyError("bad record")
        return iter(())


def test_pool_worker_exception_propagates_as_itself():
    ds = ShardedDataSet(_samples(8), decode=_BadDecode(), workers=1,
                        chunk=4)
    try:
        with pytest.raises(KeyError):
            list(ds.data(train=False))
    finally:
        ds.close()


def test_pool_worker_kill_raises_typed_ingest_worker_died(monkeypatch):
    # armed by environment, so the spawned workers arm themselves
    monkeypatch.setenv("BIGDL_TPU_FAULTS", "ingest.worker.kill@2")
    FaultInjector.clear()
    ds = ShardedDataSet(_samples(40), workers=2, chunk=5)
    try:
        t0 = time.perf_counter()
        with pytest.raises(IngestWorkerDied, match="died mid-chunk"):
            list(ds.data(train=False))
        assert time.perf_counter() - t0 < 60
    finally:
        ds.close()
        monkeypatch.delenv("BIGDL_TPU_FAULTS")
        FaultInjector.clear()


def test_pool_worker_raise_fault_site(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_FAULTS", "ingest.worker@1")
    FaultInjector.clear()
    ds = ShardedDataSet(_samples(20), workers=1, chunk=5)
    try:
        with pytest.raises(InjectedFault, match="injected fault"):
            list(ds.data(train=False))
    finally:
        ds.close()
        monkeypatch.delenv("BIGDL_TPU_FAULTS")
        FaultInjector.clear()


def test_worker_death_never_hangs_interpreter_exit(tmp_path):
    """With enough chunks in flight to fill the call queue's pipe, a killed
    worker must not leave interpreter exit waiting on the executor's
    feeder thread after the typed error surfaced."""
    script = tmp_path / "drill.py"
    script.write_text(textwrap.dedent("""
        import numpy as np
        from bigdl_tpu_torch.dataset import Sample, ShardedDataSet

        def main():
            rng = np.random.RandomState(0)
            samples = [Sample(rng.rand(784).astype(np.float32),
                              np.float32(1)) for _ in range(512)]
            ds = ShardedDataSet(samples, workers=2, chunk=16)
            list(ds.data(train=False))

        if __name__ == "__main__":
            main()
    """))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(BIGDL_TPU_FAULTS="ingest.worker.kill@2", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "IngestWorkerDied" in proc.stderr


def test_pool_survives_close_and_reuse():
    pool = IngestPool(None, None, workers=1)
    jobs = [(i, fold_seed(1, 0, i), [i]) for i in range(4)]
    assert list(pool.run(iter(jobs))) == [0, 1, 2, 3]
    pool.close()
    assert list(pool.run(iter(jobs))) == [0, 1, 2, 3]   # rebuilt
    pool.close()
    pool.close()                                        # idempotent


# -- the trainer --------------------------------------------------------------

def _lenet_opt(ds, iters=8):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    opt = LocalOptimizer(LeNet5(10).reset(1), nn.ClassNLLCriterion(), ds,
                         Trigger.max_iteration(iters), device="cpu")
    opt.set_optim_method(SGD(learning_rate=0.01))
    return opt


def test_trainer_over_staged_sharded_dataset():
    """The trainer takes the staged batches as they are (CPU tensors from
    the ring; ``_to_device`` keeps a tensor on its device) and trains as
    over the same batches held in memory; the run closes the pool."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim.local_optimizer import _to_device
    staged = next(iter(StagingRing(device="cpu").apply(iter(_batches(1)))))
    assert _to_device(staged.data, torch.device("cpu")) is staged.data
    samples = _samples(48)
    ds = ShardedDataSet(samples, batcher=SampleToBatch(8), staging=True,
                        device="cpu", workers=2, chunk=6)
    opt = _lenet_opt(ds, iters=10)          # an epoch of 6, then 4
    opt.optimize()
    assert ds._pool is None                 # closed by the run
    assert ds.stats["batches"] >= 10
    # the same two epochs' batches in memory: the same losses
    mem = ShardedDataSet(samples, batcher=SampleToBatch(8), workers=0,
                         chunk=6)
    batches = list(mem.data(train=True))
    mem.shuffle()
    batches += list(mem.data(train=True))[:4]
    want = _lenet_opt(DataSet.array(batches), iters=10)
    want.optimize()
    got = [r["loss"] for r in opt.step_records]
    assert len(got) == 10 and np.isfinite(got).all()
    assert got == [r["loss"] for r in want.step_records]


def test_trainer_kill_one_ingest_worker_ends_typed_not_hung(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_FAULTS", "ingest.worker.kill@3")
    FaultInjector.clear()
    ds = ShardedDataSet(_samples(48), batcher=SampleToBatch(8),
                        workers=2, chunk=6)
    opt = _lenet_opt(ds, iters=12)
    try:
        with pytest.raises(IngestWorkerDied):
            opt.optimize()
    finally:
        ds.close()
        monkeypatch.delenv("BIGDL_TPU_FAULTS")
        FaultInjector.clear()


def test_trainer_epoch_rollover_reshuffles_sharded_stream():
    ds = ShardedDataSet(_samples(32), batcher=SampleToBatch(8),
                        workers=0, chunk=8)
    opt = _lenet_opt(ds, iters=8)         # 4 batches an epoch: 2 epochs
    opt.optimize()
    assert opt.state["epoch"] == 3        # 2 completed rollovers
    assert ds._epoch_serial == 2


# -- the bench ----------------------------------------------------------------

def test_bench_ingest_single_process_smoke(tmp_path, capsys):
    import json
    from bigdl_tpu_torch.dataset import bench_ingest
    out_path = str(tmp_path / "bench.json")
    art = bench_ingest.main(["--smoke", "--workers-list", "0", "--records",
                             "24", "--batch-size", "8", "--chunk", "6",
                             "--out", out_path])
    with open(out_path) as f:
        assert json.load(f) == json.loads(json.dumps(art))
    assert art["metric"] == "ingest_images_per_sec"
    assert art["worker_scaling_imgs_per_sec"]["0"] > 0
    seq = bench_ingest.main(["--smoke", "--recipe", "seqfile",
                             "--workers-list", "0", "--records", "24",
                             "--batch-size", "8", "--chunk", "6"])
    assert seq["worker_scaling_imgs_per_sec"]["0"] > 0 and seq["chunk"] == 1
    # the attribution pass: the ledger's ingest spans name a bound stage
    run_dir = str(tmp_path / "l")
    att = bench_ingest.main(["--smoke", "--workers-list", "0", "--records",
                             "24", "--batch-size", "8", "--chunk", "6",
                             "--run-dir", run_dir])
    assert att["run_dir"] == run_dir and att["attribution_workers"] == 0
    assert att["bound_stage"] in att["stage_attribution"]
    assert {"ingest.decode", "ingest.augment", "ingest.pack"} <= \
        set(att["stage_attribution"])
