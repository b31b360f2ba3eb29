"""The port's multi-threaded batching and prefetch
(``bigdl_tpu_torch.dataset.prefetch``), the record-file ImageNet pipeline
(``models/inception.py`` ``_imagenet_set``) and the trainer taking batches
that are already tensors, against the JAX package's, on the CPU.

``MTLabeledBGRImgToBatch`` and ``_imagenet_set`` give the reference's
batches bit for bit on one folder with one set of seeds (the reference's
plain numpy normalization; its native one within 1e-6).  ``MTTransformer``
keeps the order at any worker count, streams an endless upstream and hands
a worker's error to the consumer.  ``PrefetchToDevice(device="cpu")``
yields the host batches as tensors, bit for bit, over more batches than its
depth, cast to ``dtype`` where given.  The trainer and ``LocalValidator``
take such tensor batches: a bf16 batch (which ``np.asarray`` refuses) trains
to the same losses as the host batch under bf16 mixed precision, and a
trainer over record files resumed from a mid-epoch snapshot takes the
uninterrupted run's losses exactly.  Mirrors ``tests/test_dataset.py`` and
``tests/test_seqfile.py``.
"""

import itertools
import os
import threading

import numpy as np
import pytest
import torch

from bigdl_tpu import native as jnative
from bigdl_tpu.dataset import prefetch as jprefetch
from bigdl_tpu.dataset.image import LabeledImage as JLabeledImage
from bigdl_tpu.models import inception as jinception
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.dataset import (BGRImgCropper, BGRImgToLocalSeqFile,
                                     DataSet, HFlip, LabeledImage, Lambda,
                                     LocalSeqFileToBytes, MiniBatch,
                                     SeqBytesToBGRImg)
from bigdl_tpu_torch.dataset import prefetch as tprefetch
from bigdl_tpu_torch.models import inception as tinception
from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, LocalValidator,
                                   Top1Accuracy, Top5Accuracy, Trigger)

torch.set_num_threads(1)


def _images(mod, n, seed=0, h=20, w=18):
    rs = np.random.RandomState(seed)
    return [mod(rs.rand(h + i % 4, w + i % 3, 3).astype(np.float32),
                float(rs.randint(1, 11))) for i in range(n)]


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in ((g.data, w.data), (g.labels, w.labels)):
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


# -- the batcher and the thread fan-out ---------------------------------------

@pytest.mark.parametrize("to_rgb", [False, True])
def test_mt_batcher_is_the_reference_bit_for_bit(to_rgb):
    imgs = _images(LabeledImage, 11, h=6, w=5)
    imgs = [LabeledImage(x.data[:6, :5], x.label) for x in imgs]
    jimgs = [JLabeledImage(x.data, x.label) for x in imgs]
    got = tprefetch.MTLabeledBGRImgToBatch(5, 6, 4, to_rgb, workers=3)(imgs)
    want = jprefetch.MTLabeledBGRImgToBatch(5, 6, 4, to_rgb, workers=3)(jimgs)
    _same_batches(got, want)


def _crop_flip():
    return BGRImgCropper(8, 8) >> HFlip(0.5)


def test_mt_transformer_keeps_the_in_process_order():
    """The order at every worker count; the images too where one clone
    takes every chunk (each worker's clone draws from its own copy of the
    seeded stream, as the reference's do), and then as the reference's."""
    from bigdl_tpu.dataset.image import BGRImgCropper as JCropper
    from bigdl_tpu.dataset.image import HFlip as JHFlip
    imgs = _images(LabeledImage, 37)
    jimgs = [JLabeledImage(x.data, x.label) for x in imgs]
    want = list(_crop_flip()(imgs))
    for workers, chunk in ((0, 4), (1, 5), (3, 4), (4, 1)):
        got = list(tprefetch.MTTransformer(_crop_flip(), workers,
                                           chunk)(imgs))
        assert [g.label for g in got] == [w.label for w in want]
        if workers <= 1:
            ref = list(jprefetch.MTTransformer(
                JCropper(8, 8) >> JHFlip(0.5), workers, chunk)(jimgs))
            for g, w, r in zip(got, want, ref):
                np.testing.assert_array_equal(g.data, w.data)
                np.testing.assert_array_equal(g.data, r.data)


def test_mt_transformer_streams_an_endless_upstream():
    pulled = itertools.count()

    def endless():
        for i in itertools.count():
            next(pulled)
            yield LabeledImage(np.full((2, 2, 3), i, np.float32), 1.0)

    mt = tprefetch.MTTransformer(Lambda(lambda x: x), workers=2, chunk=3)
    got = list(itertools.islice(mt(endless()), 10))
    assert [int(x.data[0, 0, 0]) for x in got] == list(range(10))
    assert next(pulled) <= 10 + 2 * 2 * 3 + 3      # the bounded window


def test_mt_transformer_hands_a_worker_error_on():
    def boom(x):
        if x.label == 3.0:
            raise KeyError("bad record")
        return x
    imgs = [LabeledImage(np.zeros((2, 2, 3), np.float32), float(i))
            for i in range(20)]
    with pytest.raises(KeyError, match="bad record"):
        list(tprefetch.MTTransformer(Lambda(boom), workers=2, chunk=2)(imgs))


# -- the record-file ImageNet pipeline ----------------------------------------

def _record_folder(root, n_train=13, n_val=7, size=40, classes=1000):
    rs = np.random.RandomState(4)
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, split))
        imgs = [LabeledImage(rs.randint(0, 256, (size + i % 5, size + i % 7,
                                                  3)).astype(np.float32),
                             float(rs.randint(1, classes + 1)))
                for i in range(n)]
        list(BGRImgToLocalSeqFile(4, os.path.join(root, split, "part"))
             .apply(iter(imgs)))
    return root


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_imagenet_set_batches_are_the_reference(tmp_path, monkeypatch,
                                                train, native):
    """Two epochs of shuffled files (train) or one pass (val): bit for bit
    against the reference's plain normalization, within 1e-6 of its native
    one (another instruction order)."""
    folder = _record_folder(str(tmp_path))
    monkeypatch.setattr(jnative, "available", lambda: native)
    got_ds = tinception._imagenet_set(folder, 3, train, image_size=32,
                                      workers=2)
    want_ds = jinception._imagenet_set(folder, 3, train, image_size=32,
                                       workers=2)
    assert got_ds.size() == want_ds.size() == (13 if train else 7)
    for _ in range(2 if train else 1):
        if train:
            got_ds.shuffle()
            want_ds.shuffle()
        n = -(-got_ds.size() // 3)
        got = list(itertools.islice(got_ds.data(train), n))
        want = list(itertools.islice(want_ds.data(train), n))
        if native:
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.data, w.data, rtol=1e-6,
                                           atol=1e-6)
                np.testing.assert_array_equal(g.labels, w.labels)
        else:
            _same_batches(got, want)
        assert got[0].data.shape == (3, 3, 32, 32)


# -- PrefetchToDevice on the CPU ----------------------------------------------

def _host_batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [MiniBatch(rs.standard_normal((4 - (i == n - 1), 3, 5, 5))
                      .astype(np.float32),
                      rs.randint(1, 10, 4 - (i == n - 1)).astype(np.float32))
            for i in range(n)]


@pytest.mark.parametrize("depth", [2, 3])
def test_prefetch_yields_the_host_batches(depth):
    host = _host_batches(9)
    got = list(tprefetch.PrefetchToDevice(depth, device="cpu")(host))
    assert all(isinstance(b.data, torch.Tensor) for b in got)
    _same_batches(got, host)
    # copies: the host buffers may be reused by the producer
    assert not np.shares_memory(got[0].data.numpy(), host[0].data)


def test_prefetch_casts_data_and_keeps_labels(monkeypatch):
    host = _host_batches(5)
    monkeypatch.setenv("BIGDL_TPU_INGEST_DTYPE", "bf16")
    got = list(tprefetch.PrefetchToDevice(device="cpu")(host))
    for g, h in zip(got, host):
        assert g.data.dtype == torch.bfloat16
        assert g.labels.dtype == torch.float32
        torch.testing.assert_close(g.data, torch.from_numpy(h.data)
                                   .to(torch.bfloat16), rtol=0, atol=0)
        np.testing.assert_array_equal(g.labels.numpy(), h.labels)


def test_prefetch_hands_an_error_on_and_stops_when_abandoned():
    def failing():
        yield from _host_batches(3)
        raise OSError("disk gone")
    with pytest.raises(OSError, match="disk gone"):
        list(tprefetch.PrefetchToDevice(2, device="cpu")(failing()))

    pulled = []

    def endless():
        for i in itertools.count():
            pulled.append(i)
            yield _host_batches(1, seed=i)[0]
    before = threading.active_count()
    it = tprefetch.PrefetchToDevice(2, device="cpu")(endless())
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before
    assert len(pulled) <= 2 + 3


def test_prefetch_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprefetch.PrefetchToDevice()
    with pytest.raises(ValueError, match="cannot double-buffer"):
        tprefetch.PrefetchToDevice(1, device="cpu")


# -- the trainer on tensor batches --------------------------------------------

def _net():
    return (tnn.Sequential()
            .add(tnn.SpatialConvolution(3, 4, 3, 3))
            .add(tnn.ReLU())
            .add(tnn.SpatialMaxPooling(2, 2, 2, 2))
            .add(tnn.View(4 * 4 * 4))
            .add(tnn.Linear(4 * 4 * 4, 10))
            .add(tnn.LogSoftMax())).reset(3)


def _samples_ds(n=24, seed=1):
    rs = np.random.RandomState(seed)
    return DataSet.array([MiniBatch(rs.standard_normal((4, 3, 10, 10))
                                    .astype(np.float32),
                                    rs.randint(1, 11, 4).astype(np.float32))
                          for _ in range(n // 4)])


def _train(ds, mixed, steps=5):
    opt = LocalOptimizer(_net(), tnn.ClassNLLCriterion(), ds,
                         Trigger.max_iteration(steps), device="cpu")
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
    opt.set_mixed_precision(mixed)
    opt.optimize()
    return opt


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_trainer_takes_prefetched_tensor_batches(dtype):
    """A batch already a tensor on the trainer's device is used as it is:
    bf16 batches (cast on the host, as mixed precision casts them) train
    to the host batches' losses and weights."""
    want = _train(_samples_ds(), mixed=True)
    got = _train(_samples_ds() >> tprefetch.PrefetchToDevice(
        dtype=dtype, device="cpu"), mixed=True)
    np.testing.assert_array_equal([r["loss"] for r in got.step_records],
                                  [r["loss"] for r in want.step_records])
    for a, b in zip(got.model.param_leaves(), want.model.param_leaves()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(got.step_records) == 5
    # float32 steps take a bf16 batch as float32 input, as jnp promotes it
    f32 = _train(_samples_ds() >> tprefetch.PrefetchToDevice(
        dtype=dtype, device="cpu"), mixed=False)
    assert np.isfinite([r["loss"] for r in f32.step_records]).all()


def test_validator_takes_prefetched_tensor_batches():
    model = _net()
    ds = _samples_ds(12)
    want = LocalValidator(model, ds, device="cpu").test(
        [Top1Accuracy(), Top5Accuracy()])
    for dtype in (None, "bf16"):
        got = LocalValidator(model, ds >> tprefetch.PrefetchToDevice(
            dtype=dtype, device="cpu"), device="cpu").test(
                [Top1Accuracy(), Top5Accuracy()])
        if dtype is None:
            assert got == want
        assert [r.count for r in got] == [12, 12]


def test_record_file_trainer_resumes_exactly(tmp_path):
    """Elements are files: a snapshot mid-epoch, resumed, skips the
    records its run trained (crops and flips replayed with them) and takes
    the uninterrupted run's losses across the next epoch boundary."""
    folder = _record_folder(str(tmp_path / "data"), n_train=14, size=12,
                            classes=10)

    def run(iters, ckpt=None, resume=None):
        ds = (DataSet.seq_file_folder(os.path.join(folder, "train"))
              >> LocalSeqFileToBytes() >> SeqBytesToBGRImg()
              >> BGRImgCropper(10, 10) >> HFlip(0.5)
              >> tprefetch.MTLabeledBGRImgToBatch(10, 10, 2, workers=2))
        opt = LocalOptimizer(_net(), tnn.ClassNLLCriterion(), ds,
                             Trigger.max_iteration(iters), device="cpu")
        opt.set_optim_method(SGD(learning_rate=0.05, momentum=0.9))
        if ckpt:
            opt.set_checkpoint(ckpt, Trigger.several_iteration(3))
        if resume:
            opt.resume_from(resume)
        opt.optimize()
        return [r["loss"] for r in opt.step_records], opt

    whole, opt = run(11)
    assert opt.state["epoch"] == 2        # 7 steps an epoch
    first, _ = run(3, ckpt=str(tmp_path / "ck"))
    rest, _ = run(11, resume=str(tmp_path / "ck"))
    assert first == whole[:3]
    np.testing.assert_array_equal(rest, whole[3:])
