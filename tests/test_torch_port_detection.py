"""The port's detection ops (``RoiPooling``, ``Nms``), a Fast R-CNN head
built from the port's modules, and the autoencoder's MSE recipe, against
the JAX package.

Tolerances: ``RoiPooling``'s output within rtol 1e-5 / atol 1e-6 of the
reference's and its input gradient (of the sum of the output times a
seeded random tensor) within rtol 1e-5 / atol 1e-6 of ``jax.grad``'s,
a tie inside a bin splitting the gradient evenly as ``jnp.max`` does;
``Nms`` indices equal.  The small Fast R-CNN head (a 2-conv, 1-pool,
8-channel trunk, 2 images of 3x64x80, 16 rois at scale 1/2, Fast R-CNN's
softmax and smooth-L1 losses; the JAX side runs its max pool in Pallas
interpret mode): the loss within rtol 1e-5, both outputs within atol 1e-5
and every trunk gradient within 1e-4 of its largest magnitude (f32 sums
over 16 rois and 5120 pixels in another order).  The autoencoder's recipe
(``Optimizer`` with ``MSECriterion``, SGD 0.01 with momentum 0.9, batch
15): three losses within rtol 1e-5 and the weights within atol 1e-5 of the
JAX package's ``Optimizer`` from the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.transformer import Sample as JSample
from bigdl_tpu.dataset.transformer import SampleToBatch as JSampleToBatch
from bigdl_tpu.models.autoencoder import Autoencoder as JAutoencoder
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Trigger as JTrigger
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.models import Autoencoder
from bigdl_tpu_torch.nn.pooling import roi_bins
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from tests.test_torch_port_models import _build, _np_params
from tests.test_torch_port_training import jax_losses  # noqa: F401

# the suite runs several pytest workers on one host: keep torch from
# taking every core inside each of them
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _roi_pair(feat, rois, pw, ph, scale, seed=0):
    """The port's RoiPooling against the reference's: output and the
    gradient of sum(y * r) with respect to the features."""
    jm = jnn.RoiPooling(pw, ph, scale)
    y, _ = jm.apply((), (), [jnp.asarray(feat), jnp.asarray(rois)])
    r = np.random.RandomState(seed).standard_normal(np.shape(y)) \
        .astype(np.float32)
    gj = jax.grad(lambda d: jnp.sum(jm.apply(
        (), (), [d, jnp.asarray(rois)])[0] * r))(jnp.asarray(feat))
    t = torch.from_numpy(feat).requires_grad_(True)
    yt = tnn.RoiPooling(pw, ph, scale)([t, torch.from_numpy(rois)])
    assert tuple(yt.shape) == np.shape(y)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y),
                               rtol=RTOL, atol=ATOL)
    (yt * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj), rtol=RTOL,
                               atol=ATOL)
    return yt.detach().numpy(), t.grad.numpy()


def test_roipooling_basic():
    feat = np.arange(64, dtype=np.float32).reshape(1, 1, 8, 8)
    rois = np.array([[1, 0, 0, 7, 7], [1, 4, 4, 7, 7]], np.float32)
    y, _ = _roi_pair(feat, rois, 2, 2, 1.0)
    np.testing.assert_array_equal(y[0, 0], [[27., 31.], [59., 63.]])
    np.testing.assert_array_equal(y[1, 0], [[45., 47.], [61., 63.]])


def _random_rois(rs, n, h, w, count):
    rois = []
    for _ in range(count):
        x1, y1 = rs.randint(0, w - 1), rs.randint(0, h - 1)
        rois.append([rs.randint(1, n + 1), x1, y1,
                     rs.randint(x1, 2 * w), rs.randint(y1, 2 * h)])
    return np.asarray(rois, np.float32)


def test_roipooling_matches_the_loop_oracle_rois():
    rs = np.random.RandomState(7)
    n, c, h, w = 2, 3, 9, 11
    feat = rs.randn(n, c, h, w).astype(np.float32)
    _roi_pair(feat, _random_rois(rs, n, h, w, 6), 2, 3, 0.5)


@pytest.mark.parametrize("rois", [
    # past the map on every side, and one roi wholly outside (every bin
    # empty: 0, no gradient)
    [[1, -20, -6, 30, 40], [2, 14, 10, 60, 90], [1, 40, 30, 60, 50],
     [2, -40, -40, -20, -20]],
    # one-cell rois, corners swapped (extent clamped to 1), a tall thin
    # roi whose bins overlap
    [[1, 5, 5, 5, 5], [2, 9, 9, 3, 3], [1, 0, 0, 1, 17]],
], ids=["past-the-map", "degenerate"])
def test_roipooling_at_the_edges_of_the_map(rois):
    rs = np.random.RandomState(3)
    feat = rs.randn(2, 4, 9, 11).astype(np.float32)
    y, g = _roi_pair(feat, np.asarray(rois, np.float32), 3, 4, 0.5)
    if len(rois) == 4:
        assert (y[3] == 0).all()


def test_roipooling_every_extent_matches_jax():
    """Rois of every extent from 1 to 40 cells at 7 x 7 bins and 1/16:
    each bin's edges are floor/ceil of products of an IEEE quotient (the
    reciprocal's product, one rounding off, moves the edge at 3, 6, 9 ...
    cells)."""
    k = np.arange(40, dtype=np.float32)
    rois = np.stack([np.ones_like(k), 16 * (39 - k), np.zeros_like(k),
                     np.full_like(k, 16 * 39), 16 * k], 1)
    feat = np.random.RandomState(6).randn(1, 3, 40, 40).astype(np.float32)
    _roi_pair(feat, rois, 7, 7, 1.0 / 16)


def test_roipooling_rounds_half_to_even_after_scaling():
    """At scale 1/16 pixel coordinates that are multiples of 8 land on .5:
    8 -> 0, 24 -> 2, 40 -> 2 (half to even, as jnp.round), not Caffe's
    floor(x + 0.5)."""
    rois = np.array([[1, 8, 24, 40, 56], [1, 24, 8, 104, 72],
                     [1, 0, 0, 120, 88]], np.float32)
    index, valid = roi_bins(torch.from_numpy(rois), 6, 8, 2, 2, 1.0 / 16)
    rows = (index // 8)[valid]
    assert rows.min() >= 0
    # the first roi spans rows round(1.5)=2 .. round(3.5)=4
    first = index[0][valid[0]]
    assert (first // 8).min() == 2 and (first // 8).max() == 4
    assert (first % 8).min() == 0 and (first % 8).max() == 2
    feat = np.random.RandomState(4).randn(1, 2, 6, 8).astype(np.float32)
    _roi_pair(feat, rois, 2, 2, 1.0 / 16)


def test_roipooling_splits_uneven_ties_evenly():
    """A bin of 2x3 cells whose max, 5, sits twice in its first row and
    once in its second: each of the three gets a third of the bin's
    gradient (a per-row max, then a max over rows, would give 1/4, 1/4
    and 1/2; an argmax all of it to one cell)."""
    feat = np.zeros((1, 1, 4, 6), np.float32)
    feat[0, 0, :2, :3] = [[5, 5, 1], [5, 0, 0]]
    feat[0, 0, 2:, 3:] = [[2, 2, 2], [2, 2, 2]]
    rois = np.array([[1, 0, 0, 5, 3]], np.float32)
    _, g = _roi_pair(feat, rois, 2, 2, 1.0)
    t = torch.from_numpy(feat).requires_grad_(True)
    tnn.RoiPooling(2, 2, 1.0)([t, torch.from_numpy(rois)]).sum().backward()
    third = np.float32(1.0) / 3
    np.testing.assert_allclose(t.grad[0, 0, :2, :3].numpy(),
                               [[third, third, 0], [third, 0, 0]])
    np.testing.assert_allclose(t.grad[0, 0, 2:, 3:].numpy(),
                               np.full((2, 3), 1 / 6, np.float32))


def test_roipooling_chunks_agree_with_one_pass(monkeypatch):
    from bigdl_tpu_torch.nn import pooling
    rs = np.random.RandomState(9)
    feat = torch.from_numpy(rs.randn(2, 5, 12, 14).astype(np.float32))
    rois = torch.from_numpy(_random_rois(rs, 2, 24, 28, 9))
    outs = []
    for budget in (1 << 26, 1):                  # one chunk; a roi a chunk
        monkeypatch.setattr(pooling, "ROI_CHUNK_ELEMENTS", budget)
        x = feat.clone().requires_grad_(True)
        y = tnn.RoiPooling(3, 2, 0.5)([x, rois])
        y.pow(2).sum().backward()
        outs.append((y.detach(), x.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-6, atol=1e-6)


def test_roipooling_takes_no_rois():
    y = tnn.RoiPooling(7, 7, 0.0625)([torch.zeros(1, 3, 5, 5),
                                      torch.zeros(0, 5)])
    assert tuple(y.shape) == (0, 3, 7, 7)


# -- Nms ---------------------------------------------------------------------

def test_nms_suppresses_overlapping():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [100, 100, 110, 110]],
                     np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    keep = tnn.Nms()(scores, boxes, 0.5)
    assert list(keep) == [0, 2]
    assert list(keep) == list(jnn.Nms()(scores, boxes, 0.5))


def test_nms_reference_calling_convention():
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [100, 100, 110, 110],
                      [0, 0, 9, 9]], np.float32)
    scores = np.array([0.5, 0.9, 0.7, 0.95], np.float32)
    buf, jbuf = [0] * 4, [0] * 4
    n = tnn.Nms().nms(scores, boxes, 0.3, buf)
    assert n == 2 and buf[:2] == [4, 3]
    assert jnn.Nms().nms(scores, boxes, 0.3, jbuf) == n and jbuf == buf
    with pytest.raises(ValueError, match="indices buffer too small"):
        tnn.Nms().nms(scores, boxes, 0.3, [0] * 3)


def test_nms_empty():
    assert tnn.Nms().nms(np.zeros((0,)), np.zeros((0, 4)), 0.5, []) == 0
    assert tnn.Nms()(np.zeros((0,)), np.zeros((0, 4)), 0.5).shape == (0,)


def test_nms_low_threshold_keeps_disjoint():
    boxes = np.array([[0, 0, 5, 5], [50, 50, 60, 60]], np.float32)
    scores = np.array([0.2, 0.8], np.float32)
    assert sorted(tnn.Nms()(scores, boxes, 0.1).tolist()) == [0, 1]


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_matches_the_reference_on_random_boxes_with_tied_scores(thresh):
    rs = np.random.RandomState(int(thresh * 10))
    xy = rs.randint(0, 200, (128, 2))
    wh = rs.randint(16, 120, (128, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rs.randint(0, 20, 128).astype(np.float32) / 20   # ties
    want = jnn.Nms()(scores, boxes, thresh)
    got = tnn.Nms()(torch.from_numpy(scores), torch.from_numpy(boxes),
                    thresh)
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < 128


# -- a Fast R-CNN head on a narrow trunk --------------------------------------

CLASSES = 21


def _head(nn, channels=8, pooled=7, hidden=32):
    trunk = nn.Sequential(
        nn.SpatialConvolution(3, channels, 3, 3, 1, 1, 1, 1), nn.ReLU(True),
        nn.SpatialConvolution(channels, channels, 3, 3, 1, 1, 1, 1),
        nn.ReLU(True), nn.SpatialMaxPooling(2, 2, 2, 2))
    return (nn.Sequential()
            .add(nn.ParallelTable().add(trunk).add(nn.Identity()))
            .add(nn.RoiPooling(pooled, pooled, 0.5))
            .add(nn.View(channels * pooled * pooled))
            .add(nn.Linear(channels * pooled * pooled, hidden))
            .add(nn.Threshold(0, 1e-6)).add(nn.Dropout(0.5))
            .add(nn.Linear(hidden, hidden))
            .add(nn.Threshold(0, 1e-6)).add(nn.Dropout(0.5))
            .add(nn.ConcatTable().add(nn.Linear(hidden, CLASSES))
                 .add(nn.Linear(hidden, 4 * CLASSES))))


def _head_loss(nn, n_rois):
    return (nn.ParallelCriterion()
            .add(nn.SoftmaxWithCriterion(), 1.0)
            .add(nn.SmoothL1CriterionWithWeights(1.0, n_rois), 1.0))


def _head_data(seed, images, h, w, per_image):
    """Images, rois (batch index, box in pixels; odd corners land on .5 at
    scale 1/2, some reach the edge) and Fast R-CNN targets: a quarter of
    the rois foreground (labels 2-21, their class's 4 box columns weighed
    1), the rest background (label 1, weight 0)."""
    rs = np.random.RandomState(seed)
    img = rs.standard_normal((images, 3, h, w)).astype(np.float32)
    rois = []
    for b in range(images):
        for _ in range(per_image):
            bw, bh = rs.randint(8, w // 2), rs.randint(8, h // 2)
            x1, y1 = rs.randint(0, w - 4), rs.randint(0, h - 4)
            rois.append([b + 1, x1, y1, min(x1 + bw, w - 1),
                         min(y1 + bh, h - 1)])
    rois = np.asarray(rois, np.float32)
    r = len(rois)
    labels = np.ones(r, np.float32)
    fg = rs.permutation(r)[:r // 4]
    labels[fg] = rs.randint(2, CLASSES + 1, len(fg))
    targets = rs.standard_normal((r, 4 * CLASSES)).astype(np.float32)
    weights = np.zeros((r, 4 * CLASSES), np.float32)
    for i in fg:
        c = int(labels[i]) - 1
        weights[i, 4 * c:4 * c + 4] = 1.0
    return img, rois, [labels, [targets, weights, weights.copy()]]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_PALLAS_INTERPRET", "1")


def test_fast_rcnn_head_matches_jax(interpret):
    img, rois, target = _head_data(5, 2, 64, 80, 8)
    n_rois = len(rois)
    jm, tm = _head(jnn), _head(tnn)
    _build(jm, 6)
    load_jax_params(tm, _np_params(jm))
    jc, tc = _head_loss(jnn, n_rois), _head_loss(tnn, n_rois)
    jtarget = jax.tree_util.tree_map(jnp.asarray, target)

    def jloss(p):
        out, _ = jm.apply(p, jm.state, [jnp.asarray(img), jnp.asarray(rois)],
                          training=False)
        return jc.apply(out, jtarget), out
    (lj, outj), gj = jax.value_and_grad(jloss, has_aux=True)(jm.params)

    tm.evaluate()
    ops.reset_launches()
    out = tm([torch.from_numpy(img), torch.from_numpy(rois)])
    loss = tc(out, jax.tree_util.tree_map(torch.from_numpy, target))
    loss.backward()
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-5)
    for a, b in zip(outj, out):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=1e-5)
    # the trunk's gradients crossed RoiPooling
    trunk_t = tm.layers[0].layers[0]
    trunk_j = jax.tree_util.tree_leaves(gj[0][0])
    got = [p.grad.numpy() for p in trunk_t.param_leaves()]
    assert len(got) == len(trunk_j) == 4
    for g, w in zip(got, trunk_j):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


# -- the autoencoder's recipe ---------------------------------------------------

def _mnist_like(pkg_sample, n, seed):
    """Seeded 28x28 grey images in [0, 255], normalised as the reference's
    ``GreyImgNormalizer(0.13066047740239506, 0.3081078)``, flattened; the
    target is the input (``Train.scala``'s ``toAutoencoderBatch``)."""
    rs = np.random.RandomState(seed)
    raw = rs.randint(0, 256, (n, 28, 28)).astype(np.float32) / 255.0
    flat = ((raw - 0.13066047740239506) / 0.3081078).reshape(n, 784) \
        .astype(np.float32)
    return [pkg_sample(flat[i], flat[i]) for i in range(n)]


def test_autoencoder_recipe_matches_the_jax_optimizer(jax_losses):  # noqa: F811
    jm, tm = JAutoencoder(32), Autoencoder(32)
    _build(jm, 8)
    load_jax_params(tm, _np_params(jm))
    jopt = JOptimizer(jm, JDataSet.array(_mnist_like(JSample, 45, 1)) >>
                      JSampleToBatch(15), jnn.MSECriterion(),
                      JTrigger.max_iteration(3))
    topt = Optimizer(tm, DataSet.array(_mnist_like(Sample, 45, 1)) >>
                     SampleToBatch(15), tnn.MSECriterion(),
                     Trigger.max_iteration(3), device="cpu")
    jopt.set_optim_method(JSGD(learning_rate=0.01, momentum=0.9))
    topt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    jopt.optimize()
    topt.optimize()
    tl = [r["loss"] for r in topt.step_records]
    assert len(tl) == len(jax_losses) == 3
    np.testing.assert_allclose(tl, jax_losses, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(_np_params(jm)),
                    jax.tree_util.tree_leaves(export_params(tm))):
        np.testing.assert_allclose(b, a, atol=1e-5)
