"""The port's training pieces against the JAX package, unit by unit.

* The plain versions of K3 (max-pool backward) and K4 (LRN backward)
  against the Pallas kernels they replace, run in interpret mode as
  ``tests/test_pallas_ops.py`` runs them, through ``jax.vjp``: max pool
  to rtol/atol 1e-6 with equal argmax codes, LRN to rtol 1e-5 / atol 1e-6
  (float32; sums taken in another order).  The kernel-against-plain checks
  need a CUDA card and live in ``test_torch_port_cuda.py``.
* Autograd on the CPU: ``gradcheck`` in float64 on the plain LRN pair, and
  the layers' ``x.grad`` against the plain backward.
* ``ClassNLLCriterion``, ``SGD.update``, the schedules, triggers,
  accuracies, the dataset's shuffle stream, ``Dropout`` and the non-finite
  guard, exact or to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.dataset import LocalArrayDataSet as JLocalArrayDataSet
from bigdl_tpu.ops import lrn as jlrn
from bigdl_tpu.ops import pooling as jpool
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.optim import validation as jval
from bigdl_tpu.optim.trigger import Trigger as JTrigger
from bigdl_tpu.utils.table import T as JT
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.core import init as tinit
from bigdl_tpu_torch.dataset import (DataSet, LocalArrayDataSet, Sample,
                                     SampleToBatch)
from bigdl_tpu_torch.models import LeNet5
from bigdl_tpu_torch.ops import (lrn_bwd_plain, lrn_plain, max_pool2d,
                                 max_pool2d_bwd_plain, max_pool2d_plain,
                                 pool_geometry)
from bigdl_tpu_torch.ops.lrn import cross_map_lrn
from bigdl_tpu_torch.optim import (SGD, SKIPPED_STEPS, Default, EpochStep,
                                   LocalOptimizer, LocalValidator, Optimizer,
                                   Poly, Step, Top1Accuracy, Top5Accuracy,
                                   Trigger)
from bigdl_tpu_torch.optim import validation as tval
from bigdl_tpu_torch.utils.table import T

# the suite runs several pytest workers on one host: keep torch from
# taking every core inside each of them
torch.set_num_threads(1)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_PALLAS_INTERPRET", "1")


# -- K3: max-pool backward ----------------------------------------------------

def _pool_input(shape, seed, ties):
    rng = np.random.RandomState(seed)
    if ties:    # integer values force ties inside most windows
        return rng.randint(-2, 3, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


POOL_BWD_CASES = [
    # shape, kh, kw, sh, sw, ph, pw, ceil, ties
    ((2, 3, 9, 9), 3, 3, 2, 2, 0, 0, True, False),     # stem pool, ceil
    ((2, 3, 9, 9), 3, 3, 2, 2, 0, 0, False, False),    # floor
    ((2, 4, 8, 8), 3, 3, 1, 1, 1, 1, False, False),    # branch pool, stride 1
    ((1, 3, 7, 11), 3, 3, 2, 2, 1, 1, True, False),    # odd HW, ceil, pad
    ((1, 3, 7, 11), 3, 3, 2, 2, 1, 1, False, True),    # odd HW, floor, ties
    ((2, 5, 8, 6), 2, 2, 2, 2, 0, 0, False, True),     # LeNet pool, ties
    ((2, 4, 8, 8), 3, 3, 1, 1, 1, 1, False, True),     # stride 1, ties
    ((1, 2, 10, 7), 3, 2, 2, 3, 1, 1, True, True),     # rectangular window
]

# the 13 SpatialMaxPooling layers of Inception-v1 at their plane sizes,
# batch 1 and 2 channels: (H = W, kh = kw, s, pad, ceil)
INCEPTION_POOLS = [
    ("pool1", 112, 3, 2, 0, True), ("pool2", 56, 3, 2, 0, True),
    ("3a", 28, 3, 1, 1, False), ("3b", 28, 3, 1, 1, False),
    ("pool3", 28, 3, 2, 0, True), ("4a", 14, 3, 1, 1, False),
    ("4b", 14, 3, 1, 1, False), ("4c", 14, 3, 1, 1, False),
    ("4d", 14, 3, 1, 1, False), ("4e", 14, 3, 1, 1, False),
    ("pool4", 14, 3, 2, 0, True), ("5a", 7, 3, 1, 1, False),
    ("5b", 7, 3, 1, 1, False),
]
POOL_BWD_CASES += [((1, 2, h, h), k, k, s, s, p, p, ceil, i % 2 == 1)
                   for i, (_, h, k, s, p, ceil) in enumerate(INCEPTION_POOLS)]
POOL_BWD_IDS = [f"case{i}" for i in range(8)] + \
    [f"inception-{c[0]}" for c in INCEPTION_POOLS]


@pytest.mark.parametrize("case", POOL_BWD_CASES, ids=POOL_BWD_IDS)
def test_max_pool_bwd_plain_matches_pallas_vjp(interpret, case):
    shape, kh, kw, sh, sw, ph, pw, ceil, ties = case
    geom = (kh, kw, sh, sw, ph, pw, ceil)
    x = _pool_input(shape, 0, ties)
    oh, ow, _, _ = pool_geometry(shape[2], shape[3], *geom)
    dy = np.random.RandomState(1).standard_normal(
        (shape[0], shape[1], oh, ow)).astype(np.float32)
    y, vjp = jax.vjp(lambda t: jpool._max_pool_pallas(t, *geom),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    _, (jidx,) = jpool._max_pool_fwd_impl(jnp.asarray(x), *geom, shape[2],
                                          shape[3])
    ty, idx = max_pool2d_plain(torch.from_numpy(x), *geom)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(jidx).astype(np.uint8))
    dx = max_pool2d_bwd_plain(torch.from_numpy(dy), idx, geom, shape[2],
                              shape[3])
    assert dx.shape == x.shape and dx.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _gather_like_the_kernel(dy, idx, geom, ih, iw, dtype):
    """A scalar model of ``csrc/max_pool.cu`` ``max_pool2d_bwd_kernel``:
    per dx cell, f32 sums over q within each window row p, then over p in
    ascending order, rounded once."""
    kh, kw, sh, sw, ph, pw, _ = geom
    n, c, oh, ow = dy.shape
    d, ix = dy.float().numpy(), idx.numpy()
    out = np.zeros((n, c, ih, iw), np.float32)
    for b in range(n):
        for ch in range(c):
            for y in range(ih):
                for x in range(iw):
                    r, col = y + ph, x + pw
                    acc = np.float32(0)
                    for p in range(min(kh, r + 1)):
                        rr = r - p
                        if rr % sh or rr // sh >= oh:
                            continue
                        row = np.float32(0)
                        for q in range(min(kw, col + 1)):
                            cc = col - q
                            if cc % sw or cc // sw >= ow:
                                continue
                            if ix[b, ch, rr // sh, cc // sw] == p * kw + q:
                                row = np.float32(
                                    row + d[b, ch, rr // sh, cc // sw])
                        acc = np.float32(acc + row)
                    out[b, ch, y, x] = acc
    return torch.from_numpy(out).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_max_pool_bwd_plain_is_bit_equal_to_the_kernels_gather(dtype):
    """K3's claim of bit-equality rests on its order of sums: a gather per
    dx cell in the order of the plain version's scatter."""
    for shape, kh, kw, sh, sw, ph, pw, ceil, ties in POOL_BWD_CASES[:8]:
        geom = (kh, kw, sh, sw, ph, pw, ceil)
        x = torch.from_numpy(_pool_input(shape, 2, ties)).to(dtype)
        _, idx = max_pool2d_plain(x, *geom)
        dy = torch.from_numpy(np.random.RandomState(3).standard_normal(
            tuple(idx.shape)).astype(np.float32) * 7).to(dtype)
        plain = max_pool2d_bwd_plain(dy, idx, geom, shape[2], shape[3])
        kern = _gather_like_the_kernel(dy, idx, geom, shape[2], shape[3],
                                       dtype)
        assert plain.dtype == dtype
        assert torch.equal(plain, kern), (shape, geom)


# -- K4: LRN backward ---------------------------------------------------------

LRN_BWD_CASES = [
    # shape, size, alpha, beta, k
    ((2, 8, 4, 6), 5, 1.0, 0.75, 1.0),
    ((2, 6, 5, 5), 5, 1e-4, 0.75, 1.0),     # Inception's parameters
    ((2, 7, 3, 5), 4, 1.0, 0.75, 2.0),      # odd C, even window
    ((1, 5, 4, 4), 4, 0.5, 0.5, 1.0),       # even window, beta 0.5
    ((1, 3, 4, 4), 5, 0.5, 0.5, 1.0),       # C < size
    ((1, 5, 3, 3), 3, 1.0, 1.0, 1.0),       # generic power
    ((2, 6, 3, 3), 4, 2.0, 1.0, 1.5),       # even window, generic power
]


@pytest.mark.parametrize("case", LRN_BWD_CASES,
                         ids=[f"case{i}" for i in range(len(LRN_BWD_CASES))])
def test_lrn_bwd_plain_matches_pallas_vjp_and_xla_grad(interpret, case):
    shape, size, alpha, beta, k = case
    rng = np.random.RandomState(4)
    x = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jlrn._lrn_pallas(t, size, alpha, beta, k),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    _, xla_vjp = jax.vjp(lambda t: jlrn._lrn_xla(t, size, alpha, beta, k),
                         jnp.asarray(x))
    (want_xla,) = xla_vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x)
    _, scale = lrn_plain(tx, size, alpha, beta, k)
    dx = lrn_bwd_plain(tx, scale, torch.from_numpy(dy), size, alpha, beta)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_xla), rtol=1e-5,
                               atol=1e-6)


class _PlainLRN(torch.autograd.Function):
    """The plain LRN forward/backward pair, for gradcheck."""

    @staticmethod
    def forward(ctx, x, size, alpha, beta, k):
        y, scale = lrn_plain(x, size, alpha, beta, k)
        ctx.save_for_backward(x, scale)
        ctx.params = (size, alpha, beta)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return lrn_bwd_plain(x, scale, dy, *ctx.params), None, None, None, \
            None


@pytest.mark.parametrize("size,alpha,beta,k", [(5, 1.0, 0.75, 1.0),
                                               (4, 0.5, 0.5, 2.0),
                                               (3, 1.0, 1.0, 1.0)],
                         ids=["beta0.75", "beta0.5-even", "beta1.0"])
def test_plain_lrn_pair_passes_gradcheck(size, alpha, beta, k):
    x = torch.from_numpy(np.random.RandomState(5).standard_normal(
        (2, 6, 3, 3))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t: _PlainLRN.apply(t, size, alpha, beta, k), (x,),
        eps=1e-6, atol=1e-6, rtol=1e-5)


def test_layers_in_training_mode_give_the_plain_backward():
    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, 5, 9, 9)).astype(np.float32)
    pool = tnn.SpatialMaxPooling(3, 3, 2, 2).ceil().training_()
    lrn = tnn.SpatialCrossMapLRN(5, 0.5, 0.75).training_()
    for layer in (pool, lrn):
        tx = torch.from_numpy(x).requires_grad_()
        y = layer(tx)
        g = torch.from_numpy(rng.standard_normal(tuple(y.shape))
                             .astype(np.float32))
        y.backward(g)
        if layer is pool:
            _, idx = max_pool2d_plain(torch.from_numpy(x), 3, 3, 2, 2, 0, 0,
                                      True)
            want = max_pool2d_bwd_plain(g, idx, (3, 3, 2, 2, 0, 0, True),
                                        9, 9)
        else:
            _, scale = lrn_plain(torch.from_numpy(x), 5, 0.5, 0.75, 1.0)
            want = lrn_bwd_plain(torch.from_numpy(x), scale, g, 5, 0.5, 0.75)
        assert torch.equal(tx.grad, want)


def test_pool_and_lrn_backward_take_a_strided_gradient():
    x = torch.randn(2, 3, 6, 6, generator=torch.Generator().manual_seed(0))
    for fn in (lambda t: max_pool2d(t, 2, 2, 2, 2), cross_map_lrn):
        a = x.clone().requires_grad_()
        y = fn(a)
        g = torch.randn(tuple(y.shape)[::-1]).permute(3, 2, 1, 0)
        assert not g.is_contiguous()
        y.backward(g)
        b = x.clone().requires_grad_()
        fn(b).backward(g.contiguous())
        assert torch.equal(a.grad, b.grad)


def test_saved_lrn_input_is_guarded_by_the_version_check():
    x = torch.randn(1, 4, 3, 3).requires_grad_()
    h = x * 1.0
    y = cross_map_lrn(h)
    h.add_(1.0)               # an in-place op on the saved input
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        y.sum().backward()


def test_inference_skips_the_saved_buffers():
    x = torch.randn(1, 4, 6, 6).requires_grad_()
    with torch.inference_mode():
        y = max_pool2d(x, 2, 2, 2, 2)
        z = cross_map_lrn(x)
    assert y.grad_fn is None and z.grad_fn is None
    assert max_pool2d(x, 2, 2, 2, 2).grad_fn is not None
    assert cross_map_lrn(x).grad_fn is not None


# -- criterion ---------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("size_average", [True, False], ids=["avg", "sum"])
def test_class_nll_matches_jax(weighted, size_average):
    rng = np.random.RandomState(7)
    lp = np.log(rng.dirichlet(np.ones(5), size=6)).astype(np.float32)
    t = rng.randint(1, 6, size=6).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 5).astype(np.float32) if weighted else None
    j = jnn.ClassNLLCriterion(w, size_average)
    c = tnn.ClassNLLCriterion(w, size_average)
    want = float(j.apply(jnp.asarray(lp), jnp.asarray(t)))
    got = float(c(torch.from_numpy(lp), torch.from_numpy(t)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # a single row takes the 1-D path
    np.testing.assert_allclose(
        float(c(torch.from_numpy(lp[2]), torch.tensor(t[2]))),
        float(j.apply(jnp.asarray(lp[2]), jnp.asarray(t[2]))), rtol=1e-6)


# -- SGD and its schedules ----------------------------------------------------

SGD_CASES = {
    "plain": dict(learning_rate=0.1),
    "wd": dict(learning_rate=0.1, weight_decay=0.01),
    "momentum-damp0": dict(learning_rate=0.1, momentum=0.9, dampening=0.0),
    "momentum-default-damp": dict(learning_rate=0.1, momentum=0.9,
                                  weight_decay=0.01),
    "nesterov": dict(learning_rate=0.1, momentum=0.9, dampening=0.0,
                     nesterov=True),
    "lr-decay": dict(learning_rate=0.1, learning_rate_decay=0.5,
                     momentum=0.5),
}


@pytest.mark.parametrize("name", list(SGD_CASES))
def test_sgd_update_matches_jax_over_five_steps(name):
    kw = SGD_CASES[name]
    rng = np.random.RandomState(8)
    shapes = [(3, 4), (4,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    j, t = jom.SGD(**kw), SGD(**kw)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p) for p in params]
    jst, tst = j.init_state(jp), t.init_state(tp)
    for step in range(5):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        cfg = {} if step % 2 else {"clr": -0.05 * (step + 1)}
        jp, jst = j.update([jnp.asarray(a) for a in g], jp, jst, JT(**cfg),
                           jnp.asarray(step, jnp.int32))
        tp, tst = t.update([torch.from_numpy(a) for a in g], tp, tst,
                           T(**cfg), step)
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-6)
        for a, b in zip(jst["velocity"], tst["velocity"]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-6)


def test_first_momentum_step_takes_the_gradient_itself():
    """With dampening left at its default (= momentum), a zero-initialised
    velocity would give (1 - damp) * g = 0.1 g at step 0."""
    t = SGD(learning_rate=1.0, momentum=0.9)
    p, g = [torch.zeros(3)], [torch.ones(3)]
    new, st = t.update(g, p, t.init_state(p), T(), 0)
    assert torch.equal(st["velocity"][0], g[0])
    assert torch.equal(new[0], -g[0])


@pytest.mark.parametrize("pair", [
    (jom.Default(), Default()), (jom.Poly(0.5, 7), Poly(0.5, 7)),
    (jom.Step(3, 0.5), Step(3, 0.5)), (jom.EpochStep(2, 0.1),
                                       EpochStep(2, 0.1))],
    ids=["Default", "Poly", "Step", "EpochStep"])
def test_learning_rate_schedules_match_jax(pair):
    j, t = pair
    for it in range(10):
        cfg = dict(learningRate=0.2, learningRateDecay=0.1)
        st = dict(evalCounter=it, epoch=1 + it // 3)
        assert t.current_rate(T(**cfg), T(**st)) == \
            j.current_rate(JT(**cfg), JT(**st))


def test_triggers_match_jax():
    states = [dict(epoch=e, neval=n, isLastBatchOfEpoch=last)
              for e, n, last in [(1, 0, False), (1, 1, False), (1, 2, True),
                                 (2, 3, False), (2, 4, True), (3, 5, False),
                                 (3, 6, False), (4, 9, True)]]
    for make in (lambda m: m.every_epoch(), lambda m: m.several_iteration(2),
                 lambda m: m.max_epoch(2), lambda m: m.max_iteration(5),
                 lambda m: m.and_(m.max_epoch(1), m.several_iteration(3)),
                 lambda m: m.or_(m.max_iteration(6), m.every_epoch())):
        j, t = make(JTrigger), make(Trigger)
        assert [t(T(**s)) for s in states] == [j(JT(**s)) for s in states]


def test_accuracies_match_jax():
    rng = np.random.RandomState(9)
    out = rng.standard_normal((12, 8)).astype(np.float32)
    tgt = rng.randint(1, 9, size=12).astype(np.float32)
    tgt[:3] = out[:3].argmax(1) + 1          # a few right answers
    for tm, jm in ((Top1Accuracy(), jval.Top1Accuracy()),
                   (Top5Accuracy(), jval.Top5Accuracy())):
        got = tm(torch.from_numpy(out), tgt)
        want = jm(out, tgt)
        assert (got.correct, got.count) == (want.correct, want.count)
        one = tm(torch.from_numpy(out[0]), tgt[0])
        assert (one.correct, one.count) == (1, 1)
    s = tval.AccuracyResult(3, 4) + tval.AccuracyResult(1, 4)
    assert s.result() == (0.5, 8)
    lr = tval.Loss(tnn.ClassNLLCriterion())(
        torch.log_softmax(torch.from_numpy(out), 1), tgt)
    jl = jval.Loss(jnn.ClassNLLCriterion())(
        np.asarray(jax.nn.log_softmax(out, axis=1)), tgt)
    np.testing.assert_allclose(lr.loss, jl.loss, rtol=1e-6)
    assert lr.count == jl.count == 12


# -- data feed ----------------------------------------------------------------

def test_local_array_dataset_shuffles_like_jax_for_three_epochs():
    items = list(range(11))
    j, t = JLocalArrayDataSet(items, seed=4), LocalArrayDataSet(items, seed=4)
    for _ in range(3):
        jit, tit = j.data(train=True), t.data(train=True)
        assert [next(tit) for _ in range(11)] == [next(jit)
                                                  for _ in range(11)]
        j.shuffle()
        t.shuffle()
    assert list(t.data(train=False)) == items


def test_sample_to_batch_stacks_and_keeps_the_tail():
    samples = [Sample(np.full((2, 2), i, np.float32), i + 1.0)
               for i in range(5)]
    batches = list(SampleToBatch(2)(iter(samples)))
    assert [b.size() for b in batches] == [2, 2, 1]
    assert batches[1].data.shape == (2, 2, 2)
    np.testing.assert_array_equal(batches[2].labels, [5.0])
    with pytest.raises(NotImplementedError, match="DistriOptimizer"):
        DataSet.array(samples, num_shards=2)


# -- Dropout ------------------------------------------------------------------

def test_dropout_draws_from_its_generator():
    x = torch.ones(200, 100)
    d = tnn.Dropout(0.4).training_()
    masks = []
    for _ in range(2):
        d.set_generator(torch.Generator().manual_seed(11))
        masks.append(d(x))
    assert torch.equal(masks[0], masks[1])
    y = masks[0]
    kept = (y != 0).float().mean().item()
    sigma = (0.6 * 0.4 / y.numel()) ** 0.5
    assert abs(kept - 0.6) < 3 * sigma
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.6))
    assert torch.equal(tnn.Dropout(0.4, scale=False).training_()
                       .set_generator(torch.Generator().manual_seed(11))(x),
                       (y != 0).float())
    assert torch.equal(d.evaluate()(x), x)


def test_dropout_without_a_generator_raises():
    d = tnn.Dropout(0.5).training_()
    with pytest.raises(ValueError, match="generator"):
        d(torch.ones(4))
    assert torch.equal(tnn.Dropout(0.0).training_()(torch.ones(4)),
                       torch.ones(4))


# -- the trainer's own rules --------------------------------------------------

def _lenet_samples(n, seed, nan_from=None):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 28, 28).astype(np.float32)
    if nan_from is not None:
        x[nan_from:] = np.nan
    y = rng.randint(1, 11, size=n).astype(np.float32)
    return [Sample(x[i], y[i]) for i in range(n)]


def _lenet_opt(samples, iters):
    opt = LocalOptimizer(LeNet5(10).reset(2), tnn.ClassNLLCriterion(),
                         DataSet.array(samples) >> SampleToBatch(4),
                         Trigger.max_iteration(iters), device="cpu")
    return opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9,
                                    dampening=0.0))


def test_non_finite_step_keeps_weights_and_velocity():
    """Batch 2 is NaN: after step 1 the weights and velocity are those of
    a one-step run, and one skipped step is counted."""
    one = _lenet_opt(_lenet_samples(8, 1, nan_from=4), 1)
    one.optimize()
    two = _lenet_opt(_lenet_samples(8, 1, nan_from=4), 2)
    two.optimize()
    assert two.state["skippedSteps"] == 1
    assert two.metrics.get(SKIPPED_STEPS) == 1
    assert two.state["neval"] == 2
    assert np.isnan(two.step_records[1]["loss"])
    assert np.isfinite(two.step_records[0]["loss"])
    for a, b in zip(one.model.param_leaves(), two.model.param_leaves()):
        assert torch.equal(a, b)
    for a, b in zip(one.opt_state["velocity"], two.opt_state["velocity"]):
        assert torch.equal(a, b) and torch.isfinite(a).all()


def test_trainer_validates_and_restores_training_mode():
    opt = _lenet_opt(_lenet_samples(8, 2), 4)
    val = DataSet.array(_lenet_samples(6, 3)) >> SampleToBatch(4)
    opt.set_validation(Trigger.several_iteration(2), val,
                       [Top1Accuracy(), Top5Accuracy()])
    opt.optimize()
    top1, top5 = opt.state["lastValidation"]
    assert top1.count == top5.count == 6 and top1.correct <= top5.correct
    assert opt.model.training
    assert [r.count for r in LocalValidator(opt.model, val, device="cpu")
            .test([Top1Accuracy()])] == [6]


@pytest.mark.parametrize("make", [
    lambda ds: LocalOptimizer(LeNet5(10), tnn.ClassNLLCriterion(), ds),
    lambda ds: Optimizer(LeNet5(10), ds, tnn.ClassNLLCriterion()),
    lambda ds: LocalValidator(LeNet5(10), ds),
], ids=["LocalOptimizer", "Optimizer", "LocalValidator"])
def test_entry_points_need_cuda_unless_asked_for_the_cpu(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: cuda is a valid default")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(DataSet.array(_lenet_samples(4, 0)))


def test_later_slices_raise_by_name():
    opt = _lenet_opt(_lenet_samples(4, 0), 1)
    # snapshots and resume came with the checkpoint slice
    # (tests/test_torch_port_checkpoint.py)
    with pytest.raises(NotImplementedError, match="slice of the port"):
        opt.set_mesh(None)
    # the watchdog and the summaries came with the host subsystems
    # (tests/test_torch_port_obs_hooks.py)
    assert opt.set_step_timeout(1.0) is opt and opt.step_timeout == 1.0
    assert opt.set_train_summary(None) is opt and opt.train_summary is None
    assert opt.set_val_summary(None) is opt and opt.val_summary is None
    with pytest.raises(NotImplementedError, match="DistriOptimizer"):
        Optimizer(LeNet5(10), DataSet.array(_lenet_samples(4, 0)),
                  tnn.ClassNLLCriterion(), device="cpu", compress="bf16")
    assert isinstance(Optimizer(LeNet5(10), DataSet.array(_lenet_samples(
        4, 0)), tnn.ClassNLLCriterion(), device="cpu"), LocalOptimizer)


def test_init_draws_stay_off_the_global_generator():
    torch.manual_seed(0)
    before = torch.get_rng_state()
    opt = _lenet_opt(_lenet_samples(8, 4), 2)
    opt.model = tnn.Sequential().add(tnn.Reshape([784])) \
        .add(tnn.Dropout(0.5)).add(tnn.Linear(784, 10,
                                              init_method=tinit.XAVIER)) \
        .add(tnn.LogSoftMax())
    opt.optimize()
    assert torch.equal(torch.get_rng_state(), before)
