"""The port's criterions (``bigdl_tpu_torch.nn``) against the JAX package's.

Both sides see the same seeded numpy inputs and targets.  Each case holds
``forward`` (the loss) and ``backward`` (the gradient of the loss with
respect to the input, a table's entries each) within rtol 1e-5 / atol
1e-6 of the reference's ``forward`` and ``jax.grad`` (float32; sums taken
in another order).  The cases mirror ``tests/test_criterions.py``, and add
integer-valued data that lands the hinge criterions, ``AbsCriterion``,
``L1Cost`` and the smooth L1 losses exactly on their kinks, where the
gradient must be JAX's (half at a ``jnp.maximum`` tie, slope +1 of
``jnp.abs`` at 0).  The three criterions that moved onto the ``Criterion``
base (``ClassNLLCriterion``, ``CrossEntropyCriterion``,
``TimeDistributedCriterion``) train through ``LocalOptimizer`` to the JAX
trainer's losses within rtol 1e-5 and its weights within atol 1e-5.
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
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Trigger as JTrigger
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.core import Criterion
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from tests.test_torch_port_training import jax_losses  # noqa: F401

# the suite runs several pytest workers on one host: keep torch from
# taking every core inside each of them
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda v: torch.from_numpy(np.asarray(v)),
                                  tree)


def _hold(jc, tc, x, t):
    """``tc`` against ``jc`` on input ``x`` and target ``t`` (numpy
    trees): the loss by ``forward`` and the input gradient by
    ``backward``."""
    want = jc.forward(_jax(x), _jax(t))
    got = tc.forward(_torch(x), _torch(t))
    assert isinstance(tc, Criterion)
    assert got.dim() == 0 and tc.output.grad_fn is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    gj = jc.backward(_jax(x), _jax(t))
    gt = tc.backward(_torch(x), _torch(t))
    assert tc.gradInput is gt
    jl, tl = jax.tree_util.tree_leaves(gj), jax.tree_util.tree_leaves(gt)
    assert len(jl) == len(tl) == len(jax.tree_util.tree_leaves(x))
    for a, b in zip(jl, tl):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)
    return got


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ints(rng, lo, hi, *shape):
    """Integer-valued float32 data: sums and differences land exactly on
    the criterions' kinks."""
    return rng.randint(lo, hi, size=shape).astype(np.float32)


def _labels(rng, classes, *shape):
    return rng.randint(1, classes + 1, size=shape).astype(np.float32)


def _signs(rng, *shape):
    return np.where(rng.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


def _logp(rng, n, c):
    x = _normal(rng, n, c)
    return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)


def _probs(rng, *shape):
    return np.clip(rng.rand(*shape), 0.01, 0.99).astype(np.float32)


def _dist(rng, n, c, zeros=True):
    p = rng.rand(n, c).astype(np.float32)
    if zeros:
        p[rng.rand(n, c) < 0.3] = 0.0
    return (p / np.maximum(p.sum(1, keepdims=True), 1e-3)).astype(np.float32)


def _multilabel(rng, n, d):
    """1-based label lists padded with 0; one row has a label after its
    first 0 (ignored), one row has none."""
    t = np.zeros((n, d), np.float32)
    for i in range(n):
        k = rng.randint(0, d)
        t[i, :k] = rng.permutation(d)[:k] + 1
    t[0, 0], t[0, 2] = 0, 3
    return t


# (id, constructor over a namespace, inputs (x, target) from a RandomState)
CASES = [
    ("ClassNLL", lambda nn: nn.ClassNLLCriterion(),
     lambda r: (_logp(r, 6, 5), _labels(r, 5, 6))),
    ("ClassNLL-sum", lambda nn: nn.ClassNLLCriterion(size_average=False),
     lambda r: (_logp(r, 6, 5), _labels(r, 5, 6))),
    ("ClassNLL-weights", lambda nn: nn.ClassNLLCriterion(
        weights=[1.0, 2.0, 0.5, 1.0, 3.0]),
     lambda r: (_logp(r, 6, 5), _labels(r, 5, 6))),
    ("ClassNLL-1d", lambda nn: nn.ClassNLLCriterion(),
     lambda r: (_logp(r, 1, 5)[0], np.float32(3))),
    ("CrossEntropy", lambda nn: nn.CrossEntropyCriterion(),
     lambda r: (_normal(r, 4, 5), _labels(r, 5, 4))),
    ("MSE", lambda nn: nn.MSECriterion(),
     lambda r: (_normal(r, 3, 4), _normal(r, 3, 4))),
    ("MSE-sum", lambda nn: nn.MSECriterion(size_average=False),
     lambda r: (_normal(r, 3, 4), _normal(r, 3, 4))),
    ("Abs", lambda nn: nn.AbsCriterion(),
     lambda r: (_normal(r, 3, 4), _normal(r, 3, 4))),
    ("Abs-kinks", lambda nn: nn.AbsCriterion(size_average=False),
     lambda r: (_ints(r, -2, 3, 5, 4), _ints(r, -2, 3, 5, 4))),
    ("BCE", lambda nn: nn.BCECriterion(),
     lambda r: (_probs(r, 4, 3), (r.rand(4, 3) > 0.5).astype(np.float32))),
    ("BCE-weights", lambda nn: nn.BCECriterion(
        weights=np.array([0.5, 1.0, 2.0], np.float32), size_average=False),
     lambda r: (_probs(r, 4, 3), (r.rand(4, 3) > 0.5).astype(np.float32))),
    ("DistKLDiv", lambda nn: nn.DistKLDivCriterion(),
     lambda r: (_logp(r, 3, 4), _dist(r, 3, 4))),
    ("DistKLDiv-1d", lambda nn: nn.DistKLDivCriterion(size_average=False),
     lambda r: (_logp(r, 1, 6)[0], _dist(r, 1, 6)[0])),
    ("Margin", lambda nn: nn.MarginCriterion(),
     lambda r: (_normal(r, 6), _signs(r, 6))),
    ("Margin-kinks", lambda nn: nn.MarginCriterion(margin=1.0),
     lambda r: (_ints(r, -2, 3, 12), _signs(r, 12))),
    ("SoftMargin", lambda nn: nn.SoftMarginCriterion(),
     lambda r: (_normal(r, 6), _signs(r, 6))),
    ("HingeEmbedding", lambda nn: nn.HingeEmbeddingCriterion(),
     lambda r: (_normal(r, 6), _signs(r, 6))),
    ("HingeEmbedding-kinks", lambda nn: nn.HingeEmbeddingCriterion(
        2.0, size_average=False),
     lambda r: (_ints(r, 0, 4, 12), _signs(r, 12))),
    ("MarginRanking", lambda nn: nn.MarginRankingCriterion(0.5),
     lambda r: ([_normal(r, 5), _normal(r, 5)], _signs(r, 5))),
    ("MarginRanking-table-target", lambda nn: nn.MarginRankingCriterion(),
     lambda r: ([_normal(r, 5), _normal(r, 5)],
                [_signs(r, 5), _signs(r, 5)])),
    ("MarginRanking-kinks", lambda nn: nn.MarginRankingCriterion(1.0),
     lambda r: ([_ints(r, -2, 3, 12), _ints(r, -2, 3, 12)], _signs(r, 12))),
    ("L1Cost", lambda nn: nn.L1Cost(),
     lambda r: (_ints(r, -2, 3, 4, 5), _normal(r, 4, 5))),
    ("L1HingeEmbedding-pos", lambda nn: nn.L1HingeEmbeddingCriterion(2.0),
     lambda r: ([_normal(r, 4), _normal(r, 4)], np.float32(1.0))),
    ("L1HingeEmbedding-neg", lambda nn: nn.L1HingeEmbeddingCriterion(100.0),
     lambda r: ([_normal(r, 4), _normal(r, 4)], np.float32(-1.0))),
    ("L1HingeEmbedding-kink", lambda nn: nn.L1HingeEmbeddingCriterion(4.0),
     lambda r: ([np.array([1, 0, 2, 0], np.float32),
                 np.array([0, 0, 1, 1], np.float32)], np.float32(-1.0))),
    ("SmoothL1", lambda nn: nn.SmoothL1Criterion(),
     lambda r: (np.array([0.2, 2.0, -3.0, 1.0, 0.0], np.float32),
                np.array([0.0, 0.0, 0.0, 0.0, 0.0], np.float32))),
    ("SmoothL1-sum", lambda nn: nn.SmoothL1Criterion(size_average=False),
     lambda r: (_normal(r, 3, 4) * 2, _normal(r, 3, 4))),
    ("SmoothL1WithWeights", lambda nn: nn.SmoothL1CriterionWithWeights(
        1.0, num=2),
     lambda r: (np.array([0.2, 2.0], np.float32),
                [np.zeros(2, np.float32), np.array([1.0, 0.5], np.float32),
                 np.array([2.0, 1.0], np.float32)])),
    ("SmoothL1WithWeights-sigma", lambda nn: nn.SmoothL1CriterionWithWeights(
        3.0),
     lambda r: (_normal(r, 6, 8),
                [_normal(r, 6, 8), (r.rand(6, 8) > 0.5).astype(np.float32),
                 r.rand(6, 8).astype(np.float32)])),
    ("MultiMargin", lambda nn: nn.MultiMarginCriterion(),
     lambda r: (_normal(r, 5, 4), _labels(r, 4, 5))),
    ("MultiMargin-p2-weights", lambda nn: nn.MultiMarginCriterion(
        2, weights=np.array([1.0, 0.5, 2.0, 1.5], np.float32), margin=0.7),
     lambda r: (_normal(r, 5, 4), _labels(r, 4, 5))),
    ("MultiMargin-1d", lambda nn: nn.MultiMarginCriterion(),
     lambda r: (np.array([0.1, 0.5, 0.3], np.float32), np.float32(2))),
    ("MultiMargin-kinks", lambda nn: nn.MultiMarginCriterion(
        size_average=False),
     lambda r: (_ints(r, -2, 3, 8, 5), _labels(r, 5, 8))),
    ("MultiLabelMargin", lambda nn: nn.MultiLabelMarginCriterion(),
     lambda r: (_normal(r, 5, 6), _multilabel(r, 5, 6))),
    ("MultiLabelMargin-1d", lambda nn: nn.MultiLabelMarginCriterion(),
     lambda r: (np.array([0.1, 0.2, 0.4, 0.8], np.float32),
                np.array([4, 1, 0, 0], np.float32))),
    ("MultiLabelMargin-kinks", lambda nn: nn.MultiLabelMarginCriterion(
        size_average=False),
     lambda r: (_ints(r, -2, 3, 6, 5), _multilabel(r, 6, 5))),
    ("MultiLabelSoftMargin", lambda nn: nn.MultiLabelSoftMarginCriterion(),
     lambda r: (_normal(r, 4, 3), (r.rand(4, 3) > 0.5).astype(np.float32))),
    ("MultiLabelSoftMargin-weights", lambda nn:
     nn.MultiLabelSoftMarginCriterion(
         weights=np.array([0.5, 1.0, 2.0], np.float32), size_average=False),
     lambda r: (_normal(r, 4, 3), (r.rand(4, 3) > 0.5).astype(np.float32))),
    ("CosineEmbedding", lambda nn: nn.CosineEmbeddingCriterion(0.1),
     lambda r: ([_normal(r, 6, 4), _normal(r, 6, 4)], _signs(r, 6))),
    ("CosineEmbedding-1d", lambda nn: nn.CosineEmbeddingCriterion(
        0.5, size_average=False),
     lambda r: ([_normal(r, 4), _normal(r, 4)], np.float32(-1.0))),
    ("ClassSimplex", lambda nn: nn.ClassSimplexCriterion(5),
     lambda r: (_normal(r, 4, 5), _labels(r, 5, 4))),
    ("Parallel", lambda nn: nn.ParallelCriterion().add(
        nn.MSECriterion(), 0.5).add(nn.AbsCriterion(), 2.0),
     lambda r: ([_normal(r, 3, 4), _normal(r, 3, 4)],
                [_normal(r, 3, 4), _normal(r, 3, 4)])),
    ("Parallel-repeat-target", lambda nn: nn.ParallelCriterion(True).add(
        nn.MSECriterion()).add(nn.SmoothL1Criterion(), 0.3),
     lambda r: ([_normal(r, 3, 4), _normal(r, 3, 4)], _normal(r, 3, 4))),
    ("Multi", lambda nn: nn.MultiCriterion().add(nn.MSECriterion()).add(
        nn.AbsCriterion(), 0.1),
     lambda r: (_normal(r, 3, 4), _normal(r, 3, 4))),
    ("SoftmaxWith-4d", lambda nn: nn.SoftmaxWithCriterion(),
     lambda r: (_normal(r, 2, 3, 2, 2), _labels(r, 3, 2, 2, 2))),
    ("SoftmaxWith-2d", lambda nn: nn.SoftmaxWithCriterion(),
     lambda r: (_normal(r, 8, 5), _labels(r, 5, 8))),
    ("SoftmaxWith-n1hw", lambda nn: nn.SoftmaxWithCriterion(
        normalize_mode="FULL"),
     lambda r: (_normal(r, 2, 3, 2, 3), _labels(r, 3, 2, 1, 2, 3))),
    ("SoftmaxWith-ignore", lambda nn: nn.SoftmaxWithCriterion(
        ignore_label=2),
     lambda r: (_normal(r, 2, 4, 3, 3), _labels(r, 4, 2, 3, 3))),
    ("SoftmaxWith-ignore-all", lambda nn: nn.SoftmaxWithCriterion(
        ignore_label=1),
     lambda r: (_normal(r, 3, 4), np.ones(3, np.float32))),
    ("SoftmaxWith-batch-size", lambda nn: nn.SoftmaxWithCriterion(
        ignore_label=3, normalize_mode="BATCH_SIZE"),
     lambda r: (_normal(r, 2, 4, 3, 3), _labels(r, 4, 2, 3, 3))),
    ("SoftmaxWith-full", lambda nn: nn.SoftmaxWithCriterion(
        ignore_label=3, normalize_mode="FULL"),
     lambda r: (_normal(r, 2, 4, 3, 3), _labels(r, 4, 2, 3, 3))),
    ("SoftmaxWith-none", lambda nn: nn.SoftmaxWithCriterion(
        ignore_label=3, normalize_mode="NONE"),
     lambda r: (_normal(r, 2, 4, 3, 3), _labels(r, 4, 2, 3, 3))),
    ("CriterionTable", lambda nn: nn.CriterionTable(nn.MSECriterion()),
     lambda r: (_normal(r, 3, 4), _normal(r, 3, 4))),
    ("TimeDistributed-MSE", lambda nn: nn.TimeDistributedCriterion(
        nn.MSECriterion(), size_average=True),
     lambda r: (_normal(r, 2, 3, 4), _normal(r, 2, 3, 4))),
    ("TimeDistributed-NLL", lambda nn: nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion()),
     lambda r: (np.stack([_logp(r, 3, 5) for _ in range(4)], 1),
                _labels(r, 5, 3, 4))),
    ("TimeDistributed-table", lambda nn: nn.TimeDistributedCriterion(
        nn.MSECriterion(), size_average=True),
     lambda r: ([_normal(r, 2, 4), _normal(r, 2, 4), _normal(r, 2, 4)],
                [_normal(r, 2, 4), _normal(r, 2, 4), _normal(r, 2, 4)])),
    ("TimeDistributed-table-sum", lambda nn: nn.TimeDistributedCriterion(
        nn.CrossEntropyCriterion()),
     lambda r: ([_normal(r, 3, 5), _normal(r, 3, 5)],
                [_labels(r, 5, 3), _labels(r, 5, 3)])),
]


@pytest.mark.parametrize("make, inputs", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_criterion_forward_and_backward_match_jax(make, inputs):
    x, t = inputs(np.random.RandomState(3))
    _hold(make(jnn), make(tnn), x, t)


def test_criterion_table_takes_the_table_input():
    rng = np.random.RandomState(4)
    x, t = _normal(rng, 3, 4), _normal(rng, 3, 4)
    jc, tc = jnn.CriterionTable(jnn.AbsCriterion()), \
        tnn.CriterionTable(tnn.AbsCriterion())
    want = jc.forward([jnp.asarray(x), jnp.asarray(t)], None)
    got = tc.forward([torch.from_numpy(x), torch.from_numpy(t)], None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_kink_cases_land_on_their_kinks():
    """The integer data of the ``-kinks`` cases puts some terms exactly on
    a hinge or at |0|, so those cases hold JAX's gradient there."""
    rng = np.random.RandomState(3)
    x, y = dict((c[0], c[2]) for c in CASES)["Margin-kinks"](rng)
    assert (1.0 - x * y == 0).any()
    rng = np.random.RandomState(3)
    x, t = dict((c[0], c[2]) for c in CASES)["Abs-kinks"](rng)
    assert (x == t).any()
    rng = np.random.RandomState(3)
    (a, b), y = dict((c[0], c[2]) for c in CASES)["MarginRanking-kinks"](rng)
    assert (-y * (a - b) + 1.0 == 0).any()
    # a tie gets half of each side's gradient, as jnp.maximum gives
    g = tnn.MarginCriterion(size_average=False).backward(
        torch.tensor([1.0, 2.0, 0.0]), torch.tensor([1.0, 1.0, 1.0]))
    assert g.tolist() == [-0.5, 0.0, -1.0]
    g = tnn.AbsCriterion(size_average=False).backward(
        torch.tensor([1.0, 2.0]), torch.tensor([1.0, 3.0]))
    assert g.tolist() == [1.0, -1.0]


def test_class_simplex_is_a_regular_simplex():
    s = tnn.ClassSimplexCriterion(5).simplex.numpy()
    np.testing.assert_allclose((s ** 2).sum(1), np.ones(5), rtol=1e-4)
    off = (s @ s.T)[~np.eye(5, dtype=bool)]
    np.testing.assert_allclose(off, off[0], atol=1e-5)
    np.testing.assert_array_equal(
        s, np.asarray(jnn.ClassSimplexCriterion(5).simplex))


def test_multimargin_refuses_other_p():
    with pytest.raises(ValueError, match="p must be 1 or 2"):
        tnn.MultiMarginCriterion(p=3)


def test_clone_criterion_is_independent():
    c = tnn.ParallelCriterion().add(tnn.MSECriterion(), 0.5)
    d = c.clone_criterion()
    d.add(tnn.AbsCriterion())
    assert len(c.criterions) == 1 and len(d.criterions) == 2


def test_forward_keeps_a_detached_output_and_returns_the_graph():
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    c = tnn.MSECriterion()
    loss = c(x, torch.zeros(3, 4))
    assert loss.requires_grad and c.output.grad_fn is None
    assert torch.equal(c.output, loss.detach())
    loss.backward()
    torch.testing.assert_close(x.grad, 2 * x.detach() / 12)


# -- the criterions on the base, through the trainer --------------------------

def _seq_model(nn, d, c):
    return nn.Sequential().add(nn.Linear(d, c)).add(nn.LogSoftMax())


TRAINED = [
    ("ClassNLL", lambda nn: nn.ClassNLLCriterion(), _seq_model, (6,), ()),
    ("CrossEntropy", lambda nn: nn.CrossEntropyCriterion(),
     lambda nn, d, c: nn.Sequential().add(nn.Linear(d, c)), (6,), ()),
    ("TimeDistributed", lambda nn: nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion(), size_average=True), _seq_model, (3, 6),
     (3,)),
]


@pytest.mark.parametrize("make_crit, make_model, shape, label_shape",
                         [c[1:] for c in TRAINED],
                         ids=[c[0] for c in TRAINED])
def test_criterions_on_the_base_train_as_before(jax_losses, make_crit,  # noqa: F811
                                                make_model, shape,
                                                label_shape):
    classes, n, batch, iters = 4, 24, 8, 4
    rng = np.random.RandomState(5)
    xs = rng.standard_normal((n,) + shape).astype(np.float32)
    ys = rng.randint(1, classes + 1, (n,) + label_shape).astype(np.float32)
    jm, tm = make_model(jnn, 6, classes), make_model(tnn, 6, classes)
    jm.build(seed=2)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    jopt = JLocalOptimizer(
        jm, make_crit(jnn), JDataSet.array(
            [JSample(xs[i], ys[i]) for i in range(n)]) >>
        JSampleToBatch(batch), JTrigger.max_iteration(iters))
    topt = LocalOptimizer(
        tm, make_crit(tnn), DataSet.array(
            [Sample(xs[i], ys[i]) for i in range(n)]) >>
        SampleToBatch(batch), Trigger.max_iteration(iters), device="cpu")
    jopt.set_optim_method(JSGD(learning_rate=0.5, momentum=0.9))
    topt.set_optim_method(SGD(learning_rate=0.5, momentum=0.9))
    jopt.optimize()
    topt.optimize()
    tl = [r["loss"] for r in topt.step_records]
    assert len(tl) == len(jax_losses) == iters
    np.testing.assert_allclose(tl, jax_losses, rtol=1e-5)
    assert topt.criterion.output.grad_fn is None
    for a, b in zip(jax.tree_util.tree_leaves(jm.params),
                    jax.tree_util.tree_leaves(export_params(tm))):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-5)
