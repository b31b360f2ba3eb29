"""The port's table, shape and distance layers (``bigdl_tpu_torch.nn``)
against the JAX package's.

Both sides get the same seeded numpy parameters (U(-1, 1), copied with
``load_jax_params``) and see the same numpy inputs.  Each case holds the
output and the gradients of the sum of the output times a seeded random
tensor, with respect to every floating input and every parameter, within
rtol 1e-5 / atol 1e-6 of ``jax.grad``'s (float32; sums in another order).
Integer-valued inputs put ``CMaxTable``/``CMinTable`` and ``Max``/``Min``
on ties, where the gradient splits evenly as JAX's does.  ``MaskedSelect``
is held forward only (the reference goes through host numpy and has no
gradient).  ``Cosine`` and ``Euclidean`` in a ``quantize_model("w8")``
copy agree with the reference on its eagerly packed tree within 1e-5.
The cases mirror ``tests/test_layers_misc.py:119-290`` and ``:389-393``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.ops import quant as jq
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.ops import quant

# the suite runs several pytest workers on one host: keep torch from
# taking every core inside each of them
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _draw(shapes, rng):
    return jax.tree_util.tree_map(
        lambda leaf: rng.uniform(-1.0, 1.0, leaf.shape).astype(np.float32),
        shapes)


def _is_float(v):
    return np.issubdtype(np.asarray(v).dtype, np.floating)


def _hold(make, x, seed=0, training=False, grads=True, scaled=False):
    """``make(tnn)`` against ``make(jnn)`` on the numpy tree ``x``; returns
    the port's layer and output.  With ``scaled`` each result's atol is
    ATOL times its largest magnitude (at least 1): for sums of many terms,
    where cancellation leaves a small result beside large ones."""

    def close(got, want):
        atol = ATOL * max(1.0, float(np.abs(want).max())) if scaled \
            else ATOL
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)

    jm, tm = make(jnn), make(tnn)
    shapes, state = jax.eval_shape(jm.init, jax.random.PRNGKey(seed))
    params = _draw(shapes, np.random.RandomState(seed))
    state = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   state)
    load_jax_params(tm, params)
    tm.train(training)
    leaves, treedef = jax.tree_util.tree_flatten(x)
    isf = [_is_float(v) for v in leaves]

    def run_jax(p, fl):
        it = iter(fl)
        xs = treedef.unflatten([next(it) if f else jnp.asarray(v)
                                for v, f in zip(leaves, isf)])
        return jm.apply(p, state, xs, training=training)[0]

    floats = [jnp.asarray(v) for v, f in zip(leaves, isf) if f]
    a = run_jax(params, floats)
    rng = np.random.RandomState(seed + 100)
    rs = [rng.standard_normal(np.shape(v)).astype(np.float32)
          for v in jax.tree_util.tree_leaves(a)]

    xt = [torch.from_numpy(np.array(v)).requires_grad_(f and grads)
          for v, f in zip(leaves, isf)]
    b = tm(treedef.unflatten(xt))
    got, want = jax.tree_util.tree_leaves(b), jax.tree_util.tree_leaves(a)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        close(g.detach().numpy(), np.asarray(w))
    if not grads:
        return tm, b

    def loss(p, fl):
        y = jax.tree_util.tree_leaves(run_jax(p, fl))
        return sum(jnp.sum(v * r) for v, r in zip(y, rs))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, floats)
    sum((v * torch.from_numpy(r)).sum() for v, r in zip(got, rs)).backward()
    gt = [t.grad if t.grad is not None else torch.zeros_like(t)
          for t, f in zip(xt, isf) if f]
    assert len(gt) == len(gx)
    for g, w in zip(gt, gx):
        close(g.numpy(), np.asarray(w))
    gparams = [p.grad.numpy() for p in tm.param_leaves()]
    want = jax.tree_util.tree_leaves(gp)
    assert len(gparams) == len(want)
    for g, w in zip(gparams, want):
        close(g, np.asarray(w))
    return tm, b


def _n(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


def _ints(seed, *shape):
    return np.random.RandomState(seed).randint(-2, 3, shape) \
        .astype(np.float32)


def _away(seed, *shape):
    """Values of magnitude 0.5-2 (denominators)."""
    rng = np.random.RandomState(seed)
    v = rng.uniform(0.5, 2.0, shape) * np.where(rng.rand(*shape) > 0.5, 1,
                                                -1)
    return v.astype(np.float32)


# (id, constructor over a namespace, input, training)
LAYERS = [
    # containers and table ops
    ("ParallelTable", lambda nn: nn.ParallelTable().add(nn.Linear(4, 3))
     .add(nn.MulConstant(3.0)), [_n(1, 2, 4), _n(2, 2, 5)], False),
    ("MapTable", lambda nn: nn.MapTable(nn.Linear(4, 3)),
     [_n(1, 2, 4), _n(2, 2, 4), _n(3, 2, 4)], False),
    ("MixtureTable", lambda nn: nn.MixtureTable(),
     [_n(1, 3, 2), [_n(2, 3, 4), _n(3, 3, 4)]], False),
    ("MixtureTable-3d", lambda nn: nn.MixtureTable(),
     [_n(1, 3, 3), [_n(2, 3, 5, 2), _n(3, 3, 5, 2), _n(4, 3, 5, 2)]],
     False),
    ("JoinTable-2", lambda nn: nn.JoinTable(2),
     [_n(1, 2, 3), _n(2, 2, 4)], False),
    ("JoinTable-batch", lambda nn: nn.JoinTable(1, 1),
     [_n(1, 2, 4), _n(2, 2, 4)], False),
    ("JoinTable-channels", lambda nn: nn.JoinTable(1, 3),
     [_n(1, 2, 3, 4, 4), _n(2, 2, 5, 4, 4), _n(3, 2, 2, 4, 4)], False),
    ("FlattenTable", lambda nn: nn.FlattenTable(),
     [_n(1, 2), [_n(2, 3), [_n(3, 4)]]], False),
    ("NarrowTable", lambda nn: nn.NarrowTable(2, 2),
     [_n(1, 2), _n(2, 3), _n(3, 4), _n(4, 5)], False),
    ("NarrowTable-negative", lambda nn: nn.NarrowTable(2, -1),
     [_n(1, 2), _n(2, 3), _n(3, 4), _n(4, 5)], False),
    ("SelectTable", lambda nn: nn.SelectTable(2),
     [_n(1, 2), _n(2, 3), _n(3, 4)], False),
    ("SelectTable-negative", lambda nn: nn.SelectTable(-1),
     [_n(1, 2), _n(2, 3), _n(3, 4)], False),
    ("CAddTable", lambda nn: nn.CAddTable(),
     [_n(1, 3, 3), _n(2, 3, 3), _n(3, 3, 3)], False),
    ("CSubTable", lambda nn: nn.CSubTable(), [_n(1, 3, 3), _n(2, 3, 3)],
     False),
    ("CMulTable", lambda nn: nn.CMulTable(),
     [_n(1, 3, 3), _n(2, 3, 3), _n(3, 3, 3)], False),
    ("CDivTable", lambda nn: nn.CDivTable(), [_n(1, 3, 3), _away(2, 3, 3)],
     False),
    ("CMaxTable-ties", lambda nn: nn.CMaxTable(),
     [_ints(1, 4, 5), _ints(2, 4, 5), _ints(3, 4, 5)], False),
    ("CMinTable-ties", lambda nn: nn.CMinTable(),
     [_ints(1, 4, 5), _ints(2, 4, 5)], False),
    ("Echo", lambda nn: nn.Echo(), [_n(1, 2, 3), _n(2, 4)], False),
    ("Copy", lambda nn: nn.Copy(), _n(1, 2, 3), False),
    ("Contiguous", lambda nn: nn.Contiguous(), _n(1, 2, 3), False),
    ("Bottle", lambda nn: nn.Bottle(nn.Linear(4, 2)), _n(1, 3, 5, 4),
     False),
    ("Bottle-4d", lambda nn: nn.Bottle(nn.Linear(4, 2), 2, 2),
     _n(1, 2, 3, 5, 4), False),
    # shape and reduction ops
    ("InferReshape", lambda nn: nn.InferReshape([0, -1]), _n(1, 4, 6),
     False),
    ("InferReshape-batch", lambda nn: nn.InferReshape([3, -1], True),
     _n(1, 2, 6, 2), False),
    ("Select", lambda nn: nn.Select(1, 2), _n(1, 3, 4, 5), False),
    ("Select-negative", lambda nn: nn.Select(2, -1), _n(1, 3, 4, 5), False),
    ("Select-negative-dim", lambda nn: nn.Select(-1, 3), _n(1, 3, 4, 5),
     False),
    ("Narrow", lambda nn: nn.Narrow(2, 2, 2), _n(1, 3, 4, 5), False),
    ("Narrow-negative", lambda nn: nn.Narrow(3, 2, -1), _n(1, 3, 4, 5),
     False),
    ("Squeeze", lambda nn: nn.Squeeze(2), _n(1, 3, 1, 5), False),
    ("Squeeze-all", lambda nn: nn.Squeeze(), _n(1, 3, 1, 5, 1), False),
    ("Squeeze-batch", lambda nn: nn.Squeeze(1, 2), _n(1, 3, 1, 5), False),
    ("Unsqueeze", lambda nn: nn.Unsqueeze(2), _n(1, 3, 4, 5), False),
    ("Unsqueeze-batch", lambda nn: nn.Unsqueeze(1, 2), _n(1, 3, 4, 5),
     False),
    ("Transpose", lambda nn: nn.Transpose([(1, 3)]), _n(1, 3, 4, 5), False),
    ("Transpose-two", lambda nn: nn.Transpose([(1, 2), (2, 3)]),
     _n(1, 3, 4, 5), False),
    ("Replicate", lambda nn: nn.Replicate(5), _n(1, 3, 4), False),
    ("Replicate-batch", lambda nn: nn.Replicate(3, 2, 1), _n(1, 2, 4),
     False),
    ("SpatialZeroPadding", lambda nn: nn.SpatialZeroPadding(1, 2, 0, 1),
     _n(1, 1, 2, 3, 3), False),
    ("SpatialZeroPadding-crop", lambda nn: nn.SpatialZeroPadding(
        -1, 0, 0, 0), _n(1, 1, 2, 3, 3), False),
    ("SpatialZeroPadding-defaults", lambda nn: nn.SpatialZeroPadding(
        2, -1), _n(1, 2, 4, 5), False),
    ("Index", lambda nn: nn.Index(1),
     [_n(1, 4, 5), np.array([1, 3, 3], np.int32)], False),
    ("Index-2d", lambda nn: nn.Index(2),
     [_n(1, 4, 5), np.array([[5, 1], [2, 2]], np.int32)], False),
    ("Max-ties", lambda nn: nn.Max(2), _ints(1, 4, 5), False),
    ("Min-ties", lambda nn: nn.Min(1), _ints(2, 4, 5), False),
    ("Max-batch", lambda nn: nn.Max(1, 1), _ints(3, 4, 5), False),
    ("Min-negative-dim", lambda nn: nn.Min(-1), _ints(4, 3, 4, 5), False),
    ("Mean", lambda nn: nn.Mean(2), _n(1, 4, 5), False),
    ("Mean-keepdim", lambda nn: nn.Mean(1, squeeze=False), _n(1, 4, 5),
     False),
    ("Sum", lambda nn: nn.Sum(1), _n(1, 4, 5), False),
    ("Sum-average-batch", lambda nn: nn.Sum(1, 1, size_average=True),
     _n(1, 4, 5), False),
    # distance layers
    ("Cosine", lambda nn: nn.Cosine(4, 6), _n(1, 3, 4), False),
    ("Cosine-1d", lambda nn: nn.Cosine(4, 6), _n(1, 4), False),
    ("Euclidean", lambda nn: nn.Euclidean(4, 6), _n(1, 3, 4), False),
    ("Euclidean-1d", lambda nn: nn.Euclidean(6, 3), _n(2, 6), False),
    ("CosineDistance", lambda nn: nn.CosineDistance(),
     [_n(1, 3, 4), _n(2, 3, 4)], False),
    ("DotProduct", lambda nn: nn.DotProduct(), [_n(1, 3, 4), _n(2, 3, 4)],
     False),
    ("PairwiseDistance", lambda nn: nn.PairwiseDistance(),
     [_n(1, 3, 4), _n(2, 3, 4)], False),
    ("PairwiseDistance-l1", lambda nn: nn.PairwiseDistance(1),
     [_n(1, 3, 4), _n(2, 3, 4)], False),
    ("MM", lambda nn: nn.MM(), [_n(1, 2, 3, 4), _n(2, 2, 4, 5)], False),
    ("MM-trans-a", lambda nn: nn.MM(trans_a=True),
     [_n(1, 2, 4, 3), _n(2, 2, 4, 5)], False),
    ("MM-trans-b-2d", lambda nn: nn.MM(trans_b=True),
     [_n(1, 3, 4), _n(2, 5, 4)], False),
    ("MV", lambda nn: nn.MV(), [_n(1, 2, 3, 4), _n(2, 2, 4)], False),
    ("MV-trans", lambda nn: nn.MV(trans=True),
     [_n(1, 2, 4, 3), _n(2, 2, 4)], False),
    ("MV-2d", lambda nn: nn.MV(), [_n(1, 3, 4), _n(2, 4)], False),
    ("L1Penalty-train", lambda nn: nn.L1Penalty(0.1), _ints(1, 3, 4), True),
    ("L1Penalty-train-average", lambda nn: nn.L1Penalty(0.3, True),
     _n(1, 3, 4), True),
    ("L1Penalty-eval", lambda nn: nn.L1Penalty(0.1), _n(1, 3, 4), False),
]


@pytest.mark.parametrize("make, x, training", [c[1:] for c in LAYERS],
                         ids=[c[0] for c in LAYERS])
def test_layer_forward_and_gradients_match_jax(make, x, training):
    _hold(make, x, seed=len(LAYERS), training=training)


def test_layer_parameters_take_the_reference_names_and_shapes():
    for name, make, _, _ in LAYERS:
        jm, tm = make(jnn), make(tnn)
        shapes, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        mine = jax.tree_util.tree_map(lambda v: v.shape, export_params(tm))
        theirs = jax.tree_util.tree_map(lambda v: v.shape, shapes)
        assert mine == theirs or (mine == () and theirs in ((), {})), name


def test_maptable_shares_one_child_and_its_parameters():
    tm, _ = _hold(lambda nn: nn.MapTable(nn.Linear(4, 2)),
                  [_n(1, 3, 4), _n(1, 3, 4)])
    out = tm([torch.from_numpy(_n(1, 3, 4))] * 2)
    assert torch.equal(out[0], out[1])
    assert len(tm.layers) == 1 and len(tm.param_tree()) == 1
    assert len(list(tm.parameters())) == 2
    # the shared weight's gradient is the sum over the table's entries
    lin = tm.layers[0]
    x1, x2 = _n(2, 3, 4), _n(3, 3, 4)
    lin.zero_grad()
    sum(y.sum() for y in tm([torch.from_numpy(x1), torch.from_numpy(x2)])) \
        .backward()
    torch.testing.assert_close(
        lin.weight.grad, torch.from_numpy(np.tile((x1 + x2).sum(0), (2, 1))))


def test_cmax_and_max_split_a_tie_evenly():
    a = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    b = torch.tensor([1.0, 0.0, 3.0], requires_grad=True)
    tnn.CMaxTable()([a, b]).sum().backward()
    assert a.grad.tolist() == [0.5, 1.0, 0.5]
    assert b.grad.tolist() == [0.5, 0.0, 0.5]
    x = torch.tensor([[2.0, 2.0, 1.0], [0.0, 0.0, 0.0]], requires_grad=True)
    tnn.Max(2)(x).sum().backward()
    third = 1.0 / 3.0
    torch.testing.assert_close(x.grad, torch.tensor(
        [[0.5, 0.5, 0.0], [third, third, third]]))
    x.grad = None
    tnn.Min(2)(x).sum().backward()
    torch.testing.assert_close(x.grad, torch.tensor(
        [[0.0, 0.0, 1.0], [third, third, third]]))


def test_l1_penalty_adds_its_sign_in_training_only():
    x = torch.tensor([-2.0, 0.0, 3.0], requires_grad=True)
    m = tnn.L1Penalty(0.25)
    y = m(x)
    assert torch.equal(y, x)
    y.sum().backward()
    assert x.grad.tolist() == [0.75, 1.0, 1.25]
    x.grad = None
    m.evaluate()(x).sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 1.0]


def test_masked_select_matches_the_reference_forward():
    x = _n(1, 4, 5)
    mask = (np.random.RandomState(2).rand(4, 5) > 0.4).astype(np.uint8)
    want, _ = jnn.MaskedSelect().apply((), (), [jnp.asarray(x),
                                                jnp.asarray(mask)])
    got = tnn.MaskedSelect()([torch.from_numpy(x), torch.from_numpy(mask)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_echo_prints_on_every_forward(capsys):
    m = tnn.Echo().set_name("probe")
    x = [torch.zeros(2, 3), torch.zeros(4)]
    for _ in range(2):
        assert m(x) is x
    assert capsys.readouterr().out == "probe: (2, 3); (4,)\n" * 2


def test_copy_and_contiguous():
    x = torch.arange(6.0).reshape(2, 3).t()
    c = tnn.Copy()(x)
    assert torch.equal(c, x) and c.data_ptr() != x.data_ptr()
    y = tnn.Contiguous()(x)
    assert torch.equal(y, x) and y.is_contiguous()


def test_distance_weights_are_drawn_as_the_reference_draws_them():
    for make in (tnn.Cosine, tnn.Euclidean):
        m = make(16, 5)
        bound = 1.0 / np.sqrt(16)
        w = m.weight.detach()
        assert w.shape == (5, 16) and w.abs().max() <= bound
        assert w.abs().max() > 0.8 * bound
        assert not torch.equal(m.reset(1).weight, make(16, 5).weight)


@pytest.mark.parametrize("make", [lambda nn: nn.Cosine(96, 64),
                                  lambda nn: nn.Euclidean(96, 64)],
                         ids=["Cosine", "Euclidean"])
def test_distance_layers_serve_from_a_w8_copy(make):
    jm, tm = make(jnn), make(tnn)
    shapes, state = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = _draw(shapes, np.random.RandomState(5))
    load_jax_params(tm, params)
    packed = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, params),
                                "w8")
    assert jq.is_quantized(packed["weight"])
    qm = quant.quantize_model(tm, "w8")
    assert quant.packed_weight(qm) is not None and qm.weight is None
    x = _n(6, 5, 96)
    want, _ = jm.apply(packed, (), jnp.asarray(x))
    got = qm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the copy serves a quantized weight, not the fp one
    fp, _ = jm.apply(params, (), jnp.asarray(x))
    assert np.abs(np.asarray(fp) - got.numpy()).max() > 1e-5
