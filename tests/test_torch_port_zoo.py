"""The rest of the activation and linear layers, AlexNet, VGG and the
autoencoder of the port (``bigdl_tpu_torch``) against the JAX package.

Both sides get the same seeded numpy parameters, copied with
``load_jax_params``, and see the same numpy inputs.  Tolerances: each
layer's output and its gradients (input and parameters, of the sum of the
output times a seeded random tensor) within rtol 1e-5 / atol 1e-6 of
``jax.grad``'s (float32; elementwise ops and short sums in another
order); ``RReLU`` in eval and ``GradientReversal``'s gradient exactly; the
full-width AlexNet, AlexNet-OWT and VGG-16 eval log-probabilities within
atol 1e-3 (as the full Inception-v1 in ``test_torch_port_models.py``),
with equal argmax; the CIFAR VGG's running statistics and eval output
within rtol / atol 1e-4 (BatchNorm's batch moments summed in another
order), its training output at batch 2 against the reference's own
rounding floor (see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.alexnet import AlexNet as JAlexNet
from bigdl_tpu.models.alexnet import AlexNet_OWT as JAlexNet_OWT
from bigdl_tpu.models.autoencoder import Autoencoder as JAutoencoder
from bigdl_tpu.models.vgg import Vgg_16 as JVgg_16
from bigdl_tpu.models.vgg import Vgg_19 as JVgg_19
from bigdl_tpu.models.vgg import VggForCifar10 as JVggForCifar10
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.convert import (export_params, export_state,
                                     load_jax_params, load_jax_state)
from bigdl_tpu_torch.core.module import get_named_modules
from bigdl_tpu_torch.models import (AlexNet, AlexNet_OWT, Autoencoder,
                                    Vgg_16, Vgg_19, VggForCifar10)

# the suite runs several pytest workers on one host: keep torch from
# taking every core inside each of them
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _draw(shapes, rng, low=-1.0, high=1.0):
    return jax.tree_util.tree_map(
        lambda leaf: rng.uniform(low, high, leaf.shape).astype(np.float32),
        shapes)


def _layer_pair(make, seed):
    """``make(jnn)`` and ``make(tnn)`` with the same seeded parameters
    (U(-1, 1)); returns (jax layer, its params, port layer)."""
    jm, tm = make(jnn), make(tnn)
    shapes, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(seed))
    params = _draw(shapes, np.random.RandomState(seed))
    load_jax_params(tm, params)
    return jm, params, tm


def _inputs(kind, shape, rng):
    if kind == "table":
        return [rng.standard_normal((4, 5)).astype(np.float32),
                rng.standard_normal((4, 3)).astype(np.float32)]
    if kind == "positive":
        return rng.uniform(0.5, 3.0, shape).astype(np.float32)
    return (rng.standard_normal(shape) * 2.5).astype(np.float32)


# (id, builder over a namespace, input kind, input shape)
LAYERS = [
    ("ReLU6", lambda nn: nn.ReLU6(), "normal", (4, 6)),
    ("LeakyReLU", lambda nn: nn.LeakyReLU(0.2), "normal", (4, 6)),
    ("PReLU-shared", lambda nn: nn.PReLU(), "normal", (4, 6)),
    ("PReLU-channels", lambda nn: nn.PReLU(3), "normal", (2, 3, 4, 5)),
    ("PReLU-1d", lambda nn: nn.PReLU(5), "normal", (5,)),
    ("RReLU-eval", lambda nn: nn.RReLU(0.1, 0.4), "normal", (4, 6)),
    ("ELU", lambda nn: nn.ELU(0.7), "normal", (4, 6)),
    ("TanhShrink", lambda nn: nn.TanhShrink(), "normal", (4, 6)),
    ("Sigmoid", lambda nn: nn.Sigmoid(), "normal", (4, 6)),
    ("LogSigmoid", lambda nn: nn.LogSigmoid(), "normal", (4, 6)),
    ("SoftMax-1d", lambda nn: nn.SoftMax(), "normal", (7,)),
    ("SoftMax-2d", lambda nn: nn.SoftMax(), "normal", (4, 6)),
    ("SoftMax-3d", lambda nn: nn.SoftMax(), "normal", (3, 4, 5)),
    ("SoftMin-4d", lambda nn: nn.SoftMin(), "normal", (2, 3, 4, 5)),
    ("SoftPlus", lambda nn: nn.SoftPlus(2.0), "normal", (4, 6)),
    ("SoftSign", lambda nn: nn.SoftSign(), "normal", (4, 6)),
    ("SoftShrink", lambda nn: nn.SoftShrink(0.3), "normal", (4, 6)),
    ("HardShrink", lambda nn: nn.HardShrink(0.3), "normal", (4, 6)),
    ("HardTanh", lambda nn: nn.HardTanh(-0.5, 0.8), "normal", (4, 6)),
    ("Clamp", lambda nn: nn.Clamp(-1, 2), "normal", (4, 6)),
    ("Threshold", lambda nn: nn.Threshold(0.1, -2.0), "normal", (4, 6)),
    ("Threshold-vgg", lambda nn: nn.Threshold(0, 1e-6), "normal", (4, 6)),
    ("Power", lambda nn: nn.Power(2.5, 0.5, 1.0), "positive", (4, 6)),
    ("Power-square", lambda nn: nn.Power(2), "normal", (4, 6)),
    ("Sqrt", lambda nn: nn.Sqrt(), "positive", (4, 6)),
    ("Square", lambda nn: nn.Square(), "normal", (4, 6)),
    ("Abs", lambda nn: nn.Abs(), "normal", (4, 6)),
    ("Exp", lambda nn: nn.Exp(), "normal", (4, 6)),
    ("Log", lambda nn: nn.Log(), "positive", (4, 6)),
    ("GradientReversal", lambda nn: nn.GradientReversal(0.7), "normal",
     (4, 6)),
    ("Add", lambda nn: nn.Add(6), "normal", (4, 6)),
    ("AddConstant", lambda nn: nn.AddConstant(1.5), "normal", (4, 6)),
    ("Bilinear", lambda nn: nn.Bilinear(5, 3, 4), "table", None),
    ("Bilinear-no-bias", lambda nn: nn.Bilinear(5, 3, 4, bias_res=False),
     "table", None),
    ("CAdd-vector", lambda nn: nn.CAdd((6,)), "normal", (4, 6)),
    ("CAdd-channels", lambda nn: nn.CAdd((3, 1, 1)), "normal", (2, 3, 4, 5)),
    ("CMul-channels", lambda nn: nn.CMul((3, 1, 1)), "normal", (2, 3, 4, 5)),
    ("CMul-full", lambda nn: nn.CMul((4, 6)), "normal", (4, 6)),
    ("Mul", lambda nn: nn.Mul(), "normal", (4, 6)),
    ("MulConstant", lambda nn: nn.MulConstant(-0.5), "normal", (4, 6)),
    ("Scale", lambda nn: nn.Scale((3, 1, 1)), "normal", (2, 3, 4, 5)),
]


@pytest.mark.parametrize("make, kind, shape", [c[1:] for c in LAYERS],
                         ids=[c[0] for c in LAYERS])
def test_layer_forward_and_gradients_match_jax(make, kind, shape):
    jm, params, tm = _layer_pair(make, seed=len(str(shape)))
    tm.evaluate()
    rng = np.random.RandomState(7)
    x = _inputs(kind, shape, rng)
    a, _ = jm.apply(params, (), jax.tree_util.tree_map(jnp.asarray, x))
    r = rng.standard_normal(np.shape(a)).astype(np.float32)

    def loss(p, v):
        y, _ = jm.apply(p, (), v)
        return jnp.sum(y * r)
    gp, gx = jax.grad(loss, argnums=(0, 1))(
        params, jax.tree_util.tree_map(jnp.asarray, x))

    xt = jax.tree_util.tree_map(
        lambda v: torch.from_numpy(v).requires_grad_(True), x)
    b = tm(xt)
    assert b.shape == a.shape and b.dtype == torch.float32
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=RTOL,
                               atol=ATOL)
    (b * torch.from_numpy(r)).sum().backward()
    for got, want in zip(jax.tree_util.tree_leaves(xt),
                         jax.tree_util.tree_leaves(gx)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    got = [p.grad.numpy() for p in tm.param_leaves()]
    want = jax.tree_util.tree_leaves(gp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


def test_layer_parameters_take_the_reference_names_and_shapes():
    for name, make, _, _ in LAYERS:
        jm, tm = make(jnn), make(tnn)
        shapes, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        mine = jax.tree_util.tree_map(lambda v: v.shape, export_params(tm))
        theirs = jax.tree_util.tree_map(lambda v: v.shape, shapes)
        assert mine == theirs or (mine == () and theirs in ((), {})), name
    assert tnn.PReLU(4).weight.tolist() == [0.25] * 4
    assert tnn.PReLU().weight.shape == (1,)


def test_rrelu_eval_is_the_mean_slope_exactly():
    x = _inputs("normal", (5, 7), np.random.RandomState(3))
    jm, tm = jnn.RReLU(0.1, 0.3), tnn.RReLU(0.1, 0.3).evaluate()
    a, _ = jm.apply((), (), jnp.asarray(x), training=False)
    b = tm(torch.from_numpy(x))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    neg = x < 0
    np.testing.assert_array_equal(b.numpy()[neg], (x * np.float32(0.2))[neg])


def test_rrelu_training_draws_its_slopes_from_the_handed_generator():
    lower, upper = 0.1, 0.3
    x = _inputs("normal", (64, 32), np.random.RandomState(4))
    xt = torch.from_numpy(x)
    tm = tnn.RReLU(lower, upper).training_()
    with pytest.raises(ValueError, match="generator"):
        tm(xt)
    outs = []
    for seed in (5, 5, 6):
        tm.set_generator(torch.Generator().manual_seed(seed))
        outs.append(tm(xt))
    y = outs[0].numpy()
    neg = x < 0
    np.testing.assert_array_equal(y[~neg], x[~neg])
    slopes = y[neg] / x[neg]
    assert slopes.min() >= lower - 1e-6 and slopes.max() <= upper + 1e-6
    # spread over the range, not one slope
    assert slopes.std() > 0.04 and len(np.unique(slopes)) > 100
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    # the draw is the generator's: the same stream by hand gives it
    a = torch.rand(x.shape, generator=torch.Generator().manual_seed(5))
    want = torch.where(xt >= 0, xt, xt * (lower + (upper - lower) * a))
    assert torch.equal(outs[0], want)


def test_gradient_reversal_returns_minus_lambda_times_the_gradient():
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    for lam in (1.0, 0.25, -2.0):
        xr = x.clone().requires_grad_(True)
        y = tnn.GradientReversal(lam)(xr)
        assert torch.equal(y, x)
        y.backward(g)
        assert torch.equal(xr.grad, -lam * g)


# -- models ------------------------------------------------------------------

def _xavier_tree(shapes, rng):
    """Xavier-uniform weights of rank >= 2, small uniform vectors."""
    def draw(leaf):
        shape = leaf.shape
        if len(shape) >= 2:
            field = int(np.prod(shape[2:]))
            bound = np.sqrt(6.0 / ((shape[0] + shape[1]) * field))
        else:
            bound = 0.05
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    return jax.tree_util.tree_map(draw, shapes)


def _model_pair(jmodel, tmodel, seed):
    params, state = jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed))
    jmodel.params = _xavier_tree(params, np.random.RandomState(seed))
    jmodel.state = state
    load_jax_params(tmodel, jmodel.params)
    return jmodel, tmodel


@pytest.mark.parametrize("which", ["alexnet", "alexnetowt", "vgg16"])
def test_full_width_eval_forward_matches_jax(which):
    jm, tm, size = {"alexnet": (JAlexNet(1000), AlexNet(1000), 227),
                    "alexnetowt": (JAlexNet_OWT(1000), AlexNet_OWT(1000),
                                   224),
                    "vgg16": (JVgg_16(1000), Vgg_16(1000), 224)}[which]
    _model_pair(jm, tm, seed=21)
    x = np.random.RandomState(21).standard_normal((1, 3, size, size)) \
        .astype(np.float32)
    a = np.asarray(jax.jit(lambda p, s, v: jm.apply(
        p, s, v, training=False)[0])(jm.params, jm.state, jnp.asarray(x)))
    ops.reset_launches()
    with torch.inference_mode():
        b = tm.evaluate()(torch.from_numpy(x)).numpy()
    assert b.shape == (1, 1000) and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=1e-3)
    assert b.argmax() == a.argmax()
    # on the CPU every wrapper took its plain version
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)


def test_alexnet_layer_names_and_groups_follow_the_caffe_layout():
    m = AlexNet(1000)
    named = get_named_modules(m)
    for name in ("conv1", "norm1", "pool1", "conv2", "norm2", "pool2",
                 "conv5", "pool5", "fc6", "drop6", "fc7", "drop7", "fc8",
                 "loss"):
        assert name in named
    assert [named[k].n_group for k in ("conv1", "conv2", "conv3", "conv4",
                                       "conv5")] == [1, 2, 1, 2, 2]
    assert named["conv1"].propagate_back is False
    assert named["drop6"].p == 0.5 and named["norm1"].size == 5
    owt = get_named_modules(AlexNet_OWT(10, has_dropout=False))
    assert "drop6" not in owt and "fc8" in owt
    assert not any(isinstance(x, tnn.SpatialCrossMapLRN)
                   for x in AlexNet_OWT().modules())


@pytest.mark.parametrize("build", [(JVgg_19, Vgg_19, 1000),
                                   (JVggForCifar10, VggForCifar10, 10)],
                         ids=["vgg19", "cifar"])
def test_vgg_parameter_and_state_trees_match_the_reference(build):
    jcls, tcls, classes = build
    jm, tm = jcls(classes), tcls(classes)
    params, state = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    for mine, theirs in ((export_params(tm), params),
                         (export_state(tm), state)):
        assert jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.shape, mine)) == \
            jax.tree_util.tree_structure(
                jax.tree_util.tree_map(lambda v: v.shape, theirs))
        assert [np.shape(v) for v in jax.tree_util.tree_leaves(mine)] == \
            [v.shape for v in jax.tree_util.tree_leaves(theirs)]
    pools = [m for m in tm.modules() if isinstance(m, tnn.SpatialMaxPooling)]
    assert len(pools) == 5
    assert all(p.ceil_mode == (classes == 10) for p in pools)


def _bn_leaf(path, leaf, rng):
    name = getattr(path[-1], "key", None) if path else None
    if name == "running_mean":
        return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)
    if name == "running_var" or (name == "weight" and len(leaf.shape) == 1):
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
    if len(leaf.shape) >= 2:
        field = int(np.prod(leaf.shape[2:]))
        bound = np.sqrt(6.0 / ((leaf.shape[0] + leaf.shape[1]) * field))
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
    return rng.uniform(-0.05, 0.05, leaf.shape).astype(np.float32)


def test_vgg_for_cifar10_training_forward_moves_the_statistics_as_jax():
    """A training forward at batch 2 (the dropout layers set to p 0 on
    both sides: their masks come from different generators), then an eval
    forward on the moved statistics.  The running statistics and the eval
    log-probs agree within 1e-4.  The training output is ill-conditioned
    at batch 2 (the last BatchNorm normalises two rows, so a 1e-7 relative
    change of the input moves the reference's own output by up to 2e-3):
    it is held within 4 times the reference's distance from itself under
    two such changes, never tighter than 1e-4, as ``chip_smoke.py`` holds
    the card against the CPU after an update."""
    jm, tm = JVggForCifar10(10), VggForCifar10(10)
    rng = np.random.RandomState(31)
    params, state = jax.eval_shape(jm.init, jax.random.PRNGKey(31))
    jm.params = jax.tree_util.tree_map_with_path(
        lambda p, v: _bn_leaf(p, v, rng), params)
    jm.state = jax.tree_util.tree_map_with_path(
        lambda p, v: _bn_leaf(p, v, rng), state)
    load_jax_params(tm, jm.params)
    load_jax_state(tm, jm.state)
    for m in jm.modules:
        if isinstance(m, jnn.Dropout):
            m.p = 0.0
    for m in tm.modules():
        if isinstance(m, tnn.Dropout):
            m.set_p(0.0)
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    train = jax.jit(lambda p, s, v: jm.apply(p, s, v, training=True))
    a, new_state = train(jm.params, jm.state, jnp.asarray(x))
    a = np.asarray(a)
    floor = max(np.abs(np.asarray(train(jm.params, jm.state, jnp.asarray(
        (x * (1 + 1e-7 * np.random.RandomState(k).standard_normal(
            x.shape))).astype(np.float32)))[0]) - a).max() for k in (0, 1))
    with torch.no_grad():
        b = tm.training_()(torch.from_numpy(x)).numpy()
    assert np.isfinite(b).all()
    assert np.abs(b - a).max() <= max(1e-4, 4 * floor)
    for g, w in zip(jax.tree_util.tree_leaves(export_state(tm)),
                    jax.tree_util.tree_leaves(new_state)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
    a, _ = jax.jit(lambda p, s, v: jm.apply(p, s, v, training=False))(
        jm.params, new_state, jnp.asarray(x))
    with torch.no_grad():
        b = tm.evaluate()(torch.from_numpy(x))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                               atol=1e-4)


def test_autoencoder_matches_jax():
    jm, tm = _model_pair(JAutoencoder(32), Autoencoder(32), seed=41)
    rng = np.random.RandomState(41)
    x = rng.standard_normal((3, 28, 28)).astype(np.float32)
    a, _ = jm.apply(jm.params, jm.state, jnp.asarray(x))
    r = rng.standard_normal(np.shape(a)).astype(np.float32)
    gp = jax.grad(lambda p: jnp.sum(jm.apply(p, jm.state,
                                             jnp.asarray(x))[0] * r))(
        jm.params)
    b = tm(torch.from_numpy(x))
    assert b.shape == (3, 784)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=RTOL,
                               atol=ATOL)
    (b * torch.from_numpy(r)).sum().backward()
    for g, w in zip([p.grad.numpy() for p in tm.param_leaves()],
                    jax.tree_util.tree_leaves(gp)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)
