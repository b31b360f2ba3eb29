"""The port's layers and models (``bigdl_tpu_torch``) against the JAX
package: each model is built in ``bigdl_tpu`` from a seed, its parameters
are copied across with ``load_jax_params``, and both forwards see the same
numpy inputs.  Log-probabilities agree to rtol/atol 1e-4 (float32, sums
taken in another order), the full Inception-v1 to atol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.core.module import flatten_params, get_named_modules
from bigdl_tpu.models.inception import Inception_v1 as JInception
from bigdl_tpu.models.inception import inception_module as j_inception_module
from bigdl_tpu.models.lenet import LeNet5 as JLeNet5
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.api import DLClassifier
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.core.module import get_named_modules as t_named
from bigdl_tpu_torch.core.precision import mixed_forward
from bigdl_tpu_torch.models import Inception_v1, LeNet5, inception_module

# the suite runs several pytest workers on one host: keep torch from
# taking every core inside each of them
torch.set_num_threads(1)


def _np_params(m):
    return jax.tree_util.tree_map(np.asarray, m.params)


def _build(jmodel, seed):
    """Give ``jmodel`` seeded numpy parameters in the tree its own ``init``
    makes: shapes from ``jax.eval_shape`` (nothing is compiled), Xavier-
    uniform weights and small uniform biases."""
    rng = np.random.RandomState(seed)

    def draw(leaf):
        shape = leaf.shape
        if len(shape) >= 2:
            field = int(np.prod(shape[2:]))
            bound = np.sqrt(6.0 / ((shape[0] + shape[1]) * field))
        else:
            bound = 0.05
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed))
    jmodel.params, jmodel.state = jax.tree_util.tree_map(draw, shapes)
    return jmodel


def _pair(jmodel, tmodel, seed):
    _build(jmodel, seed).evaluate()
    load_jax_params(tmodel, _np_params(jmodel))
    return jmodel, tmodel.evaluate()


def _forward_both(jmodel, tmodel, x):
    a = np.asarray(jax.jit(lambda p, s, v: jmodel.apply(
        p, s, v, training=False)[0])(jmodel.params, jmodel.state,
                                     jnp.asarray(x)))
    with torch.inference_mode():
        b = tmodel(torch.from_numpy(x)).numpy()
    return a, b


def _narrow_inception(pkg, init):
    """Inception stem (ceil pools, LRN) + one narrow inception module."""
    nn, mod = pkg
    return (nn.Sequential()
            .add(nn.SpatialConvolution(3, 16, 7, 7, 2, 2, 3, 3,
                                       init_method=init))
            .add(nn.ReLU(True))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(nn.SpatialCrossMapLRN(5, 0.5, 0.75))
            .add(nn.SpatialConvolution(16, 16, 3, 3, 1, 1, 1, 1,
                                       init_method=init))
            .add(nn.ReLU(True))
            .add(nn.SpatialCrossMapLRN(5, 1e-4, 0.75))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(mod(16, 8, 8, 12, 4, 6, 6, "inception_x/"))
            .add(nn.SpatialAveragePooling(4, 4, 1, 1))
            .add(nn.Dropout(0.4))
            .add(nn.View(32).set_num_input_dims(3))
            .add(nn.Linear(32, 10, init_method=init))
            .add(nn.LogSoftMax()))


@pytest.mark.parametrize("batch", [1, 4])
def test_lenet5_matches_jax(batch):
    jm, tm = _pair(JLeNet5(10), LeNet5(10), seed=batch)
    x = np.random.RandomState(batch).rand(batch, 28, 28).astype(np.float32)
    a, b = _forward_both(jm, tm, x)
    assert b.shape == (batch, 10)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch", [2, 3])
def test_narrow_inception_stack_matches_jax(batch):
    from bigdl_tpu.core import init as jinit
    from bigdl_tpu_torch.core import init as tinit
    jm = _narrow_inception((jnn, j_inception_module), jinit.XAVIER)
    tm = _narrow_inception((tnn, inception_module), tinit.XAVIER)
    jm, tm = _pair(jm, tm, seed=7)
    x = np.random.RandomState(batch).standard_normal(
        (batch, 3, 32, 32)).astype(np.float32)
    a, b = _forward_both(jm, tm, x)
    assert b.shape == (batch, 10)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


def test_chw_input_is_lifted_to_batch_one():
    layer = tnn.SpatialMaxPooling(3, 3, 2, 2).ceil()
    x = torch.randn(4, 9, 9)
    assert torch.equal(layer(x), layer(x[None])[0])
    lrn = tnn.SpatialCrossMapLRN(5, 1.0, 0.75)
    assert torch.equal(lrn(x), lrn(x[None])[0])


def test_average_pooling_keeps_the_jax_divisor_semantics():
    x = np.random.RandomState(4).standard_normal((2, 3, 7, 9)) \
        .astype(np.float32)
    for kwargs in (dict(), dict(ceil_mode=True),
                   dict(ceil_mode=True, count_include_pad=False)):
        j = jnn.SpatialAveragePooling(3, 3, 2, 2, 1, 1, **kwargs)
        t = tnn.SpatialAveragePooling(3, 3, 2, 2, 1, 1, **kwargs)
        a, _ = j.apply((), (), jnp.asarray(x))
        np.testing.assert_allclose(t(torch.from_numpy(x)).numpy(),
                                   np.asarray(a), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="must be <"):
        tnn.SpatialMaxPooling(2, 2, 2, 2, 2, 2)


def test_average_pooling_keeps_its_divisors_on_the_device():
    x = np.random.RandomState(5).standard_normal((2, 3, 7, 7)) \
        .astype(np.float32)
    tx = torch.from_numpy(x)
    for args, kw, constant in (
            ((7, 7, 1, 1), {}, True),                      # Inception's pool5
            ((3, 3, 2, 2, 1, 1), {"count_include_pad": False}, False)):
        j = jnn.SpatialAveragePooling(*args, **kw)
        t = tnn.SpatialAveragePooling(*args, **kw)
        want = np.asarray(j.apply((), (), jnp.asarray(x))[0])
        with torch.inference_mode():
            first = t(tx)
        second = t(tx.clone().requires_grad_())      # outside inference mode
        np.testing.assert_allclose(first.numpy(), want, rtol=1e-5, atol=1e-6)
        assert torch.equal(second.detach(), first)
        (d,) = t._divisor_cache.values()
        assert isinstance(d, float) == constant


def test_inception_v1_parameter_tree_round_trips():
    jm = _build(JInception(1000), 11)
    tm = Inception_v1(1000)
    load_jax_params(tm, _np_params(jm))
    w, g = tm.get_parameters()
    jw = np.asarray(flatten_params(jm.params))
    assert w.shape == jw.shape and w.numel() > 6_000_000
    np.testing.assert_array_equal(w.numpy(), jw)
    assert float(g.abs().sum()) == 0.0
    # same layer names, so name-matching loaders find the same layers
    jnames = {n for n in get_named_modules(jm) if "/" in n}
    tnames = {n for n in t_named(tm) if "/" in n}
    assert jnames == tnames and len(tnames) > 100
    pools = [m for m in tm.modules()
             if isinstance(m, tnn.SpatialMaxPooling)]
    lrns = [m for m in tm.modules()
            if isinstance(m, tnn.SpatialCrossMapLRN)]
    assert (len(pools), len(lrns)) == (13, 2)


def test_load_jax_params_raises_on_mismatch():
    jm = _build(JLeNet5(10), 0)
    params = _np_params(jm)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(LeNet5(5), params)
    with pytest.raises(ValueError, match="children"):
        load_jax_params(LeNet5(10), params[:-1])
    bad = list(params)
    bad[1] = {"weight": params[1]["weight"]}        # bias missing
    with pytest.raises(ValueError, match="parameters"):
        load_jax_params(LeNet5(10), bad)


def test_reset_is_seeded_and_explicit():
    a, b = LeNet5(10).reset(3), LeNet5(10).reset(3)
    c = LeNet5(10).reset(4)
    assert torch.equal(a.get_parameters()[0], b.get_parameters()[0])
    assert not torch.equal(a.get_parameters()[0], c.get_parameters()[0])


def test_bf16_eval_cast_follows_the_f32_forward():
    tm = LeNet5(10).reset(1).evaluate()
    x = torch.from_numpy(np.random.RandomState(1).rand(4, 28, 28)
                         .astype(np.float32))
    with torch.inference_mode():
        y16 = mixed_forward(tm, x, torch.bfloat16)
        y32 = tm(x)
    assert y16.dtype == torch.float32
    assert next(tm.parameters()).dtype == torch.float32
    torch.testing.assert_close(y16, y32, rtol=5e-2, atol=5e-2)
    clf = DLClassifier(tm, (4, 28, 28), compute_dtype=torch.bfloat16,
                       device="cpu")
    assert clf._pack(list(x.numpy())).dtype == torch.bfloat16
    assert clf.predict(list(x.numpy())).shape == (4,)


def test_inception_v1_full_forward_matches_jax():
    jm, tm = _pair(JInception(1000), Inception_v1(1000), seed=5)
    x = np.random.RandomState(5).standard_normal((2, 3, 224, 224)) \
        .astype(np.float32)
    a, b = _forward_both(jm, tm, x)
    assert b.shape == (2, 1000) and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=1e-3)
    np.testing.assert_array_equal(b.argmax(1), a.argmax(1))
