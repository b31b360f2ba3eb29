"""Packing full-width Inception-v1 for quantized inference: the port's
``quantize_model`` against the JAX package's ``quantize_params`` on the same
seeded float32 weights.  The w8 and f8 trees are bit-equal leaf by leaf
(JAX packs eagerly, as ``DLClassifier`` does); the w4 and w8a8 layouts are
held field by field against ``jax.eval_shape`` of the reference, their bits
per leaf by the codec tests of ``test_torch_port_quant.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.inception import Inception_v1 as JInception
from bigdl_tpu.ops import quant as jq
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models import Inception_v1
from bigdl_tpu_torch.ops import quant as tq

# the suite runs several pytest workers on one host: keep torch from
# taking every core inside each of them
torch.set_num_threads(1)


def _np(a):
    """A JAX or torch array as numpy; 1-byte floats as their raw bytes."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    if str(a.dtype) == "float8_e4m3fn":
        return a.view(np.uint8)
    return a.astype(np.float32) if str(a.dtype) == "bfloat16" else a


@pytest.fixture(scope="module")
def inception_params():
    """Seeded numpy parameters in the tree ``Inception_v1(1000).init``
    makes (shapes from ``jax.eval_shape``: nothing is compiled)."""
    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(JInception(1000).init, jax.random.PRNGKey(0))[0]
    return jax.tree_util.tree_map(
        lambda leaf: (0.05 * rng.standard_normal(leaf.shape))
        .astype(np.float32), shapes)


def _leaves(tree):
    """{path: leaf} of a packed or fp JAX tree, packed leaves as dicts."""
    out = {}

    def rec(t, path):
        if jq.is_quantized(t):
            out[path] = t
        elif isinstance(t, dict):
            for k, v in t.items():
                rec(v, f"{path}.{k}" if path else k)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                rec(v, f"{path}.{i}" if path else str(i))
        else:
            out[path] = t
    rec(tree, "")
    return out


def _port_leaves(qmodel):
    """The same {path: leaf} view of a ``quantize_model`` copy."""
    out = {}
    for path, m in tq._walk(qmodel):
        qt = tq.packed_weight(m)
        if qt is not None:
            out[tq._param_path(path, "weight")] = qt
        for name, p in m._parameters.items():
            if p is not None:
                out[tq._param_path(path, name)] = p
    return out


@pytest.mark.parametrize("mode", ["w8", "f8"])
def test_quantize_model_packs_inception_like_jax(inception_params, mode):
    model = load_jax_params(Inception_v1(1000), inception_params)
    qmodel = tq.quantize_model(model, mode, cast_rest=torch.bfloat16)
    jparams = jq.quantize_params(
        jax.tree_util.tree_map(jnp.asarray, inception_params), mode=mode,
        cast_rest=jnp.bfloat16)
    want = _leaves(jparams)
    got = _port_leaves(qmodel)
    assert set(got) == set(want)
    packed = sorted(p for p, v in want.items() if jq.is_quantized(v))
    assert len(packed) == 57
    names = {p: m.name for p, m in tq._walk(qmodel)}
    assert "inception_3a/5x5_reduce" not in \
        {names[p.rsplit(".", 1)[0]] for p in packed}
    for path, leaf in want.items():
        if jq.is_quantized(leaf):
            for key in ("q8", "f8", "scale"):
                if key in leaf:
                    np.testing.assert_array_equal(_np(got[path][key]),
                                                  _np(leaf[key]))
            assert got[path]["scale"].dtype == torch.float32
        else:
            assert got[path].dtype == torch.bfloat16, path
            np.testing.assert_array_equal(_np(got[path]), _np(leaf))
    # the caller's model keeps its fp weights
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert sum(1 for _ in model.parameters()) == 116
    by_dtype = {k: v for k, v in jq.param_bytes_by_dtype(jparams).items()
                if v}
    assert tq.param_bytes_by_dtype(qmodel) == by_dtype


@pytest.mark.parametrize("mode", ["w4", "w8a8"])
def test_quantize_model_layout_matches_jax(inception_params, mode):
    """The packed layout of the other rungs on full-width Inception-v1:
    which leaves pack, each field's shape and dtype (``jax.eval_shape`` of
    the reference; the bits are held per leaf by the codec tests)."""
    calib = {"24.weight": 0.05} if mode == "w8a8" else None
    want = _leaves(jax.eval_shape(
        lambda p: jq.quantize_params(p, mode=mode, calib=calib,
                                     cast_rest=jnp.bfloat16),
        inception_params))
    model = load_jax_params(Inception_v1(1000), inception_params)
    got = _port_leaves(tq.quantize_model(model, mode, calib=calib,
                                         cast_rest=torch.bfloat16))
    assert set(got) == set(want)
    n_packed = 0
    for path, leaf in want.items():
        if isinstance(leaf, dict):
            n_packed += 1
            fields = {k for k in leaf if k != "dt"}
            assert set(got[path]) == fields, path
            for k in fields:
                assert tuple(got[path][k].shape) == tuple(leaf[k].shape)
                assert str(got[path][k].dtype).replace("torch.", "") == \
                    str(leaf[k].dtype)
        else:
            assert got[path].dtype == torch.bfloat16
    assert n_packed == 57
    if mode == "w8a8":
        assert [p for p, v in got.items() if isinstance(v, dict)
                and "sx" in v] == ["24.weight"]
        assert got["24.weight"]["sx"].item() == np.float32(0.05)
