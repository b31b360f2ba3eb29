"""The port's other convolutions, ``LookupTable``, ``Normalize`` and the
spatial normalizations (``bigdl_tpu_torch.nn``) against the JAX package's.

Both sides get the same seeded numpy parameters (U(-1, 1), copied with
``load_jax_params``) and inputs.  Each case holds the output and the
gradients of the sum of the output times a seeded random tensor, with
respect to the floating input and every parameter, within rtol 1e-5 and
an atol of 1e-6 times the result's largest magnitude (at least 1) of
``jax.grad``'s: float32 sums of up to a few hundred terms in another
order, where cancellation leaves some outputs small beside the others.  Under
``quantize_model(m, "w8")`` each weighted layer agrees with the
reference's ``quantize_params`` and ``apply`` within 1e-5 (the same packed
bits, widened and convolved in another order), and a dilated layer keeps
off ``int8_conv2d`` (whose patches carry no dilation).  The cases mirror
``tests/test_layers_misc.py:305-313``, ``tests/test_torch_oracle.py:70-84,
178``, ``tests/test_conv_pool.py:71-104`` and
``tests/test_spatial_normalization.py:44-102``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.ops import quant as jq
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.nn import conv as tconv
from bigdl_tpu_torch.nn.normalization import _gaussian_kernel_2d
from bigdl_tpu_torch.ops import quant
from tests.test_torch_port_tables import _draw, _hold, _n

torch.set_num_threads(1)


def _ids(seed, n_index, *shape):
    """1-based float indices with a fractional part (cast toward zero)."""
    rng = np.random.RandomState(seed)
    return (rng.randint(1, n_index + 1, shape) +
            rng.uniform(0.0, 0.9, shape)).astype(np.float32)


# (id, constructor over a namespace, input)
LAYERS = [
    ("LookupTable", lambda nn: nn.LookupTable(10, 4), _ids(1, 10, 3, 5)),
    ("LookupTable-padding", lambda nn: nn.LookupTable(10, 4, 2.0),
     _ids(2, 10, 6)),
    ("LookupTable-max_norm", lambda nn: nn.LookupTable(10, 6, max_norm=1.5),
     _ids(3, 10, 4, 5)),
    ("LookupTable-max_norm-L1", lambda nn: nn.LookupTable(
        10, 6, max_norm=2.0, norm_type=1.0), _ids(4, 10, 4, 5)),
    ("SpatialShareConvolution", lambda nn: nn.SpatialShareConvolution(
        3, 4, 3, 3, 1, 1, 1, 1), _n(5, 2, 3, 7, 6)),
    ("SpatialShareConvolution-groups-stride", lambda nn:
     nn.SpatialShareConvolution(4, 6, 3, 2, 2, 1, 0, 1, n_group=2),
     _n(6, 2, 4, 7, 9)),
    ("SpatialDilatedConvolution", lambda nn: nn.SpatialDilatedConvolution(
        2, 3, 3, 3, 1, 1, 2, 2, 2, 2), _n(7, 1, 2, 9, 9)),
    ("SpatialDilatedConvolution-stride-rect", lambda nn:
     nn.SpatialDilatedConvolution(3, 4, 3, 2, 2, 1, 1, 0, 3, 2),
     _n(8, 2, 3, 10, 11)),
    ("SpatialDilatedConvolution-chw", lambda nn:
     nn.SpatialDilatedConvolution(2, 3, 2, 2, 1, 1, 0, 0, 2, 1),
     _n(9, 2, 6, 6)),
    ("SpatialFullConvolution", lambda nn: nn.SpatialFullConvolution(
        3, 2, 3, 3, 2, 2, 1, 1, 1, 1), _n(10, 2, 3, 5, 5)),
    ("SpatialFullConvolution-groups-noadj", lambda nn:
     nn.SpatialFullConvolution(4, 6, 3, 2, 1, 2, 0, 1, 0, 1, n_group=2),
     _n(11, 2, 4, 4, 5)),
    ("SpatialFullConvolution-nobias-chw", lambda nn:
     nn.SpatialFullConvolution(3, 2, 4, 4, 2, 2, 1, 1, no_bias=True),
     _n(12, 3, 4, 4)),
    ("SpatialFullConvolution-adj-rect", lambda nn:
     nn.SpatialFullConvolution(2, 3, 2, 3, 3, 2, 0, 1, 2, 1),
     _n(13, 2, 2, 3, 4)),
    ("SpatialConvolutionMap-full", lambda nn: nn.SpatialConvolutionMap(
        nn.SpatialConvolutionMap.full(3, 4), 3, 3, 1, 1, 1, 1),
     _n(14, 2, 3, 6, 6)),
    ("SpatialConvolutionMap-one_to_one-stride", lambda nn:
     nn.SpatialConvolutionMap(nn.SpatialConvolutionMap.one_to_one(3), 2, 3,
                              2, 1), _n(15, 2, 3, 7, 8)),
    ("SpatialConvolutionMap-table", lambda nn: nn.SpatialConvolutionMap(
        np.array([[1, 1], [2, 1], [2, 2], [3, 3], [1, 3]]), 3, 3),
     _n(16, 3, 5, 5)),
    ("Normalize-L2", lambda nn: nn.Normalize(2.0), _n(17, 4, 7)),
    ("Normalize-L1", lambda nn: nn.Normalize(1.0), _n(18, 4, 7)),
    ("Normalize-L3-4d", lambda nn: nn.Normalize(3.0), _n(19, 2, 5, 3, 3)),
    ("Normalize-inf", lambda nn: nn.Normalize(float("inf")), _n(20, 4, 7)),
]
KERNEL_5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
NORMS = ["SpatialSubtractiveNormalization", "SpatialDivisiveNormalization",
         "SpatialContrastiveNormalization"]


@pytest.mark.parametrize("name,make,x", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_matches_jax(name, make, x):
    _hold(make, x, seed=3, scaled=True)


@pytest.mark.parametrize("kernel", ["default", "1-D", "2-D"])
@pytest.mark.parametrize("layout", ["batched", "chw"])
@pytest.mark.parametrize("cls", NORMS)
def test_spatial_normalization_matches_jax(cls, layout, kernel):
    k = {"default": None, "1-D": KERNEL_5,
         "2-D": np.outer(KERNEL_5[:3], KERNEL_5[1:5])}[kernel]
    x = _n(21, 2, 3, 12, 11)
    _hold(lambda nn: getattr(nn, cls)(3, k), x[0] if layout == "chw" else x,
          scaled=True)


def test_subtractive_normalization_vanishes_inside_a_constant_image():
    """``tests/test_spatial_normalization.py:77-84``: the interior mean of a
    constant image is the constant."""
    y = tnn.SpatialSubtractiveNormalization(1)(torch.full((1, 1, 13, 13),
                                                          2.5))
    torch.testing.assert_close(y[0, 0, 5:8, 5:8], torch.zeros(3, 3),
                               rtol=0, atol=1e-5)
    k = _gaussian_kernel_2d(9)
    assert tuple(k.shape) == (9, 9) and abs(k.sum().item() - 1) < 1e-6


def test_lookup_table_gathers_one_based_rows():
    """``tests/test_layers_misc.py:305-313``, and the padding row zero at
    init."""
    m = tnn.LookupTable(10, 4, padding_value=3).reset(0)
    y = m(torch.tensor([[1, 5], [10, 1]]))
    assert tuple(y.shape) == (2, 2, 4)
    torch.testing.assert_close(y[1, 0], m.weight[9])
    assert m.weight[2].abs().max() == 0 and m.weight[1].abs().max() > 0


def test_lookup_table_max_norm_leaves_the_weight_alone():
    m = tnn.LookupTable(6, 8, max_norm=0.5).reset(1)
    before = m.weight.detach().clone()
    y = m(torch.tensor([1.0, 2.0, 6.0]))
    assert (torch.linalg.vector_norm(y, dim=-1) <= 0.5 + 1e-6).all()
    torch.testing.assert_close(m.weight.detach(), before, rtol=0, atol=0)


def test_convolution_map_masks_the_missing_connections():
    m = tnn.SpatialConvolutionMap(tnn.SpatialConvolutionMap.one_to_one(3),
                                  3, 3).reset(2)
    assert m.param_tree().keys() == {"weight", "bias"}
    x = torch.from_numpy(_n(22, 1, 3, 5, 5))
    y = m(x)
    # output plane 2 sees input plane 2 alone
    x2 = x.clone()
    x2[:, [0, 2]] = 0
    torch.testing.assert_close(m(x2)[:, 1], y[:, 1])
    # per output plane fan: one connected plane of 3x3, U(-1/3, 1/3)
    assert m.weight.abs().max() <= 1 / 3


def test_full_convolution_gives_the_reference_output_size():
    m = tnn.SpatialFullConvolution(3, 5, 4, 3, 3, 2, 1, 0, 2, 1)
    y = m(torch.zeros(2, 3, 6, 7))
    # (i - 1) * d - 2 * pad + k + adj
    assert tuple(y.shape) == (2, 5, (6 - 1) * 2 + 3 + 1,
                              (7 - 1) * 3 - 2 + 4 + 2)
    with pytest.raises(ValueError, match="adjW/adjH"):
        tnn.SpatialFullConvolution(3, 5, 4, 3, 2, 2, 0, 0, 2, 0)


# -- quantized copies ---------------------------------------------------------

QUANTIZED = [
    ("SpatialShareConvolution", lambda nn: nn.SpatialShareConvolution(
        16, 32, 3, 3, 1, 1, 1, 1), _n(30, 2, 16, 9, 9)),
    ("SpatialDilatedConvolution", lambda nn: nn.SpatialDilatedConvolution(
        16, 32, 3, 3, 1, 1, 2, 2, 2, 2), _n(31, 2, 16, 9, 9)),
    ("SpatialFullConvolution", lambda nn: nn.SpatialFullConvolution(
        32, 16, 3, 3, 2, 2, 1, 1, 1, 1), _n(32, 2, 32, 5, 5)),
    ("SpatialConvolutionMap", lambda nn: nn.SpatialConvolutionMap(
        nn.SpatialConvolutionMap.full(16, 32), 3, 3, 1, 1, 1, 1),
     _n(33, 2, 16, 7, 7)),
    ("LookupTable", lambda nn: nn.LookupTable(512, 16),
     _ids(34, 512, 4, 7)),
]


def _quantized_pair(make, seed=5):
    jm, tm = make(jnn), make(tnn)
    shapes, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(seed))
    params = _draw(shapes, np.random.RandomState(seed))
    load_jax_params(tm, params)
    packed = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, params),
                                "w8")
    assert jq.is_quantized(packed["weight"])
    qm = quant.quantize_model(tm, "w8")
    assert quant.packed_weight(qm) is not None and qm.weight is None
    return jm, params, packed, qm


@pytest.mark.parametrize("name,make,x", QUANTIZED,
                         ids=[c[0] for c in QUANTIZED])
def test_quantized_layer_matches_the_reference_packing(name, make, x,
                                                       monkeypatch):
    jm, params, packed, qm = _quantized_pair(make)
    calls = []
    real = quant.int8_conv2d
    monkeypatch.setattr(quant, "int8_conv2d",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want, _ = jm.apply(packed, (), jnp.asarray(x))
    got = qm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the copy serves the packed weight, not the fp one
    fp, _ = jm.apply(params, (), jnp.asarray(x))
    assert np.abs(np.asarray(fp) - got.numpy()).max() > 1e-5
    assert len(calls) == (name == "SpatialShareConvolution")


def test_quantized_dilated_convolution_needs_its_opt_out(monkeypatch):
    """With the class flag turned on, the dilated layer takes the fused
    int8 conv, whose patches carry no dilation, and misses the reference
    (here by the output's size: 11x11 windows for 9x9)."""
    _, make, x = QUANTIZED[1]
    jm, _, packed, qm = _quantized_pair(make)
    want = np.asarray(jm.apply(packed, (), jnp.asarray(x))[0])
    calls = []
    real = quant.int8_conv2d
    monkeypatch.setattr(quant, "int8_conv2d",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tconv.SpatialDilatedConvolution, "_fused_int8_ok",
                        True)
    got = qm(torch.from_numpy(x)).numpy()
    assert calls
    assert got.shape != want.shape or \
        not np.allclose(got, want, rtol=1e-3, atol=1e-3)
