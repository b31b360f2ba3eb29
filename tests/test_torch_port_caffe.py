"""The port's Caffe loader (``bigdl_tpu_torch.utils.caffe_loader``) against
the JAX package's.

The wire-format parse equals the reference's exactly (names, types, V1/V2
flags, blob shapes and float32 data) on ``tests/fixtures/
protobuf_oracle.caffemodel`` (serialized by Google's protobuf runtime) and
on V1 and V2 files that ``encode_caffemodel`` writes, and the port's
encoder writes the reference's bytes.  ``copy_parameters`` into LeNet-5,
AlexNet (grouped convolutions) and Inception-v1 at 10 classes under Caffe's
GoogLeNet names leaves every weight equal to the reference's copy (exact)
and the forward within rtol 1e-5 / atol 1e-5 of the reference's on the
same seeded images (float32; long sums in another order).  Each
``match_all`` refusal gives the reference's exception and message, and
``match_all=False`` keeps the module's own weights.  Mirrors
``tests/test_caffe_loader.py``.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils import caffe_loader as jcl
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.core.module import get_named_modules
from bigdl_tpu_torch.utils import caffe_loader as tcl
from tests.test_torch_port_models import _build, _np_params

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-5
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "protobuf_oracle.caffemodel")

PROTOTXT = """
name: "TinyNet"  # a comment
layer {
  name: "conv1"
  type: "Convolution"
  bottom: "data"
  top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1 }
}
layer {
  name: "fc1"
  type: "InnerProduct"
  inner_product_param { num_output: 5 bias_term: false }
}
"""


def _same_parse(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["name"], g["type"], g["v2"]) == \
            (w["name"], w["type"], w["v2"])
        assert len(g["blobs"]) == len(w["blobs"])
        for gb, wb in zip(g["blobs"], w["blobs"]):
            assert gb["shape"] == wb["shape"]
            assert gb["data"].dtype == wb["data"].dtype
            np.testing.assert_array_equal(gb["data"], wb["data"])


def test_parse_equals_the_reference_on_the_protobuf_oracle():
    raw = open(FIXTURE, "rb").read()
    got = tcl.parse_caffemodel(raw)
    _same_parse(got, jcl.parse_caffemodel(raw))
    layers = {l["name"]: l for l in got}
    assert layers["conv1"]["type"] == "Convolution" and layers["conv1"]["v2"]
    assert layers["fc1"]["type"] == 14 and not layers["fc1"]["v2"]
    rng = np.random.RandomState(0)
    want = [rng.randn(4, 3, 3, 3), rng.randn(4), rng.randn(10, 16),
            rng.randn(10)]
    blobs = layers["conv1"]["blobs"] + layers["fc1"]["blobs"]
    for b, w in zip(blobs, want):
        np.testing.assert_array_equal(b["data"].reshape(w.shape),
                                      w.astype(np.float32))


@pytest.mark.parametrize("v1", [False, True], ids=["v2", "v1"])
def test_encoder_writes_the_reference_bytes_and_parses_alike(v1):
    rng = np.random.RandomState(3)
    layers = [{"name": "conv1", "type": 4 if v1 else "Convolution",
               "blobs": [rng.rand(4, 2, 3, 3), rng.rand(4)]},
              {"name": "empty", "type": 5 if v1 else "ReLU", "blobs": []},
              {"name": "fc/1", "type": 14 if v1 else "InnerProduct",
               "blobs": [rng.rand(5, 64).astype(np.float32)]}]
    raw = tcl.encode_caffemodel(layers, v1=v1)
    assert raw == jcl.encode_caffemodel(layers, v1=v1)
    _same_parse(tcl.parse_caffemodel(raw), jcl.parse_caffemodel(raw))
    assert [b["shape"] for b in tcl.parse_caffemodel(raw)[0]["blobs"]] == \
        [[4, 2, 3, 3], [4]]


def test_prototxt_parse_equals_the_reference():
    assert tcl.parse_prototxt(PROTOTXT) == jcl.parse_prototxt(PROTOTXT)
    net = tcl.parse_prototxt(PROTOTXT)
    assert net["name"] == "TinyNet"
    assert [l["name"] for l in net["layer"]] == ["conv1", "fc1"]
    assert net["layer"][1]["inner_product_param"]["bias_term"] is False


def _blobs_for(model, seed, v1=False):
    """Seeded caffe blobs, in Caffe's shapes (the port's), for every
    weighted layer of the port ``model``, by its name (V1 records type
    layers by enum: 4 convolution, 14 inner product)."""
    rng = np.random.RandomState(seed)
    layers = []
    for name, m in get_named_modules(model).items():
        if getattr(m, "weight", None) is None or isinstance(m, tnn.Container):
            continue
        blobs = [rng.uniform(-0.1, 0.1, tuple(m.weight.shape))]
        if getattr(m, "bias", None) is not None:
            blobs.append(rng.uniform(-0.1, 0.1, tuple(m.bias.shape)))
        conv = m.weight.dim() == 4
        layers.append({"name": name, "type": (4 if conv else 14) if v1
                       else ("Convolution" if conv else "InnerProduct"),
                       "blobs": [b.astype(np.float32) for b in blobs]})
    return layers


def _lenet(nn):
    return (nn.Sequential()
            .add(nn.Reshape([1, 28, 28]).set_name("reshape"))
            .add(nn.SpatialConvolution(1, 6, 5, 5).set_name("conv1"))
            .add(nn.Tanh().set_name("tanh1"))
            .add(nn.SpatialMaxPooling(2, 2, 2, 2).set_name("pool1"))
            .add(nn.SpatialConvolution(6, 12, 5, 5).set_name("conv2"))
            .add(nn.SpatialMaxPooling(2, 2, 2, 2).set_name("pool2"))
            .add(nn.Reshape([12 * 4 * 4]).set_name("flat"))
            .add(nn.Linear(12 * 4 * 4, 100).set_name("ip1"))
            .add(nn.Tanh().set_name("tanh2"))
            .add(nn.Linear(100, 10).set_name("ip2"))
            .add(nn.LogSoftMax().set_name("prob")))


def _model(kind, pkg):
    from importlib import import_module
    nn = tnn if pkg == "port" else jnn
    if kind == "lenet":
        return _lenet(nn)
    root = "bigdl_tpu_torch" if pkg == "port" else "bigdl_tpu"
    if kind == "alexnet":
        return import_module(f"{root}.models.alexnet").AlexNet(10)
    return import_module(f"{root}.models.inception").Inception_v1(10)


INPUTS = {"lenet": (2, 1, 28, 28), "alexnet": (1, 3, 227, 227),
          "inception": (1, 3, 224, 224)}


@pytest.mark.parametrize("kind,v1", [("lenet", False), ("lenet", True),
                                     ("alexnet", False),
                                     ("inception", False)],
                         ids=["lenet-v2", "lenet-v1", "alexnet", "inception"])
def test_copy_parameters_matches_the_reference(tmp_path, kind, v1):
    tm = _model(kind, "port")
    jm = _build(_model(kind, "jax"), 0)
    layers = _blobs_for(tm, 7, v1)
    path = str(tmp_path / f"{kind}.caffemodel")
    with open(path, "wb") as f:
        f.write(tcl.encode_caffemodel(layers, v1=v1))
    assert tnn.load_caffe(tm, "deploy.prototxt", path) is tm
    jcl.CaffeLoader.load(jm, "deploy.prototxt", path)
    got, want = export_params(tm), _np_params(jm)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)
    named = get_named_modules(tm)
    for layer in layers:        # every blob lands whole, in its own shape
        m = named[layer["name"]]
        np.testing.assert_array_equal(m.weight.detach().numpy(),
                                      layer["blobs"][0])
    x = np.random.RandomState(1).uniform(-1, 1, INPUTS[kind]).astype(
        np.float32)
    tm.evaluate()
    with torch.inference_mode():
        y = tm(torch.from_numpy(x)).numpy()
    jm.evaluate()
    ref = np.asarray(jax.jit(lambda p, s, v: jm.apply(
        p, s, v, training=False)[0])(jm.params, jm.state, jnp.asarray(x)))
    np.testing.assert_allclose(y, ref, rtol=RTOL, atol=ATOL)


def test_alexnet_grouped_blob_is_caffes_group_order(tmp_path):
    """conv2 (2 groups): the (out, in/2, kh, kw) blob, copied flat, gives
    Caffe's grouped convolution: output channels [0, 128) read input
    channels [0, 48) through the blob's first 128 filters, and so on."""
    tm = _model("alexnet", "port")
    layers = _blobs_for(tm, 11)
    path = str(tmp_path / "alexnet.caffemodel")
    with open(path, "wb") as f:
        f.write(tcl.encode_caffemodel(layers))
    tcl.CaffeLoader.load(tm, None, path)
    conv2 = get_named_modules(tm)["conv2"]
    blob = next(l for l in layers if l["name"] == "conv2")["blobs"]
    assert conv2.n_group == 2 and blob[0].shape == (256, 48, 5, 5)
    x = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (1, 96, 27, 27)).astype(np.float32))
    w, b = torch.from_numpy(blob[0]), torch.from_numpy(blob[1])
    want = torch.cat([F.conv2d(x[:, g * 48:(g + 1) * 48],
                               w[g * 128:(g + 1) * 128],
                               b[g * 128:(g + 1) * 128], padding=2)
                      for g in range(2)], dim=1)
    with torch.inference_mode():
        got = conv2(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def _tiny(nn, bias=True):
    return (nn.Sequential()
            .add(nn.SpatialConvolution(2, 4, 3, 3, with_bias=bias)
                 .set_name("conv1"))
            .add(nn.ReLU().set_name("relu1"))
            .add(nn.Reshape([4 * 4 * 4]).set_name("flat"))
            .add(nn.Linear(64, 5).set_name("fc1")))


def _write(tmp_path, layers, v1=False, name="net.caffemodel"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(tcl.encode_caffemodel(layers, v1=v1))
    return path


def _tiny_layers(conv_blobs=None, fc_blobs=None):
    rng = np.random.RandomState(7)
    conv = [rng.rand(4, 2, 3, 3).astype(np.float32),
            rng.rand(4).astype(np.float32)]
    fc = [rng.rand(5, 64).astype(np.float32), rng.rand(5).astype(np.float32)]
    return [{"name": "conv1", "type": "Convolution",
             "blobs": conv if conv_blobs is None else conv_blobs},
            {"name": "fc1", "type": "InnerProduct",
             "blobs": fc if fc_blobs is None else fc_blobs}]


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the refusal itself is compared
        return type(e), str(e)
    return None


# (make(nn) -> model, caffe layers): each refusal of match_all
REFUSALS = {
    "unmapped-module": (
        lambda nn: nn.Sequential().add(nn.Linear(3, 3).set_name("absent")),
        lambda: _tiny_layers()),
    "layer-without-blobs": (
        lambda nn: _tiny(nn),
        lambda: _tiny_layers(fc_blobs=[])),
    "parameter-without-blob": (
        lambda nn: _tiny(nn),
        lambda: _tiny_layers(conv_blobs=_tiny_layers()[0]["blobs"][:1])),
    "nonzero-blob-without-parameter": (
        lambda nn: _tiny(nn, bias=False),
        lambda: _tiny_layers()),
    "element-count-mismatch": (
        lambda nn: _tiny(nn),
        lambda: _tiny_layers(fc_blobs=[np.ones((3, 3), np.float32)])),
}
MESSAGES = {"unmapped-module": "cannot map a layer",
            "layer-without-blobs": "carries no blobs",
            "parameter-without-blob": "provides only 1 blob",
            "nonzero-blob-without-parameter": "nonzero 'bias' blob",
            "element-count-mismatch": "element number mismatch"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_match_all_refusals_as_the_reference(tmp_path, case, caplog):
    make, layers = REFUSALS[case]
    path = _write(tmp_path, layers())
    tm = make(tnn)
    jm = make(jnn).build(seed=0)
    got = _raised(lambda: tcl.CaffeLoader.load(tm, None, path))
    want = _raised(lambda: jcl.CaffeLoader.load(jm, None, path))
    assert got is not None and got == want
    assert MESSAGES[case] in got[1]
    # without match_all the refusal is a warning (or, for the element
    # count, still an error) and unmatched weights keep their values
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        got = _raised(lambda: tcl.CaffeLoader.load(tm, None, path,
                                                   match_all=False))
    want = _raised(lambda: jcl.CaffeLoader.load(jm, None, path,
                                                match_all=False))
    assert got == want
    if case == "unmapped-module":
        for k, v in tm.state_dict().items():
            assert torch.equal(v, before[k])
    if got is None and case != "unmapped-module":
        assert caplog.records


def test_zero_blob_without_parameter_is_dropped_quietly(tmp_path):
    layers = _tiny_layers()
    layers[0]["blobs"][1] = np.zeros(4, np.float32)
    path = _write(tmp_path, layers)
    tm = _tiny(tnn, bias=False)
    tcl.CaffeLoader.load(tm, None, path)
    np.testing.assert_array_equal(tm.layers[0].weight.detach().numpy(),
                                  layers[0]["blobs"][0])


@pytest.mark.parametrize("case", ["blobs-beat-no-blobs", "v2-beats-v1"])
def test_duplicate_layers_resolve_as_the_reference(tmp_path, case):
    """A layer with blobs beats one without, then V2 beats V1
    (``CaffeLoader._load``)."""
    v1 = _tiny_layers()
    v2 = _tiny_layers(conv_blobs=[b + 1 for b in _tiny_layers()[0]["blobs"]])
    if case == "blobs-beat-no-blobs":
        v2[0]["blobs"] = []
    for layer, enum in zip(v1, (4, 14)):
        layer["type"] = enum
    raw = tcl.encode_caffemodel(v1, v1=True) + tcl.encode_caffemodel(v2)
    path = str(tmp_path / "dup.caffemodel")
    with open(path, "wb") as f:
        f.write(raw)
    tm, jm = _tiny(tnn), _tiny(jnn).build(seed=0)
    tcl.CaffeLoader.load(tm, None, path)
    jcl.CaffeLoader.load(jm, None, path)
    want = (v1 if case == "blobs-beat-no-blobs" else v2)[0]["blobs"][0]
    np.testing.assert_array_equal(tm.layers[0].weight.detach().numpy(), want)
    np.testing.assert_array_equal(np.asarray(jm.params[0]["weight"]), want)


def test_copy_keeps_each_parameters_dtype(tmp_path):
    layers = _tiny_layers()
    path = _write(tmp_path, layers)
    tm = _tiny(tnn).to(device="cpu", dtype=torch.bfloat16)
    tnn.load_caffe(tm, None, path)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    np.testing.assert_array_equal(
        tm.layers[3].bias.detach().float().numpy(),
        torch.from_numpy(layers[1]["blobs"][1]).bfloat16().float().numpy())
