"""The port's Torch7 ``.t7`` codec and module mapping
(``bigdl_tpu_torch.utils.torch_file``) against the JAX package's.

Both directions for every lua class ``module_from_t7`` maps: a file the
reference wrote (``save_torch`` of a JAX module, or its ``_Writer`` on a
``TorchObject`` for the classes it only reads, ``cudnn.*`` names
included) loads into the port and gives the reference's forward on the
same seeded input within rtol 1e-5 / atol 1e-6 (float32; sums in another
order); the port's ``save_torch`` of a module holding the reference
module's weights (``convert.load_jax_params``) writes the reference's
bytes exactly, and the reference loads it with the port module's forward.
The codec: a hand-built fixture, the canonical bytes, strided and shared
storages, every storage dtype, nested and self-referential tables,
``overwrite``, all equal to the reference's reader on the same bytes.  A
loaded LeNet-5's input gradient on the CPU within rtol 1e-5 / atol 1e-6 of
the reference's ``backward``.  ``Module.save``/``nn.load`` round trip and
the refusal of a file the reference's ``Module.save`` wrote, in a
subprocess that shows ``bigdl_tpu`` is never imported.  Mirrors
``tests/test_torch_file.py``.
"""

import io
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils import torch_file as jtf
from bigdl_tpu.utils.table import T as JT
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import load_jax_params, load_jax_state
from bigdl_tpu_torch.utils import torch_file as ttf
from bigdl_tpu_torch.utils.table import T
from tests.test_torch_port_models import _build, _np_params

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lenet(nn):
    from importlib import import_module
    pkg = "bigdl_tpu_torch" if nn is tnn else "bigdl_tpu"
    return import_module(f"{pkg}.models.lenet").LeNet5(10)


def _bn_model(nn):
    return (nn.Sequential()
            .add(nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1))
            .add(nn.SpatialBatchNormalization(4))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.View(4 * 3 * 3))
            .add(nn.Linear(36, 8))
            .add(nn.BatchNormalization(8))
            .add(nn.Tanh())
            .add(nn.Linear(8, 5))
            .add(nn.LogSoftMax()))


def _concat(nn):
    return (nn.Concat(2)
            .add(nn.SpatialConvolution(3, 2, 1, 1))
            .add(nn.Sequential()
                 .add(nn.SpatialConvolution(3, 3, 3, 3, 1, 1, 1, 1))
                 .add(nn.ReLU())))


# writable classes: (make(nn), input shape); the reference's save_torch
WRITABLE = {
    "linear": (lambda nn: nn.Linear(6, 4), (3, 6)),
    "linear-no-bias": (lambda nn: nn.Linear(6, 4, with_bias=False), (3, 6)),
    "conv": (lambda nn: nn.SpatialConvolution(3, 4, 3, 3, 2, 2, 1, 1),
             (2, 3, 9, 9)),
    "conv-no-bias-no-backprop": (
        lambda nn: nn.SpatialConvolution(3, 4, 3, 3, with_bias=False,
                                         propagate_back=False),
        (2, 3, 7, 7)),
    "share-conv": (lambda nn: nn.SpatialShareConvolution(3, 4, 2, 2),
                   (2, 3, 5, 5)),
    "maxpool": (lambda nn: nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1),
                (2, 3, 9, 9)),
    "maxpool-ceil": (lambda nn: nn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
                     (2, 3, 8, 8)),
    "relu": (lambda nn: nn.ReLU(), (2, 5)),
    "threshold": (lambda nn: nn.Threshold(0.1, -0.5), (2, 5)),
    "tanh": (lambda nn: nn.Tanh(), (2, 5)),
    "sigmoid": (lambda nn: nn.Sigmoid(), (2, 5)),
    "logsoftmax": (lambda nn: nn.LogSoftMax(), (2, 5)),
    "dropout": (lambda nn: nn.Dropout(0.3), (2, 5)),
    "view": (lambda nn: nn.View(12), (2, 3, 2, 2)),
    "reshape": (lambda nn: nn.Reshape([3, 4]), (2, 12)),
    "reshape-batch-mode": (lambda nn: nn.Reshape([2, 6], batch_mode=False),
                           (12,)),
    "batchnorm": (lambda nn: nn.BatchNormalization(5), (4, 5)),
    "batchnorm-no-affine": (lambda nn: nn.BatchNormalization(5, affine=False),
                            (4, 5)),
    "spatial-batchnorm": (lambda nn: nn.SpatialBatchNormalization(3),
                          (2, 3, 4, 4)),
    "concat": (_concat, (2, 3, 6, 6)),
    "sequential": (lambda nn: nn.Sequential().add(nn.Linear(6, 5))
                   .add(nn.Tanh()).add(nn.Sequential().add(nn.Linear(5, 3))),
                   (3, 6)),
    "lenet5": (_lenet, (2, 1, 28, 28)),
    "bn-model": (_bn_model, (2, 3, 6, 6)),
}


def _pair(make, seed=0):
    """The reference module with seeded weights (and running statistics
    drawn in [0.5, 1.5]) and the port module holding the same."""
    jm = _build(make(jnn), seed)
    rng = np.random.RandomState(seed + 100)
    jm.state = jax.tree_util.tree_map(
        lambda s: rng.uniform(0.5, 1.5, np.shape(s)).astype(np.float32),
        jm.state)
    tm = make(tnn)
    load_jax_params(tm, _np_params(jm))
    load_jax_state(tm, jax.tree_util.tree_map(np.asarray, jm.state))
    return jm.evaluate(), tm.evaluate()


def _jax_forward(jm, x):
    jm = jm.evaluate()
    y = jm.apply(jm.params, jm.state, jax.tree_util.tree_map(jnp.asarray, x),
                 training=False)[0]
    return jax.tree_util.tree_map(np.asarray, y)


def _port_forward(tm, x):
    with torch.inference_mode():
        y = tm.evaluate()(jax.tree_util.tree_map(torch.from_numpy, x))
    return y


def _close(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=ATOL)


def _x(shape, seed=1):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", sorted(WRITABLE))
def test_t7_both_directions_and_bytes(tmp_path, name):
    make, shape = WRITABLE[name]
    jm, tm = _pair(make)
    x = _x(shape)
    ref_file, port_file = str(tmp_path / "ref.t7"), str(tmp_path / "port.t7")
    jtf.save_torch(jm, ref_file)
    tm.save_torch(port_file)
    assert open(port_file, "rb").read() == open(ref_file, "rb").read()
    want = _jax_forward(jm, x)
    _close(_port_forward(tm, x), want)
    # the reference's file into the port
    _close(_port_forward(tnn.load_torch(ref_file, device="cpu"), x), want)
    # the port's file into the reference
    _close(_jax_forward(jtf.load_torch(port_file), x),
           _port_forward(tm, x).numpy())


def _w(shape, seed):
    return np.random.RandomState(seed).uniform(-0.5, 0.5, shape).astype(
        np.float32)


def _obj(cls, **fields):
    return jtf.TorchObject(cls, JT(**fields))


def _linear_obj(i, o, seed, cls="nn.Linear"):
    return _obj(cls, weight=_w((o, i), seed), bias=_w((o,), seed + 1))


# classes the reference only reads: (TorchObject, input)
READ_ONLY = {
    "spatial-convolution-groups": (
        lambda: _obj("nn.SpatialConvolution", nInputPlane=4.0,
                     nOutputPlane=6.0, kW=3.0, kH=3.0, dW=1.0, dH=1.0,
                     padW=1.0, padH=1.0, groups=2.0,
                     weight=_w((6, 2, 3, 3), 1), bias=_w((6,), 2)),
        lambda: _x((2, 4, 5, 5))),
    "spatial-average-pooling": (
        lambda: _obj("nn.SpatialAveragePooling", kW=3.0, kH=3.0, dW=2.0,
                     dH=2.0, padW=1.0, padH=1.0, ceil_mode=True,
                     count_include_pad=False),
        lambda: _x((2, 3, 8, 8))),
    "softmax": (lambda: _obj("nn.SoftMax"), lambda: _x((3, 7))),
    "identity": (lambda: _obj("nn.Identity"), lambda: _x((3, 7))),
    "lrn": (lambda: _obj("nn.SpatialCrossMapLRN", size=5.0, alpha=1e-4,
                         beta=0.75, k=2.0),
            lambda: _x((2, 7, 5, 5))),
    "zero-padding": (lambda: _obj("nn.SpatialZeroPadding", pad_l=1.0,
                                  pad_r=2.0, pad_t=0.0, pad_b=1.0),
                     lambda: _x((2, 3, 4, 4))),
    "concat-table": (
        lambda: _obj("nn.ConcatTable", modules=JT(_linear_obj(5, 3, 3),
                                                  _linear_obj(5, 2, 5))),
        lambda: _x((2, 5))),
    "parallel-table": (
        lambda: _obj("nn.ParallelTable", modules=JT(_linear_obj(5, 3, 7),
                                                    _obj("nn.Tanh"))),
        lambda: [_x((2, 5), 2), _x((2, 4), 3)]),
    "cudnn": (
        lambda: _obj("nn.Sequential", modules=JT(
            _obj("cudnn.SpatialConvolution", nInputPlane=3.0,
                 nOutputPlane=4.0, kW=3.0, kH=3.0, dW=1.0, dH=1.0,
                 padW=0.0, padH=0.0, weight=_w((4, 3, 3, 3), 9),
                 bias=_w((4,), 10)),
            _obj("cudnn.SpatialBatchNormalization", eps=1e-5, momentum=0.1,
                 running_mean=_w((4,), 11),
                 running_var=_w((4,), 12) + 1.0, weight=_w((4,), 13),
                 bias=_w((4,), 14)),
            _obj("cudnn.ReLU"),
            _obj("cudnn.SpatialMaxPooling", kW=2.0, kH=2.0, dW=2.0, dH=2.0,
                 padW=0.0, padH=0.0, ceil_mode=True),
            _obj("cudnn.SoftMax"))),
        lambda: _x((2, 3, 8, 8))),
}


@pytest.mark.parametrize("name", sorted(READ_ONLY))
def test_t7_read_only_classes_load_as_the_reference(tmp_path, name):
    make, x = READ_ONLY[name]
    path = str(tmp_path / "m.t7")
    buf = io.BytesIO()
    jtf._Writer(buf).write_object(make())
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    x = x()
    want = _jax_forward(jtf.load_torch(path), x)
    _close(_port_forward(tnn.load_torch(path, device="cpu"), x), want)


def test_load_torch_builds_the_classes_and_geometry(tmp_path):
    """Concat's 1-based dimension, ceil mode, the MM weight's shape and
    the running statistics land in the port's attributes."""
    jm, _ = _pair(lambda nn: nn.Sequential().add(_concat(nn)).add(
        nn.SpatialMaxPooling(3, 3, 2, 2).ceil()).add(
        nn.SpatialBatchNormalization(5)))
    path = str(tmp_path / "m.t7")
    jtf.save_torch(jm, path)
    m = tnn.load_torch(path, device="cpu")
    concat, pool, bn = m.layers
    assert isinstance(concat, tnn.Concat) and concat.dimension == 2
    assert pool.ceil_mode and isinstance(pool, tnn.SpatialMaxPooling)
    conv = concat.layers[1].layers[0]
    assert tuple(conv.weight.shape) == (3, 3, 3, 3)
    np.testing.assert_array_equal(bn.running_var.numpy(),
                                  np.asarray(jm.state[2]["running_var"]))
    assert all(p.dtype == torch.float32 for p in m.parameters())


def test_grouped_conv_refused_on_write(tmp_path):
    m = tnn.SpatialConvolution(4, 4, 3, 3, n_group=2)
    with pytest.raises(ValueError, match="nGroup"):
        m.save_torch(str(tmp_path / "g.t7"))


def test_unmapped_class_refused(tmp_path):
    path = str(tmp_path / "u.t7")
    jtf.save(_obj("nn.SpatialFractionalMaxPooling"), path)
    with pytest.raises(ValueError, match="unsupported lua class"):
        tnn.load_torch(path, device="cpu")
    with pytest.raises(ValueError, match="unsupported module"):
        tnn.Sequential().add(tnn.LayerNorm(3)).save_torch(
            str(tmp_path / "ln.t7"))


def test_load_torch_needs_cuda_unless_asked_for_the_cpu(tmp_path,
                                                        monkeypatch):
    path = str(tmp_path / "l.t7")
    tnn.Linear(3, 2).save_torch(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnn.load_torch(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttf.module_from_t7(ttf.load(path))
    assert isinstance(tnn.load_torch(path, device="cpu"), tnn.Linear)


def test_loaded_model_backward_matches_the_reference(tmp_path):
    jm, _ = _pair(_lenet, seed=3)
    path = str(tmp_path / "lenet.t7")
    jtf.save_torch(jm, path)
    x, gy = _x((2, 1, 28, 28), 4), _x((2, 10), 5)
    jback = jtf.load_torch(path).evaluate()
    jback.forward(x)
    want = np.asarray(jback.backward(x, gy))
    tback = tnn.load_torch(path, device="cpu").evaluate()
    xt = torch.from_numpy(x).requires_grad_(True)
    tback(xt).backward(torch.from_numpy(gy))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=RTOL, atol=ATOL)
    assert all(p.grad is not None for p in tback.parameters())


# -- the codec ---------------------------------------------------------------

def _t7_tensor_bytes(arr, tensor_cls, storage_cls, index=1, sizes=None,
                     strides=None, offset=1):
    """The t7 encoding of a tensor over ``arr`` as its storage, by hand."""
    sizes = list(arr.shape) if sizes is None else sizes
    if strides is None:
        strides, s = [], 1
        for n in reversed(sizes):
            strides.insert(0, s)
            s *= n
    out = struct.pack("<ii", 4, index)
    for s in ("V 1", tensor_cls):
        out += struct.pack("<i", len(s)) + s.encode()
    out += struct.pack("<i", len(sizes))
    out += b"".join(struct.pack("<q", s) for s in sizes)
    out += b"".join(struct.pack("<q", s) for s in strides)
    out += struct.pack("<q", offset)
    out += struct.pack("<ii", 4, index + 1)
    for s in ("V 1", storage_cls):
        out += struct.pack("<i", len(s)) + s.encode()
    out += struct.pack("<q", arr.size) + arr.tobytes()
    return out


def _both_read(tmp_path, raw):
    p = tmp_path / "x.t7"
    p.write_bytes(raw)
    return ttf.load(str(p)), jtf.load(str(p))


STORAGES = {
    "torch.FloatStorage": np.float32, "torch.DoubleStorage": np.float64,
    "torch.LongStorage": np.int64, "torch.IntStorage": np.int32,
    "torch.ShortStorage": np.int16, "torch.ByteStorage": np.uint8,
    "torch.CharStorage": np.int8, "torch.CudaStorage": np.float32,
    "torch.CudaDoubleStorage": np.float64, "torch.CudaLongStorage": np.int64,
}


@pytest.mark.parametrize("storage", sorted(STORAGES))
def test_every_storage_dtype(tmp_path, storage):
    dtype = STORAGES[storage]
    arr = (np.arange(12) % 7 - 3).astype(dtype).reshape(3, 4)
    if dtype == np.uint8:
        arr = np.arange(12, dtype=np.uint8).reshape(3, 4)
    tensor = storage.replace("Storage", "Tensor")
    got, want = _both_read(tmp_path, _t7_tensor_bytes(arr, tensor, storage))
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["transposed", "offset-slice", "broadcast"])
def test_strided_reads(tmp_path, case):
    base = np.arange(24, dtype=np.float32)
    geom = {"transposed": ([4, 3], [1, 4], 1),
            "offset-slice": ([2, 3], [6, 2], 4),     # rows 2 apart, from 3
            "broadcast": ([3, 4], [0, 1], 5)}[case]  # stride 0 repeats
    raw = _t7_tensor_bytes(base, "torch.FloatTensor", "torch.FloatStorage",
                           sizes=geom[0], strides=geom[1], offset=geom[2])
    got, want = _both_read(tmp_path, raw)
    np.testing.assert_array_equal(got, want)
    if case == "transposed":
        np.testing.assert_array_equal(got, base[:12].reshape(3, 4).T)


def test_strides_past_the_storage_raise(tmp_path):
    raw = _t7_tensor_bytes(np.arange(6, dtype=np.float32),
                           "torch.FloatTensor", "torch.FloatStorage",
                           sizes=[3, 3], strides=[3, 1], offset=1)
    p = tmp_path / "bad.t7"
    p.write_bytes(raw)
    with pytest.raises(ValueError, match="past its storage"):
        ttf.load(str(p))


def test_shared_storage_and_tensor_identity(tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    tbl = T(a=arr, b=arr)
    p = str(tmp_path / "sh.t7")
    ttf.save(tbl, p)
    out = ttf.load(p)
    assert out["a"] is out["b"]
    np.testing.assert_array_equal(out["a"], arr)
    # two tensors over one storage (written by hand): a view and its base
    st = np.arange(8, dtype=np.float32)
    raw = struct.pack("<iii", 3, 1, 2)
    for k, (sizes, off) in enumerate((([8], 1), ([2, 2], 3))):
        raw += struct.pack("<i", 1) + struct.pack("<d", k + 1)
        raw += struct.pack("<ii", 4, 2 + 2 * k)
        for s in ("V 1", "torch.FloatTensor"):
            raw += struct.pack("<i", len(s)) + s.encode()
        raw += struct.pack("<i", len(sizes))
        raw += b"".join(struct.pack("<q", s) for s in sizes)
        strides = [1] if len(sizes) == 1 else [2, 1]
        raw += b"".join(struct.pack("<q", s) for s in strides)
        raw += struct.pack("<q", off)
        if k == 0:
            raw += struct.pack("<ii", 4, 3)
            for s in ("V 1", "torch.FloatStorage"):
                raw += struct.pack("<i", len(s)) + s.encode()
            raw += struct.pack("<q", 8) + st.tobytes()
        else:
            raw += struct.pack("<ii", 4, 3)   # back-reference
    got, want = _both_read(tmp_path, raw)
    np.testing.assert_array_equal(got[2], st[2:6].reshape(2, 2))
    for k in (1, 2):
        np.testing.assert_array_equal(got[k], want[k])


def test_nested_and_self_referential_tables(tmp_path):
    inner = T(np.ones((2, 2), np.float32), 7.0)
    tbl = T(lr=0.1, name="sgd", flag=True, off=False, nothing=None,
            inner=inner, n=np.int64(7), half=np.float32(0.25))
    tbl["self"] = tbl
    p = str(tmp_path / "t.t7")
    ttf.save(tbl, p)
    got, want = ttf.load(p), jtf.load(p)
    assert got["self"] is got and want["self"] is want
    for k in ("lr", "name", "flag", "off", "n", "half"):
        assert got[k] == want[k] == tbl[k]
    assert "nothing" not in got or got["nothing"] is None
    np.testing.assert_array_equal(got["inner"][1], np.ones((2, 2)))
    assert got["inner"][2] == 7.0
    # the reference writes the same bytes for the same table
    q = str(tmp_path / "r.t7")
    jtbl = JT(**{k: v for k, v in tbl.items() if k != "self"})
    jtbl["inner"] = JT(inner[1], inner[2])
    jtbl["self"] = jtbl
    jtf.save(jtbl, q)
    assert open(p, "rb").read() == open(q, "rb").read()


def test_hand_built_fixture_and_canonical_bytes(tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    raw = _t7_tensor_bytes(arr, "torch.FloatTensor", "torch.FloatStorage")
    got, _ = _both_read(tmp_path, raw)
    np.testing.assert_array_equal(got, arr)
    p = str(tmp_path / "out.t7")
    ttf.save(arr, p)
    assert open(p, "rb").read() == raw
    ttf.save(torch.from_numpy(arr), p, overwrite=True)
    assert open(p, "rb").read() == raw


def test_overwrite_flag_and_failed_save(tmp_path):
    p = str(tmp_path / "x.t7")
    ttf.save(1.0, p)
    with pytest.raises(FileExistsError):
        ttf.save(2.0, p)
    ttf.save(2.0, p, overwrite=True)
    assert ttf.load(p) == jtf.load(p) == 2.0
    q = str(tmp_path / "bad.t7")
    with pytest.raises(TypeError):
        ttf.save(T(bad=object()), q)
    assert not os.path.exists(q)


@pytest.mark.parametrize("value", [3.5, "hello", True, False, None])
def test_scalars_round_trip(tmp_path, value):
    p = str(tmp_path / "v.t7")
    ttf.save(value, p)
    assert ttf.load(p) == jtf.load(p) == value


# -- Module.save / nn.load ---------------------------------------------------

def test_module_save_and_nn_load_round_trip(tmp_path):
    jm, tm = _pair(_bn_model, seed=2)
    tm.set_generator(torch.Generator().manual_seed(0))
    p = str(tmp_path / "model")
    tm.save(p)
    back = tnn.load(p, device="cpu")
    assert type(back) is type(tm) and back.name == tm.name
    assert [type(m) for m in back.modules()] == [type(m)
                                                 for m in tm.modules()]
    for a, b in zip(tm.state_dict().values(), back.state_dict().values()):
        assert torch.equal(a, b)
    x = _x((2, 3, 6, 6))
    _close(_port_forward(back, x), _jax_forward(jm, x))
    with pytest.raises(FileExistsError):
        tm.save(p)
    tm.save(p, overwrite=True)


def test_nn_load_refuses_a_reference_saved_module(tmp_path):
    """A file the JAX package's ``Module.save`` wrote is refused with a
    clean ``ValueError``, and the port does not import the JAX package."""
    jm = _build(_lenet(jnn), 0)
    p = str(tmp_path / "jax_model")
    jm.save(p)
    code = (
        "import sys\n"
        "import bigdl_tpu_torch.nn as nn\n"
        "try:\n"
        f"    nn.load({p!r}, device='cpu')\n"
        "except ValueError as e:\n"
        "    print('refused:', e)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('bigdl_tpu', 'jax', 'jaxlib'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "refused:" in out.stdout and "bigdl_tpu" in out.stdout


def test_nn_load_needs_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    p = str(tmp_path / "m")
    tnn.Linear(3, 2).save(p)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnn.load(p)
    with pytest.raises(ValueError, match="not a module"):
        from bigdl_tpu_torch.utils.file import File
        File.save({"a": 1}, str(tmp_path / "d"))
        tnn.load(str(tmp_path / "d"), device="cpu")
