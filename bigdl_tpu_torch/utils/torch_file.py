"""Torch7 ``.t7`` binary reader and writer (``bigdl_tpu/utils/torch_file.py``).

Parity: ``utils/TorchFile.scala:74-90``, the codec behind
``Module.loadTorch``/``saveTorch``.  The format is Torch7's public
serialization, a little-endian stream of tagged objects:

  ``int32 typeId`` then its payload:
    0 NIL
    1 NUMBER   -> float64
    2 STRING   -> int32 length + bytes
    3 TABLE    -> int32 index, int32 count, then count (key, value) objects
    4 TORCH    -> int32 index, version string ("V 1"), class string, payload
    5 BOOLEAN  -> int32

  torch.<T>Tensor payload: int32 ndim, int64 sizes[ndim], int64
  strides[ndim], int64 storageOffset (1-based), then a torch.<T>Storage
  object.  torch.<T>Storage payload: int64 size, raw elements.

Indices memoise repeated objects (shared storages, recursive tables).

Tensors load as numpy arrays, on the host.  Module fields become the
port's parameters only in :func:`module_from_t7`, which maps each lua
``nn.*`` class table (fields ``weight``/``bias``/``modules``/geometry,
``TorchFile.scala:443-580``) onto a port module with its parameters and
running statistics on the caller's device; :func:`write_module` writes the
same tables from port modules, byte for byte as the JAX package does for
the same module and weights.
"""

from __future__ import annotations

import io
import os
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.utils.file import to_host
from bigdl_tpu_torch.utils.table import T, Table

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_RECUR_FUNCTION = 8
TYPE_LEGACY_RECUR_FUNCTION = 7

_STORAGE_DTYPES = {
    "torch.FloatStorage": np.float32,
    "torch.DoubleStorage": np.float64,
    "torch.LongStorage": np.int64,
    "torch.IntStorage": np.int32,
    "torch.ShortStorage": np.int16,
    "torch.ByteStorage": np.uint8,
    "torch.CharStorage": np.int8,
    "torch.CudaStorage": np.float32,
    "torch.CudaDoubleStorage": np.float64,
    "torch.CudaLongStorage": np.int64,
}

_TENSOR_CLASSES = {
    "torch.FloatTensor", "torch.DoubleTensor", "torch.LongTensor",
    "torch.IntTensor", "torch.ShortTensor", "torch.ByteTensor",
    "torch.CharTensor", "torch.CudaTensor", "torch.CudaDoubleTensor",
    "torch.CudaLongTensor",
}

_DTYPE_TO_TENSOR = {
    np.dtype(np.float32): ("torch.FloatTensor", "torch.FloatStorage"),
    np.dtype(np.float64): ("torch.DoubleTensor", "torch.DoubleStorage"),
    np.dtype(np.int64): ("torch.LongTensor", "torch.LongStorage"),
    np.dtype(np.int32): ("torch.IntTensor", "torch.IntStorage"),
    np.dtype(np.uint8): ("torch.ByteTensor", "torch.ByteStorage"),
}


@dataclass
class TorchObject:
    """A deserialized ``torch.class`` object that is not a tensor or a
    storage, typically an ``nn.*`` module: ``class_name`` and its field
    ``elements``."""
    class_name: str
    elements: Table = field(default_factory=T)

    def __getitem__(self, key):
        return self.elements.get(key)

    def get(self, key, default=None):
        return self.elements.get(key, default)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0
        self.memo: Dict[int, Any] = {}

    def _take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_int(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def read_long(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def read_double(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def read_string(self) -> str:
        n = self.read_int()
        return bytes(self._take(n)).decode("latin-1")

    def read_array(self, dtype, n: int) -> np.ndarray:
        """``n`` elements as a read-only view of the file's buffer (no
        copy: tensors gather out of it)."""
        nbytes = np.dtype(dtype).itemsize * n
        return np.frombuffer(self._take(nbytes), dtype=dtype, count=n)

    def read_object(self) -> Any:
        type_id = self.read_int()
        if type_id == TYPE_NIL:
            return None
        if type_id == TYPE_NUMBER:
            return self.read_double()
        if type_id == TYPE_STRING:
            return self.read_string()
        if type_id == TYPE_BOOLEAN:
            return self.read_int() == 1
        if type_id == TYPE_TABLE:
            index = self.read_int()
            if index in self.memo:
                return self.memo[index]
            count = self.read_int()
            tbl = T()
            self.memo[index] = tbl
            for _ in range(count):
                k = self.read_object()
                v = self.read_object()
                if isinstance(k, float) and k == int(k):
                    k = int(k)
                tbl[k] = v
            return tbl
        if type_id in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION,
                       TYPE_LEGACY_RECUR_FUNCTION):
            index = self.read_int()
            if index in self.memo:   # back-reference: no body follows
                return self.memo[index]
            fn = ["function", None]
            self.memo[index] = fn    # before upvalues: closures self-refer
            size = self.read_int()
            self._take(size)  # skip dumped lua bytecode
            fn[1] = self.read_object()
            return fn
        if type_id == TYPE_TORCH:
            index = self.read_int()
            if index in self.memo:
                return self.memo[index]
            version = self.read_string()
            if version.startswith("V "):
                class_name = self.read_string()
            else:  # ancient files have no version header
                class_name = version
            if class_name in _STORAGE_DTYPES:
                n = self.read_long()
                arr = self.read_array(_STORAGE_DTYPES[class_name], n)
                self.memo[index] = arr
                return arr
            if class_name in _TENSOR_CLASSES:
                # placeholder first: storage may back-reference the tensor
                self.memo[index] = None
                t = self._read_tensor()
                self.memo[index] = t
                return t
            obj = TorchObject(class_name)
            self.memo[index] = obj
            elements = self.read_object()
            obj.elements = elements if isinstance(elements, Table) else T()
            return obj
        raise ValueError(f"unknown t7 type id {type_id} at {self.pos - 4}")

    def _read_tensor(self) -> Optional[np.ndarray]:
        ndim = self.read_int()
        sizes = [self.read_long() for _ in range(ndim)]
        strides = [self.read_long() for _ in range(ndim)]
        offset = self.read_long() - 1  # 1-based
        storage = self.read_object()
        if storage is None or ndim == 0:
            return None
        n = int(np.prod(sizes)) if sizes else 0
        if n == 0:
            return np.zeros(sizes, dtype=storage.dtype)
        last = offset + sum((sz - 1) * st for sz, st in zip(sizes, strides))
        if offset < 0 or min(strides) < 0 or last >= storage.size:
            raise ValueError(f"t7 tensor of sizes {sizes}, strides "
                             f"{strides} and offset {offset + 1} reaches "
                             f"past its storage of {storage.size}")
        # one copy through the strides (shared or overlapping storages,
        # transposed views)
        item = storage.itemsize
        view = np.lib.stride_tricks.as_strided(
            storage[offset:], shape=sizes,
            strides=[st * item for st in strides], writeable=False)
        return np.array(view)


def load(file_name: str) -> Any:
    """Load a torch object from a ``.t7`` file (``TorchFile.load``)."""
    with open(file_name, "rb") as f:
        return _Reader(f.read()).read_object()


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self, f):
        self.f = f
        self.index = 0
        # id(obj) -> assigned t7 index; the keep-alive list holds the
        # objects so CPython cannot recycle an id mid-write.  Repeated
        # tables and tensors serialize as a bare (type, index)
        # back-reference, which is what makes shared storages and
        # self-referential tables round-trip.
        self.memo: Dict[int, int] = {}
        self._keepalive: list = []

    def _memoise(self, obj, type_id: int):
        """True (and the back-reference written) if ``obj`` was written
        already; otherwise a fresh index is assigned and written."""
        key = id(obj)
        if key in self.memo:
            self.write_int(type_id)
            self.write_int(self.memo[key])
            return True
        self.index += 1
        self.memo[key] = self.index
        self._keepalive.append(obj)
        self.write_int(type_id)
        self.write_int(self.index)
        return False

    def write_int(self, v: int):
        self.f.write(struct.pack("<i", int(v)))

    def write_long(self, v: int):
        self.f.write(struct.pack("<q", int(v)))

    def write_double(self, v: float):
        self.f.write(struct.pack("<d", float(v)))

    def write_string(self, s: str):
        raw = s.encode("latin-1")
        self.write_int(len(raw))
        self.f.write(raw)

    def _next_index(self) -> int:
        self.index += 1
        return self.index

    def write_object(self, obj: Any):
        if obj is None:
            self.write_int(TYPE_NIL)
        elif isinstance(obj, (bool, np.bool_)):
            self.write_int(TYPE_BOOLEAN)
            self.write_int(1 if obj else 0)
        elif isinstance(obj, str):   # before np.generic: np.str_ is both
            self.write_int(TYPE_STRING)
            self.write_string(obj)
        elif isinstance(obj, (int, float, np.generic)):
            # np.generic covers 0-d numpy scalars (np.float32(0.1) etc.)
            # which must land as lua numbers, not 0-dim tensors
            self.write_int(TYPE_NUMBER)
            self.write_double(float(obj))
        elif isinstance(obj, dict):  # Table is a dict subclass
            if self._memoise(obj, TYPE_TABLE):
                return
            self.write_int(len(obj))
            for k, v in obj.items():
                self.write_object(k)
                self.write_object(v)
        elif isinstance(obj, torch.nn.Module):
            write_module(self, obj)
        elif isinstance(obj, TorchObject):
            if self._memoise(obj, TYPE_TORCH):
                return
            self.write_string("V 1")
            self.write_string(obj.class_name)
            self.write_object(obj.elements)
        elif isinstance(obj, (np.ndarray, torch.Tensor, list, tuple)):
            self._write_tensor(obj)
        else:
            raise TypeError(f"cannot write a {type(obj).__name__} as t7")

    def _write_tensor(self, orig):
        if self._memoise(orig, TYPE_TORCH):
            return
        arr = _np(orig)
        if arr.dtype not in _DTYPE_TO_TENSOR:
            arr = arr.astype(np.float32)
        arr = np.ascontiguousarray(arr)
        tensor_cls, storage_cls = _DTYPE_TO_TENSOR[arr.dtype]
        self.write_string("V 1")
        self.write_string(tensor_cls)
        self.write_int(arr.ndim)
        for s in arr.shape:
            self.write_long(s)
        # contiguous row-major strides in elements
        stride = 1
        strides = []
        for s in reversed(arr.shape):
            strides.append(stride)
            stride *= s
        for s in reversed(strides):
            self.write_long(s)
        self.write_long(1)  # storageOffset, 1-based
        # storage object
        self.write_int(TYPE_TORCH)
        self.write_int(self._next_index())
        self.write_string("V 1")
        self.write_string(storage_cls)
        self.write_long(arr.size)
        self.f.write(arr.tobytes())


def save(obj: Any, file_name: str, overwrite: bool = False) -> None:
    """Save an object as ``.t7`` (``TorchFile.save``).  It is serialized in
    memory first, so an object that cannot be written leaves no truncated
    file on disk."""
    if os.path.exists(file_name) and not overwrite:
        raise FileExistsError(file_name)
    buf = io.BytesIO()
    _Writer(buf).write_object(obj)
    with open(file_name, "wb") as f:
        f.write(buf.getbuffer())


# ---------------------------------------------------------------------------
# Module <-> t7 mapping (``TorchFile.scala:443-580`` field layouts)
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    """A tensor or array as a host numpy array (bfloat16 widened)."""
    return np.asarray(to_host(x))


def _general_fields(tbl: Table, dtype: str = "torch.FloatTensor") -> None:
    tbl["gradInput"] = np.zeros((0,), np.float32)
    tbl["output"] = np.zeros((0,), np.float32)
    tbl["_type"] = dtype


def write_module(w: _Writer, module) -> None:
    """Serialize one of the port's modules as its lua ``nn.*`` table."""
    import bigdl_tpu_torch.nn as nn
    tbl = T()
    _general_fields(tbl)

    def emit(lua_name: str):
        if w._memoise(module, TYPE_TORCH):
            return
        w.write_string("V 1")
        w.write_string(lua_name)
        w.write_object(tbl)

    if isinstance(module, nn.Linear):
        tbl["weight"] = _np(module.weight)
        tbl["gradWeight"] = np.zeros_like(tbl["weight"])
        if module.bias is not None:
            tbl["bias"] = _np(module.bias)
            tbl["gradBias"] = np.zeros_like(tbl["bias"])
        emit("nn.Linear")
    elif type(module) in (nn.SpatialConvolution, nn.SpatialShareConvolution):
        m = module
        if m.n_group != 1:
            raise ValueError("nGroup != 1 is not supported in torch format")
        wt = _np(m.weight).reshape(
            m.n_output_plane, m.n_input_plane * m.kernel_h * m.kernel_w)
        tbl.update_(dict(
            nInputPlane=m.n_input_plane, nOutputPlane=m.n_output_plane,
            kW=m.kernel_w, kH=m.kernel_h, dW=m.stride_w, dH=m.stride_h,
            padW=m.pad_w, padH=m.pad_h,
            fInput=np.zeros((0,), np.float32),
            fGradInput=np.zeros((0,), np.float32),
            weight=wt, gradWeight=np.zeros_like(wt)))
        if m.bias is not None:
            tbl["bias"] = _np(m.bias)
            tbl["gradBias"] = np.zeros_like(tbl["bias"])
        if not m.propagate_back:
            tbl["gradInput"] = None
        emit("nn.SpatialConvolutionMM")
    elif isinstance(module, nn.SpatialMaxPooling):
        m = module
        tbl.update_(dict(kW=m.kernel_w, kH=m.kernel_h, dW=m.stride_w,
                         dH=m.stride_h, padW=m.pad_w, padH=m.pad_h,
                         indices=np.zeros((0,), np.float32),
                         ceil_mode=m.ceil_mode))
        emit("nn.SpatialMaxPooling")
    elif isinstance(module, nn.ReLU):
        tbl.update_(dict(val=0.0, threshold=0.0, inplace=False))
        emit("nn.ReLU")
    elif isinstance(module, nn.Threshold):
        tbl.update_(dict(val=module.v, threshold=module.th, inplace=False))
        emit("nn.Threshold")
    elif isinstance(module, (nn.Concat, nn.Sequential)):
        mods = T()
        for i, child in enumerate(module.layers):
            mods[i + 1] = child
        if isinstance(module, nn.Concat):
            tbl["dimension"] = module.dimension
        tbl["modules"] = mods
        emit("nn.Concat" if isinstance(module, nn.Concat)
             else "nn.Sequential")
    elif isinstance(module, nn.Dropout):
        tbl["p"] = module.p
        tbl["noise"] = np.zeros((0,), np.float32)
        emit("nn.Dropout")
    elif isinstance(module, nn.View):
        tbl["size"] = np.asarray(module.sizes, np.int64)
        tbl["numElements"] = int(np.prod([s for s in module.sizes if s > 0]))
        emit("nn.View")
    elif isinstance(module, nn.LogSoftMax):
        emit("nn.LogSoftMax")
    elif isinstance(module, nn.BatchNormalization):
        m = module
        spatial = isinstance(m, nn.SpatialBatchNormalization)
        tbl.update_(dict(
            nDim=4 if spatial else 2, eps=m.eps, momentum=m.momentum,
            affine=m.affine, running_mean=_np(m.running_mean),
            running_var=_np(m.running_var)))
        if m.affine:
            tbl["weight"] = _np(m.weight)
            tbl["bias"] = _np(m.bias)
            tbl["gradWeight"] = np.zeros_like(tbl["weight"])
            tbl["gradBias"] = np.zeros_like(tbl["bias"])
        emit("nn.SpatialBatchNormalization" if spatial
             else "nn.BatchNormalization")
    elif isinstance(module, nn.Tanh):
        emit("nn.Tanh")
    elif isinstance(module, nn.Sigmoid):
        emit("nn.Sigmoid")
    elif isinstance(module, nn.Reshape):
        tbl["size"] = np.asarray(module.size, np.int64)
        tbl["batchMode"] = bool(module.batch_mode) \
            if module.batch_mode is not None else None
        emit("nn.Reshape")
    else:
        raise ValueError(
            f"saveTorch: unsupported module {type(module).__name__}")


def _set(param: Optional[torch.Tensor], value) -> None:
    """Copy ``value`` (an array of the parameter's element count) into
    ``param`` in place, in the parameter's dtype."""
    if param is None or value is None:
        return
    src = np.asarray(value, np.float32).reshape(tuple(param.shape))
    with torch.no_grad():
        param.copy_(torch.from_numpy(src))


def _module_from_t7(obj: Any):
    import bigdl_tpu_torch.nn as nn
    if not isinstance(obj, TorchObject):
        raise ValueError(f"not a torch module object: {type(obj)}")
    name = obj.class_name.replace("cudnn.", "nn.")
    e = obj.elements

    def f_int(key, default=0):
        v = e.get(key, default)
        return int(v) if v is not None else default

    if name in ("nn.Sequential", "nn.Concat", "nn.ConcatTable",
                "nn.ParallelTable"):
        mods = e.get("modules", T())
        children = [_module_from_t7(mods[k]) for k in sorted(
            k for k in mods.keys() if isinstance(k, int))]
        if name == "nn.Sequential":
            container = nn.Sequential()
        elif name == "nn.Concat":
            container = nn.Concat(f_int("dimension", 1))
        elif name == "nn.ConcatTable":
            container = nn.ConcatTable()
        else:
            container = nn.ParallelTable()
        for c in children:
            container.add(c)
        return container
    if name == "nn.Linear":
        weight = e.get("weight")
        out_size, in_size = weight.shape
        m = nn.Linear(in_size, out_size, with_bias=e.get("bias") is not None)
        _set(m.weight, weight)
        _set(m.bias, e.get("bias"))
        return m
    if name in ("nn.SpatialConvolution", "nn.SpatialConvolutionMM"):
        n_in, n_out = f_int("nInputPlane"), f_int("nOutputPlane")
        m = nn.SpatialConvolution(
            n_in, n_out, f_int("kW"), f_int("kH"), f_int("dW", 1),
            f_int("dH", 1), f_int("padW"), f_int("padH"),
            n_group=f_int("groups", 1) or 1,
            with_bias=e.get("bias") is not None)
        # the MM form's 2-D (out, in * kh * kw) weight in the port's
        # (out, in / groups, kh, kw) shape
        _set(m.weight, e.get("weight"))
        _set(m.bias, e.get("bias"))
        return m
    if name == "nn.SpatialMaxPooling":
        m = nn.SpatialMaxPooling(
            f_int("kW"), f_int("kH"), f_int("dW", 1), f_int("dH", 1),
            f_int("padW"), f_int("padH"))
        if e.get("ceil_mode"):
            m.ceil()
        return m
    if name == "nn.SpatialAveragePooling":
        return nn.SpatialAveragePooling(
            f_int("kW"), f_int("kH"), f_int("dW", 1), f_int("dH", 1),
            f_int("padW"), f_int("padH"), ceil_mode=bool(e.get("ceil_mode")),
            count_include_pad=bool(e.get("count_include_pad", True)))
    if name in ("nn.BatchNormalization", "nn.SpatialBatchNormalization"):
        running_mean = e.get("running_mean")
        n = int(np.asarray(running_mean).shape[0])
        cls = nn.SpatialBatchNormalization \
            if name == "nn.SpatialBatchNormalization" \
            else nn.BatchNormalization
        m = cls(n, eps=float(e.get("eps", 1e-5)),
                momentum=float(e.get("momentum", 0.1)),
                affine=e.get("weight") is not None)
        _set(m.weight, e.get("weight"))
        _set(m.bias, e.get("bias"))
        _set(m.running_mean, running_mean)
        _set(m.running_var, e.get("running_var"))
        return m
    if name == "nn.ReLU":
        return nn.ReLU()
    if name == "nn.Threshold":
        return nn.Threshold(float(e.get("threshold", 1e-6)),
                            float(e.get("val", 0.0)))
    simple = {"nn.Tanh": nn.Tanh, "nn.Sigmoid": nn.Sigmoid,
              "nn.SoftMax": nn.SoftMax, "nn.LogSoftMax": nn.LogSoftMax,
              "nn.Identity": nn.Identity}
    if name in simple:
        return simple[name]()
    if name == "nn.Dropout":
        return nn.Dropout(float(e.get("p", 0.5)))
    if name in ("nn.View", "nn.Reshape"):
        sizes = [int(s) for s in np.asarray(e.get("size")).reshape(-1)]
        return nn.View(*sizes) if name == "nn.View" else nn.Reshape(sizes)
    if name == "nn.SpatialCrossMapLRN":
        return nn.SpatialCrossMapLRN(
            f_int("size", 5), float(e.get("alpha", 1e-4)),
            float(e.get("beta", 0.75)), float(e.get("k", 1.0)))
    if name == "nn.SpatialZeroPadding":
        return nn.SpatialZeroPadding(
            f_int("pad_l"), f_int("pad_r"), f_int("pad_t"), f_int("pad_b"))
    raise ValueError(f"loadTorch: unsupported lua class {obj.class_name}")


def module_from_t7(obj: Any, device="cuda"):
    """A port module tree from a loaded t7 object
    (``TorchFile.readModuleWithType``'s role: lua class name -> module, the
    weights copied in), its parameters and running statistics on
    ``device`` (CUDA by default; without CUDA it raises unless asked for
    the CPU)."""
    dev = resolve_device(device)
    return _module_from_t7(obj).to(dev)


def load_torch(file_name: str, device="cuda"):
    """``Module.loadTorch`` parity: read a t7 file holding an nn module
    onto ``device``."""
    dev = resolve_device(device)
    return module_from_t7(load(file_name), dev)


def save_torch(module, file_name: str, overwrite: bool = False) -> None:
    """``AbstractModule.saveTorch`` parity."""
    save(module, file_name, overwrite=overwrite)
