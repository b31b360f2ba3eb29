"""The fp16 wire codec: kernels K5 (compress), K6 (decompress) and K7
(add), each beside its plain version.

BigDL's wire format for gradient and weight slices
(``parameters/FP16CompressedTensor.scala``) keeps the top two bytes of each
IEEE-754 float32, truncating rather than rounding: bfloat16's bits.

    compress:   u16 = bits(f32) >> 16
    decompress: f32 = bits(u32(u16) << 16)
    add:        decompress both, add in f32, truncate again

K5, K6 and K7 replace ``bigdl_tpu/ops/fp16.py`` ``_compress_kernel``,
``_decompress_kernel`` and ``_add_kernel`` (``csrc/fp16_codec.cu``).  The
TPU, and XLA on the CPU, flush subnormals in float32 arithmetic: an add
treats a subnormal input as signed zero and flushes a subnormal sum to
signed zero.  :func:`fp16_add_plain` does so explicitly, whatever the
process's ``torch.set_flush_denormal``, and K7 adds with
``add.rn.ftz.f32``.  Compress and decompress are pure bit operations and
keep subnormal bits.  A NaN sum is a NaN, its payload the framework's own.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Outputs are flat; ``fp16_decompress(u, shape=)`` reshapes.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.ops import _build

_EXPONENT = 0x7F800000
_SIGN = -0x80000000          # 0x80000000 as an int32


def fp16_compress_reference(x):
    """float32 -> uint16 by top-two-byte truncation (``toFP16``), in
    ``x``'s shape."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits >> 16) & 0xFFFF).to(torch.uint16)


def fp16_decompress_reference(u):
    """uint16 -> float32 by a zero low half (``fromFP16``), in ``u``'s
    shape."""
    return (u.to(torch.int32) << 16).view(torch.float32)


def _flush_subnormals(x):
    """Subnormal float32 values to zero of the same sign."""
    bits = x.view(torch.int32)
    return torch.where((bits & _EXPONENT) == 0, bits & _SIGN,
                       bits).view(torch.float32)


def fp16_add_plain(a, b):
    """Decompress, add with subnormals flushed, compress (``_add_kernel``),
    in ``a``'s shape."""
    s = _flush_subnormals(fp16_decompress_reference(a)) + \
        _flush_subnormals(fp16_decompress_reference(b))
    return fp16_compress_reference(_flush_subnormals(s))


def _wire(u, what):
    if u.dtype != torch.uint16:
        raise TypeError(f"{what} takes the uint16 wire format, got {u.dtype}")
    return u.reshape(-1)


def _cuda_only(t, what):
    if t.device.type != "cuda":
        raise RuntimeError(f"{what} has no path for device {t.device}")


def fp16_compress(x):
    """Compress to the wire format: ``x`` cast to float32, flat uint16.
    The K5 kernel for a CUDA tensor, the plain version for a CPU tensor."""
    x = x.to(torch.float32).reshape(-1)
    if x.device.type == "cpu":
        return fp16_compress_reference(x)
    _cuda_only(x, "fp16_compress")
    x = x.contiguous()
    out = torch.empty(x.numel(), dtype=torch.uint16, device=x.device)
    if x.numel():
        rc = _build.load().bigdl_fp16_compress(
            x.data_ptr(), out.data_ptr(), x.numel(), _build.stream_ptr(x))
        _build.check(rc, "fp16_compress")
        _build.count_launch(fp16_compress)
    return out


fp16_compress.launches = 0


def fp16_decompress(u, shape=None):
    """Expand the uint16 wire format to float32, flat or in ``shape``.  The
    K6 kernel for a CUDA tensor, the plain version for a CPU tensor."""
    u = _wire(u, "fp16_decompress")
    if u.device.type == "cpu":
        out = fp16_decompress_reference(u)
    else:
        _cuda_only(u, "fp16_decompress")
        u = u.contiguous()
        out = torch.empty(u.numel(), dtype=torch.float32, device=u.device)
        if u.numel():
            rc = _build.load().bigdl_fp16_decompress(
                u.data_ptr(), out.data_ptr(), u.numel(), _build.stream_ptr(u))
            _build.check(rc, "fp16_decompress")
            _build.count_launch(fp16_decompress)
    return out.reshape(shape) if shape is not None else out


fp16_decompress.launches = 0


def fp16_add(a, b):
    """Sum two wire-format buffers of one length in the fp16 domain
    (``FP16CompressedTensor.add``): flat uint16.  The K7 kernel for CUDA
    tensors, the plain version for CPU tensors."""
    a, b = _wire(a, "fp16_add"), _wire(b, "fp16_add")
    if a.numel() != b.numel():
        raise ValueError(f"fp16_add takes buffers of one length, got "
                         f"{a.numel()} and {b.numel()}")
    if a.device != b.device:
        raise ValueError("fp16_add takes both buffers on one device")
    if a.device.type == "cpu":
        return fp16_add_plain(a, b)
    _cuda_only(a, "fp16_add")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    if a.numel():
        rc = _build.load().bigdl_fp16_add(a.data_ptr(), b.data_ptr(),
                                          out.data_ptr(), a.numel(),
                                          _build.stream_ptr(a))
        _build.check(rc, "fp16_add")
        _build.count_launch(fp16_add)
    return out


fp16_add.launches = 0
