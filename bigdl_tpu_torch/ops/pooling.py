"""NCHW max pool with a stored argmax code: kernel K1 and its plain version.

Replaces ``bigdl_tpu/ops/pooling.py`` ``_fwd_kernel`` (the Pallas forward
reached through ``_max_pool_fwd_impl``) with ``csrc/max_pool.cu``.  The TPU
kernel emulated strided window reads with one-hot MXU matmuls and padded
with a finite bf16 minimum, both Mosaic workarounds; the CUDA kernel reads
the window with direct strided loads and skips padding cells.

What bounds it on the H100 is bytes: x read once, y and the optional uint8
index written once, at 3.35 TB/s.  The design keeps it there with one thread
per output element and neighbouring threads on neighbouring output columns,
so loads and stores coalesce and window overlap is served from cache.

Contract shared by the kernel and :func:`max_pool2d_plain`: the window is
scanned in row-major order and compared in f32 with a strict ``>``, so ties
keep the FIRST maximal offset; the index is the window-offset code
``p * kw + q`` as uint8.  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops._grad import forward_only


def _pool_out_size(in_size, k, stride, pad, ceil_mode):
    if ceil_mode:
        out = int(math.ceil(float(in_size - k + 2 * pad) / stride)) + 1
    else:
        out = int(math.floor(float(in_size - k + 2 * pad) / stride)) + 1
    if pad > 0 and (out - 1) * stride >= in_size + pad:
        out -= 1  # last window must start inside the (left-padded) input
    return out


def pool_geometry(ih, iw, kh, kw, sh, sw, ph, pw, ceil_mode):
    """(oh, ow, extra_h, extra_w): output size and the right/bottom padding
    needed so every window is complete over the padded plane."""
    oh = _pool_out_size(ih, kh, sh, ph, ceil_mode)
    ow = _pool_out_size(iw, kw, sw, pw, ceil_mode)
    eh = max((oh - 1) * sh + kh - ih - ph, 0)
    ew = max((ow - 1) * sw + kw - iw - pw, 0)
    return oh, ow, eh, ew


def max_pool2d_plain(x, kh, kw, sh, sw, ph=0, pw=0, ceil_mode=False):
    """Plain PyTorch max pool: ``(y, idx)`` with the kernel's tie rule and
    uint8 window-offset codes."""
    n, c, ih, iw = x.shape
    oh, ow, eh, ew = pool_geometry(ih, iw, kh, kw, sh, sw, ph, pw, ceil_mode)
    xf = torch.nn.functional.pad(x.float(), (pw, ew, ph, eh))
    rows = torch.arange(oh, device=x.device) * sh - ph
    cols = torch.arange(ow, device=x.device) * sw - pw
    best = torch.full((n, c, oh, ow), -math.inf, device=x.device)
    idx = torch.zeros((n, c, oh, ow), dtype=torch.uint8, device=x.device)
    have = torch.zeros((oh, ow), dtype=torch.bool, device=x.device)
    for p in range(kh):
        rv = (rows + p >= 0) & (rows + p < ih)
        for q in range(kw):
            cv = (cols + q >= 0) & (cols + q < iw)
            valid = rv[:, None] & cv[None, :]
            v = xf[:, :, p:p + (oh - 1) * sh + 1:sh,
                   q:q + (ow - 1) * sw + 1:sw]
            take = valid & (~have | (v > best))
            best = torch.where(take, v, best)
            idx = torch.where(take, torch.full_like(idx, p * kw + q), idx)
            have = have | valid
    return best.to(x.dtype), idx


def _launch(x, kh, kw, sh, sw, ph, pw, ceil_mode, with_idx):
    n, c, ih, iw = x.shape
    oh, ow, _, _ = pool_geometry(ih, iw, kh, kw, sh, sw, ph, pw, ceil_mode)
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    idx = torch.empty((n, c, oh, ow), dtype=torch.uint8, device=x.device) \
        if with_idx else None
    lib = _build.load()
    rc = lib.bigdl_max_pool2d_fwd(
        x.data_ptr(), y.data_ptr(), None if idx is None else idx.data_ptr(),
        _build.DTYPE_CODES[x.dtype], n, c, ih, iw, kh, kw, sh, sw, ph, pw,
        oh, ow, _build.stream_ptr(x))
    _build.check(rc, "max_pool2d_fwd")
    max_pool2d.launches += 1
    return y, idx


def _validate(x, kh, kw, sh, sw, ph, pw, ceil_mode):
    if x.dim() != 4:
        raise ValueError(f"max_pool2d takes NCHW input, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"max_pool2d takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if min(kh, kw, sh, sw) < 1 or ph < 0 or pw < 0:
        raise ValueError("kernel and stride must be >= 1, padding >= 0")
    if kh * kw > 255:
        raise ValueError(f"window {kh}x{kw} does not fit a uint8 index code")
    if not (ph < kh and pw < kw):
        raise ValueError(f"pad ({ph}, {pw}) must be < kernel ({kh}, {kw})")
    oh, ow, _, _ = pool_geometry(x.shape[2], x.shape[3], kh, kw, sh, sw, ph,
                                 pw, ceil_mode)
    if oh < 1 or ow < 1:
        raise ValueError(f"window {kh}x{kw} does not fit input "
                         f"{tuple(x.shape[2:])}")


def max_pool2d(x, kh, kw, sh, sw, ph=0, pw=0, ceil_mode=False,
               return_indices=False):
    """NCHW max pool: the K1 kernel for a CUDA tensor, the plain version for
    a CPU tensor.  ``return_indices`` also returns the uint8 argmax codes;
    without it the kernel skips that write."""
    _validate(x, kh, kw, sh, sw, ph, pw, ceil_mode)
    geom = (kh, kw, sh, sw, ph, pw, ceil_mode)
    if x.device.type == "cpu":
        def run(t):
            y, idx = max_pool2d_plain(t, *geom)
            return (y, idx) if return_indices else y
    elif x.device.type == "cuda":
        if not x.is_contiguous():
            raise ValueError("max_pool2d kernel takes a contiguous tensor")

        def run(t):
            y, idx = _launch(t, *geom, with_idx=return_indices)
            return (y, idx) if return_indices else y
    else:
        raise RuntimeError(f"max_pool2d has no path for device {x.device}")
    return forward_only(run, "max_pool2d", x)


max_pool2d.launches = 0
