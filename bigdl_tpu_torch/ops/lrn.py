"""Cross-map LRN forward: kernel K2 and its plain version.

    y_i     = x_i * scale_i^(-beta)
    scale_i = k + (alpha/size) * sum_{j=i-lo}^{i+hi} x_j^2,
    lo = (size-1)//2, hi = size-1-lo

Replaces ``bigdl_tpu/ops/lrn.py`` ``_fwd_kernel`` (the Pallas forward
reached through ``_lrn_pallas_fwd``) with ``csrc/lrn.cu``.  The TPU kernel
tiled (C, pixels) blocks in VMEM and summed shifted copies; the CUDA kernel
gives each thread one (image, pixel) and walks the channels, neighbouring
threads on neighbouring pixels, so each channel plane is read coalesced.

What bounds it on the H100 is bytes: x read once, y (and the optional
``scale``, the TPU kernel's second output kept for the backward) written
once, at 3.35 TB/s.  The window sum is taken in f32 and recomputed per
channel from cache rather than carried as a running sum.

:func:`lrn_plain` mirrors ``_lrn_xla`` (``ops/lrn.py:81-86``) including the
``_neg_pow`` forms; it computes in x's dtype, as the reference does.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops._grad import forward_only

_POW_MODES = {0.75: 0, 0.5: 1}      # csrc/lrn.cu PowMode; 2 = powf


def _neg_pow(scale, beta):
    """scale**(-beta) with the sqrt-family forms for the common exponents
    (``ops/lrn.py:67-78``)."""
    if beta == 0.75:
        r = torch.rsqrt(scale)
        return r * torch.sqrt(r)
    if beta == 0.5:
        return torch.rsqrt(scale)
    return torch.pow(scale, -beta)


def _window_sum_c(a, size, lo, hi):
    padded = torch.nn.functional.pad(a, (0, 0, 0, 0, lo, hi))
    c = a.shape[1]
    out = padded[:, 0:c]
    for j in range(1, size):
        out = out + padded[:, j:j + c]
    return out


def lrn_plain(x, size=5, alpha=1.0, beta=0.75, k=1.0):
    """Plain PyTorch LRN over NCHW: ``(y, scale)``."""
    lo = (size - 1) // 2
    hi = size - 1 - lo
    scale = k + (alpha / size) * _window_sum_c(x * x, size, lo, hi)
    return x * _neg_pow(scale, beta), scale


def _launch(x, size, alpha, beta, k, with_scale):
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    scale = torch.empty_like(x) if with_scale else None
    lib = _build.load()
    rc = lib.bigdl_lrn_fwd(
        x.data_ptr(), y.data_ptr(),
        None if scale is None else scale.data_ptr(),
        _build.DTYPE_CODES[x.dtype], n, c, h * w, size, alpha / size, beta,
        k, _POW_MODES.get(beta, 2), _build.stream_ptr(x))
    _build.check(rc, "lrn_fwd")
    cross_map_lrn.launches += 1
    return y, scale


def cross_map_lrn(x, size=5, alpha=1.0, beta=0.75, k=1.0,
                  return_scale=False):
    """Cross-map LRN over an NCHW batch: the K2 kernel for a CUDA tensor,
    the plain version for a CPU tensor.  ``return_scale`` also returns the
    ``scale`` buffer; without it the kernel skips that write."""
    if x.dim() != 4:
        raise ValueError(f"cross_map_lrn takes NCHW input, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"cross_map_lrn takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if size < 1:
        raise ValueError(f"LRN size must be >= 1, got {size}")
    alpha, beta, k = float(alpha), float(beta), float(k)
    if x.device.type == "cpu":
        def run(t):
            y, scale = lrn_plain(t, size, alpha, beta, k)
            return (y, scale) if return_scale else y
    elif x.device.type == "cuda":
        if not x.is_contiguous():
            raise ValueError("cross_map_lrn kernel takes a contiguous tensor")

        def run(t):
            y, scale = _launch(t, size, alpha, beta, k, return_scale)
            return (y, scale) if return_scale else y
    else:
        raise RuntimeError(f"cross_map_lrn has no path for device {x.device}")
    return forward_only(run, "cross_map_lrn", x)


cross_map_lrn.launches = 0
