"""Cross-map LRN: kernels K2 (forward) and K4 (backward), each beside its
plain version, and their autograd pair.

    y_i     = x_i * scale_i^(-beta)
    scale_i = k + (alpha/size) * sum_{j=i-lo}^{i+hi} x_j^2,
    lo = (size-1)//2, hi = size-1-lo

    q_j  = dy_j * x_j * scale_j^(-beta) / scale_j
    dx_i = dy_i * scale_i^(-beta) - 2 (alpha/size) beta x_i sum_{j=i-hi}^{i+lo} q_j

K2 replaces ``bigdl_tpu/ops/lrn.py`` ``_fwd_kernel`` (reached through
``_lrn_pallas_fwd``) and K4 its ``_bwd_kernel`` (reached through
``_lrn_pallas_bwd``), both in ``csrc/lrn.cu``.  The TPU kernels tiled
(C, pixels) blocks in VMEM and summed shifted copies; the CUDA kernels give
each thread one (image, pixel) and walk the channels, neighbouring threads
on neighbouring pixels, so each channel plane is read coalesced.

What bounds both on the H100 is bytes: K2 reads x once and writes y (and
the optional ``scale``, kept for the backward) once; K4 reads x, scale and
dy once and writes dx once, at 3.35 TB/s.  Window sums are taken in f32 and
recomputed per channel from cache rather than carried as a running sum.

:func:`lrn_plain` mirrors ``_lrn_xla`` (``ops/lrn.py:81-86``) and
:func:`lrn_bwd_plain` mirrors ``_bwd_kernel`` (``ops/lrn.py:133-141``),
including the ``_neg_pow`` forms; both compute in x's dtype, as the
reference does.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.ops import _build

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


def lrn_bwd_plain(x, scale, dy, size=5, alpha=1.0, beta=0.75):
    """Plain PyTorch LRN backward over NCHW (``_bwd_kernel``): ``dx`` from
    the forward's input ``x``, its ``scale`` buffer and ``dy``.  The power
    is taken in at least f32 and cast back, as the reference does."""
    lo = (size - 1) // 2
    hi = size - 1 - lo
    wide = torch.promote_types(scale.dtype, torch.float32)
    pow_b = _neg_pow(scale.to(wide), beta).to(x.dtype)
    q = dy * x * pow_b / scale
    rsum = _window_sum_c(q, size, hi, lo)        # reversed window [-hi, lo]
    return dy * pow_b - 2.0 * (alpha / size) * beta * x * rsum


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


def _forward(x, size, alpha, beta, k, with_scale):
    """``(y, scale)`` by the device's route; ``scale`` is None when not
    asked for on the card, where the kernel then skips that write."""
    if x.device.type == "cpu":
        y, scale = lrn_plain(x, size, alpha, beta, k)
        return y, scale if with_scale else None
    if x.device.type == "cuda":
        if not x.is_contiguous():
            raise ValueError("cross_map_lrn kernel takes a contiguous tensor")
        return _launch(x, size, alpha, beta, k, with_scale)
    raise RuntimeError(f"cross_map_lrn has no path for device {x.device}")


class _CrossMapLRN(torch.autograd.Function):
    """K2 with the scale write on in forward, K4 in backward.  ``x`` and
    ``scale`` are saved with ``save_for_backward``, so an in-place change to
    either before the backward fails autograd's version check."""

    @staticmethod
    def forward(ctx, x, size, alpha, beta, k):
        y, scale = _forward(x, size, alpha, beta, k, with_scale=True)
        ctx.mark_non_differentiable(scale)
        ctx.save_for_backward(x, scale)
        ctx.params = (size, alpha, beta)
        return y, scale

    @staticmethod
    def backward(ctx, dy, _dscale):
        x, scale = ctx.saved_tensors
        return lrn_bwd(x, scale, dy, *ctx.params), None, None, None, None


def cross_map_lrn(x, size=5, alpha=1.0, beta=0.75, k=1.0,
                  return_scale=False):
    """Cross-map LRN over an NCHW batch: the K2 kernel for a CUDA tensor,
    the plain version for a CPU tensor.  ``return_scale`` also returns the
    ``scale`` buffer.  When autograd will need it (grad enabled and ``x``
    requires grad) ``scale`` is written and saved for the K4 backward;
    otherwise, unless asked for, the kernel skips that write."""
    if x.dim() != 4:
        raise ValueError(f"cross_map_lrn takes NCHW input, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"cross_map_lrn takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if size < 1:
        raise ValueError(f"LRN size must be >= 1, got {size}")
    alpha, beta, k = float(alpha), float(beta), float(k)
    if torch.is_grad_enabled() and x.requires_grad:
        y, scale = _CrossMapLRN.apply(x, size, alpha, beta, k)
    else:
        y, scale = _forward(x, size, alpha, beta, k, return_scale)
    return (y, scale) if return_scale else y


cross_map_lrn.launches = 0


def lrn_bwd(x, scale, dy, size=5, alpha=1.0, beta=0.75):
    """LRN backward: ``dx`` in x's dtype.  The K4 kernel for CUDA tensors,
    :func:`lrn_bwd_plain` for CPU tensors."""
    if x.dim() != 4 or x.shape != scale.shape or x.shape != dy.shape:
        raise ValueError(f"lrn_bwd takes NCHW x, scale and dy of one shape, "
                         f"got {tuple(x.shape)}, {tuple(scale.shape)}, "
                         f"{tuple(dy.shape)}")
    if x.dtype not in _build.DTYPE_CODES or \
            not x.dtype == scale.dtype == dy.dtype:
        raise TypeError(f"lrn_bwd takes float32 or bfloat16 x, scale and dy "
                        f"of one dtype, got {x.dtype}, {scale.dtype}, "
                        f"{dy.dtype}")
    if not x.device == scale.device == dy.device:
        raise ValueError("lrn_bwd takes x, scale and dy on one device")
    alpha, beta = float(alpha), float(beta)
    dy = dy.contiguous()        # autograd may hand in a strided gradient
    if x.device.type == "cpu":
        return lrn_bwd_plain(x, scale, dy, size, alpha, beta)
    if x.device.type != "cuda":
        raise RuntimeError(f"lrn_bwd has no path for device {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("lrn_bwd kernel takes contiguous x and scale")
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    rc = _build.load().bigdl_lrn_bwd(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        _build.DTYPE_CODES[x.dtype], n, c, h * w, size, alpha / size, beta,
        _POW_MODES.get(beta, 2), _build.stream_ptr(x))
    _build.check(rc, "lrn_bwd")
    lrn_bwd.launches += 1
    return dx


lrn_bwd.launches = 0
