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
(C, pixels) blocks in VMEM and summed shifted copies, so each element was
read once and q formed once.  The CUDA kernels give each thread a vector
of adjacent pixels of one image (16 bytes in K2, 8 in K4; fewer, or a
single pixel, where the planes or the tensors' bases are not aligned to
them) and a chunk of channels, which it walks with the window kept in
registers: K2 sums each output's window of squares from registers, K4
forms q once as its channel enters the window.  :func:`lrn_plan` picks
the instantiation, the vector, the chunk and the grid.

What bounds both on the H100 is bytes: K2 reads x once and writes y (and
the optional ``scale``, kept for the backward) once; K4 reads x, scale and
dy once and writes dx once, at 3.35 TB/s; a chunk's halo of size - 1
channels is read again, from L2.  Window sums are taken in f32, in the
order of the reference's window sum.

:func:`lrn_plain` mirrors ``_lrn_xla`` (``ops/lrn.py:81-86``) and
:func:`lrn_bwd_plain` mirrors ``_bwd_kernel`` (``ops/lrn.py:133-141``),
including the ``_neg_pow`` forms; both compute in x's dtype, as the
reference does.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.quant import H100_SMS, _device_sms

_POW_MODES = {0.75: 0, 0.5: 1}      # csrc/lrn.cu PowMode; 2 = powf

# window sizes with their own instantiation (csrc/lrn.cu kFixedSize; the
# library refuses a plan that names another)
LRN_FIXED_SIZES = (5,)
LRN_GROUP = 2                   # planes a thread loads a step (kGroup)
LRN_THREADS = 128               # threads a block
LRN_MIN_CHUNK = 4               # channels a thread at least
# per kernel, K2 ("fwd") and K4 ("bwd"): the most bytes of adjacent
# pixels a thread loads from each tensor, and the threads the plan aims
# for on each SM.  K4 carries three tensors' windows, so 8 bytes and
# fewer, longer walks keep its registers and its halo in bounds
# (bench_lrn.py ablate)
LRN_VECTOR_BYTES = {"fwd": 16, "bwd": 8}
LRN_THREADS_PER_SM = {"fwd": 2048, "bwd": 512}


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


class LrnPlan(NamedTuple):
    """A launch of K2 or K4: the instantiation (``"size 5"`` for a window
    fixed at compile time, or ``"generic"``), ``vec`` adjacent pixels a
    thread (4, 8 or 16 bytes' worth, or 1), ``chunk`` channels a thread
    (the last chunk of a plane column may hold fewer), ``chunks`` chunks
    over C, ``vecs`` pixel vectors a plane, ``threads`` a block and
    ``blocks`` in all.  Thread t of the grid (pixel vectors fastest) owns
    vector t mod vecs, chunk (t // vecs) mod chunks, image t // (vecs *
    chunks)."""
    variant: str
    vec: int
    chunk: int
    chunks: int
    vecs: int
    threads: int
    blocks: int


@functools.lru_cache(maxsize=None)
def lrn_plan(n, c, hw, size, dtype, align, backward=False, sms=H100_SMS):
    """Plan K2 (or, ``backward``, K4) over an (n, c, hw) tensor on a card
    of ``sms`` SMs.  ``align``: the bytes (a power of two, at most 16)
    every tensor of the call is aligned to.  A thread takes the widest
    vector of adjacent pixels, 16, 8 or 4 bytes and at most
    LRN_VECTOR_BYTES, whose size divides ``hw`` and the alignment, else one
    pixel; the chunk is the largest that still gives about
    LRN_THREADS_PER_SM threads an SM (at least LRN_MIN_CHUNK channels),
    evened out over C."""
    key = "bwd" if backward else "fwd"
    itemsize = torch.empty((), dtype=dtype).element_size()
    vec = next((nbytes // itemsize for nbytes in (16, 8, 4)
                if itemsize < nbytes <= min(LRN_VECTOR_BYTES[key], align)
                and hw % (nbytes // itemsize) == 0), 1)
    vecs = -(-hw // vec)
    want = -(-LRN_THREADS_PER_SM[key] * sms // (n * vecs))
    chunk = max(LRN_MIN_CHUNK, -(-c // want))
    chunks = -(-c // chunk)
    chunk = -(-c // chunks)         # the same chunks, evened out
    chunks = -(-c // chunk)
    variant = f"size {size}" if size in LRN_FIXED_SIZES else "generic"
    return LrnPlan(variant, vec, chunk, chunks, vecs, LRN_THREADS,
                   -(-n * chunks * vecs // LRN_THREADS))


def lrn_plan_for(tensors, size, backward=False):
    """The plan of a call on CUDA ``tensors`` (x first)."""
    x = tensors[0]
    n, c, h, w = x.shape
    ptrs = 0
    for t in tensors:
        ptrs |= t.data_ptr()
    align = min(16, ptrs & -ptrs) if ptrs else 16
    return lrn_plan(n, c, h * w, size, x.dtype, align, backward,
                    _device_sms(x.device.index))


def _plan_args(tensors, size, backward=False):
    """The plan's arguments of the C entry points for a call on
    ``tensors`` (x first): fixed size (0 generic), vec, chunk, threads."""
    p = lrn_plan_for(tensors, size, backward)
    return (size if p.variant != "generic" else 0, p.vec, p.chunk,
            p.threads)


def _launch(x, size, alpha, beta, k, with_scale):
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    scale = torch.empty_like(x) if with_scale else None
    lib = _build.load()
    rc = lib.bigdl_lrn_fwd(
        x.data_ptr(), y.data_ptr(),
        None if scale is None else scale.data_ptr(),
        _build.DTYPE_CODES[x.dtype], n, c, h * w, size, alpha / size, beta,
        k, _POW_MODES.get(beta, 2), *_plan_args((x, y), size),
        _build.stream_ptr(x))
    _build.check(rc, "lrn_fwd")
    _build.count_launch(cross_map_lrn)
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
    if x.device.type == "cuda":
        # the kernel reads NCHW in order: a channels-last input (cuDNN
        # keeps a channels-last batch so) or another strided one is copied
        x = x.contiguous()
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
        _POW_MODES.get(beta, 2),
        *_plan_args((x, scale, dy, dx), size, backward=True),
        _build.stream_ptr(x))
    _build.check(rc, "lrn_bwd")
    _build.count_launch(lrn_bwd)
    return dx


lrn_bwd.launches = 0
