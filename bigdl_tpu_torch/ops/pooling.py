"""NCHW max pool with a stored argmax code: kernels K1 (forward) and K3
(backward), each beside its plain version, and their autograd pair.

K1 replaces ``bigdl_tpu/ops/pooling.py`` ``_fwd_kernel`` (the Pallas forward
reached through ``_max_pool_fwd_impl``) and K3 its ``_bwd_kernel`` (reached
through ``_max_pool_pallas_bwd``), both in ``csrc/max_pool.cu``.  The TPU
kernels emulated strided window reads and the backward scatter with one-hot
MXU matmuls and padded with a finite bf16 minimum, all Mosaic workarounds;
the CUDA kernels read windows from shared memory and skip padding cells.

What bounds both on the H100 is bytes: K1 reads x once and writes y and the
optional uint8 index once; K3 reads dy and the index once and writes dx
once, at 3.35 TB/s.  A block stages a contiguous span of its planes in
shared memory (16-byte copies), computes every output of the span from
there and stores the span with 16-byte stores; :func:`pool_plan` picks the
planes a block, or the rows of a band of one plane with its halo (and the
columns of a tile, where a row is over the budget), and the threads a
block.  The kernels are templated on the path's windows (3x3 stride 2, 3x3
stride 1, 2x2 stride 2) with a generic instantiation for the rest
(:func:`pool_variant`).

Contract shared by the kernels and their plain versions: the window is
scanned in row-major order and compared in f32 with a strict ``>``, so ties
keep the FIRST maximal offset; the index is the window-offset code
``p * kw + q`` as uint8.  The backward sums in f32, over ``q`` within each
window row ``p`` and then over ``p`` in ascending order, and rounds once to
dy's dtype, so K3 is bit-equal to :func:`max_pool2d_bwd_plain`.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from bigdl_tpu_torch.ops import _build


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


def max_pool2d_bwd_plain(dy, idx, geom, ih, iw):
    """Plain PyTorch max-pool backward (``_max_pool_pallas_bwd``): route
    each ``dy`` to the window offset its uint8 code names.  Sums in f32 over
    ``q`` within each window row ``p``, then over ``p`` in ascending order,
    and rounds once to dy's dtype."""
    kh, kw, sh, sw, ph, pw, ceil_mode = geom
    n, c, oh, ow = dy.shape
    _, _, eh, ew = pool_geometry(ih, iw, kh, kw, sh, sw, ph, pw, ceil_mode)
    dy32 = dy.float()
    acc = torch.zeros((n, c, ih + ph + eh, iw + pw + ew), device=dy.device)
    for p in range(kh):
        row = torch.zeros((n, c, oh, acc.shape[3]), device=dy.device)
        for q in range(kw):
            hit = idx == p * kw + q
            row[:, :, :, q:q + (ow - 1) * sw + 1:sw] += torch.where(
                hit, dy32, torch.zeros_like(dy32))
        acc[:, :, p:p + (oh - 1) * sh + 1:sh, :] += row
    return acc[:, :, ph:ph + ih, pw:pw + iw].to(dy.dtype)


# -- the kernels' plan ----------------------------------------------------------

H100_SMS = 132
POOL_SMEM_BUDGET = 48 * 1024     # a block's shared memory, so 4 blocks an SM
POOL_SMEM_LIMIT = 232448         # the most one block can have on the H100
POOL_BLOCKS_PER_SM = 8           # blocks the plan aims for on each SM
POOL_MAX_THREADS = 256
# the instantiations, by the code ``csrc/max_pool.cu``
# ``bigdl_max_pool2d_variant`` gives a window (the one table of which
# window takes which is there)
POOL_VARIANTS = ("generic", "3x3/2", "3x3/1", "2x2/2")


def pool_variant(kh, kw, sh, sw):
    """The instantiation of K1 and K3 a window takes, as the library picks
    it: one of the path's fixed windows (``"3x3/2"``, ``"3x3/1"``,
    ``"2x2/2"``) or ``"generic"``.  Loads (and builds) the library."""
    return POOL_VARIANTS[_build.load().bigdl_max_pool2d_variant(kh, kw, sh,
                                                                 sw)]


class PoolPlan(NamedTuple):
    """A launch of K1 or K3: ``planes`` whole planes a block, or (planes 1)
    bands of ``rows`` rows of one plane, y rows in K1 and dx rows in K3
    (``rows`` is the plane's all in whole-plane blocks), cut into tiles of
    ``cols`` columns, y columns in K1 and dx columns in K3, when a row is
    over the budget (``cols`` is the row's all otherwise); ``bands`` a
    plane, ``tiles`` a row, ``blocks`` in all, ``threads`` a block and
    ``smem`` bytes of dynamic shared memory a block, as the kernels' entry
    points size it."""
    planes: int
    rows: int
    cols: int
    bands: int
    tiles: int
    blocks: int
    threads: int
    smem: int


def _r16(nbytes):
    return (nbytes + 15) // 16 * 16


def pool_smem(h, w, geom, itemsize, planes, rows, cols, backward=False):
    """Shared memory of the largest K1 (or, ``backward``, K3) block of
    ``planes`` planes of ``rows`` rows and ``cols`` columns, as
    ``csrc/max_pool.cu`` ``fwd_smem`` / ``bwd_smem`` size it: each span in a
    region of 16 bytes more than it holds, 16-byte aligned.  K1: x (a
    band's input rows, a tile's input columns in rows of ``(cols - 1) * sw
    + kw``), y, idx.  K3: dy and the codes of the windows that reach the
    block's dx rows and columns, dx, and the generic window's tables of the
    rows' and columns' (quotient, remainder) by the stride (counted for
    every window)."""
    kh, kw, sh, sw = geom[:4]
    oh, ow, _, _ = pool_geometry(h, w, *geom)
    full, width = (h, w) if backward else (oh, ow)
    whole, tiled = rows >= full and cols >= width, cols < width
    n_out = planes * rows * cols
    if backward:
        win = oh if whole else min(oh, (rows + kh - 2) // sh + 1)
        pitch = (cols + kw - 2) // sw + 1 if tiled else ow
        n_in = planes * win * pitch
        return (_r16(16 + n_in * itemsize) + _r16(16 + n_in) +
                _r16(16 + n_out * itemsize) + 8 * (rows + cols))
    rows_in = h if whole else min(h, (rows - 1) * sh + kh)
    pitch = (cols - 1) * sw + kw if tiled else w
    n_in = planes * rows_in * pitch
    return (_r16(16 + n_in * itemsize) + _r16(16 + n_out * itemsize) +
            _r16(16 + n_out))


@functools.lru_cache(maxsize=None)
def pool_plan(n, c, h, w, geom, dtype, backward=False, sms=H100_SMS):
    """Plan K1 (or, ``backward``, K3) over an (n, c, h, w) input on a card
    of ``sms`` SMs.  Whole planes share a block while the blocks stay at
    least POOL_BLOCKS_PER_SM an SM and their shared memory within
    POOL_SMEM_BUDGET; with one plane a block, a plane is cut into bands of
    rows when it is over the budget or when there are too few planes for
    that many blocks, and a row over the budget into tiles of columns (in
    K3 a multiple of the stride, so that a tile starts on a stride cell).
    About four work items a thread, 64 to 256 threads."""
    oh, ow, _, _ = pool_geometry(h, w, *geom)
    size = torch.empty((), dtype=dtype).element_size()
    planes = n * c
    full, width = (h, w) if backward else (oh, ow)
    step = geom[3] if backward else 1

    def smem(g, rows, cols=width):
        return pool_smem(h, w, geom, size, g, rows, cols, backward)

    target = POOL_BLOCKS_PER_SM * sms
    g = max(1, planes // target)
    while g > 1 and smem(g, full) > POOL_SMEM_BUDGET:
        g -= 1
    rows, cols = full, width
    if g == 1:
        if planes < target:
            rows = -(-full // -(-target // planes))
        while rows > 1 and smem(1, rows) > POOL_SMEM_BUDGET:
            rows -= 1
        while cols > step and smem(1, rows, cols) > POOL_SMEM_BUDGET:
            cols = max(step, cols // 2 // step * step)
    bands = -(-full // rows)
    rows = -(-full // bands)        # the same bands, evened out
    tiles = -(-width // cols)
    threads = 64
    while threads < POOL_MAX_THREADS and 4 * threads < g * rows * cols:
        threads *= 2
    return PoolPlan(g, rows, cols, bands, tiles,
                    -(-planes // g) * bands * tiles, threads,
                    smem(g, rows, cols))


@functools.lru_cache(maxsize=None)
def _device_sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x, kh, kw, sh, sw, ph, pw, ceil_mode, with_idx):
    n, c, ih, iw = x.shape
    geom = (kh, kw, sh, sw, ph, pw, ceil_mode)
    oh, ow, _, _ = pool_geometry(ih, iw, *geom)
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    idx = torch.empty((n, c, oh, ow), dtype=torch.uint8, device=x.device) \
        if with_idx else None
    p = pool_plan(n, c, ih, iw, geom, x.dtype,
                  sms=_device_sms(x.device.index))
    lib = _build.load()
    rc = lib.bigdl_max_pool2d_fwd(
        x.data_ptr(), y.data_ptr(), None if idx is None else idx.data_ptr(),
        _build.DTYPE_CODES[x.dtype], n, c, ih, iw, kh, kw, sh, sw, ph, pw,
        oh, ow, p.planes, p.rows, p.cols, p.threads, _build.stream_ptr(x))
    _build.check(rc, "max_pool2d_fwd")
    _build.count_launch(max_pool2d)
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


def _forward(x, geom, with_idx):
    """``(y, idx)`` by the device's route; ``idx`` is None when not asked
    for on the card, where the kernel then skips that write."""
    if x.device.type == "cpu":
        y, idx = max_pool2d_plain(x, *geom)
        return y, idx if with_idx else None
    if x.device.type == "cuda":
        if not x.is_contiguous():
            raise ValueError("max_pool2d kernel takes a contiguous tensor")
        return _launch(x, *geom, with_idx=with_idx)
    raise RuntimeError(f"max_pool2d has no path for device {x.device}")


class _MaxPool2d(torch.autograd.Function):
    """K1 with the index write on in forward, K3 in backward."""

    @staticmethod
    def forward(ctx, x, geom):
        y, idx = _forward(x, geom, with_idx=True)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(idx)
        ctx.geom, ctx.in_hw = geom, tuple(x.shape[2:])
        return y, idx

    @staticmethod
    def backward(ctx, dy, _didx):
        (idx,) = ctx.saved_tensors
        return max_pool2d_bwd(dy, idx, ctx.geom, *ctx.in_hw), None


def max_pool2d(x, kh, kw, sh, sw, ph=0, pw=0, ceil_mode=False,
               return_indices=False):
    """NCHW max pool: the K1 kernel for a CUDA tensor, the plain version for
    a CPU tensor.  ``return_indices`` also returns the uint8 argmax codes.
    When autograd will need them (grad enabled and ``x`` requires grad) the
    codes are written and saved for the K3 backward; otherwise, unless
    asked for, the kernel skips that write."""
    _validate(x, kh, kw, sh, sw, ph, pw, ceil_mode)
    geom = (kh, kw, sh, sw, ph, pw, ceil_mode)
    if x.device.type == "cuda":
        # the kernel reads NCHW in order: a channels-last input (cuDNN
        # keeps a channels-last batch so) or another strided one is copied
        x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        y, idx = _MaxPool2d.apply(x, geom)
    else:
        y, idx = _forward(x, geom, with_idx=return_indices)
    return (y, idx) if return_indices else y


max_pool2d.launches = 0


def max_pool2d_bwd(dy, idx, geom, ih, iw):
    """Max-pool backward: ``dx`` (N, C, ih, iw) in dy's dtype from ``dy``
    and the uint8 codes of the forward.  The K3 kernel for CUDA tensors,
    :func:`max_pool2d_bwd_plain` for CPU tensors."""
    kh, kw, sh, sw, ph, pw, ceil_mode = geom
    if dy.dim() != 4 or dy.shape != idx.shape:
        raise ValueError(f"max_pool2d_bwd takes NCHW dy and idx of one "
                         f"shape, got {tuple(dy.shape)} and "
                         f"{tuple(idx.shape)}")
    if dy.dtype not in _build.DTYPE_CODES or idx.dtype != torch.uint8:
        raise TypeError(f"max_pool2d_bwd takes float32 or bfloat16 dy and "
                        f"uint8 idx, got {dy.dtype} and {idx.dtype}")
    if dy.device != idx.device:
        raise ValueError(f"dy on {dy.device} but idx on {idx.device}")
    oh, ow, _, _ = pool_geometry(ih, iw, kh, kw, sh, sw, ph, pw, ceil_mode)
    if (oh, ow) != tuple(dy.shape[2:]):
        raise ValueError(f"dy has {tuple(dy.shape[2:])} windows, the "
                         f"geometry over {(ih, iw)} gives {(oh, ow)}")
    dy = dy.contiguous()        # autograd may hand in a strided gradient
    if dy.device.type == "cpu":
        return max_pool2d_bwd_plain(dy, idx, geom, ih, iw)
    if dy.device.type != "cuda":
        raise RuntimeError(f"max_pool2d_bwd has no path for device "
                           f"{dy.device}")
    if not idx.is_contiguous():
        raise ValueError("max_pool2d_bwd kernel takes a contiguous idx")
    n, c = dy.shape[:2]
    dx = torch.empty((n, c, ih, iw), dtype=dy.dtype, device=dy.device)
    p = pool_plan(n, c, ih, iw, tuple(geom), dy.dtype, backward=True,
                  sms=_device_sms(dy.device.index))
    rc = _build.load().bigdl_max_pool2d_bwd(
        dy.data_ptr(), idx.data_ptr(), dx.data_ptr(),
        _build.DTYPE_CODES[dy.dtype], n, c, ih, iw, kh, kw, sh, sw, ph, pw,
        oh, ow, p.planes, p.rows, p.cols, p.threads, _build.stream_ptr(dy))
    _build.check(rc, "max_pool2d_bwd")
    _build.count_launch(max_pool2d_bwd)
    return dx


max_pool2d_bwd.launches = 0
