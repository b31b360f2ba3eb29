"""Quantized inference (``bigdl_tpu/ops/quant.py``): the weight codecs,
calibration, packing a model, and the fused dequant-matmul kernels K13-K15,
each beside its plain version.

Scheme (symmetric absmax, as in the reference): per-output-channel weight
scales, ``scale[n] = absmax(w[n]) / 127`` for the int8 rung (``/ 7`` for
int4, ``/ 448`` for e4m3), and for ``w8a8`` one per-tensor activation scale
per ``Linear`` from a calibration pass.  A packed weight is a dict of
tensors, ``{"q8", "scale"}`` (+ ``"sx"``), ``{"q4", "scale", "odd"}`` or
``{"f8", "scale"}``, bit-equal to the JAX package's for the same float32
weights: the same f32 division, ``torch.round`` rounds half to even as
``jnp.round`` does, and nibble bytes above 127 are stored as negative int8.

The kernels (``csrc/quant_matmul.cu``), ``y = x @ dequant(q).T``:

* K13 (:func:`w8_matmul`, :func:`f8_matmul`) replaces ``_w8_kernel``
  (``bigdl_tpu/ops/quant.py:417``, reached through ``_fused_call`` and, for
  e4m3 weights, ``_f8_pallas``): int8 or e4m3 weights widened inside the
  kernel, f32 accumulation, ``scale[n]`` applied once on the output before
  the single rounding to x's dtype.  bfloat16 x runs the Hopper kernel of
  ``csrc/quant_bf16.cuh``; float32 x the register-tiled FFMA kernel
  ``f32_mm`` (full f32, as the reference's product).
* K14 (:func:`a8_matmul`) replaces ``_a8_kernel`` (``quant.py:459``):
  int8 x int8 -> int32 on the int8 tensor cores (``wgmma`` s32.s8.s8),
  then ``float(acc) * s[n]``.  The sums are exact, so it is bit-equal to
  :func:`int8_a8_matmul_plain`.
* K15 (:func:`w4_matmul`) replaces ``_w4_kernel`` (``quant.py:441``): the
  split-half nibble layout is decoded in place, so x is never re-laid out
  (one K step reads a byte tile once, against x's columns ``[j, j + w)``
  for the low nibbles and ``[h + j, h + j + w)`` for the high ones); in
  float32 it runs ``f32_mm`` too.

The TPU kernels padded M/N/K to whole tiles in memory and carried the K
sum across grid steps.  What bounds the bf16 kernel on the H100 is the
bytes of the convs' patch matrices (x; 15-315 operations a byte, below
the card's 295 for all but one conv) and, at the classifier (M 8 or 32),
launch and K-chain latency.  So x's tiles and the packed weight's come by
TMA into a 4-stage ring while ``wgmma`` runs on the tiles that landed
(the weight widened exactly in shared memory, never in device memory), a
block's N tile covers up to 256 columns (x read once), and the grid is
planned per shape by :func:`bf16_plan` to fill the card.  float32 is
bound by FFMA's rate and by what shared memory hands it: ``f32_mm``
gives each thread an 8 x 8 micro-tile (4 FFMA a loaded register) and
feeds it through a 3-stage ``cp.async`` ring, the packed bytes widened
once a step into an f32 tile; :func:`f32_plan` picks the block tile by
N and M.  K14 is bound by latency: :func:`a8_plan` picks its N tile and
splits K so that the classifier's blocks reach the card's SMs, and the
last block of each output tile (an atomic ticket) adds the int32 partial
sums in split order in the same launch.  Wherever M tiles x N tiles give
fewer blocks than the card has SMs, K is split across blocks and the
partial sums are added in split order (no atomics on the sums: launches
are bit-equal).  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.  Each wrapper counts its launches in
``<wrapper>.launches`` (a split's second pass is part of one launch).
"""

from __future__ import annotations

import copy
import functools
import threading
from typing import Dict, Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.core.module import Container
from bigdl_tpu_torch.core.precision import promote
from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.ops import _build

# parameter names of matmul/conv weights the layers route through the
# quantized path (the reference's attention projections included)
QUANT_KEYS = ("weight", "wq", "wk", "wv", "wo")

# leaves smaller than this stay full precision
MIN_QUANT_ELEMENTS = 4096

# e4m3 finite max: the fp8 rung's absmax target (int8's 127, int4's 7)
F8_MAX = 448.0

# Declared per-rung budgets, against a bf16 tree (the packed tree serves
# cast_rest=bf16, so the resident ratio compares like with like): a top-1
# drop vs the bf16 baseline, the mean |delta logit| vs bf16, and the
# resident bytes over the bf16 tree's.
RUNG_BUDGETS = {
    "w8": {"max_top1_drop": 0.02, "max_mean_abs_dlogit": 0.10,
           "max_resident_ratio_vs_bf16": 0.60},
    "w8a8": {"max_top1_drop": 0.03, "max_mean_abs_dlogit": 0.15,
             "max_resident_ratio_vs_bf16": 0.60},
    "w4": {"max_top1_drop": 0.20, "max_mean_abs_dlogit": 0.35,
           "max_resident_ratio_vs_bf16": 0.30},
    "f8": {"max_top1_drop": 0.02, "max_mean_abs_dlogit": 0.12,
           "max_resident_ratio_vs_bf16": 0.55},
}
MODES = tuple(RUNG_BUDGETS)


def normalize_mode(quantize: Optional[str]) -> Optional[str]:
    """``"int8"`` is weight-only ``"w8"``, ``"int4"`` the nibble ``"w4"``
    rung, ``"fp8"`` the e4m3 ``"f8"`` rung."""
    return {"int8": "w8", "int4": "w4", "fp8": "f8"}.get(quantize, quantize)


def check_mode(mode: str, quantize) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown quantize mode {quantize!r} (expected "
                         "'w8'/'int8', 'w8a8', 'w4'/'int4' or 'f8'/'fp8')")


# -- codecs -------------------------------------------------------------------
# Every codec is per output channel, axis 0 of the stored layout (Linear's
# (out, in), conv's OIHW).

def _per_channel(scale, ndim: int):
    return scale.reshape((-1,) + (1,) * (ndim - 1))


def _absmax(w):
    return w.float().abs().amax(dim=tuple(range(1, w.dim())))


def quantize_channelwise(w):
    """Symmetric per-channel int8: ``(q8, scale)``, ``q8`` int8 of w's
    shape in [-127, 127], ``scale`` (w.shape[0],) f32."""
    scale = _absmax(w).clamp_min(1e-12) / 127.0
    q = torch.round(w.float() / _per_channel(scale, w.dim()))
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_channelwise(q8, scale, dtype=torch.float32):
    return (q8.float() * _per_channel(scale, q8.dim())).to(dtype)


def quantize_act(x, sx):
    """Per-tensor int8 activation quantization with a calibrated scale."""
    return torch.round(x.float() / sx).clamp(-127, 127).to(torch.int8)


def quantize_nibble(w):
    """Symmetric per-channel int4, two nibbles per byte, split-half packed
    along the last axis: byte ``j`` holds column ``j`` in its low nibble and
    column ``h + j`` (``h = ceil(K/2)``) in its high one; an odd K pads one
    zero nibble.  Returns ``(q4, scale)``, ``q4`` int8 of shape
    ``w.shape[:-1] + (h,)``."""
    scale = _absmax(w).clamp_min(1e-12) / 7.0
    q = torch.round(w.float() / _per_channel(scale, w.dim())) \
        .clamp(-7, 7).to(torch.int32)
    k = q.shape[-1]
    h = (k + 1) // 2
    lo = q[..., :h]
    hi = F.pad(q[..., h:], (0, h - (k - h)))
    byte = (lo & 15) | ((hi & 15) << 4)
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8), scale


def unpack_nibbles(q4, k: int):
    """Split-half nibbles back to int32 in [-7, 7], last axis ``k`` long."""
    b = q4.to(torch.int32)
    lo = ((b & 15) ^ 8) - 8
    hi = (((b >> 4) & 15) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1)[..., :k]


def dequantize_nibble(q4, scale, k: int, dtype=torch.float32):
    return (unpack_nibbles(q4, k).float()
            * _per_channel(scale, q4.dim())).to(dtype)


def quantize_f8(w):
    """Scaled e4m3: ``scale = absmax / 448``, then a straight cast (round to
    nearest even).  Returns ``(f8, scale)``."""
    scale = _absmax(w).clamp_min(1e-12) / F8_MAX
    return (w.float() / _per_channel(scale, w.dim())) \
        .to(torch.float8_e4m3fn), scale


def dequantize_f8(q, scale, dtype=torch.float32):
    return (q.float() * _per_channel(scale, q.dim())).to(dtype)


# -- packed weights -----------------------------------------------------------

def pack(w, sx=None, mode: str = "w8") -> Dict[str, torch.Tensor]:
    """One weight in the packed form of ``mode``.  ``"odd"`` is a zero-size
    int8 stamp whose first dim is K's parity.  An activation scale ``sx``
    pairs with the int8 rung only."""
    if mode == "w4":
        q4, scale = quantize_nibble(w)
        out = {"q4": q4, "scale": scale,
               "odd": torch.zeros((w.shape[-1] % 2, 0), dtype=torch.int8,
                                  device=w.device)}
    elif mode == "f8":
        f8, scale = quantize_f8(w)
        out = {"f8": f8, "scale": scale}
    else:
        q8, scale = quantize_channelwise(w)
        out = {"q8": q8, "scale": scale}
    if sx is not None:
        if mode != "w8":
            raise ValueError("activation scales pair with the int8 rung "
                             f"only (w8a8); {mode} serves weight-only")
        out["sx"] = torch.tensor(sx, dtype=torch.float32, device=w.device)
    return out


def packed_kind(qt) -> Optional[str]:
    """``"q8"`` / ``"q4"`` / ``"f8"`` for a packed weight, else None."""
    if not isinstance(qt, dict) or "scale" not in qt:
        return None
    for kind in ("q8", "q4", "f8"):
        if kind in qt:
            return kind
    return None


def packed_k(qt) -> int:
    """Original last-axis length of a ``q4`` weight."""
    return 2 * qt["q4"].shape[-1] - qt["odd"].shape[0]


def unpack(qt, dtype=torch.float32):
    """Widen a packed weight of any rung back to ``dtype``."""
    kind = packed_kind(qt)
    if kind == "q4":
        return dequantize_nibble(qt["q4"], qt["scale"], packed_k(qt),
                                 dtype=dtype)
    if kind == "f8":
        return dequantize_f8(qt["f8"], qt["scale"], dtype=dtype)
    return dequantize_channelwise(qt["q8"], qt["scale"], dtype=dtype)


def is_quantized(x) -> bool:
    return packed_kind(x) is not None


def maybe_unpack(w, dtype=torch.float32):
    return unpack(w, dtype) if is_quantized(w) else w


def packed_weight(module, name: str = "weight"
                  ) -> Optional[Dict[str, torch.Tensor]]:
    """The packed parameter ``name`` of a layer of a :func:`quantize_model`
    copy (its fields are buffers named ``<name>_<field>``), or None where
    that parameter is not packed."""
    fields = getattr(module, "packed_fields", {}).get(name)
    if not fields:
        return None
    return {f: getattr(module, f"{name}_{f}") for f in fields}


def int8_gather_rows(qt, idx):
    """Embedding rows ``idx`` of a packed table (``int8_gather_rows``): the
    packed rows and their per-row scales are gathered and only those rows
    widened, to float32 (the reference widens to its ``"dt"`` stamp, which
    no packed LM here carries), so the table stays packed on the card."""
    kind = packed_kind(qt)
    if kind == "q4":
        rows = unpack_nibbles(qt["q4"][idx], packed_k(qt)).float()
    elif kind == "f8":        # gathered as bytes: the same bits, any device
        rows = qt["f8"].view(torch.uint8)[idx].view(qt["f8"].dtype).float()
    else:
        rows = qt["q8"][idx].float()
    return rows * qt["scale"][idx][..., None]


# -- plain versions of the kernels -------------------------------------------

def int8_matmul_plain(x, q, scale):
    """K13's plain version (``int8_matmul_reference`` and
    ``f8_matmul_reference``): widen the int8 or e4m3 weight, f32 products
    and sums, output-side scale, one rounding to x's dtype."""
    acc = torch.matmul(x.float(), q.float().t())
    return (acc * scale[None, :]).to(x.dtype)


def int8_a8_matmul_plain(xq, q8, s_combined, out_dtype):
    """K14's plain version: exact integer sums (float64 holds every partial
    sum of int8 products exactly), ``float(acc) * s[n]`` in f32."""
    acc = torch.matmul(xq.double(), q8.double().t())
    return (acc.float() * s_combined[None, :]).to(out_dtype)


def int4_matmul_plain(x, q4, scale, k: int):
    """K15's plain version (``int4_matmul_reference``): unpack the nibbles,
    widen, f32 products and sums, output-side scale."""
    return int8_matmul_plain(x, unpack_nibbles(q4, k), scale)


# -- the bf16 kernel's plan --------------------------------------------------

MAX_BN = 256         # widest N tile: wgmma's largest N
H100_SMS = 132       # streaming multiprocessors of an H100 SXM


class Bf16Plan(NamedTuple):
    """The grid of the bf16 K13/K15 kernel for one product: ``bm`` rows a
    block (64, 128 or 192), ``bn`` columns a block (N over ``n_tiles``, rounded
    up to 8), ``splits`` blocks along K of ``per`` K steps each (the last
    may have fewer), of ``steps`` in all (64 x columns a step)."""
    bm: int
    bn: int
    n_tiles: int
    splits: int
    per: int
    steps: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def bf16_plan(m: int, k: int, n: int, nibbles: bool = False,
              sms: int = H100_SMS) -> Bf16Plan:
    """Plan the bf16 kernel's grid for an (M, K, N) product (``nibbles``:
    K15's int4 layout, 32 packed bytes a step) on a card of ``sms`` SMs.
    One N tile up to 256 columns, so x is read once; above, the fewest
    tiles of at most 256 (N 257-512 takes two), neighbours in the grid.
    The most rows a block (192 where the tile is at most 192 columns wide,
    128, or 64) that still give a block per SM: a block widens its weight
    tile once for all its rows.  Where the tiles give fewer blocks than
    ``sms``, K is split into the fewest non-empty splits that reach
    ``sms`` blocks, or one step each."""
    steps = _cdiv(_cdiv(k, 2), 32) if nibbles else _cdiv(k, 64)
    n_tiles = max(1, _cdiv(n, MAX_BN))
    bn = max(8, 8 * _cdiv(_cdiv(n, n_tiles), 8))
    bm = 64
    for rows in (192, 128):
        if (rows == 128 or bn <= 192) and _cdiv(m, rows) * n_tiles >= sms:
            bm = rows
            break
    tiles = max(1, _cdiv(m, bm) * n_tiles)
    splits, per = 1, steps
    if tiles < sms and steps > 1:
        splits, per = steps, 1
        for want in range(_cdiv(sms, tiles), steps + 1):
            p = _cdiv(steps, want)
            if tiles * _cdiv(steps, p) >= sms:
                splits, per = _cdiv(steps, p), p
                break
    return Bf16Plan(bm, bn, n_tiles, splits, per, steps)


def _k_splits(tiles: int, steps: int, sms: int):
    """``(splits, per)``: K unsplit where ``tiles`` blocks fill ``sms``
    SMs, else the fewest non-empty splits of ``per`` steps that reach
    ``sms`` blocks, or one step each."""
    if tiles >= sms or steps <= 1:
        return 1, steps
    for want in range(_cdiv(sms, tiles), steps + 1):
        per = _cdiv(steps, want)
        if tiles * _cdiv(steps, per) >= sms:
            return _cdiv(steps, per), per
    return steps, 1


# -- the f32 kernel's plan ---------------------------------------------------

F32_TILES = ((64, 128), (128, 64), (128, 32))    # (rows, columns) a block
F32_STEP = 16                                    # weight columns a K step
F32_BLOCKS_PER_SM = 2                            # blocks an SM to fill


class F32Plan(NamedTuple):
    """The grid of the f32 K13/K15 kernel for one product: ``bm`` x ``bn``
    a block (one of F32_TILES), ``n_tiles`` of them along N, ``splits``
    blocks along K of ``per`` K steps each (the last may have fewer), of
    ``steps`` in all (16 weight columns a step)."""
    bm: int
    bn: int
    n_tiles: int
    splits: int
    per: int
    steps: int


@functools.lru_cache(maxsize=None)
def f32_plan(m: int, k: int, n: int, nibbles: bool = False,
             sms: int = H100_SMS) -> F32Plan:
    """Plan the f32 kernel's grid for an (M, K, N) product (``nibbles``:
    K15's int4 layout, 8 packed bytes a step) on a card of ``sms`` SMs.
    The block tile that computes the least padding (its rows and columns
    past M and N), the widest on a tie: 64 x 128, 128 x 64, or 128 x 32
    (the 8 x 4 micro-tile) where N <= 32.  A block alone on an SM leaves
    its FFMA units waiting on shared memory, so where the tiles give fewer
    than F32_BLOCKS_PER_SM blocks an SM, K is split as :func:`bf16_plan`
    splits it, to that many blocks (filling one or three an SM measured
    slower over the forward's products: too few blocks, or the partial
    sums' traffic and a tail wave)."""
    steps = _cdiv(_cdiv(k, 2), F32_STEP // 2) if nibbles else \
        _cdiv(k, F32_STEP)
    bm, bn = min((t for t in F32_TILES if t[1] > 32 or n <= 32),
                 key=lambda t: _cdiv(m, t[0]) * t[0] * _cdiv(n, t[1]) * t[1])
    n_tiles = _cdiv(n, bn)
    splits, per = _k_splits(max(1, _cdiv(m, bm) * n_tiles), steps,
                            F32_BLOCKS_PER_SM * sms)
    return F32Plan(bm, bn, n_tiles, splits, per, steps)


# -- K14's plan ----------------------------------------------------------------

A8_BM = 64                 # rows a block: one warpgroup's wgmma
A8_BN = (256, 128, 64)     # its N tiles
A8_STEP = 128              # bytes of K a step
A8_TICKETS = 1024          # output tiles a split launch may have


class A8Plan(NamedTuple):
    """K14's grid for one product: 64 rows x ``bn`` columns a block,
    ``n_tiles`` along N, ``splits`` blocks along K of ``per`` K steps each
    (the last may have fewer), of ``steps`` in all (128 bytes a step)."""
    bn: int
    n_tiles: int
    splits: int
    per: int
    steps: int


@functools.lru_cache(maxsize=None)
def a8_plan(m: int, k: int, n: int, sms: int = H100_SMS) -> A8Plan:
    """Plan K14's grid for an (M, K, N) product on a card of ``sms`` SMs.
    K14 is bound by latency, so from the narrowest N tile that covers N
    (256 above 256) it narrows the tile until one K step a block would
    give ``sms`` blocks (64 columns at least), then splits K into the
    fewest splits that reach ``sms`` blocks, or one step each."""
    steps = _cdiv(k, A8_STEP)
    m_tiles = _cdiv(m, A8_BM)
    widths = [w for w in A8_BN
              if w <= min([c for c in A8_BN if c >= n] or [A8_BN[0]])]
    bn = next((w for w in widths if m_tiles * _cdiv(n, w) * steps >= sms),
              A8_BN[-1])
    n_tiles = _cdiv(n, bn)
    splits, per = _k_splits(max(1, m_tiles * n_tiles), steps, sms)
    return A8Plan(bn, n_tiles, splits, per, steps)


@functools.lru_cache(maxsize=None)
def _device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# -- wrappers -----------------------------------------------------------------

def _check_matmul(what, x, q, scale, kbytes):
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"{what} takes 2-D x and weight, got "
                         f"{tuple(x.shape)} and {tuple(q.shape)}")
    if q.shape[1] != kbytes or scale.shape != (q.shape[0],):
        raise ValueError(f"{what}: x {tuple(x.shape)}, weight "
                         f"{tuple(q.shape)} and scale {tuple(scale.shape)} "
                         "do not agree")
    if scale.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 scales, got {scale.dtype}")
    if not (x.device == q.device == scale.device):
        raise ValueError(f"{what}: x on {x.device}, weight on {q.device}, "
                         f"scale on {scale.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what} has no path for device {x.device}")


def _launch(fn, what, x, q, scale, y, *dims):
    for t in (x, q, scale):
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors")
    rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
            *dims, _build.stream_ptr(x))
    _build.check(rc, what)


def _dequant_launch(fn, what, x, q, scale, k, dims, nibbles):
    """Launch K13 or K15 (``fn``, ``dims`` its codes and shape) into a new
    y with the plan of x's dtype (:func:`bf16_plan` or :func:`f32_plan`)
    and, when that splits K, an f32 workspace of the partial sums."""
    m, n = x.shape[0], q.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    planner = bf16_plan if x.dtype == torch.bfloat16 else f32_plan
    p = planner(m, k, n, nibbles, _device_sms(x.device.index))
    ws = None
    if p.splits > 1:
        ws = torch.empty((p.splits, m, n), dtype=torch.float32,
                         device=x.device)
    _launch(fn, what, x, q, scale, y, *dims, p.bm, p.bn, p.splits,
            None if ws is None else ws.data_ptr())
    return y


def _dequant_matmul(wrapper, x, q, scale, wdtype):
    name = wrapper.__name__
    _check_matmul(name, x, q, scale, x.shape[1])
    if x.dtype not in _build.DTYPE_CODES or q.dtype != wdtype:
        raise TypeError(f"{name} takes float32 or bfloat16 x and {wdtype} "
                        f"weights, got {x.dtype} and {q.dtype}")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    m, k = x.shape
    y = _dequant_launch(_build.load().bigdl_w8_matmul, name, x, q, scale, k,
                        (_build.DTYPE_CODES[x.dtype],
                         _build.WEIGHT_CODES[wdtype], m, q.shape[0], k),
                        False)
    _build.count_launch(wrapper)
    return y


def w8_matmul(x, q8, scale):
    """K13 with int8 weights: ``(x @ q8.T) * scale`` in x's dtype, for x
    (M, K) float32 or bfloat16, ``q8`` (N, K) int8, ``scale`` (N,) f32."""
    return _dequant_matmul(w8_matmul, x, q8, scale, torch.int8)


def f8_matmul(x, f8, scale):
    """K13 with e4m3 weights (the same kernel body as :func:`w8_matmul`,
    as ``_f8_pallas`` reuses ``_w8_kernel``)."""
    return _dequant_matmul(f8_matmul, x, f8, scale, torch.float8_e4m3fn)


def a8_matmul(xq, q8, s_combined, out_dtype):
    """K14: ``float(xq @ q8.T as int32) * s_combined`` in ``out_dtype``, for
    ``xq`` (M, K) int8 from :func:`quantize_act` and ``s_combined`` = scale *
    sx computed in f32 by the caller."""
    _check_matmul("a8_matmul", xq, q8, s_combined, xq.shape[1])
    if xq.dtype != torch.int8 or q8.dtype != torch.int8 or \
            out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"a8_matmul takes int8 xq and weights and a float32 "
                        f"or bfloat16 output, got {xq.dtype}, {q8.dtype} "
                        f"and {out_dtype}")
    if xq.device.type == "cpu":
        return int8_a8_matmul_plain(xq, q8, s_combined, out_dtype)
    m, k = xq.shape
    n = q8.shape[0]
    y = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    p = a8_plan(m, k, n, _device_sms(xq.device.index))
    ws = tickets = None
    if p.splits > 1:
        ws = torch.empty((p.splits, m, n), dtype=torch.int32,
                         device=xq.device)
        tickets = _a8_tickets(xq)
        if _cdiv(m, A8_BM) * p.n_tiles > tickets.numel():
            raise ValueError(f"a8_matmul {(m, k, n)}: more split tiles than "
                             f"{tickets.numel()} tickets")
    _launch(_build.load().bigdl_a8_matmul, "a8_matmul", xq, q8, s_combined,
            y, _build.DTYPE_CODES[out_dtype], m, n, k, p.bn, p.splits,
            None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr())
    _build.count_launch(a8_matmul)
    return y


_tickets: Dict = {}


def _a8_tickets(xq):
    """K14's ticket counters for xq's card and current stream: zeroed once,
    and each launch leaves them zero (its last blocks reset theirs), so
    launches in stream order share them; another stream gets its own."""
    key = (xq.device.index, _build.stream_ptr(xq))
    t = _tickets.get(key)
    if t is None:
        t = _tickets.setdefault(key, torch.zeros(
            A8_TICKETS, dtype=torch.int32, device=xq.device))
    return t


def w4_matmul(x, q4, scale, k: int):
    """K15: ``(x @ unpack_nibbles(q4, k).T) * scale`` in x's dtype, for
    ``q4`` (N, ceil(K/2)) int8 split-half nibbles."""
    _check_matmul("w4_matmul", x, q4, scale, (k + 1) // 2)
    if x.shape[1] != k:
        raise ValueError(f"w4_matmul: x has {x.shape[1]} columns, the "
                         f"weight {k}")
    if x.dtype not in _build.DTYPE_CODES or q4.dtype != torch.int8:
        raise TypeError(f"w4_matmul takes float32 or bfloat16 x and int8 "
                        f"nibble bytes, got {x.dtype} and {q4.dtype}")
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, scale, k)
    y = _dequant_launch(_build.load().bigdl_w4_matmul, "w4_matmul", x, q4,
                        scale, k, (_build.DTYPE_CODES[x.dtype], x.shape[0],
                                   q4.shape[0], k), True)
    _build.count_launch(w4_matmul)
    return y


for _fn in (w8_matmul, f8_matmul, a8_matmul, w4_matmul):
    _fn.launches = 0


def int8_matmul(x, qt):
    """``y = x @ dequant(qt).T`` for every packed rung, without building
    ``dequant(qt)``: K13 for int8 and e4m3 weights, K14 when an int8 weight
    carries a calibrated ``"sx"`` (x is quantized first), K15 for nibbles.
    ``x`` is (..., K); returns (..., N) in x's dtype."""
    kind = packed_kind(qt)
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if kind == "q4":
        y = w4_matmul(x2, qt["q4"], qt["scale"], packed_k(qt))
    elif kind == "f8":
        y = f8_matmul(x2, qt["f8"], qt["scale"])
    elif "sx" in qt:
        y = a8_matmul(quantize_act(x2, qt["sx"]), qt["q8"],
                      qt["scale"] * qt["sx"], x.dtype)
    else:
        y = w8_matmul(x2, qt["q8"], qt["scale"])
    return y.reshape(lead + (y.shape[-1],))


def matmul_or_observe(module, name: str, x, b=None):
    """The one dispatch of every quant-aware product, ``x @ w.T + b`` with
    ``w`` the parameter ``name`` of ``module`` (``matmul_or_observe``): a
    packed ``w`` (:func:`packed_weight`) runs :func:`int8_matmul` (K13, K14
    or K15 by rung) in x's dtype, the bias added after; an fp ``w`` is the
    calibration point (:func:`observe`) and takes ``F.linear`` with the
    operands promoted as ``jnp`` promotes them."""
    qt = packed_weight(module, name)
    if qt is not None:
        y = int8_matmul(x, qt)
        return y if b is None else y + b
    w = getattr(module, name)
    observe(w, x)
    return F.linear(*promote(x, w, b))


def int8_conv2d(x, qt, padding=(0, 0)):
    """Stride-1 NCHW conv over a packed int8 OIHW weight: (C, kh, kw)
    patches of x from ``F.unfold`` (outside the kernel, as the reference
    leaves its patches to XLA), the int8 weight flattened to (O, C*kh*kw) as
    a view, and the product through K13.  Returns (N, O, OH, OW) in x's
    dtype, contiguous."""
    if packed_kind(qt) != "q8" or "sx" in qt:
        raise ValueError("int8_conv2d serves the weight-only int8 rung; "
                         "other packed conv weights take the widen path")
    o, _, kh, kw = qt["q8"].shape
    n, _, h, w = x.shape
    ph, pw = padding
    oh, ow = h + 2 * ph - kh + 1, w + 2 * pw - kw + 1
    cols = F.unfold(x, (kh, kw), padding=(ph, pw))     # (N, C*kh*kw, L)
    feat = cols.shape[1]
    # a view, not a copy, when n == 1: the kernel takes it contiguous
    p2 = cols.transpose(1, 2).reshape(n * oh * ow, feat).contiguous()
    y = w8_matmul(p2, qt["q8"].reshape(o, feat), qt["scale"])
    return y.reshape(n, oh, ow, o).permute(0, 3, 1, 2).contiguous()


# -- calibration --------------------------------------------------------------

_collector = threading.local()


def observe(w, x) -> None:
    """Calibration hook of every fp product site (:func:`matmul_or_observe`):
    records max |x| per weight ``w`` inside :class:`calibrating`, so the four
    projections of an attention layer each get their own input's scale; a
    no-op (one thread-local read) outside."""
    store = getattr(_collector, "store", None)
    if store is None:
        return
    v = float(x.detach().float().abs().max())
    store[id(w)] = max(store.get(id(w), 0.0), v)


class calibrating:
    """Context manager arming :func:`observe` with an absmax store keyed by
    weight (internal: :func:`calibrate` is the public pass)."""

    def __init__(self, store: Dict):
        self.store = store

    def __enter__(self):
        _collector.store = self.store
        return self.store

    def __exit__(self, *exc):
        _collector.store = None


def _walk(model, path: str = ""):
    """``(path, layer)`` for every layer, with the paths of its parameters'
    place in :meth:`~bigdl_tpu_torch.core.module.Module.param_tree` (a
    Container's or a ``ModuleList``'s children by index, any other child by
    attribute name: ``blocks.3.attn``, ``blocks.3.fc1``, ``""`` for the
    root), so calibration scales and packed leaves are keyed as
    ``bigdl_tpu.ops.quant._walk`` keys the JAX package's pytree."""
    if isinstance(model, Container):
        for i, m in enumerate(model.layers):
            yield from _walk(m, _param_path(path, str(i)))
        return
    yield path, model
    for name, child in model._modules.items():
        if isinstance(child, torch.nn.ModuleList):
            for i, m in enumerate(child):
                yield from _walk(m, _param_path(path, f"{name}.{i}"))
        elif child is not None:
            yield from _walk(child, _param_path(path, name))


def _param_path(path: str, name: str) -> str:
    return f"{path}.{name}" if path else name


def _quantizable(name: str, p, extra_keys=()):
    # shape[0] > 1: a singleton channel axis would make one per-tensor
    # scale out of the per-channel scheme
    return ((name in QUANT_KEYS or name in extra_keys) and p.dim() in (2, 4)
            and p.is_floating_point() and p.numel() >= MIN_QUANT_ELEMENTS
            and p.shape[0] > 1)


def calibrate(model, batches: Iterable) -> Dict[str, float]:
    """Run ``batches`` through the fp ``model`` in eval mode on its device,
    record the max |x| of each quantizable weight's input, and return
    ``{param_path: absmax / 127}`` for :func:`quantize_model`'s ``calib=``.
    Integer batches (token ids) stay integers; any other batch goes in as
    float32.  Writes a ``quant.calibration`` ledger record (sites, batches,
    scales) so the deployed scales are auditable."""
    device = next(model.parameters()).device
    store: Dict = {}
    nb = 0
    was_training = model.training
    model.eval()
    try:
        with calibrating(store), torch.inference_mode():
            for x in batches:
                nb += 1
                x = np.asarray(x)
                if not np.issubdtype(x.dtype, np.integer):
                    x = x.astype(np.float32)
                model(torch.as_tensor(x).to(device))
    finally:
        model.train(was_training)
    scales: Dict[str, float] = {}
    for path, m in _walk(model):
        for name, p in m._parameters.items():
            if p is not None and id(p) in store and _quantizable(name, p):
                scales[_param_path(path, name)] = \
                    max(store[id(p)], 1e-12) / 127.0
    run_ledger.emit("quant.calibration", batches=nb, sites=len(scales),
                    scales={p: float(s) for p, s in scales.items()})
    return scales


# -- packing a model ----------------------------------------------------------

def quantize_model(model, mode: str = "w8",
                   calib: Optional[Dict[str, float]] = None,
                   cast_rest=None, extra_keys: Sequence[str] = ()):
    """A private packed copy of ``model`` for quantized inference
    (``quantize_params``); the caller's model keeps its fp weights.

    Each parameter the reference packs (``_quantizable``: a ``QUANT_KEYS``
    name or one of ``extra_keys``, 2-D or 4-D, floating, at least
    ``MIN_QUANT_ELEMENTS``, ``shape[0] > 1``) is replaced by buffers
    ``<name>_<field>`` of its packed form, so ``.to(device)`` moves them,
    and its layer's ``packed_fields[name]`` names the fields
    (:func:`packed_weight`).  ``extra_keys=("tok",)`` packs a
    ``TransformerLM``'s tied table, whose per-row scales serve both the
    gather and the head.  ``"w8a8"`` bakes ``calib``'s activation scale
    into each calibrated leaf; a packed leaf without one (the tied head,
    which the reference never observes) serves weight-only.  Every other
    floating parameter is cast to ``cast_rest`` when given; scales stay
    f32."""
    req = mode
    mode = normalize_mode(mode)
    check_mode(mode, req)
    if mode == "w8a8" and not calib:
        raise ValueError("mode='w8a8' needs calib= activation scales from "
                         "calibrate(); weight-only quantization is "
                         "mode='w8'")
    leaf_mode = "w8" if mode == "w8a8" else mode
    qmodel = copy.deepcopy(model)
    with torch.no_grad():
        for path, m in _walk(qmodel):
            for name, p in list(m._parameters.items()):
                if p is None:
                    continue
                if _quantizable(name, p, extra_keys):
                    sx = calib.get(_param_path(path, name)) \
                        if mode == "w8a8" else None
                    leaf = pack(p.detach(), sx=sx, mode=leaf_mode)
                    m._parameters[name] = None
                    for f, t in leaf.items():
                        m.register_buffer(f"{name}_{f}", t)
                    m.packed_fields = dict(getattr(m, "packed_fields", {}),
                                           **{name: tuple(leaf)})
                else:
                    v = p.detach()
                    if cast_rest is not None and v.is_floating_point():
                        v = v.to(cast_rest)
                    m._parameters[name] = torch.nn.Parameter(
                        v, requires_grad=False)
    return qmodel.evaluate()


def param_bytes_by_dtype(model) -> Dict[str, int]:
    """Resident parameter and buffer bytes by dtype name (``int8``,
    ``float32``, ``bfloat16``, ``float8_e4m3fn``)."""
    out: Dict[str, int] = {}
    for t in list(model.parameters()) + list(model.buffers()):
        name = str(t.dtype).replace("torch.", "")
        out[name] = out.get(name, 0) + t.numel() * t.element_size()
    return out


def emit_param_bytes(model, kind: str, **attrs) -> Dict[str, int]:
    """Write the ``mem.params`` ledger record of a serving model and
    return its bytes by dtype."""
    by_dtype = param_bytes_by_dtype(model)
    run_ledger.emit("mem.params", kind=kind, bytes_by_dtype=by_dtype,
                    total_bytes=sum(by_dtype.values()), **attrs)
    return by_dtype
