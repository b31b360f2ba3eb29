"""Pooling layers (``bigdl_tpu/nn/pooling.py``).

``SpatialMaxPooling`` runs the port's max-pool op (kernel K1 on the card);
``SpatialAveragePooling`` is plain torch with the JAX package's divisor
semantics (``count_include_pad`` and the divisor clamp at ``in + pad``).
The output-size rule, ceil mode included, is ``ops.pooling.pool_geometry``.
``RoiPooling`` is Fast R-CNN's region-of-interest max pool on stock torch
ops (the reference runs it on XLA, with no kernel of its own).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.nn.conv import _maybe_batched
from bigdl_tpu_torch.ops.pooling import max_pool2d, pool_geometry


class _SpatialPool(Module):

    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0):
        super().__init__()
        self.kernel_w, self.kernel_h = kw, kh
        self.stride_w = dw if dw is not None else kw
        self.stride_h = dh if dh is not None else kh
        # no pooling window may lie entirely in padding
        if not (pad_w < kw and pad_h < kh):
            raise ValueError(
                f"pad ({pad_h}, {pad_w}) must be < kernel ({kh}, {kw})")
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = False

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def _geometry(self, ih, iw):
        return pool_geometry(ih, iw, self.kernel_h, self.kernel_w,
                             self.stride_h, self.stride_w,
                             self.pad_h, self.pad_w, self.ceil_mode)


class SpatialMaxPooling(_SpatialPool):

    def forward(self, input):
        def run(x):
            return max_pool2d(x, self.kernel_h, self.kernel_w,
                              self.stride_h, self.stride_w,
                              self.pad_h, self.pad_w, self.ceil_mode)
        return _maybe_batched(run, input)


class SpatialAveragePooling(_SpatialPool):
    """Default Torch semantics: count_include_pad=True, divisor counts the
    window's overlap with the padded input (clamped at ih+pad)."""

    def __init__(self, kw, kh, dw=None, dh=None, pad_w=0, pad_h=0,
                 ceil_mode=False, count_include_pad=True, divide=True):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h)
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide
        self._divisor_cache = {}

    def _divisors(self, ih, iw, oh, ow, device, dtype):
        """The (oh, ow) divisor table, or a float when every window has the
        same count (no padding, no ceil overhang).  Tables are built once per
        (input size, mode, device, dtype) and kept on the device, so the
        forward never waits on a host-to-device copy."""
        key = (ih, iw, self.ceil_mode, self.count_include_pad, device, dtype)
        d = self._divisor_cache.get(key)
        if d is not None:
            return d

        def axis_counts(n_out, in_size, k, stride, pad, include_pad):
            starts = np.arange(n_out) * stride - pad
            ends = starts + k
            if include_pad:
                lo, hi = 0 - pad, in_size + pad
            else:
                lo, hi = 0, in_size
            return (np.minimum(ends, hi) - np.maximum(starts, lo)
                    ).clip(min=1).astype(np.float32)

        ch = axis_counts(oh, ih, self.kernel_h, self.stride_h, self.pad_h,
                         self.count_include_pad)
        cw = axis_counts(ow, iw, self.kernel_w, self.stride_w, self.pad_w,
                         self.count_include_pad)
        table = np.outer(ch, cw)
        if (table == table.flat[0]).all():
            d = float(table.flat[0])
        else:
            # a plain tensor even when first built under inference_mode
            with torch.inference_mode(False):
                d = torch.from_numpy(table).to(device=device, dtype=dtype)
        self._divisor_cache[key] = d
        return d

    def forward(self, input):
        def run(x):
            ih, iw = x.shape[2], x.shape[3]
            oh, ow, eh, ew = self._geometry(ih, iw)
            xp = torch.nn.functional.pad(x, (self.pad_w, ew, self.pad_h, eh))
            s = xp.unfold(2, self.kernel_h, self.stride_h) \
                  .unfold(3, self.kernel_w, self.stride_w).sum(dim=(-2, -1))
            if self.divide:
                s = s / self._divisors(ih, iw, oh, ow, s.device, s.dtype)
            return s
        return _maybe_batched(run, input)


# elements of one gathered chunk of RoiPooling's bins (256 MB in float32)
ROI_CHUNK_ELEMENTS = 1 << 26


def roi_bins(rois, h: int, w: int, pooled_h: int, pooled_w: int,
             spatial_scale: float):
    """The flat pixel index ``(R, ph, pw, KH, KW)`` into the (N * H * W)
    pixels of a feature map of every cell of every roi's bins, and whether
    the cell lies in its bin; ``KH``/``KW`` are the tallest and widest bin.

    A roi row is (1-based batch index, x1, y1, x2, y2) in image pixels; the
    corners scale by ``spatial_scale`` and round half to even
    (``torch.round``, as ``jnp.round``); bin i of an axis runs from
    floor(i * bin) to ceil((i + 1) * bin) past the roi's start, in float32
    as the reference computes it (IEEE division and products, so every
    device finds the same edges), clipped to the map."""
    rois = rois.float()
    batch = rois[:, 0].long() - 1
    x1, y1, x2, y2 = torch.round(rois[:, 1:5] * spatial_scale).long() \
        .unbind(1)

    def axis(lo, hi, n_bins, size):
        extent = (hi - lo + 1).clamp_min(1).float()
        # a tensor divisor: CUDA divides by a scalar as a product with its
        # reciprocal, one rounding off, and that moves a bin's edge
        step = extent / torch.full_like(extent, n_bins)
        i = torch.arange(n_bins, device=rois.device, dtype=torch.float32)
        start = torch.floor(i * step[:, None]).long() + lo[:, None]
        end = torch.ceil((i + 1) * step[:, None]).long() + lo[:, None]
        return start.clamp(0, size), end.clamp(0, size)

    hs, he = axis(y1, y2, pooled_h, h)                     # (R, ph)
    ws, we = axis(x1, x2, pooled_w, w)                     # (R, pw)
    kh, kw = (max(1, v) for v in torch.stack(
        [(he - hs).max(), (we - ws).max()]).tolist())
    ry = hs[:, :, None] + torch.arange(kh, device=rois.device)
    cx = ws[:, :, None] + torch.arange(kw, device=rois.device)
    valid = (ry < he[:, :, None])[:, :, None, :, None] & \
        (cx < we[:, :, None])[:, None, :, None, :]
    base = batch.clamp(0, None)[:, None, None, None, None] * h
    index = (base + ry.clamp(max=h - 1)[:, :, None, :, None]) * w + \
        cx.clamp(max=w - 1)[:, None, :, None, :]
    return index, valid


class _RoiPool(torch.autograd.Function):
    """The max over each bin's cells, a chunk of rois at a time; the
    backward recomputes each chunk and gives a bin's gradient to its cells
    that equal its max, split evenly among them as ``jnp.max``'s gradient
    splits a tie (an argmax would give it all to one).  A bin without a
    cell gives 0 and no gradient."""

    @staticmethod
    def forward(ctx, data, index, valid):
        n, c, h, w = data.shape
        r = index.shape[0]
        rows = data.permute(0, 2, 3, 1).reshape(n * h * w, c)
        chunk = max(1, ROI_CHUNK_ELEMENTS // max(1, index[0].numel() * c))
        out = data.new_empty((r,) + tuple(index.shape[1:3]) + (c,))
        for lo in range(0, r, chunk):
            v = rows[index[lo:lo + chunk]]       # (r', ph, pw, KH, KW, C)
            v = v.masked_fill(~valid[lo:lo + chunk, ..., None], -math.inf)
            out[lo:lo + chunk] = v.amax(dim=(3, 4))
        out.masked_fill_(~valid.any(dim=4).any(dim=3)[..., None], 0.0)
        ctx.save_for_backward(rows, index, valid, out)
        ctx.shape, ctx.chunk = (n, h, w, c), chunk
        return out.permute(0, 3, 1, 2).contiguous()

    @staticmethod
    def backward(ctx, grad):
        rows, index, valid, out = ctx.saved_tensors
        (n, h, w, c), chunk = ctx.shape, ctx.chunk
        g = grad.permute(0, 2, 3, 1)                        # (R, ph, pw, C)
        grad_rows = torch.zeros_like(rows)
        for lo in range(0, index.shape[0], chunk):
            sl = slice(lo, lo + chunk)
            hit = (rows[index[sl]] == out[sl, :, :, None, None, :]) & \
                valid[sl, ..., None]
            count = hit.sum(dim=(3, 4), keepdim=True).clamp_min(1)
            share = torch.where(hit, g[sl, :, :, None, None, :] / count,
                                0.0)
            grad_rows.index_add_(0, index[sl].reshape(-1),
                                 share.reshape(-1, c))
        return grad_rows.reshape(n, h, w, c).permute(0, 3, 1, 2), None, None


class RoiPooling(Module):
    """Region-of-interest max pooling (``nn/RoiPooling.scala``).

    Input: the table [features (N, C, H, W), rois (R, 5)], each roi row
    (1-based batch index, x1, y1, x2, y2) in image pixels, scaled by
    ``spatial_scale``.  Output (R, C, pooled_h, pooled_w): the max over
    each bin (:func:`roi_bins`), 0 for a bin that holds no cell.  Not the
    reference's broadcast, which masks a (C, ph, pw, H, W) tensor a roi:
    the port gathers each bin's cells, a chunk of rois at a time."""

    def __init__(self, pooled_w: int, pooled_h: int, spatial_scale: float):
        super().__init__()
        self.pooled_w, self.pooled_h = pooled_w, pooled_h
        self.spatial_scale = spatial_scale

    def forward(self, input):
        data, rois = input[0], input[1]
        n, c, h, w = data.shape
        rois = torch.as_tensor(rois, device=data.device)
        if rois.shape[0] == 0:
            return data.new_zeros((0, c, self.pooled_h, self.pooled_w))
        index, valid = roi_bins(rois, h, w, self.pooled_h, self.pooled_w,
                                self.spatial_scale)
        return _RoiPool.apply(data, index, valid)
