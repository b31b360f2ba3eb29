"""Pooling layers (``bigdl_tpu/nn/pooling.py``).

``SpatialMaxPooling`` runs the port's max-pool op (kernel K1 on the card);
``SpatialAveragePooling`` is plain torch with the JAX package's divisor
semantics (``count_include_pad`` and the divisor clamp at ``in + pad``).
The output-size rule, ceil mode included, is ``ops.pooling.pool_geometry``.
"""

from __future__ import annotations

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
