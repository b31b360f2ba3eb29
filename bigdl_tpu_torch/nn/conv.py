"""The convolutions (``bigdl_tpu/nn/conv.py``).

``SpatialConvolution``: weight layout OIHW ``(outC, inC/nGroup, kH, kW)``,
NCHW input, groups, and 3-D CHW input lifted to batch 1.  The JAX package
leaves convolution to XLA (``lax.conv_general_dilated``), outside any
Pallas kernel; the port leaves it to ``torch.nn.functional`` the same
way.  ``SpatialShareConvolution`` is the same layer (buffer sharing is
moot here), ``SpatialDilatedConvolution`` adds the kernel's dilation,
``SpatialFullConvolution`` is the transposed convolution of Torch's
``(inC, outC/nGroup, kH, kW)`` weight (``F.conv_transpose2d``'s own
layout; ``adj`` is its ``output_padding``), and
``SpatialConvolutionMap`` convolves with a dense ``(outC, inC, kH, kW)``
weight times a fixed 0/1 connection mask (a buffer) from a table of
1-based (input plane, output plane) pairs.

A packed weight (a ``quant.quantize_model`` copy) takes the fused int8 conv
(``quant.int8_conv2d``: patches, then K13) when it is eligible: int8 rung,
no activation scale, stride 1, one group, and a layer of the base geometry
(``_fused_int8_ok``: the patches carry no dilation, so the dilated layer
opts out).  Every other packed weight is widened to the input dtype and
convolved as the fp weight is; the bias is added after the conv on both
paths, as the reference adds it.  The full convolution's packed weight is
packed on its first axis, the input planes, as the reference packs it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.module import Module, seeded
from bigdl_tpu_torch.ops import quant


def _maybe_batched(fn, input):
    """Torch layers accept both CHW and NCHW; lift 3-D inputs to batch 1."""
    if input.dim() == 3:
        return fn(input.unsqueeze(0))[0]
    return fn(input)


class SpatialConvolution(Module):

    # a subclass of another geometry (dilation) keeps to the widen path
    _fused_int8_ok = True
    dilation_w = dilation_h = 1

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 init_method: str = init_methods.DEFAULT,
                 with_bias: bool = True):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes ({n_input_plane}, {n_output_plane}) "
                             f"must divide by n_group={n_group}")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.propagate_back = propagate_back
        self.init_method = init_method
        self.with_bias = with_bias
        self.weight = nn.Parameter(torch.empty(
            n_output_plane, n_input_plane // n_group, kernel_h, kernel_w))
        self.bias = nn.Parameter(torch.empty(n_output_plane)) \
            if with_bias else None
        self.reset_parameters(seeded())

    def _fans(self):
        fan_in = (self.n_input_plane // self.n_group) * \
            self.kernel_h * self.kernel_w
        fan_out = (self.n_output_plane // self.n_group) * \
            self.kernel_h * self.kernel_w
        return fan_in, fan_out

    def reset_parameters(self, gen):
        fan_in, fan_out = self._fans()
        with torch.no_grad():
            self.weight.copy_(init_methods.init_weight(
                self.init_method, gen, tuple(self.weight.shape), fan_in,
                fan_out))
            if self.bias is not None:
                self.bias.copy_(init_methods.uniform(
                    gen, (self.n_output_plane,), 1.0 / math.sqrt(fan_in)))

    def _fused_int8_eligible(self, qt) -> bool:
        return (self._fused_int8_ok
                and quant.packed_kind(qt) == "q8" and "sx" not in qt
                and self.stride_h == 1 and self.stride_w == 1
                and self.n_group == 1)

    def _conv(self, x, w, b=None):
        return F.conv2d(x, w, b, stride=(self.stride_h, self.stride_w),
                        padding=(self.pad_h, self.pad_w),
                        dilation=(self.dilation_h, self.dilation_w),
                        groups=self.n_group)

    def forward(self, input):
        qt = quant.packed_weight(self)

        def run(x):
            if qt is None:
                return self._conv(x, self.weight, self.bias)
            if self._fused_int8_eligible(qt):
                y = quant.int8_conv2d(x, qt,
                                      padding=(self.pad_h, self.pad_w))
            else:
                y = self._conv(x, quant.unpack(qt, x.dtype))
            return _add_bias(y, self.bias)
        return _maybe_batched(run, input)


def _add_bias(y, bias):
    return y if bias is None else y + bias[None, :, None, None]


class SpatialShareConvolution(SpatialConvolution):
    """``nn/SpatialShareConvolution.scala``: ``SpatialConvolution``'s math
    (its buffer sharing is the allocator's business here)."""


class SpatialDilatedConvolution(SpatialConvolution):
    """``nn/SpatialDilatedConvolution.scala``: the kernel dilated by
    ``(dilation_h, dilation_w)``."""

    _fused_int8_ok = False

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 dilation_w: int = 1, dilation_h: int = 1,
                 init_method: str = init_methods.DEFAULT):
        super().__init__(n_input_plane, n_output_plane, kw, kh, dw, dh,
                         pad_w, pad_h, init_method=init_method)
        self.dilation_w, self.dilation_h = dilation_w, dilation_h


class SpatialFullConvolution(Module):
    """Transposed convolution (``nn/SpatialFullConvolution.scala``): output
    size (iH - 1) * dH - 2 * padH + kH + adjH, ``adj`` below the stride."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 adj_w: int = 0, adj_h: int = 0,
                 n_group: int = 1, no_bias: bool = False,
                 init_method: str = init_methods.DEFAULT):
        super().__init__()
        if not (adj_w < dw and adj_h < dh):
            raise ValueError("adjW/adjH must be smaller than "
                             "strideW/strideH")
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes ({n_input_plane}, {n_output_plane}) "
                             f"must divide by n_group={n_group}")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kw, kh
        self.stride_w, self.stride_h = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.adj_w, self.adj_h = adj_w, adj_h
        self.n_group = n_group
        self.with_bias = not no_bias
        self.init_method = init_method
        self.weight = nn.Parameter(torch.empty(
            n_input_plane, n_output_plane // n_group, kh, kw))
        self.bias = nn.Parameter(torch.empty(n_output_plane)) \
            if self.with_bias else None
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        fan_in = (self.n_output_plane // self.n_group) * \
            self.kernel_h * self.kernel_w
        with torch.no_grad():
            self.weight.copy_(init_methods.init_weight(
                self.init_method, gen, tuple(self.weight.shape), fan_in,
                fan_in))
            if self.bias is not None:
                self.bias.copy_(init_methods.uniform(
                    gen, (self.n_output_plane,), 1.0 / math.sqrt(fan_in)))

    def forward(self, input):
        qt = quant.packed_weight(self)

        def run(x):
            w = self.weight if qt is None else quant.unpack(qt, x.dtype)
            y = F.conv_transpose2d(
                x, w, stride=(self.stride_h, self.stride_w),
                padding=(self.pad_h, self.pad_w),
                output_padding=(self.adj_h, self.adj_w),
                groups=self.n_group)
            return _add_bias(y, self.bias)
        return _maybe_batched(run, input)


class SpatialConvolutionMap(Module):
    """Connection-table convolution (``nn/SpatialConvolutionMap.scala``):
    ``conn_table`` is an (nKernels, 2) array of 1-based (inPlane,
    outPlane) pairs; the planes are its largest entries."""

    def __init__(self, conn_table, kw: int, kh: int,
                 dw: int = 1, dh: int = 1, pad_w: int = 0, pad_h: int = 0):
        super().__init__()
        ct = np.asarray(conn_table, dtype=np.int64)
        self.conn_table = ct
        self.n_input_plane = int(ct[:, 0].max())
        self.n_output_plane = int(ct[:, 1].max())
        self.kernel_w, self.kernel_h = kw, kh
        self.stride_w, self.stride_h = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        mask = torch.zeros(self.n_output_plane, self.n_input_plane, 1, 1)
        mask[ct[:, 1] - 1, ct[:, 0] - 1] = 1.0
        self.register_buffer("mask", mask)
        self.weight = nn.Parameter(torch.empty(
            self.n_output_plane, self.n_input_plane, kh, kw))
        self.bias = nn.Parameter(torch.empty(self.n_output_plane))
        self.reset_parameters(seeded())

    @staticmethod
    def full(n_in: int, n_out: int):
        ins, outs = np.meshgrid(np.arange(1, n_in + 1),
                                np.arange(1, n_out + 1))
        return np.stack([ins.ravel(), outs.ravel()], axis=1)

    @staticmethod
    def one_to_one(n_features: int):
        idx = np.arange(1, n_features + 1)
        return np.stack([idx, idx], axis=1)

    def reset_parameters(self, gen):
        """U(-1, 1) over sqrt of each output plane's fan (its connected
        inputs times kH * kW), the weight and the bias alike."""
        fan = self.mask[:, :, 0, 0].sum(dim=1).clamp_min(1.0) * \
            self.kernel_h * self.kernel_w
        with torch.no_grad():
            w = torch.rand(tuple(self.weight.shape), generator=gen) * 2 - 1
            self.weight.copy_(w / fan.sqrt()[:, None, None, None])
            b = torch.rand(self.n_output_plane, generator=gen) * 2 - 1
            self.bias.copy_(b / fan.sqrt())

    def forward(self, input):
        qt = quant.packed_weight(self)

        def run(x):
            w = self.weight if qt is None else quant.unpack(qt, x.dtype)
            y = F.conv2d(x, w * self.mask.to(w.dtype),
                         stride=(self.stride_h, self.stride_w),
                         padding=(self.pad_h, self.pad_w))
            return _add_bias(y, self.bias)
        return _maybe_batched(run, input)
