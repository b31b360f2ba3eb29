"""SpatialConvolution (``bigdl_tpu/nn/conv.py``).

Weight layout OIHW ``(outC, inC/nGroup, kH, kW)``, NCHW input, groups, and
3-D CHW input lifted to batch 1.  The JAX package leaves convolution to
XLA (``lax.conv_general_dilated``), outside any Pallas kernel; the port
leaves it to ``torch.nn.functional.conv2d`` the same way.

A packed weight (a ``quant.quantize_model`` copy) takes the fused int8 conv
(``quant.int8_conv2d``: patches, then K13) when it is eligible: int8 rung,
no activation scale, stride 1, one group.  Every other packed weight is
widened to the input dtype and convolved by ``F.conv2d``; the bias is added
after the conv on both paths, as the reference adds it.  A subclass with
another geometry (dilation) must keep to the widen path.
"""

from __future__ import annotations

import math

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
        return (quant.packed_kind(qt) == "q8" and "sx" not in qt
                and self.stride_h == 1 and self.stride_w == 1
                and self.n_group == 1)

    def forward(self, input):
        qt = quant.packed_weight(self)
        stride = (self.stride_h, self.stride_w)
        padding = (self.pad_h, self.pad_w)

        def run(x):
            if qt is None:
                return F.conv2d(x, self.weight, self.bias, stride=stride,
                                padding=padding, groups=self.n_group)
            if self._fused_int8_eligible(qt):
                y = quant.int8_conv2d(x, qt, padding=padding)
            else:
                y = F.conv2d(x, quant.unpack(qt, x.dtype), stride=stride,
                             padding=padding, groups=self.n_group)
            return y if self.bias is None else \
                y + self.bias[None, :, None, None]
        return _maybe_batched(run, input)
