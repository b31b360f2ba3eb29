"""Linear (``bigdl_tpu/nn/linear.py``): y = x W^T + b, weight
``(outputSize, inputSize)`` as in Torch.

In a :func:`bigdl_tpu_torch.ops.quant.quantize_model` copy the weight is
packed and the product runs the fused dequant-matmul (``quant.int8_matmul``:
K13, K14 or K15 by rung); an fp weight takes ``F.linear`` and is the
calibration point (``quant.observe``), as ``matmul_or_observe`` is in the
reference."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.module import Module, seeded
from bigdl_tpu_torch.core.precision import promote
from bigdl_tpu_torch.ops import quant


class Linear(Module):

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 init_method: str = init_methods.DEFAULT):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.init_method = init_method
        self.weight = nn.Parameter(torch.empty(output_size, input_size))
        self.bias = nn.Parameter(torch.empty(output_size)) \
            if with_bias else None
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.copy_(init_methods.init_weight(
                self.init_method, gen, (self.output_size, self.input_size),
                fan_in=self.input_size, fan_out=self.output_size))
            if self.bias is not None:
                self.bias.copy_(init_methods.uniform(
                    gen, (self.output_size,),
                    1.0 / math.sqrt(self.input_size)))

    def forward(self, input):
        qt = quant.packed_weight(self)
        if qt is not None:
            y = quant.int8_matmul(input, qt)
            return y if self.bias is None else y + self.bias
        quant.observe(self, input)
        return F.linear(*promote(input, self.weight, self.bias))
