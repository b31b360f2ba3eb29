"""Linear and the parameterized scalar layers (``bigdl_tpu/nn/linear.py``).

``Linear``: y = x W^T + b, weight ``(outputSize, inputSize)`` as in Torch.
``Bilinear``: y_k = x1^T W_k x2 + b_k over a table input ``[x1, x2]``.
``Add``/``CAdd`` add a learned bias (a vector, or any shape broadcast from
the right), ``Mul``/``CMul`` multiply by a learned gain (one scalar, or any
shape), ``Scale`` is ``CMul`` then ``CAdd``; ``AddConstant`` and
``MulConstant`` add or multiply by a fixed scalar.  Each layer's parameters
take the reference's names (``weight``, ``bias``; ``Scale``'s ``cmul`` and
``cadd``), so ``convert.load_jax_params`` carries them as they are.

In a :func:`bigdl_tpu_torch.ops.quant.quantize_model` copy ``Linear``'s
weight is packed and the product runs the fused dequant-matmul
(``quant.int8_matmul``: K13, K14 or K15 by rung); an fp weight takes
``F.linear`` and is the calibration point, both through
``quant.matmul_or_observe`` as in the reference."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.module import Module, seeded
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
        return quant.matmul_or_observe(self, "weight", input, self.bias)


class Bilinear(Module):
    """y_k = x1^T W_k x2 + b_k over a table input ``[x1, x2]`` of (N, in1)
    and (N, in2) (``nn/Bilinear.scala``); weight ``(out, in1, in2)``."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True):
        super().__init__()
        self.input_size1 = input_size1
        self.input_size2 = input_size2
        self.output_size = output_size
        self.bias_res = bias_res
        self.weight = nn.Parameter(torch.empty(output_size, input_size1,
                                               input_size2))
        self.bias = nn.Parameter(torch.empty(output_size)) \
            if bias_res else None
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        stdv = 1.0 / math.sqrt(self.input_size1)
        with torch.no_grad():
            self.weight.copy_(init_methods.uniform(
                gen, tuple(self.weight.shape), stdv))
            if self.bias is not None:
                self.bias.copy_(init_methods.uniform(
                    gen, (self.output_size,), stdv))

    def forward(self, input):
        x1, x2 = input[0], input[1]
        y = torch.einsum("bi,kij,bj->bk", x1, self.weight, x2)
        return y if self.bias is None else y + self.bias


class Add(Module):
    """A learned bias vector added to the input (``nn/Add.scala``)."""

    def __init__(self, input_size: int):
        super().__init__()
        self.input_size = input_size
        self.bias = nn.Parameter(torch.empty(input_size))
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.bias.copy_(init_methods.uniform(
                gen, (self.input_size,), 1.0 / math.sqrt(self.input_size)))

    def forward(self, input):
        return input + self.bias


class AddConstant(Module):
    def __init__(self, constant_scalar: float, inplace: bool = False):
        super().__init__()
        self.constant_scalar = constant_scalar

    def forward(self, input):
        return input + self.constant_scalar


class Mul(Module):
    """One learned scalar gain, U(-1, 1) at init (``nn/Mul.scala``)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.copy_(init_methods.uniform(gen, (1,), 1.0))

    def forward(self, input):
        return input * self.weight[0]


class MulConstant(Module):
    def __init__(self, scalar: float, inplace: bool = False):
        super().__init__()
        self.scalar = scalar

    def forward(self, input):
        return input * self.scalar


def _broadcast(t, input):
    """``t`` with leading 1s up to ``input``'s rank."""
    if t.dim() < input.dim():
        t = t.reshape((1,) * (input.dim() - t.dim()) + tuple(t.shape))
    return t


class CAdd(Module):
    """A learned bias of any shape that broadcasts against the input from
    the right (``nn/CAdd.scala``)."""

    KEY = "bias"

    def __init__(self, size: Sequence[int]):
        super().__init__()
        self.size = tuple(size)
        self.register_parameter(self.KEY, nn.Parameter(torch.empty(
            self.size)))
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        with torch.no_grad():
            getattr(self, self.KEY).copy_(init_methods.uniform(
                gen, self.size, 1.0 / math.sqrt(math.prod(self.size))))

    def forward(self, input):
        return input + _broadcast(self.bias, input)


class CMul(CAdd):
    """A learned gain of any shape (``nn/CMul.scala``).  In a
    ``quant.quantize_model`` copy a large 2-D or 4-D gain is packed; it is
    widened to the input's dtype here, as the reference widens it."""

    KEY = "weight"

    def forward(self, input):
        qt = quant.packed_weight(self)
        w = self.weight if qt is None else quant.unpack(qt, input.dtype)
        return input * _broadcast(w, input)


class Scale(Module):
    """``CMul`` then ``CAdd`` of one shape (``nn/Scale.scala``)."""

    def __init__(self, size: Sequence[int]):
        super().__init__()
        self.size = tuple(size)
        self.cmul = CMul(size)
        self.cadd = CAdd(size)

    def forward(self, input):
        return self.cadd(self.cmul(input))
