"""Activations (``bigdl_tpu/nn/activation.py``): the elementwise layers,
``PReLU`` with its learned slope, ``RReLU`` with random slopes in training,
``GradientReversal``, the softmax family, and ``gelu`` with the tanh
approximation, which ``jax.nn.gelu`` takes by default (``F.gelu`` defaults
to the exact erf form).

Softmax-family axis convention follows Torch7: 1-D and 3-D (C,H,W) inputs
reduce over dim 0, 2-D and 4-D over dim 1.

``RReLU`` draws its slopes, as ``Dropout`` draws its masks, only from the
generator that ``Module.set_generator`` hands it, and raises in training
mode without one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.module import Module


def gelu(x):
    """``jax.nn.gelu(x)``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _softmax_axis(ndim: int) -> int:
    if ndim == 1 or ndim == 3:
        return 0
    return 1


class ReLU(Module):
    def __init__(self, ip: bool = False):
        super().__init__()
        self.inplace = ip   # accepted for API parity; the op is out of place

    def forward(self, x):
        return torch.relu(x)


class ReLU6(Module):
    def forward(self, x):
        return F.relu6(x)


class LeakyReLU(Module):
    def __init__(self, negval: float = 0.01, inplace: bool = False):
        super().__init__()
        self.negval = negval

    def forward(self, x):
        return F.leaky_relu(x, self.negval)


class PReLU(Module):
    """Learned leaky slope, 0.25 at init (``nn/PReLU.scala``):
    ``n_output_plane=0`` is one shared scalar, else one slope a channel
    (axis 1, or axis 0 of a 1-D input, as the reference takes it)."""

    def __init__(self, n_output_plane: int = 0):
        super().__init__()
        self.n_output_plane = n_output_plane
        self.weight = nn.Parameter(torch.full((max(1, n_output_plane),),
                                              0.25))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.fill_(0.25)

    def forward(self, input):
        w = self.weight
        if self.n_output_plane > 0:
            shape = [1] * input.dim()
            shape[1 if input.dim() >= 2 else 0] = w.shape[0]
            w = w.reshape(shape)
        return torch.where(input > 0, input, input * w)


class RReLU(Module):
    """Randomized leaky ReLU (``nn/RReLU.scala``): in training each
    negative element's slope is drawn from U(lower, upper), in eval it is
    the mean (lower + upper) / 2."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 inplace: bool = False):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, input):
        if not self.training:
            return torch.where(input >= 0, input,
                               input * ((self.lower + self.upper) / 2.0))
        if self.generator is None:
            raise ValueError(
                "RReLU needs a generator in training mode: hand one to "
                "the model with set_generator(torch.Generator(device))")
        a = torch.rand(input.shape, generator=self.generator,
                       device=input.device, dtype=input.dtype)
        a = self.lower + (self.upper - self.lower) * a
        return torch.where(input >= 0, input, input * a)


class ELU(Module):
    def __init__(self, alpha: float = 1.0, inplace: bool = False):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class Tanh(Module):
    def forward(self, x):
        return torch.tanh(x)


class TanhShrink(Module):
    def forward(self, x):
        return F.tanhshrink(x)


class Sigmoid(Module):
    def forward(self, x):
        return torch.sigmoid(x)


class LogSigmoid(Module):
    def forward(self, x):
        return F.logsigmoid(x)


class SoftMax(Module):
    def forward(self, x):
        return torch.softmax(x, dim=_softmax_axis(x.dim()))


class SoftMin(Module):
    def forward(self, x):
        return torch.softmax(-x, dim=_softmax_axis(x.dim()))


class LogSoftMax(Module):
    def forward(self, x):
        return torch.log_softmax(x, dim=_softmax_axis(x.dim()))


class SoftPlus(Module):
    """log(1 + exp(beta x)) / beta, exact at every x (``F.softplus``
    switches to x above its threshold, which differs by up to 2e-9)."""

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self.beta = beta

    def forward(self, x):
        return torch.logaddexp(self.beta * x, torch.zeros_like(x)) / \
            self.beta


class SoftSign(Module):
    def forward(self, x):
        return F.softsign(x)


class SoftShrink(Module):
    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def forward(self, x):
        return F.softshrink(x, self.lambd)


class HardShrink(Module):
    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def forward(self, x):
        return F.hardshrink(x, self.lambd)


class HardTanh(Module):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 inplace: bool = False):
        super().__init__()
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class Threshold(Module):
    """y = x if x > th else v (``nn/Threshold.scala``)."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False):
        super().__init__()
        self.th, self.v = th, v

    def forward(self, x):
        return F.threshold(x, self.th, self.v)


class Clamp(HardTanh):
    def __init__(self, min_value: float, max_value: float):
        super().__init__(float(min_value), float(max_value))


class Power(Module):
    """y = (shift + scale*x)^power (``nn/Power.scala``)."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0):
        super().__init__()
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)


class Sqrt(Module):
    def forward(self, x):
        return torch.sqrt(x)


class Square(Module):
    def forward(self, x):
        return x * x


class Abs(Module):
    def forward(self, x):
        return torch.abs(x)


class Exp(Module):
    def forward(self, x):
        return torch.exp(x)


class Log(Module):
    def forward(self, x):
        return torch.log(x)


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(Module):
    """Identity forward, -lambda * grad backward (``nn/GradientReversal``)."""

    def __init__(self, lambda_: float = 1.0):
        super().__init__()
        self.lambda_ = lambda_

    def forward(self, input):
        return _Reverse.apply(input, self.lambda_)
