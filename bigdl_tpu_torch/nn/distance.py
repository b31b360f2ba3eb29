"""Distance, similarity and matrix-product layers
(``bigdl_tpu/nn/distance.py``): ``Cosine`` and ``Euclidean`` against learned
weight rows, ``CosineDistance``, ``DotProduct``, ``PairwiseDistance``,
``MM``, ``MV`` over a table, and ``L1Penalty``.

``Cosine``'s and ``Euclidean``'s weight ``(output_size, input_size)`` is
drawn as the reference draws it, U(-1/sqrt(input_size), 1/sqrt(input_size));
in a :func:`bigdl_tpu_torch.ops.quant.quantize_model` copy it is packed and
widened to the input's dtype here, as the reference's ``quant.maybe_unpack``
does."""

from __future__ import annotations

import math

import torch
from torch import nn

from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.module import Module, seeded
from bigdl_tpu_torch.ops import quant


class _Rows(Module):
    """A layer with a learned weight of ``output_size`` rows of
    ``input_size``."""

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.weight = nn.Parameter(torch.empty(output_size, input_size))
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.copy_(init_methods.uniform(
                gen, (self.output_size, self.input_size),
                1.0 / math.sqrt(self.input_size)))

    def _weight(self, dtype):
        qt = quant.packed_weight(self)
        return self.weight if qt is None else quant.unpack(qt, dtype)


class Cosine(_Rows):
    """y_j = cos(x, w_j) (``nn/Cosine.scala``)."""

    def forward(self, input):
        w = self._weight(input.dtype)
        xn = input / (torch.linalg.vector_norm(input, dim=-1, keepdim=True)
                      + 1e-12)
        wn = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-12)
        return xn @ wn.T


class Euclidean(_Rows):
    """y_j = ||x - w_j|| (``nn/Euclidean.scala``); ``fast_backward`` is
    accepted for API parity."""

    def __init__(self, input_size: int, output_size: int,
                 fast_backward: bool = True):
        super().__init__(input_size, output_size)

    def forward(self, input):
        x = input if input.dim() == 2 else input[None]
        d = x[:, None, :] - self._weight(input.dtype)[None, :, :]
        y = torch.sqrt((d * d).sum(dim=-1) + 1e-24)
        return y if input.dim() == 2 else y[0]


class CosineDistance(Module):
    """Table [x1, x2] -> their cosine similarity on the last dim
    (``nn/CosineDistance.scala``)."""

    def forward(self, input):
        x1, x2 = input[0], input[1]
        num = (x1 * x2).sum(dim=-1)
        den = torch.linalg.vector_norm(x1, dim=-1) * \
            torch.linalg.vector_norm(x2, dim=-1)
        return num / torch.maximum(den, torch.full_like(den, 1e-12))


class DotProduct(Module):
    """Table [x1, x2] -> their dot product on the last dim."""

    def forward(self, input):
        return (input[0] * input[1]).sum(dim=-1)


class PairwiseDistance(Module):
    """Table [x1, x2] -> their Lp distance on the last dim
    (``nn/PairwiseDistance.scala``)."""

    def __init__(self, norm: int = 2):
        super().__init__()
        self.norm = norm

    def forward(self, input):
        d = input[0] - input[1]
        d = torch.where(d >= 0, d, -d)          # jnp.abs: slope +1 at 0
        return torch.pow(torch.pow(d, self.norm).sum(dim=-1),
                         1.0 / self.norm)


class MM(Module):
    """Table [A, B] -> A @ B, either transposed first; batched over
    leading dims (``nn/MM.scala``)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False):
        super().__init__()
        self.trans_a, self.trans_b = trans_a, trans_b

    def forward(self, input):
        a, b = input[0], input[1]
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MV(Module):
    """Table [matrix, vector] -> their product, batched over leading dims
    (``nn/MV.scala``)."""

    def __init__(self, trans: bool = False):
        super().__init__()
        self.trans = trans

    def forward(self, input):
        m, v = input[0], input[1]
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class _L1Penalty(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x)
        ctx.w = w
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g + ctx.w * torch.sign(x), None


class L1Penalty(Module):
    """The identity forward; in training mode the backward adds
    ``l1weight * sign(x)`` (divided by the input's size with
    ``size_average``) to the gradient (``nn/L1Penalty.scala``);
    ``provide_output`` is accepted for API parity."""

    def __init__(self, l1weight: float, size_average: bool = False,
                 provide_output: bool = True):
        super().__init__()
        self.l1weight = float(l1weight)
        self.size_average = size_average

    def forward(self, input):
        if not self.training:
            return input
        w = self.l1weight / input.numel() if self.size_average \
            else self.l1weight
        return _L1Penalty.apply(input, w)
