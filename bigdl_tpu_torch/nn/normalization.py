"""Normalisations (``bigdl_tpu/nn/normalization.py``).

``SpatialCrossMapLRN``: y = x / (k + alpha/size * sum_{c in window}
x_c^2)^beta, through the port's LRN op (kernel K2 on the card).
``LayerNorm``: each position's feature vector to zero mean and unit
(population) variance over the last dimension, then the affine
``weight``/``bias``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.module import Module
from bigdl_tpu_torch.core.precision import promote
from bigdl_tpu_torch.nn.conv import _maybe_batched
from bigdl_tpu_torch.ops.lrn import cross_map_lrn


class SpatialCrossMapLRN(Module):

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, k: float = 1.0):
        super().__init__()
        self.size = size
        self.alpha, self.beta, self.k = alpha, beta, k

    def forward(self, input):
        def run(x):
            return cross_map_lrn(x, self.size, self.alpha, self.beta, self.k)
        return _maybe_batched(run, input)


class LayerNorm(Module):

    def __init__(self, normalized_size: int, eps: float = 1e-5):
        super().__init__()
        self.normalized_size = normalized_size
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(normalized_size))
        self.bias = nn.Parameter(torch.zeros(normalized_size))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, input):
        x, w, b = promote(input, self.weight, self.bias)
        return F.layer_norm(x, (self.normalized_size,), w, b, self.eps)
