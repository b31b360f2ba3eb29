"""Activations (``bigdl_tpu/nn/activation.py``): ReLU, Tanh, LogSoftMax,
and ``gelu`` with the tanh approximation, which ``jax.nn.gelu`` takes by
default (``F.gelu`` defaults to the exact erf form).

Softmax-family axis convention follows Torch7: 1-D and 3-D (C,H,W) inputs
reduce over dim 0, 2-D and 4-D over dim 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


class Tanh(Module):
    def forward(self, x):
        return torch.tanh(x)


class LogSoftMax(Module):
    def forward(self, x):
        return torch.log_softmax(x, dim=_softmax_axis(x.dim()))
