"""SpatialCrossMapLRN (``bigdl_tpu/nn/normalization.py``):
y = x / (k + alpha/size * sum_{c in window} x_c^2)^beta, through the port's
LRN op (kernel K2 on the card)."""

from __future__ import annotations

from bigdl_tpu_torch.core.module import Module
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
