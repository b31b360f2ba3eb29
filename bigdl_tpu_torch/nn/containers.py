"""Sequential and Concat (``bigdl_tpu/nn/containers.py``)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.core.module import Container


class Sequential(Container):

    def forward(self, input):
        x = input
        for m in self.layers:
            x = m(x)
        return x


class Concat(Container):
    """Run branches on the same input, concat outputs on ``dimension``
    (1-based, Torch-style; dim 2 = channels of NCHW)."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, input):
        return torch.cat([m(input) for m in self.layers],
                         dim=self.dimension - 1)
