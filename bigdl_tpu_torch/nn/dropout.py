"""Dropout (``bigdl_tpu/nn/dropout.py``): identity in eval mode.

Training-mode dropout needs the port's explicit random stream, which comes
with the training slice; until then a training-mode forward with ``p > 0``
raises rather than drawing from torch's global generator.
"""

from __future__ import annotations

from bigdl_tpu_torch.core.module import Module


class Dropout(Module):

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True):
        super().__init__()
        self.p = init_p
        self.scale = scale

    def set_p(self, p: float):
        self.p = p
        return self

    def forward(self, input):
        if not self.training or self.p <= 0.0:
            return input
        raise NotImplementedError(
            "training-mode Dropout comes with the training slice of the "
            "port; call evaluate() for inference")
