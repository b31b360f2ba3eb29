"""Dropout (``bigdl_tpu/nn/dropout.py``): inverted dropout in training mode,
identity in eval mode.

In training mode with ``p > 0`` each element is kept with probability
``1 - p`` and, when ``scale``, the kept ones are divided by ``1 - p``.  The
mask is drawn from the layer's explicit ``torch.Generator`` on the input's
device, which the trainer hands to the model (``Module.set_generator``);
without one, a training-mode forward raises rather than drawing from
torch's global generator.
"""

from __future__ import annotations

import torch

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
        if self.generator is None:
            raise ValueError(
                "Dropout needs a generator in training mode: hand one to "
                "the model with set_generator(torch.Generator(device))")
        keep = torch.rand(input.shape, generator=self.generator,
                          device=input.device) < 1.0 - self.p
        y = torch.where(keep, input, torch.zeros_like(input))
        if self.scale:
            y = y / (1.0 - self.p)
        return y
