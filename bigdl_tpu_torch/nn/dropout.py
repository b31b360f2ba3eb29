"""Dropout and LookupTable (``bigdl_tpu/nn/dropout.py``).

``Dropout``: inverted dropout in training mode, identity in eval mode.

In training mode with ``p > 0`` each element is kept with probability
``1 - p`` and, when ``scale``, the kept ones are divided by ``1 - p``.  The
mask is drawn from the layer's explicit ``torch.Generator`` on the input's
device, which the trainer hands to the model (``Module.set_generator``);
without one, a training-mode forward raises rather than drawing from
torch's global generator.

``LookupTable``: an embedding with 1-based indices (float indices are cast
toward zero).  A ``padding_value`` row is zero at init and trains as any
other; ``max_norm`` renormalises the gathered rows whose ``norm_type``
norm exceeds it (never the weight itself).  In a ``quant.quantize_model``
copy the table stays packed and only the gathered rows are widened
(``quant.int8_gather_rows``).
"""

from __future__ import annotations

import torch
from torch import nn

from bigdl_tpu_torch.core.module import Module, seeded
from bigdl_tpu_torch.ops import quant


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


class LookupTable(Module):

    def __init__(self, n_index: int, n_output: int,
                 padding_value: float = 0.0,
                 max_norm: float = float("inf"),
                 norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False):
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.weight = nn.Parameter(torch.empty(n_index, n_output))
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        """weight ~ N(0, 1), the padding row zero, as the reference draws
        it."""
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.n_index, self.n_output,
                                          generator=gen))
            if self.padding_value > 0:
                self.weight[int(self.padding_value) - 1] = 0.0

    def forward(self, input):
        idx = input.long() - 1
        qt = quant.packed_weight(self)
        rows = self.weight[idx] if qt is None else \
            quant.int8_gather_rows(qt, idx)
        if self.max_norm != float("inf"):
            norms = torch.linalg.vector_norm(rows, ord=self.norm_type,
                                             dim=-1, keepdim=True)
            rows = torch.where(norms > self.max_norm,
                               rows * (self.max_norm / (norms + 1e-7)), rows)
        return rows
