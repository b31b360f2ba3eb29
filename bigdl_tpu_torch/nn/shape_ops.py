"""Reshape, View and Padding (``bigdl_tpu/nn/shape_ops.py``), with the
reference's batch-dimension inference."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.nn.functional as F

from bigdl_tpu_torch.core.module import Module


class Reshape(Module):

    def __init__(self, size: Sequence[int],
                 batch_mode: Optional[bool] = None):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def forward(self, input):
        n = math.prod(self.size)
        if self.batch_mode is False:
            return input.reshape(self.size)
        total = input.numel()
        # dim 0 is batch when the TRAILING dims account for the target
        # size (batch 1 included); an empty batch is always batched
        if input.dim() > 1 and input.shape[0] > 0:
            trailing = total // input.shape[0]
        else:
            trailing = total
        batched = self.batch_mode is True or (
            self.batch_mode is None and input.dim() > 0 and
            (total != n or (input.dim() > 1 and trailing == n) or
             (input.dim() == 1 and n == 1)))
        if batched:
            return input.reshape((input.shape[0],) + self.size)
        return input.reshape(self.size)


class View(Module):

    def __init__(self, *sizes: int):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(int(s) for s in sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int):
        self.num_input_dims = n
        return self

    def forward(self, input):
        n = math.prod(s for s in self.sizes if s > 0)
        if -1 not in self.sizes:
            if self.num_input_dims:
                # explicit mode (Torch setNumInputDims): the last
                # num_input_dims dims are the sample, anything before batch
                batch = tuple(input.shape[:max(0, input.dim() -
                                                self.num_input_dims)])
                return input.reshape(batch + self.sizes)
            trailing = math.prod(input.shape[1:])
            if input.dim() > 1 and trailing == n:
                return input.reshape((input.shape[0],) + self.sizes)
            total = trailing * input.shape[0] if input.dim() else 1
            if total != n and total % n == 0:
                return input.reshape((total // n,) + self.sizes)
        return input.reshape(self.sizes)


class Padding(Module):
    """Pad ``pad`` entries (negative = before) of ``value`` on the 1-based
    dimension ``dim`` of an ``n_input_dim``-dimensional sample; a batched
    input (more dimensions) shifts the axis (``nn/Padding.scala``)."""

    def __init__(self, dim: int, pad: int, n_input_dim: int,
                 value: float = 0.0, n_index: int = 1):
        super().__init__()
        self.dim, self.pad = dim, pad
        self.n_input_dim = n_input_dim
        self.value = value

    def forward(self, input):
        ax = self.dim - 1
        if 0 < self.n_input_dim < input.dim():
            ax += input.dim() - self.n_input_dim
        widths = [0, 0] * (input.dim() - ax)
        widths[-2:] = (-self.pad, 0) if self.pad < 0 else (0, self.pad)
        return F.pad(input, widths, value=self.value)
