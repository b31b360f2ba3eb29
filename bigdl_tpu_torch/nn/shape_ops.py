"""Shape and reduction layers (``bigdl_tpu/nn/shape_ops.py``): Reshape,
InferReshape, View, Select, Narrow, Squeeze, Unsqueeze, Transpose,
Replicate, Padding, SpatialZeroPadding, Index, MaskedSelect, Max, Min, Mean
and Sum, with the reference's batch-dimension inference.

Torch dims are 1-based; negative dims count from the end (``_axis``).
Layers given ``n_input_dims``/``num_input_dims`` shift the dim when the
input has more dims than that (a batch).  ``Max``/``Min`` split the
gradient evenly among tied elements, as ``jnp.max`` does (``torch.amax``,
not ``torch.max(x, dim)``)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.core.module import Module


def _axis(dim: int, ndim: int, batch_shift: bool = False) -> int:
    """1-based Torch dim -> 0-based axis; negative dims from the end."""
    ax = dim - 1 if dim > 0 else ndim + dim
    return ax + 1 if batch_shift else ax


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


class InferReshape(Module):
    """Reshape with -1 (inferred) and 0 (copied from the input) entries
    (``nn/InferReshape.scala``)."""

    def __init__(self, size: Sequence[int], batch_mode: bool = False):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def forward(self, input):
        in_shape = input.shape[1:] if self.batch_mode else input.shape
        out = [in_shape[i] if s == 0 else s for i, s in enumerate(self.size)]
        if self.batch_mode:
            out = [input.shape[0]] + out
        return input.reshape(out)


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


class Select(Module):
    """The slice at the 1-based ``index`` (negative from the end) of the
    1-based ``dim``."""

    def __init__(self, dim: int, index: int):
        super().__init__()
        self.dim, self.index = dim, index

    def forward(self, input):
        ax = _axis(self.dim, input.dim())
        idx = self.index - 1 if self.index > 0 \
            else input.shape[ax] + self.index
        return input.select(ax, idx)


class Narrow(Module):
    """``length`` entries of ``dimension`` from the 1-based ``offset`` (a
    negative length counts from the end)."""

    def __init__(self, dimension: int, offset: int, length: int = 1):
        super().__init__()
        self.dimension, self.offset, self.length = dimension, offset, length

    def forward(self, input):
        ax = _axis(self.dimension, input.dim())
        length = self.length if self.length >= 0 else \
            input.shape[ax] - self.offset + 1 + self.length + 1
        return input.narrow(ax, self.offset - 1, length)


class Squeeze(Module):

    def __init__(self, dim: Optional[int] = None, num_input_dims: int = 0):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def forward(self, input):
        if self.dim is None:
            return input.squeeze()
        return input.squeeze(_axis(
            self.dim, input.dim(),
            batch_shift=0 < self.num_input_dims < input.dim()))


class Unsqueeze(Module):

    def __init__(self, pos: int, num_input_dims: int = 0):
        super().__init__()
        self.pos = pos
        self.num_input_dims = num_input_dims

    def forward(self, input):
        ax = self.pos - 1
        if 0 < self.num_input_dims < input.dim():
            ax += input.dim() - self.num_input_dims
        return input.unsqueeze(ax)


class Transpose(Module):
    """A sequence of pairwise swaps of 1-based dims
    (``nn/Transpose.scala``)."""

    def __init__(self, permutations: Sequence[Sequence[int]]):
        super().__init__()
        self.permutations = [tuple(p) for p in permutations]

    def forward(self, input):
        x = input
        for d1, d2 in self.permutations:
            x = x.transpose(_axis(d1, x.dim()), _axis(d2, x.dim()))
        return x


class Replicate(Module):
    """``n_features`` copies along a new 1-based dim ``dim`` (shifted past
    a batch when the input has more than ``n_dim`` dims)."""

    def __init__(self, n_features: int, dim: int = 1, n_dim: int = 0):
        super().__init__()
        self.n_features, self.dim, self.n_dim = n_features, dim, n_dim

    def forward(self, input):
        ax = self.dim - 1
        if 0 < self.n_dim < input.dim():
            ax += input.dim() - self.n_dim
        x = input.unsqueeze(ax)
        reps = [1] * x.dim()
        reps[ax] = self.n_features
        return x.repeat(reps)


class SpatialZeroPadding(Module):
    """Zeros around the last two dims; a negative pad crops
    (``nn/SpatialZeroPadding.scala``).  Unset pads default as the
    reference's: right to left, top to left, bottom to right."""

    def __init__(self, pad_left: int, pad_right: int = None,
                 pad_top: int = None, pad_bottom: int = None):
        super().__init__()
        self.pl = pad_left
        self.pr = pad_left if pad_right is None else pad_right
        self.pt = self.pl if pad_top is None else pad_top
        self.pb = self.pr if pad_bottom is None else pad_bottom

    def forward(self, input):
        return F.pad(input, (self.pl, self.pr, self.pt, self.pb))


class Index(Module):
    """Table input [tensor, 1-based indices]: the entries at those
    indices of the 1-based ``dimension``, as ``jnp.take`` gives them
    (``nn/Index.scala``)."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, input):
        x, idx = input[0], input[1]
        ax = _axis(self.dimension, x.dim())
        return x[(slice(None),) * ax + (idx.to(x.device).long() - 1,)]


class MaskedSelect(Module):
    """Table input [tensor, mask]: the 1-D tensor of the entries where the
    mask is nonzero (``nn/MaskedSelect.scala``).  Its size depends on the
    data, so a CUDA input waits for the card (``torch.masked_select``)."""

    def forward(self, input):
        x, mask = input[0], input[1]
        return torch.masked_select(x, mask.to(x.device).bool())


class _Reduce(Module):

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 squeeze: bool = True):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.squeeze = squeeze

    def forward(self, input):
        return self._reduce(input, _axis(
            self.dimension, input.dim(),
            batch_shift=0 < self.n_input_dims < input.dim()))


class Max(_Reduce):

    def __init__(self, dim: int = 1, num_input_dims: int = -1):
        super().__init__(dim, num_input_dims)

    def _reduce(self, x, ax):
        return torch.amax(x, dim=ax)


class Min(_Reduce):

    def __init__(self, dim: int = 1, num_input_dims: int = -1):
        super().__init__(dim, num_input_dims)

    def _reduce(self, x, ax):
        return torch.amin(x, dim=ax)


class Mean(_Reduce):

    def _reduce(self, x, ax):
        return x.mean(dim=ax, keepdim=not self.squeeze)


class Sum(_Reduce):

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 size_average: bool = False, squeeze: bool = True):
        super().__init__(dimension, n_input_dims, squeeze)
        self.size_average = size_average

    def _reduce(self, x, ax):
        y = x.sum(dim=ax, keepdim=not self.squeeze)
        return y / x.shape[ax] if self.size_average else y
