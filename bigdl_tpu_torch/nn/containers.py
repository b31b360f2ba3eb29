"""Sequential, Concat, ConcatTable, CAddTable and Identity
(``bigdl_tpu/nn/containers.py``).  A table is a Python list of tensors, as
in the reference."""

from __future__ import annotations

import functools
import operator

import torch

from bigdl_tpu_torch.core.module import Container, Module


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


class ConcatTable(Container):
    """Same input to every branch; the output is the table of the branch
    outputs."""

    def forward(self, input):
        return [m(input) for m in self.layers]


class CAddTable(Module):
    """The sum of a table's tensors.  ``inplace`` is accepted for API
    parity; the add is out of place, as an in-place add onto a branch
    output that autograd saved would raise."""

    def __init__(self, inplace: bool = False):
        super().__init__()
        self.inplace = inplace

    def forward(self, input):
        return functools.reduce(operator.add, list(input))


class Identity(Module):

    def forward(self, input):
        return input
