"""Containers and table combinators (``bigdl_tpu/nn/containers.py``):
``Sequential``, ``Concat``, ``ConcatTable``, ``ParallelTable``,
``MapTable``, ``Bottle``; the table ops ``MixtureTable``, ``JoinTable``,
``FlattenTable``, ``NarrowTable``, ``SelectTable`` and the pairwise
``C{Add,Sub,Mul,Div,Max,Min}Table``; ``Identity``, ``Echo``, ``Copy`` and
``Contiguous``.  A table is a Python list of tensors, as in the reference.
``MapTable`` and ``Bottle`` hold one child, so their parameter tree is the
reference's ``[p]``."""

from __future__ import annotations

import functools

import torch

from bigdl_tpu_torch.core.module import Container, Module, tree_leaves


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


class ParallelTable(Container):
    """The i-th child on the i-th table entry."""

    def forward(self, input):
        return [m(input[i]) for i, m in enumerate(self.layers)]


class MapTable(Container):
    """One child on every table entry, with its parameters shared
    (``nn/MapTable.scala``'s clones share storage; here it is literally the
    same module)."""

    def __init__(self, module: Module = None):
        super().__init__()
        if module is not None:
            self.add(module)

    def forward(self, input):
        return [self.layers[0](x) for x in input]


class MixtureTable(Module):
    """Input [gates (B, K), experts: a table of K (B, ...)]; output
    sum_k gate_k * expert_k (``nn/MixtureTable.scala``)."""

    def forward(self, input):
        gates, experts = input[0], input[1]
        stacked = torch.stack(list(experts), dim=1)          # (B, K, ...)
        g = gates.reshape(gates.shape[:2] + (1,) * (stacked.dim() - 2))
        return (stacked * g).sum(dim=1)


class JoinTable(Module):
    """Concatenate the table's entries on ``dimension`` (1-based over the
    last ``n_input_dims`` dims when the input has more: a batch)."""

    def __init__(self, dimension: int, n_input_dims: int = 0):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, input):
        axis = self.dimension - 1
        ndim = input[0].dim()
        if 0 < self.n_input_dims < ndim:
            axis += ndim - self.n_input_dims
        return torch.cat(list(input), dim=axis)


class FlattenTable(Module):
    """A nested table as one flat table, in order."""

    def forward(self, input):
        return list(tree_leaves(input))


class NarrowTable(Module):
    """``length`` entries from the 1-based ``offset`` (a negative length
    counts from the end)."""

    def __init__(self, offset: int, length: int = 1):
        super().__init__()
        self.offset, self.length = offset, length

    def forward(self, input):
        n = self.length if self.length >= 0 \
            else len(input) - self.offset + 1 + self.length + 1
        return list(input)[self.offset - 1:self.offset - 1 + n]


class SelectTable(Module):
    """The entry at the 1-based ``index`` (negative from the end)."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, input):
        return input[self.index - 1 if self.index > 0 else self.index]


class _CTable(Module):
    """A pairwise reduce of the table's tensors, left to right."""

    _op = None

    def forward(self, input):
        return functools.reduce(self._op, list(input))


class CAddTable(_CTable):
    """The sum of a table's tensors.  ``inplace`` is accepted for API
    parity; the add is out of place, as an in-place add onto a branch
    output that autograd saved would raise."""

    _op = staticmethod(torch.add)

    def __init__(self, inplace: bool = False):
        super().__init__()
        self.inplace = inplace


class CSubTable(_CTable):
    _op = staticmethod(torch.sub)


class CMulTable(_CTable):
    _op = staticmethod(torch.mul)


class CDivTable(_CTable):
    _op = staticmethod(torch.div)


class CMaxTable(_CTable):
    """Elementwise maximum; a tie gives each side half the gradient, as
    ``jnp.maximum`` does."""

    _op = staticmethod(torch.maximum)


class CMinTable(_CTable):
    _op = staticmethod(torch.minimum)


class Identity(Module):

    def forward(self, input):
        return input


class Echo(Module):
    """Prints the name and the shapes of its input on every forward, and
    passes the input on (``nn/Echo.scala``)."""

    def forward(self, input):
        print(f"{self.name}: " + "; ".join(
            str(tuple(t.shape)) for t in tree_leaves(input)), flush=True)
        return input


class Copy(Module):
    """A copy of the input."""

    def forward(self, input):
        return input.clone()


class Contiguous(Module):
    """The input in contiguous memory."""

    def forward(self, input):
        return input.contiguous()


class Bottle(Container):
    """Fold the leading dims into one batch dim to run an
    ``n_input_dim``-D module over higher-dimensional input, then unfold its
    output (``nn/Bottle.scala``)."""

    def __init__(self, module: Module, n_input_dim: int = 2,
                 n_output_dim: int = 2):
        super().__init__(module)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim

    def forward(self, input):
        cut = input.dim() - self.n_input_dim + 1
        y = self.layers[0](input.reshape((-1,) + tuple(input.shape[cut:])))
        return y.reshape(tuple(input.shape[:cut]) + tuple(y.shape[1:]))
