"""Recurrent layers (``bigdl_tpu/nn/recurrent.py``).

A cell maps one time step, ``step(x_t, hidden) -> (y, hidden)``, from
``zero_hidden(batch)``: ``RnnCell`` (h' = act(W_i x + b_i + W_h h + b_h)),
``LSTMCell`` (gates i, f, g, o from one bias; the hidden state is the pair
(h, c)) and ``GRUCell`` (one bias, in the input path only:
n = tanh(n_i + r * W_hn h)).  Parameter names are the reference's
(``i2h_w``, ``i2h_b``, ``h2h_w``, ``h2h_b``; ``wi``, ``wh``, ``b``), so
``convert.load_jax_params`` carries them as they are.

``Recurrent`` runs its cell over the time axis of a batch-first (B, T, D)
input and returns the (B, T, H) hidden sequence.  The reference's
``lax.scan`` body becomes a Python loop over time of stock torch ops; the
input projection of every step is one product before the loop (each
step's sums as the cell's own ``step`` takes them).  Truncated BPTT is the
reference's chunked rule: the carried hidden state (both halves of an
LSTM's) is detached at every step ``i`` with ``i % bptt_truncate == 0``;
0 keeps the whole graph.  No TPU kernel stands behind these layers, and
cuDNN's fused RNNs are not used: their bias layout and truncation differ.

``TimeDistributed`` applies its module at every time step by folding time
into the batch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.module import Container, Module, seeded, tree_map
from bigdl_tpu_torch.core.precision import promote


class Cell(Module):
    """Recurrent cell protocol: ``step(x_t, hidden) -> (y, hidden)`` and
    ``zero_hidden(batch)``.  Called alone it takes the table
    ``[x_t, hidden]`` and returns ``[y, hidden]``."""

    hidden_size: int

    def zero_hidden(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros(batch, self.hidden_size, device=device)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The input's part of the step's pre-activation, for any leading
        shape (every time step at once in ``Recurrent``)."""
        raise NotImplementedError

    def recur(self, zi: torch.Tensor, hidden):
        """One step from the projected input ``zi``."""
        raise NotImplementedError

    def step(self, x_t, hidden):
        return self.recur(self.project(x_t), hidden)

    def forward(self, input):
        y, h = self.step(input[0], input[1])
        return [y, h]


def _draw(gen, shape, stdv):
    return init_methods.uniform(gen, shape, stdv)


class RnnCell(Cell):

    ACTIVATIONS = {"tanh": torch.tanh, "relu": F.relu,
                   "sigmoid": torch.sigmoid}

    def __init__(self, input_size: int, hidden_size: int,
                 activation: str = "tanh"):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = self.ACTIVATIONS[activation]
        self.i2h_w = nn.Parameter(torch.empty(hidden_size, input_size))
        self.i2h_b = nn.Parameter(torch.empty(hidden_size))
        self.h2h_w = nn.Parameter(torch.empty(hidden_size, hidden_size))
        self.h2h_b = nn.Parameter(torch.empty(hidden_size))
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        si = 1.0 / math.sqrt(self.input_size)
        sh = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            self.i2h_w.copy_(_draw(gen, tuple(self.i2h_w.shape), si))
            self.i2h_b.copy_(_draw(gen, (self.hidden_size,), si))
            self.h2h_w.copy_(_draw(gen, tuple(self.h2h_w.shape), sh))
            self.h2h_b.copy_(_draw(gen, (self.hidden_size,), sh))

    def project(self, x):
        return F.linear(*promote(x, self.i2h_w, self.i2h_b))

    def recur(self, zi, hidden):
        h, w, b = promote(hidden, self.h2h_w, self.h2h_b)
        h = self.activation(zi + h @ w.t() + b)
        return h, h


class LSTMCell(Cell):
    """Standard LSTM, gates i, f, g, o; the hidden state is (h, c)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.wi = nn.Parameter(torch.empty(4 * hidden_size, input_size))
        self.wh = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
        self.b = nn.Parameter(torch.empty(4 * hidden_size))
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        s = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in (self.wi, self.wh, self.b):
                p.copy_(_draw(gen, tuple(p.shape), s))

    def zero_hidden(self, batch, device=None):
        return (super().zero_hidden(batch, device),
                super().zero_hidden(batch, device))

    def project(self, x):
        return F.linear(*promote(x, self.wi))

    def recur(self, zi, hidden):
        h, c = hidden
        h, wh, b = promote(h, self.wh, self.b)
        z = zi + h @ wh.t() + b
        i, f, g, o = z.chunk(4, dim=-1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        return h2, (h2, c2)


class GRUCell(Cell):
    """GRU with one bias, in the input path: r and u from both paths,
    n = tanh(n_i + r * n_h) with n_h = W_hn h (no hidden bias)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.wi = nn.Parameter(torch.empty(3 * hidden_size, input_size))
        self.wh = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.b = nn.Parameter(torch.empty(3 * hidden_size))
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        s = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in (self.wi, self.wh, self.b):
                p.copy_(_draw(gen, tuple(p.shape), s))

    def project(self, x):
        return F.linear(*promote(x, self.wi, self.b))

    def recur(self, zi, hidden):
        h, wh = promote(hidden, self.wh)
        ri, ui, ni = zi.chunk(3, dim=-1)
        rh, uh, nh = (h @ wh.t()).chunk(3, dim=-1)
        r = torch.sigmoid(ri + rh)
        u = torch.sigmoid(ui + uh)
        n = torch.tanh(ni + r * nh)
        h2 = (1 - u) * n + u * h
        return h2, h2


class Recurrent(Container):
    """Its cell over the time axis of a (B, T, D) input: the (B, T, H)
    hidden sequence.  ``bptt_truncate`` > 0 detaches the carried hidden
    state at every step ``i`` with ``i % bptt_truncate == 0``."""

    def __init__(self, hidden_size: Optional[int] = None,
                 bptt_truncate: int = 0):
        super().__init__()
        self.hidden_size = hidden_size
        self.bptt_truncate = bptt_truncate

    def forward(self, input):
        cell = self.layers[0]
        zs = cell.project(input)               # (B, T, gates)
        h = cell.zero_hidden(input.shape[0], input.device)
        trunc = self.bptt_truncate
        ys = []
        for i in range(input.shape[1]):
            if trunc and i % trunc == 0:
                h = tree_map(torch.Tensor.detach, h)
            y, h = cell.recur(zs[:, i], h)
            ys.append(y)
        return torch.stack(ys, dim=1)


class TimeDistributed(Container):
    """Its module at every time step of a (B, T, ...) input, time folded
    into the batch."""

    def __init__(self, module: Module):
        super().__init__(module)

    def forward(self, input):
        b, t = input.shape[:2]
        y = self.layers[0](input.reshape((b * t,) + tuple(input.shape[2:])))
        return y.reshape((b, t) + tuple(y.shape[1:]))
