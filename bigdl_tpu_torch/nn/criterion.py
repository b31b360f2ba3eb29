"""Criterions (``bigdl_tpu/nn/criterion.py``).  Class targets are
**1-based**, as in Torch; ``size_average`` defaults to true; the gradient
comes from autograd."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.core.module import Module


class ClassNLLCriterion(Module):
    """Input: (N, C) log-probabilities, or one (C,) row; target: (N,)
    1-based classes.  With ``weights`` each row counts by its class's
    weight, and ``size_average`` divides by the sum of those weights."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = None if weights is None else \
            torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average

    def forward(self, input, target):
        target = torch.as_tensor(target, device=input.device)
        if input.dim() == 1:
            input, target = input[None], target.reshape(1)
        t = target.long() - 1
        lp = input.gather(1, t[:, None])[:, 0]
        if self.weights is not None:
            w = self.weights.to(input.device, input.dtype)[t]
            total = -(lp * w).sum()
            denom = w.sum()
        else:
            total = -lp.sum()
            denom = input.shape[0]
        return total / denom if self.size_average else total


class CrossEntropyCriterion(Module):
    """``log_softmax`` over the last axis, then :class:`ClassNLLCriterion`
    (``nn/CrossEntropyCriterion.scala``)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.nll = ClassNLLCriterion(weights, size_average)

    def forward(self, input, target):
        return self.nll(torch.log_softmax(input, dim=-1), target)


class TimeDistributedCriterion(Module):
    """``criterion`` at every time step of (N, T, ...) input and (N, T)
    target, summed over the steps (divided by T when ``size_average``).
    The steps run as one batched call (``torch.func.vmap`` over the time
    axis, as the reference ``jax.vmap``s it), not a loop of T calls."""

    def __init__(self, criterion, size_average: bool = False):
        super().__init__()
        self.criterion = criterion
        self.size_average = size_average

    def forward(self, input, target):
        target = torch.as_tensor(target, device=input.device)
        losses = torch.func.vmap(self.criterion, in_dims=(1, 1))(input,
                                                                 target)
        total = losses.sum()
        return total / input.shape[1] if self.size_average else total
