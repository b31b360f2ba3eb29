"""Forward-only autograd wrapper for kernels whose backward is not ported.

The TPU package pairs each forward kernel with a backward kernel
(``ops/pooling.py`` ``_bwd_kernel``, ``ops/lrn.py`` ``_bwd_kernel``).  Those
come with the training slice; until then a graph that reaches one of these
ops can be built, but calling backward through it raises.
"""

from __future__ import annotations

import torch


class _ForwardOnly(torch.autograd.Function):

    @staticmethod
    def forward(ctx, run, name, x):
        ctx.name = name
        return run(x)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.name} has no backward yet: its backward kernel comes "
            "with the training slice of the port")


def forward_only(run, name: str, x: torch.Tensor):
    """``run(x)``, made to raise ``NotImplementedError`` on backward."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ForwardOnly.apply(run, name, x)
    return run(x)
