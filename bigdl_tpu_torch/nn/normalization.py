"""Normalisations (``bigdl_tpu/nn/normalization.py``).

``SpatialCrossMapLRN``: y = x / (k + alpha/size * sum_{c in window}
x_c^2)^beta, through the port's LRN op (kernel K2 on the card).
``LayerNorm``: each position's feature vector to zero mean and unit
(population) variance over the last dimension, then the affine
``weight``/``bias``.
``BatchNormalization`` / ``SpatialBatchNormalization``: each feature (axis
1) normalised over every other axis, by the biased batch variance in
training and by the running statistics in evaluation, then the affine.
The running mean and variance are f32 buffers (``Module.STATE``) that a
training forward updates in place: running = (1 - momentum) * running +
momentum * batch, with the unbiased batch variance.  The reference has no
Pallas kernel here (XLA fuses it); the port normalises with
``F.batch_norm`` and no weight, which accepts a bf16 input beside f32
running statistics (it refuses a bf16 weight beside them), and applies the
affine after, in the activation's dtype, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core.module import Module, seeded
from bigdl_tpu_torch.core.precision import promote
from bigdl_tpu_torch.nn.conv import _maybe_batched
from bigdl_tpu_torch.ops.lrn import cross_map_lrn


class SpatialCrossMapLRN(Module):

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, k: float = 1.0):
        super().__init__()
        self.size = size
        self.alpha, self.beta, self.k = alpha, beta, k

    def forward(self, input):
        def run(x):
            return cross_map_lrn(x, self.size, self.alpha, self.beta, self.k)
        return _maybe_batched(run, input)


class LayerNorm(Module):

    def __init__(self, normalized_size: int, eps: float = 1e-5):
        super().__init__()
        self.normalized_size = normalized_size
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(normalized_size))
        self.bias = nn.Parameter(torch.zeros(normalized_size))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, input):
        x, w, b = promote(input, self.weight, self.bias)
        return F.layer_norm(x, (self.normalized_size,), w, b, self.eps)


class BatchNormalization(Module):
    """Per-feature BN over a (N, D) input (``nn/BatchNormalization.scala``;
    Torch's momentum convention, ``eps`` per layer, ``affine=False`` without
    weight and bias)."""

    STATE = ("running_mean", "running_var")

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.weight = nn.Parameter(torch.empty(n_output)) if affine else None
        self.bias = nn.Parameter(torch.empty(n_output)) if affine else None
        self.register_buffer("running_mean", torch.zeros(n_output))
        self.register_buffer("running_var", torch.ones(n_output))
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        """weight ~ U(0, 1) and bias 0, as the reference draws them; the
        running statistics back to 0 and 1."""
        with torch.no_grad():
            if self.affine:
                self.weight.copy_(torch.rand(self.n_output, generator=gen))
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def param_tree(self):
        """``{}`` without the affine, as the reference's ``init_params``."""
        return super().param_tree() or {}

    def forward(self, input):
        y = F.batch_norm(input, self.running_mean, self.running_var, None,
                         None, self.training, self.momentum, self.eps)
        if not self.affine:
            return y
        shape = [1] * input.dim()
        shape[1] = self.n_output
        y, w, b = promote(y, self.weight, self.bias)
        return y * w.reshape(shape) + b.reshape(shape)


class SpatialBatchNormalization(BatchNormalization):
    """The 4-D (N, C, H, W) form (``nn/SpatialBatchNormalization.scala``):
    the same math, reduced over N, H and W."""
