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
``Normalize``: the input over its Lp norm along dim 1 plus ``eps`` (the
largest |x| for p = inf).
``SpatialSubtractiveNormalization``: x less its kernel-weighted mean over
every channel and the window, the kernel (9x9 gaussian by default; a 1-D
kernel means its outer product) scaled to sum 1/nInputPlane, and each
border mean divided by the kernel's weight inside the plane (a
convolution of ones; padding (k//2, (k-1)//2) on each axis).
``SpatialDivisiveNormalization`` divides x by the square root of the same
local mean of x*x (no mean subtracted, as in the reference), where it
exceeds ``threshold``, else by ``thresval``;
``SpatialContrastiveNormalization`` is the one then the other.  An
unbatched CHW input is lifted to a batch of 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import numpy as np
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


class Normalize(Module):
    """Unit Lp norm over dim 1 (``nn/Normalize.scala``)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10):
        super().__init__()
        self.p, self.eps = p, eps

    def forward(self, input):
        if self.p == float("inf"):
            norm = input.abs().amax(dim=1, keepdim=True)
        else:
            norm = input.abs().pow(self.p).sum(dim=1, keepdim=True) \
                .pow(1.0 / self.p)
        return input / (norm + self.eps)


def _gaussian_kernel_2d(size: int) -> torch.Tensor:
    """The trio's default kernel: a normalised 2-D gaussian, sigma
    size / 4."""
    sigma = 0.25 * size
    xs = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return torch.from_numpy((k / k.sum()).astype(np.float32))


class SpatialSubtractiveNormalization(Module):

    def __init__(self, n_input_plane: int = 1, kernel=None):
        super().__init__()
        self.n_input_plane = n_input_plane
        k = _gaussian_kernel_2d(9) if kernel is None else \
            torch.as_tensor(np.asarray(kernel, np.float32))
        if k.dim() == 1:
            k = torch.outer(k, k)      # a 1-D kernel means separable
        self.register_buffer("kernel", k / (k.sum() * n_input_plane))

    def _local_mean(self, x):
        n, c, h, w = x.shape
        kh, kw = self.kernel.shape
        pad = (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2)
        w4 = self.kernel.to(x.dtype).expand(1, c, kh, kw).contiguous()
        mean = F.conv2d(F.pad(x, pad), w4)
        ones = torch.ones((1, c, h, w), dtype=x.dtype, device=x.device)
        coef = F.conv2d(F.pad(ones, pad), w4)
        return mean / coef.clamp_min(1e-12)

    def forward(self, input):
        return _maybe_batched(lambda x: x - self._local_mean(x), input)


class SpatialDivisiveNormalization(Module):

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__()
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel)
        self.threshold, self.thresval = threshold, thresval

    def forward(self, input):
        def run(x):
            var = self.sub._local_mean(x * x)
            std = torch.sqrt(torch.maximum(var, torch.zeros_like(var)))
            thr = torch.where(std > self.threshold, std,
                              torch.full_like(std, self.thresval))
            return x / thr
        return _maybe_batched(run, input)


class SpatialContrastiveNormalization(Module):

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: float = 1e-4, thresval: float = 1e-4):
        super().__init__()
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel)
        self.div = SpatialDivisiveNormalization(n_input_plane, kernel,
                                                threshold, thresval)

    def forward(self, input):
        return self.div(self.sub(input))
