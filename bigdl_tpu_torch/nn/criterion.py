"""Criterions (``bigdl_tpu/nn/criterion.py``).  Class targets are
**1-based**, as in Torch; ``size_average`` defaults to true; the gradient
comes from autograd (``Criterion.backward``).

Each formula is the reference's, written again in torch: not
``torch.nn.functional``'s losses, whose epsilons, clamps and reductions
differ.  Where the reference meets a kink its gradient is JAX's:
``jnp.maximum``/``jnp.minimum`` split a tie in half (so does
``torch.maximum``, unlike ``clamp_min`` or ``relu``), and ``jnp.abs`` has
slope +1 at 0 (``_abs``; ``torch.abs`` has 0 there)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.core.module import Criterion, tree_map


def _value(target, input):
    """``target`` (a tensor, an array or a table of them) on ``input``'s
    device; a float64 array becomes float32, as JAX takes it."""
    def one(t):
        t = torch.as_tensor(t, device=input.device)
        return t.float() if t.dtype == torch.float64 else t
    return tree_map(one, target)


def _labels(target, input):
    """1-based class targets as 0-based int64 on ``input``'s device."""
    return torch.as_tensor(target, device=input.device).long() - 1


def _abs(x):
    """|x| with JAX's slope +1 at 0."""
    return torch.where(x >= 0, x, -x)


def _relu(x):
    """max(0, x) with JAX's half gradient at 0."""
    return torch.maximum(x, torch.zeros_like(x))


def _avg(x, size_average, n):
    return x / n if size_average else x


def _mean_or_sum(x, size_average):
    return x.mean() if size_average else x.sum()


class ClassNLLCriterion(Criterion):
    """Input: (N, C) log-probabilities, or one (C,) row; target: (N,)
    1-based classes.  With ``weights`` each row counts by its class's
    weight, and ``size_average`` divides by the sum of those weights."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = None if weights is None else \
            torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average

    def apply(self, input, target):
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


class CrossEntropyCriterion(Criterion):
    """``log_softmax`` over the last axis, then :class:`ClassNLLCriterion`
    (``nn/CrossEntropyCriterion.scala``)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.nll = ClassNLLCriterion(weights, size_average)

    def apply(self, input, target):
        return self.nll.apply(torch.log_softmax(input, dim=-1), target)


class MSECriterion(Criterion):

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        d = input - _value(target, input)
        return _mean_or_sum(d * d, self.size_average)


class AbsCriterion(Criterion):

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        return _mean_or_sum(_abs(input - _value(target, input)),
                            self.size_average)


class BCECriterion(Criterion):
    """Binary cross entropy with the reference's 1e-12 inside each log."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = None if weights is None else \
            torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average

    def apply(self, input, target):
        eps = 1e-12
        t = _value(target, input)
        loss = t * torch.log(input + eps) + \
            (1 - t) * torch.log(1 - input + eps)
        if self.weights is not None:
            loss = loss * self.weights.to(input.device)
        return _avg(-loss.sum(), self.size_average, input.numel())


class ClassSimplexCriterion(MSECriterion):
    """MSE against a regular-simplex embedding of the target class
    (``nn/ClassSimplexCriterion.scala``)."""

    def __init__(self, n_classes: int):
        super().__init__()
        self.n_classes = n_classes
        self.simplex = self._build_simplex(n_classes)

    @staticmethod
    def _build_simplex(n):
        """n unit vectors in R^n with equal pairwise dot products -1/n
        (the analytic regular-simplex embedding)."""
        c = (1.0 + np.sqrt(n + 1.0)) / (n ** 1.5)
        m = np.sqrt(1.0 + 1.0 / n) * np.eye(n) - c * np.ones((n, n))
        return torch.from_numpy(m.astype(np.float32))

    def apply(self, input, target):
        goal = self.simplex.to(input.device)[_labels(target, input)]
        return super().apply(input, goal)


class CosineEmbeddingCriterion(Criterion):
    """Table input [x1, x2]; target y in {1, -1}
    (``nn/CosineEmbeddingCriterion.scala``)."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x1, x2 = input[0], input[1]
        if x1.dim() == 1:
            x1, x2 = x1[None], x2[None]
        y = _value(target, x1).reshape(-1)
        cos = (x1 * x2).sum(1) / (torch.linalg.vector_norm(x1, dim=1) *
                                  torch.linalg.vector_norm(x2, dim=1) + 1e-12)
        loss = torch.where(y > 0, 1.0 - cos, _relu(cos - self.margin))
        return _mean_or_sum(loss, self.size_average)


class DistKLDivCriterion(Criterion):
    """target * (log(target) - input); input is log-probabilities."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        t = _value(target, input)
        pos = t > 0
        loss = torch.where(pos, t * (torch.log(
            torch.where(pos, t, torch.ones_like(t))) - input),
            torch.zeros_like(input))
        return _avg(loss.sum(), self.size_average,
                    input.shape[0] if input.dim() > 1 else input.numel())


class HingeEmbeddingCriterion(Criterion):

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        loss = torch.where(_value(target, input) > 0, input,
                           _relu(self.margin - input))
        return _mean_or_sum(loss, self.size_average)


class L1Cost(Criterion):
    """|x|_1 of the input, target ignored (``nn/L1Cost.scala``)."""

    def apply(self, input, target=None):
        return _abs(input).sum()


class L1HingeEmbeddingCriterion(Criterion):
    """Table [x1, x2]; L1 distance hinge
    (``nn/L1HingeEmbeddingCriterion.scala``)."""

    def __init__(self, margin: float = 1.0):
        super().__init__()
        self.margin = margin

    def apply(self, input, target):
        d = _abs(input[0] - input[1]).sum()
        y = _value(target, d).reshape(())
        return torch.where(y > 0, d, _relu(self.margin - d))


class MarginCriterion(Criterion):
    """Hinge loss max(0, margin - y * x) (``nn/MarginCriterion.scala``)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        return _mean_or_sum(
            _relu(self.margin - input * _value(target, input)),
            self.size_average)


class MarginRankingCriterion(Criterion):
    """Table [x1, x2]; max(0, -y * (x1 - x2) + margin)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        y = target[1] if isinstance(target, (list, tuple)) else target
        y = _value(y, input[0])
        loss = _relu(-y * (input[0] - input[1]) + self.margin)
        return _mean_or_sum(loss, self.size_average)


class MultiCriterion(Criterion):
    """Weighted sum of criterions on the same (input, target)."""

    def __init__(self):
        super().__init__()
        self.criterions = []
        self.weights = []

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def apply(self, input, target):
        return sum(w * c.apply(input, target)
                   for c, w in zip(self.criterions, self.weights))


class ParallelCriterion(MultiCriterion):
    """The i-th criterion on (input[i], target[i]), or on the whole target
    with ``repeat_target`` (``nn/ParallelCriterion.scala``)."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.repeat_target = repeat_target

    def apply(self, input, target):
        total = 0.0
        for i, (c, w) in enumerate(zip(self.criterions, self.weights)):
            t = target if self.repeat_target else target[i]
            total = total + w * c.apply(input[i], t)
        return total


class MultiLabelMarginCriterion(Criterion):
    """Torch's multilabel margin: each target row lists 1-based labels,
    padded with 0 after the last (``nn/MultiLabelMarginCriterion.scala``)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        t = torch.as_tensor(target, device=input.device).long()
        if input.dim() == 1:
            input, t = input[None], t[None]
        n, d = input.shape
        # the labels: nonzero entries before the first zero
        seen_zero = torch.cumsum((t == 0).long(), dim=1) > 0
        is_label = ~seen_zero & (t > 0)
        tidx = (t - 1).clamp(0, d - 1)
        # a one-hot union, not a scatter: padding must not mark class 1
        label_mask = (F.one_hot(tidx, d).bool() &
                      is_label[:, :, None]).any(dim=1)
        x_target = input.gather(1, tidx)                        # (N, D)
        # max(0, 1 - (x[label] - x[j])) for each label and non-label j
        contrib = _relu(1.0 - (x_target[:, :, None] - input[:, None, :]))
        m = is_label[:, :, None] & ~label_mask[:, None, :]
        per_sample = torch.where(m, contrib, torch.zeros_like(contrib)) \
            .sum(dim=(1, 2)) / d
        return _avg(per_sample.sum(), self.size_average, n)


class MultiLabelSoftMarginCriterion(Criterion):
    """Sigmoid and binary cross entropy per class, through log-sigmoid
    (``nn/MultiLabelSoftMarginCriterion.scala``)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = None if weights is None else \
            torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average

    def apply(self, input, target):
        t = _value(target, input)
        loss = t * F.logsigmoid(input) + (1 - t) * F.logsigmoid(-input)
        if self.weights is not None:
            loss = loss * self.weights.to(input.device)
        n = input.shape[0] if input.dim() > 1 else 1
        return _avg(-loss.sum() / input.shape[-1], self.size_average, n)


class MultiMarginCriterion(Criterion):
    """Multiclass hinge, ``p`` 1 or 2, with optional class ``weights``
    (``nn/MultiMarginCriterion.scala``)."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__()
        if p not in (1, 2):
            raise ValueError(f"p must be 1 or 2, got {p}")
        self.p = p
        self.margin = margin
        self.weights = None if weights is None else \
            torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average

    def apply(self, input, target):
        t = _labels(target, input)
        if input.dim() == 1:
            input, t = input[None], t.reshape(1)
        n, d = input.shape
        x_t = input.gather(1, t[:, None])
        margin = _relu(self.margin - x_t + input)
        margin = torch.where(F.one_hot(t, d).bool(),
                             torch.zeros_like(margin), margin)
        if self.p == 2:
            margin = margin * margin
        if self.weights is not None:
            margin = margin * self.weights.to(input.device)[t][:, None]
        return _avg((margin.sum(dim=1) / d).sum(), self.size_average, n)


class SmoothL1Criterion(Criterion):

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        d = _abs(input - _value(target, input))
        loss = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
        return _mean_or_sum(loss, self.size_average)


class SmoothL1CriterionWithWeights(Criterion):
    """Fast R-CNN's bbox loss with inside and outside weights and
    ``sigma``, divided by ``num`` when it is positive
    (``nn/SmoothL1CriterionWithWeights.scala``).  The target is the table
    [targets, inside weights, outside weights]."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        super().__init__()
        self.sigma2 = sigma * sigma
        self.num = num

    def apply(self, input, target):
        t, iw, ow = _value(list(target[:3]), input)
        d = iw * (input - t)
        ad = _abs(d)
        loss = torch.where(ad < 1.0 / self.sigma2,
                           0.5 * self.sigma2 * d * d,
                           ad - 0.5 / self.sigma2)
        total = (ow * loss).sum()
        return total / self.num if self.num > 0 else total


class SoftMarginCriterion(Criterion):
    """log(1 + exp(-y * x)) (``nn/SoftMarginCriterion.scala``)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def apply(self, input, target):
        z = -input * _value(target, input)
        return _mean_or_sum(torch.logaddexp(z, torch.zeros_like(z)),
                            self.size_average)


class SoftmaxWithCriterion(Criterion):
    """Caffe's softmax loss over (N, C) or (N, C, H, W) with an optional
    1-based ``ignore_label`` and the normalize modes ``VALID`` (by the
    labels not ignored), ``BATCH_SIZE``, ``FULL`` (by every position) or
    any other (none) (``nn/SoftmaxWithCriterion.scala``)."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "VALID"):
        super().__init__()
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def apply(self, input, target):
        lp = torch.log_softmax(input, dim=1)
        t = _labels(target, input)                 # (N,) or (N, H, W)
        if t.dim() == input.dim():                 # (N, 1, H, W)
            t = t.squeeze(1)
        tl = t.clamp(0, input.shape[1] - 1)
        picked = lp.gather(1, tl[:, None]).squeeze(1)
        if self.ignore_label is None:
            valid = torch.ones_like(picked, dtype=torch.bool)
        else:
            valid = t != self.ignore_label - 1
        total = -torch.where(valid, picked, torch.zeros_like(picked)).sum()
        if self.normalize_mode == "VALID":
            return total / valid.sum().clamp_min(1)
        if self.normalize_mode == "BATCH_SIZE":
            return total / input.shape[0]
        if self.normalize_mode == "FULL":
            return total / picked.numel()
        return total


class CriterionTable(Criterion):
    """Wraps a criterion to take the table input [x, target]
    (``nn/CriterionTable.scala``)."""

    def __init__(self, criterion: Criterion):
        super().__init__()
        self.criterion = criterion

    def apply(self, input, target=None):
        if target is None:
            return self.criterion.apply(input[0], input[1])
        return self.criterion.apply(input, target)


class TimeDistributedCriterion(Criterion):
    """``criterion`` at every time step of (N, T, ...) input and (N, T)
    target, summed over the steps (divided by T when ``size_average``).
    The steps run as one batched call (``torch.func.vmap`` over the time
    axis, as the reference ``jax.vmap``s it), not a loop of T calls.  A
    table input holds one step's input an entry (``target`` likewise) and
    runs step by step."""

    def __init__(self, criterion: Criterion, size_average: bool = False):
        super().__init__()
        self.criterion = criterion
        self.size_average = size_average

    def apply(self, input, target):
        if isinstance(input, torch.Tensor):
            target = torch.as_tensor(target, device=input.device)
            losses = torch.func.vmap(self.criterion.apply, in_dims=(1, 1))(
                input, target)
            total = losses.sum()
            return total / input.shape[1] if self.size_average else total
        steps = len(input)
        total = 0.0
        for t in range(steps):
            total = total + self.criterion.apply(input[t], target[t])
        return total / steps if self.size_average else total
