"""Validation methods and result monoids (``bigdl_tpu/optim/validation.py``).

Parity: ``optim/ValidationMethod.scala:28-219`` (Top1Accuracy, Top5Accuracy,
Loss; ``AccuracyResult``/``LossResult`` combine with ``+``).  Outputs stay
on their device: the accuracies take the argmax (or top 5) there and fetch
only the counts.
"""

from __future__ import annotations

import torch


class ValidationResult:
    def result(self):
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    def __init__(self, correct: int, count: int):
        self.correct, self.count = int(correct), int(count)

    def result(self):
        return (self.correct / max(1, self.count), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __eq__(self, other):
        return (self.correct, self.count) == (other.correct, other.count)

    def __repr__(self):
        acc, n = self.result()
        return f"Accuracy(correct: {self.correct}, count: {n}, " \
               f"accuracy: {acc:.5f})"


class LossResult(ValidationResult):
    def __init__(self, loss: float, count: int):
        self.loss, self.count = float(loss), int(count)

    def result(self):
        return (self.loss / max(1, self.count), self.count)

    def __add__(self, other):
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        avg, n = self.result()
        return f"Loss(loss: {self.loss:.4f}, count: {n}, average: {avg:.4f})"


class ValidationMethod:
    """``method(output, target) -> ValidationResult``."""

    def __call__(self, output, target):
        raise NotImplementedError


def _rows(output, target):
    """(N, C) output and (N,) int64 targets on the output's device."""
    out = torch.as_tensor(output)
    t = torch.as_tensor(target, device=out.device).long()
    if out.dim() == 1:
        out, t = out[None], t.reshape(1)
    return out, t


class Top1Accuracy(ValidationMethod):
    """Targets are 1-based class indices (``ValidationMethod.scala:91``)."""

    def __call__(self, output, target):
        out, t = _rows(output, target)
        correct = (out.argmax(dim=-1) + 1 == t).sum()
        return AccuracyResult(int(correct), t.shape[0])

    def __repr__(self):
        return "Top1Accuracy"


class Top5Accuracy(ValidationMethod):
    def __call__(self, output, target):
        out, t = _rows(output, target)
        top5 = out.topk(min(5, out.shape[-1]), dim=-1).indices + 1
        correct = (top5 == t[:, None]).any(dim=1).sum()
        return AccuracyResult(int(correct), t.shape[0])

    def __repr__(self):
        return "Top5Accuracy"


class Loss(ValidationMethod):
    """Average criterion loss over the set (``ValidationMethod.scala:208``)."""

    def __init__(self, criterion):
        self.criterion = criterion

    def __call__(self, output, target):
        out = torch.as_tensor(output)
        loss = float(self.criterion(out, target))
        n = out.shape[0] if out.dim() > 1 else 1
        return LossResult(loss * n, n)

    def __repr__(self):
        return "Loss"
