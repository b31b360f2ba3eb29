"""Non-maximum suppression for object detection (``bigdl_tpu/nn/nms.py``).

Caffe's convention (``nn/Nms.scala``): boxes are ``N x 4`` rows ``(x1, y1,
x2, y2)``; areas and overlaps count pixels inclusively (the ``+1``);
boxes are walked in descending score (a stable sort, so ties keep their
order) and a box is suppressed when its IoU with a box already kept is
above ``thresh``.

The IoU matrix is computed on the device of the scores (one batch of
elementwise ops) and moved to the host once as a bool matrix; the greedy
walk, whose trip count depends on the data, runs there, with no launch a
box."""

from __future__ import annotations

import numpy as np
import torch


def box_areas(boxes: torch.Tensor) -> torch.Tensor:
    """Areas ``(x2 - x1 + 1) * (y2 - y1 + 1)`` (``Nms.scala:118-130``)."""
    x1, y1, x2, y2 = boxes.unbind(1)
    return (x2 - x1 + 1.0) * (y2 - y1 + 1.0)


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU with the +1 convention (``Nms.scala:132-151``)."""
    areas = box_areas(boxes)
    x1, y1, x2, y2 = boxes.unbind(1)
    iw = torch.minimum(x2[:, None], x2[None, :]) - \
        torch.maximum(x1[:, None], x1[None, :]) + 1.0
    ih = torch.minimum(y2[:, None], y2[None, :]) - \
        torch.maximum(y1[:, None], y1[None, :]) + 1.0
    inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)
    return inter / (areas[:, None] + areas[None, :] - inter)


class Nms:
    """``Nms.scala``'s two calling forms: ``nms(scores, boxes, thresh,
    indices) -> count`` writes the kept indices, 1-based, into the caller's
    buffer; calling the object returns them 0-based as an ndarray."""

    def nms(self, scores, boxes, thresh: float, indices) -> int:
        n = int(np.prod(np.shape(scores)))
        if n and (len(indices) < n or
                  int(np.prod(np.shape(boxes))) != 4 * n):
            raise ValueError("indices buffer too small or box shape mismatch")
        kept = self(scores, boxes, thresh)
        for j, ind in enumerate(kept):
            indices[j] = int(ind) + 1
        return len(kept)

    def __call__(self, scores, boxes, thresh: float) -> np.ndarray:
        """The kept 0-based indices, in descending score."""
        scores = torch.as_tensor(scores, dtype=torch.float32).reshape(-1)
        if scores.numel() == 0:
            return np.zeros((0,), np.int64)
        boxes = torch.as_tensor(boxes, dtype=torch.float32,
                                device=scores.device).reshape(-1, 4)
        order = torch.argsort(-scores, stable=True)
        b = boxes[order]
        over = (iou_matrix(b) > thresh).cpu().numpy()
        alive = np.ones(len(over), bool)
        for i in range(len(over)):
            if alive[i]:
                alive[i + 1:] &= ~over[i, i + 1:]
        return order.cpu().numpy()[alive]
