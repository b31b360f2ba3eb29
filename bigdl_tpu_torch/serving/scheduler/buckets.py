"""Batch-bucket ladder with pad-to-bucket dispatch
(``bigdl_tpu/serving/scheduler/buckets.py``).

A small set of batch shapes (``BucketLadder``, e.g. ``8, 32``), every one
warmed before traffic arrives; each dispatch pads only up to the nearest
rung at or above its live size.  PyTorch runs eagerly, so a rung is not a
compiled program here; warmup still runs each rung, which absorbs the
first-use kernel build and per-thread library set-up, and seeds the
per-rung service-time floor and estimate that admission and batching plan
with.  The worker pool runs :meth:`BucketedRunner.warmup` inside each
worker thread, the thread that will serve.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# EWMA weight for per-bucket service-time estimates
_EST_ALPHA = 0.2


class BucketLadder:
    """A validated, ascending ladder of batch buckets; ``pick(n)`` returns
    the smallest rung that fits ``n``."""

    def __init__(self, buckets: Sequence[int], name: str = "batch"):
        vals = [int(b) for b in buckets]
        if not vals:
            raise ValueError(f"{name} bucket ladder is empty")
        if any(b < 1 for b in vals):
            raise ValueError(
                f"{name} bucket ladder {vals} has a non-positive rung")
        if len(set(vals)) != len(vals):
            raise ValueError(
                f"{name} bucket ladder {vals} has duplicate rungs")
        self.name = name
        self.buckets: List[int] = sorted(vals)

    @property
    def max(self) -> int:
        return self.buckets[-1]

    @property
    def min(self) -> int:
        return self.buckets[0]

    def pick(self, n: int) -> int:
        """Smallest rung >= ``n``."""
        if n < 1:
            raise ValueError(f"cannot bucket a size-{n} batch")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"size {n} exceeds the largest {self.name} bucket "
            f"{self.max} (ladder {self.buckets})")

    def __iter__(self):
        return iter(self.buckets)

    def __len__(self) -> int:
        return len(self.buckets)

    def __repr__(self) -> str:
        return f"BucketLadder({self.name}: {self.buckets})"


def pad_to_bucket(feats: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad ``feats`` (rows-leading) up to ``bucket`` rows."""
    n = feats.shape[0]
    if n > bucket:
        raise ValueError(f"{n} rows do not fit bucket {bucket}")
    if n == bucket:
        return feats
    pad = np.zeros((bucket - n,) + feats.shape[1:], feats.dtype)
    return np.concatenate([feats, pad])


class BucketedRunner:
    """The ``DLClassifier`` forward at every rung of a batch-bucket ladder,
    with the serving discipline around it: only ladder shapes are ever
    dispatched, every rung runs once at :meth:`warmup`, and per-bucket
    service-time floors and EWMA estimates feed admission and batching."""

    def __init__(self, classifier, ladder: BucketLadder):
        self.classifier = classifier
        self.ladder = ladder
        self._row_shape = tuple(classifier.batch_shape[1:])
        self._lock = threading.Lock()
        self._floor: Dict[int, float] = {}      # best observed, per rung
        self._est: Dict[int, float] = {}        # EWMA, per rung

    def warmup(self) -> Dict[int, float]:
        """Run every rung twice (the first absorbs kernel builds and
        library autotuning) and seed its floor and estimate from the
        second; returns {bucket: steady-state seconds}."""
        out: Dict[int, float] = {}
        clf = self.classifier
        for bucket in self.ladder:
            x = torch.zeros((bucket,) + self._row_shape,
                            dtype=clf.compute_dtype or torch.float32)
            self.run(x, bucket).cpu()
            clf.synchronize()
            t0 = time.monotonic()
            self.run(x, bucket).cpu()
            clf.synchronize()
            dur = time.monotonic() - t0
            self.observe(bucket, dur)
            out[bucket] = dur
        return out

    def pack(self, feats_list: Sequence[np.ndarray], bucket: int):
        """``DLClassifier._pack`` at the rung's size — one pack contract
        for offline and online inference."""
        return self.classifier._pack(list(feats_list), size=bucket)

    def run(self, x, bucket: int):
        """Run the forward on ``x``, already padded to ``bucket`` rows; an
        off-ladder bucket or a batch of another size raises."""
        if bucket not in self.ladder.buckets:
            raise ValueError(f"bucket {bucket} is not a ladder rung "
                             f"({self.ladder.buckets})")
        if x.shape[0] != bucket:
            raise ValueError(f"bucket-{bucket} forward dispatched with a "
                             f"batch of {x.shape[0]} rows")
        return self.classifier._run(x)

    # -- service-time model -------------------------------------------------

    def observe(self, bucket: int, dur_s: float) -> None:
        with self._lock:
            f = self._floor.get(bucket)
            self._floor[bucket] = dur_s if f is None else min(f, dur_s)
            e = self._est.get(bucket)
            self._est[bucket] = dur_s if e is None else \
                (1 - _EST_ALPHA) * e + _EST_ALPHA * dur_s

    def floor_s(self, bucket: Optional[int] = None) -> float:
        """Best observed service time — for ``bucket`` when given, else the
        smallest across the ladder (the admission layer's proof)."""
        with self._lock:
            if bucket is not None and bucket in self._floor:
                return self._floor[bucket]
            return min(self._floor.values()) if self._floor else 0.0

    def est_s(self, bucket: Optional[int] = None) -> float:
        """EWMA service time for ``bucket`` (default: the largest rung)."""
        with self._lock:
            if bucket is not None and bucket in self._est:
                return self._est[bucket]
            if self._est:
                return self._est[max(self._est)]
            return 0.0
