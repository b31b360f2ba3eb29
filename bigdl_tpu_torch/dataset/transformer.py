"""Composable iterator transformers (``bigdl_tpu/dataset/transformer.py``,
the part the trainer needs).

Parity: ``dataset/Transformer.scala:40-241``: a transformer maps an iterator
to an iterator and composes with ``>>``; ``SampleToBatch`` stacks Samples
into numpy MiniBatches, the last one possibly smaller.  Everything here is
numpy on the host; the trainer copies each batch to its device.  Padding
for variable-length features comes with the TransformerLM slice.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class Transformer:
    """Iterator -> Iterator mapping; compose with ``>>``."""

    def apply(self, prev: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, prev: Iterator) -> Iterator:
        return self.apply(iter(prev))

    def and_then(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return self.and_then(other)


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def apply(self, prev):
        return self.second(self.first(prev))


class Sample:
    """Feature + label pair (``dataset/Sample.scala:34-103``)."""

    __slots__ = ("feature", "label")

    def __init__(self, feature, label):
        self.feature = np.asarray(feature)
        self.label = np.asarray(label)

    def __repr__(self):
        return f"Sample(feature{self.feature.shape}, " \
               f"label{self.label.shape})"


class MiniBatch:
    """Batched data + labels (``dataset/Types.scala:71-76``)."""

    __slots__ = ("data", "labels")

    def __init__(self, data, labels):
        self.data = data
        self.labels = labels

    def size(self) -> int:
        return self.data.shape[0]


class SampleToBatch(Transformer):
    """Sample -> MiniBatch of ``batch_size`` stacked samples; the tail of
    the stream makes a smaller last batch (``dataset/Transformer.scala``)."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size

    @staticmethod
    def _batch(feats, labels):
        return MiniBatch(np.stack(feats), np.stack(labels))

    def apply(self, prev):
        feats, labels = [], []
        for s in prev:
            feats.append(s.feature)
            labels.append(s.label)
            if len(feats) == self.batch_size:
                yield self._batch(feats, labels)
                feats, labels = [], []
        if feats:
            yield self._batch(feats, labels)
