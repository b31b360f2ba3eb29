"""Composable iterator transformers (``bigdl_tpu/dataset/transformer.py``,
the part the trainer and the python binding's helpers need).

Parity: ``dataset/Transformer.scala:40-241``: a transformer maps an iterator
to an iterator and composes with ``>>``; ``SampleToBatch`` stacks Samples
into numpy MiniBatches, the last one possibly smaller; ``reseed`` re-derives a
chain's random streams per chunk for the sharded feed.  Everything here is
numpy on the host; the trainer copies each batch to its device.
"""

from __future__ import annotations

from typing import Callable, Iterator

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

    def clone_transformer(self) -> "Transformer":
        """A deep copy (``Transformer.scala`` cloneTransformer): its own
        random streams, at the state this one's are in."""
        import copy
        return copy.deepcopy(self)

    def _walk(self) -> Iterator["Transformer"]:
        """The leaf transformers of this (possibly chained) pipeline, in
        order: the unit ``reseed`` salts by position."""
        yield self

    def reseed(self, seed: int) -> None:
        """Re-derive every stochastic leaf's ``_rng`` from ``seed``, salted
        by the leaf's position, so two augmentations of one chain never
        draw alike.  The sharded feed reseeds a chain per chunk from the
        chunk's place in the stream, so the draws a record gets depend on
        where it sits, never on which worker ran it or how many ran."""
        for i, t in enumerate(self._walk()):
            if hasattr(t, "_rng"):
                t._rng = np.random.RandomState(
                    (seed ^ (0x9E3779B1 * (i + 1))) & 0xFFFFFFFF)


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def apply(self, prev):
        return self.second(self.first(prev))

    def _walk(self):
        yield from self.first._walk()
        yield from self.second._walk()


class Lambda(Transformer):
    """Wrap a per-element function as a transformer."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def apply(self, prev):
        return (self.fn(x) for x in prev)


class Identity(Transformer):
    def apply(self, prev):
        return prev


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


def normalizer(mean, std):
    """Sample -> Sample feature normalization (python-binding parity:
    ``dl/src/main/python/dataset/transformer.py:22``).  Use with
    ``Lambda``: ``ds >> Lambda(normalizer(mean, std))``, or map it over a
    sample list before ``DataSet.array``."""
    def apply(sample: Sample) -> Sample:
        return Sample((np.asarray(sample.feature, np.float32) - mean) / std,
                      sample.label)
    return apply


class SampleToBatch(Transformer):
    """Sample -> MiniBatch of ``batch_size`` stacked samples
    (``dataset/Transformer.scala``); the tail of the stream makes a smaller
    last batch, or none with ``drop_last`` (``train_main`` of the
    TransformerLM drops it).  The reference's padding options
    (``feature_padding``, ``label_padding``, ``fixed_length``) come with the
    DistriOptimizer slice, their only caller."""

    def __init__(self, batch_size: int, feature_padding=None,
                 label_padding=None, fixed_length=None,
                 drop_last: bool = False):
        if (feature_padding, label_padding, fixed_length) != \
                (None, None, None):
            raise NotImplementedError(
                "SampleToBatch's feature_padding, label_padding and "
                "fixed_length come with the DistriOptimizer slice of the "
                "port (ROADMAP.md Queue 1 item 12)")
        self.batch_size = batch_size
        self.drop_last = drop_last

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
        if feats and not self.drop_last:
            yield self._batch(feats, labels)
