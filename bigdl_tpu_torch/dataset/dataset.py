"""DataSet abstractions (``bigdl_tpu/dataset/dataset.py``, the local part).

Parity: ``dataset/DataSet.scala``: ``AbstractDataSet`` with
``data(train)/shuffle()/size()/transform``, ``LocalArrayDataSet`` (an
in-memory array with an index-shuffled looping iterator) and
``TransformedDataSet`` (``ds >> transformer``).  The shuffle stream is a
``np.random.RandomState(seed)`` permuting the index array in place once
per epoch, the same stream as the reference's, so both trainers see the
same batches in the same order.  ``DataSet.seq_file_folder`` is the
record-file ImageNet dataset: its elements are the files, its ``size()``
their records.  The multi-process sharded dataset is ``ShardedDataSet``
(``dataset/sharded.py``); sharding across hosts by the process group comes
with the DistriOptimizer slice of the port.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import MiniBatch, Transformer


class AbstractDataSet:

    def data(self, train: bool) -> Iterator:
        """train=True: infinite shuffled looping iterator; train=False: one
        pass in order (``DataSet.scala:47-104``)."""
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer):
        return self.transform(transformer)


def _record_count(items) -> int:
    """Total records in a buffer: pre-batched MiniBatch items count their
    rows, so ``size()`` agrees with the trainer's per-batch accounting."""
    if items and isinstance(items[0], MiniBatch):
        return sum(b.size() for b in items)
    return len(items)


class LocalArrayDataSet(AbstractDataSet):
    """``DataSet.scala:128-157``."""

    def __init__(self, data: Sequence, seed: int = 1):
        self.buffer = list(data)
        self._perm = np.arange(len(self.buffer))
        self._rng = np.random.RandomState(seed)

    def size(self) -> int:
        return _record_count(self.buffer)

    def shuffle(self) -> None:
        self._rng.shuffle(self._perm)

    def data(self, train: bool) -> Iterator:
        if train:
            def looper():
                i = 0
                n = len(self.buffer)
                while True:
                    yield self.buffer[self._perm[i % n]]
                    i += 1
            return looper()
        return iter(self.buffer)


def _count_seqfile_records(paths) -> int:
    from bigdl_tpu_torch.dataset.seqfile import count_records
    return sum(count_records(getattr(p, "path", p)) for p in paths)


class _SeqFileLocalDataSet(LocalArrayDataSet):
    """Record-file paths whose ``size()`` is their record count (a header
    scan, at the first call), or ``total_size`` where given."""

    def __init__(self, paths, seed: int = 1,
                 total_size: Optional[int] = None):
        super().__init__(paths, seed)
        self._total = total_size

    def size(self) -> int:
        if self._total is None:
            self._total = _count_seqfile_records(self.buffer)
        return self._total


class TransformedDataSet(AbstractDataSet):
    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def size(self) -> int:
        return self.base.size()

    def shuffle(self) -> None:
        self.base.shuffle()

    def data(self, train: bool) -> Iterator:
        return self.transformer(self.base.data(train))

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self.base,
                                  self.transformer.and_then(transformer))


class DataSet:
    """Factory namespace (``DataSet.scala:265-449``)."""

    @staticmethod
    def array(data, num_shards: Optional[int] = None, seed: int = 1):
        if num_shards:
            raise NotImplementedError(
                "DataSet.array(num_shards=...) builds the sharded dataset of "
                "the DistriOptimizer slice of the port")
        return LocalArrayDataSet(data, seed)

    @staticmethod
    def seq_file_folder(folder: str, num_shards: Optional[int] = None,
                        seed: int = 1, total_size: Optional[int] = None,
                        host_shard: bool = False):
        """Record-file ImageNet (``DataSet.SeqFileFolder.files``,
        ``dataset/DataSet.scala:437-449``): the elements are the folder's
        record-file paths, shuffled per epoch as whole files; pipe them
        through ``seqfile.LocalSeqFileToBytes`` to stream records.
        ``size()`` counts records (a header scan, or ``total_size``), so
        epoch triggers count images as the reference's record RDD does."""
        if num_shards or host_shard:
            raise NotImplementedError(
                "DataSet.seq_file_folder(num_shards=, host_shard=True) "
                "comes with the DistriOptimizer slice of the port "
                "(ROADMAP.md Queue 1 item 12)")
        from bigdl_tpu_torch.dataset.seqfile import seq_file_paths
        return _SeqFileLocalDataSet(seq_file_paths(folder), seed,
                                    total_size=total_size)
