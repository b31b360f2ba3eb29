"""The sharded multi-process feed (``bigdl_tpu/dataset/sharded.py``).

BigDL keeps partitioned ingest as a layer of its own below the trainers
(Spark partitions of records feeding synchronous SGD, one pipeline an
executor).  ``ShardedDataSet`` rebuilds it with processes:

* **deterministic partitioning**: :func:`partition_range` and
  :func:`worker_shard` split files or records per host and per worker,
  every record exactly once, uneven splits balanced to within one item;
* **process-pool decode and augment** (``ingest_pool``), in order, each
  chunk's draws seeded from its place in the stream, so the sample stream
  is a function of (seed, epoch, position) alone, never of the worker
  count;
* **the staging ring** (``staging.StagingRing``): the host cast, the copy
  to the card and the step overlap.

The trainers take it through the ``DataSet`` seam (``data(train)``,
``size()``, ``shuffle()``), so ``LocalOptimizer`` runs unchanged on top,
and ``close()`` stops the pool at the end of a run::

    items --(host shard)-- chunks --> [worker processes: decode >> augment
          (>> pack)] --(in order)--> pack or coalesce --> StagingRing -->
          device

``host_index``/``host_count`` take one host's slice of the records; they
default to process 0 of 1 (reading them from the process group comes with
the DistriOptimizer slice of the port, ``ROADMAP.md`` Queue 1 item 12).
The parent's packing time and its wait on the workers are kept in
``stats``, and each batch's packing runs under an ``ingest.pack`` span
(``ingest.coalesce`` for worker-packed blocks) that leaves the wait on the
workers out, as in the reference.
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset import ingest_config
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet, _record_count
from bigdl_tpu_torch.dataset.ingest_pool import IngestPool, fold_seed
from bigdl_tpu_torch.dataset.transformer import MiniBatch, Transformer
from bigdl_tpu_torch.observability import tracer


def partition_range(n_items: int, index: int, count: int) -> range:
    """Item indices of shard ``index`` of ``count``: contiguous, balanced to
    within one item; the ``count`` ranges tile ``range(n_items)`` with no
    gap and no overlap for any ``n_items`` (0 and fewer than ``count``
    included)."""
    if not 0 <= index < count:
        raise ValueError(f"shard index {index} outside [0, {count})")
    base, rem = divmod(n_items, count)
    start = index * base + min(index, rem)
    return range(start, start + base + (1 if index < rem else 0))


def worker_shard(items: Sequence, host_index: int, host_count: int,
                 worker_index: int, worker_count: int) -> List:
    """The items of worker ``worker_index`` of host ``host_index``: the host
    split first (files stay on their host, the reference's executor
    placement), then the worker split within the host.  Over hosts and
    workers, every item exactly once."""
    hosted = [items[i] for i in
              partition_range(len(items), host_index, host_count)]
    return [hosted[i] for i in
            partition_range(len(hosted), worker_index, worker_count)]


class ShardedDataSet(AbstractDataSet):
    """A deterministically sharded, multi-process dataset.

    ``items`` are records or file paths (one file a chunk: a file expands
    to many records downstream).  With file items pass ``total_size`` (this
    host's record count) or use :meth:`from_seq_folder`, which counts the
    records: otherwise ``size()`` counts items and the trainer would roll
    its epochs after one record a file.  ``decode`` is the deterministic
    per-record chain run in the workers (``LocalSeqFileToBytes() >>
    SeqBytesToBGRImg()``), ``augment`` the stochastic one (crop, flip,
    normalize), reseeded per chunk.  ``batcher`` runs in the parent after
    the in-order reassembly (``BGRImgToBatch(32)``), so batches do not
    depend on the worker count either; ``pack_in_workers=True`` packs each
    chunk into MiniBatch blocks in its worker (one array to unpickle, not
    one a record) and the parent only concatenates them to
    ``batcher.batch_size``, the same batches.  ``staging=True`` appends a
    :class:`~bigdl_tpu_torch.dataset.staging.StagingRing` to ``device``
    (CUDA by default; it raises without CUDA unless asked for the CPU), so
    ``data(train)`` yields batches on the device, their data cast to
    ``staging_dtype``.
    """

    def __init__(self, items: Sequence, *,
                 decode: Optional[Transformer] = None,
                 augment: Optional[Transformer] = None,
                 batcher: Optional[Transformer] = None,
                 pack_in_workers: bool = False,
                 staging: bool = False,
                 staging_depth: Optional[int] = None,
                 staging_dtype=None,
                 device="cuda",
                 workers: Optional[int] = None,
                 chunk: Optional[int] = None,
                 seed: int = 1,
                 host_index: int = 0, host_count: int = 1,
                 total_size: Optional[int] = None):
        all_items = list(items)
        self.items = [all_items[i] for i in
                      partition_range(len(all_items), host_index,
                                      host_count)]
        self.host_index, self.host_count = host_index, host_count
        self.decode = decode
        self.augment = augment
        self.batcher = batcher
        if pack_in_workers:
            # the parent coalesces worker blocks back to the batch size
            if not hasattr(batcher, "batch_size"):
                raise ValueError(
                    "pack_in_workers=True needs a batcher with a "
                    f"batch_size attribute (got {type(batcher).__name__}) "
                    "so the parent can coalesce worker blocks to the "
                    "right size")
        self.pack_in_workers = pack_in_workers
        # staging copies MiniBatches: with no batcher and no decode to make
        # them, raw records would reach the ring
        if (staging and batcher is None and decode is None
                and all_items and not hasattr(all_items[0], "labels")):
            raise ValueError(
                "staging=True needs MiniBatch input: pass batcher=... "
                f"(items are {type(all_items[0]).__name__}, not "
                "MiniBatch)")
        self.staging = staging
        self.staging_depth = staging_depth
        self.staging_dtype = staging_dtype
        if staging:
            from bigdl_tpu_torch.core.device import resolve_device
            self.device = resolve_device(device)
        self.workers = ingest_config.workers(workers)
        self.chunk = ingest_config.chunk(chunk)
        self.seed = seed
        self._total = total_size
        self._size_fn = None              # set by from_seq_folder
        self._perm = np.arange(len(self.items))
        self._rng = np.random.RandomState(seed)
        self._epoch_serial = 0            # advanced by shuffle()
        self._pool: Optional[IngestPool] = None
        # the parent's side: seconds packing (or coalescing) and seconds
        # waiting on the workers, and the batches made; and the chunks
        # each process served, by pid (the pool keeps it across epochs)
        self.stats = {"pack_s": 0.0, "wait_s": 0.0, "batches": 0,
                      "chunks_by_pid": {}}

    @classmethod
    def from_seq_folder(cls, folder: str, *,
                        decode: Optional[Transformer] = None,
                        chunk: Optional[int] = 1,
                        host_index: int = 0, host_count: int = 1,
                        **kwargs) -> "ShardedDataSet":
        """The record-file folder on the sharded feed: the items are the
        folder's record FILES (one a chunk), ``decode`` defaults to
        ``LocalSeqFileToBytes >> SeqBytesToBGRImg``, and ``size()`` counts
        this host's records (a header scan at the first call), so epochs
        count images, not files."""
        from bigdl_tpu_torch.dataset.seqfile import (LocalSeqFileToBytes,
                                                     SeqBytesToBGRImg,
                                                     count_records,
                                                     seq_file_paths)
        if decode is None:
            decode = LocalSeqFileToBytes() >> SeqBytesToBGRImg()
        ds = cls(seq_file_paths(folder), decode=decode, chunk=chunk,
                 host_index=host_index, host_count=host_count, **kwargs)
        ds._size_fn = lambda: sum(count_records(p) for p in ds.items)
        return ds

    # -- the DataSet seam ----------------------------------------------------

    def size(self) -> int:
        if self._total is None:
            self._total = (self._size_fn() if self._size_fn is not None
                           else _record_count(self.items))
        return self._total

    def shuffle(self) -> None:
        """Permute the item order for the next epoch: a function of (seed,
        shuffles so far) alone, so a resume replays it and every worker
        count sees it alike."""
        self._rng.shuffle(self._perm)
        self._epoch_serial += 1

    def transform(self, transformer: Transformer) -> "ShardedDataSet":
        """Append to the worker-side augment chain (the ``>>`` seam);
        batching and staging stay in the parent (``batcher``,
        ``staging``), so the order and the batches are kept."""
        self.augment = (transformer if self.augment is None
                        else self.augment.and_then(transformer))
        self.close()                # the chains changed: new workers
        return self

    # -- the pipeline --------------------------------------------------------

    def _worker_pack(self) -> Transformer:
        """The batcher shipped to the workers, ``drop_last`` off: a worker
        packs one chunk, and dropping each chunk's tail would lose records;
        the stream's ``drop_last`` is ``_coalesced``'s in the parent."""
        pack = self.batcher.clone_transformer()
        if getattr(pack, "drop_last", False):
            pack.drop_last = False
        return pack

    def _ensure_pool(self) -> IngestPool:
        if self._pool is None:
            self._pool = IngestPool(
                self.decode, self.augment, workers=self.workers,
                pack=self._worker_pack() if self.pack_in_workers
                else None, served=self.stats["chunks_by_pid"])
        return self._pool

    def close(self, wait: bool = True) -> None:
        """Shut the worker pool down (idempotent).  The pool otherwise
        lives across epochs: the trainer builds a fresh ``data()`` every
        epoch, and a respawn would bill the workers' start to each."""
        if self._pool is not None:
            self._pool.close(wait=wait)
            self._pool = None

    def _chunks(self, train: bool) -> Iterator:
        """(chunk_index, chunk_seed, items) jobs in stream order; the index
        counts within the epoch, the seed folds the epoch in, so the
        augmentation changes across epochs but never across worker
        counts."""
        epoch = self._epoch_serial
        order = [self.items[i] for i in self._perm] if train \
            else list(self.items)
        for ci in range(0, len(order), self.chunk):
            idx = ci // self.chunk
            yield (idx, fold_seed(self.seed, epoch, idx),
                   order[ci:ci + self.chunk])

    def data(self, train: bool) -> Iterator:
        """One epoch's stream (the trainer asks again each epoch, after
        ``shuffle()``): records (no batcher), host MiniBatches (a batcher)
        or MiniBatches on the device (a batcher and staging)."""
        stream = self._ensure_pool().run(self._chunks(train))
        if self.batcher is not None:
            if self.pack_in_workers:
                stream = _coalesced(self.batcher.batch_size,
                                    getattr(self.batcher, "drop_last",
                                            False), stream, self.stats)
            else:
                stream = _packed(self.batcher, stream, self.stats)
        if self.staging:
            from bigdl_tpu_torch.dataset.staging import StagingRing
            stream = StagingRing(depth=self.staging_depth,
                                 dtype=self.staging_dtype,
                                 device=self.device).apply(stream)
        return stream


class _TimedIter:
    """An iterator that adds up the time spent in its upstream's
    ``next()``: the parent's wait on the workers, which the packing time
    leaves out."""

    def __init__(self, it: Iterator):
        self._it = iter(it)
        self.waited_s = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            return next(self._it)
        finally:
            self.waited_s += time.perf_counter() - t0


def _coalesced(batch_size: int, drop_last: bool, stream: Iterator,
               stats: dict) -> Iterator:
    """Concatenate worker-packed MiniBatch blocks back to ``batch_size``
    rows in stream order: the parent's half of ``pack_in_workers``."""
    timed = _TimedIter(stream)
    pending: list = []                 # blocks, in order
    rows = 0

    def emit(n: int) -> MiniBatch:
        nonlocal rows
        take_d, take_l, got = [], [], 0
        while got < n:
            blk = pending[0]
            d, lab = np.asarray(blk.data), np.asarray(blk.labels)
            need = n - got
            if d.shape[0] <= need:
                take_d.append(d)
                take_l.append(lab)
                got += d.shape[0]
                pending.pop(0)
            else:
                take_d.append(d[:need])
                take_l.append(lab[:need])
                pending[0] = MiniBatch(d[need:], lab[need:])
                got = n
        rows -= n
        if len(take_d) == 1:
            return MiniBatch(take_d[0], take_l[0])
        return MiniBatch(np.concatenate(take_d), np.concatenate(take_l))

    while True:
        h = tracer.begin_span("ingest.coalesce")
        t0, w0 = time.perf_counter(), timed.waited_s
        try:
            while rows < batch_size:
                blk = next(timed)
                pending.append(blk)
                rows += blk.size()
        except StopIteration:
            h.exclude(timed.waited_s - w0)
            if rows and not drop_last:
                out = emit(rows)
                _account(stats, t0, timed.waited_s - w0)
                h.set(records=out.size())
                h.end()
                yield out
            else:
                h.end()
            return
        except BaseException as e:
            h.exclude(timed.waited_s - w0)
            h.end(error=type(e).__name__)
            raise
        out = emit(batch_size)
        _account(stats, t0, timed.waited_s - w0)
        h.exclude(timed.waited_s - w0)
        h.set(records=out.size())
        h.end()
        yield out


def _packed(batcher: Transformer, stream: Iterator, stats: dict) -> Iterator:
    """Driver-side batch assembly; each batch's packing time leaves out the
    time its pull waited on the workers."""
    timed = _TimedIter(stream)
    it = batcher(timed)
    while True:
        h = tracer.begin_span("ingest.pack")
        t0, w0 = time.perf_counter(), timed.waited_s
        try:
            batch = next(it)
        except StopIteration:
            h.exclude(timed.waited_s - w0)
            h.end()
            return
        except BaseException as e:
            h.exclude(timed.waited_s - w0)
            h.end(error=type(e).__name__)
            raise
        _account(stats, t0, timed.waited_s - w0)
        h.exclude(timed.waited_s - w0)
        h.set(records=batch.size() if hasattr(batch, "size") else 0)
        h.end()
        yield batch


def _account(stats: dict, t0: float, waited: float) -> None:
    stats["pack_s"] += time.perf_counter() - t0 - waited
    stats["wait_s"] += waited
    stats["batches"] += 1
