"""The multi-process decode/augment stage of the sharded feed
(``bigdl_tpu/dataset/ingest_pool.py``).

``MTTransformer``'s threads share one interpreter, so a recipe with Python
in its per-record work plateaus near one core.  ``IngestPool`` is a
persistent pool of worker PROCESSES, each holding its own copy of the
decode, augment and (optionally) pack chains, fed fixed-size chunks of
records and reassembled strictly in submission order.  No worker touches
the card: the chains are numpy and the native host helpers, and the pool
starts its workers by ``spawn`` (``ingest_config.start_method``; ``fork``
after CUDA is initialised deadlocks), so a worker never holds a CUDA
context.

Determinism: the CHUNK, not the worker, is the unit of seeding and of
reassembly.  Chunk ``k`` of epoch ``e`` always carries the seed
``fold_seed(seed, e, k)`` (the augment chain is ``reseed``-ed with it) and
always lands at position ``k`` of the output, so the worker count (0, 1,
8, ...) never changes the sample stream, only how fast it arrives.

Failures: a worker that raises hands on its own exception; a worker that
DIES (killed, out of memory, a segfault) turns the pool's
``BrokenProcessPool`` into a typed :class:`IngestWorkerDied` at the
consumer, never a hang.  Fault sites: ``ingest.worker`` (raises inside the
worker) and ``ingest.worker.kill`` (``os._exit``, the real death); spawned
workers arm them from ``BIGDL_TPU_FAULTS``.  The reference's per-chunk
trace spans and run-ledger records come with the host subsystems
(``ROADMAP.md`` Queue 1 item 13).
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Iterator, List, Optional

from bigdl_tpu_torch.dataset import ingest_config
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.resilience.fault_injector import FaultInjector


class IngestWorkerDied(RuntimeError):
    """A decode/augment worker process died without returning its chunk
    (a hard crash; an exception would propagate as itself)."""


def fold_seed(seed: int, epoch: int, chunk_index: int) -> int:
    """The 32-bit seed of one chunk of one epoch: a SplitMix64-style mix,
    so nearby (epoch, chunk) pairs land far apart."""
    x = (seed * 0x9E3779B97F4A7C15 + epoch * 0xBF58476D1CE4E5B9
         + chunk_index * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 27
    return x & 0xFFFFFFFF


# -- the worker process's side ------------------------------------------------
#
# Module-level state and top-level functions: spawn pickles the initializer
# and the task function by reference, and a worker builds its chains once.

_WORKER: dict = {}


def _init_worker(decode: Optional[Transformer],
                 augment: Optional[Transformer],
                 pack: Optional[Transformer]) -> None:
    _WORKER["decode"] = decode
    _WORKER["augment"] = augment
    _WORKER["pack"] = pack


def _run_chunk(job) -> List:
    """One task: decode, augment (reseeded with the chunk's seed) and pack
    one chunk.  ``job`` is (chunk_index, chunk_seed, items)."""
    _, chunk_seed, items = job
    FaultInjector.fire("ingest.worker")
    if FaultInjector.should("ingest.worker.kill"):
        # the failure drilled: the process vanishes mid-chunk, with no
        # exception and no cleanup
        os._exit(13)
    records = items
    decode, augment = _WORKER.get("decode"), _WORKER.get("augment")
    pack = _WORKER.get("pack")
    if decode is not None:
        records = decode(iter(records))
    if augment is not None:
        augment.reseed(chunk_seed)
        records = augment(iter(records))
    if pack is not None:
        # a chunk leaves as MiniBatch blocks: one array to unpickle, not
        # one a record; the parent concatenates them to the batch size
        records = pack(iter(records))
    return list(records)


def run_chunk_inprocess(decode, augment, chunk_index: int,
                        chunk_seed: int, items: List,
                        pack: Optional[Transformer] = None) -> List:
    """``workers=0``: the same task, the same seeding, on the caller's
    thread, so the in-process stream is the pool's bit for bit."""
    saved = dict(_WORKER)
    _init_worker(decode, augment, pack)
    try:
        return _run_chunk((chunk_index, chunk_seed, items))
    finally:
        _WORKER.clear()
        _WORKER.update(saved)


# -- the parent's side --------------------------------------------------------

class IngestPool:
    """A persistent process pool applying (decode, augment, pack) to chunks
    in order.  Persistent because the trainer builds a fresh data iterator
    every epoch, and spawning interpreters per epoch would bill the pool's
    start to every epoch's first batches."""

    def __init__(self, decode: Optional[Transformer],
                 augment: Optional[Transformer],
                 workers: Optional[int] = None,
                 pack: Optional[Transformer] = None):
        self.decode = decode
        self.augment = augment
        self.pack = pack
        self.workers = ingest_config.workers(workers)
        self.start_method = ingest_config.start_method()
        self._pool = None
        self._lock = threading.Lock()

    def _ensure_pool(self):
        with self._lock:
            if self._pool is None:
                import multiprocessing
                from concurrent.futures import ProcessPoolExecutor
                ctx = multiprocessing.get_context(self.start_method)
                self._pool = ProcessPoolExecutor(
                    self.workers, mp_context=ctx, initializer=_init_worker,
                    initargs=(self.decode, self.augment, self.pack))
                # a dead worker can leave the call queue's feeder thread
                # blocked on a full pipe nobody reads, and the exit-time
                # join of the executor's threads then hangs the
                # interpreter after IngestWorkerDied surfaced; the feeder
                # is a daemon thread: never wait for it
                self._pool._call_queue.cancel_join_thread()
            return self._pool

    def close(self, wait: bool = True) -> None:
        """Shut the pool down (idempotent).  A caller on a failure path
        passes ``wait=False``: a broken pool's workers may never join."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=wait, cancel_futures=True)

    def __del__(self):
        # never block garbage collection on a wedged worker
        if getattr(self, "_pool", None) is not None:
            self.close(wait=False)

    def run(self, chunks: Iterator):
        """Yield the processed records of each chunk in submission order.
        ``chunks`` yields (chunk_index, chunk_seed, items); at most
        2 * workers chunks are in flight, so an endless upstream
        streams."""
        if self.workers == 0:
            for chunk_index, chunk_seed, items in chunks:
                yield from run_chunk_inprocess(
                    self.decode, self.augment, chunk_index, chunk_seed,
                    items, pack=self.pack)
            return
        from concurrent.futures.process import BrokenProcessPool
        pool = self._ensure_pool()
        window = 2 * self.workers
        pending: collections.deque = collections.deque()
        try:
            for job in chunks:
                try:
                    pending.append(pool.submit(_run_chunk, job))
                except (BrokenProcessPool, RuntimeError) as e:
                    # a death breaks submission too (and a racing shutdown
                    # raises RuntimeError): the same failure here
                    raise self._died(e)
                if len(pending) >= window:
                    yield from self._result(pending.popleft())
            while pending:
                yield from self._result(pending.popleft())
        finally:
            for f in pending:
                f.cancel()

    def _result(self, future) -> List:
        from concurrent.futures.process import BrokenProcessPool
        try:
            return future.result()
        except BrokenProcessPool as e:
            raise self._died(e)

    def _died(self, cause: BaseException) -> IngestWorkerDied:
        # a broken pool is unusable; drop it so a caller that goes on
        # (a test, a caller that re-arms) builds a new one
        self.close(wait=False)
        err = IngestWorkerDied(
            f"ingest worker process died mid-chunk ({self.workers} "
            "workers; BIGDL_TPU_FAULTS=ingest.worker.kill drills it): the "
            "pool is torn down and the stream cannot continue.  If this "
            "fired at startup in a script, put its entry point under `if "
            "__name__ == '__main__':`; the spawn start method re-imports "
            "the main module in every worker")
        err.__cause__ = cause
        return err
