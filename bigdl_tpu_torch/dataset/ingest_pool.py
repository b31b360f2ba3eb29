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
workers arm them from ``BIGDL_TPU_FAULTS``.

Trace: each chunk's stages run under ``ingest.decode``, ``ingest.augment``
and ``ingest.pack`` spans (``ingest.chunk`` for a chain-less worker), with
the chunk's record count.  A spawned worker adopts the parent's run
directory (an initializer argument) and trace id (``BIGDL_TPU_TRACE_ID``,
inherited from the parent's environment), and the submitting span's
context rides with each chunk (``observability.trace.current_wire``), so
the worker's top-level spans link back to it across the process boundary.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Iterator, List, Optional

from bigdl_tpu_torch.dataset import ingest_config
from bigdl_tpu_torch.dataset.transformer import MiniBatch, Transformer
from bigdl_tpu_torch.observability import ledger
from bigdl_tpu_torch.observability import trace as run_trace
from bigdl_tpu_torch.observability import tracer
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
                 pack: Optional[Transformer],
                 run_dir: Optional[str] = None) -> None:
    """Per-process set-up: adopt the parent's run directory, so this
    pid's ``ingest.*`` spans land beside the trainer's events file, and
    keep the chains."""
    if run_dir:
        ledger.set_run_dir(run_dir)
    _WORKER["decode"] = decode
    _WORKER["augment"] = augment
    _WORKER["pack"] = pack


def _run_chunk(job) -> List:
    """One task: decode, augment (reseeded with the chunk's seed) and pack
    one chunk.  ``job`` is (chunk_index, chunk_seed, items[, trace_ctx]):
    the optional trace context of the submitting span is attached, so this
    worker's spans link back to it."""
    ctx = None
    if len(job) == 4:
        chunk_index, chunk_seed, items, ctx = job
    else:
        chunk_index, chunk_seed, items = job
    with run_trace.attach(ctx):
        return _run_chunk_body(chunk_index, chunk_seed, items)


def _run_chunk_body(chunk_index: int, chunk_seed: int,
                    items: List) -> List:
    FaultInjector.fire("ingest.worker")
    if FaultInjector.should("ingest.worker.kill"):
        # the failure drilled: the process vanishes mid-chunk, with no
        # exception and no cleanup
        os._exit(13)
    decode, augment = _WORKER.get("decode"), _WORKER.get("augment")
    pack = _WORKER.get("pack")
    if decode is None and augment is None and pack is None:
        # a chain-less worker still spans its chunk, so the trace shows
        # the topology
        with tracer.span("ingest.chunk", chunk=chunk_index,
                         records=len(items)):
            return list(items)
    records = items
    if decode is not None:
        records = _timed_stage("ingest.decode", decode, records,
                               chunk_index)
    if augment is not None:
        augment.reseed(chunk_seed)
        records = _timed_stage("ingest.augment", augment, records,
                               chunk_index)
    if pack is not None:
        # a chunk leaves as MiniBatch blocks: one array to unpickle, not
        # one a record; the parent concatenates them to the batch size
        records = _timed_stage("ingest.pack", pack, records, chunk_index)
    return list(records)


def _timed_stage(name: str, chain: Transformer, records: List,
                 chunk_index: int) -> List:
    """Apply one chain to one chunk under its own span; the record count
    (the rows inside MiniBatch blocks) is set after the work."""
    h = tracer.begin_span(name, chunk=chunk_index)
    error = None
    try:
        out = list(chain(iter(records)))
        h.set(records=sum(b.size() if isinstance(b, MiniBatch) else 1
                          for b in out))
        return out
    except BaseException as e:
        error = type(e).__name__
        raise
    finally:
        h.end(error=error)


def _served_chunk(job):
    """The pool's task: one chunk and the pid of the process that ran
    it."""
    return os.getpid(), _run_chunk(job)


def run_chunk_inprocess(decode, augment, chunk_index: int,
                        chunk_seed: int, items: List,
                        pack: Optional[Transformer] = None) -> List:
    """``workers=0``: the same task, the same seeding, on the caller's
    thread, so the in-process stream is the pool's bit for bit."""
    saved = dict(_WORKER)
    _WORKER["decode"], _WORKER["augment"] = decode, augment
    _WORKER["pack"] = pack
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
    start to every epoch's first batches.  ``served`` (a dict) counts the
    chunks each process ran, by pid."""

    def __init__(self, decode: Optional[Transformer],
                 augment: Optional[Transformer],
                 workers: Optional[int] = None,
                 pack: Optional[Transformer] = None,
                 served: Optional[dict] = None):
        self.served = {} if served is None else served
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
                led = ledger.get_ledger()
                ctx = multiprocessing.get_context(self.start_method)
                self._pool = ProcessPoolExecutor(
                    self.workers, mp_context=ctx, initializer=_init_worker,
                    initargs=(self.decode, self.augment, self.pack,
                              led.dir if led is not None else None))
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
            pid = os.getpid()
            for chunk_index, chunk_seed, items in chunks:
                out = run_chunk_inprocess(
                    self.decode, self.augment, chunk_index, chunk_seed,
                    items, pack=self.pack)
                self.served[pid] = self.served.get(pid, 0) + 1
                yield from out
            return
        from concurrent.futures.process import BrokenProcessPool
        pool = self._ensure_pool()
        window = 2 * self.workers
        pending: collections.deque = collections.deque()
        try:
            for job in chunks:
                # the submitting span's context rides with the chunk
                # (None, and no payload, when the ledger is off)
                ctx = run_trace.current_wire()
                if ctx is not None:
                    job = tuple(job) + (ctx,)
                try:
                    pending.append(pool.submit(_served_chunk, job))
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
            pid, out = future.result()
        except BrokenProcessPool as e:
            raise self._died(e)
        self.served[pid] = self.served.get(pid, 0) + 1
        return out

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
