"""Multi-threaded batching and host-to-device prefetch
(``bigdl_tpu/dataset/prefetch.py``).

Parity: ``dataset/image/MTLabeledBGRImgToBatch.scala:47-80``, the
reference's throughput-critical batcher, clones the transformer pipeline per
core and fills batch slots from several threads.  Here:

* ``MTTransformer`` fans a cloned transformer out over chunks of the
  element stream on a thread pool and reassembles them in order, keeping at
  most ``2 * workers`` chunks in flight (an epoch-looping upstream streams).
* ``MTLabeledBGRImgToBatch`` packs HxWx3 images into one NCHW buffer from
  several threads; each batch is a copy of it.
* ``PrefetchToDevice`` runs the upstream iterator in a background thread
  and copies each batch to the device ahead of the consumer: on the card
  through a ring of ``depth`` pinned host buffers (cast there to ``dtype``
  if given) and a side CUDA stream, so the next batch's copy overlaps the
  current step.  The consumer's stream waits on each copy's event, and each
  tensor is marked with ``record_stream`` for the consumer's stream, so the
  allocator never hands its memory out while the step may read it.  A
  pinned buffer is refilled only after its last copy's event completed.

The random crops and flips draw upstream of the threads, in the stream's
order, so the batches are the same whatever the worker count.  The pack
runs in the native host library (``native.pack_chw``), outside the
interpreter lock.  Fault sites (``resilience/fault_injector.py``):
``mt.worker`` in each ``MTTransformer`` task, ``prefetch.producer`` per
batch in the prefetch thread and ``prefetch.put`` at each copy, which is
retried as a transient error (``resilience/retry.py``).
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bigdl_tpu_torch import native as _native
from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.dataset import ingest_config
from bigdl_tpu_torch.dataset.transformer import MiniBatch, Transformer
from bigdl_tpu_torch.observability import tracer
from bigdl_tpu_torch.resilience.fault_injector import FaultInjector
from bigdl_tpu_torch.resilience.retry import retry


class MTTransformer(Transformer):
    """Apply ``transformer`` with ``workers`` cloned pipelines in parallel,
    preserving input order (``cloneTransformer`` parity).  ``workers`` and
    ``chunk`` default from ``BIGDL_TPU_INGEST_WORKERS`` (4 if unset) and
    ``BIGDL_TPU_INGEST_CHUNK``; ``workers=0`` runs in-process, the same
    stream.  A worker's exception reaches the consumer."""

    def __init__(self, transformer: Transformer, workers=None, chunk=None):
        self.transformer = transformer
        self.workers = ingest_config.workers(workers, default=4)
        self.chunk = ingest_config.chunk(chunk)

    def apply(self, prev):
        if self.workers == 0:
            yield from self.transformer.clone_transformer()(prev)
            return
        free: "queue.SimpleQueue" = queue.SimpleQueue()
        for _ in range(self.workers):
            free.put(self.transformer.clone_transformer())

        def run_chunk(items):
            FaultInjector.fire("mt.worker")
            c = free.get()
            try:
                return list(c.apply(iter(items)))
            finally:
                free.put(c)

        def chunks():
            buf = []
            for x in prev:
                buf.append(x)
                if len(buf) == self.chunk:
                    yield buf
                    buf = []
            if buf:
                yield buf

        # a bounded window, not pool.map (which consumes the whole upstream
        # before it yields anything)
        with ThreadPoolExecutor(self.workers) as pool:
            pending: collections.deque = collections.deque()
            try:
                for items in chunks():
                    pending.append(pool.submit(run_chunk, items))
                    if len(pending) >= 2 * self.workers:
                        yield from pending.popleft().result()
                while pending:
                    yield from pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()


class MTLabeledBGRImgToBatch(Transformer):
    """BGR images -> NCHW float32 MiniBatch, the slots filled by a thread
    pool (``image/MTLabeledBGRImgToBatch.scala``) through the native pack
    where it pays (``native=False``: numpy's copy); the tail of the stream
    makes a smaller last batch."""

    def __init__(self, width: int, height: int, batch_size: int,
                 to_rgb: bool = False, workers=None, native: bool = True):
        self.width, self.height = width, height
        self.batch_size = batch_size
        self.to_rgb = to_rgb
        self.workers = max(1, ingest_config.workers(workers, default=4))
        self.native = native

    def apply(self, prev):
        data = np.zeros((self.batch_size, 3, self.height, self.width),
                        np.float32)
        labels = np.zeros((self.batch_size,), np.float32)

        def fill(args):
            i, img = args
            if self.native and img.data.ndim == 3 and \
                    _native.pays(img.data):
                _native.pack_chw(img.data, data[i], to_rgb=self.to_rgb)
            else:
                x = img.data[..., ::-1] if self.to_rgb else img.data
                data[i] = x.transpose(2, 0, 1)
            labels[i] = img.label

        pool = ThreadPoolExecutor(self.workers)
        try:
            batch = []
            for img in prev:
                batch.append(img)
                if len(batch) == self.batch_size:
                    list(pool.map(fill, enumerate(batch)))
                    yield MiniBatch(data.copy(), labels.copy())
                    batch = []
            if batch:
                list(pool.map(fill, enumerate(batch)))
                yield MiniBatch(data[:len(batch)].copy(),
                                labels[:len(batch)].copy())
        finally:
            pool.shutdown(wait=False)


class _PinnedRing:
    """``depth`` host slots (a data and a labels buffer each, pinned when
    the device is the card), each with the event of its last copy to the
    card.  ``stage`` fills a slot (cast to ``dtype`` on the host) once that
    event has completed; ``upload`` copies a slot's rows to the device on
    the side stream and returns the device tensors and the copy's event.
    On the CPU ``upload`` copies the rows out of the slot, so a refill
    never shows through a yielded batch.  A batch with fewer rows than its
    slot goes through a view of it (a short tail); a slot grows to a batch
    that does not fit it."""

    def __init__(self, depth: int, dtype, device: torch.device):
        self.device = device
        self.dtype = dtype
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.depth = depth
        self.slots = [None] * depth
        self.events = [None] * depth
        self.n = 0

    @staticmethod
    def fits(capacity, shapes) -> bool:
        """Whether a batch of (data, labels) ``shapes`` fits slots of
        ``capacity``: no more rows, the same row shapes."""
        (sd, sl), (d, lb) = capacity, shapes
        return d[0] <= sd[0] and tuple(d[1:]) == tuple(sd[1:]) \
            and tuple(lb[1:]) == tuple(sl[1:])

    def stage(self, batch: MiniBatch, i=None):
        """Fill slot ``i`` (the next in turn by default); returns (i, rows)."""
        if i is None:
            i = self.n % self.depth
            self.n += 1
        data = torch.as_tensor(np.asarray(batch.data))
        labels = torch.as_tensor(np.asarray(batch.labels))
        if self.events[i] is not None:
            self.events[i].synchronize()   # its last copy has read the slot
        slot = self.slots[i]
        if slot is None or not self.fits((slot[0].shape, slot[1].shape),
                                         (data.shape, labels.shape)):
            slot = self.slots[i] = (
                torch.empty(data.shape, dtype=self.dtype or data.dtype,
                            pin_memory=self.cuda),
                torch.empty(labels.shape, dtype=labels.dtype,
                            pin_memory=self.cuda))
        n = data.shape[0]
        slot[0][:n].copy_(data)            # the host cast to ``dtype``
        slot[1][:n].copy_(labels)
        return i, n

    def upload(self, i: int, n: int):
        sd, sl = self.slots[i]
        host = (sd[:n], sl[:n])
        if not self.cuda:
            return host[0].clone(), host[1].clone(), None
        with torch.cuda.stream(self.stream):
            dev = tuple(h.to(self.device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[i] = event
        return dev + (event,)

    def put(self, batch: MiniBatch):
        return self.upload(*self.stage(batch))


_END = object()        # the end of a pipe's stream


class _Pipe:
    """A bounded queue between the threads of one device feed
    (``PrefetchToDevice``, ``StagingRing``), sharing the feed's ``stop``
    event: a put gives up once the consumer has abandoned the stream, so
    no thread blocks forever holding slots; an error gets through a full
    queue; a get returns None once ``stop`` is set, and raises where every
    thread that feeds the pipe died without handing on an error or the
    end, so a killed thread cannot leave its reader blocked."""

    def __init__(self, stop: threading.Event, maxsize: int = 0):
        self.q: "queue.Queue" = queue.Queue(maxsize)
        self.stop = stop

    def put(self, item) -> bool:
        while not self.stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def fail(self, e: BaseException) -> None:
        """Hand an error on, draining an item of a full queue that its
        reader stopped reading."""
        while not self.stop.is_set():
            try:
                self.q.put(e, timeout=0.1)
                return
            except queue.Full:
                try:
                    self.q.get_nowait()
                except queue.Empty:
                    pass

    def get(self, feeders=(), what: str = ""):
        while True:
            try:
                return self.q.get(timeout=0.1)
            except queue.Empty:
                if self.stop.is_set():
                    return None
                if feeders and not any(t.is_alive() for t in feeders):
                    try:
                        # the last item may have landed between the
                        # timeout and the thread's exit
                        return self.q.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            f"{what} thread(s) died without reporting an "
                            "error or end-of-stream") from None


def _feed(threads, pipe: _Pipe, device, what: str):
    """The consumer's side of a device feed: start ``threads``, then yield
    each copy of ``pipe`` once the consumer's stream waits on its event
    and its tensors are marked for that stream (so the allocator never
    hands their memory out while the step may read it); an error raises as
    itself.  On the end, an error or an abandoned consumer the threads are
    released and joined (they poll ``stop`` every 0.1 s, so a copy in
    flight ends before the interpreter's teardown)."""
    for t in threads:
        t.start()
    try:
        while True:
            item = pipe.get(threads, what)
            if item is _END or item is None:
                return
            if isinstance(item, BaseException):
                raise item
            data, labels, event = item
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                data.record_stream(stream)
                labels.record_stream(stream)
            yield MiniBatch(data, labels)
    finally:
        pipe.stop.set()
        for t in threads:
            t.join(timeout=5.0)


class PrefetchToDevice(Transformer):
    """Run the upstream iterator in a background thread and copy each
    MiniBatch to ``device`` (CUDA by default; it raises without CUDA unless
    asked for the CPU), keeping ``depth`` batches in flight.  ``dtype``
    casts batch DATA on the host before the copy (a bf16-mixed step casts
    it anyway; the cast halves the bytes on the link); labels keep theirs.
    ``depth`` defaults from ``BIGDL_TPU_INGEST_DEPTH`` (2), ``dtype`` from
    ``BIGDL_TPU_INGEST_DTYPE``.  It yields MiniBatches of tensors on
    ``device``; on the CPU each is a copy of the host batch."""

    def __init__(self, depth=None, dtype=None, device="cuda"):
        self.depth = ingest_config.depth(depth)
        self.dtype = ingest_config.pack_dtype(dtype)
        self.device = resolve_device(device)

    def _host_copy(self, batch: MiniBatch):
        data = torch.tensor(np.asarray(batch.data), dtype=self.dtype)
        return data, torch.tensor(np.asarray(batch.labels)), None

    def apply(self, prev):
        out = _Pipe(threading.Event(), self.depth)
        if self.device.type == "cuda":
            stage = _PinnedRing(self.depth, self.dtype, self.device).put
        else:
            stage = self._host_copy

        def producer():
            try:
                for b in prev:
                    FaultInjector.fire("prefetch.producer")
                    # a transient copy error is retried before it ends
                    # the run
                    staged = retry(_fire_put, stage, b,
                                   label="prefetch.device_put")
                    if not out.put(staged):
                        return
                out.put(_END)
            except BaseException as e:     # handed to the consumer
                out.fail(e)

        yield from _feed([threading.Thread(target=producer, daemon=True)],
                         out, self.device, "PrefetchToDevice producer")


def _fire_put(stage, batch):
    """The copy of one batch, behind its fault site ``prefetch.put``, under
    a ``prefetch.h2d`` span, so the ledger shows copy stalls on the
    producer thread."""
    FaultInjector.fire("prefetch.put")
    with tracer.span("prefetch.h2d"):
        return stage(batch)
