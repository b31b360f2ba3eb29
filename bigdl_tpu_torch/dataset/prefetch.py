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
order, so the batches are the same whatever the worker count.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.dataset import ingest_config
from bigdl_tpu_torch.dataset.transformer import MiniBatch, Transformer


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
    pool (``image/MTLabeledBGRImgToBatch.scala``); the tail of the stream
    makes a smaller last batch."""

    def __init__(self, width: int, height: int, batch_size: int,
                 to_rgb: bool = False, workers=None):
        self.width, self.height = width, height
        self.batch_size = batch_size
        self.to_rgb = to_rgb
        self.workers = max(1, ingest_config.workers(workers, default=4))

    def apply(self, prev):
        data = np.zeros((self.batch_size, 3, self.height, self.width),
                        np.float32)
        labels = np.zeros((self.batch_size,), np.float32)

        def fill(args):
            i, img = args
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
    """``depth`` pinned host slots (a data and a labels buffer each), each
    with the event of its last copy to the card.  ``put`` refills the next
    slot once that event has completed, copies it on the side stream and
    returns the device tensors and the copy's event."""

    def __init__(self, depth: int, dtype, device: torch.device):
        self.device = device
        self.dtype = dtype
        self.stream = torch.cuda.Stream(device)
        self.slots = [(None, None)] * depth
        self.events = [None] * depth
        self.n = 0

    @staticmethod
    def _fill(buf, src, dtype):
        if buf is None or buf.shape != src.shape or buf.dtype != dtype:
            buf = torch.empty(src.shape, dtype=dtype, pin_memory=True)
        buf.copy_(src)             # the host cast to ``dtype``, if any
        return buf

    def put(self, batch: MiniBatch):
        i = self.n % len(self.slots)
        self.n += 1
        if self.events[i] is not None:
            self.events[i].synchronize()   # its last copy has read the slot
        data = torch.as_tensor(np.asarray(batch.data))
        labels = torch.as_tensor(np.asarray(batch.labels))
        old_data, old_labels = self.slots[i]
        host = (self._fill(old_data, data, self.dtype or data.dtype),
                self._fill(old_labels, labels, labels.dtype))
        self.slots[i] = host
        with torch.cuda.stream(self.stream):
            dev = tuple(h.to(self.device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[i] = event
        return dev + (event,)


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
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        stop = threading.Event()
        if self.device.type == "cuda":
            stage = _PinnedRing(self.depth, self.dtype, self.device).put
        else:
            stage = self._host_copy

        def put(item) -> bool:
            # gives up when the consumer abandons the generator, so the
            # producer never blocks forever holding ``depth`` batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in prev:
                    if not put(stage(b)):
                        return
            except BaseException as e:     # handed to the consumer
                while not stop.is_set():
                    try:
                        # drain a slot if the queue is full, so the error
                        # always gets through
                        q.put(e, timeout=0.1)
                        return
                    except queue.Full:
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            pass
                return
            put(end)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=1.0)
                except queue.Empty:
                    if t.is_alive():
                        continue
                    try:
                        # the producer's last item may have landed between
                        # the timeout and its exit
                        item = q.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            "PrefetchToDevice producer thread died "
                            "without reporting an error or end-of-stream"
                        ) from None
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                data, labels, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    data.record_stream(stream)
                    labels.record_stream(stream)
                yield MiniBatch(data, labels)
        finally:
            stop.set()     # the consumer is done: release the producer
