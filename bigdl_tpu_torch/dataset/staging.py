"""The staging ring, the copy-to-device half of the sharded feed
(``bigdl_tpu/dataset/staging.py``).

``StagingRing`` turns a MiniBatch stream into a device-resident one through
``depth`` host slots (``prefetch._PinnedRing``: pinned on the card, sized
by the first batch) and two threads:

* the **stager** copies each batch into the next free slot, casting its
  data to ``dtype`` there, on the host (bf16 halves the bytes on the link);
* the **uploader** copies a staged slot to the card on a side CUDA stream,
  records an event and hands the slot back; the stager refills a slot only
  after its copy's event has completed.

So the cast of batch k+2, the copy of batch k+1 and the step on batch k
overlap, and the ring bounds what is in flight: with every slot staged or
in flight the stager blocks, and so does the upstream iterator.  The
consumer's stream waits on each copy's event and the tensors are marked
with ``record_stream`` for it.  On ``device="cpu"`` the uploader copies the
rows out of the slot before handing it back, so a refill never shows
through a batch already yielded.

Failures reach the consumer's ``next()`` as themselves (an upstream
``IngestWorkerDied`` included); a thread that dies without reporting
cannot leave the consumer blocked (bounded waits and liveness checks); an
abandoned consumer releases both threads.  The stager checks the
``ingest.stage`` fault site before each batch.  Each slot's fill runs
under an ``ingest.stage`` span and each copy under ``ingest.h2d``; on the
card the latter spans the enqueue of the copy and its event, not the
transfer itself.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.dataset import ingest_config
from bigdl_tpu_torch.dataset.prefetch import _END, _feed, _PinnedRing, _Pipe
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.observability import tracer
from bigdl_tpu_torch.resilience.fault_injector import FaultInjector


class StagingRing(Transformer):
    """MiniBatch stream -> MiniBatches of tensors on ``device`` (CUDA by
    default; it raises without CUDA unless asked for the CPU) through a
    ring of ``depth`` host slots.  ``dtype`` casts batch DATA on the host
    (labels keep theirs); ``depth`` and ``dtype`` default from
    ``BIGDL_TPU_INGEST_DEPTH`` (2) and ``BIGDL_TPU_INGEST_DTYPE``.  A short
    last batch goes through a view of its slot; a batch with more rows
    than the first raises."""

    def __init__(self, depth: Optional[int] = None, dtype=None,
                 device="cuda"):
        self.depth = ingest_config.depth(depth)
        self.dtype = ingest_config.pack_dtype(dtype)
        self.device = resolve_device(device)

    def apply(self, prev):
        ring = _PinnedRing(self.depth, self.dtype, self.device)
        stop = threading.Event()
        free = _Pipe(stop)              # slot indices the stager may fill
        for i in range(self.depth):
            free.put(i)
        staged, ready = _Pipe(stop, self.depth), _Pipe(stop, self.depth)

        def stager():
            try:
                first = None
                for b in prev:
                    FaultInjector.fire("ingest.stage")
                    if not hasattr(b, "labels"):
                        raise TypeError(
                            "StagingRing expects a MiniBatch stream, got "
                            f"{type(b).__name__}: put a batcher before it "
                            "(ShardedDataSet(batcher=..., staging=True))")
                    shapes = (np.shape(b.data), np.shape(b.labels))
                    if first is None:
                        first = shapes
                    elif not _PinnedRing.fits(first, shapes):
                        raise ValueError(
                            f"batch of {tuple(shapes[0])} exceeds the "
                            f"staging ring's slot capacity {tuple(first[0])} "
                            "(the first batch sizes the ring; keep batch "
                            "sizes non-increasing or drop_last)")
                    i = free.get()
                    if i is None:
                        return
                    with tracer.span("ingest.stage", records=b.size()):
                        item = ring.stage(b, i)
                    if not staged.put(item):
                        return
                staged.put(_END)
            except BaseException as e:
                staged.fail(e)

        def uploader():
            try:
                while True:
                    item = staged.get()
                    if item is None:
                        return
                    if item is _END or isinstance(item, BaseException):
                        ready.put(item)
                        return
                    with tracer.span("ingest.h2d", records=int(item[1])):
                        out = ring.upload(*item)
                    free.put(item[0])
                    if not ready.put(out):
                        return
            except BaseException as e:
                ready.fail(e)

        yield from _feed(
            [threading.Thread(target=stager, daemon=True,
                              name="bigdl-ingest-stager"),
             threading.Thread(target=uploader, daemon=True,
                              name="bigdl-ingest-uploader")],
            ready, self.device, "StagingRing pipeline")
