"""Batch-bucket ladder, device worker pool, and continuous batching of
TransformerLM generation over a block-paged KV pool."""

from bigdl_tpu_torch.serving.scheduler.buckets import (BucketLadder,
                                                       BucketedRunner,
                                                       pad_to_bucket)
from bigdl_tpu_torch.serving.scheduler.continuous import (ContinuousGenerator,
                                                          GenRequest,
                                                          SlotManager)
from bigdl_tpu_torch.serving.scheduler.paging import (PageAllocator,
                                                      PrefixCache)
from bigdl_tpu_torch.serving.scheduler.pool import DeviceWorker, WorkerPool

__all__ = ["BucketLadder", "BucketedRunner", "ContinuousGenerator",
           "DeviceWorker", "GenRequest", "PageAllocator", "PrefixCache",
           "SlotManager", "WorkerPool", "pad_to_bucket"]
