"""Batch-bucket ladder, device worker pool, continuous batching of
TransformerLM generation over a block-paged KV pool with multi-turn
sessions, and the device-memory budgeter."""

from bigdl_tpu_torch.serving.scheduler.buckets import (BucketLadder,
                                                       BucketedRunner,
                                                       pad_to_bucket)
from bigdl_tpu_torch.serving.scheduler.continuous import (ContinuousGenerator,
                                                          GenRequest,
                                                          SlotManager)
from bigdl_tpu_torch.serving.scheduler.membudget import MemoryBudgeter
from bigdl_tpu_torch.serving.scheduler.paging import (HostOffloadTier,
                                                      PageAllocator,
                                                      PrefixCache)
from bigdl_tpu_torch.serving.scheduler.pool import DeviceWorker, WorkerPool

__all__ = ["BucketLadder", "BucketedRunner", "ContinuousGenerator",
           "DeviceWorker", "GenRequest", "HostOffloadTier", "MemoryBudgeter",
           "PageAllocator", "PrefixCache", "SlotManager", "WorkerPool",
           "pad_to_bucket"]
