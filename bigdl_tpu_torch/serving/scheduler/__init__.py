"""Batch-bucket ladder and device worker pool of the serving runtime."""

from bigdl_tpu_torch.serving.scheduler.buckets import (BucketLadder,
                                                       BucketedRunner,
                                                       pad_to_bucket)
from bigdl_tpu_torch.serving.scheduler.pool import DeviceWorker, WorkerPool

__all__ = ["BucketLadder", "BucketedRunner", "DeviceWorker", "WorkerPool",
           "pad_to_bucket"]
