"""Online serving of a ``DLClassifier`` (admission queue, deadline batcher,
bucket ladder, worker pool with per-worker breakers, typed errors) and of
a ``TransformerLM`` (``ContinuousGenerator``: continuous batching over a
block-paged KV pool with a prefix cache, multi-turn sessions parked to host
RAM, and a ``MemoryBudgeter`` of device bytes).

The deterministic chaos drill over the pool's fault sites is
``python -m bigdl_tpu_torch.cli serve-drill`` (:mod:`serving.drill`); the
scheduler benchmark is ``bench-serve`` (:mod:`serving.bench_serve`).  The
multi-tenant fleet (several models behind one admission plane, stride
dispatch, the autoscaler) is :mod:`serving.fleet`."""

from bigdl_tpu_torch.serving.batcher import DeadlineBatcher
from bigdl_tpu_torch.serving.breaker import CircuitBreaker
from bigdl_tpu_torch.serving.errors import (BreakerOpenError,
                                            DeadlineExceededError,
                                            DeadlineUnmeetableError,
                                            DrainingError,
                                            ForwardFailedError,
                                            InvalidRequestError,
                                            MemoryBudgetError,
                                            PackFailedError, QueueFullError,
                                            ServingError, ShedError,
                                            SlotCapacityError,
                                            UnknownTenantError)
from bigdl_tpu_torch.serving.queue import AdmissionQueue, Request
from bigdl_tpu_torch.serving.scheduler import (BucketedRunner, BucketLadder,
                                               ContinuousGenerator,
                                               HostOffloadTier,
                                               MemoryBudgeter, PageAllocator,
                                               PrefixCache, SlotManager,
                                               WorkerPool, pad_to_bucket)
from bigdl_tpu_torch.serving.server import InferenceServer

__all__ = ["AdmissionQueue", "BreakerOpenError", "BucketLadder",
           "BucketedRunner", "CircuitBreaker", "ContinuousGenerator",
           "DeadlineBatcher", "DeadlineExceededError",
           "DeadlineUnmeetableError", "DrainingError", "ForwardFailedError",
           "HostOffloadTier", "InferenceServer", "InvalidRequestError",
           "MemoryBudgetError", "MemoryBudgeter", "PackFailedError",
           "PageAllocator", "PrefixCache", "QueueFullError", "Request",
           "ServingError", "ShedError", "SlotCapacityError", "SlotManager",
           "UnknownTenantError", "WorkerPool", "pad_to_bucket"]
