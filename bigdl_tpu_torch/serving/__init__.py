"""Online serving of a ``DLClassifier`` (admission queue, deadline batcher,
bucket ladder, worker pool with per-worker breakers, typed errors) and of
a ``TransformerLM`` (``ContinuousGenerator``: continuous batching over a
block-paged KV pool with a prefix cache)."""

from bigdl_tpu_torch.serving.batcher import DeadlineBatcher
from bigdl_tpu_torch.serving.breaker import CircuitBreaker
from bigdl_tpu_torch.serving.errors import (BreakerOpenError,
                                            DeadlineExceededError,
                                            DeadlineUnmeetableError,
                                            DrainingError,
                                            ForwardFailedError,
                                            InvalidRequestError,
                                            PackFailedError, QueueFullError,
                                            ServingError, ShedError,
                                            SlotCapacityError)
from bigdl_tpu_torch.serving.queue import AdmissionQueue, Request
from bigdl_tpu_torch.serving.scheduler import (ContinuousGenerator,
                                               PageAllocator, PrefixCache)
from bigdl_tpu_torch.serving.server import InferenceServer

__all__ = ["AdmissionQueue", "BreakerOpenError", "CircuitBreaker",
           "ContinuousGenerator", "DeadlineBatcher", "DeadlineExceededError",
           "DeadlineUnmeetableError", "DrainingError", "ForwardFailedError",
           "InferenceServer", "InvalidRequestError", "PackFailedError",
           "PageAllocator", "PrefixCache", "QueueFullError", "Request",
           "ServingError", "ShedError", "SlotCapacityError"]
