"""Host-side resilience helpers of the port."""

from bigdl_tpu_torch.resilience.retry import RETRYABLE_IO_ERRORS, retry

__all__ = ["RETRYABLE_IO_ERRORS", "retry"]
