"""Host-side resilience helpers of the port: bounded retry and the fault
injector of the data feed's sites."""

from bigdl_tpu_torch.resilience.fault_injector import (Fault, FaultInjector,
                                                       InjectedFault)
from bigdl_tpu_torch.resilience.retry import (RETRIES, RETRYABLE_IO_ERRORS,
                                              retry)

__all__ = ["Fault", "FaultInjector", "InjectedFault", "RETRIES",
           "RETRYABLE_IO_ERRORS", "retry"]
