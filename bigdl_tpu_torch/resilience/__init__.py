"""Host-side resilience helpers of the port: bounded retry, the fault
injector of the trainer's, serving's and the data feed's sites and the step
watchdog."""

from bigdl_tpu_torch.resilience.fault_injector import (Fault, FaultInjector,
                                                       InjectedFault)
from bigdl_tpu_torch.resilience.retry import (RETRIES, RETRYABLE_IO_ERRORS,
                                              retry)
from bigdl_tpu_torch.resilience.watchdog import Watchdog, WatchdogTimeout

__all__ = ["Fault", "FaultInjector", "InjectedFault", "RETRIES",
           "RETRYABLE_IO_ERRORS", "Watchdog", "WatchdogTimeout", "retry"]
