"""Bounded retry with exponential backoff and jitter
(``bigdl_tpu/resilience/retry.py``, without the run-ledger records).

Only *transient* error types are retried (``retryable``); programming
errors propagate on their first occurrence.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, Tuple, Type

logger = logging.getLogger("bigdl_tpu_torch.resilience")

# the transient family: storage/network hiccups and timeouts
RETRYABLE_IO_ERRORS: Tuple[Type[BaseException], ...] = (OSError,
                                                        TimeoutError)


def retry(fn: Callable, *args,
          retries: int = 3,
          backoff: float = 0.1,
          max_backoff: float = 30.0,
          jitter: float = 0.5,
          retryable: Tuple[Type[BaseException], ...] = RETRYABLE_IO_ERRORS,
          label: Optional[str] = None,
          deadline: Optional[float] = None,
          **kwargs):
    """Call ``fn(*args, **kwargs)``; on a ``retryable`` exception sleep
    ``backoff * 2**attempt`` (+- ``jitter`` fraction, capped at
    ``max_backoff``) and try again, up to ``retries`` extra attempts.

    ``deadline`` is a TOTAL-time budget in seconds from this call's start:
    each backoff is clamped to what remains, and once it is spent the last
    exception is re-raised."""
    label = label or getattr(fn, "__name__", "call")
    start = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retryable as e:
            remaining = None if deadline is None else \
                deadline - (time.monotonic() - start)
            exhausted = remaining is not None and remaining <= 0
            if attempt >= retries or exhausted:
                logger.error("%s: giving up after %d attempts (%s)%s",
                             label, attempt + 1, e,
                             " — deadline exhausted" if exhausted else "")
                raise
            delay = min(backoff * (2 ** attempt), max_backoff)
            delay *= 1.0 + jitter * (2.0 * random.random() - 1.0)
            delay = max(delay, 0.0)
            if remaining is not None:
                delay = min(delay, remaining)
            logger.warning("%s failed (%s: %s); retry %d/%d in %.2fs",
                           label, type(e).__name__, e, attempt + 1,
                           retries, delay)
            time.sleep(delay)
            attempt += 1
