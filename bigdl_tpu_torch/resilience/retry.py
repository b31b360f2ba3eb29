"""Bounded retry with exponential backoff and jitter
(``bigdl_tpu/resilience/retry.py``).

Only *transient* error types are retried (``retryable``); programming
errors propagate on their first occurrence.  ``RETRIES`` counts the
retries taken, by label; the run ledger gets a ``retry`` event a retry
and a flushed ``retry.giveup`` event when the retries run out.
"""

from __future__ import annotations

import collections
import logging
import random
import time
from typing import Callable, Optional, Tuple, Type

from bigdl_tpu_torch.observability import ledger as run_ledger

logger = logging.getLogger("bigdl_tpu_torch.resilience")

# the transient family: storage/network hiccups and timeouts
RETRYABLE_IO_ERRORS: Tuple[Type[BaseException], ...] = (OSError,
                                                        TimeoutError)

# retries taken in this process, by label
RETRIES: "collections.Counter[str]" = collections.Counter()


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
                # the give-up flushes: the raise may be the process's
                # last act
                run_ledger.emit_critical(
                    "event", kind="retry.giveup", label=label,
                    attempt=attempt + 1, exc=type(e).__name__,
                    **({"deadline_exhausted": True} if exhausted else {}))
                raise
            delay = min(backoff * (2 ** attempt), max_backoff)
            delay *= 1.0 + jitter * (2.0 * random.random() - 1.0)
            delay = max(delay, 0.0)
            if remaining is not None:
                delay = min(delay, remaining)
            logger.warning("%s failed (%s: %s); retry %d/%d in %.2fs",
                           label, type(e).__name__, e, attempt + 1,
                           retries, delay)
            RETRIES[label] += 1
            run_ledger.emit_critical(
                "event", kind="retry", label=label, attempt=attempt + 1,
                exc=type(e).__name__, flush_after=False)
            time.sleep(delay)
            attempt += 1
