"""Host-side step watchdog — fail fast instead of deadlocking the pod
(``bigdl_tpu/resilience/watchdog.py``).  In the port the guarded section
is the trainer's step up to its one host sync, ``float(loss)``.

A hung collective is the worst SPMD failure mode: one wedged host blocks
every other host's next all-reduce forever, silently burning the whole
pod.  The reference never had this problem — Spark's task timeout killed
and rescheduled the straggler (``DistriOptimizer.scala:244-272``).  The
answer here is a host-side timer armed around each blocking
section (the host sync on the step result): if the section overruns, the
watchdog dumps every thread's stack (the diagnostic Spark's UI gave for
free), interrupts the main thread, and the trainer surfaces a
:class:`WatchdogTimeout` — turning an invisible deadlock into a loud,
attributable crash that the relauncher + auto-resume can recover from.

``BIGDL_TPU_WATCHDOG_HARD=1`` additionally hard-exits the process after
a grace period, for runtimes whose blocked C calls never observe the
interrupt.

``Watchdog.pause(label)`` suspends every armed watchdog for the
duration of a *legitimate* long stall — an elastic membership reshape
tears down and rebuilds the mesh, reshards a checkpoint and recompiles,
none of which is a hung step — and REARMS them with a fresh, full
timeout on exit, emitting a ``watchdog.paused`` ledger event so the
pause is auditable: the timeout budget never bills a membership
transition as a wedged collective, and a watchdog that would have fired
mid-teardown (racing buffers that are being replaced) cannot.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import sys
import threading
import time
import weakref
from typing import Callable, Optional

from bigdl_tpu_torch.observability import ledger as run_ledger

logger = logging.getLogger("bigdl_tpu_torch.resilience")

_HARD_EXIT_GRACE_S = 10.0
_HARD_EXIT_CODE = 43

# pause/rearm registry: every armed Watchdog registers here so
# Watchdog.pause() can suspend the fleet of timers and rearm them fresh
_pause_lock = threading.Lock()
_pause_depth = 0
_active: "weakref.WeakSet[Watchdog]" = weakref.WeakSet()


class _WatchdogPause:
    """Context manager returned by :meth:`Watchdog.pause`."""

    def __init__(self, label: str):
        self.label = label
        self._t0 = 0.0

    def __enter__(self) -> "_WatchdogPause":
        global _pause_depth
        self._t0 = time.monotonic()
        with _pause_lock:
            _pause_depth += 1
            for w in list(_active):
                w._suspend()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        global _pause_depth
        with _pause_lock:
            _pause_depth -= 1
            resume = _pause_depth == 0
            if resume:
                for w in list(_active):
                    w._rearm()
        dur = time.monotonic() - self._t0
        run_ledger.emit("event", kind="watchdog.paused", label=self.label,
                        dur_s=dur)
        logger.info("watchdog paused %.2fs for %s (timers rearmed fresh)",
                    dur, self.label)
        return False


class WatchdogTimeout(RuntimeError):
    """The guarded section exceeded the watchdog timeout."""


class Watchdog:
    """Context manager: ``with Watchdog(30, label="step 12"): <block>``.

    If the block runs past ``timeout`` seconds the watchdog logs a
    diagnostic (label + all-thread stack dump to stderr), then either
    calls ``on_timeout`` (tests / custom policies) or interrupts the
    main thread, which ``__exit__`` converts into a
    :class:`WatchdogTimeout`.  A ``timeout`` of ``None``/``<= 0``
    disarms (zero overhead beyond one comparison).
    """

    def __init__(self, timeout: Optional[float], label: str = "step",
                 on_timeout: Optional[Callable[[], None]] = None):
        self.timeout = timeout
        self.label = label
        self.on_timeout = on_timeout
        self.fired = False
        self._timer: Optional[threading.Timer] = None

    @classmethod
    def pause(cls, label: str = "reshape") -> "_WatchdogPause":
        """Suspend every armed watchdog for a legitimate long stall
        (an elastic reshape window); on exit each is REARMED with a
        fresh, full timeout and a ``watchdog.paused`` event records the
        pause so the stall is attributable.  Re-entrant (nested pauses
        rearm once, at the outermost exit)."""
        return _WatchdogPause(label)

    def _suspend(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _rearm(self) -> None:
        if self.fired or not (self.timeout and self.timeout > 0):
            return
        self._timer = threading.Timer(self.timeout, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def _fire(self):
        with _pause_lock:
            if _pause_depth > 0 or self not in _active:
                # the timer went off as a pause began (or as __exit__
                # retired this watchdog): do not fire — the pause exit
                # rearms a fresh timer.  The fire DECISION is atomic
                # with the pause/exit state; a pause that begins after
                # this point raced a genuine pre-pause overrun, which
                # fires as the timeout it was.
                self._timer = None
                return
            self.fired = True
        logger.error(
            "WATCHDOG: %s exceeded %.1fs — a hung step/collective; "
            "dumping all thread stacks and failing fast",
            self.label, self.timeout)
        try:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except Exception:       # diagnostics must never mask the timeout
            pass
        if self.on_timeout is not None:
            run_ledger.emit_critical("event", kind="watchdog.timeout",
                                     label=self.label,
                                     timeout_s=self.timeout)
            self.on_timeout()
            return
        import _thread
        _thread.interrupt_main()
        if os.environ.get("BIGDL_TPU_WATCHDOG_HARD", "0") == "1":
            # the interrupt only lands when the main thread re-enters the
            # interpreter; a truly wedged runtime never does — give it a
            # grace period then kill the process so the pod's relauncher
            # takes over
            killer = threading.Timer(
                _HARD_EXIT_GRACE_S,
                lambda: os._exit(_HARD_EXIT_CODE))
            killer.daemon = True
            killer.start()
        # ledger LAST: the run directory often shares the filesystem
        # whose hang triggered the watchdog — a blocking write here must
        # not stop the interrupt/hard-exit from going out (this timer
        # thread may then wedge on the flush, but it is a daemon and the
        # fail-fast has already been dispatched)
        run_ledger.emit_critical("event", kind="watchdog.timeout",
                                 label=self.label, timeout_s=self.timeout)

    def __enter__(self) -> "Watchdog":
        if self.timeout and self.timeout > 0:
            with _pause_lock:
                _active.add(self)
                if _pause_depth == 0:
                    self._timer = threading.Timer(self.timeout, self._fire)
                    self._timer.daemon = True
                    self._timer.start()
                # armed under an active pause: the timer starts at rearm
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        with _pause_lock:
            _active.discard(self)
            if self._timer is not None:
                self._timer.cancel()
        if not self.fired or self.on_timeout is not None:
            return False
        if exc_type is not KeyboardInterrupt:
            # raced: the timer fired right as the block finished (or as a
            # different exception unwound), so the interrupt is — or is
            # about to be — pending against the main thread and would
            # otherwise detonate at an arbitrary later bytecode (e.g.
            # mid-checkpoint).  Absorb it here; the overrun itself is
            # still reported as the timeout it was.
            try:
                deadline = time.monotonic() + 2.0
                while time.monotonic() < deadline:
                    time.sleep(0.01)
            except KeyboardInterrupt:
                pass
        raise WatchdogTimeout(
            f"{self.label} exceeded the {self.timeout:.1f}s watchdog "
            "timeout (hung step or collective; thread stacks were "
            "dumped to stderr)") from (
                exc if exc_type not in (None, KeyboardInterrupt) else None)
