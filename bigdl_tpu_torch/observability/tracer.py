"""Structured tracing spans over the training stack's hot seams
(``bigdl_tpu/observability/tracer.py``).

``span(name, **attrs)`` is a nestable, thread-safe context manager: on
exit it appends ONE record to the run ledger carrying wall + monotonic
start, duration, attributes, and parent linkage (a per-thread stack), so
the offline reader can compute exclusive per-phase time and reconstruct
the step timeline.  With the ledger disabled it degrades to a bare
``yield`` behind a single ``is None`` test — instrumentation stays in
the code at ~zero cost.

Compilation is a first-class event.  The reference listens to XLA's
compiles through ``jax.monitoring``; the port has no XLA, and what makes
its first step slow is its own builds at first use: ``nvcc`` over the
CUDA kernels (``ops/_build.py``) and ``g++`` over the host helpers
(``native.py``).  Each build calls :func:`record_compile`, which lands
in the ledger as one ``compile`` record next to the spans it delayed.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Optional

from bigdl_tpu_torch.observability import ledger

_tls = threading.local()
_ids = itertools.count(1)


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
        _tls.ident = threading.get_ident()   # cached: one syscall/thread
    return s


def swap_remote_parent(value):
    """Set this thread's remote-parent slot (a ``(pid, span)`` tuple or
    None) and return the previous value.  While set, every TOP-LEVEL
    span opened on this thread records ``link``/``link_pid`` fields
    pointing at the remote span — a CAUSAL parent from another process
    or thread.  Links are deliberately NOT the ``parent`` field:
    containment parents stay per-thread so the report's exclusive-time
    subtraction never crosses a process/thread boundary, and
    ``trace-export`` renders links as Perfetto flow arrows instead.
    Swap-semantics (not set/clear) so :func:`bigdl_tpu_torch.observability.
    trace.attach` — the intended caller — nests correctly."""
    prev = getattr(_tls, "remote", None)
    _tls.remote = value
    return prev


def current_span() -> Optional[int]:
    """Id of the innermost open span on this thread (None at top level)."""
    s = _stack()
    return s[-1] if s else None


def reset_stack() -> None:
    """Clear this thread's span stack.  Called at run boundaries
    (``_run_start``): an exception that escaped a ``begin_span`` handle
    would otherwise leave a dead span id parenting every later span —
    silently demoting them from top-level and corrupting the report's
    coverage figure for the NEXT run in the same process."""
    _stack().clear()


@contextlib.contextmanager
def span(name: str, **attrs):
    """``with span("train.step", step=12): ...`` — yields the span id (or
    None when the ledger is off).  An exception inside the block is
    recorded (``error`` field) and re-raised; the duration is recorded
    either way — failed phases are exactly the ones worth attributing."""
    h = begin_span(name, **attrs)
    error = None
    try:
        yield h.sid
    except BaseException as e:
        error = type(e).__name__
        raise
    finally:
        h.end(error=error)


class SpanHandle:
    """Explicit begin/end span for seams where a ``with`` block would
    force a huge reindent (e.g. a trainer's whole setup section).  Joins
    the same per-thread stack as :func:`span`, so spans opened inside it
    nest correctly; ``end()`` is idempotent and pops any stragglers the
    block leaked."""

    __slots__ = ("_led", "name", "attrs", "sid", "_rec", "_t0", "_done",
                 "_excluded")

    def __init__(self, led, name: str, attrs: dict):
        self._led = led
        self.sid = next(_ids)
        stack = _stack()
        parent = stack[-1] if stack else None
        stack.append(self.sid)
        self._rec = {"type": "span", "name": name, "span": self.sid,
                     "thread": _tls.ident,
                     "ts": time.time(), "mono": time.monotonic()}
        if parent is not None:
            self._rec["parent"] = parent
        else:
            # a top-level span under an attached cross-boundary context
            # carries a causal link to the submitting span: this is what
            # stitches an ingest worker's (or a pool worker thread's)
            # per-pid ledger file back into one timeline
            remote = getattr(_tls, "remote", None)
            if remote is not None:
                self._rec["link"] = remote[1]
                self._rec["link_pid"] = remote[0]
        if attrs:
            self._rec["attrs"] = attrs
        self._t0 = time.perf_counter()
        self._done = False
        self._excluded = 0.0

    def set(self, **attrs) -> None:
        """Attach/overwrite attributes before ``end()`` — for counts
        only known once the work ran (e.g. records decoded from a
        chunk of files)."""
        if not self._done:
            self._rec.setdefault("attrs", {}).update(attrs)

    def link_to(self, pid, span) -> None:
        """Add an EXTRA causal link to another process's span, beyond
        the one the attached context already supplies.  The fleet's
        salvage path needs exactly this: a re-driven request's dispatch
        span links to the client submit (via the attached wire context)
        AND to the dead host's original claim — two causal parents, one
        execution.  Links accumulate in a ``links`` list of
        ``[pid, span]`` pairs; the exporter renders each as its own
        flow arrow."""
        if self._done or pid is None or span is None:
            return
        self._rec.setdefault("links", []).append([int(pid), int(span)])

    def exclude(self, seconds: float) -> None:
        """Deduct ``seconds`` from this span's duration at ``end()`` —
        for time measurably spent waiting on ANOTHER instrumented stage
        (e.g. the pack span pulls records through a generator that
        blocks on decode workers: that wait belongs to decode's spans,
        and double-billing it would misattribute the bound stage)."""
        self._excluded += max(0.0, float(seconds))

    def end(self, error: Optional[str] = None) -> None:
        if self._done:
            return
        self._done = True
        stack = _stack()
        if self.sid in stack:
            del stack[stack.index(self.sid):]
        self._rec["dur_s"] = max(
            0.0, time.perf_counter() - self._t0 - self._excluded)
        if error:
            self._rec["error"] = error
        self._led.emit(self._rec)


class _NullHandle:
    sid = None

    def set(self, **attrs) -> None:
        pass

    def link_to(self, pid, span) -> None:
        pass

    def exclude(self, seconds: float) -> None:
        pass

    def end(self, error: Optional[str] = None) -> None:
        pass


_NULL = _NullHandle()


def begin_span(name: str, **attrs):
    """Open a span now, close it with ``.end()`` later (possibly many
    statements away).  Returns a no-op handle when the ledger is off."""
    led = ledger.get_ledger()
    if led is None:
        return _NULL
    return SpanHandle(led, name, attrs)


# -- build records -------------------------------------------------------------

def record_compile(event: str, dur_s: float, **fields) -> None:
    """Ledger one ``compile`` record (``event``, ``dur_s``) under the span
    open on this thread, as the reference's ``jax.monitoring`` listener
    does for an XLA compile.  A no-op while the ledger is off."""
    if not ledger.enabled():
        return
    rec = {"event": event, "dur_s": float(dur_s)}
    rec.update(fields)
    parent = current_span()
    if parent is not None:
        rec["span"] = parent
    ledger.emit("compile", **rec)
