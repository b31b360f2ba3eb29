"""The run ledger — a durable, queryable event record for every training run
(``bigdl_tpu/observability/ledger.py``, kept line for line: the same
``BIGDL_TPU_RUN_DIR`` and ``BIGDL_TPU_TRACE_ID`` variables, the same
per-pid file names and the same strict-JSON records, so one run directory
reads the same through either package's report).

The reference surfaced training visibility through ``Metrics``
logs and TensorBoard summaries (BigDL paper §4); both evaporate with the
process.  The ledger keeps them: every span, per-step record, scalar and
resilience event is appended as one JSON line to a file under the run
directory, so a finished (or crashed) run can be reconstructed offline
(``python -m bigdl_tpu_torch.cli run-report <dir>``).

Design constraints, in order:

* **Non-blocking** — ``emit()`` appends to a bounded in-memory queue and
  returns; a daemon thread drains it to disk.  When the queue is full the
  OLDEST records are dropped (and counted) rather than ever stalling a
  training step on storage.
* **Crash-safe** — each record is written as one fully-formed
  ``json.dumps(rec) + "\\n"`` string, so a crash can at worst truncate the
  final line; every complete line is valid JSON (line-atomic appends).
  ``flush()`` drains synchronously — the resilience paths (watchdog fire,
  retry give-up) call it so the diagnostic survives a hard exit.
* **Zero cost when off** — with no run directory configured,
  ``get_ledger()`` is one global read returning ``None`` and every
  instrumentation site is a single ``is None`` test.

Activation: set ``BIGDL_TPU_RUN_DIR=/path/to/run`` in the environment
(checked once, lazily), or call :func:`set_run_dir` programmatically.
Each process writes its own ``events-<pid>.jsonl`` file, so a multi-host
run pointed at a shared directory never interleaves writers; the reader
merges by timestamp.

This module is dependency-free (stdlib only) on purpose: the resilience
layer emits into it from failure paths where importing torch could itself
be the broken thing.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import threading
import time
from typing import Any, Dict, Optional

_FLUSH_INTERVAL_S = 0.25

# run-scoped trace id, shared by every process of a run: the first
# process to ask mints one and PUBLISHES it into its own environment, so
# spawned children (ingest workers, drill subprocesses) inherit the same
# id for free — the cross-process half of trace stitching
_TRACE_ENV = "BIGDL_TPU_TRACE_ID"
_trace_lock = threading.Lock()


def trace_id() -> str:
    """This run's trace id (16 hex chars).  Stable for the process
    lifetime and inherited by child processes via the environment."""
    tid = os.environ.get(_TRACE_ENV, "")
    if tid:
        return tid
    with _trace_lock:
        tid = os.environ.get(_TRACE_ENV, "")
        if not tid:
            import uuid
            tid = uuid.uuid4().hex[:16]
            os.environ[_TRACE_ENV] = tid
    return tid


def adopt_trace(tid: Optional[str]) -> None:
    """Adopt a trace id minted ELSEWHERE — the fleet half of trace
    stitching.  Environment inheritance only reaches spawned children;
    fleet hosts are peer processes on (conceptually) different machines,
    so the gen-1 leader mints the id, commits it in the generation
    payload, and every host adopts it from the committed record here.

    Adopting before any ledger exists simply pre-seeds the environment
    (the first ``trace.bind`` then carries the fleet id); adopting after
    a ledger already bound a different id appends a ``trace.bind`` with
    ``rebind``/``prev`` fields and flushes, so the reader can still
    place every record of the file.  Idempotent; never *creates* a
    ledger."""
    if not tid:
        return
    tid = str(tid)
    with _trace_lock:
        prev = os.environ.get(_TRACE_ENV, "")
        if prev == tid:
            return
        os.environ[_TRACE_ENV] = tid
    led = _active
    if led is not None and prev:
        try:
            led.emit({"type": "trace.bind", "trace": tid,
                      "pid": os.getpid(), "rebind": True, "prev": prev})
            led.flush()
        except Exception:
            pass


class RunLedger:
    """Buffered JSONL sink for one process's share of a run directory."""

    def __init__(self, run_dir: str, capacity: int = 8192):
        self.dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, f"events-{os.getpid()}.jsonl")
        self._capacity = capacity
        self._q: collections.deque = collections.deque()
        self._dropped = 0
        self._lock = threading.Lock()       # queue state
        self._wlock = threading.Lock()      # file writes (take+write)
        self._wake = threading.Event()
        self._closed = False
        self._io_error: Optional[str] = None
        # append mode: a relaunched pid colliding with an old file (rare)
        # extends it rather than truncating history
        self._f = open(self.path, "a", encoding="utf-8")
        self._writer = threading.Thread(target=self._drain_loop,
                                        name="bigdl-torch-ledger",
                                        daemon=True)
        self._writer.start()
        # every ledger closes at exit (close() is idempotent) so the
        # final partial batch and the ledger.dropped accounting record
        # reach disk however the ledger was activated
        atexit.register(self.close)
        # first record of every per-pid file: which trace this process
        # belongs to — the reader stitches files on it.  Flushed
        # immediately: drop-oldest overflow would otherwise sacrifice
        # exactly this record first, and a file without its bind is a
        # process the stitcher cannot place.
        self.emit({"type": "trace.bind", "trace": trace_id(),
                   "pid": os.getpid()})
        self.flush()

    # -- producer side ------------------------------------------------------

    def emit(self, rec: Dict[str, Any]) -> None:
        """Queue one record (non-blocking).  ``ts`` (wall) and ``mono``
        (monotonic, for robust ordering/durations) are stamped here unless
        the caller already did."""
        if self._closed:
            return
        rec.setdefault("ts", time.time())
        rec.setdefault("mono", time.monotonic())
        with self._lock:
            if len(self._q) >= self._capacity:
                self._q.popleft()
                self._dropped += 1
            self._q.append(rec)
            backlog = len(self._q)
        # wake the writer only on real backlog; otherwise let it batch on
        # its poll interval — waking per record costs a context switch on
        # the training thread's critical path
        if backlog >= 512:
            self._wake.set()

    # -- writer side --------------------------------------------------------

    def _take_batch(self):
        with self._lock:
            batch = list(self._q)
            self._q.clear()
        return batch

    def _write_batch(self, batch) -> None:
        if not batch:
            return
        lines = []
        for rec in batch:
            try:
                # allow_nan=False: every written line is STRICT JSON (a
                # NaN loss must not poison the file for non-Python
                # parsers); the rare unserializable record is replaced,
                # not dropped, so the count stays honest
                lines.append(json.dumps(rec, default=str, allow_nan=False,
                                        separators=(",", ":")) + "\n")
            except (TypeError, ValueError):
                lines.append(json.dumps(
                    {"type": "ledger.unserializable",
                     "orig_type": str(rec.get("type")),
                     "ts": rec.get("ts")}) + "\n")
        try:
            # composed fully before the write so a crash can only
            # truncate the final line, never interleave
            self._f.write("".join(lines))
            self._f.flush()
        except OSError as e:
            # a dead disk must not take the training run with it; record
            # the first error and go dark
            if self._io_error is None:
                self._io_error = f"{type(e).__name__}: {e}"

    def _drain_loop(self) -> None:
        while not self._closed:
            self._wake.wait(timeout=_FLUSH_INTERVAL_S)
            self._wake.clear()
            with self._wlock:
                self._write_batch(self._take_batch())

    def flush(self) -> None:
        """Synchronously drain the queue to disk (call before a hard exit
        or before reading the file back).  The write lock spans take +
        write on both paths, so flush() returning means every record
        emitted before the call is on disk — including a batch the drain
        thread had already taken but not yet finished writing."""
        with self._wlock:
            self._write_batch(self._take_batch())

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._wake.set()
        self._writer.join(timeout=2.0)
        # under the queue lock: the bounded join above can return with
        # the writer still alive (wedged disk), and an unguarded append
        # would race its _take_batch() — list(q)/q.clear() under the
        # lock, this append between them — losing the accounting record
        with self._lock:
            if self._dropped:
                self._q.append({"type": "ledger.dropped",
                                "count": self._dropped,
                                "ts": time.time(),
                                "mono": time.monotonic()})
        self.flush()
        try:
            self._f.close()
        except OSError:
            pass


# -- process-wide active ledger ----------------------------------------------

_active: Optional[RunLedger] = None
_env_checked = False
_state_lock = threading.Lock()


def get_ledger() -> Optional[RunLedger]:
    """The active ledger, or ``None`` when disabled.  First call checks
    ``BIGDL_TPU_RUN_DIR`` unless :func:`set_run_dir` already ran."""
    global _active, _env_checked
    if _active is not None or _env_checked:
        return _active
    with _state_lock:
        if not _env_checked:
            run_dir = os.environ.get("BIGDL_TPU_RUN_DIR", "")
            if run_dir:
                _active = RunLedger(run_dir)
            _env_checked = True
    return _active


def set_run_dir(run_dir: Optional[str]) -> Optional[RunLedger]:
    """Programmatically enable (or, with ``None``, disable) the ledger.
    Replaces any active ledger, closing the old one.  Wins over the
    environment variable."""
    global _active, _env_checked
    # swap under the lock, close OUTSIDE it: close() joins the writer
    # thread (bounded 2s) and flushes to disk — holding _state_lock
    # through that would stall every first-call get_ledger() behind
    # one caller's drain.  close() is idempotent and the old ledger is
    # already unpublished, so late emits go to the new one.
    with _state_lock:
        old = _active
        _active = RunLedger(run_dir) if run_dir else None
        _env_checked = True
        new = _active
    if old is not None:
        old.close()
    return new


def enabled() -> bool:
    return get_ledger() is not None


def emit(type_: str, **fields) -> None:
    """Emit one record when the ledger is active; no-op (one global read)
    otherwise."""
    led = get_ledger()
    if led is not None:
        rec = {"type": type_}
        rec.update(fields)
        led.emit(rec)


def flush() -> None:
    led = get_ledger()
    if led is not None:
        led.flush()


def emit_critical(type_: str, flush_after: bool = True, **fields) -> None:
    """Emit + synchronously flush, swallowing every error — the one
    pattern for crash paths (watchdog fire, retry give-up, injected
    faults): the diagnostic must hit disk before a possible hard exit,
    and observability must never mask the real failure."""
    try:
        emit(type_, **fields)
        if flush_after:
            flush()
    except Exception:
        pass
