"""Profiling / tracing utilities (``bigdl_tpu/utils/profiler.py``).

Parity: SURVEY.md §5.1 — the reference has three tracing tiers:
per-module wall timers, kernel timers (``DenseTensorBLAS.time``), and
per-iteration Metrics.  The port's mapping:

* kernel-level view      -> ``torch.profiler``: ``trace(logdir)`` /
                            ``start_trace``/``stop_trace`` record the host
                            and, on a CUDA device, the kernels (CUPTI),
                            and write a Chrome trace into ``logdir``
                            (load it at https://ui.perfetto.dev)
* named regions          -> ``annotate(name)``
                            (``torch.profiler.record_function``)
* per-iteration metrics  -> ``StepTimer`` feeding ``optim.Metrics`` under
                            the reference's metric names

A step's launches are asynchronous, so "computing time" per step is host
wall time around a blocking host read (``.item()``), the same measurement
the reference makes around ``jax.device_get``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

_lock = threading.Lock()
_active = None          # (profiler, logdir) of the open start_trace


def start_trace(logdir: str, device="cuda") -> None:
    """Start recording a profiler trace for :func:`stop_trace` to write
    into ``logdir``.  CUDA activity is recorded when ``device`` is a CUDA
    device (the default), the host's alone otherwise."""
    global _active
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with _lock:
        if _active is not None:
            raise RuntimeError("a profiler trace is already being recorded")
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        _active = (prof, logdir)


def stop_trace() -> str:
    """Stop the trace :func:`start_trace` opened and write it as
    ``<logdir>/trace-<pid>-<ns>.json``; returns the path."""
    global _active
    with _lock:
        if _active is None:
            raise RuntimeError("no profiler trace is being recorded")
        prof, logdir = _active
        _active = None
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Capture a profiler trace of the block into ``logdir``."""
    start_trace(logdir, device=device)
    try:
        yield
    finally:
        stop_trace()


def annotate(name: str):
    """Named region that shows up on the profiler timeline
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates per-phase wall times into a Metrics object under the
    reference's names (``optim/DistriOptimizer.scala:115-119,148-151,
    180-182,214``).  Use as::

        with timer.phase("computing time for each node"):
            loss = float(step(...))      # must block (a host read)
    """

    def __init__(self, metrics, parallel: int = 1):
        self.metrics = metrics
        self.parallel = parallel

    @contextlib.contextmanager
    def phase(self, name: str):
        # try/finally: a step that RAISES still gets its time attributed
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.metrics.add(name, time.perf_counter_ns() - t0)

    def block_and_time(self, name: str, value: torch.Tensor):
        """Block on a device tensor, attributing the wait to ``name``;
        returns the host value (a Python number for one element, a numpy
        array otherwise)."""
        with self.phase(name):
            host = value.item() if value.numel() == 1 \
                else value.cpu().numpy()
        return host
