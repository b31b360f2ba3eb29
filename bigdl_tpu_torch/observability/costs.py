"""Device cost & memory attribution (``bigdl_tpu/observability/costs.py``).

Two record kinds, as in the reference:

* ``cost.analysis`` — one per (label, input signature): the FLOPs of the
  labelled work.  The reference asks XLA's cost model through an extra
  AOT compile; the port has no XLA, so it counts with
  ``torch.utils.flop_counter.FlopCounterMode`` around the caller's REAL
  first call of that signature (:func:`cost_probe` opens the counter,
  :func:`emit_cost` ledgers what it saw).  No extra step is run: an extra
  training step would move the weights.  The counter sees ATen's ops
  only: the work of the port's hand-written kernels (pooling, LRN,
  attention, the quantized products) is not in the count.
  ``bytes_accessed`` and ``output_bytes`` have no counterpart and stay 0,
  as ``_normalize`` leaves them in the reference when XLA gives none, so
  the intensity is 0 too.
* ``mem.hbm`` — per-step high-watermark sampling of the run's own CUDA
  device (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``
  and ``.peak``, the device's total memory as the limit).  A CPU device
  reports nothing, as a backend without ``memory_stats`` does in the
  reference.

``BIGDL_TPU_COSTS=0`` turns the cost records off, and
``BIGDL_TPU_HBM_EVERY`` sets the sampling period (default 16 steps), as
in the reference.  Nothing here raises into the caller's run.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

from bigdl_tpu_torch.observability import ledger

_lock = threading.Lock()
_emitted: set = set()


def costs_enabled() -> bool:
    """Cost records are on iff the ledger is on and ``BIGDL_TPU_COSTS``
    is not ``0``."""
    return ledger.enabled() and \
        os.environ.get("BIGDL_TPU_COSTS", "1") != "0"


def _leaves(obj):
    if isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _leaves(o)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _leaves(obj[k])
    else:
        yield obj


def _signature(args) -> str:
    """Shape/dtype fingerprint of a call — one ``cost.analysis`` per
    (label, signature), so a second epoch (same shapes) is free but a new
    shape records again."""
    return repr([(tuple(getattr(a, "shape", ())) or None,
                  str(getattr(a, "dtype", type(a).__name__)))
                 for a in _leaves(args)])


class CostProbe:
    """A FLOP counter around one real call: ``with probe: out = f(x)``,
    then :func:`emit_cost` ledgers it."""

    def __init__(self, key, label: str):
        from torch.utils.flop_counter import FlopCounterMode
        self.key = key
        self.label = label
        self._mode = FlopCounterMode(display=False)

    def __enter__(self) -> "CostProbe":
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._mode.__exit__(*exc)
        return False

    @property
    def flops(self) -> float:
        return float(self._mode.get_total_flops())


def cost_probe(label: str, *args) -> Optional[CostProbe]:
    """A :class:`CostProbe` for the first call of ``label`` with inputs of
    ``args``' shapes in this run directory, or None when costs are off or
    that (label, signature) already recorded."""
    try:
        if not costs_enabled():
            return None
        led = ledger.get_ledger()
        key = (led.dir if led is not None else None, label,
               _signature(args))
        with _lock:
            if key in _emitted:
                return None
        return CostProbe(key, label)
    except Exception:
        return None


def emit_cost(probe: Optional[CostProbe],
              **extra) -> Optional[Dict[str, float]]:
    """Ledger the ``cost.analysis`` record of a probe that ran (extra
    keyword fields ride along).  None, and no record, for a None probe or
    a (label, signature) another probe recorded first."""
    if probe is None:
        return None
    try:
        with _lock:
            if probe.key in _emitted:
                return None
            _emitted.add(probe.key)
        res = {"flops": probe.flops, "bytes_accessed": 0.0,
               "output_bytes": 0.0, "intensity_flops_per_byte": 0.0}
        ledger.emit("cost.analysis", label=probe.label, **res, **extra)
        return res
    except Exception:
        return None


# -- device memory high-watermark sampling -------------------------------------

def hbm_stats(device) -> Optional[List[Dict[str, Any]]]:
    """The memory stats of ``device`` as a one-entry list, or None for a
    device that is not a CUDA one (or a CUDA that is not initialised)."""
    try:
        import torch
        dev = torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_initialized():
            return None
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        ms = torch.cuda.memory_stats(idx)
        in_use = int(ms.get("allocated_bytes.all.current", 0))
        return [{"device": idx, "bytes_in_use": in_use,
                 "peak_bytes_in_use":
                     int(ms.get("allocated_bytes.all.peak", in_use)),
                 "bytes_limit":
                     int(torch.cuda.get_device_properties(idx)
                         .total_memory)}]
    except Exception:
        return None


def hbm_sample_every() -> int:
    try:
        return max(1, int(os.environ.get("BIGDL_TPU_HBM_EVERY", "16")))
    except ValueError:
        return 16


def sample_hbm(device, step: Optional[int] = None,
               force: bool = False) -> None:
    """Ledger a ``mem.hbm`` record (in-use and peak bytes of ``device``)
    every ``BIGDL_TPU_HBM_EVERY`` steps (default 16).  Free when the
    ledger is off or the device is not a CUDA one."""
    if not ledger.enabled():
        return
    if not force and step is not None and step % hbm_sample_every() != 0:
        return
    st = hbm_stats(device)
    if not st:
        return
    ledger.emit("mem.hbm", step=step, devices=st,
                peak_bytes=max(d["peak_bytes_in_use"] for d in st),
                bytes_in_use=max(d["bytes_in_use"] for d in st))
