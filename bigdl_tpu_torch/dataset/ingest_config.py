"""Ingest tuning knobs (``bigdl_tpu/dataset/ingest_config.py``): one place
for every ``BIGDL_TPU_INGEST_*`` default.

Every knob follows the same contract: the API argument wins when given,
the environment variable is the deployment-level default, and the coded
fallback is the safe single-host value.  Parsing is strict: a mistyped
value raises when the pipeline is built.

=============================  =============================================
variable                       meaning
=============================  =============================================
``BIGDL_TPU_INGEST_DEPTH``     prefetch ring depth (pinned host buffers kept
                               in flight; default 2, the double buffer)
``BIGDL_TPU_INGEST_WORKERS``   decode/augment worker count (threads for
                               ``MTTransformer``; 0 = in-process, default 2)
``BIGDL_TPU_INGEST_DTYPE``     host-side cast dtype for batch DATA before
                               the host-to-device copy (``bf16``/``f32``/
                               ``f16``; empty = keep the producer's dtype)
``BIGDL_TPU_INGEST_CHUNK``     records a worker takes per task (the
                               ordering unit; default 32)
``BIGDL_TPU_INGEST_START``     multiprocessing start method for ingest
                               worker processes (default ``spawn``)
=============================  =============================================
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_DTYPE_NAMES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                "f16": torch.float16, "float16": torch.float16,
                "f32": torch.float32, "float32": torch.float32}


def _int_env(var: str, default: int, minimum: int) -> int:
    raw = os.environ.get(var, "")
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(f"{var}={raw!r} is not an integer") from None
    if val < minimum:
        raise ValueError(f"{var}={val} is below the minimum {minimum}")
    return val


def depth(arg: Optional[int] = None) -> int:
    """Prefetch depth (>= 2, so the copy of batch k+1 can overlap the
    consumption of batch k)."""
    if arg is not None:
        if arg < 2:
            raise ValueError(f"ingest depth {arg} < 2 cannot double-buffer")
        return arg
    return _int_env("BIGDL_TPU_INGEST_DEPTH", 2, 2)


def workers(arg: Optional[int] = None, default: int = 2) -> int:
    """Decode/augment worker count; 0 runs in-process (the same sample
    order).  ``default`` is the coded fallback when neither the argument
    nor the environment gives one."""
    if arg is not None:
        if arg < 0:
            raise ValueError(f"ingest workers {arg} < 0")
        return arg
    return _int_env("BIGDL_TPU_INGEST_WORKERS", default, 0)


def chunk(arg: Optional[int] = None) -> int:
    """Records per worker task: the unit of order-preserving reassembly,
    never derived from the worker count."""
    if arg is not None:
        if arg < 1:
            raise ValueError(f"ingest chunk {arg} < 1")
        return arg
    return _int_env("BIGDL_TPU_INGEST_CHUNK", 32, 1)


def pack_dtype(arg=None) -> Optional[torch.dtype]:
    """The torch dtype batch data is cast to on the host (``None`` keeps
    the producer's).  Takes a torch dtype or the ``bf16``/``f32``/``f16``
    spellings of ``BIGDL_TPU_INGEST_DTYPE``."""
    if arg is not None:
        return _resolve_dtype(arg, origin="ingest pack dtype")
    raw = os.environ.get("BIGDL_TPU_INGEST_DTYPE", "").strip().lower()
    if not raw:
        return None
    return _resolve_dtype(raw, origin="BIGDL_TPU_INGEST_DTYPE")


def _resolve_dtype(spec, origin: str) -> torch.dtype:
    if isinstance(spec, torch.dtype):
        return spec
    key = str(spec).strip().lower()
    try:
        return _DTYPE_NAMES[key]
    except KeyError:
        raise ValueError(f"{origin}={spec!r}: choose from "
                         f"{sorted(_DTYPE_NAMES)}") from None


def start_method(arg: Optional[str] = None) -> str:
    val = arg or os.environ.get("BIGDL_TPU_INGEST_START", "spawn")
    if val not in ("spawn", "fork", "forkserver"):
        raise ValueError(
            f"ingest start method {val!r}: choose spawn/fork/forkserver")
    return val
