"""Atomic publish of a file that another process may read at any instant
(``bigdl_tpu/utils/durable_io.py``).

The only write shape that survives a SIGKILL or a power loss mid-write is
tmp + flush + fsync + ``os.replace``:

* the tmp name is unique per writer (pid + thread id), so concurrent
  writers never interleave into one half-file;
* ``fsync`` pins the bytes before the rename: ``os.replace`` alone
  publishes the name atomically but can still surface a truncated file
  after a power loss;
* ``os.replace`` makes the publish all-or-nothing: a reader sees the old
  content or the new, never a torn mix.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Durably publish ``data`` at ``path`` (the guarantee of
    :func:`atomic_write_json`, for bytes)."""
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # never leave the half-written tmp behind
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, payload, *, indent: Optional[int] = None,
                      sort_keys: bool = False) -> None:
    """Durably publish ``payload`` as JSON at ``path``: a concurrent reader
    (or one after a mid-write kill or power loss) sees the previous content
    or the new, never a torn mix."""
    atomic_write_text(path, json.dumps(payload, indent=indent,
                                       sort_keys=sort_keys))


def atomic_write_text(path: str, data: str,
                      encoding: str = "utf-8") -> None:
    """Durably publish ``data`` at ``path`` (the guarantee of
    :func:`atomic_write_json`, for other text)."""
    atomic_write_bytes(path, data.encode(encoding))
