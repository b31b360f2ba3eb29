"""Dataset fetch helpers (``bigdl_tpu/dataset/base.py``).

Parity: the reference python binding's ``dataset/base.py``
(``dl/src/main/python/dataset/base.py:176`` — ``maybe_download``).

Training hosts usually have **no internet egress** — data is staged to
local or cloud storage out of band.  ``maybe_download`` is
therefore local-first: if the file is already in ``work_directory`` it is
returned immediately; otherwise a download is attempted and a clear
actionable error is raised when the network is unreachable.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("bigdl_tpu_torch.dataset")


def maybe_download(filename: str, work_directory: str,
                   source_url: str) -> str:
    """Return the path of ``filename`` under ``work_directory``,
    downloading it from ``source_url`` first if it is not present."""
    os.makedirs(work_directory, exist_ok=True)
    filepath = os.path.join(work_directory, filename)
    if os.path.exists(filepath):
        return filepath
    import urllib.request
    logger.info("downloading %s -> %s", source_url, filepath)
    try:
        tmp = filepath + ".part"
        urllib.request.urlretrieve(source_url, tmp)
        os.replace(tmp, filepath)
    except Exception as e:  # noqa: BLE001 — urllib raises many types
        raise IOError(
            f"{filename} is not in {work_directory} and downloading "
            f"{source_url} failed ({e}). Training hosts typically have no "
            f"egress: stage the file to {filepath} manually.") from e
    return filepath
