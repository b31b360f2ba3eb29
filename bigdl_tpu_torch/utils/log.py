"""Console logging setup for the port's CLI entry points
(``bigdl_tpu/utils/log.py``)."""

import logging
import sys


def init_logging(level=logging.INFO) -> None:
    """One stdout handler on the ``bigdl_tpu_torch`` logger, which stops
    propagating (so a configured root logger does not print each record a
    second time); a repeat call only sets the level."""
    root = logging.getLogger("bigdl_tpu_torch")
    root.propagate = False
    if root.handlers:
        root.setLevel(level)
        return
    h = logging.StreamHandler(sys.stdout)
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    root.addHandler(h)
    root.setLevel(level)
