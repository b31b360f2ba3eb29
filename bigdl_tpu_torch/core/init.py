"""Parameter initialisation methods (``bigdl_tpu/core/init.py``).

Parity: ``nn/InitializationMethod.scala`` — Default (Torch fan-in uniform)
and Xavier.  Every draw takes an explicit ``torch.Generator``; tensors are
made on the CPU and moved with the module.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

DEFAULT = "default"
XAVIER = "xavier"


def uniform(gen: torch.Generator, shape, stdv: float,
            dtype=torch.float32) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) * stdv


def default_init(gen, shape: Tuple[int, ...], fan_in: int,
                 dtype=torch.float32):
    """Torch default: U(-1/sqrt(fanIn), 1/sqrt(fanIn))."""
    return uniform(gen, shape, 1.0 / math.sqrt(max(1, fan_in)), dtype)


def xavier_init(gen, shape: Tuple[int, ...], fan_in: int, fan_out: int,
                dtype=torch.float32):
    return uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)), dtype)


def init_weight(method: str, gen, shape, fan_in: int, fan_out: int,
                dtype=torch.float32):
    if method == XAVIER:
        return xavier_init(gen, shape, fan_in, fan_out, dtype)
    if method != DEFAULT:
        raise ValueError(f"init method {method!r} is not ported "
                         f"(have {DEFAULT!r}, {XAVIER!r})")
    return default_init(gen, shape, fan_in, dtype)
