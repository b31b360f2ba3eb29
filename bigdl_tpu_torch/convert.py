"""Copy parameters between the JAX package's pytree and the port's modules.

``load_jax_params(model, params)`` takes ``bigdl_tpu``'s parameter pytree as
nested lists/dicts of arrays (a Container's children by index, a leaf
layer's parameters by name, ``()`` for a layer without any) and copies it
into the matching port modules.  Conv OIHW and Linear ``(out, in)`` layouts
are the same on both sides, so each leaf is copied as it is.  Any mismatch
of structure, names or shapes raises ``ValueError``; nothing is copied
partially on a failed check.  ``export_params(model)`` is the inverse: the
port's parameters as that pytree of numpy arrays, so weights trained by
the two trainers can be compared leaf by leaf.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.core.module import Container, Module


def _pairs(m: Module, p: Any, path: str) -> List[Tuple[torch.nn.Parameter,
                                                        np.ndarray, str]]:
    if isinstance(m, Container):
        if not isinstance(p, (list, tuple)) or len(p) != len(m.layers):
            n = len(p) if isinstance(p, (list, tuple)) else type(p).__name__
            raise ValueError(f"{path}: container {m.name!r} has "
                             f"{len(m.layers)} children, params have {n}")
        out = []
        for i, (child, cp) in enumerate(zip(m.layers, p)):
            out.extend(_pairs(child, cp, f"{path}[{i}]"))
        return out
    mine = {k: v for k, v in m._parameters.items() if v is not None}
    theirs = {} if isinstance(p, (list, tuple)) and len(p) == 0 else p
    if not isinstance(theirs, dict):
        raise ValueError(f"{path}: layer {m.name!r} expects a dict of "
                         f"parameters, got {type(p).__name__}")
    if set(mine) != set(theirs):
        raise ValueError(f"{path}: layer {m.name!r} has parameters "
                         f"{sorted(mine)}, params have {sorted(theirs)}")
    out = []
    for k, dst in mine.items():
        src = np.asarray(theirs[k])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}.{k}: shape {tuple(src.shape)} does "
                             f"not match {tuple(dst.shape)} of {m.name!r}")
        out.append((dst, src, f"{path}.{k}"))
    return out


def load_jax_params(model: Module, params: Any) -> Module:
    """Copy ``params`` into ``model`` in place; returns ``model``."""
    pairs = _pairs(model, params, "params")
    with torch.no_grad():
        for dst, src, _ in pairs:
            dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))
    return model


def export_params(model: Module) -> Any:
    """The model's parameters as ``bigdl_tpu``'s pytree: a list per
    Container, a dict of float32 numpy arrays per layer with parameters,
    ``()`` for a layer without any."""
    if isinstance(model, Container):
        return [export_params(m) for m in model.layers]
    mine = {k: v.detach().cpu().float().numpy().copy()
            for k, v in model._parameters.items() if v is not None}
    return mine if mine else ()
