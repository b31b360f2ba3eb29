"""Copy parameters between the JAX package's pytree and the port's modules.

``load_jax_params(model, params)`` takes ``bigdl_tpu``'s parameter pytree as
nested lists/dicts of arrays and copies it into the matching port modules,
walking ``Module.param_tree``: a Container's children (and a
``ModuleList``'s) by index, a layer's own parameters and its
parameter-holding children by name, ``()`` for a layer without any.  So
the Inception trees (lists of leaf dicts) and the TransformerLM tree
(``{"tok", "pos", "blocks": [{"ln1", "attn": {"wq", ...}, "ln2", "fc1",
"fc2"}], "ln_f"}``) load alike.  Conv OIHW and Linear ``(out, in)``
layouts are the same on both sides, so each leaf is copied as it is.  Any
mismatch of structure, names or shapes raises ``ValueError``; nothing is
copied partially on a failed check.  ``export_params(model)`` is the
inverse: the port's parameters as that pytree of numpy arrays, so weights
of the two packages can be compared leaf by leaf.  ``load_jax_state`` and
``export_state`` do the same, by the same rules, for the module state
(``Module.state_tree``: BatchNorm's running statistics).
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.core.module import Module


def _pairs(mine: Any, theirs: Any, path: str,
           what: str = "parameters") -> List[Tuple[
               torch.Tensor, np.ndarray, str]]:
    """(tensor, array, path) for every leaf of the port's tree ``mine``
    (``Module.param_tree`` or ``state_tree``) and the JAX tree ``theirs``,
    walked together."""
    if isinstance(mine, list):
        if not isinstance(theirs, (list, tuple)) or len(theirs) != len(mine):
            n = len(theirs) if isinstance(theirs, (list, tuple)) \
                else type(theirs).__name__
            raise ValueError(f"{path}: container has {len(mine)} children, "
                             f"{path} has {n}")
        return [pair for i, (m, t) in enumerate(zip(mine, theirs))
                for pair in _pairs(m, t, f"{path}[{i}]", what)]
    if isinstance(mine, torch.Tensor):
        src = np.asarray(theirs)
        if tuple(src.shape) != tuple(mine.shape):
            raise ValueError(f"{path}: shape {tuple(src.shape)} does not "
                             f"match {tuple(mine.shape)}")
        return [(mine, src, path)]
    mine = {} if isinstance(mine, tuple) else mine
    if isinstance(theirs, (list, tuple)) and len(theirs) == 0:
        theirs = {}
    if not isinstance(theirs, dict):
        raise ValueError(f"{path}: layer expects a dict of {what}, got "
                         f"{type(theirs).__name__}")
    if set(mine) != set(theirs):
        raise ValueError(f"{path}: layer has {what} {sorted(mine)}, "
                         f"{path} has {sorted(theirs)}")
    return [pair for k in mine
            for pair in _pairs(mine[k], theirs[k], f"{path}.{k}", what)]


def _copy(pairs) -> None:
    with torch.no_grad():
        for dst, src, _ in pairs:
            dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))


def load_jax_params(model: Module, params: Any) -> Module:
    """Copy ``params`` into ``model`` in place; returns ``model``."""
    _copy(_pairs(model.param_tree(), params, "params"))
    return model


def load_jax_state(model: Module, state: Any) -> Module:
    """Copy the module state ``state`` into ``model``'s state buffers in
    place; returns ``model``."""
    _copy(_pairs(model.state_tree(), state, "state", "state"))
    return model


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, tuple):
        return ()
    return tree.detach().cpu().float().numpy().copy()


def export_params(model: Module) -> Any:
    """The model's parameters as ``bigdl_tpu``'s pytree
    (``Module.param_tree``) of float32 numpy arrays."""
    return _to_numpy(model.param_tree())


def export_state(model: Module) -> Any:
    """The model's module state as ``bigdl_tpu``'s pytree
    (``Module.state_tree``) of float32 numpy arrays."""
    return _to_numpy(model.state_tree())
