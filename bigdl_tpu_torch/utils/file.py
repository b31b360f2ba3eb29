"""Snapshot save and load, local and remote (``bigdl_tpu/utils/file.py``).

Parity: ``utils/File.scala:27-131``.  A snapshot is a pickle (protocol 4)
of a tree of host numpy arrays and plain Python values: tensors are
brought to the host as numpy before the pickle, so a file holds no torch
object and has one format in both packages.  A ``model.<n>`` snapshot is
``{"params", "model_state"}`` with ``params`` and ``model_state`` the JAX
package's pytrees (``convert.export_params``, ``convert.export_state``).

A module (``Module.save``; ``nn.load`` reads it back onto a device) is
pickled whole, the port's own classes by name: every tensor it holds
(parameters, buffers, any tensor attribute) is written as a host copy and
every ``torch.Generator`` as None, so the file loads without a card and
the caller's device is chosen at load.  The JAX package pickles its
modules with their JAX classes, which :meth:`File.load` refuses (below):
``.t7`` and ``.caffemodel`` files carry models between the two packages.

Local paths are published atomically
(``durable_io.atomic_write_bytes``: a tmp file per writer, fsynced and
renamed); a ``scheme://`` path goes through an opener given to
:func:`register_filesystem`, else through ``fsspec`` where it is installed.

:meth:`File.load` refuses a pickle that names a class of ``bigdl_tpu`` or
of ``jax``: the JAX trainer's ``state.<n>`` holds its validation results,
and resolving them would import the JAX package into the port.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import Any, Callable, Dict

import torch

from bigdl_tpu_torch.utils.durable_io import atomic_write_bytes

# scheme -> opener(path, mode) -> file object; takes precedence over fsspec
_REGISTRY: Dict[str, Callable[[str, str], Any]] = {}
# top-level packages whose classes a snapshot may not name
_REFUSED = ("bigdl_tpu", "jax", "jaxlib")


def register_filesystem(scheme: str,
                        opener: Callable[[str, str], Any]) -> None:
    """Register ``opener(path, mode)`` for ``scheme://`` paths."""
    _REGISTRY[scheme.rstrip(":/")] = opener


def path_scheme(path: str) -> str:
    """URL scheme of ``path``, or "" for plain local paths."""
    i = path.find("://")
    return path[:i] if i > 0 else ""


def _fsspec(path: str, scheme: str):
    try:
        import fsspec
    except ImportError as e:
        raise ValueError(
            f"remote path {path!r}: no filesystem registered for {scheme!r} "
            "and fsspec is not installed — call "
            "bigdl_tpu_torch.utils.file.register_filesystem") from e
    return fsspec


def _open(path: str, mode: str):
    scheme = path_scheme(path)
    if not scheme or scheme == "file":
        return open(path.removeprefix("file://"), mode)
    if scheme in _REGISTRY:
        return _REGISTRY[scheme](path, mode)
    return _fsspec(path, scheme).open(path, mode).open()


def _exists(path: str) -> bool:
    scheme = path_scheme(path)
    if not scheme or scheme == "file":
        return os.path.exists(path.removeprefix("file://"))
    if scheme in _REGISTRY:
        try:
            with _REGISTRY[scheme](path, "rb"):
                return True
        except OSError:
            return False
    fs, p = _fsspec(path, scheme).core.url_to_fs(path)
    return fs.exists(p)


def to_host(obj: Any) -> Any:
    """``obj`` with every tensor as a host numpy array (bfloat16 widened to
    float32, which numpy lacks), through dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return type(obj)((k, to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _no_generator():
    return None


def _host_tensor(t: torch.Tensor, requires_grad: bool) -> torch.Tensor:
    return t.requires_grad_(requires_grad)


class _HostPickler(pickle.Pickler):
    """Pickles a tensor on a device as its host copy (a Parameter as a
    Parameter) and a ``torch.Generator`` as None."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Generator):
            return _no_generator, ()
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            host = obj.detach().cpu()
            if isinstance(obj, torch.nn.Parameter):
                return torch.nn.Parameter, (host, obj.requires_grad)
            return _host_tensor, (host, obj.requires_grad)
        return NotImplemented


def _dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _HostPickler(buf, protocol=4).dump(obj)
    return buf.getvalue()


class _Unpickler(pickle.Unpickler):

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _REFUSED:
            raise ValueError(
                f"snapshot names the class {module}.{name}: bigdl_tpu_torch "
                "does not import the JAX package or jax")
        return super().find_class(module, name)


class File:

    @staticmethod
    def save(obj: Any, path: str, is_overwrite: bool = False) -> None:
        if _exists(path) and not is_overwrite:
            raise FileExistsError(
                f"{path} already exists (pass is_overwrite=True)")
        obj = to_host(obj)
        if path_scheme(path) in ("", "file"):
            local = path.removeprefix("file://")
            d = os.path.dirname(local)
            if d:
                os.makedirs(d, exist_ok=True)
            atomic_write_bytes(local, _dumps(obj))
        else:
            # object stores upload whole objects: no tmp and rename
            with _open(path, "wb") as f:
                f.write(_dumps(obj))

    @staticmethod
    def load(path: str) -> Any:
        with _open(path, "rb") as f:
            return _Unpickler(f).load()


def tree_structure(tree: Any):
    """The shape of a pytree of dicts, lists and tuples, leaves as ``*``:
    two trees of one structure compare equal (JAX's ``tree_structure``)."""
    if isinstance(tree, dict):
        return {k: tree_structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_structure(v) for v in tree)
    return "*"


def load_model_snapshot(model, path: str):
    """Restore a ``model.<neval>`` snapshot (``{"params", "model_state"}``)
    into ``model``, the resume path every train and test entry point
    shares.  The snapshot's params and module-state trees must have the
    structure of the model's (``convert.export_params``,
    ``convert.export_state``): a mismatched tree (a snapshot of another
    builder or version) raises ``ValueError``, and nothing is copied.
    Leaf shapes are checked before anything is copied.  A model without
    state (no BatchNorm) takes the snapshot's state only when that holds
    no leaf either."""
    from bigdl_tpu_torch.convert import (_copy, _pairs, export_params,
                                         export_state)
    from bigdl_tpu_torch.core.module import tree_leaves

    snap = File.load(path)
    state = snap.get("model_state", ())
    stateful = any(True for _ in tree_leaves(model.state_tree()))
    trees = [("params", export_params(model), snap["params"])]
    if stateful or any(True for _ in tree_leaves(state)):
        trees.append(("model_state", export_state(model), state))
    for key, mine, theirs in trees:
        want, got = tree_structure(mine), tree_structure(theirs)
        if want != got:
            raise ValueError(
                f"snapshot {path!r} does not match the model architecture: "
                f"snapshot {key} tree {got} != model {key} tree {want}. "
                "Was it saved by a different model builder/version?")
    # every shape is checked before the first copy
    pairs = _pairs(model.param_tree(), snap["params"], "params")
    if stateful:
        pairs += _pairs(model.state_tree(), state, "state", "state")
    _copy(pairs)
    return model
