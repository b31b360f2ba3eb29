"""Torch-style module facade on ``torch.nn.Module``
(``bigdl_tpu/core/module.py``).

The JAX package keeps modules functional (``apply(params, state, x)``) under
a stateful facade.  Here PyTorch's own modules are already stateful, so the
facade is a thin layer of the reference's names over ``nn.Module``:
``forward``, ``evaluate()``, ``training_()``, ``get_parameters()``,
``set_name``, and a :class:`Container` with the builder idiom ``add()``.

Seeding: leaf layers implement ``reset_parameters(gen)``; :meth:`Module.reset`
walks the tree in order with one explicit ``torch.Generator``.  Layers that
draw in training (``Dropout``) use the generator that
:meth:`Module.set_generator` hands to every layer of the tree.

Run-time state (BatchNorm's running statistics) lives in buffers that a
layer names in ``STATE``; :meth:`Module.state_tree` gives them in the JAX
package's module-state layout and :meth:`Module.load_state_tree` copies
such a tree back.
"""

from __future__ import annotations

import threading

import torch
from torch import nn

from bigdl_tpu_torch.core.device import resolve_device

_uid_lock = threading.Lock()
_uid_counters: dict = {}


def _next_uid(cls_name: str) -> int:
    with _uid_lock:
        n = _uid_counters.get(cls_name, 0) + 1
        _uid_counters[cls_name] = n
        return n


def seeded(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


class Module(nn.Module):
    """Base class for all layers of the port."""

    # names of this layer's own buffers that are run-time state
    STATE: tuple = ()

    def __init__(self) -> None:
        super().__init__()
        cls = type(self).__name__
        self.name = f"{cls}_{_next_uid(cls)}"
        self.generator = None

    # -- initialisation -----------------------------------------------------

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw this layer's own parameters from ``gen`` (none by default)."""

    def reset(self, seed: int = 0) -> "Module":
        """Re-initialise every layer from one generator seeded ``seed``
        (``AbstractModule.reset``)."""
        gen = seeded(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Module):
                    m.reset_parameters(gen)
        return self

    def set_generator(self, gen: torch.Generator) -> "Module":
        """Hand ``gen`` to every layer of the tree: the random stream of
        training-mode draws (``Dropout``'s masks).  It must lie on the
        device the forward runs on."""
        for m in self.modules():
            if isinstance(m, Module):
                m.generator = gen
        return self

    # -- device -------------------------------------------------------------

    def to(self, *args, **kwargs):
        """``nn.Module.to`` with the port's device rule: with no argument it
        moves to ``"cuda"``, and a CUDA target without CUDA raises."""
        if not args and not kwargs:
            kwargs["device"] = "cuda"
        device = torch._C._nn._parse_to(*args, **kwargs)[0]
        if device is not None:
            resolve_device(device)
        return super().to(*args, **kwargs)

    def tensor_device(self) -> torch.device:
        """The device of the layer's first parameter or buffer (a
        ``quant.quantize_model`` copy may hold a packed weight as buffers
        only)."""
        for t in self.parameters():
            return t.device
        for t in self.buffers():
            return t.device
        raise ValueError(f"{self.name} holds no tensor")

    # -- Torch-parity facade ------------------------------------------------

    def training_(self) -> "Module":
        self.train(True)
        return self

    def evaluate(self) -> "Module":
        self.train(False)
        return self

    def set_name(self, name: str) -> "Module":
        """``AbstractModule.setName`` — used by name-matching loaders."""
        self.name = name
        return self

    def get_name(self) -> str:
        return self.name

    def param_tree(self):
        """This layer's parameters as the JAX package's pytree: a dict of
        its own parameters and of its children that hold any (a child list
        as a list), ``()`` when it holds none."""
        tree = {k: p for k, p in self._parameters.items() if p is not None}
        for k, c in self._modules.items():
            if c is None or not any(True for _ in c.parameters()):
                continue
            tree[k] = [m.param_tree() for m in c] \
                if isinstance(c, nn.ModuleList) else c.param_tree()
        return tree or ()

    def state_tree(self):
        """This layer's run-time state as the JAX package's module-state
        pytree: a dict of its own ``STATE`` buffers and of its children
        that hold parameters or state (a child list as a list), ``()``
        for a layer without any."""
        tree = {k: self._buffers[k] for k in self.STATE}
        for k, c in self._modules.items():
            if c is None or not (any(True for _ in c.parameters())
                                 or _holds_state(c)):
                continue
            tree[k] = [m.state_tree() for m in c] \
                if isinstance(c, nn.ModuleList) else c.state_tree()
        return tree or ()

    def state_leaves(self):
        """State buffers in the JAX package's pytree leaf order."""
        return tree_leaves(self.state_tree())

    def load_state_tree(self, tree) -> "Module":
        """Copy a tree shaped like :meth:`state_tree` (tensors or arrays)
        into this model's state buffers; ``convert.load_jax_state`` checks
        structure, names and shapes first."""
        from bigdl_tpu_torch.convert import load_jax_state
        return load_jax_state(self, tree)

    def param_leaves(self):
        """Parameters in the JAX package's pytree leaf order."""
        return tree_leaves(self.param_tree())

    def get_parameters(self):
        """Flat contiguous (weights, grads) — ``getParameters()`` parity;
        a parameter without a gradient contributes zeros."""
        leaves = list(self.param_leaves())
        if not leaves:
            z = torch.zeros(0)
            return z, z.clone()
        w = torch.cat([p.detach().reshape(-1) for p in leaves])
        g = torch.cat([(p.grad if p.grad is not None
                        else torch.zeros_like(p)).detach().reshape(-1)
                       for p in leaves])
        return w, g


class Container(Module):
    """Base container — parity with ``nn/Container.scala``.  Children are
    held in order in ``self.layers``."""

    def __init__(self, *modules: Module) -> None:
        super().__init__()
        self.layers = nn.ModuleList(modules)

    def add(self, module: Module) -> "Container":
        self.layers.append(module)
        return self

    def param_tree(self):
        """A list of the children's trees, in order."""
        return [m.param_tree() for m in self.layers]

    def state_tree(self):
        """A list of the children's states, in order."""
        return [m.state_tree() for m in self.layers]


def _holds_state(module: nn.Module) -> bool:
    return any(getattr(m, "STATE", ()) for m in module.modules())


def state_buffer_names(model: nn.Module) -> set:
    """Qualified names (as ``named_buffers`` gives them) of the model's
    run-time state buffers."""
    return {f"{p}.{k}" if p else k for p, m in model.named_modules()
            for k in getattr(m, "STATE", ())}


def tree_leaves(tree):
    """The leaves of a parameter pytree in JAX's order: a dict's entries by
    sorted key, a list's items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from tree_leaves(x)
    else:
        yield tree


def get_named_modules(model: Module) -> dict:
    """{name: module} over the tree (``nn/Utils.getNamedModules``)."""
    return {m.name: m for m in model.modules() if isinstance(m, Module)}
