"""Mixed precision, bf16 compute over f32 master weights
(``bigdl_tpu/core/precision.py`` ``mixed_forward``).

The forward runs with every floating parameter and buffer cast to
``compute_dtype``, except the run-time state (``Module.STATE``: BatchNorm's
running statistics), and a floating input in that dtype; an integer input
(token ids) passes through unchanged, as ``cast_tree`` passes integer
leaves (bf16 holds integers exactly only up to 256); the output comes back in
float32, so the loss and the criterion stay in f32.  The model's own
parameters stay in their dtype.  The casts are ordinary differentiable
ops, so under autograd the gradients with respect to the f32 parameters
come back in f32 (a cast's backward casts back), with no unscale pass:
bf16 has f32's exponent range.  The state buffers are left out of the
tensors handed to ``functional_call``, so the layers read and update the
module's own f32 buffers in place, as the reference hands ``model_state``
in and out in its own dtype (``cast_like``).
``DLClassifier(compute_dtype=...)`` uses the same forward for inference
and ``LocalOptimizer.set_mixed_precision`` for training.
"""

from __future__ import annotations

import itertools

import torch
from torch.func import functional_call

from bigdl_tpu_torch.core.module import state_buffer_names


def cast_tensors(model: torch.nn.Module, dtype) -> dict:
    """{name: tensor} of the model's parameters and buffers, floating ones
    cast to ``dtype``; the run-time state buffers are not in it."""
    state = state_buffer_names(model)
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in itertools.chain(model.named_parameters(),
                                        model.named_buffers())
            if k not in state}


def promote(*tensors):
    """The operands of one product cast to their common dtype, as ``jnp``
    promotes mixed operands (bf16 with f32 gives f32) where torch's matmul,
    ``F.linear`` and ``F.layer_norm`` raise.  ``None`` passes through."""
    dt = None
    for t in tensors:
        if t is not None:
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return tuple(t if t is None or t.dtype == dt else t.to(dt)
                 for t in tensors)


def mixed_forward(model: torch.nn.Module, data: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    if data.is_floating_point():
        data = data.to(compute_dtype)
    y = functional_call(model, cast_tensors(model, compute_dtype), (data,))
    return y.float()
