"""Optimizer factory (``bigdl_tpu/optim/optimizer.py``).

Parity: ``optim/Optimizer.scala:152-186``, which picks the trainer by the
dataset's kind.  The port has the local trainer only: a sharded dataset,
or an argument of the distributed trainer, raises and names the
DistriOptimizer slice.
"""

from __future__ import annotations

from bigdl_tpu_torch.optim.local_optimizer import (LocalOptimizer,
                                                   _base_dataset)


def Optimizer(model, dataset, criterion, end_when=None, device="cuda",
              **distri_kwargs):
    """A :class:`LocalOptimizer` on ``device`` (CUDA by default)."""
    if distri_kwargs or getattr(_base_dataset(dataset), "num_shards", None):
        raise NotImplementedError(
            "a sharded dataset or DistriOptimizer arguments "
            f"({sorted(distri_kwargs)}) come with the DistriOptimizer slice "
            "of the port")
    return LocalOptimizer(model, criterion, dataset, end_when,
                          device=device)
