"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``pooling`` — K1, NCHW max pool with a stored argmax code, and K3, its
  backward (``csrc/max_pool.cu``; replace ``bigdl_tpu/ops/pooling.py``
  ``_fwd_kernel`` and ``_bwd_kernel``);
* ``lrn``     — K2, cross-map LRN forward, and K4, its backward
  (``csrc/lrn.cu``; replace ``bigdl_tpu/ops/lrn.py`` ``_fwd_kernel`` and
  ``_bwd_kernel``).

A wrapper takes the plain version for a CPU tensor and launches its kernel
for a CUDA tensor, or raises; there is no switch that hides a kernel.  Each
wrapper counts its launches in ``<wrapper>.launches``.  ``max_pool2d`` and
``cross_map_lrn`` are differentiable: their backward runs K3 and K4.  The
kernels are built with ``nvcc`` at first use (``ops/_build.py``).
"""

from bigdl_tpu_torch.ops.lrn import (cross_map_lrn, lrn_bwd, lrn_bwd_plain,
                                     lrn_plain)
from bigdl_tpu_torch.ops.pooling import (max_pool2d, max_pool2d_bwd,
                                         max_pool2d_bwd_plain,
                                         max_pool2d_plain, pool_geometry)

KERNEL_WRAPPERS = (max_pool2d, cross_map_lrn, max_pool2d_bwd, lrn_bwd)


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = ["cross_map_lrn", "lrn_bwd", "lrn_bwd_plain", "lrn_plain",
           "max_pool2d", "max_pool2d_bwd", "max_pool2d_bwd_plain",
           "max_pool2d_plain", "pool_geometry", "KERNEL_WRAPPERS",
           "reset_launches"]
