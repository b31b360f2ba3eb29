"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``pooling`` — K1, NCHW max pool with a stored argmax code, and K3, its
  backward (``csrc/max_pool.cu``; replace ``bigdl_tpu/ops/pooling.py``
  ``_fwd_kernel`` and ``_bwd_kernel``);
* ``lrn``     — K2, cross-map LRN forward, and K4, its backward
  (``csrc/lrn.cu``; replace ``bigdl_tpu/ops/lrn.py`` ``_fwd_kernel`` and
  ``_bwd_kernel``);
* ``quant``   — the quantized-inference codecs, calibration and model
  packing, and the fused dequant-matmuls (``csrc/quant_matmul.cu``): K13
  (``w8_matmul`` for int8 weights, ``f8_matmul`` for e4m3; replaces
  ``bigdl_tpu/ops/quant.py`` ``_w8_kernel``), K14 (``a8_matmul``, int8 x
  int8; ``_a8_kernel``) and K15 (``w4_matmul``, int4 nibbles;
  ``_w4_kernel``);
* ``attention`` — softmax attention, its plain versions and the dispatcher
  ``fused_attention`` (``csrc/attention.cu``): K8 (``attention_fwd``, one
  max per row; replaces ``bigdl_tpu/ops/attention.py`` ``_fwd_kernel``) and
  K9 (``attention_stream_fwd``, the online softmax with an optional
  key-padding bias and, on the training path, its row logsumexp;
  ``_stream_kernel``), whose backward is the flash backward
  (``csrc/flash_attention_bwd.cu``): K10 (``attention_stream_bwd_dq``;
  ``_bwd_dq_kernel``) and K11 (``attention_stream_bwd_dkv``, dK and dV
  summed over a GQA group; ``_bwd_dkv_kernel``), beside their plain
  version ``flash_bwd_plain``, both fed by one ``flash_bwd_delta`` pass
  (``rowsum(dO·O)``, a helper with no TPU kernel of its own; K8's backward
  is autograd of the chunked plain form, as in the reference); and K12
  (``paged_attention``, masked attention over a block-paged KV pool
  through a page table; ``_paged_kernel``, ``csrc/paged_attention.cu``),
  the read path of ``ContinuousGenerator``;
* ``fp16``    — the fp16 wire codec (``csrc/fp16_codec.cu``): K5
  (``fp16_compress``, float32 to its top two bytes; replaces
  ``bigdl_tpu/ops/fp16.py`` ``_compress_kernel``), K6 (``fp16_decompress``;
  ``_decompress_kernel``) and K7 (``fp16_add``, the sum in the fp16 domain
  with subnormals flushed; ``_add_kernel``).

A wrapper takes the plain version for a CPU tensor and launches its kernel
for a CUDA tensor, or raises; there is no switch that hides a kernel.  Each
wrapper counts its launches in ``<wrapper>.launches``.  ``max_pool2d`` and
``cross_map_lrn`` are differentiable: their backward runs K3 and K4.  The
kernels are built with ``nvcc`` at first use (``ops/_build.py``).
"""

from bigdl_tpu_torch.ops.attention import (attention_fwd,
                                           attention_reference,
                                           attention_stream_bwd_dkv,
                                           attention_stream_bwd_dq,
                                           attention_stream_fwd,
                                           attention_stream_plain,
                                           flash_bwd_delta,
                                           flash_bwd_delta_plain,
                                           flash_bwd_plain, fused_attention,
                                           paged_attention,
                                           paged_attention_plain)
from bigdl_tpu_torch.ops.fp16 import (fp16_add, fp16_add_plain,
                                      fp16_compress,
                                      fp16_compress_reference,
                                      fp16_decompress,
                                      fp16_decompress_reference)
from bigdl_tpu_torch.ops.lrn import (cross_map_lrn, lrn_bwd, lrn_bwd_plain,
                                     lrn_plain)
from bigdl_tpu_torch.ops.pooling import (max_pool2d, max_pool2d_bwd,
                                         max_pool2d_bwd_plain,
                                         max_pool2d_plain, pool_geometry)
from bigdl_tpu_torch.ops.quant import (a8_matmul, f8_matmul,
                                       int4_matmul_plain,
                                       int8_a8_matmul_plain,
                                       int8_matmul_plain, w4_matmul,
                                       w8_matmul)

KERNEL_WRAPPERS = (max_pool2d, cross_map_lrn, max_pool2d_bwd, lrn_bwd,
                   w8_matmul, f8_matmul, a8_matmul, w4_matmul,
                   attention_fwd, attention_stream_fwd,
                   attention_stream_bwd_dq, attention_stream_bwd_dkv,
                   flash_bwd_delta, paged_attention, fp16_compress,
                   fp16_decompress, fp16_add)


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    """Every kernel wrapper's launches so far, by wrapper name."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


__all__ = ["a8_matmul", "attention_fwd", "attention_reference",
           "attention_stream_bwd_dkv", "attention_stream_bwd_dq",
           "attention_stream_fwd", "attention_stream_plain",
           "cross_map_lrn", "f8_matmul", "flash_bwd_delta",
           "flash_bwd_delta_plain", "flash_bwd_plain",
           "fp16_add", "fp16_add_plain", "fp16_compress",
           "fp16_compress_reference", "fp16_decompress",
           "fp16_decompress_reference", "fused_attention",
           "int4_matmul_plain", "int8_a8_matmul_plain", "int8_matmul_plain",
           "lrn_bwd", "lrn_bwd_plain", "lrn_plain", "max_pool2d",
           "max_pool2d_bwd", "max_pool2d_bwd_plain", "max_pool2d_plain",
           "paged_attention", "paged_attention_plain", "pool_geometry", "w4_matmul", "w8_matmul", "KERNEL_WRAPPERS",
           "launch_counts", "reset_launches"]
