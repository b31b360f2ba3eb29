"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu`` for one NVIDIA
H100.

The JAX package ``bigdl_tpu`` is the reference; this package mirrors its
layout (``core/``, ``nn/``, ``ops/``, ``models/``, ``api.py``,
``serving/``) and replaces each Pallas kernel on a ported path with a
hand-written CUDA kernel (``csrc/``), built with ``nvcc`` at first use.
It imports torch, numpy and the standard library only.

Every entry point takes ``device=`` and defaults to ``"cuda"``; without
CUDA it raises unless the caller passes ``device="cpu"``, which runs each
kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
