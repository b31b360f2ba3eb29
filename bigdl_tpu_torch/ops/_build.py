"""Build and load the hand-written CUDA kernels (``bigdl_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with :mod:`ctypes`.  The build runs
at first use, never at import, and is cached under
``build/bigdl_tpu_torch/<hash>/`` in the checkout, keyed by a hash of the
sources and the compiler flags; each ``.cu`` file compiles in its own
``nvcc`` process, all started together, then one link step makes the
library.  Nothing here falls back: a missing ``nvcc`` or a failed build
raises.

``build_host`` does the same for the host helpers' C++ source
(``csrc/host/``, compiled by ``g++``, no CUDA) into
``build/bigdl_tpu_torch/host/<hash>/``.

Each build that runs (not one found in the cache) writes one ``compile``
record to the run ledger (``event`` ``nvcc`` or ``g++``, ``dur_s``), the
port's counterpart of the reference's XLA compile records.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from bigdl_tpu_torch.observability import tracer

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "bigdl_tpu_torch"
LIB_NAME = "libbigdl_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# dtype codes, kept in step with csrc/common.cuh: activations, then the
# packed weights of the quantized matmuls
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
WEIGHT_CODES = {torch.int8: 2, torch.float8_e4m3fn: 3}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, y, idx (or null), dtype, n, c, h, w, kh, kw, sh, sw, ph, pw, oh,
    # ow, planes a block, rows a band, columns a tile, threads, stream
    "bigdl_max_pool2d_fwd": [_P, _P, _P] + [_I] * 17 + [_P],
    # dy, idx, dx, then as the forward
    "bigdl_max_pool2d_bwd": [_P, _P, _P] + [_I] * 17 + [_P],
    # kh, kw, sh, sw: the instantiation K1 and K3 take
    "bigdl_max_pool2d_variant": [_I] * 4,
    # x, y, scale, dtype, n, c, hw, size, alpha/size, beta, k, mode, then
    # the plan: fixed size (0 generic), pixels a thread, channels a thread,
    # threads a block; stream
    "bigdl_lrn_fwd": [_P, _P, _P, _I, _I, _I, ctypes.c_longlong, _I,
                      ctypes.c_float, ctypes.c_float, ctypes.c_float] +
    [_I] * 5 + [_P],
    # x, scale, dy, dx, dtype, n, c, hw, size, alpha/size, beta, mode, the
    # plan as for the forward, stream
    "bigdl_lrn_bwd": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _I,
                      ctypes.c_float, ctypes.c_float] + [_I] * 5 + [_P],
    # x, q, scale, y, x dtype, weight dtype, m, n, k, bm, bn, splits,
    # workspace (or null), stream
    "bigdl_w8_matmul": [_P, _P, _P, _P] + [_I] * 8 + [_P, _P],
    # xq, q, scale * sx, y, y dtype, m, n, k, bn, splits, workspace and
    # tickets (or null), stream
    "bigdl_a8_matmul": [_P, _P, _P, _P] + [_I] * 6 + [_P, _P, _P],
    # x, q4, scale, y, x dtype, m, n, k, bm, bn, splits, workspace (or
    # null), stream
    "bigdl_w4_matmul": [_P, _P, _P, _P] + [_I] * 7 + [_P, _P],
    # q, k, v, o, dtype, bh, h, hk, tq, tk, d, scale, causal, stream
    "bigdl_attention_fwd": [_P] * 4 + [_I] * 7 + [ctypes.c_float, _I, _P],
    # q, k, v, bias (or null), o, lse (or null), dtype, bh, h, hk, tq, tk,
    # d, scale, causal, stream
    "bigdl_attention_stream_fwd": [_P] * 6 + [_I] * 7 +
    [ctypes.c_float, _I, _P],
    # o, do, delta, dtype, rows, d, stream
    "bigdl_flash_bwd_delta": [_P, _P, _P, _I, ctypes.c_longlong, _I, _P],
    # q, k, v, delta, lse, do, bias (or null), dq, dtype, b, h, hk, tq, tk,
    # d, scale, causal, stream
    "bigdl_flash_bwd_dq": [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _P],
    # q, k, v, delta, lse, do, bias (or null), dk, dv, dtype, b, h, hk, tq,
    # tk, d, scale, causal, stream
    "bigdl_flash_bwd_dkv": [_P] * 9 + [_I] * 7 + [ctypes.c_float, _I, _P],
    # q, k pool, v pool, pages, positions, o, scratch (or null), q dtype,
    # cache dtype, b, h, hkv, s, d, page size, lp, trash, scale, tensor-core
    # path, rows per block, splits, pages a split, keys a tile, stream
    "bigdl_paged_attention": [_P] * 7 + [_I] * 10 + [ctypes.c_float] +
    [_I] * 5 + [_P],
    # x, out, n, stream
    "bigdl_fp16_compress": [_P, _P, ctypes.c_longlong, _P],
    # u, out, n, stream
    "bigdl_fp16_decompress": [_P, _P, ctypes.c_longlong, _P],
    # a, b, out, n, stream
    "bigdl_fp16_add": [_P, _P, _P, ctypes.c_longlong, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels of bigdl_tpu_torch cannot be built")


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into the cached library (a no-op when the hash
    directory already holds it) and return its path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    t0 = time.perf_counter()
    work = out_dir / f"tmp-{os.getpid()}-{threading.get_ident()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        objs, procs = [], []
        for src in sources():
            obj = work / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{out.decode(errors='replace')}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = work / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" +
                               link.stdout.decode(errors="replace"))
        os.replace(tmp_lib, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the port's counterpart of an XLA compile record: what a first step
    # waited for
    tracer.record_compile("nvcc", time.perf_counter() - t0,
                          sources=len(objs))
    return lib


HOST_ROOT = BUILD_ROOT / "host"
HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]


def host_hash(src: Path, variants, salt: str = "") -> str:
    h = hashlib.sha256((" ".join(HOST_FLAGS) + "|" + salt).encode())
    for extra in variants:
        h.update(("|" + " ".join(extra)).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_host(src: Path, lib_name: str, variants, salt: str = "") -> Path:
    """Compile one host C++ source with ``g++ HOST_FLAGS`` into
    ``HOST_ROOT/<hash>/lib_name`` (a no-op when it is there) and return its
    path.  ``variants`` are (flags before the source, flags after it) pairs
    tried in turn; the first that compiles is the library.  ``salt`` joins
    the hash: what of the machine decides which variant builds (a library
    linked against a shared library this machine lacks must not load from
    the cache).  Each process
    compiles to a name of its own and renames it into place, so concurrent
    first users never see a half-written file.  Raises ``RuntimeError``
    with every variant's ``g++`` output when none compiles."""
    out_dir = HOST_ROOT / host_hash(src, [a + b for a, b in variants], salt)
    lib = out_dir / lib_name
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the host helpers of "
                           "bigdl_tpu_torch cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{lib_name}.{os.getpid()}.{threading.get_ident()}.tmp"
    errors = []
    t0 = time.perf_counter()
    for before, after in variants:
        cmd = [gxx, *HOST_FLAGS, *before, "-o", str(tmp), str(src), *after]
        run = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        if run.returncode == 0:
            os.replace(tmp, lib)
            tracer.record_compile("g++", time.perf_counter() - t0,
                                  source=src.name)
            return lib
        errors.append(" ".join(cmd) + ":\n" +
                      run.stdout.decode(errors="replace"))
        tmp.unlink(missing_ok=True)
    raise RuntimeError("g++ failed to build " + src.name + ":\n" +
                       "\n".join(errors))


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


_launch_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count of its kernel's launches.
    Serving runs forwards on several worker threads at once, and a bare
    ``launches += 1`` is a read-modify-write that can lose a count."""
    with _launch_lock:
        wrapper.launches += 1


def stream_ptr(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of the current stream on t's card (without
    building a ``torch.cuda.Stream``: a wrapper's host time counts where
    the kernel is short)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
