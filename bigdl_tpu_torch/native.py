"""The native host helpers (``csrc/host/bigdl_native.cpp``) through ctypes
(``bigdl_tpu/native.py``).

The port's own copy of the JAX package's C++ host library: the fp16 wire
codec, MT19937, the image-ingest loops (planar bytes to HWC floats, crop,
flip, per-channel normalize, bilinear resize, the CHW batch pack), the BTSF
record scan and the libjpeg decode with its fused resize to BGR.  ctypes
releases the interpreter lock for every call, so threads and the trainer's
own thread run beside a helper.

The library is built with ``g++ -O3 -fPIC -std=c++17`` (the reference's
flags: no ``-march``, no fast math, so every helper gives numpy's bits) at
first use into ``build/bigdl_tpu_torch/host/<hash>/`` by
``ops/_build.build_host``: first against libjpeg (``-DBIGDL_WITH_JPEG
-ljpeg``), then without it where that fails; ``has_jpeg()`` says which one
loaded.  The hash covers the source, the flags and the libjpeg the
machine's loader finds, so a checkout carried to a machine without it
builds anew.  A build that fails both ways raises ``RuntimeError`` with
``g++``'s output.  Nothing is built at import.

Python wraps the helpers that a transformer, the record reader or the
random generator calls; the library's other symbols (the fp16 codec, the
planar-bytes decode, crop, the float resize) are declared for the tests,
which hold them against the reference's.  Each image helper has its numpy
plain version beside it (``<name>_plain``), the value the helper is held to
bit for bit; the transformers take it on images below ``MIN_VALUES``
(``pays``), and the batchers with ``native=False``.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "host" / \
    "bigdl_native.cpp"
LIB_NAME = "libbigdl_native.so"
# (flags before the source, flags after it), tried in turn
BUILD_VARIANTS = [(["-DBIGDL_WITH_JPEG"], ["-ljpeg"]), ([], [])]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64 = ctypes.c_int64
_u64 = ctypes.c_uint64
_dbl = ctypes.c_double
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_dblp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """The built library's path (built now if it is not there)."""
    import ctypes.util
    from bigdl_tpu_torch.ops import _build
    return _build.build_host(SOURCE, LIB_NAME, BUILD_VARIANTS,
                             salt=ctypes.util.find_library("jpeg") or "")


def lib() -> ctypes.CDLL:
    """The loaded library, built at the first call (raises if it cannot
    be built)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(library_path()))
            _declare(loaded)
            _lib = loaded
    return _lib


def available() -> bool:
    """``MKL.isMKLLoaded`` parity: True once the library is loaded; a
    library that cannot be built raises instead of returning False."""
    return lib() is not None


def _declare(lb: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p

    def sig(name, restype, argtypes):
        fn = getattr(lb, name)
        fn.restype = restype
        fn.argtypes = argtypes

    sig("bn_fp16_compress", None, [_f32p, _i64, _u16p])
    sig("bn_fp16_decompress", None, [_u16p, _i64, _f32p])
    sig("bn_fp16_add", None, [_u16p, _u16p, _i64, _u16p])
    sig("bn_mt_new", vp, [_u64])
    sig("bn_mt_free", None, [vp])
    sig("bn_mt_set_seed", None, [vp, _u64])
    sig("bn_mt_get_seed", _u64, [vp])
    sig("bn_mt_get_state", None, [vp, _u32p, _i64p, _dblp])
    sig("bn_mt_set_state", None, [vp, _u32p, _i64p, _dblp])
    sig("bn_mt_random", ctypes.c_uint32, [vp])
    sig("bn_mt_uniform", _dbl, [vp, _dbl, _dbl])
    sig("bn_mt_normal", _dbl, [vp, _dbl, _dbl])
    sig("bn_mt_exponential", _dbl, [vp, _dbl])
    sig("bn_mt_cauchy", _dbl, [vp, _dbl, _dbl])
    sig("bn_mt_geometric", _i64, [vp, _dbl])
    sig("bn_mt_bernoulli", ctypes.c_int32, [vp, _dbl])
    sig("bn_mt_uniform_array", None, [vp, _dbl, _dbl, _i64, _dblp])
    sig("bn_mt_normal_array", None, [vp, _dbl, _dbl, _i64, _dblp])
    sig("bn_mt_shuffle_indices", None, [vp, _i64, _i64p])
    sig("bn_bytes_chw_to_hwc", None,
        [_u8p, _i64, _i64, _i64, ctypes.c_float, _f32p])
    sig("bn_crop", None,
        [_f32p, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _f32p])
    sig("bn_hflip", None, [_f32p, _i64, _i64, _i64, _f32p])
    sig("bn_normalize", None, [_f32p, _i64, _i64, _f32p, _f32p])
    sig("bn_resize_bilinear", None,
        [_f32p, _i64, _i64, _i64, _f32p, _i64, _i64])
    sig("bn_pack_chw", None,
        [_f32p, _i64, _i64, _i64, ctypes.c_int32, vp, vp, _f32p])
    sig("bn_seqfile_scan", _i64,
        [ctypes.c_char_p, _i64, _i64p, _i64p, _i64p, _i64p])
    sig("bn_has_jpeg", ctypes.c_int32, [])
    sig("bn_jpeg_probe", _i64, [ctypes.c_char_p, _i64, _i64, _i64p])
    sig("bn_jpeg_decode", ctypes.c_int32,
        [ctypes.c_char_p, _i64, _i64, _u8p, _i64, _i64])
    sig("bn_u8rgb_resize_bgr", None,
        [_u8p, _i64, _i64, _f32p, _i64, _i64, ctypes.c_float])


# -- the image-ingest loops (float32 HWC) -------------------------------------

# Below this many values an image costs numpy less than the ctypes call's
# own overhead (CIFAR's 32x32x3: chip_smoke.py phase 3v-a times both at 32
# and at 224 pixels); the crossover lies between, and no path of the port
# runs an image there.
MIN_VALUES = 64 * 64 * 3


def pays(img: np.ndarray) -> bool:
    """True where ``img`` is large enough for a native loop to repay its
    ctypes call."""
    return img.size >= MIN_VALUES


def hflip(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    img2 = np.ascontiguousarray(img, np.float32)
    out = np.empty((h, w, c), np.float32)
    lib().bn_hflip(img2.reshape(h, w, c), h, w, c, out)
    return out.reshape(img.shape)


def hflip_plain(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[:, ::-1])


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    """Per-channel (x - mean) / std on an HWC image; a new array."""
    out = np.array(img, np.float32, order="C")      # one copy, in place
    c = out.shape[-1] if out.ndim == 3 else 1
    lib().bn_normalize(out.reshape(-1, c), out.size // c, c,
                       np.ascontiguousarray(mean, np.float32),
                       np.ascontiguousarray(std, np.float32))
    return out


def normalize_plain(img: np.ndarray, mean, std) -> np.ndarray:
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _taps(src: int, dst: int):
    """The C loops' sample positions along one axis: (i0, i1, weight) in
    double, the start clamped at 0 and the ends at the last index."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    f = np.maximum(f, 0.0)
    i0 = np.minimum(f.astype(np.int64), src - 1)
    i1 = np.minimum(i0 + 1, src - 1)
    return i0, i1, f - i0


def pack_chw(img: np.ndarray, dst: np.ndarray, to_rgb: bool = False,
             mean=None, std=None) -> None:
    """Write one HWC image into a CHW slot of a batch buffer, with optional
    channel reversal and per-channel ``(x - mean) * (1 / std)``."""
    h, w, c = img.shape
    if dst.shape != (c, h, w) or dst.dtype != np.float32 \
            or not dst.flags.c_contiguous:
        raise ValueError("pack_chw: slot %s/%s does not fit image %s" %
                         (dst.shape, dst.dtype, img.shape))
    img2 = np.ascontiguousarray(img, np.float32)
    mp = sp = None
    if mean is not None:
        mean = np.ascontiguousarray(mean, np.float32)
        mp = mean.ctypes.data_as(ctypes.c_void_p)
    if std is not None:
        std = np.ascontiguousarray(std, np.float32)
        sp = std.ctypes.data_as(ctypes.c_void_p)
    lib().bn_pack_chw(img2, h, w, c, 1 if to_rgb else 0, mp, sp, dst)


def pack_chw_plain(img: np.ndarray, dst: np.ndarray, to_rgb: bool = False,
                   mean=None, std=None) -> None:
    x = np.asarray(img, np.float32)
    if to_rgb:
        x = x[..., ::-1]
    if mean is not None or std is not None:
        c = x.shape[-1]
        m = np.zeros(c, np.float32) if mean is None else \
            np.asarray(mean, np.float32)[::-1 if to_rgb else 1]
        s = np.ones(c, np.float32) if std is None else \
            np.asarray(std, np.float32)[::-1 if to_rgb else 1]
        x = (x - m) * (np.float32(1) / s)
    dst[...] = x.transpose(2, 0, 1)


# -- the BTSF record scan -----------------------------------------------------

def _scan_error(path: str, n: int) -> None:
    if n == -3:
        open(path, "rb").close()      # the OS error the Python reader gives
        raise OSError(f"{path}: cannot open")
    if n == -1:
        raise ValueError(f"{path}: not a BTSF record file")
    if n == -2:
        raise ValueError(f"{path}: truncated record")


def seqfile_count(path: str) -> int:
    """The record count of one BTSF file: the scan's counting pass (one
    buffered read, no offset arrays)."""
    empty = np.empty(0, np.int64)
    n = lib().bn_seqfile_scan(path.encode(), 0, empty, empty, empty, empty)
    _scan_error(path, n)
    return int(n)


def seqfile_scan(path: str):
    """(key_off, key_len, val_off, val_len) int64 arrays of every record of
    one BTSF file; ``ValueError`` on a bad magic or a truncated record."""
    empty = np.empty(0, np.int64)
    n = lib().bn_seqfile_scan(path.encode(), 0, empty, empty, empty, empty)
    _scan_error(path, n)
    arrays = [np.empty(n, np.int64) for _ in range(4)]
    m = lib().bn_seqfile_scan(path.encode(), n, *arrays)
    _scan_error(path, m)
    m = min(m, n)                 # a file that shrank between the passes
    return tuple(a[:m] for a in arrays)


# -- JPEG (libjpeg) -----------------------------------------------------------

def has_jpeg() -> bool:
    """True when the loaded library was built against libjpeg."""
    return bool(lib().bn_has_jpeg())


def jpeg_decode(data: bytes, min_short: int = 0, with_orig_dims=False):
    """JPEG bytes -> RGB uint8 (h, w, 3), or None where the library has no
    libjpeg or the stream is not a decodable JPEG (a truncated scan
    included: libjpeg's warnings count as failure).  ``min_short`` > 0
    decodes at the largest 1/2^k DCT scale that keeps the shorter edge at
    least ``min_short``; ``with_orig_dims`` also returns the file's own
    (h, w), from which a resize target is computed."""
    lb = lib()
    if not lb.bn_has_jpeg():
        return None
    hw = np.empty(4, np.int64)
    denom = lb.bn_jpeg_probe(data, len(data), min_short, hw)
    if denom < 0:
        return None
    out = np.empty((int(hw[0]), int(hw[1]), 3), np.uint8)
    if lb.bn_jpeg_decode(data, len(data), denom, out,
                         int(hw[0]), int(hw[1])) != 0:
        return None
    if with_orig_dims:
        return out, (int(hw[2]), int(hw[3]))
    return out


def u8rgb_resize_bgr(img: np.ndarray, dh: int, dw: int,
                     normalize: float = 1.0) -> np.ndarray:
    """(sh, sw, 3) uint8 RGB -> (dh, dw, 3) float32 BGR times 1/normalize
    in one pass (bilinear, in float, where the size changes)."""
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((dh, dw, 3), np.float32)
    lib().bn_u8rgb_resize_bgr(img, img.shape[0], img.shape[1], out,
                              dh, dw, 1.0 / float(normalize))
    return out


def u8rgb_resize_bgr_plain(img: np.ndarray, dh: int, dw: int,
                           normalize: float = 1.0) -> np.ndarray:
    inv = np.float32(1.0 / float(normalize))
    x = np.asarray(img, np.uint8).astype(np.float32)
    sh, sw = x.shape[:2]
    if (sh, sw) == (dh, dw):
        return x[..., ::-1] * inv
    y0, y1, wy = _taps(sh, dh)
    x0, x1, wx = _taps(sw, dw)
    wx = wx.astype(np.float32)[None, :, None]
    wy = wy.astype(np.float32)[:, None, None]
    r0, r1 = x[y0], x[y1]
    top = r0[:, x0] + (r0[:, x1] - r0[:, x0]) * wx
    bot = r1[:, x0] + (r1[:, x1] - r1[:, x0]) * wx
    return ((top + (bot - top) * wy) * inv)[..., ::-1]
