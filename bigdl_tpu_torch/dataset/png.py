"""A PNG decoder on the standard library's ``zlib`` and numpy.

``LocalImgReader`` reads PNG files through :func:`read_png` on every
machine, with or without PIL, so the pixels the host hands the card are the
same wherever the port runs.  It decodes non-interlaced images of 1, 2, 4
or 8 bits a sample in grey (type 0), 8 bits in RGB (2), grey-alpha (4) and
RGBA (6), and 1-8 bit palette images (3), with any of the five row filters
(None, Sub, Up, Average, Paeth) and image data split over any number of
``IDAT`` chunks; every chunk's CRC is checked.  Interlaced (Adam7) and
16-bit files raise ``ValueError``.

:func:`read_png` returns what PIL's ``Image.open(path).convert("RGB")``
gives: an (H, W, 3) uint8 array, alpha dropped, grey replicated, a palette
looked up, sub-byte grey scaled to 0-255.

Row filters: the Sub, Average and Paeth filters predict a byte from the
reconstructed byte to its left, so a row is a sequential scan.  Rows of
None, Sub (a cumulative sum that wraps at 256) and Up are unfiltered a row
at a time.  An image with any Average or Paeth row is unfiltered along
anti-diagonals instead: each row is shifted right by its index, so pixel
(y, x) sits at column x + y, and its left, upper and upper-left neighbours
(columns x + y - 1, x + y - 1 and x + y - 2 of rows y and y - 1) are all
complete one or two columns earlier; each step then reconstructs one
column of the shifted image, every row at once, by its own filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def is_png(head: bytes) -> bool:
    return head[:8] == SIGNATURE


def _chunks(data: bytes):
    if not is_png(data):
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before its IEND chunk")


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(kinds, raw, bpp):
    """Rows of None, Sub and Up filters only, a row at a time."""
    out = np.empty_like(raw)
    prior = np.zeros(raw.shape[1], np.uint8)
    for y, kind in enumerate(kinds):
        row = raw[y]
        if kind == 0:
            out[y] = row
        elif kind == 1:
            # x_i = r_i + x_{i-bpp}: a cumulative sum over each byte lane,
            # wrapping at 256 in uint8
            lanes = row.reshape(-1, bpp)
            out[y] = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)
        else:
            out[y] = row + prior
        prior = out[y]
    return out


def _unfilter_diagonal(kinds, raw, bpp):
    """Any filters, along anti-diagonals of (pixel, byte lane) rows."""
    h, stride = raw.shape
    w = stride // bpp
    px = raw.reshape(h, w, bpp).astype(np.int32)
    # skewed planes: pixel (y, x) at [y + 1, x + y + 2]; row 0 and the two
    # leading columns stay zero (the prior row and left of the image)
    span = w + h + 2
    s = np.zeros((h + 1, span, bpp), np.int32)
    r = np.zeros((h, span, bpp), np.int32)
    rows = np.arange(h)[:, None]
    r[rows, np.arange(w)[None, :] + rows + 2] = px
    kinds = np.asarray(kinds)
    masks = [(kinds == k).astype(np.int32)[:, None] for k in range(5)]
    has = [np.concatenate([[0], np.cumsum(m[:, 0])]) for m in masks]
    for t in range(2, w + h + 1):
        lo, hi = max(0, t - 1 - w), min(h, t - 1)
        if lo >= hi:
            continue
        a = s[lo + 1:hi + 1, t - 1]
        b = s[lo:hi, t - 1]
        c = s[lo:hi, t - 2]
        pred = masks[1][lo:hi] * a + masks[2][lo:hi] * b
        if has[3][hi] > has[3][lo]:
            pred += masks[3][lo:hi] * ((a + b) >> 1)
        if has[4][hi] > has[4][lo]:
            pred += masks[4][lo:hi] * _paeth(a, b, c)
        s[lo + 1:hi + 1, t] = (r[lo:hi, t] + pred) & 0xFF
    out = s[1:][rows, np.arange(w)[None, :] + rows + 2]
    return out.astype(np.uint8).reshape(h, stride)


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    if buf.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {buf.size} bytes, want "
                         f"{h * (stride + 1)} ({h} rows of {stride} + 1)")
    buf = buf.reshape(h, stride + 1)
    kinds = buf[:, 0].tolist()
    if max(kinds, default=0) > 4:
        raise ValueError(f"unknown PNG row filter {max(kinds)}")
    raw = buf[:, 1:]
    if all(k <= 2 for k in kinds):
        return _unfilter_rows(kinds, raw, bpp)
    return _unfilter_diagonal(kinds, raw, bpp)


def _unpack(rows: np.ndarray, w: int, bits: int) -> np.ndarray:
    """(h, stride) bytes of sub-byte samples -> (h, w) sample values."""
    if bits == 8:
        return rows[:, :w]
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :w]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as PIL's ``convert("RGB")``."""
    header = None
    palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, bits, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"unknown PNG colour type {ctype}")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG files are not supported")
    if bits == 16:
        raise ValueError("16-bit PNG files are not supported")
    if bits != 8 and ctype not in (0, 3):
        raise ValueError(f"PNG colour type {ctype} at {bits} bits a sample")
    channels = _CHANNELS[ctype]
    stride = (w * channels * bits + 7) // 8
    bpp = max(1, channels * bits // 8)
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, bpp)
    if ctype in (2, 4, 6):
        px = rows.reshape(h, w, channels)
        return np.ascontiguousarray(
            px[..., :3] if ctype == 6 else
            np.repeat(px[..., :1], 3, axis=2) if ctype == 4 else px)
    samples = _unpack(rows, w, bits)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG file has no PLTE chunk")
        # an index past the palette reads black
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette
        return table[samples]
    grey = samples * np.uint8(255 // ((1 << bits) - 1))
    return np.repeat(grey[..., None], 3, axis=2)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray, filters=(0,), level: int = 6) -> bytes:
    """An 8-bit PNG of ``pixels`` ((H, W) grey or (H, W, C) with C 1, 2, 3
    or 4: grey, grey-alpha, RGB, RGBA); row y takes the row filter
    ``filters[y % len(filters)]`` (0-4)."""
    px = np.asarray(pixels, np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    x = px.reshape(h, w * c).astype(np.int32)
    left = np.zeros_like(x)
    left[:, c:] = x[:, :-c]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:] = left[:-1]
    preds = [np.zeros_like(x), left, up, (left + up) >> 1,
             _paeth(left, up, upleft)]
    kinds = np.asarray([filters[y % len(filters)] for y in range(h)])
    pred = np.choose(kinds[:, None], preds)
    rows = np.concatenate([kinds[:, None], (x - pred) & 0xFF], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.astype(np.uint8).tobytes(),
                                            level))
            + _chunk(b"IEND", b""))
