"""MNIST idx-ubyte reading with the reference python binding's API
(``bigdl_tpu/dataset/mnist.py``).

Parity: ``dl/src/main/python/dataset/mnist.py`` (``extract_images``,
``extract_labels``, ``read_data_sets``, the dataset mean/std constants).
Returns uint8 arrays shaped ``(N, 28, 28, 1)`` / ``(N,)`` like the
reference; feed them to ``DataSet.array`` + ``transformer.normalizer`` or
convert to ``ByteRecord``s via ``loaders.load_mnist`` for the image
pipeline.

Accepts both gzipped (``*.gz``, the distributed form) and raw idx files.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from bigdl_tpu_torch.dataset import base

SOURCE_URL = "http://yann.lecun.com/exdb/mnist/"

TRAIN_MEAN = 0.13066047740239506
TRAIN_STD = 0.3081078
TEST_MEAN = 0.13251460696903547
TEST_STD = 0.31048024

_IMAGE_MAGIC = 2051
_LABEL_MAGIC = 2049


def _open_stream(f):
    """File object -> decompressed byte stream (gzip sniffed by magic)."""
    head = f.read(2)
    f.seek(0)
    if head == b"\x1f\x8b":
        return gzip.GzipFile(fileobj=f)
    return f


def _read32(stream) -> int:
    return struct.unpack(">I", stream.read(4))[0]


def extract_images(f) -> np.ndarray:
    """idx3-ubyte file object -> uint8 array (N, rows, cols, 1)."""
    stream = _open_stream(f)
    magic = _read32(stream)
    if magic != _IMAGE_MAGIC:
        raise ValueError(
            f"invalid magic {magic} in MNIST image file "
            f"{getattr(f, 'name', '<stream>')}")
    n, rows, cols = _read32(stream), _read32(stream), _read32(stream)
    data = np.frombuffer(stream.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols, 1)


def extract_labels(f) -> np.ndarray:
    """idx1-ubyte file object -> uint8 array (N,)."""
    stream = _open_stream(f)
    magic = _read32(stream)
    if magic != _LABEL_MAGIC:
        raise ValueError(
            f"invalid magic {magic} in MNIST label file "
            f"{getattr(f, 'name', '<stream>')}")
    n = _read32(stream)
    return np.frombuffer(stream.read(n), np.uint8)


def read_data_sets(train_dir: str, data_type: str = "train"):
    """(images, labels) for the requested split, fetching the canonical
    ``.gz`` files into ``train_dir`` if absent (see ``base.maybe_download``
    for offline behavior).  Falls back to already-staged raw idx files
    (``train-images-idx3-ubyte`` etc.) before attempting any download."""
    import os

    if data_type == "train":
        img_name, lbl_name = ("train-images-idx3-ubyte",
                              "train-labels-idx1-ubyte")
    else:
        img_name, lbl_name = ("t10k-images-idx3-ubyte",
                              "t10k-labels-idx1-ubyte")

    paths = []
    for name in (img_name, lbl_name):
        raw = os.path.join(train_dir, name)
        if os.path.exists(raw):
            paths.append(raw)
        else:
            paths.append(base.maybe_download(name + ".gz", train_dir,
                                             SOURCE_URL + name + ".gz"))
    with open(paths[0], "rb") as f:
        images = extract_images(f)
    with open(paths[1], "rb") as f:
        labels = extract_labels(f)
    return images, labels
