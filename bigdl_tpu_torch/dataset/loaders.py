"""Binary dataset file parsers (``bigdl_tpu/dataset/loaders.py``).

Parity: the MNIST idx-ubyte parsing in ``models/lenet/Utils.scala``
(``load(featureFile, labelFile)``) and the CIFAR-10 binary parsing in
``models/vgg/Utils.scala`` — pure-python equivalents producing
``ByteRecord`` streams.  Labels are **1-based** like the reference (Torch
class convention).
"""

from __future__ import annotations

import os
import struct
from typing import List

import numpy as np

from bigdl_tpu_torch.dataset.image import ByteRecord


def load_mnist(feature_file: str, label_file: str) -> List[ByteRecord]:
    """Parse idx3-ubyte images + idx1-ubyte labels into ByteRecords."""
    with open(label_file, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad label magic {magic}"
        labels = np.frombuffer(f.read(n), np.uint8)
    with open(feature_file, "rb") as f:
        magic, n2, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad image magic {magic}"
        assert n2 == n, "image/label count mismatch"
        raw = f.read(n * rows * cols)
    rec_len = rows * cols
    return [ByteRecord(raw[i * rec_len:(i + 1) * rec_len],
                       float(labels[i]) + 1.0) for i in range(n)]


def write_mnist(feature_file: str, label_file: str,
                images: np.ndarray, labels: np.ndarray) -> None:
    """Write idx files (test fixtures / data generation)."""
    images = np.asarray(images, np.uint8)
    labels = np.asarray(labels, np.uint8)
    n, rows, cols = images.shape
    with open(label_file, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())
    with open(feature_file, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols))
        f.write(images.tobytes())


# CIFAR-10 channel statistics (``models/vgg/Utils.scala:29-32``,
# ``models/resnet/DataSet.scala:39-42``) — shared by the vgg/resnet CLIs.
CIFAR10_TRAIN_MEAN = (0.4913996898739353, 0.4821584196221302,
                      0.44653092422369434)
CIFAR10_TRAIN_STD = (0.24703223517429462, 0.2434851308749409,
                     0.26158784442034005)
CIFAR10_TEST_MEAN = (0.4942142913295297, 0.4851314002725445,
                     0.45040910258647154)
CIFAR10_TEST_STD = (0.2466525177466614, 0.2428922662655766,
                    0.26159238066790275)


def load_cifar10(data_dir: str, train: bool = True) -> List[ByteRecord]:
    """Parse CIFAR-10 binary batches (1 label byte + 3072 RGB plane bytes
    per record).  Stored planes are RGB; the reference's pipeline treats
    images as BGR, so the planes are reordered here."""
    files = [f"data_batch_{i}.bin" for i in range(1, 6)] if train \
        else ["test_batch.bin"]
    records = []
    for fname in files:
        path = os.path.join(data_dir, fname)
        with open(path, "rb") as f:
            buf = f.read()
        rec = 3073
        for i in range(len(buf) // rec):
            chunk = buf[i * rec:(i + 1) * rec]
            label = float(chunk[0]) + 1.0
            img = np.frombuffer(chunk[1:], np.uint8).reshape(3, 32, 32)
            bgr = img[::-1]  # RGB planes -> BGR planes
            records.append(ByteRecord(bgr.tobytes(), label))
    return records


def write_cifar10_batch(path: str, images: np.ndarray,
                        labels: np.ndarray) -> None:
    """images: (N,3,32,32) uint8 RGB planes; labels: (N,) 0-based."""
    with open(path, "wb") as f:
        for img, lab in zip(np.asarray(images, np.uint8),
                            np.asarray(labels, np.uint8)):
            f.write(bytes([int(lab)]))
            f.write(img.tobytes())
