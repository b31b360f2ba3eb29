"""Image types and transformers (``bigdl_tpu/dataset/image.py``).

Parity: ``dataset/image/`` (SURVEY.md section 2.4): ``BytesToGreyImg``,
``GreyImgNormalizer``, ``GreyImgCropper``, ``GreyImgToBatch``,
``BytesToBGRImg``, ``BGRImgCropper``, ``BGRImgRdmCropper``,
``BGRImgNormalizer``, ``BGRImgPixelNormalizer``, ``HFlip``, ``ColorJitter``,
``Lighting`` (PCA noise), ``BGRImgToBatch``, ``BGRImgToImageVector``,
``LocalImgReader`` and the image types ``LabeledGreyImage``/
``LabeledBGRImage``.

Representation: a labeled image is (float32 ndarray HxW or HxWx3, label);
batching emits NCHW MiniBatches (Torch layout parity).  Everything here
runs on the host, with the JAX package's ``np.random.RandomState`` draws,
so the random crops, flips and jitters are the reference's for the same
seed; the trainer or validator copies each batch to its device.  The hot
loops (``BGRImgNormalizer``, ``HFlip``, ``BGRImgToBatch``'s pack) run in
the native host library (``bigdl_tpu_torch.native``, outside the
interpreter lock) on an image of at least ``native.MIN_VALUES`` values, and
in numpy below it, where the ctypes call costs more than the loop; the two
are bit-equal.  ``BytesToBGRImg``'s planar-to-HWC decode stays numpy's,
which is faster than the native loop at every size measured.

``LocalImgReader`` decodes a ``.jpg``/``.jpeg`` file through the native
libjpeg path (a scaled IFAST decode, then one fused bilinear resize to BGR,
the reference's fast path) where the library has libjpeg; PNG files with
the port's own decoder (``dataset/png.py``, the standard library's ``zlib``
and numpy); anything else through PIL, imported only then.  The PNG and
PIL paths resize with ``F.interpolate``'s antialiased bilinear filter on
uint8 (PIL's ``BILINEAR``: equal on an upscale, within 1 of 255 on a
downscale).
"""

from __future__ import annotations

import io
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch import native as _native
from bigdl_tpu_torch.dataset import png
from bigdl_tpu_torch.dataset.transformer import MiniBatch, Transformer

logger = logging.getLogger("bigdl_tpu_torch.dataset")


class LabeledImage:
    __slots__ = ("data", "label")

    def __init__(self, data: np.ndarray, label: float):
        self.data = data  # HxW (grey) or HxWxC float32
        self.label = label

    def width(self):
        return self.data.shape[1]

    def height(self):
        return self.data.shape[0]


LabeledGreyImage = LabeledImage
LabeledBGRImage = LabeledImage


class ByteRecord:
    """Raw bytes + label (``dataset/Types.scala:79-81``)."""

    __slots__ = ("data", "label")

    def __init__(self, data: bytes, label: float):
        self.data = data
        self.label = label


class BytesToGreyImg(Transformer):
    """row*col uint8 bytes -> grey image in [0,1]
    (``image/BytesToGreyImg.scala``)."""

    def __init__(self, row: int, col: int):
        self.row, self.col = row, col

    def apply(self, prev):
        for rec in prev:
            img = np.frombuffer(rec.data, np.uint8).astype(np.float32)
            img = img.reshape(self.row, self.col) / 255.0
            yield LabeledImage(img, rec.label)


class GreyImgNormalizer(Transformer):
    """(x - mean) / std; construct from a dataset to compute global stats
    (``image/GreyImgNormalizer.scala``)."""

    def __init__(self, mean: float, std: float):
        self.mean, self.std = float(mean), float(std)

    @staticmethod
    def from_dataset(dataset) -> "GreyImgNormalizer":
        total, total_sq, n = 0.0, 0.0, 0
        for img in dataset.data(train=False):
            total += float(img.data.sum())
            total_sq += float((img.data ** 2).sum())
            n += img.data.size
        mean = total / n
        std = float(np.sqrt(total_sq / n - mean * mean))
        return GreyImgNormalizer(mean, std)

    def apply(self, prev):
        for img in prev:
            yield LabeledImage((img.data - self.mean) / self.std, img.label)


class GreyImgCropper(Transformer):
    """Random crop to (cropW, cropH) (``image/GreyImgCropper.scala``)."""

    def __init__(self, crop_w: int, crop_h: int, seed: int = 0):
        self.crop_w, self.crop_h = crop_w, crop_h
        self._rng = np.random.RandomState(seed)

    def apply(self, prev):
        for img in prev:
            h, w = img.data.shape
            y0 = self._rng.randint(0, h - self.crop_h + 1)
            x0 = self._rng.randint(0, w - self.crop_w + 1)
            yield LabeledImage(
                img.data[y0:y0 + self.crop_h, x0:x0 + self.crop_w],
                img.label)


class GreyImgToBatch(Transformer):
    """Grey images -> (N,1,H,W) MiniBatch (``image/GreyImgToBatch.scala``)."""

    def __init__(self, batch_size: int, drop_last: bool = False):
        self.batch_size = batch_size
        self.drop_last = drop_last

    def apply(self, prev):
        imgs, labels = [], []
        for img in prev:
            imgs.append(img.data[None])  # add channel dim
            labels.append(img.label)
            if len(imgs) == self.batch_size:
                yield MiniBatch(np.stack(imgs).astype(np.float32),
                                np.asarray(labels, np.float32))
                imgs, labels = [], []
        if imgs and not self.drop_last:
            yield MiniBatch(np.stack(imgs).astype(np.float32),
                            np.asarray(labels, np.float32))


class BytesToBGRImg(Transformer):
    """3*row*col uint8 BGR bytes (three planes) -> HxWx3 float image
    (``image/BytesToBGRImg.scala``)."""

    def __init__(self, normalize: float = 255.0,
                 row: Optional[int] = None, col: Optional[int] = None):
        self.normalize = normalize
        self.row, self.col = row, col

    def apply(self, prev):
        for rec in prev:
            buf = np.frombuffer(rec.data, np.uint8)
            if self.row is not None:
                h, w = self.row, self.col
            else:  # CIFAR binary layout: 3 planes
                h = w = int(np.sqrt(buf.size // 3))
            img = (buf.reshape(3, h, w).transpose(1, 2, 0)
                   .astype(np.float32) / self.normalize)
            yield LabeledImage(img, rec.label)


class BGRImgNormalizer(Transformer):
    """Per-channel (x - mean) / std over BGR (``image/BGRImgNormalizer``)."""

    def __init__(self, mean: Tuple[float, float, float],
                 std: Tuple[float, float, float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    @staticmethod
    def from_dataset(dataset) -> "BGRImgNormalizer":
        total = np.zeros(3)
        total_sq = np.zeros(3)
        n = 0
        for img in dataset.data(train=False):
            total += img.data.sum(axis=(0, 1))
            total_sq += (img.data ** 2).sum(axis=(0, 1))
            n += img.data.shape[0] * img.data.shape[1]
        mean = total / n
        std = np.sqrt(total_sq / n - mean ** 2)
        return BGRImgNormalizer(tuple(mean), tuple(std))

    def apply(self, prev):
        for img in prev:
            if img.data.ndim == 3 and _native.pays(img.data):
                out = _native.normalize(img.data, self.mean, self.std)
            else:
                out = _native.normalize_plain(img.data, self.mean, self.std)
            yield LabeledImage(out, img.label)


class BGRImgPixelNormalizer(Transformer):
    """Subtract a per-pixel mean image (``image/BGRImgPixelNormalizer``)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def apply(self, prev):
        for img in prev:
            yield LabeledImage(img.data - self.means, img.label)


class BGRImgCropper(Transformer):
    """Random (train) or center crop (``image/BGRImgCropper.scala``,
    ``BGRImgRdmCropper``)."""

    def __init__(self, crop_width: int, crop_height: int,
                 center: bool = False, padding: int = 0, seed: int = 0):
        self.crop_w, self.crop_h = crop_width, crop_height
        self.center = center
        self.padding = padding
        self._rng = np.random.RandomState(seed)

    def apply(self, prev):
        for img in prev:
            if self.padding:
                p = self.padding
                img = LabeledImage(
                    np.pad(img.data, ((p, p), (p, p)) +
                           ((0, 0),) * (img.data.ndim - 2)),
                    img.label)
            h, w = img.data.shape[:2]
            if self.center:
                y0 = (h - self.crop_h) // 2
                x0 = (w - self.crop_w) // 2
            else:
                y0 = self._rng.randint(0, h - self.crop_h + 1)
                x0 = self._rng.randint(0, w - self.crop_w + 1)
            yield LabeledImage(
                img.data[y0:y0 + self.crop_h, x0:x0 + self.crop_w],
                img.label)


class HFlip(Transformer):
    """Random horizontal flip (``image/HFlip.scala``)."""

    def __init__(self, threshold: float = 0.5, seed: int = 0):
        self.threshold = threshold
        self._rng = np.random.RandomState(seed)

    def apply(self, prev):
        for img in prev:
            if self._rng.rand() < self.threshold:
                flip = _native.hflip if _native.pays(img.data) else \
                    _native.hflip_plain
                yield LabeledImage(flip(img.data), img.label)
            else:
                yield img


class ColorJitter(Transformer):
    """Random brightness/contrast/saturation in random order
    (``image/ColorJitter.scala``)."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, seed: int = 0):
        self.brightness, self.contrast = brightness, contrast
        self.saturation = saturation
        self._rng = np.random.RandomState(seed)

    def _grs(self, img):  # grayscale via BGR luma
        return (0.114 * img[..., 0] + 0.587 * img[..., 1] +
                0.299 * img[..., 2])[..., None]

    def apply(self, prev):
        for img in prev:
            x = img.data
            ops = [0, 1, 2]
            self._rng.shuffle(ops)
            for op in ops:
                if op == 0 and self.brightness > 0:
                    a = 1.0 + self._rng.uniform(-self.brightness,
                                                self.brightness)
                    x = x * a
                elif op == 1 and self.contrast > 0:
                    a = 1.0 + self._rng.uniform(-self.contrast,
                                                self.contrast)
                    x = x * a + (1 - a) * self._grs(x).mean()
                elif op == 2 and self.saturation > 0:
                    a = 1.0 + self._rng.uniform(-self.saturation,
                                                self.saturation)
                    x = x * a + (1 - a) * self._grs(x)
            yield LabeledImage(x.astype(np.float32), img.label)


class Lighting(Transformer):
    """AlexNet-style PCA lighting noise (``image/Lighting.scala``), using
    the standard ImageNet eigen decomposition."""

    EIG_VAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
    # rows are channels (BGR = standard RGB matrix with rows reversed);
    # columns stay in eigenvalue order so EIG_VAL pairs correctly
    EIG_VEC = np.array([[-0.5836, -0.6948, 0.4203],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5675, 0.7192, 0.4009]], np.float32)

    def __init__(self, alphastd: float = 0.1, seed: int = 0):
        self.alphastd = alphastd
        self._rng = np.random.RandomState(seed)

    def apply(self, prev):
        for img in prev:
            alpha = self._rng.normal(0, self.alphastd, 3).astype(np.float32)
            noise = (self.EIG_VEC * alpha * self.EIG_VAL).sum(axis=1)
            yield LabeledImage(img.data + noise[None, None, :], img.label)


class BGRImgToBatch(Transformer):
    """BGR images -> (N,3,H,W) MiniBatch (``image/BGRImgToBatch.scala``),
    each image packed into its CHW slot of one C-contiguous NCHW buffer by
    the native pack where it pays (``native=False``: numpy's copy)."""

    def __init__(self, batch_size: int, to_rgb: bool = False,
                 drop_last: bool = False, native: bool = True):
        self.batch_size = batch_size
        self.to_rgb = to_rgb
        self.drop_last = drop_last
        self.native = native

    def _emit(self, imgs, labels):
        pack = _native.pack_chw if self.native and _native.pays(imgs[0]) \
            else _native.pack_chw_plain
        h, w, c = imgs[0].shape
        batch = np.empty((len(imgs), c, h, w), np.float32)
        for i, x in enumerate(imgs):
            pack(x, batch[i], to_rgb=self.to_rgb)
        return MiniBatch(batch, np.asarray(labels, np.float32))

    def apply(self, prev):
        imgs, labels = [], []
        for img in prev:
            imgs.append(img.data)
            labels.append(img.label)
            if len(imgs) == self.batch_size:
                yield self._emit(imgs, labels)
                imgs, labels = [], []
        if imgs and not self.drop_last:
            yield self._emit(imgs, labels)


class LocalImgReader(Transformer):
    """Read image files into scaled BGR ``LabeledImage``s
    (``image/LocalImgReader.scala``; the reference scales via java awt, the
    JAX package via PIL).  Input elements are ``(path, label)`` pairs or
    ``LocalImgPath`` style objects with ``.path``/``.label``.

    ``scale_to``: resize so the shorter edge equals this (keeping aspect),
    the reference's ``smallSideSize`` behavior; 0 disables resizing, and an
    image already at its target size is not resampled.  A ``.jpg``/``.jpeg``
    file decodes through the native libjpeg path where the library has
    libjpeg (``_read_native``: a scaled IFAST decode, then one fused
    bilinear resize to BGR over 1/normalize; within a few levels of PIL's
    ISLOW decode and antialiased resize); a file that path declines (no
    libjpeg, not a JPEG) goes to ``decode_rgb``: PNG through
    ``dataset/png.py``, anything else through PIL, imported only then.
    """

    def __init__(self, scale_to: int = 256, normalize: float = 1.0):
        self.scale_to = scale_to
        self.normalize = normalize

    @staticmethod
    def _short_edge_dims(h: int, w: int, scale_to: int):
        if w < h:
            return int(round(h * scale_to / w)), scale_to
        return scale_to, int(round(w * scale_to / h))

    def _read(self, path: str) -> np.ndarray:
        bgr = self._read_native(path)
        if bgr is not None:
            return bgr
        rgb = decode_rgb(path)
        if self.scale_to:
            h, w = rgb.shape[:2]
            rgb = resize_bilinear(rgb, *self._short_edge_dims(
                h, w, self.scale_to))
        return rgb[..., ::-1].astype(np.float32) / self.normalize  # -> BGR

    def _read_native(self, path: str):
        """The libjpeg path (``bigdl_tpu/dataset/image.py`` ``_read_native``):
        decoded at the largest 1/2^k DCT scale that keeps the shorter edge
        at least ``scale_to``, the resize target taken from the file's own
        size; None where the file is not a ``.jpg``/``.jpeg`` the library
        can decode (no libjpeg, another format, a truncated scan)."""
        if not path.lower().endswith((".jpg", ".jpeg")) or \
                not _native.has_jpeg():
            return None
        with open(path, "rb") as f:
            data = f.read()
        decoded = _native.jpeg_decode(data, min_short=self.scale_to,
                                      with_orig_dims=True)
        if decoded is None:
            return None
        img, (oh, ow) = decoded
        nh, nw = self._short_edge_dims(oh, ow, self.scale_to) \
            if self.scale_to else img.shape[:2]
        return _native.u8rgb_resize_bgr(img, nh, nw, self.normalize)

    def apply(self, prev):
        for item in prev:
            if hasattr(item, "path"):
                path, label = item.path, getattr(item, "label", 0.0)
            else:
                path, label = item
            yield LabeledImage(self._read(path), float(label))


def decode_rgb(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8 RGB, as PIL's ``convert("RGB")``
    gives it: PNG through ``dataset/png.py``, anything else through PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if png.is_png(data):
        return png.decode_png(data)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path} is neither a PNG file nor a JPEG file the native "
            "libjpeg path decoded: reading it needs PIL (Pillow), which is "
            "not installed") from e
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def resize_bilinear(rgb: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, 3) uint8 resized to (h, w) by the antialiased bilinear filter
    of ``F.interpolate`` on uint8 (PIL's ``BILINEAR``); an image already
    (h, w) comes back unchanged."""
    if rgb.shape[:2] == (h, w):
        return rgb
    x = torch.from_numpy(np.ascontiguousarray(rgb)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=True)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def image_folder_paths(folder: str):
    """(path, 1-based class label) pairs from a folder-per-class tree
    (``DataSet.ImageFolder.paths`` parity); class order is sorted name."""
    classes = sorted(d for d in os.listdir(folder)
                     if os.path.isdir(os.path.join(folder, d)))
    out = []
    for i, c in enumerate(classes):
        cdir = os.path.join(folder, c)
        for f in sorted(os.listdir(cdir)):
            p = os.path.join(cdir, f)
            if os.path.isfile(p):
                out.append((p, float(i + 1)))
    return out


def BGRImgRdmCropper(crop_height: int, crop_width: int, padding: int = 0,
                     seed: int = 0) -> BGRImgCropper:
    """Name-parity factory (``image/BGRImgRdmCropper.scala``): random crop
    with zero padding — the ResNet/CIFAR augmentation.  Note the
    reference's (height, width) argument order."""
    return BGRImgCropper(crop_width, crop_height, center=False,
                         padding=padding, seed=seed)


class BGRImgToImageVector(Transformer):
    """BGR image -> flat float feature vector
    (``image/BGRImgToImageVector.scala`` — the reference emits a Spark-ML
    DenseVector for the DLClassifier DataFrame path; here a flat numpy
    row for ``api.DLClassifier``)."""

    def apply(self, prev):
        for img in prev:
            # planar CHW order (the reference's BGRImage.copyTo layout):
            # DLClassifier reshapes flat features straight into an NCHW
            # batch shape, so interleaved HWC would scramble channels
            data = img.data
            if data.ndim == 3:
                data = data.transpose(2, 0, 1)
            yield {"features": np.ravel(data).astype(np.float32),
                   "label": img.label}
