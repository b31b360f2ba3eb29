"""The port's image pipeline (``bigdl_tpu_torch.dataset.image``) and PNG
decoder (``bigdl_tpu_torch.dataset.png``) against the JAX package's.

Every transformer gets the same arrays and seeds on both sides
(``np.random.RandomState`` draws: the random crops, flips, jitters and
lighting noise are the reference's); outputs are equal, or within rtol
1e-6 / atol 1e-6 where the reference runs its native helpers (a per-channel
normalization by another instruction order).  ``LocalImgReader`` reads
PNG files PIL writes (grey, RGB, palette, RGBA, grey-alpha, sub-byte
palettes, PIL's per-row filter choice) and files whose rows cycle through
the five PNG filters: its pixels equal the reference's (PIL) exactly where
no resize runs, and within 1 of 255 where one runs, on at most 2 % of the
values (0-0.64 % on these files).  With PIL blocked (a subprocess with
``sys.modules["PIL"] = None``), a PNG still reads, a JPEG reads through the
native libjpeg path where the host library has libjpeg (else it raises the
``ImportError`` that names PIL), and a file of another format (BMP) raises
that ``ImportError``.  A ``.jpg`` read through ``LocalImgReader`` is the
native path's output, bit for bit, within 0.03 of the range of PIL's
decode on average where the library has libjpeg, and PIL's exactly where it has not.
Mirrors ``tests/test_dataset.py:24-95, 147-165``.
"""

import io
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset import image as timage
from bigdl_tpu_torch.dataset import png

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESIZE_SHARE = 0.02     # values that differ by 1 after a resize, at most


def _grey_records(mod, n=6, seed=0):
    rs = np.random.RandomState(seed)
    imgs = rs.randint(0, 256, (n, 12, 10)).astype(np.uint8)
    return [mod.ByteRecord(im.tobytes(), float(i % 3 + 1))
            for i, im in enumerate(imgs)]


def _bgr_images(mod, n=5, h=12, w=10, seed=1):
    rs = np.random.RandomState(seed)
    return [mod.LabeledImage(rs.rand(h, w, 3).astype(np.float32) * 255,
                             float(i + 1)) for i in range(n)]


def _same(got, want, exact=True):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            np.testing.assert_array_equal(g["features"], w["features"])
            assert g["label"] == w["label"]
            continue
        gd, wd = (g.data, w.data) if hasattr(w, "data") else (g, w)
        assert np.asarray(gd).dtype == np.asarray(wd).dtype
        if exact:
            np.testing.assert_array_equal(gd, wd)
        else:
            np.testing.assert_allclose(gd, wd, rtol=1e-6, atol=1e-6)
        if hasattr(w, "labels"):
            np.testing.assert_array_equal(g.labels, w.labels)
        elif hasattr(w, "label"):
            assert g.label == w.label


# (name, transformer(mod), input(mod), exact)
GREY = {
    "bytes-to-grey": (lambda m: m.BytesToGreyImg(12, 10), True),
    "grey-normalizer": (lambda m: m.BytesToGreyImg(12, 10) >>
                        m.GreyImgNormalizer(0.4, 0.3), True),
    "grey-cropper": (lambda m: m.BytesToGreyImg(12, 10) >>
                     m.GreyImgCropper(7, 5, seed=3), True),
    "grey-to-batch": (lambda m: m.BytesToGreyImg(12, 10) >>
                      m.GreyImgToBatch(4), True),
    "grey-to-batch-drop-last": (lambda m: m.BytesToGreyImg(12, 10) >>
                                m.GreyImgToBatch(4, drop_last=True), True),
}


@pytest.mark.parametrize("name", sorted(GREY))
def test_grey_transformers(name):
    make, exact = GREY[name]
    _same(make(timage)(_grey_records(timage)),
          make(jimage)(_grey_records(jimage)), exact)


BGR = {
    "bgr-normalizer": (lambda m: m.BGRImgNormalizer((100, 110, 120),
                                                    (50, 60, 70)), False),
    "pixel-normalizer": (lambda m: m.BGRImgPixelNormalizer(
        np.random.RandomState(5).rand(12, 10, 3) * 100), True),
    "random-cropper": (lambda m: m.BGRImgCropper(7, 5, seed=4), True),
    "center-cropper": (lambda m: m.BGRImgCropper(7, 5, center=True), True),
    "padded-cropper": (lambda m: m.BGRImgCropper(10, 12, padding=3, seed=2),
                       True),
    "rdm-cropper": (lambda m: m.BGRImgRdmCropper(8, 6, padding=2, seed=6),
                    True),
    "hflip": (lambda m: m.HFlip(0.5, seed=7), True),
    "color-jitter": (lambda m: m.ColorJitter(0.4, 0.4, 0.4, seed=8), True),
    "lighting": (lambda m: m.Lighting(0.1, seed=9), True),
    "to-batch": (lambda m: m.BGRImgToBatch(2), True),
    "to-batch-rgb-drop-last": (lambda m: m.BGRImgToBatch(2, to_rgb=True,
                                                         drop_last=True),
                               True),
    "to-image-vector": (lambda m: m.BGRImgToImageVector(), True),
    "chain": (lambda m: m.BGRImgNormalizer((0.5, 0.5, 0.5), (2, 2, 2)) >>
              m.BGRImgCropper(8, 8, seed=1) >> m.HFlip(0.5, seed=2) >>
              m.ColorJitter(seed=3) >> m.Lighting(0.1, seed=4) >>
              m.BGRImgToBatch(2), False),
}


@pytest.mark.parametrize("name", sorted(BGR))
def test_bgr_transformers(name):
    make, exact = BGR[name]
    _same(make(timage)(_bgr_images(timage)),
          make(jimage)(_bgr_images(jimage)), exact)


@pytest.mark.parametrize("shape", [(3, 32, 32), (3, 6, 9)],
                         ids=["cifar", "row-col"])
def test_bytes_to_bgr(shape):
    rs = np.random.RandomState(2)
    raw = rs.randint(0, 256, (4,) + shape).astype(np.uint8)
    kw = {} if shape[1] == shape[2] else {"row": shape[1], "col": shape[2]}

    def run(m):
        recs = [m.ByteRecord(r.tobytes(), 1.0) for r in raw]
        return list(m.BytesToBGRImg(255.0, **kw)(recs))
    _same(run(timage), run(jimage), exact=False)


@pytest.mark.parametrize("kind", ["grey", "bgr"])
def test_normalizers_from_a_dataset(kind):
    if kind == "grey":
        got = timage.GreyImgNormalizer.from_dataset(
            DataSet.array(_grey_records(timage)) >> timage.BytesToGreyImg(
                12, 10))
        want = jimage.GreyImgNormalizer.from_dataset(
            JDataSet.array(_grey_records(jimage)) >> jimage.BytesToGreyImg(
                12, 10))
    else:
        got = timage.BGRImgNormalizer.from_dataset(
            DataSet.array(_bgr_images(timage)))
        want = jimage.BGRImgNormalizer.from_dataset(
            JDataSet.array(_bgr_images(jimage)))
    np.testing.assert_array_equal(got.mean, want.mean)
    np.testing.assert_array_equal(got.std, want.std)


@pytest.mark.parametrize("to_rgb", [False, True])
def test_batches_are_nchw_in_order(to_rgb):
    """``np.stack`` of HWC images transposed to CHW keeps their memory
    order (a channels-last batch, which the card's convolutions keep
    channels-last); the port's batch is C-contiguous NCHW."""
    imgs = _bgr_images(timage, n=3)
    got = next(iter(timage.BGRImgToBatch(3, to_rgb=to_rgb)(imgs))).data
    assert got.flags.c_contiguous and got.shape == (3, 3, 12, 10)
    raw = np.stack([i.data.transpose(2, 0, 1) for i in imgs])
    assert not raw.flags.c_contiguous
    want = raw[:, ::-1] if to_rgb else raw
    np.testing.assert_array_equal(got, want)


def test_image_folder_paths(tmp_path):
    for cls in ("dog", "cat", "ant"):
        (tmp_path / cls).mkdir()
        for i in range(2):
            (tmp_path / cls / f"{i}.png").write_bytes(b"x")
    (tmp_path / "stray.txt").write_text("not a class")
    got = timage.image_folder_paths(str(tmp_path))
    assert got == jimage.image_folder_paths(str(tmp_path))
    assert [lbl for _, lbl in got] == [1.0, 1.0, 2.0, 2.0, 3.0, 3.0]


# -- PNG files and LocalImgReader -------------------------------------------

def _pil_file(folder, name, mode, h, w, seed, optimize=False):
    rs = np.random.RandomState(seed)
    # smooth content, so PIL's optimizer picks a mix of row filters
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 3 + yy) % 256, (yy * 2 + xx // 2) % 256,
                     (xx * yy) % 256], axis=2)
    arr = ((base + rs.randint(0, 9, (h, w, 3))) % 256).astype(np.uint8)
    im = Image.fromarray(arr)
    if mode == "P":
        im = im.quantize(256)
    elif mode == "P16":
        im = im.quantize(16)
    elif mode != "RGB":
        im = im.convert(mode)
    path = os.path.join(folder, name)
    im.save(path, "PNG", optimize=optimize)
    return path


def _encoded_file(folder, name, h, w, channels, filters, seed):
    rs = np.random.RandomState(seed)
    arr = rs.randint(0, 256, (h, w, channels)).astype(np.uint8)
    path = os.path.join(folder, name)
    with open(path, "wb") as f:
        f.write(png.encode_png(arr, filters))
    return path


def _filters_used(path):
    data = open(path, "rb").read()
    chunks = list(png._chunks(data))
    w, h, bits, ctype = png.struct.unpack(">IIBB", chunks[0][1][:10])
    stride = (w * png._CHANNELS[ctype] * bits + 7) // 8
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    return set(np.frombuffer(raw, np.uint8).reshape(h, stride + 1)[:, 0])


FILES = {
    "grey": lambda d: _pil_file(d, "grey.png", "L", 40, 50, 0),
    "rgb": lambda d: _pil_file(d, "rgb.png", "RGB", 40, 50, 1),
    "rgb-optimized": lambda d: _pil_file(d, "opt.png", "RGB", 40, 50, 2,
                                         optimize=True),
    "palette": lambda d: _pil_file(d, "pal.png", "P", 40, 50, 3),
    "palette-4-bit": lambda d: _pil_file(d, "pal16.png", "P16", 40, 50, 4),
    "rgba": lambda d: _pil_file(d, "rgba.png", "RGBA", 40, 50, 5),
    "grey-alpha": lambda d: _pil_file(d, "la.png", "LA", 40, 50, 6),
    "bilevel": lambda d: _pil_file(d, "one.png", "1", 40, 50, 7),
    "five-filters-rgb": lambda d: _encoded_file(d, "f5.png", 33, 47, 3,
                                                [0, 1, 2, 3, 4], 8),
    "five-filters-rgba": lambda d: _encoded_file(d, "f5a.png", 33, 47, 4,
                                                 [4, 3, 2, 1, 0], 9),
    "five-filters-grey": lambda d: _encoded_file(d, "f5g.png", 33, 47, 1,
                                                 [3, 4, 1, 0, 2], 10),
    "sub-up-only": lambda d: _encoded_file(d, "su.png", 33, 47, 3,
                                           [1, 2, 0], 11),
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_png_decodes_as_pil(tmp_path, name):
    path = FILES[name](str(tmp_path))
    want = np.asarray(Image.open(path).convert("RGB"))
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if name.startswith("five-filters"):
        assert _filters_used(path) == {0, 1, 2, 3, 4}


def test_pil_optimizer_and_large_files_use_several_filters_and_idats(
        tmp_path):
    path = _pil_file(str(tmp_path), "big.png", "RGB", 300, 300, 12,
                     optimize=True)
    assert len(_filters_used(path)) >= 3
    n_idat = sum(1 for k, _ in png._chunks(open(path, "rb").read())
                 if k == b"IDAT")
    assert n_idat > 1
    np.testing.assert_array_equal(png.read_png(path),
                                  np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("case", ["interlaced", "16-bit", "bad-crc",
                                  "not-png", "truncated"])
def test_png_refusals(tmp_path, case):
    arr = np.random.RandomState(0).randint(0, 256, (8, 8, 3)).astype(
        np.uint8)
    path = str(tmp_path / "x.png")
    if case == "interlaced":
        # PIL writes no interlaced file: the IHDR's interlace flag set by
        # hand (PIL reads such files)
        data = png.encode_png(arr)
        ihdr = png.struct.pack(">IIBBBBB", 8, 8, 8, 2, 0, 0, 1)
        with open(path, "wb") as f:
            f.write(data[:8] + png._chunk(b"IHDR", ihdr) + data[33:])
    elif case == "16-bit":
        Image.fromarray((arr[..., 0].astype(np.uint16) * 257)).save(path)
    else:
        data = png.encode_png(arr)
        data = {"bad-crc": data[:40] + bytes([data[40] ^ 1]) + data[41:],
                "not-png": b"GIF89a" + data[6:],
                "truncated": data[:-20]}[case]
        with open(path, "wb") as f:
            f.write(data)
    with pytest.raises(ValueError):
        png.read_png(path)


def _read_both(paths, scale_to, normalize=1.0):
    items = [(p, float(i + 1)) for i, p in enumerate(paths)]
    got = list(timage.LocalImgReader(scale_to, normalize)(items))
    want = list(jimage.LocalImgReader(scale_to, normalize)(items))
    return got, want


@pytest.mark.parametrize("name", sorted(FILES))
def test_local_img_reader_exact_without_a_resize(tmp_path, name):
    path = FILES[name](str(tmp_path))
    h, w = np.asarray(Image.open(path)).shape[:2]
    for scale_to in (0, min(h, w)):       # off, and already at the size
        got, want = _read_both([path], scale_to, normalize=255.0)
        _same(got, want)


SIZES = {"down-square": (300, 300), "down-wide": (480, 640),
         "down-tall": (341, 256), "up": (200, 500), "odd": (257, 199)}


@pytest.mark.parametrize("name", sorted(SIZES))
def test_local_img_reader_within_one_level_with_a_resize(tmp_path, name):
    h, w = SIZES[name]
    path = _pil_file(str(tmp_path), "r.png", "RGB", h, w, 13)
    got, want = _read_both([path], 256)
    g, r = got[0].data, want[0].data
    assert g.shape == r.shape and g.dtype == r.dtype == np.float32
    diff = np.abs(g - r)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() <= RESIZE_SHARE
    if name == "up":
        np.testing.assert_array_equal(g, r)
    assert got[0].label == want[0].label == 1.0


def test_short_edge_dims_round_as_the_reference():
    for h, w in [(300, 451), (451, 300), (255, 256), (333, 500), (7, 9)]:
        assert timage.LocalImgReader._short_edge_dims(h, w, 256) == \
            jimage.LocalImgReader._short_edge_dims(h, w, 256)


def test_local_img_reader_takes_path_objects(tmp_path):
    path = _pil_file(str(tmp_path), "a.png", "RGB", 20, 30, 14)

    class Item:
        def __init__(self, p):
            self.path, self.label = p, 3.0
    got = list(timage.LocalImgReader(0)([Item(path)]))
    assert got[0].label == 3.0
    np.testing.assert_array_equal(
        got[0].data, np.asarray(Image.open(path).convert("RGB"),
                                np.float32)[..., ::-1])


def test_png_reads_and_jpeg_refuses_without_pil(tmp_path):
    from bigdl_tpu_torch import native
    png_path = _pil_file(str(tmp_path), "a.png", "RGB", 20, 30, 15)
    jpg_path = str(tmp_path / "a.jpg")
    bmp_path = str(tmp_path / "a.bmp")
    Image.open(png_path).save(jpg_path, "JPEG")
    Image.open(png_path).save(bmp_path, "BMP")
    want = np.asarray(Image.open(png_path).convert("RGB"))[..., ::-1]
    np.save(str(tmp_path / "want.npy"), want.astype(np.float32))
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from bigdl_tpu_torch.dataset import LocalImgReader\n"
        f"got = list(LocalImgReader(0)([({png_path!r}, 1.0)]))[0].data\n"
        f"assert np.array_equal(got, np.load({str(tmp_path / 'want.npy')!r}))\n"
        f"for path in ({jpg_path!r}, {bmp_path!r}):\n"
        "    try:\n"
        "        img = list(LocalImgReader(0)([(path, 1.0)]))[0].data\n"
        "        print('read:', path[-3:], img.shape)\n"
        "    except ImportError as e:\n"
        "        print('refused:', path[-3:], e)\n"
        "assert 'PIL.Image' not in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    if native.has_jpeg():
        assert lines[0] == "read: jpg (20, 30, 3)"
    else:
        assert lines[0].startswith("refused: jpg") and "PIL" in lines[0]
    assert lines[1].startswith("refused: bmp") and "PIL" in lines[1]
    assert "item 11" not in out.stdout


def test_jpeg_goes_through_pil_when_it_is_there(tmp_path):
    from bigdl_tpu_torch import native
    png_path = _pil_file(str(tmp_path), "a.png", "RGB", 24, 32, 16)
    jpg_path = str(tmp_path / "a.jpg")
    Image.open(png_path).save(jpg_path, "JPEG", quality=95)
    got = list(timage.LocalImgReader(0)([(jpg_path, 2.0)]))[0]
    want = np.asarray(Image.open(jpg_path).convert("RGB"), np.float32)
    if not native.has_jpeg():
        np.testing.assert_array_equal(got.data, want[..., ::-1])
        return
    # the native path's output bit for bit, and PIL's within the IFAST
    # decode and plain chroma upsampling: 0.03 of the range on average
    # (the reference's bound, tests/test_native.py)
    with open(jpg_path, "rb") as f:
        rgb = native.jpeg_decode(f.read())
    np.testing.assert_array_equal(
        got.data, native.u8rgb_resize_bgr(rgb, 24, 32, 1.0))
    assert got.data.shape == want.shape
    assert np.abs(got.data - want[..., ::-1]).mean() < 0.03 * 255


def test_png_encoder_round_trip_through_pil():
    rs = np.random.RandomState(17)
    for c in (1, 2, 3, 4):
        arr = rs.randint(0, 256, (9, 13, c)).astype(np.uint8)
        data = png.encode_png(arr, [0, 1, 2, 3, 4])
        im = Image.open(io.BytesIO(data))
        np.testing.assert_array_equal(np.asarray(im).reshape(arr.shape), arr)
