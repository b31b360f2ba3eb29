"""The port's native host helpers (``bigdl_tpu_torch/native.py``, built
from ``bigdl_tpu_torch/csrc/host/bigdl_native.cpp``) against their numpy
plain versions and the JAX package's ``bigdl_tpu.native``.

Mirrors ``tests/test_native.py`` case for case.  Tolerances: every helper
is bit-equal to its plain version (``<name>_plain``; ``pack_chw`` with a
mean and a std too, as both multiply by ``1 / std``) and to the
reference's library on the same seeded input, and so is each symbol the
port does not wrap (the fp16 codec, the planar-bytes decode, crop, the
float resize; reached through ctypes); the MT19937 streams (the
scalar draws, the array draws, ``shuffle_indices``, the state round trips)
are equal, native and ``force_python=True``, to each other and to the
reference's ``RandomGenerator``; the libjpeg decode is bit-equal to the
reference's and within 2 levels on average of PIL's (IFAST against
ISLOW), the reader's fused decode and resize within 0.03 of the range on
average of PIL's path (the reference's bound).  The JPEG fixtures are the
seeded files under ``tests/data/torch_port/`` (``make_fixtures.py``).
"""

import glob
import io
import os

import numpy as np
import pytest

from bigdl_tpu import native as jnative
from bigdl_tpu.utils.random_generator import RandomGenerator as JRNG
from bigdl_tpu_torch import native
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_port")


def _ref_native():
    if not jnative.available():
        pytest.skip("the reference's native library is not built here")
    return jnative


def test_library_builds_under_build_and_loads():
    path = native.library_path()
    assert path.is_file() and "build/bigdl_tpu_torch/host" in str(path)
    assert native.available()


def test_build_takes_the_first_variant_that_compiles(tmp_path,
                                                     monkeypatch):
    """The jpeg-less fallback: a variant that fails to link gives way to the
    next; the library lands under the hash of the source and the flags."""
    from bigdl_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "HOST_ROOT", tmp_path / "host")
    src = tmp_path / "h.cpp"
    src.write_text('extern "C" int h_which(void) {\n'
                   '#ifdef H_FIRST\n return 1;\n#else\n return 2;\n'
                   '#endif\n}\n')
    variants = [(["-DH_FIRST"], ["-lno_such_library_anywhere"]), ([], [])]
    lib = _build.build_host(src, "libh.so", variants)
    assert lib.parent.parent == tmp_path / "host"
    assert lib.parent.name == _build.host_hash(src, [a + b for a, b in
                                                     variants])
    import ctypes
    assert ctypes.CDLL(str(lib)).h_which() == 2
    assert [p.name for p in lib.parent.iterdir()] == ["libh.so"]
    assert _build.build_host(src, "libh.so", variants) == lib   # cached
    # a machine whose loader finds another libjpeg builds its own library
    flat = [a + b for a, b in variants]
    assert _build.host_hash(src, flat, "libjpeg.so.62") != \
        _build.host_hash(src, flat)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    from bigdl_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "HOST_ROOT", tmp_path / "host")
    src = tmp_path / "broken.cpp"
    src.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build "
                       "broken.cpp(.|\n)*error"):
        _build.build_host(src, "libb.so", native.BUILD_VARIANTS)
    assert not list((tmp_path / "host").rglob("*.so*"))


# The library's symbols that no transformer calls (the fp16 codec, the
# planar-bytes decode, crop, the float resize): the port wraps none of them,
# so the tests reach them through ctypes as ``bigdl_tpu/native.py`` does and
# hold them against numpy and the reference's library.

def _fp16_compress(x):
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    out = np.empty(x.shape, np.uint16)
    native.lib().bn_fp16_compress(x, x.size, out)
    return out


def _fp16_decompress(u):
    u = np.ascontiguousarray(u, np.uint16).reshape(-1)
    out = np.empty(u.shape, np.float32)
    native.lib().bn_fp16_decompress(u, u.size, out)
    return out


def _fp16_add(a, b):
    a = np.ascontiguousarray(a, np.uint16)
    b = np.ascontiguousarray(b, np.uint16)
    out = np.empty(a.shape, np.uint16)
    native.lib().bn_fp16_add(a, b, a.size, out)
    return out


def _fp16_compress_numpy(x):
    return (np.asarray(x, np.float32).view(np.uint32) >>
            np.uint32(16)).astype(np.uint16)


def _fp16_decompress_numpy(u):
    return (np.asarray(u, np.uint16).astype(np.uint32) <<
            np.uint32(16)).view(np.float32)


def _bytes_chw_to_hwc(raw, c, h, w, norm):
    out = np.empty((h, w, c), np.float32)
    native.lib().bn_bytes_chw_to_hwc(np.frombuffer(raw, np.uint8).copy(),
                                     c, h, w, norm, out)
    return out


def _crop(img, y0, x0, ch, cw):
    h, w, c = img.shape
    out = np.empty((ch, cw, c), np.float32)
    native.lib().bn_crop(np.ascontiguousarray(img, np.float32), h, w, c, y0,
                         x0, ch, cw, out)
    return out


def _resize_bilinear(img, dh, dw):
    sh, sw, c = img.shape
    out = np.empty((dh, dw, c), np.float32)
    native.lib().bn_resize_bilinear(np.ascontiguousarray(img, np.float32),
                                    sh, sw, c, out, dh, dw)
    return out


def _resize_bilinear_numpy(img, dh, dw):
    """The C loop in double: half-pixel centres, clamped taps."""
    x = np.asarray(img, np.float32).astype(np.float64)
    y0, y1, wy = native._taps(x.shape[0], dh)
    x0, x1, wx = native._taps(x.shape[1], dw)
    wx = wx[None, :, None]
    top = x[y0][:, x0] * (1 - wx) + x[y0][:, x1] * wx
    bot = x[y1][:, x0] * (1 - wx) + x[y1][:, x1] * wx
    return (top * (1 - wy[:, None, None]) +
            bot * wy[:, None, None]).astype(np.float32)


class TestFp16Codec:
    def test_roundtrip_truncation(self):
        x = np.random.RandomState(0).randn(4097).astype(np.float32)
        u = _fp16_compress(x)
        y = _fp16_decompress(u)
        # sign, exponent and 7 mantissa bits kept: relative error 2^-7
        assert np.all(np.abs(y - x) <= np.abs(x) * 2.0 ** -7)
        assert np.array_equal(_fp16_compress(y), u)
        assert np.array_equal(u, _fp16_compress_numpy(x))
        assert np.array_equal(y, _fp16_decompress_numpy(u))

    def test_matches_device_reference(self):
        from bigdl_tpu_torch.ops import fp16 as tfp16
        import torch
        x = np.random.RandomState(1).randn(1000).astype(np.float32)
        u = _fp16_compress(x)
        assert np.array_equal(u, _ref_native().fp16_compress(x))
        # the port's device codec's plain version, on the CPU
        got = tfp16.fp16_compress_reference(torch.from_numpy(x))
        assert np.array_equal(u, got.to(torch.int32).numpy())
        assert np.array_equal(_fp16_decompress(u),
                              jnative.fp16_decompress(u))
        assert np.array_equal(
            _fp16_decompress(u), tfp16.fp16_decompress_reference(
                torch.from_numpy(u.astype(np.int32)).to(torch.uint16))
            .numpy())

    def test_add_in_fp16_domain(self):
        a = np.float32([1.0, 2.5, -3.25])
        b = np.float32([0.5, 0.25, 1.25])
        ua, ub = _fp16_compress(a), _fp16_compress(b)
        s = _fp16_decompress(_fp16_add(ua, ub))
        expect = _fp16_decompress(
            _fp16_compress(_fp16_decompress(ua) + _fp16_decompress(ub)))
        assert np.array_equal(s, expect)
        rs = np.random.RandomState(3)
        ua = _fp16_compress(rs.randn(777).astype(np.float32))
        ub = _fp16_compress(rs.randn(777).astype(np.float32))
        assert np.array_equal(_fp16_add(ua, ub), _fp16_compress_numpy(
            _fp16_decompress_numpy(ua) + _fp16_decompress_numpy(ub)))
        assert np.array_equal(_fp16_add(ua, ub),
                              _ref_native().fp16_add(ua, ub))


class TestNativeRNGParity:
    def test_stream_parity_with_python(self):
        a = RandomGenerator(1234)
        b = RandomGenerator(1234, force_python=True)
        c = JRNG(1234)
        assert a._h is not None and b._h is None
        for _ in range(2000):        # across the 624-word reload
            u = a.uniform(0, 1)
            assert u == b.uniform(0, 1) == c.uniform(0, 1)
        for _ in range(51):   # an odd count: the Box-Muller pair cache
            v = a.normal(0, 1)
            assert v == b.normal(0, 1) == c.normal(0, 1)
        for _ in range(20):
            assert a.bernoulli(0.3) == b.bernoulli(0.3) == c.bernoulli(0.3)
            assert a.geometric(0.5) == b.geometric(0.5) == c.geometric(0.5)
            assert a.cauchy(0, 1) == b.cauchy(0, 1) == c.cauchy(0, 1)
            assert a.exponential(2.0) == b.exponential(2.0) == \
                c.exponential(2.0)
            assert a.log_normal(1.0, 0.5) == b.log_normal(1.0, 0.5) == \
                c.log_normal(1.0, 0.5)

    def test_reference_stream_via_native(self):
        rng = RandomGenerator(5489)
        assert rng._h is not None
        assert [rng._random() for _ in range(5)] == [
            3499211612, 581869302, 3890346734, 3586334585, 545404204]

    def test_batch_equals_scalar_stream(self):
        a, b, c = RandomGenerator(7), RandomGenerator(7), JRNG(7)
        arr = a.uniform_array(-1, 1, 700)
        assert np.array_equal(arr, [b.uniform(-1, 1) for _ in range(700)])
        assert np.array_equal(arr, c.uniform_array(-1, 1, 700))
        arr = a.normal_array(2, 3, 101)
        assert np.array_equal(arr, [b.normal(2, 3) for _ in range(101)])
        assert np.array_equal(arr, c.normal_array(2, 3, 101))

    def test_shuffle_indices_parity(self):
        a = RandomGenerator(99)
        b = RandomGenerator(99, force_python=True)
        perm = a.shuffle_indices(257)
        assert np.array_equal(perm, b.shuffle_indices(257))
        assert np.array_equal(perm, JRNG(99).shuffle_indices(257))

    def test_clone_and_copy_mid_stream(self):
        a = RandomGenerator(5)
        for _ in range(1000):
            a.uniform(0, 1)
        a.normal(0, 1)             # the pair cache half used
        c = a.clone()
        for _ in range(10):
            assert c.uniform(0, 1) == a.uniform(0, 1)
        assert c.normal(0, 1) == a.normal(0, 1)
        s, im, dm = a._export_state()
        j = JRNG(0)
        j._import_state(s, im, dm)
        assert j.uniform(0, 1) == a.uniform(0, 1)

    def test_cross_backend_copy(self):
        a = RandomGenerator(11)
        for _ in range(100):
            a.uniform(0, 1)
        py = RandomGenerator(0, force_python=True)
        py.copy(a)
        for _ in range(700):
            assert py.uniform(0, 1) == a.uniform(0, 1)
        assert a.get_seed() == py.get_seed() == 11


class TestImageKernels:
    def _img(self, h=13, w=17, c=3, seed=0):
        return np.random.RandomState(seed).rand(h, w, c).astype(np.float32)

    def test_bytes_chw_to_hwc(self):
        raw = np.random.RandomState(2).randint(
            0, 256, 3 * 8 * 9, dtype=np.uint8).tobytes()
        got = _bytes_chw_to_hwc(raw, 3, 8, 9, 255.0)
        want = (np.frombuffer(raw, np.uint8).reshape(3, 8, 9)
                .transpose(1, 2, 0).astype(np.float32) / 255.0)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, _ref_native().bytes_chw_to_hwc(raw, 3, 8, 9, 255.0))
        # BytesToBGRImg decodes in numpy: the same values
        from bigdl_tpu_torch.dataset.image import BytesToBGRImg, ByteRecord
        img = list(BytesToBGRImg(255.0, 8, 9)(iter([ByteRecord(raw, 1.0)])))
        np.testing.assert_array_equal(img[0].data, got)

    def test_crop(self):
        x = self._img()
        got = _crop(x, 2, 3, 7, 11)
        np.testing.assert_array_equal(got, x[2:9, 3:14])
        np.testing.assert_array_equal(got, _ref_native().crop(x, 2, 3, 7, 11))

    def test_hflip(self):
        x = self._img()
        np.testing.assert_array_equal(native.hflip(x), native.hflip_plain(x))
        np.testing.assert_array_equal(native.hflip(x), _ref_native().hflip(x))
        g = self._img()[..., 0]   # a grey image
        np.testing.assert_array_equal(native.hflip(g), g[:, ::-1])

    def test_normalize(self):
        x = self._img(224, 224)
        mean = np.float32([0.485, 0.456, 0.406])
        std = np.float32([0.229, 0.224, 0.225])
        got = native.normalize(x, mean, std)
        np.testing.assert_array_equal(got, native.normalize_plain(x, mean,
                                                                  std))
        np.testing.assert_array_equal(got,
                                      _ref_native().normalize(x, mean, std))

    def test_resize_bilinear_identity_and_shape(self):
        x = self._img(8, 8)
        np.testing.assert_array_equal(_resize_bilinear(x, 8, 8), x)
        for dh, dw in ((16, 12), (5, 3), (1, 1), (31, 9)):
            y = _resize_bilinear(x, dh, dw)
            assert y.shape == (dh, dw, 3)
            assert y.min() >= x.min() - 1e-6 and y.max() <= x.max() + 1e-6
            np.testing.assert_array_equal(y, _resize_bilinear_numpy(x, dh, dw))
            np.testing.assert_array_equal(
                y, _ref_native().resize_bilinear(x, dh, dw))

    def test_pack_chw_fused(self):
        x = self._img()
        dst = np.empty((3,) + x.shape[:2], np.float32)
        want = np.empty_like(dst)
        native.pack_chw(x, dst, to_rgb=True)
        np.testing.assert_array_equal(dst, x[..., ::-1].transpose(2, 0, 1))
        mean = np.float32([0.1, 0.2, 0.3])
        std = np.float32([2.0, 3.0, 4.0])
        for to_rgb in (False, True):
            native.pack_chw(x, dst, to_rgb=to_rgb, mean=mean, std=std)
            native.pack_chw_plain(x, want, to_rgb=to_rgb, mean=mean, std=std)
            np.testing.assert_array_equal(dst, want)
            _ref_native().pack_chw(x, want, to_rgb=to_rgb, mean=mean,
                                   std=std)
            np.testing.assert_array_equal(dst, want)
        # x * (1 / std) is within one rounding of (x - mean) / std
        native.pack_chw(x, dst, to_rgb=False, mean=mean, std=std)
        np.testing.assert_allclose(
            dst, ((x - mean) / std).transpose(2, 0, 1), rtol=1e-6)
        with pytest.raises(ValueError, match="does not fit"):
            native.pack_chw(x, np.empty((3, 4, 4), np.float32))


class TestPipelineIntegration:
    def test_bgr_to_batch_native_matches_numpy(self, monkeypatch):
        """At 64x65 (over ``native.MIN_VALUES``) the batcher packs through
        the native helper, at 6x5 through numpy's copy; both bit-equal to
        ``native=False`` and to the reference."""
        from bigdl_tpu.dataset import image as jimage
        from bigdl_tpu_torch.dataset.image import BGRImgToBatch, LabeledImage

        calls = []
        pack = native.pack_chw
        monkeypatch.setattr(native, "pack_chw",
                            lambda *a, **k: calls.append(1) or pack(*a, **k))
        for (h, w), native_calls in (((64, 65), 7), ((6, 5), 0)):
            imgs = [LabeledImage(
                np.random.RandomState(i).rand(h, w, 3).astype(np.float32),
                float(i)) for i in range(7)]
            calls.clear()
            got = list(BGRImgToBatch(3, to_rgb=True)(iter(imgs)))
            assert len(calls) == native_calls
            plain = list(BGRImgToBatch(3, to_rgb=True, native=False)(
                iter(imgs)))
            ref = list(jimage.BGRImgToBatch(3, to_rgb=True)(iter(
                [jimage.LabeledImage(i.data, i.label) for i in imgs])))
            assert [b.size() for b in got] == [3, 3, 1]
            for g, p, r in zip(got, plain, ref):
                np.testing.assert_array_equal(g.data, p.data)
                np.testing.assert_array_equal(g.data, r.data)
                np.testing.assert_array_equal(g.labels, r.labels)
                assert g.data.flags.c_contiguous

    def test_mt_batcher_native(self):
        from bigdl_tpu_torch.dataset.image import LabeledImage
        from bigdl_tpu_torch.dataset.prefetch import MTLabeledBGRImgToBatch

        imgs = [LabeledImage(
            np.random.RandomState(i).rand(64, 64, 3).astype(np.float32),
            float(i)) for i in range(8)]
        assert native.pays(imgs[0].data)
        for to_rgb in (False, True):
            batches = list(MTLabeledBGRImgToBatch(64, 64, 4, to_rgb=to_rgb,
                                                  workers=2)(iter(imgs)))
            plain = list(MTLabeledBGRImgToBatch(
                64, 64, 4, to_rgb=to_rgb, workers=2, native=False)(
                    iter(imgs)))
            assert len(batches) == 2
            for b, p in zip(batches, plain):
                np.testing.assert_array_equal(b.data, p.data)
        np.testing.assert_array_equal(
            batches[0].data,
            np.stack([im.data[..., ::-1].transpose(2, 0, 1)
                      for im in imgs[:4]]))
        np.testing.assert_array_equal(batches[1].labels, [4., 5., 6., 7.])


class TestJpegDecode:
    """The libjpeg path against PIL and the reference's library, on the
    committed fixtures."""

    def _jpegs(self):
        files = sorted(glob.glob(os.path.join(FIXDIR, "*.jpg")))
        assert len(files) == 5, files
        if not native.has_jpeg():
            pytest.skip("the host library was built without libjpeg")
        return [f for f in files if "png_named" not in f]

    def test_full_decode_matches_pil_exactly(self):
        from PIL import Image
        for f in self._jpegs():
            with open(f, "rb") as fh:
                data = fh.read()
            img = native.jpeg_decode(data)
            pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            assert img.shape == pil.shape
            # IFAST against PIL's ISLOW, within a few levels
            assert np.abs(img.astype(int) - pil.astype(int)).mean() < 2.0
            if _ref_native().has_jpeg():
                np.testing.assert_array_equal(img, jnative.jpeg_decode(data))

    def test_scaled_decode_halves_when_large_enough(self):
        from PIL import Image
        halved = 0
        for f in self._jpegs():
            with Image.open(f) as im:
                w, h = im.size
            with open(f, "rb") as fh:
                data = fh.read()
            img, orig = native.jpeg_decode(data, min_short=min(h, w) // 2,
                                           with_orig_dims=True)
            assert orig == (h, w)
            assert min(h, w) // 2 <= min(img.shape[:2]) <= min(h, w)
            halved += min(img.shape[:2]) < min(h, w)
        assert halved == len(self._jpegs())

    def test_non_jpeg_returns_none_and_reader_falls_back(self):
        from bigdl_tpu_torch.dataset.image import LocalImgReader
        png = os.path.join(FIXDIR, "png_named.jpg")
        with open(png, "rb") as f:
            assert native.jpeg_decode(f.read()) is None
        r = LocalImgReader(scale_to=64)
        assert r._read_native(png) is None
        out = r._read(png)                 # the port's PNG decoder
        assert out.ndim == 3 and out.shape[2] == 3
        assert min(out.shape[:2]) == 64

    def test_reader_native_close_to_pil(self):
        from PIL import Image
        from bigdl_tpu.dataset.image import LocalImgReader as JReader
        from bigdl_tpu_torch.dataset.image import LocalImgReader
        r = LocalImgReader(scale_to=128, normalize=255.0)
        checked = 0
        for f in self._jpegs():
            nat = r._read_native(f)
            with Image.open(f) as im:
                w, h = im.size
                nh, nw = LocalImgReader._short_edge_dims(h, w, 128)
                pil = np.asarray(im.convert("RGB").resize(
                    (nw, nh), Image.BILINEAR), np.float32)[..., ::-1] / 255.0
            assert nat.shape == pil.shape
            assert float(np.abs(nat - pil).mean()) < 0.03, f
            if _ref_native().has_jpeg():
                np.testing.assert_array_equal(
                    nat, JReader(scale_to=128, normalize=255.0)
                    ._read_native(f))
            got = list(r([(f, 2.0)]))[0]
            np.testing.assert_array_equal(got.data, nat)
            checked += 1
        assert checked == 4

    def test_fused_convert_matches_numpy(self):
        rs = np.random.RandomState(0)
        img = rs.randint(0, 256, (37, 53, 3), np.uint8)
        for dh, dw in ((37, 53), (64, 91), (19, 26)):
            out = native.u8rgb_resize_bgr(img, dh, dw, 255.0)
            np.testing.assert_array_equal(
                out, native.u8rgb_resize_bgr_plain(img, dh, dw, 255.0))
            np.testing.assert_array_equal(
                out, _ref_native().u8rgb_resize_bgr(img, dh, dw, 255.0))
        out = native.u8rgb_resize_bgr(img, 37, 53, 255.0)
        want = img[..., ::-1].astype(np.float32) / np.float32(255.0)
        np.testing.assert_allclose(out, want, atol=1e-6)

    def test_truncated_jpeg_rejected(self):
        with open(self._jpegs()[0], "rb") as f:
            data = f.read()
        assert native.jpeg_decode(data) is not None
        assert native.jpeg_decode(data[:len(data) // 2]) is None
        assert native.jpeg_decode(b"\xff\xd8garbage") is None
