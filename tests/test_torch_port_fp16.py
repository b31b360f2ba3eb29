"""The port's fp16 wire codec (``bigdl_tpu_torch.ops.fp16``) against the JAX
package's (``bigdl_tpu.ops.fp16``).

The JAX side runs its Pallas kernels K5, K6 and K7 in interpret mode, as
``tests/test_pallas_ops.py`` does; the port's wrappers take their plain
versions for CPU tensors.  Inputs are seeded numpy normals and a table of
special values (signed zeros, subnormals, the smallest and largest
normals, infinities, quiet and signalling NaNs with high and low payloads).
The results are bit-equal, except that a NaN result need only be a NaN
(its payload is the framework's own).  K7 flushes subnormals as XLA on the
CPU and the TPU do: the plain version flushes explicitly, whatever
``torch.set_flush_denormal`` says.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu.ops import fp16 as jfp16
from bigdl_tpu_torch import ops
from bigdl_tpu_torch.ops import fp16 as tfp16

torch.set_num_threads(1)

# float32 bit patterns: zeros, subnormals (0x00010000 keeps wire bits
# 0x0001), the smallest and largest normals, infinities, NaNs (0x7F800001
# truncates to +inf), values that truncation and rounding tell apart
F32_SPECIAL = [0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF,
               0x807FFFFF, 0x00010000, 0x80010000, 0x00800000, 0x80800000,
               0x7F7FFFFF, 0xFF7FFFFF, 0x7F800000, 0xFF800000, 0x7F800001,
               0xFF800001, 0x7FA00000, 0x7FC00000, 0xFFC00000, 0x7FFFFFFF,
               0x3F800000, 0x3F80FFFF, 0x3F818000, 0xBF80FFFF, 0x4B000001]
# wire values: zeros, subnormals, smallest normals and their neighbours,
# largest normals, infinities, signalling and quiet NaNs, +-1
U16_SPECIAL = [0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x807F, 0x0080,
               0x8080, 0x0081, 0x8081, 0x7F7F, 0xFF7F, 0x7F80, 0xFF80,
               0x7F81, 0xFFBF, 0x7FC0, 0xFFC0, 0x7FFF, 0x3F80, 0xBF80,
               0x3F81, 0x0100, 0x8100]
# K7's flush cases: (a, b, sum) as XLA on the CPU gives them
ADD_CASES = [(0x0001, 0x0001, 0x0000), (0x8001, 0x8001, 0x8000),
             (0x807F, 0x0000, 0x0000), (0x0081, 0x8080, 0x0000),
             (0x8081, 0x0080, 0x8000), (0x0001, 0x3F80, 0x3F80),
             (0x0100, 0x8080, 0x0080), (0x0100, 0x8081, 0x0000)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_PALLAS_INTERPRET", "1")


def _u16(values):
    return np.asarray(values, dtype=np.uint16)


def _f32(bits):
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _normals(n, seed):
    return np.random.RandomState(seed).standard_normal(n).astype(np.float32)


def _u16_nan(u):
    u = np.asarray(u).astype(np.uint32)
    return ((u & 0x7F80) == 0x7F80) & ((u & 0x7F) != 0)


def assert_same_bits(got, want):
    """Bit-equal where ``want`` is not a NaN; a NaN where it is."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == np.float32:
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan)
        assert np.array_equal(got.view(np.uint32)[~nan],
                              want.view(np.uint32)[~nan])
    else:
        nan = _u16_nan(want)
        assert np.array_equal(_u16_nan(got), nan)
        assert np.array_equal(got[~nan], want[~nan])


def _pairs():
    a, b = np.meshgrid(_u16(U16_SPECIAL), _u16(U16_SPECIAL))
    return a.reshape(-1), b.reshape(-1)


def _inputs(kind):
    """(f32 input of K5, u16 input of K6, the two u16 inputs of K7)."""
    if kind == "normals":
        u, v = (np.array(jfp16.fp16_compress_reference(_normals(4099, s)))
                for s in (1, 2))
        return _normals(4099, 0), u, u, v
    return (_f32(F32_SPECIAL), _u16(U16_SPECIAL)) + _pairs()


@pytest.mark.parametrize("kind", ["normals", "special"])
def test_plain_codec_matches_the_pallas_kernels(kind):
    x, u, a, b = _inputs(kind)
    assert_same_bits(tfp16.fp16_compress_reference(torch.from_numpy(x)),
                     jfp16.fp16_compress(x))
    assert_same_bits(tfp16.fp16_decompress_reference(torch.from_numpy(u)),
                     jfp16.fp16_decompress(u))
    assert_same_bits(tfp16.fp16_add_plain(torch.from_numpy(a),
                                          torch.from_numpy(b)),
                     jfp16.fp16_add(a, b))


def test_add_flush_cases_match_jax_whatever_the_flush_flag():
    a, b, want = (_u16(c) for c in zip(*ADD_CASES))
    assert_same_bits(np.asarray(jfp16.fp16_add(a, b)), want)
    nans = [(0x7F81, 0x3F80), (0x7F80, 0xFF80), (0xFFC0, 0x0001)]
    na, nb = (_u16(c) for c in zip(*nans))
    assert _u16_nan(np.asarray(jfp16.fp16_add(na, nb))).all()
    for flush in (False, True):
        torch.set_flush_denormal(flush)
        try:
            got = tfp16.fp16_add(torch.from_numpy(a), torch.from_numpy(b))
            nan_sum = tfp16.fp16_add(torch.from_numpy(na),
                                     torch.from_numpy(nb))
        finally:
            torch.set_flush_denormal(False)
        assert_same_bits(got.numpy(), want)
        assert _u16_nan(nan_sum.numpy()).all()
    # compress and decompress keep subnormal bits
    sub = _f32([0x00010000, 0x80010000, 0x00000001])
    assert tfp16.fp16_compress(torch.from_numpy(sub)).tolist() == \
        [0x0001, 0x8001, 0x0000] == np.asarray(
            jfp16.fp16_compress(sub)).tolist()
    back = tfp16.fp16_decompress(torch.from_numpy(_u16([0x0001, 0x8001])))
    assert back.numpy().view(np.uint32).tolist() == [0x00010000, 0x80010000]


@pytest.mark.parametrize("n", [1, 7, 8191, 32768 + 3])
def test_wrappers_match_jax_at_ragged_lengths(n):
    ops.reset_launches()
    x = _normals(n, n)
    got = tfp16.fp16_compress(torch.from_numpy(x))
    want = np.asarray(jfp16.fp16_compress(x))
    assert_same_bits(got.numpy(), want)
    assert_same_bits(tfp16.fp16_decompress(got).numpy(),
                     np.asarray(jfp16.fp16_decompress(want)))
    y = np.array(jfp16.fp16_compress(_normals(n, n + 1)))
    assert_same_bits(tfp16.fp16_add(got, torch.from_numpy(y)).numpy(),
                     np.asarray(jfp16.fp16_add(want, y)))
    # on the CPU every wrapper took its plain version
    assert all(fn.launches == 0 for fn in ops.KERNEL_WRAPPERS)


def test_wrappers_take_views_other_dtypes_and_shapes():
    x = _normals(6 * 11, 5).reshape(6, 11)
    t = torch.from_numpy(x)
    flat = np.asarray(jfp16.fp16_compress(x))
    got = tfp16.fp16_compress(t)
    assert got.shape == (66,) and got.dtype == torch.uint16
    assert_same_bits(got.numpy(), flat)
    # an offset view and a non-contiguous one
    assert_same_bits(tfp16.fp16_compress(t.reshape(-1)[1:]).numpy(),
                     flat[1:])
    assert_same_bits(tfp16.fp16_compress(t[:, ::2]).numpy(),
                     np.asarray(jfp16.fp16_compress(x[:, ::2])))
    # the input is cast to float32 first, as in the reference
    for dt in (np.float64, np.float16):
        assert_same_bits(tfp16.fp16_compress(torch.from_numpy(
            x.astype(dt))).numpy(), np.asarray(jfp16.fp16_compress(
                x.astype(dt))))
    bf = torch.from_numpy(x).to(torch.bfloat16)
    assert_same_bits(tfp16.fp16_compress(bf).numpy(),
                     np.asarray(jfp16.fp16_compress(
                         bf.float().numpy())))
    back = tfp16.fp16_decompress(got, shape=(6, 11))
    assert back.shape == (6, 11)
    assert_same_bits(back.numpy(), np.asarray(
        jfp16.fp16_decompress(flat, shape=(6, 11))))
    # a 2-D wire buffer sums flat
    s = tfp16.fp16_add(got.reshape(6, 11), got.reshape(6, 11))
    assert s.shape == (66,)
    assert_same_bits(s.numpy(), np.asarray(jfp16.fp16_add(flat, flat)))
    with pytest.raises(ValueError, match="one length"):
        tfp16.fp16_add(got, got[1:])
    with pytest.raises(TypeError, match="uint16"):
        tfp16.fp16_decompress(torch.zeros(3, dtype=torch.int32))
    empty = tfp16.fp16_compress(torch.zeros(0))
    assert empty.shape == (0,) and tfp16.fp16_decompress(empty).shape == (0,)


def test_truncation_not_rounding():
    # 1 + 3 * 2^-9 (three quarters of a bf16 step) rounds up to nearest
    # bf16 but truncates down, as 1 + 2^-9 (the reference's case) does
    x = torch.tensor([1.0 + 3 * 2.0 ** -9, -(1.0 + 3 * 2.0 ** -9),
                      1.0 + 2.0 ** -9])
    back = tfp16.fp16_decompress(tfp16.fp16_compress(x))
    assert back.tolist() == [1.0, -1.0, 1.0]
    assert x.to(torch.bfloat16).float().tolist()[:2] == \
        [1.0 + 2.0 ** -7, -(1.0 + 2.0 ** -7)]
    assert_same_bits(back.numpy(), np.asarray(jfp16.fp16_decompress(
        jfp16.fp16_compress(x.numpy()))))


def test_round_trip_within_2_to_the_minus_7():
    # FP16ParameterSpec's bound: 7 mantissa bits lose < 2^-7 relative
    x = torch.from_numpy(_normals(100000, 9) *
                         np.float32(10.0) ** np.random.RandomState(9)
                         .randint(-30, 30, 100000).astype(np.float32))
    back = tfp16.fp16_decompress(tfp16.fp16_compress(x), shape=x.shape)
    err = (back - x).abs()
    assert (err <= x.abs() * 2.0 ** -7 + 1e-30).all()
    assert (back.abs() <= x.abs()).all()       # truncation is toward zero
