"""The port's quantized inference (``bigdl_tpu_torch.ops.quant``, the packed
``Linear``/``SpatialConvolution`` paths, ``DLClassifier(quantize=...)``)
against the JAX package on the CPU.

The JAX side runs its Pallas kernels K13-K15 in interpret mode, as
``tests/test_quant.py`` does; the port's wrappers run their plain versions
on CPU tensors.  Inputs and weights come from numpy seeds (packing
full-width Inception-v1 is held in ``test_torch_port_quant_inception.py``).
Tolerances:
the codecs are bit-equal (same f32 division, round half to even, int8
storage of nibble bytes); K14 (int8 x int8) is exact in float32 and
bfloat16; K13 and K15 agree to 1e-5 of the sum of |products| per output
(f32 sums taken in another order), plus one bfloat16 rounding step of the
output (2^-7 relative) in bfloat16; the fused conv to rtol/atol 1e-5 in
float32; the quantized classifier's log-probabilities agree to 1e-4 in
float32 (conv sums in another order) with equal predictions.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import bigdl_tpu.nn as jnn
from bigdl_tpu.api import DLClassifier as JDLClassifier
from bigdl_tpu.models.inception import inception_module as j_inception_module
from bigdl_tpu.ops import quant as jq
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.api import DLClassifier
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models import inception_module
from bigdl_tpu_torch.ops import quant as tq
from bigdl_tpu_torch.serving import InferenceServer

# the suite runs several pytest workers on one host: keep torch from
# taking every core inside each of them
torch.set_num_threads(1)

BF16_RTOL = 2.0 ** -7       # one bfloat16 rounding step of the output
SUM_RTOL = 1e-5             # f32 sums in another order, of sum |x * w|


def _assert_sum_close(got, want, x, wide, dtype):
    """|got - want| within SUM_RTOL of each output's sum of |products|
    (``wide`` the widened, scaled weight), plus one bf16 step in bf16."""
    bound = SUM_RTOL * (np.abs(x.astype(np.float32))
                        @ np.abs(wide.astype(np.float32)).T)
    if dtype == "bfloat16":
        bound = bound + BF16_RTOL * np.abs(want)
    err = np.abs(got - want)
    assert (err <= bound).all(), float((err - bound).max())


@pytest.fixture
def interpret():
    """Route the JAX package's quant dispatch through the Pallas
    interpreter for one test, restoring the variable after it."""
    prev = os.environ.get("BIGDL_TPU_PALLAS_INTERPRET")
    os.environ["BIGDL_TPU_PALLAS_INTERPRET"] = "1"
    yield
    if prev is None:
        os.environ.pop("BIGDL_TPU_PALLAS_INTERPRET", None)
    else:
        os.environ["BIGDL_TPU_PALLAS_INTERPRET"] = prev


def _np(a):
    """A JAX or torch array as numpy; 1-byte floats as their raw bytes."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    if str(a.dtype) == "float8_e4m3fn":
        return a.view(np.uint8)
    return a.astype(np.float32) if str(a.dtype) == "bfloat16" else a


def _weights(shape, seed, ties=False):
    rng = np.random.RandomState(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    if ties:
        # per-channel absmax 127 (int8 scale 1.0) and values on exact .5
        # steps, so w / scale lands on ties that round half to even
        w = np.round(w * 20) / 2
        w.reshape(shape[0], -1)[:, 0] = 127.0
    return w


# -- (a) codecs ---------------------------------------------------------------

CODEC_SHAPES = [(64, 75), (33, 17), (16, 8, 3, 3), (6, 5, 1, 1), (5, 4097)]


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("shape", CODEC_SHAPES,
                         ids=["x".join(map(str, s)) for s in CODEC_SHAPES])
def test_codecs_are_bit_equal_to_jax(shape, ties):
    w = _weights(shape, 0, ties)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    for mode in ("w8", "w4", "f8"):
        got, want = tq.pack(tw, mode=mode), jq.pack(jw, mode=mode)
        assert set(got) == set(want)
        for key in got:
            assert tuple(got[key].shape) == tuple(want[key].shape), key
            np.testing.assert_array_equal(_np(got[key]), _np(want[key]))
        # widening back is the same f32 arithmetic
        np.testing.assert_array_equal(_np(tq.unpack(got)),
                                      _np(jq.unpack(want)))
    assert tq.packed_k(tq.pack(tw, mode="w4")) == shape[-1]


def test_nibble_bytes_above_127_are_negative_int8():
    w = np.array([[-7.0, -1.0, 7.0, 3.0, -4.0]], np.float32)
    q4, scale = tq.quantize_nibble(torch.from_numpy(w))
    jq4, _ = jq.quantize_nibble(jnp.asarray(w))
    assert q4.dtype == torch.int8 and (q4 < 0).any()
    np.testing.assert_array_equal(q4.numpy(), np.asarray(jq4))
    np.testing.assert_array_equal(
        tq.unpack_nibbles(q4, 5).numpy(), [[-7, -1, 7, 3, -4]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_is_bit_equal_to_jax(dtype):
    rng = np.random.RandomState(1)
    x = rng.standard_normal((9, 37)).astype(np.float32)
    x[0, :8] = [0.5, 1.5, -2.5, 126.5, -200.0, 0.0, -0.5, 3.5]
    sx = np.float32(1.0)
    for s in (sx, np.float32(0.0137)):
        got = tq.quantize_act(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.tensor(s))
        want = jq.quantize_act(jnp.asarray(x, getattr(jnp, dtype)),
                               jnp.asarray(s))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_model_mode_checks():
    with pytest.raises(ValueError, match="unknown quantize mode 'fp4'"):
        tq.quantize_model(tnn.Sequential().add(tnn.Linear(128, 64)), "fp4")
    with pytest.raises(ValueError, match="needs calib="):
        tq.quantize_model(tnn.Sequential().add(tnn.Linear(128, 64)), "w8a8")


# -- (c) the plain kernel versions against JAX's (interpret-mode) kernels ----

MATMUL_SHAPES = [(1, 7, 5), (13, 33, 17), (37, 130, 70), (130, 515, 129)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", MATMUL_SHAPES,
                         ids=["x".join(map(str, s)) for s in MATMUL_SHAPES])
def test_plain_kernels_match_jax_kernels(interpret, mkn, dtype):
    m, k, n = mkn
    rng = np.random.RandomState(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    for mode, sx in (("w8", None), ("f8", None), ("w4", None),
                     ("w8", 0.03)):
        qt = tq.pack(tw, sx=sx, mode=mode)
        got = tq.int8_matmul(tx, qt)
        want = jq.int8_matmul(jx, jq.pack(jw, sx=sx, mode=mode))
        assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
        if sx is not None:      # K14: integer sums, bit-equal
            np.testing.assert_array_equal(_np(got), _np(want))
        else:
            _assert_sum_close(_np(got), _np(want), _np(tx),
                              tq.unpack(qt).numpy(), dtype)


def test_wrappers_take_the_plain_version_on_the_cpu():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.standard_normal((6, 11)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((9, 11)).astype(np.float32))
    p8, p4, pf = (tq.pack(w, mode=m) for m in ("w8", "w4", "f8"))
    before = [fn.launches for fn in (tq.w8_matmul, tq.f8_matmul,
                                     tq.a8_matmul, tq.w4_matmul)]
    assert torch.equal(tq.w8_matmul(x, p8["q8"], p8["scale"]),
                       tq.int8_matmul_plain(x, p8["q8"], p8["scale"]))
    assert torch.equal(tq.f8_matmul(x, pf["f8"], pf["scale"]),
                       tq.int8_matmul_plain(x, pf["f8"], pf["scale"]))
    assert torch.equal(tq.w4_matmul(x, p4["q4"], p4["scale"], 11),
                       tq.int4_matmul_plain(x, p4["q4"], p4["scale"], 11))
    xq = tq.quantize_act(x, torch.tensor(0.02))
    assert torch.equal(tq.a8_matmul(xq, p8["q8"], p8["scale"], torch.float32),
                       tq.int8_a8_matmul_plain(xq, p8["q8"], p8["scale"],
                                               torch.float32))
    assert [fn.launches for fn in (tq.w8_matmul, tq.f8_matmul, tq.a8_matmul,
                                   tq.w4_matmul)] == before
    with pytest.raises(TypeError, match="int8 weights"):
        tq.w8_matmul(x, pf["f8"], pf["scale"])
    with pytest.raises(ValueError, match="do not agree"):
        tq.w8_matmul(x[:, :10], p8["q8"], p8["scale"])


# -- (c2) the bf16 kernel's grid plan ------------------------------------------

@functools.lru_cache(maxsize=None)
def _inception_products(bucket):
    """(M, K, N) of every packed product of the port's full-width
    Inception-v1 ``w8`` forward at batch ``bucket``: the fused stride-1
    convs as patch matrices and the classifier (found with pre-hooks over
    one batch-1 forward on the CPU, as chip_smoke.py's quant_products)."""
    from bigdl_tpu_torch.models import Inception_v1
    qmodel = tq.quantize_model(Inception_v1(1000).reset(0), "w8")
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, tuple(args[0].shape))))
        for m in qmodel.modules() if tq.packed_weight(m) is not None]
    with torch.inference_mode():
        qmodel(torch.zeros((1, 3, 224, 224)))
    for h in hooks:
        h.remove()
    out = []
    for m, (_, c, h, w) in [(m, s) for m, s in seen if len(s) == 4]:
        if m._fused_int8_eligible(tq.packed_weight(m)):
            oh = h + 2 * m.pad_h - m.kernel_h + 1
            ow = w + 2 * m.pad_w - m.kernel_w + 1
            out.append((bucket * oh * ow, c * m.kernel_h * m.kernel_w,
                        m.n_output_plane))
    out += [(bucket, m.input_size, m.output_size) for m, s in seen
            if isinstance(m, tnn.Linear)]
    return out


def _blocks(m, plan):
    return -(-m // plan.bm) * plan.n_tiles * plan.splits


def _check_plan(m, k, n, plan):
    assert plan.bm in (64, 128, 192) and plan.bn % 8 == 0
    assert 8 <= plan.bn <= (192 if plan.bm == 192 else 256)
    assert plan.bn * plan.n_tiles >= n > plan.bn * (plan.n_tiles - 1)
    assert plan.n_tiles == (1 if n <= 256 else 2 if n <= 512 else
                            -(-n // 256))
    # no split is empty, and together they cover every K step
    assert plan.per * plan.splits >= plan.steps
    assert plan.per * (plan.splits - 1) < plan.steps


@pytest.mark.parametrize("nibbles", [False, True], ids=["int8-e4m3", "int4"])
@pytest.mark.parametrize("bucket", [8, 32])
def test_bf16_plan_fills_the_card_at_every_inception_product(bucket,
                                                             nibbles):
    prods = _inception_products(bucket)
    assert len(prods) == 56             # 55 stride-1 convs, the classifier
    for m, k, n in prods:
        plan = tq.bf16_plan(m, k, n, nibbles)
        _check_plan(m, k, n, plan)
        # at least one block a streaming multiprocessor, or one K step a
        # split; and no split where the tiles alone fill the card
        assert _blocks(m, plan) >= tq.H100_SMS or plan.per == 1, (m, k, n)
        if -(-m // plan.bm) * plan.n_tiles >= tq.H100_SMS:
            assert plan.splits == 1, (m, k, n)
    # N 288-384 (4d/3x3, 4e/3x3, 5a/3x3, 5b/1x1, 5b/3x3) takes two N tiles
    assert {n for m, k, n in prods
            if tq.bf16_plan(m, k, n).n_tiles == 2} == {288, 320, 384}


@pytest.mark.parametrize("mkn,want", [
    ((100352, 576, 192), (192, 192, 1, 1)),   # conv2/3x3 at batch 32
    ((25088, 1152, 192), (128, 192, 1, 1)),   # 3b/3x3: 131 tiles of 192
    ((6272, 480, 16), (64, 16, 1, 2)),        # 4a/5x5_reduce: 98 tiles
    ((1568, 832, 160), (64, 160, 1, 7)),      # 13 K steps in 7 splits
    ((32, 1024, 1000), (64, 256, 4, 16)),     # the classifier: one step each
    ((8, 5, 257), (64, 136, 2, 1)),           # N 257 in two tiles, one step
    ((1, 7, 5), (64, 8, 1, 1)),
], ids=["conv2", "3b-3x3", "4a-5x5-reduce", "uneven", "classifier", "n257",
        "tiny"])
def test_bf16_plan_at_edges(mkn, want):
    m, k, n = mkn
    plan = tq.bf16_plan(m, k, n)
    _check_plan(m, k, n, plan)
    assert (plan.bm, plan.bn, plan.n_tiles, plan.splits) == want


# -- (c3) the f32 kernel's and K14's grid plans -------------------------------

def _check_splits(tiles, plan, slots):
    # no split is empty, and together they cover every K step; the card's
    # ``slots`` blocks filled, or one K step a split; no split where the
    # tiles alone fill them
    assert plan.per * plan.splits >= plan.steps
    assert plan.per * (plan.splits - 1) < plan.steps
    assert tiles * plan.splits >= slots or plan.per == 1
    if tiles >= slots:
        assert plan.splits == 1


def _check_f32_plan(m, k, n, nibbles, plan):
    assert (plan.bm, plan.bn) in tq.F32_TILES
    assert plan.bn > 32 or n <= 32          # the 8 x 4 tile only there
    assert plan.bn * plan.n_tiles >= n > plan.bn * (plan.n_tiles - 1)
    assert plan.steps == (-(-(-(-k // 2)) // 8) if nibbles else -(-k // 16))
    # no other tile computes less padding
    area = -(-m // plan.bm) * plan.bm * plan.n_tiles * plan.bn
    assert all(-(-m // bm) * bm * -(-n // bn) * bn >= area
               for bm, bn in tq.F32_TILES if bn > 32 or n <= 32)
    # the f32 kernel's card holds F32_BLOCKS_PER_SM blocks an SM
    _check_splits(-(-m // plan.bm) * plan.n_tiles, plan,
                  tq.F32_BLOCKS_PER_SM * tq.H100_SMS)


def _check_a8_plan(m, k, n, plan):
    assert plan.bn in tq.A8_BN
    assert plan.bn * plan.n_tiles >= n > plan.bn * (plan.n_tiles - 1)
    assert plan.steps == -(-k // tq.A8_STEP)
    _check_splits(-(-m // tq.A8_BM) * plan.n_tiles, plan, tq.H100_SMS)


@pytest.mark.parametrize("nibbles", [False, True], ids=["int8-e4m3", "int4"])
@pytest.mark.parametrize("bucket", [8, 32])
def test_f32_plan_fills_the_card_at_every_inception_product(bucket, nibbles):
    prods = _inception_products(bucket)
    assert len(prods) == 56
    for m, k, n in prods:
        _check_f32_plan(m, k, n, nibbles, tq.f32_plan(m, k, n, nibbles))
    # the narrow 1x1 convs take the 32-column tile, N 48 the 64-column one
    assert {n for m, k, n in prods
            if tq.f32_plan(m, k, n, nibbles).bn == 32} == {16, 24, 32}
    assert tq.f32_plan(bucket * 49, 832, 48, nibbles).bn == 64


@pytest.mark.parametrize("bucket", [8, 32])
def test_a8_plan_fills_the_card_at_every_inception_product(bucket):
    prods = _inception_products(bucket)
    for m, k, n in prods:
        _check_a8_plan(m, k, n, tq.a8_plan(m, k, n))


@pytest.mark.parametrize("mkn,nibbles,want", [
    ((100352, 576, 192), False, (128, 64, 3, 1)),   # conv2/3x3: 2352 tiles
    ((25088, 1152, 192), False, (128, 64, 3, 1)),   # 3b/3x3: 588 tiles
    ((6272, 480, 16), False, (128, 32, 1, 6)),      # 4a/5x5_reduce: 49 tiles
    ((1568, 832, 160), False, (128, 64, 3, 7)),     # 52 K steps in 7 splits
    ((32, 1024, 1000), False, (64, 128, 8, 64)),    # the classifier: 1 step
    ((8, 1024, 1000), False, (64, 128, 8, 64)),     # at bucket 8
    ((32, 1024, 1000), True, (64, 128, 8, 64)),     # K15's 8 byte steps
    ((1568, 1001, 130), False, (128, 64, 3, 7)),    # 63 steps, 9 a split
    ((1, 7, 5), False, (128, 32, 1, 1)),
], ids=["conv2", "3b-3x3", "4a-5x5-reduce", "split", "classifier",
        "classifier-8", "classifier-int4", "uneven", "tiny"])
def test_f32_plan_at_edges(mkn, nibbles, want):
    m, k, n = mkn
    plan = tq.f32_plan(m, k, n, nibbles)
    _check_f32_plan(m, k, n, nibbles, plan)
    assert (plan.bm, plan.bn, plan.n_tiles, plan.splits) == want


@pytest.mark.parametrize("mkn,want", [
    ((100352, 576, 192), (256, 1, 1)),   # conv2/3x3: tiles fill the card
    ((25088, 1152, 192), (256, 1, 1)),   # 3b/3x3
    ((6272, 480, 16), (64, 1, 2)),       # 4a/5x5_reduce: 98 tiles, 4 steps
    ((1568, 832, 160), (256, 1, 7)),     # one K step a split
    ((32, 1024, 1000), (64, 16, 8)),     # the classifier: one step a split
    ((8, 1024, 1000), (64, 16, 8)),      # at bucket 8
    ((300, 1024, 1000), (256, 4, 8)),    # 20 tiles: one step a split
    ((130, 1000, 96), (64, 2, 8)),       # 8 steps, the last ragged
    ((1, 7, 5), (64, 1, 1)),
], ids=["conv2", "3b-3x3", "4a-5x5-reduce", "split", "classifier",
        "classifier-8", "wide-m", "ragged-k", "tiny"])
def test_a8_plan_at_edges(mkn, want):
    m, k, n = mkn
    plan = tq.a8_plan(m, k, n)
    _check_a8_plan(m, k, n, plan)
    assert (plan.bn, plan.n_tiles, plan.splits) == want


# -- (d) the fused int8 conv --------------------------------------------------

@pytest.mark.parametrize("k,pad", [(1, 0), (3, 1), (5, 2)],
                         ids=["1x1", "3x3-pad1", "5x5-pad2"])
def test_int8_conv2d_matches_jax(interpret, k, pad):
    from jax import lax
    rng = np.random.RandomState(k)
    x = rng.standard_normal((2, 6, 7, 9)).astype(np.float32)
    w = rng.standard_normal((11, 6, k, k)).astype(np.float32)
    # F.unfold orders patch features (C, kh, kw), as the reference's patches
    cols = F.unfold(torch.from_numpy(x), (k, k), padding=(pad, pad))
    jcols = lax.conv_general_dilated_patches(
        jnp.asarray(x), (k, k), (1, 1), ((pad, pad), (pad, pad)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    np.testing.assert_array_equal(cols.numpy(),
                                  np.asarray(jcols).reshape(cols.shape))
    got = tq.int8_conv2d(torch.from_numpy(x), tq.pack(torch.from_numpy(w)),
                         padding=(pad, pad))
    want = jq.int8_conv2d(jnp.asarray(x), jq.pack(jnp.asarray(w)),
                          padding=(pad, pad))
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # and the same product as a conv over the widened weight
    wide = F.conv2d(torch.from_numpy(x), tq.unpack(
        tq.pack(torch.from_numpy(w))), padding=pad)
    torch.testing.assert_close(got, wide, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2])
def test_int8_conv2d_hands_the_kernel_contiguous_patches(monkeypatch, n):
    seen = []
    plain = tq.w8_matmul

    def spy(x, q8, scale):
        seen.append(x.is_contiguous() and q8.is_contiguous())
        return plain(x, q8, scale)

    monkeypatch.setattr(tq, "w8_matmul", spy)
    x = torch.randn((n, 4, 5, 6))
    qt = tq.pack(torch.randn((3, 4, 3, 3)))
    y = tq.int8_conv2d(x, qt, padding=(1, 1))
    assert seen == [True] and tuple(y.shape) == (n, 3, 5, 6)
    tq.int8_matmul(x.transpose(2, 3)[..., :4],
                   tq.pack(torch.randn((3, 4))))
    assert seen == [True, True]


# -- (e), (f) calibration and the quantized classifier -----------------------

ROWS_SHAPE = (192, 16, 16)


def _test_model(pkg, module_fn):
    """A strided quantized conv, the ``inception_3a`` block at its real
    widths (1x1, 3x3 and 5x5 stride-1 convs; its 5x5_reduce stays fp, 3072
    elements), then two quantized ``Linear`` layers."""
    nn = pkg
    return (nn.Sequential()
            .add(nn.SpatialConvolution(192, 192, 3, 3, 2, 2, 1, 1))
            .add(nn.ReLU(True))
            .add(module_fn(192, 64, 96, 128, 16, 32, 32, "inception_3a/"))
            .add(nn.SpatialAveragePooling(8, 8, 1, 1))
            .add(nn.View(256).set_num_input_dims(3))
            .add(nn.Linear(256, 100))
            .add(nn.ReLU(True))
            .add(nn.Linear(100, 100))
            .add(nn.LogSoftMax()))


@pytest.fixture(scope="module")
def pair():
    jm = _test_model(jnn, j_inception_module)
    rng = np.random.RandomState(3)

    def draw(leaf):
        shape = leaf.shape
        if len(shape) >= 2:
            bound = np.sqrt(6.0 / ((shape[0] + shape[1])
                                   * int(np.prod(shape[2:]))))
        else:
            bound = 0.05
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(3))
    jm.params, jm.state = jax.tree_util.tree_map(draw, shapes)
    jm.evaluate()
    tm = load_jax_params(_test_model(tnn, inception_module),
                         jax.tree_util.tree_map(np.asarray, jm.params))
    rows = [r.astype(np.float32) for r in
            np.random.RandomState(1).standard_normal((6,) + ROWS_SHAPE)]
    return jm, tm.evaluate(), rows


def test_calibrate_matches_jax(pair):
    jm, tm, rows = pair
    x = np.stack(rows[:4])
    want = jq.calibrate(jm, jm.params, jm.state, [x])
    got = tq.calibrate(tm, [x])
    assert set(got) == set(want) == {"5.weight", "7.weight"}
    for path in want:
        assert got[path] == pytest.approx(want[path], rel=1e-5)
    assert tm.training is False


@pytest.mark.parametrize("mode", ["int8", "w8a8", "int4", "fp8"])
def test_quantized_classifier_matches_jax(interpret, pair, mode):
    jm, tm, rows = pair
    kw = dict(calibration_rows=rows[:4]) if mode == "w8a8" else {}
    want = JDLClassifier(jm, (4,) + ROWS_SHAPE, quantize=mode, **kw)
    got = DLClassifier(tm, (4,) + ROWS_SHAPE, quantize=mode, device="cpu",
                       **kw)
    assert got.quantize == want.quantize == jq.normalize_mode(mode)
    np.testing.assert_array_equal(got.predict(rows), want.predict(rows))
    x = np.stack(rows[:4])
    jlp = np.asarray(jm.apply(want._params, jm.state, jnp.asarray(x),
                              training=False)[0])
    with torch.inference_mode():
        tlp = got.qmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tlp, jlp, rtol=1e-4, atol=1e-4)
    # the caller's model keeps its fp weights
    assert tm.layers[5].weight.dtype == torch.float32
    assert tq.packed_weight(tm.layers[5]) is None


def test_bf16_quantized_classifier_matches_jax(interpret, pair):
    """The serving configuration (w8, bf16 activations): log-probs within
    two bfloat16 steps at |log p| ~ 4.6 (0.0625), the reference and the
    port rounding the conv sums to bfloat16 at different points."""
    jm, tm, rows = pair
    want = JDLClassifier(jm, (4,) + ROWS_SHAPE, quantize="w8",
                         compute_dtype=jnp.bfloat16)
    got = DLClassifier(tm, (4,) + ROWS_SHAPE, quantize="w8",
                       compute_dtype=torch.bfloat16, device="cpu")
    x = np.stack(rows[:4])
    jlp = np.asarray(jm.apply(want._params, jm.state,
                              jnp.asarray(x, jnp.bfloat16),
                              training=False)[0].astype(jnp.float32))
    with torch.inference_mode():
        tlp = got.qmodel(torch.from_numpy(x).to(torch.bfloat16))
    assert tlp.dtype == torch.bfloat16
    assert np.abs(tlp.float().numpy() - jlp).max() <= 0.0625
    assert got.qmodel.layers[7].weight_scale.dtype == torch.float32
    assert got.qmodel.layers[7].bias.dtype == torch.bfloat16


def test_server_answers_like_the_quantized_classifier(pair):
    _, tm, rows = pair
    clf = DLClassifier(tm, (4,) + ROWS_SHAPE, quantize="w8", device="cpu")
    server = InferenceServer(clf, batch_buckets=(2, 4), device="cpu",
                             max_delay_s=0.002)
    try:
        got = server.predict(rows)
    finally:
        assert server.drain(timeout=30)
    np.testing.assert_array_equal(got, clf.predict(rows))


@pytest.mark.parametrize("kw,exc,match", [
    (dict(quantize="fp4"), ValueError, "unknown quantize mode 'fp4'"),
    (dict(quantize="w8a8"), ValueError, "needs calibration_rows"),
    (dict(quantize="w8a8", calibration_rows=[np.zeros(5, np.float32)]),
     ValueError, "calibration row 0 has shape"),
])
def test_quantize_mode_checks(pair, kw, exc, match):
    _, tm, _ = pair
    with pytest.raises(exc, match=match):
        DLClassifier(tm, (4,) + ROWS_SHAPE, device="cpu", **kw)
