"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip without one.  They import neither
jax nor ``bigdl_tpu``, so they also run where only PyTorch is installed:

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest

Tolerances: max-pool forward and backward are bit-equal (values and uint8
argmax codes; the backward sums in the plain version's order), also at the
edges of their plan (bases off 16 bytes, bands of rows, many planes a
block); the LRN
forward within rtol 1e-5 / atol 1e-6 in float32 and rtol 2e-2 / atol 1e-2
in bfloat16, the LRN backward within rtol 1e-5 / atol 1e-5 and rtol 2e-2 /
atol 2e-2, where the plain version rounds to bfloat16 at every step, also
at the edges of their plan (bases off 16 bytes, odd planes, C below the
window or off a multiple of the chunk, window sizes 1 and 4).  The
quantized matmuls: K14 (int8 x int8) is bit-equal, also where it splits K
(its last block of a tile adds the int32 partial sums); K13 (int8 and
e4m3 weights) and K15 (int4) agree to 1e-4 of each output's sum of
|products| (f32 sums taken in another order: wgmma's, the f32 kernel's,
and a split K's partial sums), plus one bfloat16 rounding step of the
output (2^-7 relative) in bfloat16, and are bit-equal across two launches
in both dtypes.
The attention kernels K8, K9 and K12 agree with their plain versions to
1e-5 of each output's sum of |p·v| (the softmax weights times |v|) in
float32, and to two bfloat16 steps (2 * 2^-7) of it in bfloat16: the two
outputs' own roundings can land one step apart, and K8/K9 round p to
bfloat16 for the tensor cores (2^-9 of the sum at most); K8 and K9 are
bit-equal across two launches in both dtypes.  The f32 K8/K9 hold these
tolerances at the edges of their blocks and key tiles at every head dim
16-256, and K9 writes o = 0 and an lse of about NEG_INF for a row whose
every key is padded.  K8-K11 hold these tolerances at
head dims 160 (zero-padded) and 256 and, through their D-chunked kernels,
320 and 512.  K12 holds them on both of its paths (tensor cores, page
split) and is bit-equal across two launches.  K9's row
logsumexp agrees to 1e-5 of max(1, |lse|); the delta pass agrees with
``flash_bwd_delta_plain`` to 1e-5 of each row's sum |dO·O|; K10 and K11
agree with ``flash_bwd_plain`` to 1e-4 of each gradient's largest magnitude
in float32 and two bfloat16 steps of it in bfloat16 (ds and p rounded where
the reference rounds them), and both are bit-equal across launches.  K8's
backward (autograd of the chunked plain form) agrees with autograd of the
plain form to 1e-4 of each gradient's largest magnitude in float32 (the
same math, f32 sums in another order).  The fp16 codec K5, K6 and K7 is
bit-equal to its plain versions wherever the plain result is not a NaN, and
a NaN where it is (K7's NaN is the card's canonical one), on a table of
special values and at misaligned offsets.  BatchNorm's running statistics
stay f32 buffers on the card and move under bf16 mixed precision; a
ResNet-50 bf16 step on the card is held against the CPU's bf16 step with
the CPU's own f32 step as the yardstick of bf16 rounding.  A
LocalOptimizer run resumed from a snapshot on the card draws the
uninterrupted run's dropout masks (the
CUDA generator's state is restored exactly) and agrees with it to 1e-5.
The perf harness's AlexNet and VGG-16 launch K1 and K2 (3 + 2 and 5) in a
bf16 forward and K3 and K4 besides in an f32 step, and nothing else.
"""

import numpy as np
import pytest
import torch

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.ops import (cross_map_lrn, lrn_bwd, lrn_bwd_plain,
                                 lrn_plain, max_pool2d, max_pool2d_bwd,
                                 max_pool2d_bwd_plain, max_pool2d_plain)
from bigdl_tpu_torch.ops import attention as attn
from bigdl_tpu_torch.ops import fp16
from bigdl_tpu_torch.ops import quant
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.core.module import tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs plain runs on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", [(3, 3, 2, 2, 1, 1, True),
                                  (3, 3, 1, 1, 1, 1, False),
                                  (2, 2, 2, 2, 0, 0, False)],
                         ids=["ceil-pad", "branch", "lenet"])
def test_max_pool_kernel_is_bit_equal_to_plain(cuda_device, dtype, geom):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randint(-3, 4, (3, 7, 13, 11), generator=g,
                      device=cuda_device).to(getattr(torch, dtype))
    y, idx = max_pool2d(x, *geom, return_indices=True)
    torch.cuda.synchronize()
    py, pidx = max_pool2d_plain(x, *geom)
    assert torch.equal(y, py) and torch.equal(idx, pidx)
    assert torch.equal(max_pool2d(x, *geom), py)


# (shape, (size, alpha, beta, k), placement) of the LRN kernels' cases:
# the three pow forms, then the edges of ops/lrn.py lrn_plan (odd planes,
# bases off 16 bytes, planes no multiple of 4 or 8 elements, C below the
# window, C = 1, C off a multiple of the chunk, sizes 1 and 4, AlexNet's
# LRNs); placement "slice" is x[1:] of a batch one image larger, "element
# 1" a copy at element 1 of a larger tensor (dy too in the backward)
LRN_CASES = {
    "beta0.75": ((2, 7, 9, 13), (5, 1.0, 0.75, 1.0), None),
    "beta0.5": ((2, 7, 9, 13), (4, 1.0, 0.5, 2.0), None),
    "powf": ((2, 7, 9, 13), (3, 0.5, 1.0, 1.0), None),
    "odd-hw-batch-slice": ((3, 7, 9, 13), (5, 1.0, 0.75, 1.0), "slice"),
    "base-off-16-bytes": ((2, 9, 8, 8), (5, 1.0, 0.75, 1.0), "element 1"),
    "hw-36": ((2, 9, 6, 6), (5, 1.0, 0.75, 1.0), None),
    "hw-34": ((2, 9, 2, 17), (5, 1.0, 0.75, 1.0), None),
    "c-3-below-size": ((2, 3, 8, 8), (5, 1.0, 0.75, 1.0), None),
    "c-1": ((2, 1, 8, 8), (5, 1.0, 0.75, 1.0), None),
    "c-7-off-the-chunk": ((4, 7, 16, 16), (5, 1.0, 0.75, 1.0), None),
    "c-97": ((1, 97, 8, 8), (5, 1.0, 0.5, 2.0), None),
    "size-1": ((2, 6, 8, 8), (1, 1.0, 0.75, 1.0), None),
    "size-4-vectors": ((2, 11, 8, 8), (4, 1.0, 0.75, 2.0), None),
    "alexnet-norm1": ((2, 96, 55, 55), (5, 1e-4, 0.75, 1.0), None),
    "alexnet-norm2": ((2, 256, 27, 27), (5, 1e-4, 0.75, 1.0), None),
}


def _placed(t, placement):
    """``t`` as the case places it (see LRN_CASES)."""
    if placement == "slice":
        big = torch.cat([torch.zeros_like(t[:1]), t])
        return big[1:]
    if placement == "element 1":
        big = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        big[1:].copy_(t.reshape(-1))
        return big[1:].view(t.shape)
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(LRN_CASES.values()),
                         ids=list(LRN_CASES))
def test_lrn_kernel_matches_plain(cuda_device, dtype, case):
    shape, params, placement = case
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = _placed(torch.randn(shape, generator=g,
                            device=cuda_device).to(getattr(torch, dtype)),
                placement)
    assert x.is_contiguous()
    y, scale = cross_map_lrn(x, *params, return_scale=True)
    torch.cuda.synchronize()
    py, pscale = lrn_plain(x, *params)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2e-2, atol=1e-2)
    torch.testing.assert_close(y.float(), py.float(), **tol)
    torch.testing.assert_close(scale.float(), pscale.float(), **tol)
    torch.testing.assert_close(cross_map_lrn(x, *params).float(), py.float(),
                               **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", [(3, 3, 2, 2, 1, 1, True),
                                  (3, 3, 1, 1, 1, 1, False),
                                  (3, 2, 2, 3, 0, 1, True),
                                  (2, 2, 2, 2, 0, 0, False)],
                         ids=["ceil-pad", "branch", "rect", "lenet"])
def test_max_pool_bwd_kernel_is_bit_equal_to_plain(cuda_device, dtype, geom):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    dt = getattr(torch, dtype)
    x = torch.randint(-3, 4, (3, 7, 13, 11), generator=g,
                      device=cuda_device).to(dt)
    _, idx = max_pool2d(x, *geom, return_indices=True)
    dy = torch.randn(tuple(idx.shape), generator=g, device=cuda_device).to(dt)
    dx = max_pool2d_bwd(dy, idx, geom, 13, 11)
    torch.cuda.synchronize()
    want = max_pool2d_bwd_plain(dy, idx, geom, 13, 11)
    assert dx.dtype == dt and torch.equal(dx, want)
    # through autograd: K1 saves the codes, K3 runs in backward
    xr = x.clone().requires_grad_()
    max_pool2d(xr, *geom).backward(dy)
    assert torch.equal(xr.grad, want)


def _offset(t):
    """t as a contiguous view at element 1 of a larger tensor (its base off
    16 bytes)."""
    big = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    big[1:].copy_(t.reshape(-1))
    return big[1:].view(t.shape)


# K1 and K3 at the edges of their plan: bases off 16 bytes (x, dy and the
# codes), planes over the shared-memory budget (bands of rows, at a fixed
# window and the generic one), rows over it (column tiles, K3's stride
# cells straddling them at 3x3/2 pad 1), many 7x7 planes a block with n*c
# not a multiple of them, ceil-mode windows wholly past the plane (-inf and
# code 0)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    ("offset", (4, 96, 28, 28), (3, 3, 1, 1, 1, 1, False), True),
    ("offset-7x7", (31, 832, 7, 7), (3, 3, 2, 2, 0, 0, True), True),
    ("bands", (2, 64, 224, 224), (3, 3, 2, 2, 0, 0, True), False),
    ("bands-generic", (2, 64, 224, 224), (3, 2, 2, 3, 0, 1, True), False),
    ("planes-a-block", (31, 832, 7, 7), (3, 3, 1, 1, 1, 1, False), False),
    ("tiles", (1, 2, 4, 30000), (3, 3, 1, 1, 1, 1, False), True),
    ("tiles-pad", (1, 3, 5, 20001), (3, 3, 2, 2, 1, 1, False), False),
    ("tiles-generic", (1, 2, 6, 30000), (2, 2, 3, 3, 0, 0, True), False),
    ("past-2x2-s3", (2, 3, 6, 6), (2, 2, 3, 3, 0, 0, True), False),
    ("past-1x1-s3", (1, 1, 5, 5), (1, 1, 3, 3, 0, 0, True), False),
], ids=lambda c: c[0])
def test_max_pool_kernels_hold_at_the_plan_edges(cuda_device, dtype, case):
    from bigdl_tpu_torch.ops import pooling
    _, shape, geom, offset = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dt)
    if offset:
        x = _offset(x)
    plans = [pooling.pool_plan(*shape, geom, dt, backward=b,
                               sms=torch.cuda.get_device_properties(0)
                               .multi_processor_count) for b in (False, True)]
    if case[0].startswith("bands"):
        assert all(p.bands > 1 for p in plans)
    if case[0].startswith("tiles"):
        assert all(p.tiles > 1 for p in plans)
    if case[0] == "planes-a-block":
        assert all(p.planes > 1 and shape[0] * shape[1] % p.planes
                   for p in plans)
    y, idx = max_pool2d(x, *geom, return_indices=True)
    torch.cuda.synchronize()
    py, pidx = max_pool2d_plain(x, *geom)
    assert torch.equal(y, py) and torch.equal(idx, pidx)
    dy = torch.randn(tuple(idx.shape), generator=g,
                     device=cuda_device).to(dt)
    if offset:
        dy, idx = _offset(dy), _offset(idx)
    dx = max_pool2d_bwd(dy, idx, geom, shape[2], shape[3])
    torch.cuda.synchronize()
    assert torch.equal(dx, max_pool2d_bwd_plain(dy, idx, geom, shape[2],
                                                shape[3]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(LRN_CASES.values()),
                         ids=list(LRN_CASES))
def test_lrn_bwd_kernel_matches_plain(cuda_device, dtype, case):
    shape, params, placement = case
    g = torch.Generator(device=cuda_device).manual_seed(3)
    dt = getattr(torch, dtype)
    x = _placed(torch.randn(shape, generator=g, device=cuda_device).to(dt),
                placement)
    dy = _placed(torch.randn(shape, generator=g, device=cuda_device).to(dt),
                 placement)
    size, alpha, beta, k = params
    _, scale = cross_map_lrn(x, *params, return_scale=True)
    dx = lrn_bwd(x, scale, dy, size, alpha, beta)
    torch.cuda.synchronize()
    want = lrn_bwd_plain(x, scale, dy, size, alpha, beta)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(dx.float(), want.float(), **tol)
    xr = x.clone().requires_grad_()
    cross_map_lrn(xr, *params).backward(dy)
    torch.testing.assert_close(xr.grad.float(), want.float(), **tol)


def test_kernel_launches_are_counted(cuda_device):
    x = torch.randn((2, 4, 8, 8), device=cuda_device)
    wrappers = (max_pool2d, cross_map_lrn, max_pool2d_bwd, lrn_bwd)
    before = [fn.launches for fn in wrappers]
    max_pool2d(x, 2, 2, 2, 2)
    cross_map_lrn(x)
    xr = x.clone().requires_grad_()
    (max_pool2d(xr, 2, 2, 2, 2).sum() + cross_map_lrn(xr).sum()).backward()
    torch.cuda.synchronize()
    assert [fn.launches for fn in wrappers] == \
        [before[0] + 2, before[1] + 2, before[2] + 1, before[3] + 1]
    with pytest.raises(ValueError, match="contiguous"):
        max_pool2d(x.transpose(2, 3), 2, 2, 2, 2)


# ragged shapes; then the bf16 kernel's edges: M at its 64- and 128-row
# tiles, N 8, 24, 256, 257 and 384, K 600 (8-byte weight rows) and odd K
# (byte rows, x not by TMA), 192-row tiles with M and K ragged; then
# shapes its plan splits over K, unevenly; then the f32 kernel's edges: N
# 16, 24 and 32 (the 32-column tile), 48 (the 64-column one) and 257, M
# around its 128- and 256-row tiles, K % 4 != 0 (x by 4-byte copies); and
# the classifier at buckets 8 and 32 (K14 and the f32 kernel split K)
MATMUL_SHAPES = [(1, 7, 5), (13, 33, 17), (37, 130, 70), (129, 576, 192),
                 (300, 1024, 1000), (2, 1728, 384),
                 (63, 64, 8), (64, 600, 24), (65, 192, 256), (127, 256, 257),
                 (128, 333, 384), (129, 200, 56), (25400, 72, 40),
                 (1568, 832, 160), (392, 1200, 128),
                 (127, 64, 16), (128, 96, 24), (257, 36, 32), (255, 130, 48),
                 (256, 577, 257), (129, 1001, 130), (8, 1024, 1000),
                 (32, 1024, 1000)]
# shapes the bf16 plan splits over K: 13 steps in 7 splits, the classifier
# (16 in 16), 9 in 2
SPLIT_SHAPES = [(1568, 832, 160), (32, 1024, 1000), (6272, 528, 32)]


def _sum_close(got, want, x, wide, dtype):
    bound = 1e-4 * (x.float().abs() @ wide.float().abs().t())
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * want.float().abs()
    return bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", MATMUL_SHAPES,
                         ids=["x".join(map(str, s)) for s in MATMUL_SHAPES])
def test_quant_matmul_kernels_match_plain(cuda_device, mkn, dtype):
    m, k, n = mkn
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda_device).to(dt)
    w = torch.randn((n, k), generator=g, device=cuda_device)
    for mode in ("w8", "f8", "w4"):
        qt = quant.pack(w, mode=mode)
        if mode == "w4":
            got = quant.w4_matmul(x, qt["q4"], qt["scale"], k)
            want = quant.int4_matmul_plain(x, qt["q4"], qt["scale"], k)
        else:
            fn = quant.w8_matmul if mode == "w8" else quant.f8_matmul
            got = fn(x, qt[mode.replace("w", "q")], qt["scale"])
            want = quant.int8_matmul_plain(x, qt[mode.replace("w", "q")],
                                           qt["scale"])
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == (m, n)
        assert _sum_close(got, want, x, quant.unpack(qt), dt), mode
    qt = quant.pack(w, sx=0.05)
    xq = quant.quantize_act(x, qt["sx"])
    s = qt["scale"] * qt["sx"]
    got = quant.a8_matmul(xq, qt["q8"], s, dt)
    torch.cuda.synchronize()
    assert torch.equal(got, quant.int8_a8_matmul_plain(xq, qt["q8"], s, dt))


# x at row 1 of a larger tensor: k 1001 puts it off 16 bytes (f32: 4-byte
# copies; bf16: x by loads)
OFFSET_SHAPES = [(33, 1001, 48), (130, 512, 96)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", OFFSET_SHAPES,
                         ids=["x".join(map(str, s)) for s in OFFSET_SHAPES])
def test_quant_matmul_kernels_take_x_at_row_1(cuda_device, mkn, dtype):
    m, k, n = mkn
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(m + k)
    x = torch.randn((m + 1, k), generator=g, device=cuda_device).to(dt)[1:]
    w = torch.randn((n, k), generator=g, device=cuda_device)
    for fn, qt, args in _dequant_calls(x, w, k):
        got = fn(*args)
        want = quant.int4_matmul_plain(*args) if fn is quant.w4_matmul \
            else quant.int8_matmul_plain(*args)
        torch.cuda.synchronize()
        assert _sum_close(got, want, x, quant.unpack(qt), dt), fn.__name__
    qt = quant.pack(w, sx=0.05)
    xq = quant.quantize_act(x.float(), qt["sx"])
    xq = torch.cat([xq[:1], xq])[1:]     # int8 x at row 1 too
    s = qt["scale"] * qt["sx"]
    got = quant.a8_matmul(xq, qt["q8"], s, dt)
    torch.cuda.synchronize()
    assert torch.equal(got, quant.int8_a8_matmul_plain(xq, qt["q8"], s, dt))


def _dequant_calls(x, w, k):
    """(wrapper, packed weight, args) of K13 int8, K13 e4m3 and K15."""
    out = []
    for mode, fn, key in (("w8", quant.w8_matmul, "q8"),
                          ("f8", quant.f8_matmul, "f8"),
                          ("w4", quant.w4_matmul, "q4")):
        qt = quant.pack(w, mode=mode)
        out.append((fn, qt, (x, qt[key], qt["scale"]) +
                    ((k,) if mode == "w4" else ())))
    return out


@pytest.mark.parametrize("mkn", SPLIT_SHAPES,
                         ids=["x".join(map(str, s)) for s in SPLIT_SHAPES])
def test_split_k_matches_plain(cuda_device, mkn):
    m, k, n = mkn
    for nibbles in (False, True):
        plan = quant.bf16_plan(m, k, n, nibbles)
        assert plan.splits > 1
    g = torch.Generator(device=cuda_device).manual_seed(m + k)
    x = torch.randn((m, k), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    w = torch.randn((n, k), generator=g, device=cuda_device)
    for fn, qt, args in _dequant_calls(x, w, k):
        got = fn(*args)
        if fn is quant.w4_matmul:
            want = quant.int4_matmul_plain(*args)
        else:
            want = quant.int8_matmul_plain(*args)
        torch.cuda.synchronize()
        assert _sum_close(got, want, x, quant.unpack(qt), torch.bfloat16), \
            fn.__name__


@pytest.mark.parametrize("mkn", [(1568, 832, 160), (100352, 576, 192)],
                         ids=["split-k", "conv2"])
def test_k13_and_k15_are_bit_equal_across_launches(cuda_device, mkn):
    # no atomics: a split's partial sums are added in split order
    m, k, n = mkn
    g = torch.Generator(device=cuda_device).manual_seed(k + n)
    x = torch.randn((m, k), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    w = torch.randn((n, k), generator=g, device=cuda_device)
    for fn, _, args in _dequant_calls(x, w, k):
        a, b = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert torch.equal(a, b), fn.__name__


@pytest.mark.parametrize("mkn", [(1568, 832, 160), (32, 1024, 1000)],
                         ids=["split-k", "classifier"])
def test_f32_k13_and_k15_are_bit_equal_across_launches(cuda_device, mkn):
    # the f32 kernel splits K at both; its partial sums are added in order
    m, k, n = mkn
    for nibbles in (False, True):
        assert quant.f32_plan(m, k, n, nibbles).splits > 1
    g = torch.Generator(device=cuda_device).manual_seed(k + n)
    x = torch.randn((m, k), generator=g, device=cuda_device)
    w = torch.randn((n, k), generator=g, device=cuda_device)
    for fn, qt, args in _dequant_calls(x, w, k):
        a, b = fn(*args), fn(*args)
        want = quant.int4_matmul_plain(*args) if fn is quant.w4_matmul \
            else quant.int8_matmul_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(a, b), fn.__name__
        assert _sum_close(a, want, x, quant.unpack(qt), torch.float32), \
            fn.__name__


# K14's split edges: the classifier at buckets 8 and 32 (16 N tiles, 8
# splits of one step), 20 tiles of 256 columns, and a ragged last step
A8_SPLIT_SHAPES = [(8, 1024, 1000), (32, 1024, 1000), (300, 1024, 1000),
                   (130, 1000, 96)]


@pytest.mark.parametrize("mkn", A8_SPLIT_SHAPES,
                         ids=["x".join(map(str, s)) for s in A8_SPLIT_SHAPES])
def test_k14_is_bit_equal_at_its_splits(cuda_device, mkn):
    # the last block of each tile adds the int32 partial sums (a ticket):
    # bit-equal to plain, launch after launch, the tickets left at zero
    m, k, n = mkn
    assert quant.a8_plan(m, k, n).splits > 1
    g = torch.Generator(device=cuda_device).manual_seed(m + n)
    x = torch.randn((m, k), generator=g, device=cuda_device)
    qt = quant.pack(torch.randn((n, k), generator=g, device=cuda_device),
                    sx=3.0 / 127)
    xq = quant.quantize_act(x, qt["sx"])
    s = qt["scale"] * qt["sx"]
    for dt in (torch.float32, torch.bfloat16):
        want = quant.int8_a8_matmul_plain(xq, qt["q8"], s, dt)
        for _ in range(3):
            got = quant.a8_matmul(xq, qt["q8"], s, dt)
            torch.cuda.synchronize()
            assert torch.equal(got, want), dt
    assert not quant._a8_tickets(xq).any()


def test_quant_kernel_launches_are_counted(cuda_device):
    x = torch.randn((4, 64), device=cuda_device)
    w = torch.randn((32, 64), device=cuda_device)
    wrappers = (quant.w8_matmul, quant.f8_matmul, quant.a8_matmul,
                quant.w4_matmul)
    before = [fn.launches for fn in wrappers]
    for mode, sx in (("w8", None), ("f8", None), ("w8", 0.1), ("w4", None)):
        quant.int8_matmul(x, quant.pack(w, sx=sx, mode=mode))
    torch.cuda.synchronize()
    assert [fn.launches for fn in wrappers] == [b + 1 for b in before]
    qt = quant.pack(w)
    with pytest.raises(ValueError, match="contiguous"):
        quant.w8_matmul(x.t().contiguous().t(), qt["q8"], qt["scale"])


# (b, h, hk, t, tk, d, causal, padded lengths or None)
ATTN_CASES = [
    (2, 8, 2, 24, 24, 64, True, None),      # GQA 8/2, T = 24
    (1, 8, 1, 8, 8, 32, True, None),        # MQA, T = 8, head dim 32
    (1, 4, 4, 70, 33, 128, True, None),     # Tq != Tk, head dim 128
    (2, 2, 2, 40, 56, 16, False, None),     # non-causal, head dim 16
    (2, 4, 2, 96, 96, 64, True, [0, 50]),   # a row with every key padded
    (3, 4, 4, 130, 130, 64, False, [130, 64, 1]),
]
ATTN_IDS = ["gqa", "mqa-t8", "tq-ne-tk-d128", "noncausal-d16", "all-padded",
            "noncausal-padded"]


def _attn_close(got, want, mag, dtype):
    tol = (1e-5 if dtype == torch.float32 else 2 * 2.0 ** -7) * mag
    return bool(((got.float() - want.float()).abs() <= tol).all()) and \
        bool(torch.isfinite(got).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=ATTN_IDS)
def test_attention_kernels_match_plain(cuda_device, case, dtype):
    b, h, hk, t, tk, d, causal, lengths = case
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(t + tk + d)
    q = torch.randn((b, h, t, d), generator=g, device=cuda_device).to(dt)
    k = torch.randn((b, hk, tk, d), generator=g, device=cuda_device).to(dt)
    v = torch.randn((b, hk, tk, d), generator=g, device=cuda_device).to(dt)
    bias = None
    if lengths is not None:
        keep = torch.arange(tk, device=cuda_device)[None, :] < \
            torch.tensor(lengths, device=cuda_device)[:, None]
        bias = torch.where(keep, 0.0, attn.NEG_INF).float()
    else:
        got = attn.attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        want = attn.attention_reference(q, k, v, causal)
        mag = attn.attention_reference(q.float(), k.float(),
                                       v.float().abs(), causal)
        assert got.dtype == dt and got.shape == q.shape
        assert _attn_close(got, want, mag, dt)
    got = attn.attention_stream_fwd(q, k, v, causal, None, bias)
    torch.cuda.synchronize()
    want = attn.attention_stream_plain(q, k, v, causal, None, bias)
    mag = attn.attention_stream_plain(q.float(), k.float(), v.float().abs(),
                                      causal, None, bias)
    assert got.dtype == dt and got.shape == q.shape
    assert _attn_close(got, want, mag, dt)
    if lengths is not None and 0 in lengths:
        assert not got[lengths.index(0)].float().abs().any()


@pytest.mark.parametrize("d", [160, 256, 320, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_take_every_head_dim(cuda_device, dtype, d):
    # 160 zero-padded to 256 and 256 itself on the wgmma (bf16) and FFMA
    # (f32) kernels; 320 and 512 on the D-chunked kernels of either dtype:
    # K8, K9 with its LSE, K10 and K11 at test_flash_kernels_match_plain's
    # tolerances, one launch each
    dt = getattr(torch, dtype)
    wrappers = (attn.attention_fwd, attn.attention_stream_fwd,
                attn.attention_stream_bwd_dq, attn.attention_stream_bwd_dkv)
    before = [f.launches for f in wrappers]
    case = (2, 4, 2, 130, 130, d, True, [130, 77])
    q, k, v, do, bias = _flash_inputs(case, dt, cuda_device)
    got = attn.attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    mag = attn.attention_reference(q.float(), k.float(), v.float().abs(),
                                   True)
    assert got.shape == q.shape
    assert _attn_close(got, attn.attention_reference(q, k, v, True), mag, dt)
    o, lse = attn.attention_stream_plain(q, k, v, True, None, bias,
                                         with_lse=True)
    got_o, got_lse = attn._launch(attn.attention_stream_fwd,
                                  "bigdl_attention_stream_fwd", q, k, v, bias,
                                  True, d ** -0.5, with_lse=True)
    dq = attn.attention_stream_bwd_dq(q, k, v, o, lse, do, True, None, bias)
    dk, dv = attn.attention_stream_bwd_dkv(q, k, v, o, lse, do, True, None,
                                           bias)
    torch.cuda.synchronize()
    mag = attn.attention_stream_plain(q.float(), k.float(), v.float().abs(),
                                      True, None, bias)
    assert got_o.shape == q.shape and _attn_close(got_o, o, mag, dt)
    assert ((got_lse - lse).abs() <= 1e-5 * lse.abs().clamp_min(1.0)).all()
    rtol = 1e-4 if dt == torch.float32 else 2 * 2.0 ** -7
    for a, w in zip((dq, dk, dv),
                    attn.flash_bwd_plain(q, k, v, o, lse, do, True, None,
                                         bias)):
        assert a.shape == w.shape and torch.isfinite(a).all()
        assert (a.float() - w.float()).abs().max().item() <= \
            rtol * w.float().abs().max().item()
    assert [f.launches - n for f, n in zip(wrappers, before)] == [1] * 4


@pytest.mark.parametrize("case", [(2, 8, 2, 200, 200, 64, True, None),
                                  (3, 4, 4, 130, 130, 128, True,
                                   [130, 0, 77])],
                         ids=["ragged-t200", "padded"])
def test_bf16_k8_and_k9_are_bit_equal_across_launches(cuda_device, case):
    # each row's sums run over its key tiles in a fixed order: no atomics,
    # no split over blocks
    q, k, v, _, bias = _flash_inputs(case, torch.bfloat16, cuda_device)
    runs = [lambda: attn.attention_stream_fwd(q, k, v, True, None, bias)]
    if bias is None:
        runs.append(lambda: attn.attention_fwd(q, k, v, True))
    for run in runs:
        a, b = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(a, b)


# the f32 K8/K9's block edges (128 query rows up to head dim 128, 64 at
# 256; key tiles of 64, 32 at 256): T one short of, equal to and past a
# block, GQA 8/2 at head dims 128 and 256 with T not a multiple of the
# block, key-padding holes ((lo, hi): keys [lo, hi) padded) that pad whole
# tiles inside a block's causal range, Tq < Tk without the causal mask
F32_EDGE_CASES = [
    (2, 4, 2, 127, 127, 64, True, None),
    (2, 4, 2, 128, 128, 64, True, None),
    (2, 4, 2, 129, 129, 64, True, None),
    (1, 8, 2, 257, 257, 64, True, None),
    (2, 8, 2, 200, 200, 128, True, None),
    (2, 8, 2, 100, 100, 256, True, None),
    (2, 4, 2, 384, 384, 64, True, [(64, 256), 0]),
    (1, 4, 4, 200, 200, 256, True, [(40, 130)]),
    (1, 4, 4, 100, 300, 64, False, None),
    (2, 4, 4, 100, 300, 64, False, [300, 150]),
]
F32_EDGE_IDS = ["t127", "t128", "t129", "t257", "gqa-d128-t200",
                "gqa-d256-t100", "hole-and-all-padded", "hole-d256",
                "tq-lt-tk", "tq-lt-tk-padded"]


def _f32_fwd_close(case, device):
    """The f32 K8 (on a case without padding) and K9 with its LSE against
    their plain versions: o within 1e-5 of each output's sum |p·v|, lse
    within 1e-5 of max(1, |lse|); a row with every key padded gives o = 0
    and lse about NEG_INF."""
    causal, lengths = case[6], case[7]
    q, k, v, _, bias = _flash_inputs(case, torch.float32, device)
    if bias is None:
        got = attn.attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        mag = attn.attention_reference(q, k, v.abs(), causal)
        assert got.shape == q.shape
        assert _attn_close(got, attn.attention_reference(q, k, v, causal),
                           mag, torch.float32)
    o, lse = attn.attention_stream_plain(q, k, v, causal, None, bias,
                                         with_lse=True)
    got_o, got_lse = attn._launch(attn.attention_stream_fwd,
                                  "bigdl_attention_stream_fwd", q, k, v, bias,
                                  causal, case[5] ** -0.5, with_lse=True)
    torch.cuda.synchronize()
    mag = attn.attention_stream_plain(q, k, v.abs(), causal, None, bias)
    assert got_o.shape == q.shape and _attn_close(got_o, o, mag,
                                                  torch.float32)
    assert ((got_lse - lse).abs() <= 1e-5 * lse.abs().clamp_min(1.0)).all()
    if lengths is not None and 0 in lengths:
        row = lengths.index(0)
        assert not got_o[row].abs().any()
        assert (got_lse[row] <= attn.NEG_INF / 2).all()


@pytest.mark.parametrize("case", F32_EDGE_CASES, ids=F32_EDGE_IDS)
def test_f32_attention_kernels_at_the_block_edges(cuda_device, case):
    _f32_fwd_close(case, cuda_device)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_f32_attention_kernels_take_every_head_dim(cuda_device, d):
    # each head dim's own tiles (rows a thread, keys a tile, warps a
    # block), GQA 4/2, a T past one block, a row with every key padded
    _f32_fwd_close((2, 4, 2, 130, 130, d, True, None), cuda_device)
    _f32_fwd_close((2, 4, 2, 130, 130, d, True, [130, 0]), cuda_device)


@pytest.mark.parametrize("case", [(2, 8, 2, 257, 257, 64, True, [257, 100]),
                                  (2, 4, 4, 130, 130, 256, True, [130, 77])],
                         ids=["gqa-t257", "d256"])
def test_f32_k8_and_k9_are_bit_equal_across_launches(cuda_device, case):
    # each row's sums run over its key tiles in a fixed order: no atomics,
    # no split over blocks; K9 with the bias and its LSE
    q, k, v, _, bias = _flash_inputs(case, torch.float32, cuda_device)
    runs = [lambda: (attn.attention_fwd(q, k, v, True),),
            lambda: attn._launch(attn.attention_stream_fwd,
                                 "bigdl_attention_stream_fwd", q, k, v, bias,
                                 True, case[5] ** -0.5, with_lse=True)]
    for run in runs:
        a, b = run(), run()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_k9_backward_runs_k10_and_k11(cuda_device):
    # K9's backward is the flash backward: one K10 and one K11 launch, and
    # the gradients of autograd of the plain form (see the tolerances of
    # test_flash_kernels_match_plain); K8's is autograd of the chunked
    # plain form (test_k8_backward_...)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn((1, 2, 80, 32), generator=g, device=cuda_device)
               for _ in range(3))
    bias = torch.zeros((1, 80), device=cuda_device)
    bias[:, 60:] = attn.NEG_INF
    names = (attn.attention_stream_fwd, attn.flash_bwd_delta,
             attn.attention_stream_bwd_dq, attn.attention_stream_bwd_dkv)
    before = [f.launches for f in names]
    ours = [x.clone().requires_grad_() for x in (q, k, v)]
    o = attn.attention_stream_fwd(*ours, True, None, bias)
    assert o.requires_grad
    o.sum().backward()
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    attn.attention_reference(*ref, True,
                             mask=(bias > -1)[:, None, None, :]).sum() \
        .backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(names, before)] == [1, 1, 1, 1]
    for a, r in zip(ours, ref):
        assert (a.grad - r.grad).abs().max().item() <= \
            1e-4 * r.grad.abs().max().item()


@pytest.mark.parametrize("shape", [(1, 4, 4, 256, 64), (2, 8, 2, 128, 48),
                                   (1, 2, 2, 2048, 64)],
                         ids=["t256", "gqa-d48", "t2048"])
def test_k8_backward_matches_autograd_of_the_plain_form(cuda_device, shape):
    b, h, hk, t, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(t + d)
    q, k, v = (torch.randn(sh, generator=g, device=cuda_device)
               for sh in ((b, h, t, d), (b, hk, t, d), (b, hk, t, d)))
    do = torch.randn((b, h, t, d), generator=g, device=cuda_device)
    before = attn.attention_fwd.launches
    ours = [x.clone().requires_grad_() for x in (q, k, v)]
    o = attn.attention_fwd(*ours, True)
    o.backward(do)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    attn.attention_reference(*ref, True).backward(do)
    torch.cuda.synchronize()
    assert attn.attention_fwd.launches == before + 1
    for a, r in zip(ours, ref):
        tol = 1e-4 * r.grad.abs().max().item()
        assert (a.grad - r.grad).abs().max().item() <= tol


# -- K9 with its LSE, K10, K11 -----------------------------------------------

# (b, h, hk, t, tk, d, causal, padded lengths or None)
FLASH_CASES = [
    (2, 8, 2, 130, 130, 64, True, None),    # GQA 8/2, T not a multiple of 64
    (1, 8, 1, 72, 200, 32, True, None),     # MQA, Tq < Tk
    (2, 4, 4, 100, 40, 16, False, None),    # Tq > Tk, non-causal
    (3, 4, 2, 96, 96, 64, True, [96, 0, 41]),   # a row with every key padded
    (2, 4, 4, 72, 72, 128, False, [72, 30]),
    (1, 4, 2, 50, 50, 48, True, None),      # head dim 48, padded to 64
    # the edges of the bf16 kernels' 64-row and 64-key tiles, MQA at the
    # long-context length, the wgmma widths N 16 and 128 with the causal mask
    (1, 8, 8, 63, 63, 64, True, None),
    (1, 8, 8, 64, 64, 64, True, None),
    (1, 8, 8, 65, 65, 64, True, None),
    (1, 8, 1, 8191, 8191, 64, True, None),
    (1, 4, 4, 300, 300, 16, True, None),
    (1, 4, 2, 300, 300, 128, True, None),
    # the edges of the f32 kernels' tiles: 128 x 64 up to d 64, 64 x 64
    # (K10) and 64 x 32 (K11) at d 128, 32 x 32 at d 256; a padded GQA
    # batch whose second row leaves whole tiles padded
    (1, 8, 8, 127, 127, 64, True, None),
    (1, 8, 8, 128, 128, 64, True, None),
    (1, 8, 8, 129, 129, 64, True, None),
    (1, 4, 4, 64, 64, 128, True, None),
    (2, 8, 2, 2049, 2049, 64, True, [2049, 1500]),
    (1, 4, 4, 31, 31, 128, True, None),
    (1, 4, 2, 33, 33, 128, True, None),
    (1, 4, 4, 32, 32, 256, True, None),
    (1, 4, 2, 33, 33, 256, True, None),
    (1, 8, 2, 65, 65, 32, True, None),
]
FLASH_IDS = ["gqa-t130", "mqa-tq-lt-tk", "tq-gt-tk-noncausal-d16",
             "all-padded", "padded-d128", "d48", "t63", "t64", "t65",
             "mqa-t8191", "causal-d16", "causal-d128", "t127", "t128",
             "t129", "t64-d128", "gqa-t2049-padded", "t31-d128", "gqa-t33-d128", "t32-d256",
             "gqa-t33-d256", "gqa-t65-d32"]


def _flash_inputs(case, dt, device):
    b, h, hk, t, tk, d, causal, lengths = case
    g = torch.Generator(device=device).manual_seed(t + tk + d)
    q = torch.randn((b, h, t, d), generator=g, device=device).to(dt)
    k = torch.randn((b, hk, tk, d), generator=g, device=device).to(dt)
    v = torch.randn((b, hk, tk, d), generator=g, device=device).to(dt)
    do = torch.randn((b, h, t, d), generator=g, device=device).to(dt)
    bias = None
    if lengths is not None:   # a length, or a (lo, hi) hole of padded keys
        pos = torch.arange(tk, device=device)
        keep = torch.stack([
            (pos < n) if isinstance(n, int) else (pos < n[0]) | (pos >= n[1])
            for n in lengths])
        bias = torch.where(keep, 0.0, attn.NEG_INF).float()
    return q, k, v, do, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_flash_kernels_match_plain(cuda_device, case, dtype):
    """K9 with its LSE (o as above, lse within 1e-5 of max(1, |lse|)), K10
    and K11 (each gradient within 1e-4 of its largest magnitude in float32,
    two bfloat16 steps of it in bfloat16: ds and p are rounded where the
    reference rounds them, and a rounding can land one step apart) against
    their plain versions on the plain forward's o and lse."""
    dt = getattr(torch, dtype)
    causal, lengths = case[6], case[7]
    q, k, v, do, bias = _flash_inputs(case, dt, cuda_device)
    o, lse = attn.attention_stream_plain(q, k, v, causal, None, bias,
                                         with_lse=True)
    got_o, got_lse = attn._launch(attn.attention_stream_fwd,
                                  "bigdl_attention_stream_fwd", q, k, v, bias,
                                  causal, case[5] ** -0.5, with_lse=True)
    dq = attn.attention_stream_bwd_dq(q, k, v, o, lse, do, causal, None,
                                      bias)
    dk, dv = attn.attention_stream_bwd_dkv(q, k, v, o, lse, do, causal, None,
                                           bias)
    torch.cuda.synchronize()
    mag = attn.attention_stream_plain(q.float(), k.float(), v.float().abs(),
                                      causal, None, bias)
    assert _attn_close(got_o, o, mag, dt)
    assert ((got_lse - lse).abs() <= 1e-5 * lse.abs().clamp_min(1.0)).all()
    want = attn.flash_bwd_plain(q, k, v, o, lse, do, causal, None, bias)
    rtol = 1e-4 if dt == torch.float32 else 2 * 2.0 ** -7
    for a, w in zip((dq, dk, dv), want):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert torch.isfinite(a).all()
        assert (a.float() - w.float()).abs().max().item() <= \
            rtol * w.float().abs().max().item()
    if lengths is not None and 0 in lengths:
        row = lengths.index(0)
        assert not any(x[row].float().abs().any() for x in (dq, dk, dv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[3],
                                  FLASH_CASES[11]],
                         ids=["gqa-t130", "all-padded", "causal-d128"])
def test_delta_pass_matches_plain(cuda_device, case, dtype):
    # rowsum(dO·O) in f32 from 16-byte loads, 8 lanes a row: within 1e-5 of
    # each row's sum |dO·O| (f32 sums in another order); dO in f32 is cast
    # to o's dtype first
    dt = getattr(torch, dtype)
    q, k, v, do, bias = _flash_inputs(case, dt, cuda_device)
    o, _ = attn.attention_stream_plain(q, k, v, case[6], None, bias,
                                       with_lse=True)
    before = attn.flash_bwd_delta.launches
    for d in (do, do.float()):
        got = attn.flash_bwd_delta(o, d)
        torch.cuda.synchronize()
        want = attn.flash_bwd_delta_plain(o, d)
        mag = (d.to(dt).float() * o.float()).abs().sum(dim=-1)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert ((got - want).abs() <= 1e-5 * mag).all()
    assert attn.flash_bwd_delta.launches == before + 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k10_is_bit_equal_across_launches(cuda_device, dtype):
    # no atomics: the sums over a block's key tiles have a fixed order
    dt = getattr(torch, dtype)
    q, k, v, do, bias = _flash_inputs(FLASH_CASES[3], dt, cuda_device)
    o, lse = attn.attention_stream_plain(q, k, v, True, None, bias,
                                         with_lse=True)
    a = attn.attention_stream_bwd_dq(q, k, v, o, lse, do, True, None, bias)
    b = attn.attention_stream_bwd_dq(q, k, v, o, lse, do, True, None, bias)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k11_is_bit_equal_across_launches(cuda_device, dtype):
    # no atomics: the sums over a GQA group's query tiles have a fixed order
    dt = getattr(torch, dtype)
    q, k, v, do, bias = _flash_inputs(FLASH_CASES[3], dt, cuda_device)
    o, lse = attn.attention_stream_plain(q, k, v, True, None, bias,
                                         with_lse=True)
    a = attn.attention_stream_bwd_dkv(q, k, v, o, lse, do, True, None, bias)
    b = attn.attention_stream_bwd_dkv(q, k, v, o, lse, do, True, None, bias)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k10_and_k11_are_bit_equal_at_head_dim_256(cuda_device, dtype):
    # the bf16 ring of two stages and K11's column halves, the f32 tiles of
    # 32 rows x 32 keys: still no atomics
    dt = getattr(torch, dtype)
    q, k, v, do, bias = _flash_inputs((2, 4, 2, 130, 130, 256, True,
                                       [130, 0]), dt, cuda_device)
    o, lse = attn.attention_stream_plain(q, k, v, True, None, bias,
                                         with_lse=True)
    args = (q, k, v, o, lse, do, True, None, bias)
    for fn in (lambda: (attn.attention_stream_bwd_dq(*args),),
               lambda: attn.attention_stream_bwd_dkv(*args)):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# -- K12 ------------------------------------------------------------------------

# (b, h, hkv, s, d, page size, lp, tokens per row (0: an inactive row with
# an all-trash table), integer-valued q/k at scale 0.3, so |s| ~ 30)
PAGED_CASES = [
    (3, 8, 2, 1, 64, 16, 8, [100, 37, 1], False),
    (2, 8, 1, 2, 32, 5, 9, [44, 7], False),
    (2, 4, 4, 33, 128, 8, 10, [70, 33], False),
    (3, 8, 8, 1, 64, 16, 4, [50, 0, 64], False),
    (2, 8, 8, 4, 64, 16, 6, [90, 17], True),
    (2, 4, 2, 3, 48, 4, 20, [77, 3], False),
    # the tensor-core path in bf16 (the page split in f32): 68 packed GQA
    # rows across its 64-row tile, page sizes 5 and 8, head dims 128 and
    # 256, large scores, an all-trash row
    (2, 8, 2, 17, 64, 16, 8, [100, 40], False),
    (1, 8, 2, 20, 128, 5, 30, [140], False),
    (2, 4, 1, 32, 256, 8, 20, [150, 0], False),
    (2, 8, 1, 16, 64, 16, 6, [90, 17], True),
    # a 65 536-token table, past the old kernel's limit (a row of L scores
    # in shared memory): decode on the page split, 64 rows on either path
    (2, 4, 4, 1, 64, 16, 4096, [40000, 65536], False),
    (1, 2, 2, 64, 64, 16, 4096, [65536], False),
]
PAGED_IDS = ["gqa-decode", "mqa-ps5", "prefill-d128", "inactive-row",
             "large-scores", "d48-ps4", "gqa-68-rows", "ps5-d128-80-rows",
             "ps8-d256-128-rows", "large-scores-64-rows", "table-65536",
             "table-65536-64-rows"]


def paged_operands(case, dtype, cache_dtype, device, seed):
    """q, pools (NaN on the trash page), page table and positions of a
    case, and its scale: each row's pages drawn from a shuffled pool, its
    S queries at the last S of its tokens."""
    b, h, hkv, s, d, ps, lp, lengths, large = case
    g = torch.Generator().manual_seed(seed)
    p = sum(-(-n // ps) for n in lengths) + 3
    if large:
        q = torch.randint(-3, 4, (b, h, s, d), generator=g).float()
        k = torch.randint(-3, 4, (p + 1, hkv, ps, d), generator=g).float()
    else:
        q = torch.randn((b, h, s, d), generator=g)
        k = torch.randn((p + 1, hkv, ps, d), generator=g)
    v = torch.randn((p + 1, hkv, ps, d), generator=g)
    k[p], v[p] = float("nan"), float("nan")
    perm = torch.randperm(p, generator=g).int()
    pages = torch.full((b, lp), p, dtype=torch.int32)
    positions = torch.empty((b, s), dtype=torch.int32)
    used = 0
    for r, n in enumerate(lengths):
        if n == 0:
            positions[r] = torch.arange(s) + 5
            continue
        np_ = -(-n // ps)
        pages[r, :np_] = perm[used:used + np_]
        used += np_
        positions[r] = torch.arange(n - s, n)
    scale = 0.3 if large else d ** -0.5
    return (q.to(device, dtype), k.to(device, cache_dtype),
            v.to(device, cache_dtype), pages.to(device),
            positions.to(device), scale)


def _paged_close(ops, dtype):
    q, k, v, pages, positions, scale = ops
    got = attn.paged_attention(q, k, v, pages, positions, scale)
    torch.cuda.synchronize()
    want = attn.paged_attention_plain(q, k, v, pages, positions, scale)
    mag = attn.paged_attention_plain(q.float(), k.float(), v.float().abs(),
                                     pages, positions, scale)
    assert got.dtype == k.dtype and got.shape == q.shape
    return _attn_close(got, want, mag, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED_CASES, ids=PAGED_IDS)
def test_paged_attention_kernel_matches_plain(cuda_device, case, dtype):
    dt = getattr(torch, dtype)
    before = attn.paged_attention.launches
    assert _paged_close(paged_operands(case, dt, dt, cuda_device, 7), dt)
    assert attn.paged_attention.launches == before + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [PAGED_CASES[0], PAGED_CASES[6],
                                  PAGED_CASES[8]],
                         ids=["gqa-decode", "gqa-68-rows",
                              "ps8-d256-128-rows"])
def test_paged_attention_kernel_is_bit_equal_across_launches(cuda_device,
                                                             case, dtype):
    # the page split adds its partials in split order and the tensor-core
    # path walks a row's tiles in order: no atomics
    dt = getattr(torch, dtype)
    ops = paged_operands(case, dt, dt, cuda_device, 9)
    b, h, hkv, s, d, ps, lp = case[:7]
    plan = attn.paged_plan(b, h, hkv, s, d, ps, lp, dt, dt)
    assert plan.path == ("tensor_core" if dt == torch.bfloat16 and s > 1
                         else "split")
    a, c = attn.paged_attention(*ops), attn.paged_attention(*ops)
    torch.cuda.synchronize()
    assert torch.equal(a, c)


@pytest.mark.parametrize("pair", [("float32", "bfloat16"),
                                  ("bfloat16", "float32")],
                         ids=["f32-q-bf16-cache", "bf16-q-f32-cache"])
def test_paged_attention_kernel_mixed_dtypes(cuda_device, pair):
    qdt, cdt = (getattr(torch, x) for x in pair)
    for case in PAGED_CASES[:2]:
        assert _paged_close(paged_operands(case, qdt, cdt, cuda_device, 8),
                            cdt)


@pytest.mark.parametrize("d", [48, 80, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_at_other_head_dims(cuda_device, dtype, d):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q = torch.randn((2, 4, 40, d), generator=g, device=cuda_device).to(dt)
    k = torch.randn((2, 2, 40, d), generator=g, device=cuda_device).to(dt)
    v = torch.randn((2, 2, 40, d), generator=g, device=cuda_device).to(dt)
    for kern, plain in ((attn.attention_fwd, attn.attention_reference),
                        (attn.attention_stream_fwd,
                         attn.attention_stream_plain)):
        got = kern(q, k, v, True)
        torch.cuda.synchronize()
        mag = plain(q.float(), k.float(), v.float().abs(), True)
        assert got.shape == q.shape
        assert _attn_close(got, plain(q, k, v, True), mag, dt)
    case = (2, 4, 2, 3, d, 8, 6, [41, 9], False)
    assert _paged_close(paged_operands(case, dt, dt, cuda_device, d), dt)


# float32 bits and wire values of the codec's special cases: signed zeros,
# subnormals, the smallest and largest normals, infinities, quiet and
# signalling NaNs with high and low payloads, +-1
CODEC_F32 = [0x00000000, 0x80000000, 0x00000001, 0x807FFFFF, 0x00010000,
             0x00800000, 0x80800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F800000,
             0xFF800000, 0x7F800001, 0x7FA00000, 0x7FC00000, 0xFFC00000,
             0x7FFFFFFF, 0x3F800000, 0x3F80FFFF, 0xBF818000]
CODEC_U16 = [0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x807F, 0x0080,
             0x8080, 0x0081, 0x8081, 0x0100, 0x7F7F, 0xFF7F, 0x7F80, 0xFF80,
             0x7F81, 0xFFBF, 0x7FC0, 0xFFC0, 0x7FFF, 0x3F80, 0xBF80]


def _u16_nan(u):
    w = u.to(torch.int32)
    return ((w & 0x7F80) == 0x7F80) & ((w & 0x7F) != 0)


def _same_bits(got, want):
    """Bit-equal where ``want`` is not a NaN; a NaN where it is."""
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == torch.float32:
        nan = torch.isnan(want)
        same = torch.isnan(got) == nan
        bits = got.view(torch.int32) == want.view(torch.int32)
    else:
        nan = _u16_nan(want)
        same = _u16_nan(got) == nan
        bits = got.to(torch.int32) == want.to(torch.int32)
    return bool(same.all() and (bits | nan).all())


@pytest.mark.parametrize("offset", [0, 1, 3, 4, 8])
def test_fp16_codec_kernels_match_plain(cuda_device, offset):
    """K5, K6 and K7 on the special values, every pair of the wire table
    and seeded normals, read at an element ``offset`` into their buffers
    (the two K7 operands one element apart): the vector path at 0 and 8
    (K5 also at 4), the scalar path where a pointer is misaligned, and
    ragged tails."""
    g = torch.Generator(device=cuda_device).manual_seed(offset)
    special = torch.tensor(CODEC_F32, dtype=torch.int64).to(
        torch.int32).view(torch.float32).to(cuda_device)
    x = torch.cat([special, torch.randn(8191, generator=g,
                                        device=cuda_device), special])
    pairs = torch.tensor(CODEC_U16, dtype=torch.int32)
    a = pairs.repeat_interleave(len(CODEC_U16))
    b = pairs.repeat(len(CODEC_U16))
    # the wire buffers are put together in int32 (uint16 has few ops)
    wire = fp16.fp16_compress_reference(x).to(torch.int32)
    ua = torch.cat([a.to(cuda_device), wire, wire[:9]]).to(torch.uint16)
    ub = torch.cat([b.to(cuda_device), wire.flip(0), wire[:10]]).to(
        torch.uint16)
    n = ua.numel() - 9
    before = [fn.launches for fn in (fp16.fp16_compress,
                                     fp16.fp16_decompress, fp16.fp16_add)]
    xs = x[offset:]
    got = fp16.fp16_compress(xs)
    back = fp16.fp16_decompress(ua[offset:offset + n])
    total = fp16.fp16_add(ua[offset:offset + n], ub[offset + 1:offset + 1 + n])
    torch.cuda.synchronize()
    assert [fn.launches for fn in (fp16.fp16_compress, fp16.fp16_decompress,
                                   fp16.fp16_add)] == [c + 1 for c in before]
    assert _same_bits(got, fp16.fp16_compress_reference(xs))
    assert _same_bits(back, fp16.fp16_decompress_reference(
        ua[offset:offset + n]))
    assert _same_bits(total, fp16.fp16_add_plain(
        ua[offset:offset + n], ub[offset + 1:offset + 1 + n]))
    # a strided input, a reshaped output, the flush cases
    assert _same_bits(fp16.fp16_compress(x[::3]),
                      fp16.fp16_compress_reference(x[::3]))
    assert fp16.fp16_decompress(got[:12], shape=(3, 4)).shape == (3, 4)
    flush = fp16.fp16_add(
        torch.tensor([0x0001, 0x8001, 0x807F, 0x0081, 0x0001],
                     dtype=torch.int32).to(torch.uint16).to(cuda_device),
        torch.tensor([0x0001, 0x8001, 0x0000, 0x8080, 0x3F80],
                     dtype=torch.int32).to(torch.uint16).to(cuda_device))
    assert flush.cpu().to(torch.int32).tolist() == \
        [0x0000, 0x8000, 0x0000, 0x0000, 0x3F80]


CARD_LM = dict(max_len=12, embed_dim=16, num_heads=2, num_layers=1)


def _card_lm_trainer(device, weights, iters, dropout=0.3, seed=3):
    """A 1-layer LM with ``dropout`` on the card over 12 seeded sequences
    in batches of 4 (3 steps an epoch, reshuffled at each epoch), from
    ``weights``."""
    tm = TransformerLM(30, dropout=dropout, **CARD_LM)
    load_jax_params(tm, weights)
    ids = np.random.RandomState(4).randint(1, 31, (12, 12)).astype(
        np.float32)
    opt = LocalOptimizer(
        tm, tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                         size_average=True),
        DataSet.array([Sample(x, np.roll(x, -1)) for x in ids]) >>
        SampleToBatch(4), Trigger.max_iteration(iters), device=device)
    opt.set_optim_method(SGD(learning_rate=0.2, momentum=0.9,
                             dampening=0.0)).set_seed(seed)
    return opt


def test_resume_on_the_card_draws_the_same_dropout_masks(cuda_device,
                                                          tmp_path):
    """7 steps straight on the card, against 4 steps with a snapshot
    (mid-epoch 2) and 3 more by a fresh trainer that crosses into epoch 3:
    the snapshot carries the CUDA generator's state, so the resumed run
    draws the uninterrupted run's dropout masks and its generator ends in
    the same state.  Losses within 1e-5 relative and weights within 1e-5
    of each tensor's largest magnitude (library backward ops may sum in
    another order on the card); a run seeded otherwise, whose masks differ,
    moves the losses far beyond that."""
    weights = export_params(TransformerLM(30, **CARD_LM).reset(5))
    straight = _card_lm_trainer(cuda_device, weights, 7)
    straight.optimize()
    first = _card_lm_trainer(cuda_device, weights, 4)
    first.set_checkpoint(str(tmp_path), Trigger.several_iteration(4))
    first.optimize()
    resumed = _card_lm_trainer(
        cuda_device, export_params(TransformerLM(30, **CARD_LM).reset(9)), 7)
    resumed.resume_from(str(tmp_path))
    resumed.optimize()
    assert torch.equal(resumed._generator.get_state(),
                       straight._generator.get_state())
    want = np.array([r["loss"] for r in straight.step_records])
    got = np.array([r["loss"] for r in first.step_records +
                    resumed.step_records])
    assert got.shape == (7,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(export_params(resumed.model)),
                    tree_leaves(export_params(straight.model))):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    other = _card_lm_trainer(cuda_device, weights, 7, seed=4)
    other.optimize()
    moved = np.array([r["loss"] for r in other.step_records])
    assert np.abs(moved - want).max() > 1e-3 * np.abs(want).max()


def _bn_trainer(device, model, iters, mixed, batch=8, image=32, classes=10):
    """ResNet recipe (nesterov SGD, CrossEntropyCriterion) over seeded
    images, ``batch`` a step."""
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    rng = np.random.RandomState(17)
    x = rng.standard_normal((batch * iters, 3, image, image)) \
        .astype(np.float32)
    y = rng.randint(1, classes + 1, size=batch * iters).astype(np.float32)
    opt = LocalOptimizer(
        model, CrossEntropyCriterion(),
        DataSet.array([Sample(a, b) for a, b in zip(x, y)]) >>
        SampleToBatch(batch), Trigger.max_iteration(iters), device=device)
    opt.set_optim_method(SGD(learning_rate=0.1, weight_decay=1e-4,
                             momentum=0.9, dampening=0.0, nesterov=True))
    return opt.set_mixed_precision(mixed)


def test_bn_running_stats_move_under_mixed_precision_on_the_card(
        cuda_device):
    """bf16 mixed precision on the card: every BN layer's running mean and
    variance stay f32 buffers on the card, are finite, and moved from 0
    and 1 (a cast copy would have taken the updates and dropped them)."""
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn import BatchNormalization
    opt = _bn_trainer(cuda_device, ResNet(10, 8, "B", "cifar10").reset(3), 3,
                      True)
    opt.optimize()
    layers = [m for m in opt.model.modules()
              if isinstance(m, BatchNormalization)]
    assert len(layers) == 9
    for m in layers:
        for buf, reset in ((m.running_mean, 0.0), (m.running_var, 1.0)):
            assert buf.dtype == torch.float32 and buf.is_cuda
            assert torch.isfinite(buf).all() and bool((buf != reset).any())
    assert np.isfinite([r["loss"] for r in opt.step_records]).all()


def _rel(a, b):
    """max |a - b| / max |b| of two host tensors."""
    return ((a - b).abs().max() / b.abs().max()).item()


def test_resnet50_bf16_step_on_the_card_matches_the_cpu(cuda_device):
    """One bf16 mixed-precision step of full-width ResNet-50 at batch 2
    from the same weights, on the card and on the CPU, with the CPU's f32
    step as the yardstick: bf16 rounding over 53 convolutions and BNs
    moves the CPU's own loss and statistics away from its f32 ones, and the
    card's may differ from the CPU's by no more than twice that (plus one
    bf16 step of the loss).  The gradient itself is not comparable
    elementwise: at random init BatchNorm makes it sensitive to rounding
    (a 1e-7 relative change of the input moves it by 2 % in L2 on the
    CPU), so of the weights the test holds the classifier's update, a
    product of forward quantities, to the same rule, and requires every
    tensor's update to be finite and non-zero."""
    from bigdl_tpu_torch.models import ResNet
    runs = {}
    for key, dev, mixed in (("card", cuda_device, True),
                            ("cpu", torch.device("cpu"), True),
                            ("cpu_f32", torch.device("cpu"), False)):
        model = ResNet(1000, 50).reset(5)
        start = [p.detach().clone() for p in model.param_leaves()]
        opt = _bn_trainer(dev, model, 1, mixed, batch=2, image=224,
                          classes=1000)
        opt.optimize()
        runs[key] = (opt.step_records[0]["loss"], start,
                     [p.detach().cpu() for p in opt.model.param_leaves()],
                     [b.detach().cpu() for b in opt.model.state_leaves()])
    (lc, w0, wc, sc), (lb, _, wb, sb), (lf, _, wf, sf) = \
        runs["card"], runs["cpu"], runs["cpu_f32"]
    step = 2.0 ** (np.floor(np.log2(abs(lb))) - 7)
    assert np.isfinite(lc) and abs(lc - lb) <= 2 * abs(lb - lf) + step
    spread = max(_rel(b, f) for b, f in zip(sb, sf))
    assert max(_rel(c, b) for c, b in zip(sc, sb)) <= 2 * spread
    for c, b, f, w in zip(wc[-2:], wb[-2:], wf[-2:], w0[-2:]):
        # the classifier's bias and weight: its update against the CPU's
        assert _rel(c - w, b - w) <= 2 * _rel(b - w, f - w)
    for c, w in zip(wc, w0):
        assert torch.isfinite(c - w).all() and bool((c != w).any())


# each wrapper's launches in one forward (bf16, as ``perf infer`` runs it)
# and in one f32 training step (``perf local``) of the harness's models
HARNESS_LAUNCHES = [
    ("alexnet", {"max_pool2d": 3, "cross_map_lrn": 2},
     {"max_pool2d": 3, "max_pool2d_bwd": 3, "cross_map_lrn": 2,
      "lrn_bwd": 2}),
    ("vgg16", {"max_pool2d": 5}, {"max_pool2d": 5, "max_pool2d_bwd": 5})]


@pytest.mark.parametrize("name, forward, step", HARNESS_LAUNCHES,
                         ids=[c[0] for c in HARNESS_LAUNCHES])
def test_harness_models_launch_their_kernels(cuda_device, name, forward,
                                             step):
    """AlexNet's two LRNs and three pools and VGG-16's five pools run K1
    and K2 in a forward and K3 and K4 besides in a step, nothing else."""
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.models import perf
    model = perf._build(name).to(cuda_device)
    data, labels = perf._synthetic_batch(name, 2, "random")
    for counts, run in (
            (forward, lambda: perf.infer_forward(
                model.evaluate(), data, False, cuda_device)()),
            (step, lambda: float(perf.local_step(
                model.training_().set_generator(
                    torch.Generator(cuda_device).manual_seed(1)),
                data, labels, cuda_device)(0)))):
        ops.reset_launches()
        run()
        torch.cuda.synchronize()
        assert {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS} == \
            {fn.__name__: counts.get(fn.__name__, 0)
             for fn in ops.KERNEL_WRAPPERS}


# -- the quantized LM and speculative decoding on the card -----------------------

# the packed products of one decode step of the 2-layer LM below: 2 x (4
# projections + fc1 + fc2) and the tied head; w8a8 runs the 12 calibrated
# ones on K14 and the head, which has no activation scale, on K13
LM_STEP_LAUNCHES = {
    "w8": {"w8_matmul": 13},
    "w8a8": {"a8_matmul": 12, "w8_matmul": 1},
    "w4": {"w4_matmul": 13},
    "f8": {"f8_matmul": 13}}
LM_LOGP_RTOL = 1e-4       # of the largest |log-prob|: f32 sums reordered


def _packed_lm(mode):
    """A seeded TransformerLM(300, embed 64, 4 heads, 2 layers) packed on
    the CPU (``w8a8`` calibrated on two seeded prompts there) and its copy
    on the card."""
    import copy
    lm = TransformerLM(300, max_len=64, embed_dim=64, num_heads=4,
                       num_layers=2).reset(3).evaluate()
    calib = None
    if mode == "w8a8":
        calib = quant.calibrate(lm, [np.random.RandomState(s).randint(
            1, 301, (1, 12)) for s in (1, 2)])
    cpu = quant.quantize_model(lm, mode, calib=calib, extra_keys=("tok",))
    return cpu, copy.deepcopy(cpu).to("cuda")


@pytest.mark.parametrize("mode", list(LM_STEP_LAUNCHES))
def test_quantized_lm_decode_step_matches_the_cpu(cuda_device, mode):
    """A prefill and a decode step of a packed LM through ``decode_pages``
    on the card against the same packed copy on the CPU: log-probs within
    LM_LOGP_RTOL of their largest magnitude, float32 (the packed gather
    widens to f32), argmax equal; the step launches its rung's kernels
    and two K12, nothing else."""
    from bigdl_tpu_torch import ops
    cpu, dev = _packed_lm(mode)
    ids = torch.from_numpy(np.random.RandomState(4).randint(1, 301, (2, 9)))
    pages = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    calls = [(ids[:, :8], [0, 0]), (ids[:, 8:], [8, 8])]
    outs = {}
    for name, m, d in (("cpu", cpu, "cpu"), ("card", dev, cuda_device)):
        pool = m.init_paged_cache(8, 16)
        got = []
        with torch.inference_mode():
            for tok, pos in calls:
                ops.reset_launches()
                got.append(m.decode_pages(
                    tok.to(d), pool, pages.to(d), torch.tensor(pos).to(d),
                    torch.ones(2, dtype=torch.bool, device=d)).cpu())
        outs[name] = got
    torch.cuda.synchronize()
    assert {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS} == \
        {fn.__name__: dict(LM_STEP_LAUNCHES[mode],
                           paged_attention=2).get(fn.__name__, 0)
         for fn in ops.KERNEL_WRAPPERS}
    for a, b in zip(outs["card"], outs["cpu"]):
        assert a.dtype == b.dtype == torch.float32
        assert (a - b).abs().max() <= LM_LOGP_RTOL * b.abs().max()
        assert torch.equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_at_the_verify_shape_matches_plain(cuda_device,
                                                           dtype):
    """A verify pass of 8 slots x 4 rows: each slot's page table repeated
    and its rows at pos + i, against K12's plain version (the tolerance of
    every K12 case)."""
    dt = getattr(torch, dtype)
    b, k1 = 8, 4
    case = (b, 8, 8, 1, 64, 16, 128, [600 + 37 * r for r in range(b)],
            False)
    q, kp, vp, pages, pos, scale = paged_operands(case, dt, dt, cuda_device,
                                                  11)
    qv = torch.randn((b * k1, 8, 1, 64), device=cuda_device).to(dt)
    vpos = (pos - k1 + 1 + torch.arange(k1, device=cuda_device)).reshape(-1,
                                                                         1)
    assert _paged_close((qv, kp, vp, pages.repeat_interleave(k1, dim=0),
                         vpos, scale), dt)


def test_speculative_tokens_equal_plain_decoding_on_the_card(cuda_device):
    """An f32 LM served on the card with a truncated draft, with a w8
    draft and with itself as the draft: the tokens are plain continuous
    decoding's on the card.  The truncated drafts agree with the target
    part of the time (0 < accept rate < 1), so rounds that accept some of
    their proposals and leave the rejected ones' K/V behind in the pool
    and the draft's cache are held to plain decoding too; the self-draft
    accepts every proposal.  One request fills the cache (prompt +
    max_new = max_len), so its verify rows run past the position table
    and write the trash page."""
    from bigdl_tpu_torch.serving import ContinuousGenerator
    lm = TransformerLM(300, max_len=96, embed_dim=64, num_heads=4,
                       num_layers=2).reset(5)
    draft = TransformerLM(300, max_len=96, embed_dim=64, num_heads=4,
                          num_layers=1)
    load_jax_params(draft, {**export_params(lm),
                            "blocks": export_params(lm)["blocks"][:1]})
    rs = np.random.RandomState(12)
    prompts = [rs.randint(1, 301, size=rs.randint(5, 30)) for _ in range(6)]
    budgets = [int(rs.randint(5, 40)) for _ in range(6)]
    prompts.append(rs.randint(1, 301, size=20))
    budgets.append(96 - 20)
    kw = dict(num_slots=4, page_size=16, seq_buckets=[32],
              device=cuda_device)

    def run(**extra):
        with ContinuousGenerator(lm, **kw, **extra) as g:
            outs = [f.result(timeout=300) for f in
                    [g.submit(p, n) for p, n in zip(prompts, budgets)]]
            return outs, g.stats()

    plain, _ = run()
    for extra in (dict(draft_model=draft, spec_k=3),
                  dict(draft_model=draft, draft_quantize="w8", spec_k=3),
                  dict(draft_model=lm, spec_k=4)):
        outs, st = run(**extra)
        for a, b in zip(outs, plain):
            np.testing.assert_array_equal(a, b)
        if extra["draft_model"] is lm:
            assert st["spec"]["accept_rate"] == 1.0
        else:
            assert 0.0 < st["spec"]["accept_rate"] < 1.0
