"""The port's kernel modules (``bigdl_tpu_torch.ops``) against the JAX
package.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the Pallas kernel it replaces, run in interpret mode as
``tests/test_pallas_ops.py`` runs it, and against the XLA reference.  The
kernel-against-plain checks need a CUDA card and live in
``test_torch_port_cuda.py``.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import lrn as jlrn
from bigdl_tpu.ops import pooling as jpool
from bigdl_tpu_torch.ops import (_build, cross_map_lrn, lrn_bwd_plain,
                                 lrn_plain, max_pool2d, max_pool2d_bwd_plain,
                                 max_pool2d_plain, pool_geometry)
from bigdl_tpu_torch.ops import lrn as lrn_mod
from bigdl_tpu_torch.ops import pooling
from bigdl_tpu_torch.ops.lrn import lrn_plan
from bigdl_tpu_torch.ops.pooling import _pool_out_size

# the suite runs several pytest workers on one host: keep torch from
# taking every core inside each of them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_PALLAS_INTERPRET", "1")


def _pool_input(shape, seed, ties):
    rng = np.random.RandomState(seed)
    if ties:    # integer values force ties inside most windows
        return rng.randint(-2, 3, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


POOL_CASES = [
    # shape, kh, kw, sh, sw, ph, pw, ceil, ties
    ((2, 3, 9, 9), 3, 3, 2, 2, 0, 0, True, False),     # Inception stem pool
    ((2, 3, 9, 9), 3, 3, 2, 2, 0, 0, False, False),
    ((2, 4, 8, 8), 3, 3, 1, 1, 1, 1, False, False),    # Inception branch pool
    ((1, 3, 7, 11), 3, 3, 2, 2, 1, 1, True, False),    # odd HW, ceil, pad
    ((1, 3, 7, 11), 3, 3, 2, 2, 1, 1, False, False),   # odd HW, floor, pad
    ((2, 5, 8, 6), 2, 2, 2, 2, 0, 0, False, False),    # LeNet pool
    ((2, 3, 9, 9), 3, 3, 2, 2, 0, 0, True, True),
    ((2, 4, 8, 8), 3, 3, 1, 1, 1, 1, False, True),
    ((1, 2, 10, 7), 3, 2, 2, 3, 1, 1, True, True),     # rectangular window
]


@pytest.mark.parametrize("case", POOL_CASES,
                         ids=[f"case{i}" for i in range(len(POOL_CASES))])
def test_max_pool_plain_matches_pallas_kernel(interpret, case):
    shape, kh, kw, sh, sw, ph, pw, ceil, ties = case
    x = _pool_input(shape, 0, ties)
    y, (idx,) = jpool._max_pool_fwd_impl(jnp.asarray(x), kh, kw, sh, sw,
                                         ph, pw, ceil, shape[2], shape[3])
    ty, ti = max_pool2d_plain(torch.from_numpy(x), kh, kw, sh, sw, ph, pw,
                              ceil)
    assert ti.dtype == torch.uint8
    np.testing.assert_array_equal(ty.numpy(), np.asarray(y))
    np.testing.assert_array_equal(ti.numpy(),
                                  np.asarray(idx).astype(np.uint8))
    ref = jpool.max_pool2d_reference(jnp.asarray(x), kh, kw, sh, sw, ph,
                                     pw, ceil)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(ref))


def test_max_pool_plain_bf16_matches_pallas_kernel(interpret):
    x = _pool_input((2, 3, 9, 9), 1, False)
    xb = jnp.asarray(x, jnp.bfloat16)
    y, (idx,) = jpool._max_pool_fwd_impl(xb, 3, 3, 2, 2, 0, 0, True, 9, 9)
    tx = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    ty, ti = max_pool2d_plain(tx, 3, 3, 2, 2, 0, 0, True)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(y.astype(jnp.float32)))
    np.testing.assert_array_equal(ti.numpy(),
                                  np.asarray(idx.astype(jnp.float32))
                                  .astype(np.uint8))


@pytest.mark.parametrize("ih,k,s,p,ceil", [
    (112, 3, 2, 0, True), (56, 3, 2, 0, True), (28, 3, 1, 1, False),
    (7, 3, 2, 1, True), (8, 3, 2, 1, True), (13, 2, 2, 0, False)])
def test_pool_geometry_matches_reference(ih, k, s, p, ceil):
    from bigdl_tpu.nn.pooling import _pool_out_size as j_out
    assert _pool_out_size(ih, k, s, p, ceil) == j_out(ih, k, s, p, ceil)
    assert pool_geometry(ih, ih + 1, k, k, s, s, p, p, ceil) == \
        jpool.pool_geometry(ih, ih + 1, k, k, s, s, p, p, ceil)


# (name, input shape at batch 32, kh, kw, sh, sw, ph, pw, ceil) of
# Inception-v1's 13 max pools
INCEPTION_POOLS = [
    ("pool1/3x3_s2", (32, 64, 112, 112), 3, 3, 2, 2, 0, 0, True),
    ("pool2/3x3_s2", (32, 192, 56, 56), 3, 3, 2, 2, 0, 0, True),
    ("inception_3a/pool", (32, 192, 28, 28), 3, 3, 1, 1, 1, 1, False),
    ("inception_3b/pool", (32, 256, 28, 28), 3, 3, 1, 1, 1, 1, False),
    ("pool3/3x3_s2", (32, 480, 28, 28), 3, 3, 2, 2, 0, 0, True),
    ("inception_4a/pool", (32, 480, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("inception_4b/pool", (32, 512, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("inception_4c/pool", (32, 512, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("inception_4d/pool", (32, 512, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("inception_4e/pool", (32, 528, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("pool4/3x3_s2", (32, 832, 14, 14), 3, 3, 2, 2, 0, 0, True),
    ("inception_5a/pool", (32, 832, 7, 7), 3, 3, 1, 1, 1, 1, False),
    ("inception_5b/pool", (32, 832, 7, 7), 3, 3, 1, 1, 1, 1, False),
]


def _r16(nbytes):
    return (nbytes + 15) // 16 * 16


def _plan_blocks(plan, shape, geom, itemsize, backward):
    """Each block of a K1 (or K3) launch as csrc/max_pool.cu computes it:
    (first plane, planes, first output row, rows, first output column,
    columns, first staged row, staged rows, first staged column, staged
    columns, shared bytes its spans take).  K1: y rows and columns and the
    input rows and columns they read; K3: dx rows and columns and the
    window rows and columns that reach them."""
    n, c, h, w = shape
    kh, kw, sh, sw, ph, pw = geom[:6]
    oh, ow, _, _ = pool_geometry(h, w, *geom)
    planes = n * c
    tiled = plan.tiles > 1
    for x in range(-(-planes // plan.planes)):
        g0 = x * plan.planes
        gn = min(plan.planes, planes - g0)
        for band in range(plan.bands):
            for tile in range(plan.tiles):
                if backward:
                    iy0, r, lo, hi = 0, h, 0, oh - 1
                    if plan.bands > 1 or tiled:
                        iy0 = band * plan.rows
                        r = min(plan.rows, h - iy0)
                        top = iy0 + ph - kh + 1
                        lo = -(-top // sh) if top > 0 else 0
                        hi = min(oh - 1, (iy0 + r - 1 + ph) // sh)
                    ic0, cn, clo, chi, pitch = 0, w, 0, ow - 1, ow
                    if tiled:
                        ic0 = tile * plan.cols
                        cn = min(plan.cols, w - ic0)
                        left = ic0 + pw - kw + 1
                        clo = -(-left // sw) if left > 0 else 0
                        chi = min(ow - 1, (ic0 + cn - 1 + pw) // sw)
                        pitch = (plan.cols + kw - 2) // sw + 1
                    nwin, ncol = max(0, hi - lo + 1), max(0, chi - clo + 1)
                    assert ncol <= pitch
                    n_in, n_out = gn * nwin * pitch, gn * r * plan.cols
                    used = (_r16(16 + n_in * itemsize) + _r16(16 + n_in) +
                            _r16(16 + n_out * itemsize) +
                            8 * (r + plan.cols))
                    yield (g0, gn, iy0, r, ic0, cn, lo, nwin, clo, ncol,
                           used)
                else:
                    oy0, r, ir0, ir1 = 0, oh, 0, h
                    if plan.bands > 1 or tiled:
                        oy0 = band * plan.rows
                        r = min(plan.rows, oh - oy0)
                        ir0 = min(h, max(0, oy0 * sh - ph))
                        ir1 = max(ir0, min(h, (oy0 + r - 1) * sh - ph + kh))
                    oc0, cn, ic0, ic1, pitch = 0, ow, 0, w, w
                    if tiled:
                        oc0 = tile * plan.cols
                        cn = min(plan.cols, ow - oc0)
                        ic0 = min(w, max(0, oc0 * sw - pw))
                        ic1 = max(ic0, min(w, (oc0 + cn - 1) * sw - pw + kw))
                        pitch = (plan.cols - 1) * sw + kw
                    assert ic1 - ic0 <= pitch
                    n_in = gn * (ir1 - ir0) * pitch
                    n_out = gn * r * plan.cols
                    used = (_r16(16 + n_in * itemsize) +
                            _r16(16 + n_out * itemsize) + _r16(16 + n_out))
                    yield (g0, gn, oy0, r, oc0, cn, ir0, ir1 - ir0, ic0,
                           ic1 - ic0, used)


def _reach(lo, n, k, s, p, size, backward):
    """The input cells (K1) that outputs [lo, lo + n) along one axis read,
    or the windows (K3) that reach cells [lo, lo + n) of it."""
    if backward:
        return {o for o in range(size) for q in range(k)
                if lo <= o * s + q - p < lo + n}
    return {o * s - p + q for o in range(lo, lo + n) for q in range(k)
            if 0 <= o * s - p + q < size}


def _hold_plan(shape, geom, dtype, backward, sms=132):
    """pool_plan at one case: every plane (or band, or tile) covered once,
    the halo right (a band or tile stages exactly the rows and columns its
    windows read, or the windows that reach its rows and columns), shared
    memory within the limit with two blocks an SM, a thread count the
    kernels take, a tile of K3 starting on a stride cell."""
    n, c, h, w = shape
    kh, kw, sh, sw, ph, pw = geom[:6]
    oh, ow, _, _ = pool_geometry(h, w, *geom)
    size = torch.empty((), dtype=dtype).element_size()
    plan = pooling.pool_plan(n, c, h, w, geom, dtype, backward=backward,
                             sms=sms)
    full, width = (h, w) if backward else (oh, ow)
    assert plan.bands == -(-full // plan.rows)
    assert plan.tiles == -(-width // plan.cols)
    assert (plan.bands == 1 and plan.tiles == 1) or plan.planes == 1
    assert plan.tiles == 1 or not backward or plan.cols % sw == 0
    assert 64 <= plan.threads <= 256 and plan.threads % 32 == 0
    assert plan.smem <= pooling.POOL_SMEM_LIMIT
    # two blocks fit on an SM of 228 KB, 1 KB of it each block's own
    assert 2 * (plan.smem + 1024) <= 233472
    # each (plane, row) covered by tiles of `width` columns in all
    covered = np.zeros((n * c, full), dtype=np.int64)
    blocks = 0
    for (g0, gn, r0, r, c0, cn, s0, sn, t0, tn,
         used) in _plan_blocks(plan, shape, geom, size, backward):
        blocks += 1
        assert used <= plan.smem
        assert c0 == (blocks - 1) % plan.tiles * plan.cols
        covered[g0:g0 + gn, r0:r0 + r] += cn
        if plan.bands == 1 and plan.tiles == 1:
            assert (s0, sn) == (0, oh if backward else h)
            continue
        # the span staged along each axis cut (rows; columns of a tile):
        # from the first cell read (or window reaching) to the last
        axes = [(r0, r, s0, sn, kh, sh, ph, oh if backward else h)]
        if plan.tiles > 1:
            axes.append((c0, cn, t0, tn, kw, sw, pw, ow if backward else w))
        for a0, an, b0, bn, k, s, p, extent in axes:
            need = _reach(a0, an, k, s, p, extent, backward)
            if need:
                assert (b0, bn) == (min(need), max(need) - min(need) + 1)
            else:
                assert bn == 0
    assert (covered == width).all()
    assert blocks == plan.blocks
    return plan


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("batch", [8, 32])
@pytest.mark.parametrize("pool", INCEPTION_POOLS,
                         ids=[p[0] for p in INCEPTION_POOLS])
def test_pool_plan_holds_at_the_inception_pools(pool, batch, dtype):
    shape = (batch,) + pool[1][1:]
    geom = pool[2:]
    for backward in (False, True):
        plan = _hold_plan(shape, tuple(geom), dtype, backward)
        # enough blocks to fill the card: the plan's aim on 132 SMs
        assert plan.blocks >= pooling.POOL_BLOCKS_PER_SM * 132
        # within the budget, as the path's pools all fit it, in whole rows
        assert plan.smem <= pooling.POOL_SMEM_BUDGET and plan.tiles == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", [
    ("one element", (1, 1, 1, 1), (1, 1, 1, 1, 0, 0, False)),
    ("one element, 3x3 pad 1", (2, 3, 1, 1), (3, 3, 1, 1, 1, 1, False)),
    ("over the budget", (2, 64, 224, 224), (3, 3, 2, 2, 0, 0, True)),
    ("over the budget, 2x2/2", (8, 132, 224, 224), (2, 2, 2, 2, 0, 0,
                                                    False)),
    ("over the budget, generic", (8, 132, 224, 224), (3, 2, 2, 3, 0, 1,
                                                      True)),
    ("n*c prime", (1, 2113, 7, 7), (3, 3, 1, 1, 1, 1, False)),
    ("n*c prime, 13x11", (1, 4099, 13, 11), (3, 3, 2, 2, 0, 0, True)),
    ("stride past the window", (2, 5, 17, 19), (2, 2, 3, 3, 1, 1, True)),
    ("row over the budget", (1, 2, 4, 40000), (3, 3, 1, 1, 1, 1, False)),
    ("row over the budget, 3x3/2 pad 1", (1, 3, 5, 20001),
     (3, 3, 2, 2, 1, 1, False)),
    ("row over the budget, generic", (1, 2, 6, 30000),
     (2, 2, 3, 3, 0, 0, True)),
    ("windows past the plane, 2x2/3", (2, 3, 6, 6),
     (2, 2, 3, 3, 0, 0, True)),
    ("windows past the plane, 1x1/3", (1, 1, 5, 5),
     (1, 1, 3, 3, 0, 0, True)),
], ids=lambda c: c[0].replace(" ", "-"))
def test_pool_plan_holds_at_its_edges(case, dtype):
    name, shape, geom = case
    size = torch.empty((), dtype=dtype).element_size()
    for backward in (False, True):
        plan = _hold_plan(shape, geom, dtype, backward)
        oh, ow = pool_geometry(shape[2], shape[3], *geom)[:2]
        full, width = shape[2:] if backward else (oh, ow)
        full_smem = pooling.pool_smem(shape[2], shape[3], geom, size, 1,
                                      full, width, backward)
        row_smem = pooling.pool_smem(shape[2], shape[3], geom, size, 1, 1,
                                     width, backward)
        if full_smem > pooling.POOL_SMEM_BUDGET:   # a plane over the budget
            assert plan.bands > 1 and plan.smem <= pooling.POOL_SMEM_BUDGET
        if row_smem > pooling.POOL_SMEM_BUDGET:    # a row over it: tiles
            assert plan.tiles > 1 and plan.rows == 1
        else:
            assert plan.tiles == 1
        if name.startswith("n*c prime"):
            assert plan.planes > 1 and shape[1] % plan.planes != 0
        if name.startswith("windows past the plane"):
            # the last window starts at or past the plane's end
            assert (oh - 1) * geom[2] >= shape[2]


def test_pool_plan_names_the_instantiations(monkeypatch):
    """pool_variant names the instantiation by the code the library gives
    a window (csrc/max_pool.cu `variant`, the one table of them), and the
    plan's shared memory does not depend on it: the generic window's
    tables are counted for every window."""
    from bigdl_tpu_torch.ops import _build
    codes = {(3, 3, 2, 2): 1, (3, 3, 1, 1): 2, (2, 2, 2, 2): 3}

    class Lib:
        @staticmethod
        def bigdl_max_pool2d_variant(kh, kw, sh, sw):
            return codes.get((kh, kw, sh, sw), 0)

    monkeypatch.setattr(_build, "load", lambda: Lib)
    assert pooling.pool_variant(3, 3, 2, 2) == "3x3/2"
    assert pooling.pool_variant(3, 3, 1, 1) == "3x3/1"
    assert pooling.pool_variant(2, 2, 2, 2) == "2x2/2"
    assert pooling.pool_variant(3, 2, 2, 3) == "generic"
    assert pooling.pool_variant(3, 3, 3, 3) == "generic"
    # K3 at a fixed window, 4 bf16 28x28 planes (14x14 windows): dy, the
    # codes, dx and the generic window's tables of 28 + 28 entries
    assert pooling.pool_smem(28, 28, (3, 3, 2, 2, 0, 0, True), 2, 4, 28, 28,
                             True) == (16 + 4 * 196 * 2 + 16 + 4 * 196 +
                                       16 + 4 * 784 * 2 + 8 * (28 + 28))
    # a row too wide for one block's shared memory is cut into tiles of
    # columns, not refused
    plan = pooling.pool_plan(1, 1, 4, 40000, (3, 3, 1, 1, 1, 1, False),
                             torch.float32)
    assert plan.tiles > 1 and plan.smem <= pooling.POOL_SMEM_BUDGET


LRN_CASES = [
    # shape, size, alpha, beta, k
    ((2, 8, 4, 6), 5, 1.0, 0.75, 1.0),
    ((2, 6, 5, 5), 5, 1e-4, 0.75, 1.0),     # Inception's parameters
    ((2, 7, 3, 5), 4, 1.0, 0.75, 2.0),      # odd C, even window
    ((1, 3, 4, 4), 5, 0.5, 0.5, 1.0),       # C < size, beta 0.5
    ((1, 5, 3, 3), 3, 1.0, 1.0, 1.0),       # generic power
]


@pytest.mark.parametrize("case", LRN_CASES,
                         ids=[f"case{i}" for i in range(len(LRN_CASES))])
def test_lrn_plain_matches_pallas_kernel_and_reference(interpret, case):
    shape, size, alpha, beta, k = case
    x = np.random.RandomState(2).standard_normal(shape).astype(np.float32)
    ty, tscale = lrn_plain(torch.from_numpy(x), size, alpha, beta, k)
    y, (_, scale) = jlrn._lrn_pallas_fwd(jnp.asarray(x), size, alpha, beta,
                                         k)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tscale.numpy().reshape(np.asarray(scale)
                                                      .shape),
                               np.asarray(scale), rtol=1e-5, atol=1e-6)
    ref = jlrn.lrn_reference(jnp.asarray(x), size, alpha, beta, k)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# -- K2/K4's plan (ops/lrn.py lrn_plan) and their walk over it ---------------

INCEPTION_LRNS = [("pool1/norm1", 64, 56 * 56),
                  ("conv2/norm2", 192, 56 * 56)]

# name, shape, size, the bytes every tensor is aligned to (0: one
# element's, as a tensor at element 1 of a larger one is)
LRN_EDGES = [
    ("odd hw (AlexNet 55x55)", (2, 96, 55 * 55), 5, 16),
    ("AlexNet 27x27", (2, 256, 27 * 27), 5, 16),
    ("odd hw, base off 16 bytes", (3, 7, 9 * 13), 5, 0),
    ("hw a multiple of 8, base off 16 bytes", (2, 9, 64), 5, 0),
    ("hw a multiple of 8, base on 8 bytes", (2, 9, 64), 5, 8),
    ("hw not a multiple of 8", (2, 9, 36), 5, 16),
    ("hw not a multiple of 4", (2, 9, 34), 5, 16),
    ("C < size", (2, 3, 64), 5, 16),
    ("C = 1", (2, 1, 64), 5, 16),
    ("C not a multiple of the chunk", (4, 7, 256), 5, 16),
    ("C prime, many chunks", (1, 97, 64), 5, 16),
    ("size 1", (2, 6, 64), 1, 16),
    ("even size", (3, 7, 117), 4, 16),
    ("even size, vectors", (2, 11, 64), 4, 16),
    ("size 3", (2, 5, 135), 3, 16),
]


def _lrn_threads(plan, n, c):
    """Each thread of the grid as the kernels place it: image, first
    channel, channels and pixel vector."""
    t = np.arange(n * plan.chunks * plan.vecs)
    v, r = t % plan.vecs, t // plan.vecs
    c0 = r % plan.chunks * plan.chunk
    return r // plan.chunks, c0, np.minimum(plan.chunk, c - c0), v


def _lrn_reads(c0, nout, size, c, backward):
    """The channels a chunk's walk loads: its outputs' windows, [c - lo,
    c + hi] in K2 and [c - hi, c + lo] in K4, within [0, c)."""
    lo = (size - 1) // 2
    hi = size - 1 - lo
    before, after = (hi, lo) if backward else (lo, hi)
    return range(max(0, c0 - before), min(c, c0 + nout + after))


def _hold_lrn_plan(shape, size, dtype, align, backward):
    """lrn_plan at one case: the vector the settings and the alignment
    allow, every (image, channel, pixel) written by exactly one thread,
    each chunk's halo the size - 1 channels its windows reach, a block
    size the kernels take."""
    n, c, hw = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    align = align or itemsize
    plan = lrn_plan(n, c, hw, size, dtype, align, backward)
    # the widest vector within the setting that hw and the alignment allow
    most = lrn_mod.LRN_VECTOR_BYTES["bwd" if backward else "fwd"]
    fits = [b // itemsize for b in (4, 8, 16) if itemsize < b <= most and
            b <= align and hw % (b // itemsize) == 0]
    assert plan.vec == max(fits, default=1)
    assert plan.vecs * plan.vec == hw or plan.vec == 1 and plan.vecs == hw
    assert plan.variant == ("size 5" if size == 5 else "generic")
    assert plan.chunks == -(-c // plan.chunk)
    assert plan.blocks == -(-n * plan.chunks * plan.vecs // plan.threads)
    assert plan.threads % 32 == 0 and plan.threads <= 256
    b, c0, nout, v = _lrn_threads(plan, n, c)
    assert (nout >= 1).all()
    written = np.zeros((n, c), dtype=np.int64)   # pixel vectors a channel
    for k in range(plan.chunks):
        sel = c0 == k * plan.chunk
        np.add.at(written, (b[sel][:, None],
                            k * plan.chunk + np.arange(nout[sel][0])), 1)
        assert np.array_equal(np.sort(v[sel].reshape(n, -1), axis=1),
                              np.tile(np.arange(plan.vecs), (n, 1)))
    assert (written == plan.vecs).all()
    for k in range(plan.chunks):
        first, cnt = k * plan.chunk, min(plan.chunk, c - k * plan.chunk)
        for backward in (False, True):
            reads = _lrn_reads(first, cnt, size, c, backward)
            # the halo: size - 1 channels, less those past either end of C
            lo = (size - 1) // 2
            before, after = ((size - 1 - lo, lo) if backward else
                             (lo, size - 1 - lo))
            assert len(reads) - cnt == min(before, first) + \
                min(after, c - first - cnt)
            for ch in range(first, first + cnt):
                assert set(range(max(0, ch - before),
                                 min(c, ch + after + 1))) <= set(reads)
    return plan


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("batch", [8, 32])
@pytest.mark.parametrize("layer", INCEPTION_LRNS,
                         ids=[x[0] for x in INCEPTION_LRNS])
def test_lrn_plan_holds_at_the_inception_lrns(layer, batch, dtype):
    _, c, hw = layer
    for backward in (False, True):
        plan = _hold_lrn_plan((batch, c, hw), 5, dtype, 16, backward)
        # the size-5 instantiation, and a grid within a fifth of the
        # plan's aim (chunks evened out over C) unless the least chunk
        # stops it, two blocks an SM or more
        assert plan.variant == "size 5"
        threads = batch * plan.chunks * plan.vecs
        aim = lrn_mod.LRN_THREADS_PER_SM["bwd" if backward else "fwd"]
        assert threads >= 0.8 * min(
            aim * 132, batch * plan.vecs * -(-c // lrn_mod.LRN_MIN_CHUNK))
        assert plan.blocks >= 2 * 132


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", LRN_EDGES,
                         ids=[e[0].replace(" ", "-") for e in LRN_EDGES])
def test_lrn_plan_holds_at_its_edges(case, dtype):
    name, shape, size, align = case
    for backward in (False, True):
        plan = _hold_lrn_plan(shape, size, dtype, align, backward)
        if "off 16 bytes" in name or "odd hw" in name:  # one pixel a thread
            assert plan.vec == 1
        if name.startswith("C not a multiple") or name.startswith("C prime"):
            assert shape[1] % plan.chunk != 0
        # a small case is written exactly once, cell by cell
        n, c, hw = shape
        b, c0, nout, v = _lrn_threads(plan, n, c)
        cells = np.zeros((n, c, hw), dtype=np.int64)
        for t in range(len(b)):
            cells[b[t], c0[t]:c0[t] + nout[t],
                  v[t] * plan.vec:(v[t] + 1) * plan.vec] += 1
        assert (cells == 1).all()


def _walk(plan, x, size, alpha, beta, k, scale=None, dy=None):
    """K2 (or, given ``scale`` and ``dy``, K4) as ``csrc/lrn.cu`` walks its
    plan at a window fixed at compile time, every thread of a chunk at
    once: the chunk's input planes enter LRN_GROUP at a time as zeros
    outside [0, C) (scale 1), the window stays in a list of slots, each
    output sums its slots in the kernel's order.  Plain PyTorch ops in the
    plain versions' arithmetic, so the result is theirs, bit for bit."""
    n, c, h, w = x.shape
    xs = x.reshape(n, c, h * w)
    lo = (size - 1) // 2
    hi = size - 1 - lo
    back = dy is not None
    out = [torch.empty_like(xs) for _ in range(1 if back else 2)]
    group = lrn_mod.LRN_GROUP

    def enter(j, want):
        if not (want and 0 <= j < c):
            zero = torch.zeros_like(xs[:, 0])
            return (zero, zero + 1.0, zero) if back else zero
        if not back:
            return xs[:, j]
        sv, xv = scale.reshape(n, c, -1)[:, j], xs[:, j]
        dv = dy.reshape(n, c, -1)[:, j]
        pb = lrn_mod._neg_pow(sv, beta)
        return dv * xv * pb / sv, pb, xv, dv

    for c0 in range(0, c, plan.chunk):
        nout = min(plan.chunk, c - c0)
        first = c0 - (hi if back else lo)
        slots = [enter(first + i, True) for i in range(size - 1)]
        for o0 in range(0, nout, group):
            slots += [enter(first + o0 + size - 1 + u, o0 + u < nout)
                      for u in range(group)]
            for u in range(min(group, nout - o0)):
                acc = torch.zeros_like(xs[:, 0])
                if back:
                    for i in range(size):
                        acc = acc + slots[u + i][0]
                    _, pb, xv, dv = slots[u + hi]
                    out[0][:, c0 + o0 + u] = \
                        dv * pb - 2.0 * (alpha / size) * beta * xv * acc
                    continue
                for i in range(size):
                    acc = acc + slots[u + i] * slots[u + i]
                sc = k + (alpha / size) * acc
                out[0][:, c0 + o0 + u] = slots[u + lo] * \
                    lrn_mod._neg_pow(sc, beta)
                out[1][:, c0 + o0 + u] = sc
            slots = slots[group:]
    return [o.reshape(x.shape) for o in out]


@pytest.mark.parametrize("case", LRN_EDGES + [
    ("Inception's parameters", (2, 24, 20), 5, 16)],
    ids=[e[0].replace(" ", "-") for e in LRN_EDGES] + ["inception-params"])
def test_lrn_walk_gives_the_plain_versions_bits(case):
    name, (n, c, hw), size, align = case
    alpha, beta, k = (1e-4, 0.75, 1.0) if "Inception" in name else \
        (1.0, (0.75, 0.5, 1.0)[c % 3], 2.0)
    plan = lrn_plan(n, c, hw, size, torch.float32, align or 4)
    rng = np.random.RandomState(c)
    x = torch.from_numpy(rng.standard_normal((n, c, 1, hw))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((n, c, 1, hw))
                          .astype(np.float32))
    y, scale = _walk(plan, x, size, alpha, beta, k)
    py, pscale = lrn_plain(x, size, alpha, beta, k)
    assert torch.equal(y, py) and torch.equal(scale, pscale)
    (dx,) = _walk(lrn_plan(n, c, hw, size, torch.float32, align or 4,
                           backward=True), x, size, alpha, beta, k, scale, dy)
    assert torch.equal(dx, lrn_bwd_plain(x, scale, dy, size, alpha, beta))


def test_cpu_wrappers_take_the_plain_version_and_launch_nothing():
    x = torch.from_numpy(_pool_input((2, 3, 9, 9), 3, True))
    before = (max_pool2d.launches, cross_map_lrn.launches)
    y, idx = max_pool2d(x, 3, 3, 2, 2, ceil_mode=True, return_indices=True)
    py, pidx = max_pool2d_plain(x, 3, 3, 2, 2, 0, 0, True)
    assert torch.equal(y, py) and torch.equal(idx, pidx)
    assert torch.equal(max_pool2d(x, 3, 3, 2, 2, ceil_mode=True), py)
    ly, ls = cross_map_lrn(x, 5, 1.0, 0.75, 1.0, return_scale=True)
    py, ps = lrn_plain(x, 5, 1.0, 0.75, 1.0)
    assert torch.equal(ly, py) and torch.equal(ls, ps)
    assert (max_pool2d.launches, cross_map_lrn.launches) == before


@pytest.mark.parametrize("call,exc", [
    (lambda: max_pool2d(torch.zeros(3, 8, 8), 2, 2, 2, 2), ValueError),
    (lambda: max_pool2d(torch.zeros(1, 1, 8, 8, dtype=torch.float64),
                        2, 2, 2, 2), TypeError),
    (lambda: max_pool2d(torch.zeros(1, 1, 40, 40), 16, 16, 1, 1),
     ValueError),                                  # 256 offsets > uint8
    (lambda: max_pool2d(torch.zeros(1, 1, 8, 8), 2, 2, 2, 2, 2, 2),
     ValueError),                                  # pad >= kernel
    (lambda: cross_map_lrn(torch.zeros(3, 8, 8)), ValueError),
    (lambda: cross_map_lrn(torch.zeros(1, 3, 4, 4, dtype=torch.int32)),
     TypeError),
], ids=["pool-3d", "pool-f64", "pool-window", "pool-pad", "lrn-3d",
        "lrn-int"])
def test_wrappers_refuse_what_the_kernel_does_not_take(call, exc):
    with pytest.raises(exc):
        call()


@pytest.mark.parametrize("op", ["pool", "lrn"])
def test_backward_matches_the_plain_backward(op):
    x = torch.randn(1, 3, 6, 6, requires_grad=True)
    y = max_pool2d(x, 2, 2, 2, 2) if op == "pool" else cross_map_lrn(x)
    g = torch.randn(tuple(y.shape))
    y.backward(g)
    if op == "pool":
        _, idx = max_pool2d_plain(x.detach(), 2, 2, 2, 2)
        want = max_pool2d_bwd_plain(g, idx, (2, 2, 2, 2, 0, 0, False), 6, 6)
    else:
        _, scale = lrn_plain(x.detach())
        want = lrn_bwd_plain(x.detach(), scale, g)
    assert torch.equal(x.grad, want)


def test_build_is_lazy_and_keyed_by_the_sources(monkeypatch, tmp_path):
    names = [p.name for p in _build.sources()]
    assert names == ["attention.cu", "flash_attention_bwd.cu",
                     "fp16_codec.cu", "lrn.cu", "max_pool.cu",
                     "paged_attention.cu", "quant_bf16_e4m3.cu",
                     "quant_bf16_int4.cu", "quant_bf16_int8.cu",
                     "quant_matmul.cu"]
    assert _build.source_hash() == _build.source_hash()
    assert _build._lib is None or torch.cuda.is_available()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import bigdl_tpu_torch\n"
        "for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__, "
        "'bigdl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'bigdl_tpu' or "
        "n.startswith('bigdl_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules "
        "if n.startswith('bigdl_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 45
