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
