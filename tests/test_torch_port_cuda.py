"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip without one.  They import neither
jax nor ``bigdl_tpu``, so they also run where only PyTorch is installed:

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest

Tolerances: max-pool is bit-equal (values and uint8 argmax codes); LRN
within rtol 1e-5 / atol 1e-6 in float32 and rtol 2e-2 / atol 1e-2 in
bfloat16, where the plain version rounds to bfloat16 at every step.
"""

import pytest
import torch

from bigdl_tpu_torch.ops import (cross_map_lrn, lrn_plain, max_pool2d,
                                 max_pool2d_plain)

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", [(5, 1.0, 0.75, 1.0), (4, 1.0, 0.5, 2.0),
                                    (3, 0.5, 1.0, 1.0)],
                         ids=["beta0.75", "beta0.5", "powf"])
def test_lrn_kernel_matches_plain(cuda_device, dtype, params):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((2, 7, 9, 13), generator=g,
                    device=cuda_device).to(getattr(torch, dtype))
    y, scale = cross_map_lrn(x, *params, return_scale=True)
    torch.cuda.synchronize()
    py, pscale = lrn_plain(x, *params)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2e-2, atol=1e-2)
    torch.testing.assert_close(y.float(), py.float(), **tol)
    torch.testing.assert_close(scale.float(), pscale.float(), **tol)


def test_kernel_launches_are_counted(cuda_device):
    x = torch.randn((2, 4, 8, 8), device=cuda_device)
    before = (max_pool2d.launches, cross_map_lrn.launches)
    max_pool2d(x, 2, 2, 2, 2)
    cross_map_lrn(x)
    torch.cuda.synchronize()
    assert (max_pool2d.launches, cross_map_lrn.launches) == \
        (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="contiguous"):
        max_pool2d(x.transpose(2, 3), 2, 2, 2, 2)
