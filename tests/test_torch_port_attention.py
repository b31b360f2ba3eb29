"""The port's attention ops (``bigdl_tpu_torch.ops.attention``) against the
JAX package.

The plain versions of K8 and K9 are held against the Pallas kernels they
replace (``_fused_forward``, ``_streaming_forward``), run in interpret mode
as ``tests/test_pallas_ops.py`` runs them, on the same numpy inputs:
float32 within 1e-5 of each output's sum of |p·v| (f32 sums in another
order); bfloat16 within one bfloat16 step (2^-7) of it, since both sides
compute in f32 and round once, and two roundings can land one step apart.
The dispatcher must send every shape where the reference's eligibility
rules send it.  The kernels against their plain versions need a CUDA card
and live in ``test_torch_port_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import attention as jattn
from bigdl_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

BF16_STEP = 2.0 ** -7


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_PALLAS_INTERPRET", "1")


# (b, h, hk, t, tk, d, causal): GQA 4/2 and 4/1, MHA, non-causal, Tq != Tk
CASES = [
    (2, 4, 2, 16, 16, 16, True),
    (1, 4, 1, 24, 40, 32, False),
    (2, 2, 2, 32, 32, 8, True),
    (1, 4, 4, 8, 24, 16, True),
    (2, 2, 1, 64, 64, 64, True),
]
IDS = [f"b{c[0]}h{c[1]}kv{c[2]}t{c[3]}tk{c[4]}d{c[5]}" +
       ("causal" if c[6] else "") for c in CASES]


def _qkv(case, seed):
    b, h, hk, t, tk, d, _ = case
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((b, h, t, d)).astype(np.float32),
            rs.standard_normal((b, hk, tk, d)).astype(np.float32),
            rs.standard_normal((b, hk, tk, d)).astype(np.float32))


def _bias(b, tk):
    """Row 0 padded from the middle, row 1 with every key padded."""
    kpm = np.ones((b, tk), bool)
    kpm[0, tk // 2 + 1:] = False
    if b > 1:
        kpm[1, :] = False
    return np.where(kpm, 0.0, tattn.NEG_INF).astype(np.float32)


def _close(got, want, mag, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = (1e-5 if dtype == "float32" else BF16_STEP) * mag + 1e-30
    err = np.abs(got - want)
    assert np.all(err <= tol), (err.max(), (err / tol).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_k8_matches_pallas_fused_forward(interpret, case, dtype):
    q, k, v = _qkv(case, 0)
    causal, scale = case[6], 1.0 / np.sqrt(case[5])
    jdt = getattr(jnp, dtype)
    want = jattn._fused_forward(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                jnp.asarray(v, jdt), causal, scale)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    got = tattn.attention_reference(tq, tk, tv, causal, scale)
    assert got.dtype == tdt and got.shape == tq.shape
    mag = tattn.attention_reference(tq.float(), tk.float(), tv.float().abs(),
                                    causal, scale).numpy()
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), mag,
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_k9_matches_pallas_streaming_forward(interpret, case, padded,
                                                   dtype):
    q, k, v = _qkv(case, 1)
    causal, scale = case[6], 1.0 / np.sqrt(case[5])
    bias = _bias(case[0], case[4]) if padded else None
    jdt = getattr(jnp, dtype)
    want = jattn._streaming_forward(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal, scale, bias=None if bias is None else jnp.asarray(bias))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    got = tattn.attention_stream_plain(tq, tk, tv, causal, scale, tb)
    assert got.dtype == tdt and got.shape == tq.shape
    mag = tattn.attention_stream_plain(tq.float(), tk.float(),
                                       tv.float().abs(), causal, scale,
                                       tb).numpy()
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), mag,
           dtype)
    if padded and case[0] > 1:   # every key padded: the row is zero
        assert not got[1].float().abs().any()


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forms_match_the_oracle_with_a_mask(causal):
    """attention_reference with a key mask, the chunked form with its bias
    and K9's plain version agree with JAX's oracle, fully masked rows
    zero."""
    q, k, v = _qkv((2, 4, 2, 24, 24, 16, causal), 2)
    bias = _bias(2, 24)
    kpm = bias == 0
    want = np.asarray(jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 0.25,
        mask=jnp.asarray(kpm)[:, None, None, :]))
    want_c = np.asarray(jattn._chunked_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 0.25,
        block_q=8, bias=jnp.asarray(bias)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tb = torch.from_numpy(bias)
    got = tattn.attention_reference(
        tq, tk, tv, causal, 0.25,
        mask=torch.from_numpy(kpm)[:, None, None, :]).numpy()
    got_c = tattn._chunked_attention_reference(tq, tk, tv, causal, 0.25,
                                               block_q=8, bias=tb).numpy()
    got_s = tattn.attention_stream_plain(tq, tk, tv, causal, 0.25,
                                         tb).numpy()
    for g in (got, got_c, got_s):
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(want_c, want, rtol=1e-5, atol=1e-6)
    assert not np.abs(got[1]).any()


def test_expand_kv_heads_is_consecutive_sharing():
    q = torch.zeros(1, 6, 2, 4)
    k = torch.arange(3.0).reshape(1, 3, 1, 1).expand(1, 3, 2, 4)
    kk, vv = tattn.expand_kv_heads(q, k, k)
    assert kk[0, :, 0, 0].tolist() == [0, 0, 1, 1, 2, 2]
    jk, _ = jattn.expand_kv_heads(jnp.zeros((1, 6, 2, 4)),
                                  jnp.asarray(k.numpy()),
                                  jnp.asarray(k.numpy()))
    np.testing.assert_array_equal(np.asarray(jk), kk.numpy())


# -- dispatch -----------------------------------------------------------------

DISPATCH = [  # (t, t_k, d)
    (16, 16, 64), (24, 24, 64), (20, 20, 64), (12, 16, 64), (8, 2048, 64),
    (2048, 2048, 64), (2048, 2048, 128), (4096, 4096, 64),
    (8192, 8192, 64), (16384, 16384, 64), (2048, 4096, 32),
    (2040, 2040, 64), (4104, 4104, 64),
]


def _route_jax(monkeypatch, t, tk, d, masked, needs_backward):
    seen = []
    monkeypatch.setattr(jattn, "_fused_attention",
                        lambda *a, **kw: seen.append("K8"))
    monkeypatch.setattr(jattn, "_streaming_attention",
                        lambda *a, **kw: seen.append("K9"))
    monkeypatch.setattr(jattn, "_chunked_attention_reference",
                        lambda *a, **kw: seen.append("chunked"))
    monkeypatch.setattr(jattn, "attention_reference",
                        lambda *a, **kw: seen.append("reference"))
    q = jnp.zeros((1, 1, t, d))
    k = jnp.zeros((1, 1, tk, d))
    mask = jnp.ones((1, tk), bool) if masked else None
    jattn.fused_attention(q, k, k, causal=True,
                          needs_backward=needs_backward,
                          key_padding_mask=mask)
    return seen


def _route_port(monkeypatch, t, tk, d, masked, needs_backward):
    seen = []
    monkeypatch.setattr(tattn, "attention_fwd",
                        lambda *a, **kw: seen.append("K8"))
    monkeypatch.setattr(tattn, "attention_stream_fwd",
                        lambda *a, **kw: seen.append("K9"))
    monkeypatch.setattr(tattn, "_chunked_attention_reference",
                        lambda *a, **kw: seen.append("chunked"))
    monkeypatch.setattr(tattn, "attention_reference",
                        lambda *a, **kw: seen.append("reference"))
    q = torch.zeros((1, 1, t, d))
    k = torch.zeros((1, 1, tk, d))
    mask = torch.ones((1, tk), dtype=torch.bool) if masked else None
    tattn.fused_attention(q, k, k, causal=True,
                          needs_backward=needs_backward,
                          key_padding_mask=mask)
    return seen


@pytest.mark.parametrize("needs_backward", [False, True],
                         ids=["eval", "train"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_dispatch_matches_the_reference_eligibility(interpret, monkeypatch,
                                                     masked, needs_backward):
    routes = {}
    for t, tk, d in DISPATCH:
        want = _route_jax(monkeypatch, t, tk, d, masked, needs_backward)
        got = _route_port(monkeypatch, t, tk, d, masked, needs_backward)
        assert len(want) == 1 and got == want, (t, tk, d, got, want)
        routes[(t, tk, d)] = got[0]
    # the slice's path shapes (d = 64): the LM at T 2048 on K8, the padded
    # LM on K9, the long-context model at T 8192 on K9
    if not masked:
        assert routes[(2048, 2048, 64)] == "K8"
        assert routes[(8192, 8192, 64)] == "K9"
    else:
        assert routes[(2048, 2048, 64)] == "K9"


def test_mask_of_the_wrong_shape_raises():
    q = torch.zeros(2, 2, 8, 16)
    with pytest.raises(ValueError, match="key_padding_mask"):
        tattn.fused_attention(q, q, q, key_padding_mask=torch.ones(2, 7,
                                                                   dtype=bool))
    with pytest.raises(ValueError, match="key_padding_mask"):
        jattn.fused_attention(jnp.zeros((2, 2, 8, 16)),
                              jnp.zeros((2, 2, 8, 16)),
                              jnp.zeros((2, 2, 8, 16)),
                              key_padding_mask=jnp.ones((2, 7), bool))


def test_dispatch_runs_the_plain_versions_on_the_cpu(interpret):
    q, k, v = _qkv((2, 4, 2, 16, 16, 16, True), 3)
    kpm = np.ones((2, 16), bool)
    kpm[1, 10:] = False
    for mask in (None, kpm):
        want = jattn.fused_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            needs_backward=False,
            key_padding_mask=None if mask is None else jnp.asarray(mask))
        got = tattn.fused_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
            needs_backward=False,
            key_padding_mask=None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


# -- the wrappers on the CPU --------------------------------------------------

def test_cpu_wrappers_launch_nothing_and_stay_differentiable():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv((1, 2, 1, 16, 16, 16, True), 4))
    bias = torch.from_numpy(_bias(1, 16))
    before = (tattn.attention_fwd.launches,
              tattn.attention_stream_fwd.launches)
    o8 = tattn.attention_fwd(q, k, v, causal=True)
    o9 = tattn.attention_stream_fwd(q, k, v, causal=True, bias=bias)
    assert (tattn.attention_fwd.launches,
            tattn.attention_stream_fwd.launches) == before
    torch.testing.assert_close(o8, tattn.attention_reference(q, k, v, True))
    (o8.sum() + o9.sum()).backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in (q, k, v))


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="do not agree"):
        tattn.attention_fwd(q, torch.zeros(1, 3, 8, 16),
                            torch.zeros(1, 3, 8, 16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tattn.attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="bias"):
        tattn.attention_stream_fwd(q, q, q, bias=torch.zeros(1, 7))
