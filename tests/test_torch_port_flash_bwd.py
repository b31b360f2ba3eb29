"""The port's flash backward (``bigdl_tpu_torch.ops.attention``: K9's LSE,
``flash_bwd_plain`` and the autograd function around K9) against the JAX
package.

The plain versions are held against the Pallas kernels they replace, run in
interpret mode as ``tests/test_pallas_ops.py`` runs them, on the same numpy
inputs: ``attention_stream_plain(with_lse=True)`` against
``_streaming_forward(..., with_lse=True)`` (the output as in
``test_torch_port_attention.py``, within 1e-5 of each output's sum of
|p·v| in float32 and one bfloat16 step of it in bfloat16; the row
logsumexp, ``lse[..., 0]`` of the reference's 8 lanes, within 1e-5 of
max(1, |lse|) in both, since both sides compute it in f32);
``flash_bwd_plain`` against ``_flash_streaming_bwd`` on the reference's own
o and lse and the same dO, each gradient within 1e-5 (float32) or two
bfloat16 steps (bfloat16) of its largest magnitude: the sums run in
another order, and in bfloat16 both sides round ds and p, so a rounding
can land one step apart.  ``flash_bwd_delta_plain`` (the delta pass that
K10 and K11 share) against ``rowsum(dO·O)`` as ``_bwd_dq_kernel`` computes
it, within 1e-6 of each row's sum |dO·O| (f32 sums in another order), and
``flash_bwd_plain`` given that delta equal to it computing its own.
Autograd through the port's dispatcher against ``jax.grad`` of the
reference's, routed to the streaming kernels by a
key-padding mask or by keys past the 512 KB budget (T 2112 at d 64),
within 1e-5 of each gradient's largest magnitude in float32.  The kernels
against their plain versions need a card: ``test_torch_port_cuda.py``.
"""

import jax
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


# (b, h, hk, t, tk, d, causal, padded lengths or None): causal and not,
# GQA 4/2 and 4/1, T not a multiple of 64, Tq != Tk, padded keys with a
# row whose every key is padded
CASES = [
    (2, 4, 2, 72, 72, 16, True, None),
    (1, 4, 1, 40, 136, 32, False, None),
    (2, 4, 4, 136, 72, 16, True, None),
    (1, 4, 2, 64, 64, 16, False, None),
    (3, 4, 2, 72, 72, 16, True, [72, 0, 41]),
    (2, 4, 1, 48, 48, 32, False, [20, 48]),
    (1, 4, 2, 72, 72, 160, True, None),
    (2, 2, 1, 40, 40, 256, True, [40, 17]),
    # above 256: the D-chunked kernels' head dims
    (2, 2, 1, 40, 40, 320, True, [40, 17]),
]
IDS = ["gqa2-t72", "mqa-tq40-tk136-noncausal", "tq136-tk72",
       "gqa2-noncausal", "padded-a-row-all-padded", "mqa-padded-noncausal",
       "d160-t72", "d256-padded", "d320-padded"]


def _inputs(case, seed):
    b, h, hk, t, tk, d, _, lengths = case
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.standard_normal(s).astype(np.float32)
                   for s in ((b, h, t, d), (b, hk, tk, d), (b, hk, tk, d),
                             (b, h, t, d)))
    bias = None
    if lengths is not None:
        bias = np.where(np.arange(tk)[None, :] < np.array(lengths)[:, None],
                        0.0, tattn.NEG_INF).astype(np.float32)
    return q, k, v, do, bias


def _jax_forward(q, k, v, bias, causal, scale, dtype):
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    o, lse = jattn._streaming_forward(jq, jk, jv, causal, scale,
                                      with_lse=True, bias=jb)
    return (jq, jk, jv, jb), o, lse


def _torch(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_k9_lse_matches_pallas_streaming_forward(interpret, case,
                                                       dtype):
    q, k, v, _, bias = _inputs(case, 0)
    causal, scale = case[6], case[5] ** -0.5
    _, want_o, want_lse = _jax_forward(q, k, v, bias, causal, scale, dtype)
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    o, lse = tattn.attention_stream_plain(tq, tk, tv, causal, scale, tb,
                                          with_lse=True)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    assert lse.shape == tq.shape[:3]
    mag = tattn.attention_stream_plain(tq.float(), tk.float(),
                                       tv.float().abs(), causal, scale,
                                       tb).numpy()
    err = np.abs(o.float().numpy() - np.asarray(want_o.astype(jnp.float32)))
    assert np.all(err <= (1e-5 if dtype == "float32" else BF16_STEP) * mag
                  + 1e-30), err.max()
    want_lse = np.asarray(want_lse[..., 0])
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)
    if case[7] is not None and 0 in case[7]:
        row = case[7].index(0)
        assert np.all(lse[row].numpy() < tattn.NEG_INF / 2)
        assert not o[row].float().abs().any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_bwd_plain_matches_pallas_flash_backward(interpret, case,
                                                       dtype):
    q, k, v, do, bias = _inputs(case, 1)
    causal, scale = case[6], case[5] ** -0.5
    (jq, jk, jv, jb), o, lse = _jax_forward(q, k, v, bias, causal, scale,
                                            dtype)
    want = jattn._flash_streaming_bwd(jq, jk, jv, o, lse,
                                      jnp.asarray(do, getattr(jnp, dtype)),
                                      causal, scale, bias=jb)
    got = tattn.flash_bwd_plain(
        *(_torch(x, dtype) for x in (q, k, v, o.astype(jnp.float32))),
        torch.from_numpy(np.asarray(lse[..., 0])), _torch(do, dtype),
        causal, scale, None if bias is None else torch.from_numpy(bias))
    rtol = 1e-5 if dtype == "float32" else 2 * BF16_STEP
    for g, w, like in zip(got, want, (q, k, v)):
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == like.shape and g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=rtol * np.abs(w).max())
    if case[7] is not None and 0 in case[7]:
        row = case[7].index(0)
        assert not any(x[row].float().abs().any() for x in got)


def _reference_delta(o, do, dtype):
    """delta as ``_bwd_dq_kernel`` computes it: dO cast to q's dtype, the
    products of the f32 casts summed over the head dim."""
    jdt = getattr(jnp, dtype)
    jo, jdo = jnp.asarray(o, jdt), jnp.asarray(do, jdt)
    return np.asarray(jnp.sum(jdo.astype(jnp.float32) *
                              jo.astype(jnp.float32), axis=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_bwd_delta_plain_matches_the_reference_delta(case, dtype):
    q, k, v, do, bias = _inputs(case, 5)
    o, _ = tattn.attention_stream_plain(
        *(_torch(x, dtype) for x in (q, k, v)), case[6], None,
        None if bias is None else torch.from_numpy(bias), with_lse=True)
    o32 = o.float().numpy()
    want = _reference_delta(o32, do, dtype)
    got = tattn.flash_bwd_delta_plain(o, _torch(do, dtype))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    mag = np.abs(np.asarray(_torch(do, dtype).float()) * o32).sum(-1)
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * mag + 1e-30)
    # the wrapper takes the plain version on CPU tensors, dO in any dtype
    torch.testing.assert_close(
        tattn.flash_bwd_delta(o, torch.from_numpy(do)),
        tattn.flash_bwd_delta_plain(o, torch.from_numpy(do)), rtol=0, atol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_bwd_plain_takes_a_precomputed_delta(case):
    q, k, v, do, bias = (None if x is None else torch.from_numpy(x)
                         for x in _inputs(case, 6))
    causal = case[6]
    o, lse = tattn.attention_stream_plain(q, k, v, causal, None, bias,
                                          with_lse=True)
    delta = tattn.flash_bwd_delta_plain(o, do)
    got = tattn.flash_bwd_plain(q, k, v, o, lse, do, causal, None, bias,
                                delta=delta)
    want = tattn.flash_bwd_plain(q, k, v, o, lse, do, causal, None, bias)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_flash_bwd_plain_sums_the_gqa_group():
    """dK and dV of a KV head shared by a group of query heads are the sums
    of what each query head alone would give it."""
    case = (1, 4, 2, 72, 72, 16, True, None)
    q, k, v, do, _ = (None if x is None else torch.from_numpy(x)
                      for x in _inputs(case, 2))
    o, lse = tattn.attention_stream_plain(q, k, v, True, with_lse=True)
    _, dk, dv = tattn.flash_bwd_plain(q, k, v, o, lse, do, True)
    for j in range(2):          # KV head j serves query heads 2j, 2j + 1
        parts = [tattn.flash_bwd_plain(
            q[:, i:i + 1], k[:, j:j + 1], v[:, j:j + 1], o[:, i:i + 1],
            lse[:, i:i + 1], do[:, i:i + 1], True)
            for i in (2 * j, 2 * j + 1)]
        torch.testing.assert_close(dk[:, j], parts[0][1][:, 0] +
                                   parts[1][1][:, 0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(dv[:, j], parts[0][2][:, 0] +
                                   parts[1][2][:, 0], rtol=1e-5, atol=1e-6)


# (b, h, hk, t, d, padded lengths or None): a mask routes any tileable
# length to the streaming kernels; T 2112 at d 64 routes by its keys
# (2112 * 64 * 4 bytes > 512 KB)
ROUTED = [(2, 4, 2, 24, 16, [24, 9]), (1, 1, 1, 2112, 64, None)]


@pytest.mark.parametrize("case", ROUTED, ids=["mask-t24", "t2112"])
def test_autograd_through_k9_matches_jax_grad(interpret, case):
    b, h, hk, t, d, lengths = case
    q, k, v, do, _ = _inputs((b, h, hk, t, t, d, True, None), 3)
    kpm = None
    if lengths is not None:
        kpm = np.arange(t)[None, :] < np.array(lengths)[:, None]
    route = []
    real = jattn._streaming_attention

    def spy(*a):
        route.append("K9")
        return real(*a)

    jattn._streaming_attention = spy
    try:
        def loss(q_, k_, v_):
            o = jattn.fused_attention(
                q_, k_, v_, causal=True,
                key_padding_mask=None if kpm is None else jnp.asarray(kpm))
            return jnp.sum(o * jnp.asarray(do))

        want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                      (q, k, v)))
    finally:
        jattn._streaming_attention = real
    assert route == ["K9"]
    ours = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = tattn.fused_attention(
        *ours, causal=True,
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm))
    assert o.grad_fn is not None and \
        type(o.grad_fn).__name__ == "_K9Backward"
    o.backward(torch.from_numpy(do))
    for got, w in zip(ours, want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_k9_writes_its_lse_only_for_autograd(monkeypatch):
    """The forward asks for the row logsumexp only when autograd will need
    it, as K1/K2 write their index/scale: a scoring call skips it."""
    seen = []
    plain = tattn.attention_stream_plain

    def spy(*a, with_lse=False, **kw):
        seen.append(with_lse)
        return plain(*a, with_lse=with_lse, **kw)

    monkeypatch.setattr(tattn, "attention_stream_plain", spy)
    q = torch.randn(1, 2, 16, 16)
    with torch.inference_mode():
        tattn.attention_stream_fwd(q, q, q, True)
    tattn.attention_stream_fwd(q, q, q, True)
    tattn.attention_stream_fwd(q.requires_grad_(), q, q, True).sum() \
        .backward()
    assert seen == [False, False, True]


def test_backward_wrappers_on_the_cpu_launch_nothing():
    q, k, v, do, bias = (None if x is None else torch.from_numpy(x)
                         for x in _inputs(CASES[4], 4))
    o, lse = tattn.attention_stream_plain(q, k, v, True, None, bias,
                                          with_lse=True)
    wrappers = (tattn.flash_bwd_delta, tattn.attention_stream_bwd_dq,
                tattn.attention_stream_bwd_dkv)
    before = [w.launches for w in wrappers]
    delta = tattn.flash_bwd_delta(o, do)
    dq = tattn.attention_stream_bwd_dq(q, k, v, o, lse, do, True, None, bias)
    dk, dv = tattn.attention_stream_bwd_dkv(q, k, v, o, lse, do, True, None,
                                            bias, delta=delta)
    assert [w.launches for w in wrappers] == before
    assert torch.equal(delta, tattn.flash_bwd_delta_plain(o, do))
    want = tattn.flash_bwd_plain(q, k, v, o, lse, do, True, None, bias)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="lse must be"):
        tattn.attention_stream_bwd_dq(q, k, v, o, lse[..., :-1], do)
    with pytest.raises(ValueError, match="delta must be"):
        tattn.attention_stream_bwd_dkv(q, k, v, o, lse, do,
                                       delta=delta[..., :-1])
    with pytest.raises(ValueError, match="shaped like q"):
        tattn.attention_stream_bwd_dkv(q, k, v, o[:, :, :-1], lse, do)
    with pytest.raises(ValueError, match="flash_bwd_delta takes"):
        tattn.flash_bwd_delta(o, do[:, :, :-1])
