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

The repairs of the port's faults: K8's backward (autograd of the chunked
plain form) against ``jax.grad`` of the reference's ``fused_attention`` to
1e-5 of each gradient's largest magnitude in float32; decode with a cache
dtype other than the model's against JAX's, which promotes at each
product: log-probs within 2 bfloat16 steps of their largest magnitude
where the model is bf16 (its LayerNorm rounds at each jnp op in JAX and
once in torch), 1e-5 where it is f32, greedy tokens equal.  K12's plain
version against the reference's ``paged_attention`` in interpret mode:
float32 within 1e-6, bfloat16 within one bfloat16 step of each output's
sum of |p·v|.  K12's plan (``paged_plan``, which picks the kernel's path
and grid from the shapes alone) on the continuous path's shapes and at the
paths' edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.ops import attention as jattn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models import TransformerLM
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
    # head dims the kernels pad to 256 (160) or take as they are (256), and
    # one the D-chunked kernels take (320, a multiple of their panel)
    (2, 2, 1, 16, 16, 160, True),
    (2, 2, 2, 24, 16, 256, False),
    (2, 2, 1, 16, 16, 320, True),
    # the f32 kernel's block edges (128 query rows up to d 128, 64 at d
    # 256; key tiles of 64, 32 at d 256), as phase 2d of chip_smoke.py
    # sends them to the card: T one short of, equal to and past a block,
    # GQA 8/2 at d 128 and 256 with T not a multiple of the block, Tq < Tk
    # without the causal mask at a Tk that is not a multiple of 64, and a
    # T whose blocks hold whole padded key tiles under the hole bias
    (1, 2, 1, 127, 127, 64, True),
    (1, 2, 1, 128, 128, 64, True),
    (1, 2, 1, 129, 129, 64, True),
    (1, 2, 2, 257, 257, 64, True),
    (1, 8, 2, 200, 200, 128, True),
    (1, 8, 2, 100, 100, 256, True),
    (1, 4, 4, 100, 300, 64, False),
    (2, 2, 1, 384, 384, 64, True),
]
IDS = [f"b{c[0]}h{c[1]}kv{c[2]}t{c[3]}tk{c[4]}d{c[5]}" +
       ("causal" if c[6] else "") for c in CASES]


def _qkv(case, seed):
    b, h, hk, t, tk, d, _ = case
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((b, h, t, d)).astype(np.float32),
            rs.standard_normal((b, hk, tk, d)).astype(np.float32),
            rs.standard_normal((b, hk, tk, d)).astype(np.float32))


def _bias(b, tk, hole=False):
    """Row 0 padded from the middle (``hole``: keys [Tk/4, 3 Tk/4) padded,
    whole key tiles inside the causal range at Tk 384), row 1 with every
    key padded."""
    kpm = np.ones((b, tk), bool)
    if hole:
        kpm[0, tk // 4:3 * tk // 4] = False
    else:
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
@pytest.mark.parametrize("padded", [False, True, "hole"],
                         ids=["nobias", "bias", "hole"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_k9_matches_pallas_streaming_forward(interpret, case, padded,
                                                   dtype):
    q, k, v = _qkv(case, 1)
    causal, scale = case[6], 1.0 / np.sqrt(case[5])
    bias = _bias(case[0], case[4], padded == "hole") if padded else None
    jdt = getattr(jnp, dtype)
    # lengths the reference's tiling rule refuses (T 127, 129, 257) run as
    # one block each way: the kernel is the same, its grid one step
    blocks = None if jattn._pick_stream_blocks(case[3], case[4]) else \
        (case[3], case[4])
    want = jattn._streaming_forward(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal, scale, bias=None if bias is None else jnp.asarray(bias),
        blocks=blocks)
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


# -- repairs: K8's backward, head dims, mixed decode dtypes ---------------------

@pytest.mark.parametrize("case", [c for c in CASES
                                  if jattn._pick_block_q(c[3], c[4])],
                         ids=[i for c, i in zip(CASES, IDS)
                              if jattn._pick_block_q(c[3], c[4])])
def test_k8_backward_is_autograd_of_the_chunked_form(interpret, case):
    """The card's K8 backward recomputes through the chunked plain form, as
    the reference's ``_fused_attention_bwd`` does: its gradients against
    ``jax.grad`` of the reference's dispatch, which reaches the Pallas K8
    here."""
    q, k, v = _qkv(case, 5)
    causal, scale = case[6], 1.0 / np.sqrt(case[5])
    do = np.random.RandomState(6).standard_normal(q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        o = jattn.fused_attention(q_, k_, v_, causal=causal)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ours = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tattn._chunked_attention_reference(*ours, causal, scale).backward(
        torch.from_numpy(do))
    for got, w in zip(ours, want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_head_dims_are_padded_to_the_kernels_sizes():
    # up to 256 the wgmma tiles' sizes; above, multiples of the D-chunked
    # kernels' 64-column panel, with no upper limit
    pick = tattn._kernel_head_dim
    dims = (8, 16, 48, 64, 80, 96, 128, 160, 256, 257, 300, 320, 512, 1000)
    assert [pick(d) for d in dims] == \
        [16, 16, 64, 64, 128, 128, 128, 256, 256, 320, 320, 320, 512, 1024]


LM_CONFIGS = {"learned": dict(position="learned"),
              "rope-gqa": dict(position="rope", num_kv_heads=2)}


@pytest.mark.parametrize("mix", ["bf16-model-f32-cache",
                                 "f32-model-bf16-cache"])
@pytest.mark.parametrize("name", list(LM_CONFIGS))
def test_mixed_cache_and_model_dtypes_decode_as_jax(name, mix):
    jm = JTransformerLM(50, max_len=16, embed_dim=32, num_heads=4,
                        num_layers=2, **LM_CONFIGS[name])
    params, state = jm.init(jax.random.PRNGKey(0))
    tm = TransformerLM(50, max_len=16, embed_dim=32, num_heads=4,
                       num_layers=2, **LM_CONFIGS[name])
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    bf16_model = mix.startswith("bf16")
    mdt, cdt = ((jnp.bfloat16, jnp.float32) if bf16_model
                else (jnp.float32, jnp.bfloat16))
    tmdt, tcdt = ((torch.bfloat16, torch.float32) if bf16_model
                  else (torch.float32, torch.bfloat16))
    params = jax.tree_util.tree_map(lambda a: a.astype(mdt), params)
    tm = tm.to("cpu", tmdt).evaluate()
    ids = np.random.RandomState(1).randint(1, 51, (2, 10))
    jcache = jm.init_cache(2, 16, cdt)
    cache = tm.init_cache(2, 16, tcdt)
    with torch.inference_mode():
        for lo, hi in ((0, 8), (8, 9), (9, 10)):
            want, jcache = jm.decode(params, state,
                                     jnp.asarray(ids[:, lo:hi]), jcache, lo)
            got = tm.decode(torch.from_numpy(ids[:, lo:hi]), cache, lo)
            want = np.asarray(want, np.float32)
            assert got.dtype == torch.float32    # promoted, as in jnp
            atol = 2 * BF16_STEP * 2.0 ** np.floor(
                np.log2(np.abs(want).max())) if bf16_model else 1e-5
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=atol)
    prompt = ids[:, :5]
    want = np.asarray(jm.generate(params, state, jnp.asarray(prompt), 6,
                                  cache_dtype=cdt))
    got = tm.generate(torch.from_numpy(prompt), 6, cache_dtype=tcdt,
                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


# -- K12's plain version --------------------------------------------------------

# (b, h, hkv, s, d, pages P, page size, lp, tokens per row, (row, logical
# page) slots set to the trash page): the cases of tests/test_tuning.py's
# paged-kernel tests — GQA, ragged tables, S 1 and 2, page sizes 4, 5 and
# 16 — with a NaN-poisoned trash page; a GQA prefill of 68 packed rows (the
# kernel's tensor-core path in bf16, across its 64-row tile); page size 5
# with a trash page inside a row's visible keys
PAGED = [(3, 4, 2, 2, 8, 10, 4, 5, [11, 6, 19], []),
         (2, 4, 4, 1, 16, 9, 5, 4, [14, 3], []),
         (2, 8, 1, 2, 8, 6, 16, 3, [40, 17], []),
         (3, 4, 2, 1, 8, 10, 4, 5, [20, 0, 2], []),
         (2, 8, 2, 17, 16, 12, 16, 5, [70, 40], []),
         (2, 4, 2, 3, 8, 12, 5, 6, [27, 18], [(0, 2)])]
PAGED_IDS = ["gqa-s2-ps4", "mha-s1-ps5", "mqa-s2-ps16", "all-trash-row",
             "gqa-prefill-68-rows", "ps5-trash-inside"]


def _paged_inputs(case, seed):
    b, h, hkv, s, d, p, ps, lp, lengths, holes = case
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((b, h, s, d)).astype(np.float32)
    kp = rs.standard_normal((p + 1, hkv, ps, d)).astype(np.float32)
    vp = rs.standard_normal((p + 1, hkv, ps, d)).astype(np.float32)
    kp[p] = vp[p] = np.nan
    perm = list(rs.permutation(p))
    pages = np.full((b, lp), p, np.int32)
    pos = np.zeros((b, s), np.int32)
    for r, n in enumerate(lengths):
        np_ = -(-n // ps)
        pages[r, :np_] = [perm.pop() for _ in range(np_)]
        pos[r] = np.arange(max(n, s) - s, max(n, s))
    for r, page in holes:
        pages[r, page] = p
    return q, kp, vp, pages, pos, 1.0 / np.sqrt(d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PAGED, ids=PAGED_IDS)
def test_plain_k12_matches_pallas_paged_attention(interpret, case, dtype):
    q, kp, vp, pages, pos, scale = _paged_inputs(case, 2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jattn.paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(pages), jnp.asarray(pos), scale), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, kp, vp))
    tpages, tpos = torch.from_numpy(pages), torch.from_numpy(pos)
    got = tattn.paged_attention_plain(tq, tk, tv, tpages, tpos, scale)
    assert got.dtype == tdt and got.shape == tq.shape
    assert torch.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    else:
        mag = tattn.paged_attention_plain(tq.float(), tk.float(),
                                          tv.float().abs(), tpages, tpos,
                                          scale).numpy()
        np.testing.assert_array_less(np.abs(got.float().numpy() - want),
                                     BF16_STEP * mag + 1e-30)


def test_paged_wrapper_on_the_cpu_launches_nothing():
    q, kp, vp, pages, pos, scale = (
        torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        for x in _paged_inputs(PAGED[0], 3))
    before = tattn.paged_attention.launches
    got = tattn.paged_attention(q, kp, vp, pages, pos, scale)
    assert tattn.paged_attention.launches == before
    assert torch.equal(got, tattn.paged_attention_plain(q, kp, vp, pages,
                                                        pos, scale))
    with pytest.raises(ValueError, match="do not agree"):
        tattn.paged_attention(q[..., :4], kp, vp, pages, pos, scale)
    with pytest.raises(ValueError, match="positions"):
        tattn.paged_attention(q, kp, vp, pages, pos[:, :1], scale)
    with pytest.raises(TypeError, match="integer"):
        tattn.paged_attention(q, kp, vp, pages.float(), pos, scale)
    with pytest.raises(TypeError, match="one dtype"):
        tattn.paged_attention(q, kp, vp.bfloat16(), pages, pos, scale)
    # the page-split path's rows a block: at most PAGED_ROWS, rows x D <=
    # PAGED_OUT; the table's length no longer limits them (the score row
    # left shared memory)
    f32 = torch.float32
    assert tattn.paged_plan(1, 8, 8, 512, 64, 16, 128, f32,
                            f32).rows_per_block == tattn.PAGED_ROWS
    assert tattn.paged_plan(1, 8, 8, 512, 256, 16, 128, f32,
                            f32).rows_per_block == 4
    assert tattn.paged_plan(1, 3, 1, 1, 64, 16, 128, f32,
                            f32).rows_per_block == 3
    assert tattn.paged_plan(1, 1, 1, 1, 64, 16, 4096, f32,
                            f32).rows_per_block == 1
    with pytest.raises(ValueError, match="head dims up to 1024"):
        tattn.paged_plan(1, 1, 1, 1, 1025, 16, 8, f32, f32)


BF16, F32 = torch.bfloat16, torch.float32
# (b, h, hkv, s, d, ps, lp, q dtype, cache dtype, path): the continuous
# path's decode and prefill shapes (8 slots, 8 heads, d 64, page size 16, a
# 2048-token table), GQA prefill at the tensor-core path's edge, and what
# takes the page split: f32, f32 q over a bf16 cache, d 48, 63 packed rows
PLAN_PATHS = [(8, 8, 8, 1, 64, 16, 128, BF16, BF16, "split"),
              (1, 8, 8, 512, 64, 16, 128, BF16, BF16, "tensor_core"),
              (1, 8, 8, 128, 64, 16, 128, BF16, BF16, "tensor_core"),
              (2, 8, 2, 16, 128, 8, 20, BF16, BF16, "tensor_core"),
              (2, 8, 2, 17, 256, 5, 20, BF16, BF16, "tensor_core"),
              (1, 8, 8, 512, 64, 16, 128, F32, F32, "split"),
              (1, 8, 8, 512, 64, 16, 128, F32, BF16, "split"),
              (1, 8, 8, 512, 48, 16, 128, BF16, BF16, "split"),
              (1, 9, 1, 7, 64, 16, 128, BF16, BF16, "split")]


@pytest.mark.parametrize("case", PLAN_PATHS,
                         ids=["decode", "prefill-512", "prefill-128",
                              "gqa-64-rows", "gqa-68-rows-d256", "f32",
                              "f32-q-bf16-cache", "d48", "63-rows"])
def test_paged_plan_picks_the_path_by_shape(case):
    b, h, hkv, s, d, ps, lp, qdt, cdt, path = case
    plan = tattn.paged_plan(b, h, hkv, s, d, ps, lp, qdt, cdt)
    rows = h // hkv * s
    assert plan.path == path
    assert plan.row_tiles == -(-rows // plan.rows_per_block)
    if path == "tensor_core":
        assert plan.rows_per_block == 64 and plan.splits == 1
        # a pool that does not start on 16 bytes takes the page split
        assert tattn.paged_plan(b, h, hkv, s, d, ps, lp, qdt, cdt,
                                aligned=False).path == "split"
        return
    assert 1 <= plan.rows_per_block <= tattn.PAGED_ROWS
    assert plan.rows_per_block * d <= tattn.PAGED_OUT
    assert plan.keys_per_tile in (8, 16, 32, 64)
    # the splits cover the table once, none of them empty of pages
    assert plan.pages_per_split * plan.splits >= lp
    assert plan.pages_per_split * (plan.splits - 1) < lp
    assert plan.pages_per_split * ps >= min(tattn.PAGED_SPLIT_KEYS, lp * ps)


def test_paged_plan_fills_the_card_at_the_decode_shape():
    # 8 slots x 8 heads, S 1, d 64 over a 2048-token table, each row with
    # 520-576 visible keys (the continuous run's decode steps): the splits
    # put at least one block with visible keys on each of the 132 SMs, and
    # the grid holds two waves or more
    plan = tattn.paged_plan(8, 8, 8, 1, 64, 16, 128, BF16, BF16)
    blocks = 8 * 8 * plan.row_tiles * plan.splits
    assert blocks >= 2 * tattn.H100_SMS
    keys = plan.pages_per_split * 16
    visible = sum(-(-n // keys) for n in [520, 576] * 32)
    assert visible >= tattn.H100_SMS


@pytest.mark.parametrize("dtypes", [(BF16, BF16), (F32, F32), (F32, BF16)],
                         ids=["bf16", "f32", "f32-q-bf16-cache"])
def test_paged_plan_takes_a_65536_token_table(dtypes):
    # the old kernel kept a row of L scores in shared memory and raised
    # here; the plan now sets no limit on the table's length
    for s in (1, 512):
        plan = tattn.paged_plan(8, 8, 8, s, 64, 16, 4096, *dtypes)
        assert plan.pages_per_split * plan.splits >= 4096
    plan = tattn.paged_plan(1, 1, 1, 1, 1024, 1, 65536, F32, F32)
    assert plan.path == "split" and plan.keys_per_tile >= 8
