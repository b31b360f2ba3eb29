"""The port's quantized LM and its quantized and speculative continuous
serving (``ops.quant.quantize_model(..., extra_keys=("tok",))``,
``ContinuousGenerator(quantize=, calibration_prompts=, draft_model=,
draft_quantize=, spec_k=)``) against the JAX package on the CPU.

The quantized LM is the reference's test size, ``TransformerLM(300,
max_len=64, embed_dim=64, num_heads=4, num_layers=2)``, so every projection
and ``tok`` reach ``MIN_QUANT_ELEMENTS``; the speculative tests use
``tests/test_paging.py``'s ``_lm`` (vocab 64, embed 32, 2 heads).  Weights
come from the JAX model's ``init`` and cross with ``load_jax_params``,
prompts from numpy seeds.  The JAX side runs K13-K15 in Pallas interpret
mode for the forwards (as ``tests/test_torch_port_quant.py`` does) and its
plain reference inside its ``ContinuousGenerator`` (as ``tests/
test_quant.py``'s generator tests do); the port's wrappers run their plain
versions on CPU tensors.  Tolerances: packed leaves and gathered rows
bit-equal; calibration scales to rtol 1e-5 (the fp forward sums in another
order); quantized log-probs to atol 1e-4 in float32 (K13/K15 sums in
another order, 2e-6 seen), plus one bf16 step (2^-8) of each over a bf16
pool, where the out projection's output rounds to bf16; greedy tokens
exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.ops import quant as jq
from bigdl_tpu.serving.scheduler.continuous import \
    ContinuousGenerator as JContinuousGenerator
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.ops import quant as tq
from bigdl_tpu_torch.serving import ContinuousGenerator

torch.set_num_threads(1)

MODES = ("w8", "w8a8", "w4", "f8")
LOGP_ATOL = 1e-4


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


def _pair(vocab=300, max_len=64, embed=64, heads=4, layers=2, seed=0):
    jm = JTransformerLM(vocab, max_len=max_len, embed_dim=embed,
                        num_heads=heads, num_layers=layers)
    params, state = jm.init(jax.random.PRNGKey(seed))
    tm = TransformerLM(vocab, max_len=max_len, embed_dim=embed,
                       num_heads=heads, num_layers=layers)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, state, tm.evaluate()


def _truncated(jm, params, state, tm, layers=1):
    """The reference's truncated draft (``tests/test_paging.py``
    ``_truncated``): the first ``layers`` blocks with ``tok``, ``pos`` and
    ``ln_f``, on both sides."""
    heads = jm.blocks[0].attn.num_heads
    jd = JTransformerLM(jm.vocab_size, max_len=jm.max_len,
                        embed_dim=jm.embed_dim, num_heads=heads,
                        num_layers=layers)
    dparams = {"tok": params["tok"], "pos": params["pos"],
               "blocks": params["blocks"][:layers], "ln_f": params["ln_f"]}
    dstate = {"blocks": state["blocks"][:layers], "ln_f": state["ln_f"]}
    td = TransformerLM(tm.vocab_size, max_len=tm.max_len,
                       embed_dim=tm.embed_dim, num_heads=heads,
                       num_layers=layers)
    load_jax_params(td, jax.tree_util.tree_map(np.asarray, dparams))
    return jd, dparams, dstate, td.evaluate()


def _ids(shape, seed, vocab=300):
    return np.random.RandomState(seed).randint(1, vocab + 1, shape)


def _prompts(n, seed, vocab=300, lo=5, hi=12):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab + 1, size=rs.randint(lo, hi)).astype(
        np.int32) for _ in range(n)]


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


def _jax_leaves(tree):
    """{path: leaf} of a packed JAX tree, packed leaves as dicts."""
    out = {}

    def rec(t, path):
        if jq.is_quantized(t):
            out[path] = t
        elif isinstance(t, dict):
            for k, v in t.items():
                rec(v, f"{path}.{k}" if path else k)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                rec(v, f"{path}.{i}" if path else str(i))
        else:
            out[path] = t
    rec(tree, "")
    return out


def _port_leaves(qmodel):
    """The same {path: leaf} view of a ``quantize_model`` copy."""
    out = {}
    for path, m in tq._walk(qmodel):
        for name in getattr(m, "packed_fields", {}):
            out[tq._param_path(path, name)] = tq.packed_weight(m, name)
        for name, p in m._parameters.items():
            if p is not None:
                out[tq._param_path(path, name)] = p
    return out


def _calib(jm, params, state, tm, seed=5):
    batch = _ids((2, 16), seed)
    return (jq.calibrate(jm, params, state, [batch.astype(np.int32)]),
            tq.calibrate(tm, [batch]))


def _packed_pair(mode, dtype="float32"):
    """The reference's packed tree and the port's packed copy of the same
    weights (in ``dtype``), ``w8a8`` with the reference's scales on both
    sides so that the leaves can be held bit for bit."""
    jm, params, state, tm = _pair()
    if dtype == "bfloat16":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                        params)
        tm = tm.to("cpu", torch.bfloat16)
    calib = _calib(jm, params, state, tm)[0] if mode == "w8a8" else None
    qp = jq.quantize_params(params, mode=mode, calib=calib,
                            extra_keys=("tok",))
    qm = tq.quantize_model(tm, mode, calib=calib, extra_keys=("tok",))
    return jm, qp, state, tm, qm


# -- the quantized copy against quantize_params ---------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_packed_lm_leaves_match_jax(mode):
    _, qp, _, tm, qm = _packed_pair(mode)
    want, got = _jax_leaves(qp), _port_leaves(qm)
    assert set(got) == set(want)
    packed = sorted(p for p, v in want.items() if jq.is_quantized(v))
    # 2 blocks x (4 projections + fc1 + fc2) and the tied table
    assert len(packed) == 13 and "tok" in packed and "pos" not in packed
    for path, leaf in want.items():
        if jq.is_quantized(leaf):
            assert set(got[path]) == set(leaf), path
            for key in leaf:
                np.testing.assert_array_equal(_np(got[path][key]),
                                              _np(leaf[key]), err_msg=path)
        else:
            np.testing.assert_array_equal(_np(got[path]), _np(leaf))
    sx = sorted(p for p, v in want.items() if jq.is_quantized(v) and
                "sx" in v)
    assert sx == ([p for p in packed if p != "tok"] if mode == "w8a8"
                  else [])
    # the caller's model keeps its fp weights
    assert tm.tok is not None and tq.packed_weight(tm, "tok") is None
    assert all(p.dtype == torch.float32 for p in tm.parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_quantized_lm_log_probs_match_jax(mode, dtype, interpret):
    """The packed forward against the reference's ``apply`` on its packed
    tree, and its dtype: float32 even for a bf16 model, since the packed
    gather widens to f32 as the reference's does without a ``"dt"``
    stamp."""
    jm, qp, state, _, qm = _packed_pair(mode, dtype)
    ids = _ids((2, 16), 2)
    want, _ = jm.apply(qp, state, jnp.asarray(ids, jnp.int32),
                       training=False)
    with torch.inference_mode():
        got = qm(torch.from_numpy(ids))
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGP_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_quantized_decode_pages_over_a_bf16_pool_matches_jax(mode):
    """A prefill and a step of the packed LM through ``decode_pages`` over
    a bf16 pool against the reference's on its packed tree: the attention
    output comes back in the pool's dtype, so the out projection runs in
    bf16 on both sides (K13/K15 bf16, K14 with a bf16 output), the rest in
    f32.  Log-probs within LOGP_ATOL plus one bf16 step (2^-8) of each:
    that output rounds to bf16 after f32 sums taken in another order."""
    jm, qp, state, _, qm = _packed_pair(mode)
    ids = _ids((2, 9), 3)
    pages = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    jcache = jm.init_paged_cache(6, 4, jnp.bfloat16)
    tcache = qm.init_paged_cache(6, 4, torch.bfloat16)
    seen = []
    real = tq.int8_matmul

    def spy(x, qt):
        seen.append(x.dtype)
        return real(x, qt)

    tq.int8_matmul = spy
    try:
        with torch.inference_mode():
            for tok, pos in ((ids[:, :8], [0, 0]), (ids[:, 8:], [8, 8])):
                want, jcache = jm.decode_pages(
                    qp, state, jnp.asarray(tok, jnp.int32), jcache,
                    jnp.asarray(pages), jnp.asarray(pos, jnp.int32),
                    jnp.ones(2, bool))
                got = qm.decode_pages(torch.from_numpy(tok), tcache,
                                      torch.from_numpy(pages),
                                      torch.tensor(pos),
                                      torch.ones(2, dtype=torch.bool))
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=2.0 ** -8, atol=LOGP_ATOL)
    finally:
        tq.int8_matmul = real
    # two calls of 2 x (q, k, v, out, fc1, fc2) and the head: out in bf16
    assert len(seen) == 26 and seen.count(torch.bfloat16) == 4


@pytest.mark.parametrize("mode", MODES)
def test_packed_gather_rows_match_jax(mode):
    _, qp, _, _, qm = _packed_pair(mode)
    idx = _ids((3, 7), 4) - 1
    want = jq.int8_gather_rows(qp["tok"], jnp.asarray(idx))
    got = tq.int8_gather_rows(tq.packed_weight(qm, "tok"),
                              torch.from_numpy(idx))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_w8a8_calibrated_sites_match_jax():
    """Calibration is keyed by weight: each of an attention layer's four
    projections gets its own input's scale (``wo`` sees the attention
    output, not the block's), and the tied head, which never observes, gets
    none."""
    jm, params, state, tm = _pair()
    want, got = _calib(jm, params, state, tm)
    sites = {f"blocks.{i}.{s}" for i in range(2) for s in (
        "attn.wq", "attn.wk", "attn.wv", "attn.wo", "fc1.weight",
        "fc2.weight")}
    assert set(got) == set(want) == sites
    for path in want:
        assert got[path] == pytest.approx(want[path], rel=1e-5)
    assert got["blocks.0.attn.wo"] != got["blocks.0.attn.wq"]
    assert got["blocks.0.attn.wq"] == got["blocks.0.attn.wk"]
    # the port's own scales pack a copy that serves 12 sites on K14
    qm = tq.quantize_model(tm, "w8a8", calib=got, extra_keys=("tok",))
    leaves = _port_leaves(qm)
    assert sorted(p for p, v in leaves.items()
                  if isinstance(v, dict) and "sx" in v) == sorted(sites)
    assert "sx" not in leaves["tok"]


def test_calibrate_of_a_classifier_keeps_its_scales():
    """A classifier's scales are as before the keying by weight: each
    Linear's input absmax over the calibration rows, / 127, float64 rows
    going in as float32; ``DLClassifier(quantize="w8a8")`` bakes them."""
    from bigdl_tpu_torch.api import DLClassifier
    model = (tnn.Sequential().add(tnn.Linear(64, 128)).add(tnn.ReLU())
             .add(tnn.Linear(128, 64)).add(tnn.LogSoftMax())).evaluate()
    rows = list(np.random.RandomState(3).standard_normal((4, 64)))
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__(mod, max(
            seen.get(mod, 0.0), float(args[0].abs().max()))))
        for m in (model.layers[0], model.layers[2])]
    with torch.inference_mode():
        model(torch.as_tensor(np.stack(rows), dtype=torch.float32))
    for h in hooks:
        h.remove()
    want = {"0.weight": seen[model.layers[0]] / 127.0,
            "2.weight": seen[model.layers[2]] / 127.0}
    assert tq.calibrate(model, [np.stack(rows)]) == want
    clf = DLClassifier(model, (4, 64), quantize="w8a8", device="cpu",
                       calibration_rows=rows)
    for i, path in ((0, "0.weight"), (2, "2.weight")):
        sx = tq.packed_weight(clf.qmodel.layers[i])["sx"]
        assert sx.item() == pytest.approx(want[path], rel=1e-7)


# -- quantized continuous serving -------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "w8a8", "w4", "f8"])
def test_quantized_generator_matches_jax_and_generate(mode):
    jm, params, state, tm = _pair()
    prompts = _prompts(5, 6)
    cal = dict(calibration_prompts=_prompts(3, 7)) if mode == "w8a8" \
        else {}
    kw = dict(num_slots=3, seq_buckets=[16, 32], steps_per_sync=2)
    with JContinuousGenerator(jm, params, state, quantize=mode, **cal,
                              **kw) as g:
        want = g.generate(prompts, max_new=10)
    with ContinuousGenerator(tm, quantize=mode, device="cpu", **cal,
                             **kw) as g:
        got = g.generate(prompts, max_new=10)
        qm = g.model
        assert g.quantize == tq.normalize_mode(mode)
    assert qm is not tm and tq.packed_weight(qm, "tok") is not None
    assert tq.param_bytes_by_dtype(qm).get(
        "float8_e4m3fn" if mode == "f8" else "int8", 0) > 0
    assert tq.packed_weight(tm, "tok") is None
    for w, o, p in zip(want, got, prompts):
        np.testing.assert_array_equal(o, w)
        ref = qm.generate(torch.from_numpy(p[None]), 10, device="cpu")
        np.testing.assert_array_equal(o, ref[0].numpy())


def test_quantized_generator_validation():
    tm = _pair()[3]
    with pytest.raises(ValueError, match="unsupported quantize mode"):
        ContinuousGenerator(tm, quantize="int2", device="cpu",
                            warmup=False)
    with pytest.raises(ValueError, match="calibration_prompts"):
        ContinuousGenerator(tm, quantize="w8a8", device="cpu", warmup=False)


# -- speculative decoding (ports of tests/test_paging.py:348-463) --------------

def _small(max_len=96, layers=2):
    """``tests/test_paging.py``'s ``_lm``."""
    return _pair(vocab=64, max_len=max_len, embed=32, heads=2,
                 layers=layers)


def _refs(tm, prompts, budgets):
    return [tm.generate(torch.from_numpy(p[None]), n, device="cpu")[0]
            .numpy() for p, n in zip(prompts, budgets)]


def _run(gen, prompts, budgets):
    with gen as g:
        outs = [f.result(timeout=120)
                for f in [g.submit(p, n) for p, n in zip(prompts, budgets)]]
        st = g.stats()
    return outs, st


def test_speculative_with_truncated_draft_matches_jax_and_generate():
    jm, params, state, tm = _small()
    jd, dparams, dstate, td = _truncated(jm, params, state, tm)
    rs = np.random.RandomState(7)
    prompts = [rs.randint(1, 65, size=rs.randint(4, 12)).astype(np.int32)
               for _ in range(5)]
    budgets = [int(rs.randint(2, 10)) for _ in range(5)]
    kw = dict(num_slots=2, page_size=8, seq_buckets=[16], steps_per_sync=2,
              spec_k=3)
    want, jst = _run(JContinuousGenerator(
        jm, params, state, draft_model=jd, draft_params=dparams,
        draft_state=dstate, **kw), prompts, budgets)
    got, st = _run(ContinuousGenerator(tm, draft_model=td, device="cpu",
                                       **kw), prompts, budgets)
    for w, o, r in zip(want, got, _refs(tm, prompts, budgets)):
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, r)
    spec = st["spec"]
    assert spec["proposed"] > 0 and 0 < spec["accept_rate"] <= 1
    assert spec == jst["spec"]
    assert st["counters"]["serve.gen.spec.proposed"] == spec["proposed"]
    assert st["counters"]["serve.gen.spec.accepted"] == spec["accepted"]


def test_speculative_self_draft_accepts_everything():
    """The target as its own draft, over deep budgets: every proposal
    matches, so the accept rate is exactly 1.0 (a draft cache that skipped
    the last proposal's K/V would decay it within a few rounds)."""
    jm, params, state, tm = _small(max_len=64, layers=1)
    rs = np.random.RandomState(8)
    prompts = [rs.randint(1, 65, size=6).astype(np.int32) for _ in range(3)]
    kw = dict(num_slots=2, page_size=8, seq_buckets=[8], spec_k=4)
    want, _ = _run(JContinuousGenerator(
        jm, params, state, draft_model=jm, draft_params=params,
        draft_state=state, **kw), prompts, [40] * 3)
    got, st = _run(ContinuousGenerator(tm, draft_model=tm, device="cpu",
                                       **kw), prompts, [40] * 3)
    for w, o, r in zip(want, got, _refs(tm, prompts, [40] * 3)):
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, r)
    assert st["spec"]["accept_rate"] == 1.0
    assert st["spec"]["proposed"] >= 3 * 4 * 7


def test_speculative_eos_matches_plain_paged():
    """The host's accept walk replays the sequential eos rule: a
    speculative run with ``eos_id`` stops where plain paged decoding
    does, and where the reference's speculative run does.  The eos id is
    the fifth greedy token of the first prompt, so that request ends
    there (the reference's test takes id 17, which these weights never
    emit)."""
    jm, params, state, tm = _small(max_len=64, layers=1)
    rs = np.random.RandomState(9)
    prompts = [rs.randint(1, 65, size=5).astype(np.int32) for _ in range(3)]
    eos = int(_refs(tm, prompts[:1], [12])[0][4])
    kw = dict(num_slots=2, page_size=8, seq_buckets=[8], steps_per_sync=2,
              eos_id=eos)
    plain, _ = _run(ContinuousGenerator(tm, device="cpu", **kw), prompts,
                    [12] * 3)
    spec, _ = _run(ContinuousGenerator(tm, draft_model=tm, spec_k=3,
                                       device="cpu", **kw), prompts,
                   [12] * 3)
    want, _ = _run(JContinuousGenerator(
        jm, params, state, draft_model=jm, draft_params=params,
        draft_state=state, spec_k=3, **kw), prompts, [12] * 3)
    for a, b, w in zip(plain, spec, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, w)
    assert spec[0].size <= 5 and spec[0][-1] == eos


def test_speculative_full_capacity_request_cannot_poison_neighbors():
    """A request ending at the cache's end (prompt + max_new == max_len)
    sends its verify rows past the learned-position table: their rows come
    back finite (clipped), so the trash page they write stays inert for
    every neighbour."""
    jm, params, state, tm = _small(max_len=32, layers=1)
    rs = np.random.RandomState(13)
    full = rs.randint(1, 65, size=6).astype(np.int32)     # 6 + 26 = 32
    neighbors = [rs.randint(1, 65, size=6).astype(np.int32)
                 for _ in range(3)]
    prompts, budgets = [full] + neighbors, [26, 20, 20, 20]
    kw = dict(num_slots=4, max_len=32, page_size=8, seq_buckets=[8],
              spec_k=3)
    want, _ = _run(JContinuousGenerator(
        jm, params, state, draft_model=jm, draft_params=params,
        draft_state=state, **kw), prompts, budgets)
    got, _ = _run(ContinuousGenerator(tm, draft_model=tm, device="cpu",
                                      **kw), prompts, budgets)
    for w, o, r in zip(want, got, _refs(tm, prompts, budgets)):
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, r)


def test_speculative_validation():
    jm, params, state, tm = _small(layers=1)
    td = _truncated(jm, params, state, tm)[3]
    with pytest.raises(ValueError, match="greedy-only"):
        ContinuousGenerator(tm, temperature=0.5, draft_model=td,
                            device="cpu", warmup=False)
    bad = TransformerLM(32, max_len=96, embed_dim=32, num_heads=2,
                        num_layers=1)
    with pytest.raises(ValueError, match="vocab"):
        ContinuousGenerator(tm, draft_model=bad, device="cpu", warmup=False)
    with pytest.raises(ValueError, match="paged=True"):
        ContinuousGenerator(tm, paged=False, draft_model=td, device="cpu",
                            warmup=False)
    with pytest.raises(ValueError, match="paged=True"):
        ContinuousGenerator(tm, paged=False, prefix_cache=True, device="cpu",
                            warmup=False)
    with pytest.raises(ValueError, match="paged_kernel=False"):
        ContinuousGenerator(tm, paged_kernel=False, draft_model=td,
                            device="cpu", warmup=False)
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousGenerator(tm, draft_model=td, spec_k=0, device="cpu",
                            warmup=False)
    with pytest.raises(ValueError, match="draft_quantize"):
        ContinuousGenerator(tm, draft_model=td, draft_quantize="w4",
                            device="cpu", warmup=False)


def test_speculative_with_a_w8_draft_matches_jax_and_generate():
    """``draft_quantize="w8"``: the truncated draft served from an int8
    copy (its projections and tied table packed) proposes; the output is
    still the target's greedy path, and the reference's."""
    jm, params, state, tm = _pair()
    jd, dparams, dstate, td = _truncated(jm, params, state, tm)
    prompts = _prompts(4, 11)
    budgets = [12, 7, 16, 9]
    kw = dict(num_slots=2, page_size=8, seq_buckets=[16], spec_k=3,
              draft_quantize="w8")
    want, jst = _run(JContinuousGenerator(
        jm, params, state, draft_model=jd, draft_params=dparams,
        draft_state=dstate, **kw), prompts, budgets)
    g = ContinuousGenerator(tm, draft_model=td, device="cpu", **kw)
    packed = sorted(p for p, v in _port_leaves(g._draft).items()
                    if isinstance(v, dict))
    assert len(packed) == 7 and "tok" in packed
    assert tq.packed_weight(td, "tok") is None
    got, st = _run(g, prompts, budgets)
    for w, o, r in zip(want, got, _refs(tm, prompts, budgets)):
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, r)
    assert st["spec"] == jst["spec"]


def test_failed_prefill_under_speculation_recovers():
    """A draft prefill that raises fails its request typed, rebuilds the
    pool and the draft's cache, and the next request is served right."""
    jm, params, state, tm = _small(layers=1)
    td = _truncated(jm, params, state, tm)[3]
    prompt = np.arange(1, 7, dtype=np.int32)
    with ContinuousGenerator(tm, draft_model=td, num_slots=2, page_size=8,
                             seq_buckets=[16], spec_k=3, device="cpu") as g:
        real = g._row_prefill
        calls = []

        def flaky(model, *a):
            if model is g._draft and not calls:
                calls.append(1)
                raise RuntimeError("injected draft prefill failure")
            return real(model, *a)

        g._row_prefill = flaky
        bad = g.submit(prompt, 8)
        with pytest.raises(RuntimeError, match="prefill failed"):
            bad.result(timeout=60)
        good = g.submit(prompt, 8).result(timeout=60)
        st = g.stats()
    np.testing.assert_array_equal(good, _refs(tm, [prompt], [8])[0])
    assert st["counters"]["serve.gen.failed"] == 1
    assert st["pages"]["free"] + st["prefix"]["entries"] == \
        st["pages"]["total"]
