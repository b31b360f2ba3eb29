"""The port's TransformerLM inference (``bigdl_tpu_torch.models.transformer``
and the layers under it) against the JAX package.

Small models (2 layers, embed 32, 4 heads; learned positions, and rope with
2 KV heads) at T 16, a multiple of 8, so that the JAX side's eval dispatch
reaches its Pallas kernels (K8 unpadded, K9 with a key-padding mask), run
in interpret mode.  Weights are the JAX model's, carried by
``load_jax_params``; inputs come from numpy seeds.  Log-probs agree to 1e-4
in float32, greedy generation token for token.  Sampling cannot match
JAX's key stream, so sampled outputs are held to their properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.transformer import Sample as JSample
from bigdl_tpu.dataset.transformer import SampleToBatch as JSampleToBatch
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.optim import Loss as JLoss
from bigdl_tpu.optim import LocalValidator as JLocalValidator
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.core.precision import mixed_forward
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.ops import attention as tattn
from bigdl_tpu_torch.optim import Loss, LocalValidator

torch.set_num_threads(1)

VOCAB, T, EMBED, HEADS, LAYERS = 50, 16, 32, 4, 2
CONFIGS = {"learned": dict(position="learned", num_kv_heads=None),
           "rope-gqa": dict(position="rope", num_kv_heads=2)}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_PALLAS_INTERPRET", "1")


def _pair(name, seed=0):
    cfg = CONFIGS[name]
    jm = JTransformerLM(VOCAB, max_len=T, embed_dim=EMBED, num_heads=HEADS,
                        num_layers=LAYERS, **cfg)
    params, state = jm.init(jax.random.PRNGKey(seed))
    tm = TransformerLM(VOCAB, max_len=T, embed_dim=EMBED, num_heads=HEADS,
                       num_layers=LAYERS, **cfg)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, state, tm.evaluate()


def _ids(shape, seed=0):
    return np.random.RandomState(seed).randint(1, VOCAB + 1, shape)


# -- layers -------------------------------------------------------------------

def test_layer_norm_matches_jax():
    x = np.random.RandomState(0).standard_normal((3, 5, 32)).astype(
        np.float32) * 3 + 1
    jl = jnn.LayerNorm(32)
    p = {"weight": jnp.asarray(np.linspace(0.5, 2, 32, dtype=np.float32)),
         "bias": jnp.asarray(np.linspace(-1, 1, 32, dtype=np.float32))}
    want, _ = jl.apply(p, (), jnp.asarray(x))
    tl = tnn.LayerNorm(32)
    load_jax_params(tl, jax.tree_util.tree_map(np.asarray, p))
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    assert tnn.LayerNorm(8).weight.tolist() == [1.0] * 8


def test_gelu_is_the_tanh_approximation_as_in_jax():
    x = np.linspace(-6, 6, 97).astype(np.float32)
    got = tnn.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    # the exact erf form differs by up to ~5e-4 here: the test can tell them
    # apart
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - got).max() > 1e-4


def test_multi_head_attention_params_and_gqa_sharing():
    m = tnn.MultiHeadAttention(32, 4, num_kv_heads=2)
    shapes = {k: tuple(v.shape) for k, v in m.named_parameters()}
    assert shapes == {"wq": (32, 32), "wk": (16, 32), "wv": (16, 32),
                      "wo": (32, 32), "bq": (32,), "bk": (16,), "bv": (16,),
                      "bo": (32,)}
    jm = jnn.MultiHeadAttention(32, 4, num_kv_heads=2, causal=True)
    params = jm.init_params(jax.random.PRNGKey(3))
    load_jax_params(m, jax.tree_util.tree_map(np.asarray, params))
    m.causal = True
    x = np.random.RandomState(1).standard_normal((2, 8, 32)).astype(
        np.float32)
    want, _ = jm.apply(params, (), jnp.asarray(x))
    got = m.evaluate()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_tree_round_trip(name):
    _, params, _, tm = _pair(name)
    ex = export_params(tm)
    want = jax.tree_util.tree_map(np.asarray, params)
    assert jax.tree_util.tree_structure(ex) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(ex),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    # the flat parameter vector in the JAX leaf order
    w, _ = tm.get_parameters()
    np.testing.assert_array_equal(w.numpy(), np.concatenate(
        [x.ravel() for x in jax.tree_util.tree_leaves(want)]))
    bad = jax.tree_util.tree_map(np.asarray, params)
    del bad["blocks"][1]["attn"]["wq"]
    with pytest.raises(ValueError, match="parameters"):
        load_jax_params(tm, bad)
    with pytest.raises(ValueError, match="children"):
        load_jax_params(tm, dict(want, blocks=want["blocks"][:1]))


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_eval_log_probs_match_jax(interpret, name, padded):
    jm, params, state, tm = _pair(name)
    ids = _ids((2, T))
    kpm = None
    if padded:
        kpm = np.ones((2, T), bool)
        kpm[1, 9:] = False
    want, _ = jm.apply(params, state, jnp.asarray(ids), training=False,
                       key_padding_mask=None if kpm is None
                       else jnp.asarray(kpm))
    with torch.inference_mode():
        got = tm(torch.from_numpy(ids),
                 key_padding_mask=None if kpm is None
                 else torch.from_numpy(kpm))
    assert got.shape == (2, T, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_max_len_is_checked():
    _, _, _, tm = _pair("learned")
    with pytest.raises(ValueError, match="max_len"):
        tm(torch.from_numpy(_ids((1, T + 1))))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_prefill_and_steps_match_jax(name):
    jm, params, state, tm = _pair(name)
    ids = _ids((2, T), 1)
    jcache = jm.init_cache(2, T)
    want, jcache = jm.decode(params, state, jnp.asarray(ids[:, :8]), jcache,
                             0)
    cache = tm.init_cache(2, T)
    with torch.inference_mode():
        got = tm.decode(torch.from_numpy(ids[:, :8]), cache, 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        for i in range(8, 12):
            want, jcache = jm.decode(params, state,
                                     jnp.asarray(ids[:, i:i + 1]), jcache, i)
            got = tm.decode(torch.from_numpy(ids[:, i:i + 1]), cache, i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
    for c, jc in zip(cache, jcache):   # the cache written in place
        np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_generate_matches_jax(name):
    jm, params, state, tm = _pair(name)
    prompt = _ids((3, 5), 2)
    want = np.asarray(jm.generate(params, state, jnp.asarray(prompt), 9))
    got = tm.generate(torch.from_numpy(prompt), 9, device="cpu")
    assert got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_rejects_what_the_reference_rejects():
    _, _, _, tm = _pair("learned")
    prompt = torch.from_numpy(_ids((2, 5)))
    g = torch.Generator().manual_seed(0)
    cases = [(dict(max_new=12), "cache length"),
             (dict(max_new=12, max_len=32), "learned-position"),
             (dict(max_new=0), "max_new"),
             (dict(max_new=3, top_p=0.0), "top_p"),
             (dict(max_new=3, top_p=1.5), "top_p"),
             (dict(max_new=3, top_k=-1), "top_k"),
             (dict(max_new=3, temperature=1.0), "generator")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            tm.generate(prompt, generator=None if "temperature" in kw else g,
                        device="cpu", **kw)


def test_generate_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    _, _, _, tm = _pair("learned")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.generate(torch.from_numpy(_ids((2, 5))), 3)
    assert tm.tok.device.type == "cpu"


def test_sampling_properties():
    _, _, _, tm = _pair("rope-gqa")
    prompt = torch.from_numpy(_ids((4, 5), 3))
    greedy = tm.generate(prompt, 8, device="cpu")

    def sample(seed, **kw):
        return tm.generate(prompt, 8, temperature=0.8,
                           generator=torch.Generator().manual_seed(seed),
                           device="cpu", **kw)

    a = sample(7, top_k=5, top_p=0.9)
    assert a.shape == (4, 8) and bool(((a >= 1) & (a <= VOCAB)).all())
    assert torch.equal(a, sample(7, top_k=5, top_p=0.9))
    assert torch.equal(sample(1, top_k=1), greedy)
    assert torch.equal(sample(2, top_p=1e-6), greedy)
    # unrestricted sampling at a high temperature leaves the greedy path
    hot = tm.generate(prompt, 8, temperature=5.0,
                      generator=torch.Generator().manual_seed(4), device="cpu")
    assert not torch.equal(hot, greedy)


# -- scoring through the validator --------------------------------------------

def test_validator_loss_matches_jax(interpret):
    jm, params, state, tm = _pair("learned")
    jm.params, jm.state = params, state
    seqs = _ids((6, T + 1), 5)
    jval = (JDataSet.array([JSample(s[:-1], s[1:]) for s in seqs])
            >> JSampleToBatch(4))
    tval = (DataSet.array([Sample(s[:-1], s[1:]) for s in seqs])
            >> SampleToBatch(4))
    (want,) = JLocalValidator(jm, jval).test(
        [JLoss(jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                            size_average=True))])
    (got,) = LocalValidator(tm, tval, device="cpu").test(
        [Loss(tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion(),
                                           size_average=True))])
    assert got.count == want.count == 6
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-5)


@pytest.mark.parametrize("size_average", [False, True])
def test_time_distributed_criterion_matches_jax(size_average):
    rs = np.random.RandomState(6)
    x = rs.standard_normal((3, 5, 7)).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(x), axis=-1))
    tgt = rs.randint(1, 8, (3, 5))
    w = rs.uniform(0.5, 2, 7).astype(np.float32)
    for jc, tc in ((jnn.ClassNLLCriterion(), tnn.ClassNLLCriterion()),
                   (jnn.ClassNLLCriterion(w), tnn.ClassNLLCriterion(w))):
        want = jnn.TimeDistributedCriterion(jc, size_average).apply(
            jnp.asarray(lp), jnp.asarray(tgt))
        got = tnn.TimeDistributedCriterion(tc, size_average)(
            torch.from_numpy(lp), tgt)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- mixed precision with token ids -------------------------------------------

class _Echo(torch.nn.Module):
    """Returns its input as float32, and carries one floating parameter."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(1))

    def forward(self, x):
        return x.float() * self.w


def test_mixed_forward_passes_integer_inputs_through():
    ids = torch.tensor([[1, 255, 257, 300, 513, 31999, 32000]])
    got = mixed_forward(_Echo(), ids)
    assert got.dtype == torch.float32
    assert torch.equal(got, ids.float())          # bf16 would give 256, ...
    x = torch.tensor([257.0, 1.0 + 2 ** -10])
    assert mixed_forward(_Echo(), x).tolist() == [256.0, 1.0]
    # the LM under mixed precision reads the tokens it was given
    big = TransformerLM(1000, max_len=T, embed_dim=EMBED, num_heads=HEADS,
                        num_layers=1).reset(0).evaluate()
    ids = torch.from_numpy(np.random.RandomState(8).randint(257, 1001,
                                                            (2, T)))
    with torch.inference_mode():
        want = big.to(torch.bfloat16)(ids).float()
        big.float()
        got = mixed_forward(big, ids)
    torch.testing.assert_close(got, want)


def test_the_lm_attention_goes_through_the_dispatcher(monkeypatch):
    """Eval forwards call fused_attention with needs_backward=False, once
    per layer, with the mask passed on."""
    _, _, _, tm = _pair("learned")
    calls = []
    real = tattn.fused_attention

    def spy(*a, **kw):
        calls.append((kw["needs_backward"],
                      kw["key_padding_mask"] is not None))
        return real(*a, **kw)

    monkeypatch.setattr("bigdl_tpu_torch.nn.attention.fused_attention", spy)
    ids = torch.from_numpy(_ids((2, T)))
    with torch.inference_mode():
        tm(ids)
        tm(ids, key_padding_mask=torch.ones(2, T, dtype=torch.bool))
    assert calls == [(False, False)] * LAYERS + [(False, True)] * LAYERS
