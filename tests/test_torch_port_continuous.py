"""The port's continuous serving (``bigdl_tpu_torch.serving.
ContinuousGenerator``, the paging bookkeeping and the slot and page decode
paths under it) against the JAX package on the CPU.

Small models (vocab 64, embed 32, 2 layers; learned positions with 4 heads,
and rope with GQA 4/2) carry the JAX model's weights through
``load_jax_params``; prompts come from numpy seeds.  Decode log-probs agree
with JAX's to 1e-5 in float32, with an f32 and a bf16 cache (the cache
values round alike on both sides); greedy tokens agree exactly, with the
JAX ``ContinuousGenerator`` and with the port's own ``generate``.  The
paging and scheduler behaviour tests are ports of ``tests/test_paging.py``
and ``tests/test_scheduler.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.serving.scheduler.continuous import \
    ContinuousGenerator as JContinuousGenerator
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import (ContinuousGenerator, DrainingError,
                                     InvalidRequestError, PageAllocator,
                                     PrefixCache, SlotCapacityError)
from bigdl_tpu_torch.serving.scheduler import SlotManager

torch.set_num_threads(1)

VOCAB, EMBED = 64, 32
CONFIGS = {"learned": dict(position="learned", num_heads=4),
           "rope-gqa": dict(position="rope", num_heads=4, num_kv_heads=2)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(name="learned", max_len=64, layers=2, seed=0):
    cfg = CONFIGS[name]
    jm = JTransformerLM(VOCAB, max_len=max_len, embed_dim=EMBED,
                        num_layers=layers, **cfg)
    params, state = jm.init(jax.random.PRNGKey(seed))
    tm = TransformerLM(VOCAB, max_len=max_len, embed_dim=EMBED,
                       num_layers=layers, **cfg)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, state, tm.evaluate()


def _prompts(n, seed, lo=3, hi=14):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, VOCAB + 1, size=rs.randint(lo, hi)).astype(
        np.int32) for _ in range(n)]


def _refs(tm, prompts, budgets):
    return [tm.generate(torch.from_numpy(p[None]), n, device="cpu")[0]
            .numpy() for p, n in zip(prompts, budgets)]


def _gen(tm, **kw):
    kw.setdefault("device", "cpu")
    return ContinuousGenerator(tm, **kw)


# -- decode_slots / decode_pages against JAX ------------------------------------

@pytest.mark.parametrize("cache", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_slots_matches_jax(name, cache):
    jm, params, state, tm = _pair(name, max_len=32)
    jdt, tdt = DTYPES[cache]
    ids = np.random.RandomState(1).randint(1, VOCAB + 1, (3, 8))
    jcache = jm.init_cache(3, 32, jdt)
    tcache = tm.init_cache(3, 32, tdt)
    # a prefill of 6 at depth 0, then steps with rows at their own depths,
    # one of them inactive
    calls = [(ids[:, :6], [0, 0, 0], [True, True, True]),
             (ids[:, 6:7], [6, 6, 6], [True, False, True]),
             (ids[:, 7:8], [7, 6, 7], [True, True, True])]
    with torch.inference_mode():
        for tok, pos, act in calls:
            want, jcache = jm.decode_slots(
                params, state, jnp.asarray(tok), jcache,
                jnp.asarray(pos, jnp.int32), jnp.asarray(act))
            got = tm.decode_slots(torch.from_numpy(tok), tcache,
                                  torch.tensor(pos), torch.tensor(act))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5)
    for c, jc in zip(tcache, jcache):
        np.testing.assert_allclose(c["v"].float().numpy(),
                                   np.asarray(jc["v"], np.float32),
                                   rtol=0, atol=1e-5)


def _table(rows, lp, trash, seed, per_row):
    """A page table: each row's pages drawn from a shuffled pool, trash
    beyond them."""
    perm = np.random.RandomState(seed).permutation(trash)
    pages = np.full((rows, lp), trash, np.int32)
    for r in range(rows):
        pages[r, :per_row[r]] = perm[:per_row[r]]
        perm = perm[per_row[r]:]
    return pages


@pytest.mark.parametrize("cache", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_pages_matches_jax(name, cache):
    jm, params, state, tm = _pair(name, max_len=32)
    jdt, tdt = DTYPES[cache]
    ids = np.random.RandomState(2).randint(1, VOCAB + 1, (3, 9))
    npages, ps = 14, 4
    pages = _table(3, 8, npages, 3, [3, 2, 4])
    jcache = jm.init_paged_cache(npages, ps, jdt)
    tcache = tm.init_paged_cache(npages, ps, tdt)
    # row 1's second write runs past its 2 pages: it lands on the trash page
    calls = [(ids[:, :7], [0, 0, 0], [True, True, True]),
             (ids[:, 7:8], [7, 7, 7], [True, True, False]),
             (ids[:, 8:9], [8, 8, 7], [True, True, True])]
    with torch.inference_mode():
        for tok, pos, act in calls:
            want, jcache = jm.decode_pages(
                params, state, jnp.asarray(tok), jcache, jnp.asarray(pages),
                jnp.asarray(pos, jnp.int32), jnp.asarray(act))
            got = tm.decode_pages(torch.from_numpy(tok), tcache,
                                  torch.from_numpy(pages), torch.tensor(pos),
                                  torch.tensor(act))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5)
    for c, jc in zip(tcache, jcache):       # the pool, trash page aside
        np.testing.assert_allclose(c["k"][:npages].float().numpy(),
                                   np.asarray(jc["k"][:npages], np.float32),
                                   rtol=0, atol=1e-5)


def test_decode_pages_matches_decode_slots():
    """Port of ``tests/test_paging.py::test_decode_pages_matches_decode_
    slots``: the same tokens through both paths agree, an inactive row's
    pages stay untouched, and positions past the table write only the
    trash page."""
    _, _, _, tm = _pair("learned", max_len=32, layers=1)
    rs = np.random.RandomState(10)
    b, tp, ps = 3, 7, 4
    prompt = torch.from_numpy(rs.randint(1, VOCAB + 1, size=(b, tp)))
    with torch.inference_mode():
        lp_ref = tm.decode(prompt, tm.init_cache(b, 32), 0)
        pool = tm.init_paged_cache(b * 8, ps)
        pages = torch.arange(b * 8, dtype=torch.int32).reshape(b, 8)
        lp_pg = tm.decode_pages(prompt, pool, pages, torch.zeros(b),
                                torch.ones(b, dtype=torch.bool))
        torch.testing.assert_close(lp_pg, lp_ref, rtol=1e-5, atol=1e-5)
        assert torch.equal(lp_pg.argmax(-1), lp_ref.argmax(-1))
        before = pool[0]["k"].clone()
        tm.decode_pages(prompt[:, :1], pool, pages,
                        torch.full((b,), tp),
                        torch.tensor([True, False, True]))
        after = pool[0]["k"]
        assert torch.equal(before[8:16], after[8:16])
        assert not torch.equal(before[0:8], after[0:8])
        short = torch.full((b, 8), b * 8, dtype=torch.int32)
        short[:, 0] = pages[:, 0]
        before = pool[0]["k"][:b * 8].clone()
        tm.decode_pages(prompt[:, :1], pool, short, torch.full((b,), 30),
                        torch.ones(b, dtype=torch.bool))
        assert torch.equal(before, pool[0]["k"][:b * 8])


# -- the generator against JAX's and generate ----------------------------------

MODES = {"paged-prefix": dict(), "paged-no-prefix": dict(prefix_cache=False),
         "paged-kernel-path": dict(paged_kernel=True),
         "rows": dict(paged=False)}


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_tokens_match_jax_and_generate(mode):
    """Fewer slots than requests, mixed prompt lengths and budgets, half of
    the prompts sharing a head, two seq rungs and page size 4: admits and
    evicts interleave, and every output equals the JAX generator's and
    the port's own generate()."""
    jm, params, state, tm = _pair("rope-gqa")
    rs = np.random.RandomState(1)
    head = rs.randint(1, VOCAB + 1, size=12).astype(np.int32)
    prompts = _prompts(7, 2)
    prompts[1::2] = [np.concatenate([head, p[:4]]) for p in prompts[1::2]]
    budgets = [int(rs.randint(1, 12)) for _ in range(7)]
    kw = dict(num_slots=3, max_len=64, page_size=4, seq_buckets=[8, 16],
              steps_per_sync=3)
    jkw = {k: v for k, v in MODES[mode].items() if k != "paged_kernel"}
    with JContinuousGenerator(jm, params, state, **kw, **jkw) as g:
        want = [f.result(timeout=120) for f in
                [g.submit(p, n) for p, n in zip(prompts, budgets)]]
    with _gen(tm, **kw, **MODES[mode]) as g:
        got = [f.result(timeout=120) for f in
               [g.submit(p, n) for p, n in zip(prompts, budgets)]]
        st = g.stats()
    for w, o, r in zip(want, got, _refs(tm, prompts, budgets)):
        np.testing.assert_array_equal(o, w)
        np.testing.assert_array_equal(o, r)
    assert st["completed"] == 7 and st["paged"] == (mode != "rows")
    if mode == "paged-prefix":
        assert st["prefix"]["hit_pages"] > 0
        assert 0 < st["pages"]["mean_token_occupancy"] <= 1
    assert st["paged_kernel"] == (mode == "paged-kernel-path")


def test_eos_ends_a_request_where_generate_first_emits_it():
    _, _, _, tm = _pair("learned")
    prompts = _prompts(4, 9)
    refs = _refs(tm, prompts, [12] * 4)
    eos = int(refs[0][3])                # a token request 0 emits
    with _gen(tm, num_slots=2, seq_buckets=[16], steps_per_sync=3,
              eos_id=eos) as g:
        outs = [f.result(timeout=60) for f in [g.submit(p, 12)
                                               for p in prompts]]
    for r, o in zip(refs, outs):
        hit = np.flatnonzero(r == eos)
        np.testing.assert_array_equal(o, r[:hit[0] + 1] if hit.size else r)
    assert len(outs[0]) <= 4


def test_bf16_model_serves_with_the_default_f32_cache():
    """The mixed path: a bf16 model with the reference's default f32
    cache gives generate()'s tokens at the same dtypes."""
    _, _, _, tm = _pair("learned")
    tm = tm.to("cpu", torch.bfloat16)
    prompts = _prompts(3, 5)
    refs = [tm.generate(torch.from_numpy(p[None]), 6, device="cpu",
                        cache_dtype=torch.float32)[0].numpy()
            for p in prompts]
    with _gen(tm, num_slots=2, page_size=4, seq_buckets=[16]) as g:
        outs = [f.result(timeout=60) for f in [g.submit(p, 6)
                                               for p in prompts]]
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(o, r)


def test_sampling_draws_from_the_generator():
    _, _, _, tm = _pair("learned")
    prompts = _prompts(3, 6)
    outs = []
    for _ in range(2):
        with _gen(tm, num_slots=2, seq_buckets=[16], temperature=1.0,
                  generator=torch.Generator().manual_seed(3)) as g:
            outs.append([f.result(timeout=60)
                         for f in [g.submit(p, 8) for p in prompts]])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
        assert a.shape == (8,) and a.min() >= 1 and a.max() <= VOCAB
    with pytest.raises(ValueError, match="generator"):
        _gen(tm, temperature=1.0)


def test_entry_point_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    _, _, _, tm = _pair("learned")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousGenerator(tm)
    assert tm.tok.device.type == "cpu"


# -- paging units (ports of tests/test_paging.py) --------------------------------

def test_page_allocator_unit():
    a = PageAllocator(4, page_size=8)
    assert a.trash == 4 and a.capacity_tokens == 32
    assert a.pages_for(1) == 1 and a.pages_for(8) == 1
    assert a.pages_for(9) == 2 and a.pages_for(0) == 1
    p1 = a.alloc(3)
    assert len(p1) == 3 and a.free_count == 1 and a.used_count == 3
    assert a.alloc(2) is None            # all-or-nothing
    assert a.free_count == 1
    a.free(p1[:1])
    assert a.free_count == 2
    with pytest.raises(ValueError, match="double free"):
        a.free(p1[:1])
    with pytest.raises(ValueError, match="out of range"):
        a.free([4])                      # the trash page is not freeable
    with pytest.raises(ValueError):
        PageAllocator(0, 8)
    with pytest.raises(ValueError):
        PageAllocator(4, 0)


def test_free_list_reuse_never_aliases_live_slot():
    a = PageAllocator(6, page_size=4)
    slot_a = a.alloc(3)
    slot_b = a.alloc(3)
    assert a.alloc(1) is None
    a.free(slot_a)
    slot_c = a.alloc(3)
    assert set(slot_c) == set(slot_a)
    assert not set(slot_c) & set(slot_b)
    a.free(slot_b)
    a.free(slot_c)
    assert a.free_count == 6


def test_slot_manager_pool_tokens_shed():
    sm = SlotManager(2, max_len=64, max_prompt=32, pool_tokens=24)
    sm.check(7, 10)
    with pytest.raises(SlotCapacityError, match="page pool"):
        sm.check(7, 30)
    with pytest.raises(SlotCapacityError, match="overrun"):
        sm.check(40, 30)


def test_prefix_cache_unit():
    a = PageAllocator(8, page_size=4)
    c = PrefixCache(page_size=4)
    prompt = np.arange(1, 11, dtype=np.int32)
    keys = c.chain_keys(prompt)
    assert len(keys) == 2
    other = prompt.copy()
    other[5] = 63
    keys2 = c.chain_keys(other)
    assert keys2[0] == keys[0] and keys2[1] != keys[1]
    assert keys == PrefixCache(4).chain_keys(prompt.astype(np.int64))
    assert c.lookup(keys) == (0, [])
    pg = a.alloc(2)
    c.insert(keys, pg, 0)
    c.acquire(keys)
    assert c.lookup(keys) == (2, pg)
    assert c.stats()["hit_rate"] == 0.5
    assert c.evict_for(2, a) == 0        # referenced entries never evict
    c.release(keys)
    with pytest.raises(ValueError, match="underflow"):
        c.release(keys)
    free0 = a.free_count
    assert c.evict_for(1, a) == 1        # leaf first
    assert a.free_count == free0 + 1
    assert c.lookup(keys)[0] == 1
    assert c.evict_for(8, a) == 1 and len(c) == 0
    with pytest.raises(KeyError):
        c.acquire(keys)
    with pytest.raises(ValueError, match="raced"):
        c.insert(keys, pg, 0) or c.insert(keys, pg, 0)


# -- paging behaviour -----------------------------------------------------------

def test_prefix_hit_equal_and_cow_leaves_shared_pages_identical():
    _, _, _, tm = _pair("learned", max_len=96)
    rs = np.random.RandomState(3)
    head = rs.randint(1, VOCAB + 1, size=40).astype(np.int32)
    prompts = [np.concatenate([head, rs.randint(1, VOCAB + 1, size=6)
                               .astype(np.int32)]) for _ in range(4)]
    refs = _refs(tm, prompts, [8] * 4)
    g = _gen(tm, num_slots=1, page_size=8, seq_buckets=[16, 48],
             steps_per_sync=2)
    try:
        np.testing.assert_array_equal(g.submit(prompts[0], 8).result(60),
                                      refs[0])
        st = g.stats()["prefix"]
        assert st["entries"] == 5 and st["inserted_pages"] == 5
        assert st["hit_pages"] == 0
        shared = sorted(e.page for e in g._prefix._entries.values())
        before = [c["k"][shared].clone() for c in g._cache]
        outs = [g.submit(p, 8).result(60) for p in prompts[1:]]
        for r, o in zip(refs[1:], outs):
            np.testing.assert_array_equal(o, r)
        st = g.stats()["prefix"]
        assert st["hit_pages"] == 15 and st["hit_rate"] == 15 / 20
        for b, c in zip(before, g._cache):
            assert torch.equal(b, c["k"][shared])
    finally:
        assert g.drain(timeout=30)


def test_prefix_pages_released_only_when_last_reader_evicts():
    _, _, _, tm = _pair("learned", max_len=96)
    rs = np.random.RandomState(4)
    prompt = rs.randint(1, VOCAB + 1, size=28).astype(np.int32)
    g = _gen(tm, num_slots=2, page_size=8, seq_buckets=[8, 32],
             steps_per_sync=2, warmup=False)
    try:
        g.submit(prompt, 4).result(timeout=60)
        pre, alloc = g._prefix, g._alloc
        assert pre.held_pages == 3
        held_free = alloc.free_count
        assert all(e.refs == 0 for e in pre._entries.values())
        keys = pre.chain_keys(prompt)[:3]
        pre.acquire(keys)
        assert pre.evict_for(3, alloc) == 0          # pinned
        pre.release(keys)
        assert pre.evict_for(3, alloc) == 3
        assert alloc.free_count == held_free + 3
    finally:
        assert g.drain(timeout=30)


def test_page_exhaustion_sheds_typed_neighbors_intact():
    _, _, _, tm = _pair("learned")
    prompts = _prompts(3, 5, 6, 7)
    refs = _refs(tm, prompts, [10] * 3)
    with _gen(tm, num_slots=3, page_size=4, num_pages=12,
              seq_buckets=[8], steps_per_sync=2) as g:
        futs = [g.submit(p, 10) for p in prompts]
        with pytest.raises(SlotCapacityError, match="page pool"):
            g.submit(np.ones(8, np.int32), 50)
        assert g.stats()["counters"]["serve.shed.over_capacity"] == 1
        outs = [f.result(timeout=60) for f in futs]
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(o, r)


def test_token_scarce_pool_serves_all_admitted_via_holdback():
    _, _, _, tm = _pair("learned", max_len=48, layers=1)
    rs = np.random.RandomState(6)
    prompts = _prompts(6, 6, 3, 8)
    budgets = [int(rs.randint(2, 10)) for _ in range(6)]
    refs = _refs(tm, prompts, budgets)
    with _gen(tm, num_slots=2, max_len=48, page_size=4, num_pages=6,
              seq_buckets=[8], steps_per_sync=2, queue_capacity=64) as g:
        outs = [f.result(timeout=120) for f in
                [g.submit(p, n) for p, n in zip(prompts, budgets)]]
        st = g.stats()     # every private page back; cached heads stay
        assert st["pages"]["free"] + st["prefix"]["entries"] == 6
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(o, r)


def test_row_slot_mode_still_serves():
    _, _, _, tm = _pair("learned", layers=1)
    prompts = _prompts(4, 12, 6, 7)
    refs = _refs(tm, prompts, [6] * 4)
    with _gen(tm, num_slots=2, paged=False, seq_buckets=[8],
              steps_per_sync=2) as g:
        outs = [f.result(timeout=60) for f in [g.submit(p, 6)
                                               for p in prompts]]
        assert g.stats()["paged"] is False
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(o, r)
    with pytest.raises(ValueError, match="paged=True"):
        _gen(tm, paged=False, prefix_cache=True, warmup=False)
    with pytest.raises(ValueError, match="paged=True"):
        _gen(tm, paged=False, paged_kernel=True, warmup=False)


# -- scheduler (ports of tests/test_scheduler.py) --------------------------------

def test_over_capacity_admit_sheds_typed_not_corrupts():
    _, _, _, tm = _pair("learned", max_len=32)
    prompts = _prompts(3, 3, 6, 7)
    refs = _refs(tm, prompts, [20] * 3)
    with _gen(tm, num_slots=3, seq_buckets=[8], steps_per_sync=2) as g:
        futs = [g.submit(p, 20) for p in prompts]
        with pytest.raises(SlotCapacityError, match="overrun"):
            g.submit(np.ones(8, np.int32), 30)
        with pytest.raises(SlotCapacityError, match="prefill bucket"):
            g.submit(np.ones(12, np.int32), 4)
        outs = [f.result(timeout=60) for f in futs]
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(o, r)


def test_slot_manager_unit():
    sm = SlotManager(2, max_len=32, max_prompt=16)
    with pytest.raises(SlotCapacityError):
        sm.check(20, 13)
    with pytest.raises(SlotCapacityError):
        sm.check(17, 1)
    sm.check(16, 16)
    a, b = sm.alloc(), sm.alloc()
    assert {a, b} == {0, 1} and sm.alloc() is None
    assert sm.free_count == 0 and sm.active_count == 2
    sm.release(a)
    assert sm.alloc() == a
    with pytest.raises(ValueError):
        SlotManager(0, 32, 16)


def test_continuous_admission_sheds():
    _, _, _, tm = _pair("learned")
    g = _gen(tm, num_slots=1, seq_buckets=[8], queue_capacity=2)
    try:
        with pytest.raises(InvalidRequestError):
            g.submit(np.zeros(0, np.int32), 4)
        with pytest.raises(InvalidRequestError):
            g.submit(np.ones(4, np.int32), 0)
        with pytest.raises(InvalidRequestError, match="ids"):
            g.submit(np.array([1, VOCAB + 1]), 2)
        with pytest.raises(SlotCapacityError):
            g.submit(np.ones(4, np.int32), 80)
        c = g.stats()["counters"]
        assert c["serve.shed.invalid"] == 3
        assert c["serve.shed.over_capacity"] == 1
    finally:
        assert g.drain(timeout=30)
    with pytest.raises(DrainingError):
        g.submit(np.ones(4, np.int32), 2)
