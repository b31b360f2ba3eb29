"""The port's multi-turn sessions, host-RAM KV parking and device-memory
budgeter (``bigdl_tpu_torch.serving``: ``ContinuousGenerator(session=,
budgeter=)``, ``park``, ``close_session``, ``MemoryBudgeter``,
``HostOffloadTier``, ``mem_drill``) against the JAX package on the CPU.

Small models (vocab 64, embed 32, 2 layers; learned positions with 4
heads, and rope with GQA 4/2) carry the JAX model's weights through
``load_jax_params``; prompts come from numpy seeds.  Greedy tokens are
held exactly: against the port's and JAX's ``generate`` over the whole
history, against a run that never parks, and against the JAX
``ContinuousGenerator`` running the same script, whose ``session_info`` and
budgeter ``snapshot()`` the port's equal at every turn.  The port on the
CPU runs K12's plain version (``paged_kernel=True``) or the hoisted chunk
(its CPU default).  The budgeter and tier tests are ports of
``tests/test_membudget.py``.
"""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.serving.scheduler.continuous import \
    ContinuousGenerator as JContinuousGenerator
from bigdl_tpu.serving.scheduler.membudget import \
    MemoryBudgeter as JMemoryBudgeter
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import (ContinuousGenerator, HostOffloadTier,
                                     InvalidRequestError, MemoryBudgetError,
                                     MemoryBudgeter)
from bigdl_tpu_torch.serving.scheduler import continuous, mem_drill
from bigdl_tpu_torch.serving.scheduler.membudget import CHARGE_CLASSES

torch.set_num_threads(1)

VOCAB, EMBED = 64, 32
CONFIGS = {"learned": dict(position="learned", num_heads=4),
           "rope-gqa": dict(position="rope", num_heads=4, num_kv_heads=2)}
# the read paths on the CPU: the hoisted chunk (the default there) and
# decode_pages through K12's plain version
PATHS = {"hoisted": dict(), "kernel-path": dict(paged_kernel=True)}


def _pair(name="learned", max_len=64, seed=0):
    cfg = CONFIGS[name]
    jm = JTransformerLM(VOCAB, max_len=max_len, embed_dim=EMBED,
                        num_layers=2, **cfg)
    params, state = jm.init(jax.random.PRNGKey(seed))
    tm = TransformerLM(VOCAB, max_len=max_len, embed_dim=EMBED, num_layers=2,
                       **cfg)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, state, tm.evaluate()


def _gen(tm, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("seq_buckets", [16])
    kw.setdefault("steps_per_sync", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("device", "cpu")
    return ContinuousGenerator(tm, **kw)


def _ref(tm, prompt, max_new):
    return tm.generate(torch.from_numpy(np.asarray(prompt)[None]), max_new,
                       device="cpu")[0].numpy()


def _jref(jm, params, state, prompt, max_new):
    return np.asarray(jm.generate(params, state,
                                  np.asarray(prompt, np.int32)[None],
                                  max_new=max_new, temperature=0.0))[0]


# -- the budgeter and the tier alone (ports of tests/test_membudget.py) -------

def test_budgeter_accounting_exact():
    b = MemoryBudgeter()
    b.set_budget("a", 1000)
    b.charge("a", "kv_pages", 600)
    b.charge("a", "prefix_pages", 100)
    assert b.charged("a") == 700 and b.charged("a", "kv_pages") == 600
    assert b.headroom("a") == 300
    assert b.occupancy("a") == pytest.approx(0.7)
    # host_offload is not device bytes: parking frees headroom
    b.transfer("a", "kv_pages", "host_offload", 400)
    assert b.charged("a", "kv_pages") == 200
    assert b.charged("a", "host_offload") == 400
    assert b.headroom("a") == 700
    b.discharge("a", "prefix_pages", 100)
    with pytest.raises(ValueError, match="below zero"):
        b.discharge("a", "kv_pages", 300)
    with pytest.raises(ValueError, match="unknown charge class"):
        b.charge("a", "rope_tables", 1)
    assert b.budget("z") is None and b.headroom("z") is None
    assert b.occupancy("z") == 0.0
    b.admit("z", 10 ** 12, what="huge")
    snap = b.snapshot()
    assert set(snap["tenants"]["a"]["charged"]) == set(CHARGE_CLASSES)
    b.drop_tenant("a")
    assert "a" not in b.snapshot()["tenants"]


def test_budgeter_admit_reclaims_then_sheds_typed():
    b = MemoryBudgeter()
    b.set_budget("a", 100)
    b.charge("a", "rung_executables", 80)
    freed = {"n": 0}

    def reclaimer(tenant, need):
        got = min(need, b.charged("a", "rung_executables"))
        b.discharge("a", "rung_executables", got)
        freed["n"] += got
        return got

    b.register_reclaimer("rungs", reclaimer)
    b.admit("a", 60, what="req")           # reclaims 40, then fits
    assert freed["n"] == 40
    b.charge("a", "kv_pages", 60)
    with pytest.raises(MemoryBudgetError, match="can never fit"):
        b.require_possible("a", 101, what="monster")
    b.require_possible("a", 100, what="barely")
    with pytest.raises(MemoryBudgetError) as ei:
        b.admit("a", 100, what="req2")     # the ladder is dry at 60 held
    assert ei.value.reason == "byte_starved"
    snap = b.snapshot()
    assert snap["tenants"]["a"]["sheds"] == 2
    # the second admit reclaimed the last 40 rung bytes before shedding
    assert snap["reclaims"] == {"rungs": 2}
    assert snap["reclaimed_bytes"] == {"rungs": 80}


def test_host_offload_tier_bookkeeping():
    t = HostOffloadTier()
    t.park("s1", [{"k": torch.ones(2)}], 100)
    t.park("s2", [], 0)
    assert len(t) == 2 and "s1" in t
    with pytest.raises(ValueError, match="already parked"):
        t.park("s1", [], 1)
    payload = t.resume("s1")
    assert payload[0]["k"].shape == (2,)
    with pytest.raises(KeyError):
        t.resume("s1")
    assert t.drop("s2") == 0 and t.drop("nope") == 0
    st = t.stats()
    assert st["parks"] == 2 and st["resumes"] == 1
    assert st["parked_bytes"] == 0 and st["peak_parked_bytes"] == 100


# -- park and resume ---------------------------------------------------------

@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_park_resume_equal_to_never_parked(name, path):
    """An explicitly parked session's next turn (resumed on placement)
    equals ``generate`` over the same history, the port's and JAX's, and
    the same turns on a session that never parks."""
    jm, params, state, tm = _pair(name)
    t1 = np.arange(1, 9)
    t2 = np.array([11, 12, 13])
    outs = {}
    for park in (True, False):
        with _gen(tm, num_pages=32, **PATHS[path]) as g:
            out1 = g.submit(t1, 5, session="s").result(timeout=60)
            if park:
                assert g.park("s").result(timeout=30) is True
                info = g.session_info("s")
                assert info["state"] == "parked"
                assert info["private_pages"] == 0
                assert g.stats()["offload"]["parked_sessions"] == 1
            out2 = g.submit(t2, 5, session="s").result(timeout=60)
            assert g.session_info("s")["state"] == "resident"
            assert g.stats()["offload"]["resumes"] == int(park)
        outs[park] = (out1, out2)
    full = np.concatenate([t1, outs[True][0], t2])
    for got, want in zip(outs[True], (_ref(tm, t1, 5), _ref(tm, full, 5))):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(outs[True][0], _jref(jm, params, state,
                                                       t1, 5))
    np.testing.assert_array_equal(outs[True][1], _jref(jm, params, state,
                                                       full, 5))
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)


def test_park_pins_shared_prefix_pages_on_device():
    """Two sessions share a page-aligned prefix; parking one moves only its
    private pages: the shared pages stay pinned on the device and the
    other session decodes through them."""
    _, _, _, tm = _pair()
    shared = np.arange(1, 9)                          # 2 full pages
    with _gen(tm, num_pages=32) as g:
        oa = g.submit(shared, 4, session="a").result(timeout=60)
        ob = g.submit(shared, 4, session="b").result(timeout=60)
        np.testing.assert_array_equal(oa, ob)
        ia = g.session_info("a")
        assert ia["shared_pages"] >= 1
        assert g.park("a").result(timeout=30) is True
        pb = g.stats()["pages"]["page_bytes"]
        assert g.stats()["offload"]["parked_bytes"] == \
            ia["private_pages"] * pb
        ob2 = g.submit(np.array([20, 21]), 4, session="b").result(timeout=60)
        np.testing.assert_array_equal(
            ob2, _ref(tm, np.concatenate([shared, ob, [20, 21]]), 4))
        oa2 = g.submit(np.array([20, 21]), 4, session="a").result(timeout=60)
        np.testing.assert_array_equal(oa2, ob2)


def test_budget_accounting_exact_across_lifecycle():
    """Every page is charged and discharged exactly: mid-flight the kv and
    offload charges match the live page census, after close-all both are
    0 and only the prefix cache's pages stay charged."""
    _, _, _, tm = _pair()
    bud = MemoryBudgeter()
    with _gen(tm, num_pages=32, budgeter=bud, budget_tenant="t") as g:
        pb = g.stats()["pages"]["page_bytes"]
        for i in range(3):
            g.submit(np.arange(1, 9), 4, session=f"s{i}").result(timeout=60)
        assert g.park("s0").result(timeout=30) is True
        snap = bud.snapshot()["tenants"]["t"]["charged"]
        st = g.stats()
        live_priv = sum(g.session_info(f"s{i}")["private_pages"]
                        for i in range(3))
        assert snap["kv_pages"] == live_priv * pb
        assert snap["host_offload"] == st["offload"]["parked_bytes"]
        held = st["prefix"]["inserted_pages"] - st["prefix"]["evicted_pages"]
        assert snap["prefix_pages"] == held * pb
        assert st["budget"]["charged"] == snap
        for i in range(3):
            assert g.close_session(f"s{i}").result(timeout=30) is True
        assert g.close_session("s0").result(timeout=30) is False
        g.drain(timeout=30)
        snap = bud.snapshot()["tenants"]["t"]["charged"]
        assert snap["kv_pages"] == 0 and snap["host_offload"] == 0
    assert bud.snapshot()["device_bytes"] == \
        bud.snapshot()["tenants"]["t"]["charged"]["prefix_pages"]


def test_concurrent_park_vs_decode_race():
    """A park racing a live turn lands after the turn retires, or not at
    all: the scheduler thread owns the page table.  Either way the output
    equals generate() and the session survives."""
    _, _, _, tm = _pair()
    t1 = np.arange(1, 7)
    with _gen(tm, num_pages=32) as g:
        fut = g.submit(t1, 12, session="s")
        parks = [g.park("s") for _ in range(4)]
        out = fut.result(timeout=60)
        results = [p.result(timeout=30) for p in parks]
        assert all(r in (True, False) for r in results)
        info = g.session_info("s")
        assert info is not None and info["state"] in ("resident", "parked")
        if info["state"] != "parked":
            assert g.park("s").result(timeout=30) is True
        out2 = g.submit(np.array([9]), 4, session="s").result(timeout=60)
    np.testing.assert_array_equal(out, _ref(tm, t1, 12))
    np.testing.assert_array_equal(
        out2, _ref(tm, np.concatenate([t1, out, [9]]), 4))


def test_byte_starved_shed_typed_neighbors_intact():
    """A request whose worst-case KV bytes exceed the tenant's whole budget
    sheds MemoryBudgetError at submit, on both paths; the neighbours in
    flight land equal to generate() and the sheds are counted."""
    _, _, _, tm = _pair()
    bud = MemoryBudgeter()
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, VOCAB + 1, size=6) for _ in range(3)]
    with _gen(tm, num_pages=16, budgeter=bud, budget_tenant="t") as g:
        pb = g.stats()["pages"]["page_bytes"]
        bud.set_budget("t", 15 * pb)
        futs = [g.submit(p, 5) for p in prompts]
        flood = rs.randint(1, VOCAB + 1, size=10)
        with pytest.raises(MemoryBudgetError, match="can never fit") as ei:
            g.submit(flood, 64 - flood.size)       # 16 pages > the budget
        assert ei.value.reason == "byte_starved"
        with pytest.raises(MemoryBudgetError, match="can never fit"):
            g.submit(flood, 64 - flood.size, session="big")
        assert g.session_info("big") is None       # no latch left behind
        outs = [f.result(timeout=60) for f in futs]
        assert g.stats()["counters"]["serve.shed.byte_starved"] == 2
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, _ref(tm, p, 5))
    assert bud.snapshot()["tenants"]["t"]["sheds"] == 2


# -- the port against the JAX generator --------------------------------------

def _three_turns(g, submit_kw, sessions, turns, budgeter, tenant):
    """Each turn of each session submitted and awaited in order; returns
    the outputs and, after every turn, every session's info, the
    budgeter's snapshot and the offload census."""
    outs, infos, snaps, offload = [], [], [], []
    for turn in turns:
        for sid, prompt in zip(sessions, turn):
            outs.append(g.submit(prompt, **submit_kw,
                                 session=sid).result(timeout=120))
            infos.append([g.session_info(s) for s in sessions])
            snaps.append(budgeter.snapshot()["tenants"][tenant])
            offload.append(g.stats()["offload"])
    return outs, infos, snaps, offload


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_turn_sessions_match_jax(name, path):
    """Three sessions, three turns each, under a budget tight enough that
    placements park their neighbours: the tokens, each ``session_info``,
    the budgeter's snapshot and the parks and resumes equal the JAX
    generator's after every turn, and the tokens equal ``generate`` over
    the whole history."""
    jm, params, state, tm = _pair(name)
    rs = np.random.RandomState(7)
    head = rs.randint(1, VOCAB + 1, size=8)
    sessions = ["a", "b", "c"]
    turns = [[np.concatenate([head, rs.randint(1, VOCAB + 1, size=3)])
              for _ in sessions]]
    turns += [[rs.randint(1, VOCAB + 1, size=int(rs.randint(2, 7)))
               for _ in sessions] for _ in range(2)]
    kw = dict(num_slots=2, seq_buckets=[16], steps_per_sync=3, page_size=4,
              num_pages=24, budget_tenant="t")
    budget = 10

    def run(gen_cls, budgeter, *args, **extra):
        with gen_cls(*args, **kw, **extra, budgeter=budgeter) as g:
            pb = g.stats()["pages"]["page_bytes"]
            budgeter.set_budget("t", budget * pb)
            got = _three_turns(g, {"max_new": 5}, sessions, turns,
                               budgeter, "t")
            for s in sessions:
                assert g.close_session(s).result(timeout=30) is True
            return got, budgeter.snapshot()["tenants"]["t"]

    (want, wend) = run(JContinuousGenerator, JMemoryBudgeter(), jm, params,
                       state)
    (got, gend) = run(ContinuousGenerator, MemoryBudgeter(), tm,
                      device="cpu", **PATHS[path])
    for w, o in zip(want[0], got[0]):
        np.testing.assert_array_equal(o, w)
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert gend == wend
    assert got[3][-1]["parks"] > 0 and got[3][-1]["resumes"] > 0
    history = {s: [] for s in sessions}
    k = 0
    for turn in turns:
        for s, prompt in zip(sessions, turn):
            full = np.concatenate(history[s] + [prompt])
            np.testing.assert_array_equal(got[0][k], _ref(tm, full, 5))
            history[s] = [full, got[0][k]]
            k += 1


# -- recovery, kv_pos, refusals ----------------------------------------------

@pytest.mark.parametrize("which", ["fresh", "continuation", "resume"])
def test_failed_prefill_destroys_sessions_and_discharges(which,
                                                         monkeypatch):
    """A prefill that raises (a fresh request's, or a session's next
    turn's), or the write of a parked session's pages back into the pool,
    fails its request typed, closes every session (a parked one too),
    rebuilds the pool and leaves every budget class at 0 but
    ``prefix_pages``, which holds the prefix cache's pages (none are left);
    the next request is served right."""
    _, _, _, tm = _pair()
    bud = MemoryBudgeter()
    with _gen(tm, num_pages=32, budgeter=bud, budget_tenant="t") as g:
        pb = g.stats()["pages"]["page_bytes"]
        for i in range(3):
            g.submit(np.arange(1, 10), 4, session=f"s{i}").result(timeout=60)
        assert g.park("s1").result(timeout=30) is True
        real = (continuous.scatter_pages if which == "resume" else
                g._prefill_pages)
        calls = []

        def flaky(*a):
            if not calls:
                calls.append(1)
                raise RuntimeError("injected failure")
            return real(*a)

        if which == "resume":
            monkeypatch.setattr(continuous, "scatter_pages", flaky)
            bad = g.submit(np.array([5, 6]), 4, session="s1")
        else:
            g._prefill_pages = flaky
            bad = (g.submit(np.arange(3, 9), 4) if which == "fresh" else
                   g.submit(np.array([5, 6]), 4, session="s0"))
        with pytest.raises(RuntimeError, match="prefill failed"):
            bad.result(timeout=60)
        assert all(g.session_info(f"s{i}") is None for i in range(3))
        st = g.stats()
        snap = bud.snapshot()["tenants"]["t"]["charged"]
        assert {c: v for c, v in snap.items() if c != "prefix_pages"} == \
            {c: 0 for c in CHARGE_CLASSES if c != "prefix_pages"}
        assert snap["prefix_pages"] == st["prefix"]["entries"] * pb == 0
        assert st["offload"]["parked_sessions"] == 0
        assert st["sessions"]["open"] == 0
        assert st["pages"]["free"] == st["pages"]["total"]
        good = g.submit(np.arange(1, 10), 4, session="s0").result(timeout=60)
        assert g.session_info("s0")["state"] == "resident"
    np.testing.assert_array_equal(good, _ref(tm, np.arange(1, 10), 4))


@pytest.mark.parametrize("eos", [False, True])
def test_kv_pos_is_the_history_less_one_at_eviction(eos):
    """Chunks of 3 steps with finished rows masked inside them: a retired
    turn keeps ``kv_pos == len(history) - 1``, with and without
    ``eos_id``, and the next turn equals generate() over the history."""
    _, _, _, tm = _pair("rope-gqa")
    rs = np.random.RandomState(18)
    prompts = [rs.randint(1, VOCAB + 1, size=n) for n in (5, 9)]
    refs = [_ref(tm, p, 10) for p in prompts]
    # a token request 0 first emits mid-chunk (at index 2 or later)
    first = {int(t): i for i, t in reversed(list(enumerate(refs[0])))}
    eos_id = min((t for t, i in first.items() if i >= 2),
                 key=first.get) if eos else None
    with _gen(tm, num_pages=32, steps_per_sync=3, eos_id=eos_id) as g:
        outs = [f.result(timeout=60) for f in
                [g.submit(p, 10, session=f"s{i}")
                 for i, p in enumerate(prompts)]]
        infos = [g.session_info(f"s{i}") for i in range(2)]
        nxt = [g.submit(np.array([3, 4]), 6, session=f"s{i}").result(
            timeout=60) for i in range(2)]
    for p, o, r, info, n in zip(prompts, outs, refs, infos, nxt):
        if eos:
            hit = np.flatnonzero(r == eos_id)
            r = r[:hit[0] + 1] if hit.size else r
        np.testing.assert_array_equal(o, r)
        assert info["tokens"] == p.size + o.size
        assert info["kv_pos"] == info["tokens"] - 1
        full = np.concatenate([p, o, [3, 4]])
        want = _ref(tm, full, 6)
        if eos:
            hit = np.flatnonzero(want == eos_id)
            want = want[:hit[0] + 1] if hit.size else want
        np.testing.assert_array_equal(n, want)
    if eos:
        assert 3 <= outs[0].size < 10


def test_sessions_refused_under_row_slots_and_a_draft():
    _, _, _, tm = _pair()
    with _gen(tm, paged=False) as g:
        with pytest.raises(InvalidRequestError, match="paged=True"):
            g.submit(np.arange(1, 5), 3, session="s")
        assert g.stats()["counters"]["serve.shed.invalid"] == 1
    with _gen(tm, num_pages=32, draft_model=tm, spec_k=2) as g:
        with pytest.raises(InvalidRequestError, match="speculative"):
            g.submit(np.arange(1, 5), 3, session="s")
        assert g.session_info("s") is None
        np.testing.assert_array_equal(
            g.submit(np.arange(1, 5), 3).result(timeout=60),
            _ref(tm, np.arange(1, 5), 3))


def test_one_turn_at_a_time_per_session():
    _, _, _, tm = _pair()
    with _gen(tm, num_pages=32) as g:
        fut = g.submit(np.arange(1, 5), 8, session="s")
        with pytest.raises(InvalidRequestError, match="outstanding turn"):
            g.submit(np.arange(1, 3), 2, session="s")
        fut.result(timeout=60)
        g.submit(np.arange(1, 3), 2, session="s").result(timeout=60)
        assert g.session_info("s")["tokens"] == 4 + 8 + 2 + 2


def test_mem_drill_smoke_on_the_cpu(capsys):
    assert mem_drill.main(["--smoke", "--device", "cpu"]) == 0
    assert "mem_drill: all checks passed" in capsys.readouterr().out


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    _, _, _, tm = _pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousGenerator(tm, budgeter=MemoryBudgeter())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mem_drill.main(["--smoke"])
    assert tm.tok.device.type == "cpu"
