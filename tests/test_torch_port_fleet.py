"""The port's multi-tenant serving fleet (``bigdl_tpu_torch/serving/fleet``)
on the CPU, case for case against ``tests/test_fleet.py``, each held
against the JAX package's fleet on the same inputs:

* stride scheduling: the pick sequences of both schedulers are equal, with
  the starvation bound and the idle re-entry;
* tenancy: ``TenantSpec``'s errors carry the reference's messages, class
  resolution and per-level FIFO order are equal, live register and
  deregister, then ``UnknownTenantError``;
* the autoscaler: ``evaluate`` makes equal decisions on the same scripted
  signals;
* ``SLOTracker`` and ``Tenant._finish`` stay consistent under concurrent
  observers and count what the reference counts;
* the fleets: predictions equal the reference fleet's on the same rows
  with the weights carried across (``convert.load_jax_params``); a killed
  worker is reaped with zero lost; the overcommit, init-failure,
  dead-parked-worker and deregister-timeout cases; the generate tenants'
  tokens equal the reference's, the ``w8a8`` rung beside a classify tenant;
* ``build_report``'s ``fleet`` census equals the reference's over the
  same ledger records; ``bench-serve --fleet --smoke`` passes its gates;
  a ``FleetServer`` without CUDA raises unless asked for the CPU.

Tolerances: predictions and tokens exact; the rest are counts and
messages, compared exactly.
"""

import json
import threading
import time
from concurrent.futures import wait as fwait

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu.api import DLClassifier as JDLClassifier
from bigdl_tpu.serving import fleet as jfleet
from bigdl_tpu.serving.queue import AdmissionQueue as JAdmissionQueue
from bigdl_tpu.serving.queue import Request as JRequest
from bigdl_tpu_torch.api import DLClassifier
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.serving.errors import (DrainingError,
                                            InvalidRequestError,
                                            UnknownTenantError)
from bigdl_tpu_torch.serving.fleet import (Autoscaler, FleetServer,
                                           ModelRegistry, StrideScheduler,
                                           Tenant, TenantSpec)
from bigdl_tpu_torch.serving.queue import AdmissionQueue, Request

torch.set_num_threads(1)

FEATURES = 4


def _models(seed=0, classes=3):
    """The reference's Linear + LogSoftMax tenant model and the port's
    with its weights."""
    jm = jnn.Sequential()
    jm.add(jnn.Linear(FEATURES, classes))
    jm.add(jnn.LogSoftMax())
    jm.build(jax.random.PRNGKey(seed))
    tm = tnn.Sequential()
    tm.add(tnn.Linear(FEATURES, classes))
    tm.add(tnn.LogSoftMax())
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _clfs(seed=0, batch=4, classes=3, jcls=JDLClassifier, tcls=DLClassifier):
    jm, tm = _models(seed, classes)
    return (jcls(jm, batch_shape=(batch, FEATURES)),
            tcls(tm, (batch, FEATURES), device="cpu"))


def _clf(seed=0, batch=4, classes=3):
    return _clfs(seed, batch, classes)[1]


def _rows(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(FEATURES).astype(np.float32) for _ in range(n)]


def _raises(fn):
    """(type name, message) of what ``fn`` raises."""
    try:
        fn()
    except Exception as e:           # the comparison is the point
        return type(e).__name__, str(e)
    return None


def _both_raise(jfn, tfn, match):
    got, want = _raises(tfn), _raises(jfn)
    assert got is not None and got == want, (got, want)
    assert match in got[1]


# -- weighted-fair stride dispatch --------------------------------------------

def _picks(sched, steps):
    """The picks of ``steps``, a list of ready sets, through ``sched``."""
    return [sched.pick(r) for r in steps]


def test_stride_proportional_share():
    scheds = []
    for cls in (jfleet.StrideScheduler, StrideScheduler):
        s = cls()
        s.add("heavy", 9)
        s.add("light", 1)
        scheds.append(_picks(s, [["heavy", "light"]] * 100))
    want, got = scheds
    assert got == want
    assert got.count("heavy") == 90 and got.count("light") == 10


def test_stride_starvation_bound():
    out = []
    for cls in (jfleet.StrideScheduler, StrideScheduler):
        s = cls()
        s.add("flood", 9)
        s.add("victim", 1)
        out.append((s.starvation_bound("victim"),
                    s.starvation_bound("flood"),
                    _picks(s, [["flood", "victim"]] * 500)))
    assert out[1] == out[0]
    bound, flood_bound, picks = out[1]
    assert bound == -(-10 // 1) + 1 and flood_bound == -(-10 // 9) + 1
    gaps, last = [], -1
    for i, name in enumerate(picks):
        if name == "victim":
            gaps.append(i - last)
            last = i
    assert gaps and max(gaps) <= bound


def test_stride_idle_reentry_no_monopoly():
    out = []
    for cls in (jfleet.StrideScheduler, StrideScheduler):
        s = cls()
        s.add("a", 1)
        s.add("b", 1)
        out.append(_picks(s, [["a"]] * 50 + [["a", "b"]] * 10))
    assert out[1] == out[0]
    picks = out[1][50:]
    assert all(picks[i] != picks[i + 1] for i in range(len(picks) - 1))


def test_stride_add_remove_validation():
    js, ts = jfleet.StrideScheduler(), StrideScheduler()
    for s in (js, ts):
        s.add("a", 2)
    _both_raise(lambda: js.add("a", 1), lambda: ts.add("a", 1),
                "already scheduled")
    _both_raise(lambda: js.add("b", 0), lambda: ts.add("b", 0), ">= 1")
    for s in (js, ts):
        assert s.pick([]) is None
        assert s.pick(["ghost"]) is None      # unscheduled names skipped
        s.remove("a")
        assert s.pick(["a"]) is None


# -- tenant specs and the registry --------------------------------------------

def test_tenant_spec_validation():
    jclf, tclf = _clfs()
    cases = [(dict(kind="translate"), "kind"), (dict(weight=0), "weight"),
             (dict(priority_classes=("a", "a")), "duplicate priority"),
             (dict(quantize="w2"), "RUNG_BUDGETS")]
    for kw, match in cases:
        _both_raise(lambda: jfleet.TenantSpec("t", classifier=jclf, **kw),
                    lambda: TenantSpec("t", classifier=tclf, **kw), match)
    _both_raise(lambda: jfleet.TenantSpec("t"), lambda: TenantSpec("t"),
                "classifier= or")
    from bigdl_tpu.ops import quant as jq
    from bigdl_tpu_torch.ops import quant as tq
    assert sorted(tq.RUNG_BUDGETS) == sorted(jq.RUNG_BUDGETS)
    for mode in tq.RUNG_BUDGETS:                # every rung is a tenant's
        assert TenantSpec("t", classifier=tclf, quantize=mode).quantize \
            == mode


def test_tenant_class_resolution():
    jclf, tclf = _clfs()
    kw = dict(priority_classes=("interactive", "batch"),
              deadline_classes={"fast": 0.5, "slow": None})
    jt = jfleet.Tenant(jfleet.TenantSpec("t", classifier=jclf, **kw))
    tt = Tenant(TenantSpec("t", classifier=tclf, **kw))
    now = 100.0
    for t in (jt, tt):
        assert [t.resolve_priority(c) for c in
                (None, "interactive", "batch")] == [0, 0, 1]
        assert t.resolve_deadline("fast", None, now) == now + 0.5
        assert t.resolve_deadline("slow", None, now) is None
        assert t.resolve_deadline(None, 0.25, now) == now + 0.25
        assert t.resolve_deadline("fast", 0.25, now) == now + 0.25
    _both_raise(lambda: jt.resolve_priority("bulk"),
                lambda: tt.resolve_priority("bulk"), "no priority class")
    _both_raise(lambda: jt.resolve_deadline("warp", None, now),
                lambda: tt.resolve_deadline("warp", None, now),
                "no deadline class")
    assert isinstance(_raise_of(lambda: tt.resolve_priority("bulk")),
                      InvalidRequestError)


def _raise_of(fn):
    try:
        fn()
    except Exception as e:
        return e
    return None


def test_registry_live_add_remove():
    jclf, tclf = _clfs()
    out = []
    for reg, t in ((jfleet.ModelRegistry(),
                    jfleet.Tenant(jfleet.TenantSpec("m1", classifier=jclf))),
                   (ModelRegistry(), Tenant(TenantSpec("m1",
                                                       classifier=tclf)))):
        reg.add(t)
        assert "m1" in reg and len(reg) == 1 and reg.get("m1") is t
        dup = _raises(lambda: reg.add(t))
        reg.remove("m1")
        out.append((dup, _raises(lambda: reg.get("m1"))))
    assert out[1] == out[0]
    assert out[1][1][0] == "UnknownTenantError"
    assert isinstance(_raise_of(lambda: ModelRegistry().get("x")),
                      UnknownTenantError)


# -- priority levels in the admission queue -----------------------------------

def test_admission_queue_priority_levels():
    out = []
    for Q, R in ((JAdmissionQueue, JRequest), (AdmissionQueue, Request)):
        q = Q(capacity=4, levels=2)
        lo = R(np.zeros(2, np.float32), priority=1)
        hi = R(np.zeros(2, np.float32), priority=0)
        q.offer(lo)
        q.offer(hi)
        trace = [q.depth, q.depth_by_level()]
        trace.append([q.take() is hi, q.take() is lo])
        for p in (1, 1, 0, 0):
            q.offer(R(np.zeros(2, np.float32), priority=p))
        trace.append(_raises(
            lambda: q.offer(R(np.zeros(2, np.float32), priority=0))))
        trace.append([q.take().priority for _ in range(4)])
        q2 = Q(capacity=4, levels=2)
        q2.offer(R(np.zeros(2, np.float32), priority=7))
        trace.append(q2.depth_by_level())
        trace.append(_raises(lambda: Q(capacity=4, levels=0)))
        out.append(trace)
    assert out[1] == out[0]
    assert out[1][:3] == [2, [1, 1], [True, True]]
    assert out[1][3][0] == "QueueFullError"
    assert out[1][4] == [0, 0, 1, 1] and out[1][5] == [0, 1]
    assert "levels" in out[1][6][1]


# -- the autoscaler (deterministic evaluate) ----------------------------------

class _StubQueue:
    def __init__(self):
        self.depth = 0


class _StubSLO:
    def __init__(self):
        self.burn = 0.0

    def snapshot(self):
        return {"burn_rate": self.burn}


class _StubTenant:
    kind = "classify"

    def __init__(self, name, min_workers=1, max_workers=4):
        self.name = name
        self.queue = _StubQueue()
        self.batch_size = 4
        self.ready = []
        self.inflight = 0
        self.workers = [object()]
        self.slo = _StubSLO()
        self.spec = type("S", (), {"min_workers": min_workers,
                                   "max_workers": max_workers})()


class _StubFleet:
    def __init__(self, tenants):
        self._tenants = tenants
        self.registry = self
        self.ups = []
        self.downs = []

    def tenants(self):
        return self._tenants

    def scale_up(self, t, reason="", **info):
        if len(t.workers) >= t.spec.max_workers:
            return False
        t.workers.append(object())
        self.ups.append((t.name, reason))
        return True

    def scale_down(self, t, reason="", **info):
        if len(t.workers) <= t.spec.min_workers:
            return False
        t.workers.pop()
        self.downs.append((t.name, reason))
        return True


def _scripted(script, tenant_kw=None, extra_workers=0, **kw):
    """Run ``script`` (a list of ``(now, {field: value})``, fields of the
    stub tenant's burn, depth and inflight) through the reference's and the
    port's autoscalers; returns both (decisions, ups, downs, workers)."""
    kw.setdefault("interval_s", 3600.0)      # the threads stay idle
    kw.setdefault("grow_after", 2)
    kw.setdefault("shrink_after", 3)
    kw.setdefault("cooldown_s", 10.0)
    out = []
    for cls in (jfleet.Autoscaler, Autoscaler):
        t = _StubTenant("t", **(tenant_kw or {}))
        t.workers += [object()] * extra_workers
        fleet = _StubFleet([t])
        a = cls(fleet, **kw)
        try:
            acts = []
            for now, sig in script:
                t.slo.burn = sig.get("burn", t.slo.burn)
                t.queue.depth = sig.get("depth", t.queue.depth)
                t.inflight = sig.get("inflight", t.inflight)
                acts.append(a.evaluate(now=now))
        finally:
            a.close()
        out.append((acts, fleet.ups, fleet.downs, len(t.workers)))
    assert out[1] == out[0]
    return out[1]


def test_autoscaler_hysteresis_band_holds_steady():
    acts, ups, downs, _ = _scripted(
        [(float(i), {"burn": 0.5, "depth": 4}) for i in range(20)])
    assert acts == [0] * 20 and not ups and not downs


def test_autoscaler_grow_needs_consecutive_pressure_and_cooldown():
    acts, ups, _, _ = _scripted(
        [(0.0, {"burn": 2.0}), (1.0, {}), (2.0, {}), (5.0, {}),
         (11.0, {"burn": 0.0}), (12.0, {"burn": 2.0}), (13.0, {})],
        grow_after=2, cooldown_s=10.0)
    assert acts == [0, 1, 0, 0, 0, 0, 1]
    assert ups == [("t", "burn"), ("t", "burn")]


def test_autoscaler_backlog_pressure_and_shrink_floor():
    acts, ups, downs, workers = _scripted(
        [(0.0, {"depth": 100}), (1.0, {"depth": 0}), (2.0, {}), (3.0, {}),
         (4.0, {})],
        tenant_kw=dict(min_workers=1, max_workers=4), grow_after=1,
        shrink_after=2, cooldown_s=0.5)
    assert acts == [1, 0, 1, 0, 0]
    assert ups == [("t", "backlog")] and downs == [("t", "idle")]
    assert workers == 1


def test_autoscaler_rejects_inverted_hysteresis():
    for kw in (dict(burn_hi=0.5, burn_lo=0.5),
               dict(backlog_hi=0.1, backlog_lo=0.2)):
        _both_raise(lambda: jfleet.Autoscaler(_StubFleet([]), **kw),
                    lambda: Autoscaler(_StubFleet([]), **kw), "hysteresis")


# -- SLOTracker and Tenant._finish under concurrent observers -----------------

def _hammer(observe, n_threads, per, seed0=0):
    def run(seed):
        rng = np.random.RandomState(seed)
        for _ in range(per):
            observe(bool(rng.rand() < 0.5))

    threads = [threading.Thread(target=run, args=(seed0 + i,))
               for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()


def test_slo_tracker_concurrent_observers_stay_consistent():
    from bigdl_tpu.observability.live import SLOTracker as JSLOTracker
    from bigdl_tpu_torch.observability.live import SLOTracker
    trk = SLOTracker(target=0.9, window=64, min_samples=8, cooldown_s=0.0)
    _hammer(lambda ok: trk.observe(ok, 0.01), 8, 500)
    snap = trk.snapshot()
    assert snap["samples"] == 64
    assert 0 <= snap["misses"] <= 64
    assert snap["misses"] == sum(1 for ok, _ in trk._samples if not ok)
    assert trk.burn_count >= 1
    # the same outcomes one after another: the reference's counts
    seq = [bool(np.random.RandomState(3).rand() < 0.5) for _ in range(300)]
    snaps = []
    for cls in (JSLOTracker, SLOTracker):
        t = cls(target=0.9, window=64, min_samples=8, cooldown_s=0.0)
        fired = [t.observe(ok, 0.01) is not None for ok in seq]
        s = t.snapshot()
        snaps.append((fired, t.burn_count, s["samples"], s["misses"],
                      s["hit_rate"], s["burn_rate"]))
    assert snaps[1] == snaps[0]


def test_tenant_concurrent_finish_consistent_accounting():
    jclf, tclf = _clfs()
    N, PER = 8, 100
    out = []
    for T, S, R, clf in ((jfleet.Tenant, jfleet.TenantSpec, JRequest, jclf),
                         (Tenant, TenantSpec, Request, tclf)):
        t = T(S("t", classifier=clf, slo_window=4096, slo_min_samples=8))
        reqs = [[R(np.zeros(FEATURES, np.float32)) for _ in range(PER)]
                for _ in range(N)]

        def finisher(batch, seed, t=t):
            rng = np.random.RandomState(seed)
            for r in batch:
                if rng.rand() < 0.25:
                    t._finish(r, "expired", exc=TimeoutError("deadline"))
                else:
                    t._finish(r, "ok", result=1)

        threads = [threading.Thread(target=finisher, args=(b, i))
                   for i, b in enumerate(reqs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        flat = [r for b in reqs for r in b]
        assert all(r.future.done() for r in flat)
        oks = sum(1 for r in flat if r.future.exception() is None)
        snap = t.slo.snapshot()
        with t._lat_lock:
            lat = (len(t._latencies),
                   sum(1 for s, _ in t._latencies if s == "ok"))
        local, _, _ = t.metrics.snapshot()
        out.append((oks, snap["samples"], snap["misses"], lat,
                    local.get("serve.cancelled", (0, 0))[0]))
    assert out[1] == out[0]
    oks, samples, misses, lat, cancelled = out[1]
    assert samples == N * PER and misses == N * PER - oks
    assert lat == (N * PER, oks) and cancelled == 0


def test_slo_tracker_cooldown_rate_limits_burn_events():
    from bigdl_tpu.observability.live import SLOTracker as JSLOTracker
    from bigdl_tpu_torch.observability.live import SLOTracker
    trks = [cls(target=0.9, window=16, min_samples=4, cooldown_s=0.2)
            for cls in (JSLOTracker, SLOTracker)]
    fired = [[t.observe(False, 0.01) is not None for _ in range(16)]
             for t in trks]
    assert fired[1] == fired[0] and sum(fired[1]) == 1
    time.sleep(0.25)
    assert [t.observe(False, 0.01) is not None for t in trks] == [True] * 2
    assert [t.burn_count for t in trks] == [2, 2]


# -- the fleets end to end ----------------------------------------------------

def _eager(tm, rows):
    with torch.inference_mode():
        y = tm(torch.from_numpy(np.stack(rows)))
    return [int(v) for v in y.argmax(dim=-1) + 1]


def test_fleet_serves_tenants_bit_equal_and_live_tenancy():
    pairs = [_models(1), _models(2), _models(3, classes=5)]
    rows = _rows(8, seed=3)
    results = []
    for side in (0, 1):
        mk = (lambda m: JDLClassifier(m, batch_shape=(4, FEATURES))) \
            if side == 0 else \
            (lambda m: DLClassifier(m, (4, FEATURES), device="cpu"))
        S = jfleet.TenantSpec if side == 0 else TenantSpec
        kw = {} if side == 0 else {"device": "cpu"}
        F = jfleet.FleetServer if side == 0 else FleetServer
        specs = [S("alpha", classifier=mk(pairs[0][side]), weight=2,
                   min_workers=1),
                 S("beta", classifier=mk(pairs[1][side]), weight=1,
                   min_workers=1)]
        with F(specs, max_workers=3, **kw) as fleet:
            fa = [fleet.submit("alpha", r) for r in rows]
            fb = [fleet.submit("beta", r) for r in rows]
            got = {"alpha": [f.result(timeout=30) for f in fa],
                   "beta": [f.result(timeout=30) for f in fb]}
            fleet.register(S("gamma", classifier=mk(pairs[2][side]),
                             min_workers=1))
            fc = [fleet.submit("gamma", r) for r in rows]
            got["gamma"] = [f.result(timeout=30) for f in fc]
            assert fleet.deregister("gamma")
            shed = _raises(lambda: fleet.submit("gamma", rows[0]))
            got["after"] = fleet.submit("alpha", rows[0]).result(timeout=30)
        results.append((got, shed))
    assert results[1] == results[0]
    got, shed = results[1]
    for name, (_, tm) in zip(("alpha", "beta", "gamma"), pairs):
        assert got[name] == _eager(tm, rows)
    assert got["after"] == got["alpha"][0]
    assert shed[0] == "UnknownTenantError"


def test_fleet_worker_kill_reap_zero_lost():
    class JSlow(JDLClassifier):
        def _run(self, x):
            time.sleep(0.02)
            return super()._run(x)

    class TSlow(DLClassifier):
        def _run(self, x):
            time.sleep(0.02)
            return super()._run(x)

    rows = _rows(48, seed=4)
    preds = []
    for side, (F, S, kw) in enumerate((
            (jfleet.FleetServer, jfleet.TenantSpec, {}),
            (FleetServer, TenantSpec, {"device": "cpu"}))):
        clf = _clfs(1, jcls=JSlow, tcls=TSlow)[side]
        spec = S("t", classifier=clf, weight=1, min_workers=2,
                 max_workers=2, queue_capacity=256)
        fleet = F([spec], max_workers=3, **kw)      # one parked spare
        try:
            t = fleet.registry.get("t")
            futs = [fleet.submit("t", r) for r in rows]
            time.sleep(0.03)
            victim = t.workers[0]
            victim.kill()
            fwait(futs, timeout=30)
            assert all(f.done() for f in futs)
            assert all(f.exception() is None for f in futs)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and not \
                    fleet.metrics.snapshot()[0].get("fleet.reaped", (0,))[0]:
                time.sleep(0.01)
            local, _, _ = fleet.metrics.snapshot()
            assert local.get("fleet.reaped", (0, 0))[0] >= 1
            assert not victim.thread.is_alive()
            assert len(t.workers) == 2 and victim not in t.workers
            if side == 1:
                # every request answered once: a second answer would show
                # as a cancel, and the ok census covers every future
                c = fleet.stats()["tenants"]["t"]["counters"]
                assert c.get("serve.cancelled", 0) == 0
                assert c.get("serve.completed", 0) == len(rows)
            preds.append([f.result() for f in futs])
        finally:
            assert fleet.drain(timeout=10)
    assert preds[1] == preds[0]


def test_fleet_runs_on_the_cpu_only_when_asked(monkeypatch):
    spec = TenantSpec("a", classifier=_clf(1), min_workers=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = {th.ident for th in threading.enumerate()}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetServer([spec], max_workers=1)
    assert {th.ident for th in threading.enumerate()} <= before


def test_fleet_min_workers_overcommit_rejected():
    jclf1, tclf1 = _clfs(1)
    jclf2, tclf2 = _clfs(2)
    _both_raise(
        lambda: jfleet.FleetServer(
            [jfleet.TenantSpec("a", classifier=jclf1, min_workers=2),
             jfleet.TenantSpec("b", classifier=jclf2, min_workers=2)],
            max_workers=3),
        lambda: FleetServer(
            [TenantSpec("a", classifier=tclf1, min_workers=2),
             TenantSpec("b", classifier=tclf2, min_workers=2)],
            max_workers=3, device="cpu"),
        "exceeds the fleet")


def test_fleet_init_failure_joins_started_threads():
    before = {th.ident for th in threading.enumerate()}
    jclfs, tclfs = zip(_clfs(1), _clfs(2))
    _both_raise(
        lambda: jfleet.FleetServer(
            [jfleet.TenantSpec("a", classifier=c, min_workers=1)
             for c in jclfs],
            max_workers=2),
        lambda: FleetServer(
            [TenantSpec("a", classifier=c, min_workers=1) for c in tclfs],
            max_workers=2, device="cpu"),
        "already registered")
    leaked = [th.name for th in threading.enumerate()
              if th.ident not in before and th.is_alive()
              and th.name.startswith(("bigdl-torch-serve-w",
                                      "bigdl-torch-fleet",
                                      "bigdl-tpu-serve-w",
                                      "bigdl-tpu-fleet"))]
    assert not leaked, f"leaked threads: {leaked}"


def test_fleet_register_dead_parked_worker_rolls_back():
    out = []
    for side, (F, S, kw) in enumerate((
            (jfleet.FleetServer, jfleet.TenantSpec, {}),
            (FleetServer, TenantSpec, {"device": "cpu"}))):
        fleet = F([S("a", classifier=_clfs(1)[side], min_workers=1)],
                  max_workers=2, **kw)
        try:
            parked = fleet._parked[-1]          # next to be handed out
            parked.kill()
            parked.thread.join(timeout=5)
            assert not parked.thread.is_alive()
            err = _raises(lambda: fleet.register(
                S("b", classifier=_clfs(2)[side], min_workers=1)))
            assert "b" not in fleet.registry
            shed = _raises(lambda: fleet.submit("b", _rows(1)[0]))
            ok = fleet.submit("a", _rows(1)[0]).result(timeout=30)
            out.append((err, shed[0], ok))
        finally:
            assert fleet.drain(timeout=10)
    assert out[1] == out[0]
    assert "no live worker" in out[1][0][1]
    assert out[1][1] == "UnknownTenantError"


def test_fleet_deregister_timeout_fails_stranded_typed():
    class JSlow(JDLClassifier):
        def _run(self, x):
            time.sleep(0.05)
            return super()._run(x)

    class TSlow(DLClassifier):
        def _run(self, x):
            time.sleep(0.05)
            return super()._run(x)

    rows = _rows(64, seed=7)
    answers = []
    for side, (F, S, kw) in enumerate((
            (jfleet.FleetServer, jfleet.TenantSpec, {}),
            (FleetServer, TenantSpec, {"device": "cpu"}))):
        spec = S("t", classifier=_clfs(1, jcls=JSlow, tcls=TSlow)[side],
                 min_workers=1, max_workers=1, queue_capacity=256)
        fleet = F([spec], max_workers=1, **kw)
        try:
            futs = [fleet.submit("t", r) for r in rows]
            assert fleet.deregister("t", timeout=0.05) is False
            fwait(futs, timeout=30)
            assert all(f.done() for f in futs)     # zero lost
            stranded = [f for f in futs if f.exception() is not None]
            assert stranded
            assert all(type(f.exception()).__name__ == "DrainingError"
                       for f in stranded)
            if side == 1:
                assert all(isinstance(f.exception(), DrainingError)
                           for f in stranded)
            answers.append({i: f.result() for i, f in enumerate(futs)
                            if f.exception() is None})
        finally:
            fleet.drain(timeout=10)
    # what each fleet answered before the cut agrees where both answered
    both = set(answers[0]) & set(answers[1])
    assert all(answers[0][i] == answers[1][i] for i in both)


def _lm_pair(seed=0):
    from bigdl_tpu.models.transformer import TransformerLM as JLM
    from bigdl_tpu_torch.models import TransformerLM
    jlm = JLM(64, max_len=32, embed_dim=32, num_heads=2, num_layers=1)
    jlm._ensure_built()
    tlm = TransformerLM(64, max_len=32, embed_dim=32, num_heads=2,
                        num_layers=1)
    load_jax_params(tlm, jax.tree_util.tree_map(np.asarray, jlm.params))
    return jlm, tlm


def test_generate_tenant_validates_classes_at_the_door():
    for S in (jfleet.TenantSpec, TenantSpec):
        for kw in (dict(deadline_classes={"interactive": 0.5}),
                   dict(default_deadline_s=1.0)):
            with pytest.raises(ValueError, match="finite deadlines"):
                S("lm", model=object(), kind="generate", **kw)
    lms = _lm_pair()
    prompt = np.arange(1, 5, dtype=np.int32)
    out = []
    for side, (F, S, kw) in enumerate((
            (jfleet.FleetServer, jfleet.TenantSpec, {}),
            (FleetServer, TenantSpec, {"device": "cpu"}))):
        spec = S("lm", model=lms[side], kind="generate",
                 priority_classes=("interactive", "batch"),
                 deadline_classes={"batch": None},
                 generator_kwargs=dict(num_slots=2, seq_buckets=[16]))
        with F([S("clf", classifier=_clfs(1)[side], min_workers=1), spec],
               max_workers=1, **kw) as fleet:
            errs = [_raises(lambda: fleet.submit("lm", prompt, max_new=2,
                                                 priority_class="nope")),
                    _raises(lambda: fleet.submit("lm", prompt, max_new=2,
                                                 deadline_class="nope")),
                    _raises(lambda: fleet.submit("lm", prompt, max_new=2,
                                                 deadline_s=1.0))]
            fut = fleet.submit("lm", prompt, max_new=2,
                               priority_class="batch", deadline_class="batch")
            out.append((errs, np.asarray(fut.result(timeout=60)).tolist()))
    assert out[1] == out[0]
    errs, tokens = out[1]
    assert [e[0] for e in errs] == ["InvalidRequestError"] * 3
    assert "priority class" in errs[0][1] and "deadline class" in errs[1][1]
    assert "deadline_s" in errs[2][1] and len(tokens) == 2


def test_autoscaler_inflight_counts_into_backlog():
    acts, _, downs, _ = _scripted(
        [(float(i), {"inflight": 2}) for i in range(6)]
        + [(10.0, {"inflight": 1}), (11.0, {})],
        tenant_kw=dict(min_workers=1, max_workers=4), extra_workers=1,
        shrink_after=2, cooldown_s=0.1)
    assert acts == [0] * 6 + [0, 1]
    assert downs == [("t", "idle")]


def test_outcome_readers_never_block_on_pending_futures():
    from concurrent.futures import Future

    from bigdl_tpu.serving.drill import _outcomes as jdrill_outcomes
    from bigdl_tpu.serving.fleet.bench_fleet import \
        _outcomes as jbench_outcomes
    from bigdl_tpu_torch.serving.drill import _outcomes as drill_outcomes
    from bigdl_tpu_torch.serving.fleet.bench_fleet import \
        _outcomes as bench_outcomes

    done: Future = Future()
    done.set_result(1)
    pending: Future = Future()                # never completes
    for mine, theirs in ((drill_outcomes, jdrill_outcomes),
                         (bench_outcomes, jbench_outcomes)):
        t0 = time.monotonic()
        got = mine([done, pending], timeout_s=0.2)
        assert time.monotonic() - t0 < 5.0
        assert got == theirs([done, pending], timeout_s=0.2)
    assert drill_outcomes([done, pending], timeout_s=0.1) == \
        {"ok": 1, "errors": {"Pending": 1}}
    assert bench_outcomes([done, pending], timeout_s=0.1) == \
        {"ok": 1, "expired": 0, "failed": 1}


def test_fleet_generate_tenant_w8a8():
    lms = _lm_pair()
    prompts = [np.random.RandomState(i).randint(1, 65, (4 + i,))
               .astype(np.int32) for i in range(3)]
    row = _rows(1)[0]
    out = []
    for side, (F, S, kw) in enumerate((
            (jfleet.FleetServer, jfleet.TenantSpec, {}),
            (FleetServer, TenantSpec, {"device": "cpu"}))):
        specs = [
            S("clf", classifier=_clfs(1)[side], min_workers=1),
            S("lm", model=lms[side], kind="generate", quantize="w8a8",
              calibration_prompts=prompts,
              generator_kwargs=dict(num_slots=2, seq_buckets=[16],
                                    steps_per_sync=2)),
        ]
        with F(specs, max_workers=1, **kw) as fleet:
            t = fleet.registry.get("lm")
            assert t.generator.quantize == "w8a8"
            gen = [fleet.submit("lm", p, max_new=4) for p in prompts]
            clf = fleet.submit("clf", row)
            outs = [np.asarray(f.result(timeout=60)).tolist() for f in gen]
            st = fleet.stats()["tenants"]["lm"]
            assert st["kind"] == "generate" and st["quantize"] == "w8a8"
            with pytest.raises(ValueError, match="max_new"):
                fleet.submit("lm", prompts[0])
            out.append((outs, clf.result(timeout=30)))
    assert out[1] == out[0]
    assert all(len(o) == 4 for o in out[1][0])


# -- the fleet census ---------------------------------------------------------

def test_run_report_json_has_fleet_key(tmp_path):
    from bigdl_tpu.observability.report import build_report as jbuild
    from bigdl_tpu_torch.observability.ledger import set_run_dir
    from bigdl_tpu_torch.observability.report import (build_report,
                                                      load_ledger)
    run_dir = str(tmp_path / "run")
    set_run_dir(run_dir)
    try:
        specs = [TenantSpec("chat", classifier=_clf(1), weight=3,
                            min_workers=1),
                 TenantSpec("embed", classifier=_clf(2), weight=1,
                            min_workers=1)]
        with FleetServer(specs, max_workers=2, device="cpu") as fleet:
            futs = [fleet.submit(t, r) for r in _rows(8, seed=5)
                    for t in ("chat", "embed")]
            fwait(futs, timeout=30)
    finally:
        set_run_dir(None)
    records = load_ledger(run_dir, strict=True)[0]
    rep = build_report(records)
    assert rep["fleet"] is not None
    # the reference's report over the same records gives the same census
    assert rep["fleet"] == jbuild(records)["fleet"]
    census = rep["fleet"]["tenants"]
    assert set(census) == {"chat", "embed"}
    for name in census:
        assert census[name]["requests"].get("ok", 0) == 8
        assert census[name]["dispatches"] >= 1
        assert census[name]["weight"] == (3 if name == "chat" else 1)
    assert rep["fleet"]["dispatches"] >= 2
    assert rep["fleet"]["worker_seconds"] > 0
    assert "fleet" in json.loads(json.dumps(rep))
    assert build_report([])["fleet"] is None


# -- bench-serve --fleet --smoke ----------------------------------------------

def test_bench_serve_fleet_smoke(tmp_path, capsys):
    from bigdl_tpu_torch.cli import bench_serve
    out = str(tmp_path / "fleet.json")
    assert bench_serve(["--fleet", "--smoke", "--device", "cpu",
                        "--out", out]) == 0
    with open(out, encoding="utf-8") as f:
        art = json.load(f)
    assert art["bench"] == "fleet_r15" and art["meta"]["smoke"]
    acc = art["acceptance"]
    assert acc["holds"]
    assert acc["outputs_bit_equal_to_single_tenant"]
    assert acc["worker_seconds_under_0p8"]
    assert acc["noisy_sheds_typed_and_attributed"]
    assert acc["victim_within_error_budget"]
    assert set(art["autoscaled"]["tenants"]) == {"chat", "embed"}
    # the printed line is the written result
    printed = [json.loads(line) for line in capsys.readouterr().out
               .splitlines() if line.startswith('{"bench"')]
    assert printed == [art]
