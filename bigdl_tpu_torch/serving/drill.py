"""Deterministic serving chaos drill (``bigdl_tpu/serving/drill.py``):

    python -m bigdl_tpu_torch.cli serve-drill [--batch-size N]
        [--forward-delay-ms MS] [--workers N] [--device cuda|cpu]
        [--run-dir DIR] [--fleet-smoke]

One scripted pass through every failure seam of :class:`InferenceServer`,
driven by the deterministic :class:`FaultInjector` (sites ``serve.pack``,
``serve.forward`` and ``serve.worker<i>.forward``), asserting after each
phase that the runtime isolated the failure:

1. healthy traffic: predictions equal the eager forward, in order; the
   live ``/metrics`` endpoint answers with Prometheus text while the waves
   are in flight;
2. malformed rows are rejected at ``submit()``, never poison a batch;
3. provably unmeetable deadlines are shed at admission;
4. an injected pack fault fails only its batch, breaker untouched;
5. injected forward faults fail their batches typed and open the breaker
   after K consecutive failures; the misses drive the SLO tracker's burn
   rate over its threshold (``slo.burn`` on the ledger);
6. while open, submissions fast-fail (shed ``breaker_open``);
7. after the cooldown the half-open probe closes the breaker and traffic
   recovers;
8. an overload burst with tight deadlines: the tail expires before
   dispatch, the head is served;
9. graceful drain: every admitted request reached a terminal state, the
   queue is empty, the worker joined;
10. the worker pool (``--workers``, default 2, a two-rung bucket ladder):
    worker 0's forwards are killed through ``serve.worker0.forward``, its
    breaker opens, the other worker keeps serving, a partial wave lands in
    the small bucket, and drain loses no accepted request;
11. paged generation under token pressure: a ``ContinuousGenerator`` whose
    page pool is far smaller than ``num_slots x max_len`` is flooded with
    mixed-length prompts; never-fit requests shed ``SlotCapacityError`` at
    the door, everything admitted decodes equal to a per-request
    ``TransformerLM.generate``, and drain loses no request;
12. the multi-tenant fleet (``serving/fleet``): tenant "flood" is driven
    far past its queue while one of its workers is killed mid-flood; the
    victim tenant "steady" keeps every deadline (exclusive allocations and
    weighted-fair dispatch), every flood shed is typed ``QueueFullError``
    and attributed to the flooding tenant, the dead worker is reaped (its
    abandoned batches salvaged, the allocation backfilled from the parked
    worker: ``fleet.reap`` on the ledger), and drain loses no accepted
    request.  ``--fleet-smoke`` runs this phase alone.

Deadlines and batch boundaries are multiples of ``--forward-delay-ms``, the
fixed time every forward sleeps, which keeps the phases deterministic on
any host.  The drill's model runs on ``--device`` (CUDA by default, the CPU
when asked).  With ``--run-dir`` (or ``BIGDL_TPU_RUN_DIR``) the drill lands
in the run ledger and ``run-report`` renders its serving section.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.resilience.fault_injector import FaultInjector
from bigdl_tpu_torch.serving.errors import (BreakerOpenError,
                                            DeadlineUnmeetableError,
                                            InvalidRequestError)
from bigdl_tpu_torch.serving.server import InferenceServer

FEATURES = 4
CLASSES = 3


def _drill_classifier(batch_size: int, forward_delay_s: float, device):
    """A ``DLClassifier`` whose forward takes a known, fixed time on
    ``device``: the drill's deadlines and batch boundaries are multiples of
    it."""
    import bigdl_tpu_torch.nn as nn
    from bigdl_tpu_torch.api import DLClassifier

    m = nn.Sequential()
    m.add(nn.Linear(FEATURES, CLASSES))
    m.add(nn.LogSoftMax())
    m.reset(7)

    class Slow(DLClassifier):
        def _run(self, x):
            time.sleep(forward_delay_s)     # a heavier model, honestly
            return super()._run(x)

    clf = Slow(m, batch_shape=(batch_size, FEATURES), device=device)
    return clf, clf.model


def _eager(model, rows) -> List[int]:
    """The 1-based classes of ``rows`` by one plain forward."""
    dev = next(model.parameters()).device
    with torch.inference_mode():
        y = model(torch.as_tensor(np.stack(rows), device=dev))
    return [int(v) for v in (y.argmax(dim=-1) + 1).cpu()]


def _rows(rng: np.random.RandomState, n: int) -> List[np.ndarray]:
    return [rng.rand(FEATURES).astype(np.float32) for _ in range(n)]


def _wave(server: InferenceServer, rows, deadline_s=None):
    return [server.submit(r, deadline_s=deadline_s) for r in rows]


def _outcomes(futures, timeout_s: float = 60.0) -> dict:
    # the wait is bounded: a future still pending past the deadline is the
    # lost-request bug the drill exists to catch; it fails the gate
    # (counted under "Pending"), never hangs it
    from concurrent.futures import TimeoutError as FutureTimeout
    out = {"ok": 0, "errors": {}}
    deadline = time.monotonic() + timeout_s
    for f in futures:
        try:
            exc = f.exception(
                timeout=max(0.0, deadline - time.monotonic()))
        except FutureTimeout:
            out["errors"]["Pending"] = out["errors"].get("Pending", 0) + 1
            continue
        if exc is None:
            out["ok"] += 1
        else:
            name = type(exc).__name__
            out["errors"][name] = out["errors"].get(name, 0) + 1
    return out


def _expect(cond: bool, what: str, failures: List[str]) -> None:
    tag = "ok" if cond else "FAIL"
    print(f"  [{tag}] {what}")
    if not cond:
        failures.append(what)


def _pool_phase(args, rng, device, failures: List[str]) -> None:
    """Phase 10: one faulted worker must not stall the pool."""
    delay = args.forward_delay_ms / 1e3
    bsz = args.batch_size
    clf2, _ = _drill_classifier(bsz, delay, device)
    small = max(1, bsz // 2)
    pool = InferenceServer(clf2,
                           queue_capacity=64 * bsz,
                           max_delay_s=delay / 2,
                           breaker_threshold=args.breaker_threshold,
                           # stays open: the phase proves isolation, not
                           # recovery
                           breaker_reset_s=60.0,
                           forward_retries=0,
                           num_workers=args.workers,
                           batch_buckets=sorted({small, bsz}),
                           device=device)
    pool_accepted = []
    try:
        # kill only worker 0's forwards through its own site; waves run
        # one after another, so the least-loaded tie-break (lowest wid)
        # routes each to worker 0 until its breaker opens
        FaultInjector.install(FaultInjector().add(
            "serve.worker0.forward", count=args.breaker_threshold))

        def settle():
            # a worker drops its in-flight count after the futures
            # resolve; wait for it so the tie-break stays deterministic
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                ws = pool.stats()["workers"]
                if all(w["pending"] == 0 for w in ws.values()):
                    return
                time.sleep(0.001)

        faulted = 0
        for _ in range(args.breaker_threshold):
            wave = _wave(pool, _rows(rng, bsz))
            pool_accepted += wave
            faulted += _outcomes(wave)["errors"].get(
                "ForwardFailedError", 0)
            settle()
        st = pool.stats()["workers"]
        _expect(st[0]["breaker"] == "open",
                "faulted worker 0's breaker opened", failures)
        _expect(all(st[w]["breaker"] == "closed" for w in st if w != 0),
                "every other worker's breaker stayed closed", failures)
        _expect(faulted == args.breaker_threshold * bsz,
                f"worker 0's {args.breaker_threshold} faulted batches "
                "failed typed", failures)
        # the pool keeps serving around the open breaker, a partial wave
        # into the small bucket included
        wave = _wave(pool, _rows(rng, 2 * bsz))
        part = _wave(pool, _rows(rng, small))
        pool_accepted += wave + part
        oc = _outcomes(wave + part)
        _expect(oc["ok"] == 2 * bsz + small,
                f"the pool kept serving around the open breaker "
                f"({oc['ok']} ok)", failures)
        counters = pool.stats()["counters"]
        _expect(counters.get(f"serve.bucket.{small}", 0) >= 1,
                f"partial wave dispatched into bucket {small} (padding "
                "ledgered)", failures)
        joined = pool.drain(timeout=10)
        _expect(joined, "pool drain joined dispatcher and workers",
                failures)
        _expect(all(f.done() for f in pool_accepted),
                f"all {len(pool_accepted)} pool requests reached a "
                "terminal state (zero lost)", failures)
    finally:
        FaultInjector.clear()
        pool.drain(timeout=10)


def _paged_phase(rng, device, failures: List[str]) -> None:
    """Phase 11: flood a token-scarce page pool."""
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving.errors import SlotCapacityError
    from bigdl_tpu_torch.serving.scheduler.continuous import \
        ContinuousGenerator

    lm = TransformerLM(64, max_len=48, embed_dim=32, num_heads=2,
                       num_layers=1).reset(11).evaluate()
    prompts = [rng.randint(1, 65, size=rng.randint(3, 8)).astype(np.int32)
               for _ in range(8)]
    budgets = [int(rng.randint(2, 10)) for _ in range(8)]
    refs = [lm.generate(p[None], max_new=n, temperature=0.0,
                        device=device)[0].cpu().numpy()
            for p, n in zip(prompts, budgets)]
    # 6 pages x 4 tokens = 24 cache tokens for 2 slots x 48 max_len of
    # nominal demand: admission is token-bound, so placement runs the
    # holdback and the prefix eviction
    gen = ContinuousGenerator(lm, num_slots=2, page_size=4, num_pages=6,
                              seq_buckets=[8], steps_per_sync=2,
                              queue_capacity=64, device=device)
    try:
        futs = [gen.submit(p, n) for p, n in zip(prompts, budgets)]
        sheds = 0
        for _ in range(3):            # 7 + 30 needs 36 tokens > 24 pool
            try:
                gen.submit(rng.randint(1, 65, size=7).astype(np.int32), 30)
            except SlotCapacityError:
                sheds += 1
        _expect(sheds == 3, "3 never-fit floods shed typed "
                "SlotCapacityError at the door (page exhaustion)",
                failures)
        outs = [f.result(timeout=60) for f in futs]
        _expect(all(np.array_equal(r, o) for r, o in zip(refs, outs)),
                f"all {len(futs)} admitted requests decoded equal to "
                "generate() under page pressure", failures)
        _expect(all(f.done() for f in futs),
                "zero lost under token-scarce paging", failures)
    finally:
        _expect(gen.drain(timeout=10), "paged generator drained", failures)


def _fleet_phase(args, device, failures: List[str]) -> None:
    """Phase 12: a noisy neighbour and a worker kill against the fleet.
    Tenant ``flood`` (weight 3, 2 exclusive workers, a small queue) is
    driven far past its capacity while one of its workers is killed
    mid-flood; tenant ``steady`` (weight 1, 1 worker) serves
    deadline-classed traffic throughout."""
    import threading
    from concurrent.futures import wait as fwait

    from bigdl_tpu_torch.serving.errors import QueueFullError, ShedError
    from bigdl_tpu_torch.serving.fleet import FleetServer, TenantSpec

    delay = args.forward_delay_ms / 1e3
    bsz = args.batch_size
    rng = np.random.RandomState(12)
    flood_clf, _ = _drill_classifier(bsz, delay, device)
    steady_clf, _ = _drill_classifier(bsz, delay, device)
    steady_ddl = 60 * delay
    specs = [
        TenantSpec("flood", classifier=flood_clf, weight=3,
                   min_workers=2, max_workers=2,
                   queue_capacity=8 * bsz, max_delay_s=delay / 2),
        TenantSpec("steady", classifier=steady_clf, weight=1,
                   min_workers=1, max_workers=1,
                   priority_classes=("interactive",),
                   deadline_classes={"interactive": steady_ddl},
                   slo_target=0.9, slo_min_samples=8,
                   queue_capacity=64 * bsz, max_delay_s=delay / 2),
    ]
    # one parked spare: the reap after the kill backfills from it
    fleet = FleetServer(specs, max_workers=4, device=device)
    t_flood = fleet.registry.get("flood")
    flood_rows = 100 * bsz
    flood_futs: List = []
    sheds = {"queue_full": 0, "other": 0}
    killed = threading.Event()

    def run_flood():
        r = np.random.RandomState(13)
        for i in range(flood_rows):
            if i == flood_rows // 4:
                # kill one of flood's workers mid-flood: the thread takes
                # no more work, abandoning its inbox
                t_flood.workers[0].kill()
                killed.set()
            try:
                flood_futs.append(fleet.submit(
                    "flood", r.rand(FEATURES).astype(np.float32)))
            except QueueFullError:
                sheds["queue_full"] += 1
            except ShedError:
                sheds["other"] += 1

    th = threading.Thread(target=run_flood)
    th.start()
    steady_futs: List = []
    steady_sheds = 0
    for _ in range(8):                     # the victim's waves ride it
        for row in _rows(rng, bsz):
            try:
                steady_futs.append(fleet.submit(
                    "steady", row, priority_class="interactive",
                    deadline_class="interactive"))
            except ShedError:
                steady_sheds += 1
        time.sleep(2 * delay)
    th.join()
    fwait(flood_futs + steady_futs, timeout=60)

    _expect(killed.is_set(), "one flood worker was killed mid-flood",
            failures)
    steady_ok = sum(1 for f in steady_futs
                    if f.done() and f.exception() is None)
    _expect(steady_sheds == 0 and steady_ok == len(steady_futs),
            f"victim tenant kept 100% of its deadlines through flood + "
            f"worker kill ({steady_ok}/{len(steady_futs)} ok)", failures)
    slo = fleet.registry.get("steady").slo.snapshot()
    _expect(slo["hit_rate"] >= 0.9,
            f"victim SLO hit rate {slo['hit_rate']:.3f} >= 0.9 target",
            failures)
    _expect(sheds["queue_full"] > 0 and sheds["other"] == 0,
            f"flood sheds all typed QueueFullError "
            f"({sheds['queue_full']} sheds)", failures)
    flood_counters = fleet.stats()["tenants"]["flood"]["counters"]
    _expect(int(flood_counters.get("serve.shed.queue_full", 0))
            == sheds["queue_full"],
            "every shed attributed to the flooding tenant on its own "
            "counters", failures)
    steady_counters = fleet.stats()["tenants"]["steady"]["counters"]
    _expect(int(steady_counters.get("serve.shed.queue_full", 0)) == 0,
            "zero sheds attributed to the victim tenant", failures)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if fleet.metrics.snapshot()[0].get("fleet.reaped", (0, 0))[0]:
            break
        time.sleep(0.01)
    reaped = fleet.metrics.snapshot()[0].get("fleet.reaped", (0, 0))[0]
    _expect(int(reaped) >= 1,
            "dead worker reaped (inbox salvaged, allocation "
            "backfilled from the parked pool)", failures)
    alloc = fleet.stats()["allocations"]
    _expect(len(alloc["flood"]) == 2,
            f"flood allocation backfilled to 2 workers "
            f"({alloc['flood']})", failures)
    joined = fleet.drain(timeout=10)
    _expect(joined, "fleet drain joined dispatcher and workers",
            failures)
    _expect(all(f.done() for f in flood_futs + steady_futs),
            f"all {len(flood_futs) + len(steady_futs)} accepted fleet "
            "requests reached a terminal state (zero lost)", failures)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        "serve-drill",
        description="Deterministic chaos drill over the online-serving "
                    "runtime")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--forward-delay-ms", type=float, default=15.0,
                   help="fixed per-batch forward time the drill's "
                        "deadlines are expressed in")
    p.add_argument("--breaker-threshold", type=int, default=3)
    p.add_argument("--breaker-reset-ms", type=float, default=250.0)
    p.add_argument("--workers", type=int, default=2,
                   help="pool size for the worker-pool phase")
    p.add_argument("--device", default="cuda",
                   help="torch device of the drill's models (default cuda)")
    p.add_argument("--run-dir", default=None,
                   help="write the run ledger + Prometheus metrics here "
                        "(default: BIGDL_TPU_RUN_DIR if set)")
    p.add_argument("--fleet-smoke", action="store_true",
                   help="run only the multi-tenant fleet phase (12)")
    args = p.parse_args(argv)

    if args.run_dir:
        run_ledger.set_run_dir(args.run_dir)

    if args.fleet_smoke:
        failures: List[str] = []
        print("phase 12: multi-tenant fleet "
              "(noisy neighbor + worker kill)")
        _fleet_phase(args, args.device, failures)
        if failures:
            print(f"\nserve-drill: {len(failures)} check(s) FAILED")
            return 1
        print("\nserve-drill (fleet smoke): all checks passed")
        return 0

    device = args.device
    delay = args.forward_delay_ms / 1e3
    bsz = args.batch_size
    rng = np.random.RandomState(0)
    failures: List[str] = []
    FaultInjector.clear()

    clf, model = _drill_classifier(bsz, delay, device)
    server = InferenceServer(clf,
                             queue_capacity=64 * bsz,
                             max_delay_s=delay / 2,
                             breaker_threshold=args.breaker_threshold,
                             breaker_reset_s=args.breaker_reset_ms / 1e3,
                             forward_retries=0,
                             metrics_port=0,     # live /metrics endpoint
                             slo_min_samples=8,
                             device=device)
    accepted = []           # every future submit() ever returned

    try:
        # -- 1. healthy traffic, against the eager forward; the live
        # /metrics endpoint scraped while the waves are in flight
        print("phase 1: healthy traffic")
        rows = _rows(rng, 2 * bsz)
        waves = _wave(server, rows)
        accepted += waves
        from bigdl_tpu_torch.observability.live import scrape as _scrape
        scrape = _scrape(server.metrics_url)
        _expect(scrape is not None and "bigdl_tpu_" in scrape,
                "live /metrics endpoint served Prometheus text "
                "mid-traffic", failures)
        got = [f.result(timeout=10) for f in waves]
        _expect(got == _eager(model, rows),
                f"{len(rows)} healthy requests: ordered predictions "
                "match the eager forward", failures)

        # -- 2. malformed rows are rejected at the door
        print("phase 2: malformed rows")
        bad = 0
        for shape in ((FEATURES + 1,), (2, FEATURES + 3)):
            try:
                server.submit(np.zeros(shape, np.float32))
            except InvalidRequestError:
                bad += 1
        _expect(bad == 2, "2 malformed rows rejected with "
                "InvalidRequestError at submit()", failures)

        # -- 3. provably unmeetable deadlines shed at admission
        print("phase 3: unmeetable deadlines")
        shed = 0
        for r in _rows(rng, 2):
            try:
                server.submit(r, deadline_s=delay / 100.0)
            except DeadlineUnmeetableError:
                shed += 1
        _expect(shed == 2, "2 sub-floor deadlines shed with "
                "DeadlineUnmeetableError", failures)

        # -- 4. a pack fault fails only its batch, not the breaker
        print("phase 4: injected pack fault")
        FaultInjector.install(FaultInjector().add("serve.pack", count=1))
        wave = _wave(server, _rows(rng, bsz))
        accepted += wave
        oc = _outcomes(wave)
        _expect(oc["errors"].get("PackFailedError", 0) == bsz,
                f"pack fault: all {bsz} requests failed with "
                "PackFailedError", failures)
        _expect(server.breaker.state == "closed",
                "pack fault did not touch the circuit breaker", failures)

        # -- 5. consecutive forward faults open the breaker
        print("phase 5: injected forward faults")
        FaultInjector.install(FaultInjector().add(
            "serve.forward", count=args.breaker_threshold))
        faulted = 0
        for _ in range(args.breaker_threshold):
            wave = []
            for r in _rows(rng, bsz):
                try:
                    wave.append(server.submit(r))
                except BreakerOpenError:
                    faulted += 1        # breaker already open: sync shed
            accepted += wave
            oc = _outcomes(wave)
            faulted += oc["errors"].get("ForwardFailedError", 0) \
                + oc["errors"].get("BreakerOpenError", 0)
        _expect(faulted == args.breaker_threshold * bsz,
                f"{args.breaker_threshold} faulted batches: every "
                "request failed fast with a typed error", failures)
        _expect(server.breaker.state == "open",
                f"breaker opened after {args.breaker_threshold} "
                "consecutive forward failures", failures)
        _expect(server.slo.burn_count >= 1,
                "fault phase drove the SLO burn rate over threshold "
                f"(slo.burn x{server.slo.burn_count} on the ledger)",
                failures)

        # -- 6. while open, submissions fast-fail
        print("phase 6: fast-fail while open")
        fast = 0
        for r in _rows(rng, 3):
            try:
                server.submit(r)
            except BreakerOpenError:
                fast += 1
        _expect(fast == 3, "3 submissions fast-failed with "
                "BreakerOpenError while open", failures)

        # -- 7. cooldown, half-open probe, recovery
        print("phase 7: recovery")
        FaultInjector.clear()
        time.sleep(args.breaker_reset_ms / 1e3 + 0.02)
        wave = _wave(server, _rows(rng, bsz))
        accepted += wave
        oc = _outcomes(wave)
        _expect(oc["ok"] == bsz and server.breaker.state == "closed",
                "half-open probe succeeded: breaker closed, traffic "
                "recovered", failures)

        # -- 8. overload burst with tight deadlines: 6 batches of work,
        # each taking at least the delay; a deadline of 2.5 delays covers
        # the first batch and is provably blown by the 4th
        print("phase 8: overload expiry")
        burst = _wave(server, _rows(rng, 6 * bsz), deadline_s=2.5 * delay)
        accepted += burst
        oc = _outcomes(burst)
        expired = oc["errors"].get("DeadlineExceededError", 0)
        _expect(oc["ok"] >= bsz,
                f"overload head served ({oc['ok']} ok)", failures)
        _expect(expired >= bsz,
                f"overload tail expired before dispatch ({expired} "
                "DeadlineExceededError)", failures)
        _expect(oc["ok"] + expired == len(burst),
                "every burst request reached ok or expired — no other "
                "casualties", failures)

        # -- 9. graceful drain
        print("phase 9: graceful drain")
        joined = server.drain(timeout=10)
        _expect(joined, "drain joined the worker", failures)
        _expect(server.queue.depth == 0, "queue empty after drain",
                failures)
        _expect(all(f.done() for f in accepted),
                f"all {len(accepted)} accepted requests reached a "
                "terminal state (zero lost)", failures)

        print(f"phase 10: worker pool ({args.workers} workers)")
        _pool_phase(args, rng, device, failures)

        print("phase 11: paged KV generation flood")
        _paged_phase(rng, device, failures)
        print("phase 12: multi-tenant fleet "
              "(noisy neighbor + worker kill)")
        _fleet_phase(args, device, failures)
    finally:
        FaultInjector.clear()
        server.drain(timeout=10)

    st = server.stats()
    print("\n-- drill summary --")
    for k in sorted(st["counters"]):
        print(f"  {k:<28} {int(st['counters'][k])}")
    print(f"  batches dispatched           {st['batches']}")
    print(f"  ok latency p50/p95/p99       "
          f"{st['latency_p50_s'] * 1e3:.1f} / "
          f"{st['latency_p95_s'] * 1e3:.1f} / "
          f"{st['latency_p99_s'] * 1e3:.1f} ms")
    led = run_ledger.get_ledger()
    if led is not None:
        run_ledger.flush()
        print(f"\nledger: {led.dir} — render with "
              f"`python -m bigdl_tpu_torch.cli run-report {led.dir}`")
    if failures:
        print(f"\nserve-drill: {len(failures)} check(s) FAILED")
        return 1
    print("\nserve-drill: all checks passed")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
