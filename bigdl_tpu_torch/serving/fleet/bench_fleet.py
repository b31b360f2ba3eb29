"""Fleet serving benchmark (``bigdl_tpu/serving/fleet/bench_fleet.py``):

    python -m bigdl_tpu_torch.cli bench-serve --fleet [--smoke]
        [--device cuda|cpu] [--out PATH]

Two tenants with a long-tail traffic mix:

* **chat**: bursty interactive traffic (a lull, a flood well past one
  worker's capacity, a cool-down), weight 3, a tight deadline class;
* **embed**: steady background traffic, weight 1, relaxed deadlines.

Three measured runs over the same seeded arrival plan:

1. **autoscaled**: every tenant starts at ``min_workers`` and the control
   loop grows chat through the burst and shrinks it after.  Gate: both
   tenants' deadline hit rates meet their SLO target.
2. **static peak**: every tenant pinned at its peak allocation for the
   whole run.  Gate: the autoscaled run's worker-seconds come in under
   0.8x static peak's.
3. **noisy neighbour**: chat is flooded far past its queue; every shed is
   typed ``QueueFullError`` and attributed to chat, and embed keeps its
   deadline hit rate within budget.

Correctness gate: a fixed probe wave per tenant through the fleet equals a
single-tenant ``InferenceServer`` of the same model.  Each forward sleeps a
fixed ``--delay-ms``, so capacity and deadlines are multiples of it on any
host.  The models run on ``--device`` (CUDA by default, the CPU when
asked).  The result is printed as JSON and written to ``--out`` when given;
the exit code is 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np


def _slow_classifier(seed: int, features: int, classes: int,
                     batch: int, delay_s: float, device):
    """A ``DLClassifier`` whose forward takes a fixed, known time."""
    import bigdl_tpu_torch.nn as nn
    from bigdl_tpu_torch.api import DLClassifier

    m = nn.Sequential()
    m.add(nn.Linear(features, classes))
    m.add(nn.LogSoftMax())
    m.reset(seed)

    class Slow(DLClassifier):
        def _run(self, x):
            time.sleep(delay_s)
            return super()._run(x)

    return Slow(m, batch_shape=(batch, features), device=device), m


def _outcomes(futs: List, timeout_s: float = 60.0) -> Dict[str, int]:
    # the wait is bounded: a future still pending past the deadline is a
    # lost request and counts failed, never blocks the bench
    from concurrent.futures import TimeoutError as FutureTimeout
    out = {"ok": 0, "expired": 0, "failed": 0}
    deadline = time.monotonic() + timeout_s
    for f in futs:
        try:
            exc = f.exception(
                timeout=max(0.0, deadline - time.monotonic()))
        except FutureTimeout:
            out["failed"] += 1
            continue
        if exc is None:
            out["ok"] += 1
        elif type(exc).__name__ == "DeadlineExceededError":
            out["expired"] += 1
        else:
            out["failed"] += 1
    return out


def _drive(fleet, plan, features: Dict[str, int],
           classes: Dict[str, dict], seed: int,
           sample_allocs: Optional[dict] = None):
    """Submit the seeded arrival plan, a list of ``(duration_s,
    {tenant: rows_per_s})`` phases; returns ``(futures, sheds)`` by tenant.
    ``sample_allocs`` collects each tenant's largest allocation seen."""
    from bigdl_tpu_torch.serving.errors import ShedError

    rng = np.random.RandomState(seed)
    futs: Dict[str, List] = {n: [] for n in features}
    sheds: Dict[str, int] = {n: 0 for n in features}
    carry: Dict[str, float] = {n: 0.0 for n in features}
    tick = 0.02
    for dur, rates in plan:
        end = time.monotonic() + dur
        while time.monotonic() < end:
            t0 = time.monotonic()
            for name, rps in rates.items():
                carry[name] += rps * tick
                n = int(carry[name])
                carry[name] -= n
                for _ in range(n):
                    row = rng.rand(features[name]).astype(np.float32)
                    try:
                        futs[name].append(fleet.submit(
                            name, row, **classes.get(name, {})))
                    except ShedError:
                        sheds[name] += 1
            if sample_allocs is not None:
                allocs = fleet.stats()["allocations"]
                for name, wids in allocs.items():
                    sample_allocs[name] = max(
                        sample_allocs.get(name, 0), len(wids))
            time.sleep(max(0.0, tick - (time.monotonic() - t0)))
    return futs, sheds


def _wait(futs: Dict[str, List], timeout: float = 120.0) -> None:
    from concurrent.futures import wait as fwait
    for fs in futs.values():
        if fs:
            fwait(fs, timeout=timeout)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        "bench-fleet",
        description="two-tenant autoscaled fleet vs static peak "
                    "provisioning, and noisy-neighbour isolation")
    ap.add_argument("--delay-ms", type=float, default=10.0,
                    help="fixed per-batch forward time")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lull-s", type=float, default=3.0)
    ap.add_argument("--burst-s", type=float, default=2.0)
    ap.add_argument("--cool-s", type=float, default=3.0)
    ap.add_argument("--low-rps", type=float, default=60.0)
    ap.add_argument("--burst-rps", type=float, default=1400.0)
    ap.add_argument("--flood", type=int, default=3000,
                    help="noisy-neighbour flood size (rows)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="short phases")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tenants' models")
    ap.add_argument("--out", default=None,
                    help="write the result JSON here (default: nothing "
                         "is written)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.lull_s, args.burst_s, args.cool_s = 0.8, 0.9, 0.8
        args.flood = 1200

    from bigdl_tpu_torch.serving.errors import QueueFullError, ShedError
    from bigdl_tpu_torch.serving.fleet import FleetServer, TenantSpec
    from bigdl_tpu_torch.serving.server import InferenceServer

    device = args.device
    delay = args.delay_ms / 1e3
    bsz = args.batch
    CHAT_F, EMBED_F = 6, 4
    # deadlines in forward-time multiples: only a real backlog, not
    # scheduler jitter, misses them
    chat_ddl, embed_ddl = 120 * delay, 240 * delay
    SLO = 0.9
    PEAK_CHAT, PEAK_EMBED = 3, 1       # the static hand-provisioned peak

    def specs(chat_min, chat_max, embed_min, embed_max,
              chat_queue=8192):
        chat_clf, _ = _slow_classifier(1, CHAT_F, 3, bsz, delay, device)
        embed_clf, _ = _slow_classifier(2, EMBED_F, 5, bsz, delay, device)
        return [
            TenantSpec("chat", classifier=chat_clf, weight=3,
                       batch_buckets=[max(1, bsz // 2), bsz],
                       priority_classes=("interactive", "batch"),
                       deadline_classes={"interactive": chat_ddl},
                       slo_target=SLO, slo_window=512,
                       min_workers=chat_min, max_workers=chat_max,
                       queue_capacity=chat_queue),
            TenantSpec("embed", classifier=embed_clf, weight=1,
                       batch_buckets=[max(1, bsz // 2), bsz],
                       deadline_classes={"relaxed": embed_ddl},
                       slo_target=SLO, slo_window=512,
                       min_workers=embed_min, max_workers=embed_max,
                       queue_capacity=8192),
        ]

    features = {"chat": CHAT_F, "embed": EMBED_F}
    classes = {"chat": dict(priority_class="interactive",
                            deadline_class="interactive"),
               "embed": dict(deadline_class="relaxed")}
    plan = [(args.lull_s, {"chat": args.low_rps, "embed": args.low_rps}),
            (args.burst_s, {"chat": args.burst_rps,
                            "embed": args.low_rps}),
            (args.cool_s, {"chat": args.low_rps, "embed": args.low_rps})]
    total_s = args.lull_s + args.burst_s + args.cool_s
    print(f"bench-fleet: forward {args.delay_ms:.0f}ms x batch {bsz} "
          f"(~{bsz / delay:.0f} rows/s/worker), burst "
          f"{args.burst_rps:.0f} rows/s for {args.burst_s:.1f}s of "
          f"{total_s:.1f}s total, device {device}")

    def hit_rate(futs):
        oc = _outcomes(futs)
        n = len(futs)
        return (oc["ok"] / n if n else 1.0), oc

    # -- 1. autoscaled run -------------------------------------------------
    fleet = FleetServer(specs(1, PEAK_CHAT, 1, PEAK_EMBED),
                        max_workers=PEAK_CHAT + PEAK_EMBED,
                        autoscale=True,
                        autoscaler_kwargs=dict(
                            interval_s=0.05, burn_hi=1.0, burn_lo=0.2,
                            backlog_hi=1.5, backlog_lo=0.5,
                            grow_after=2, shrink_after=6,
                            cooldown_s=0.3), device=device)
    peaks: Dict[str, int] = {}
    futs, sheds_auto = _drive(fleet, plan, features, classes, args.seed,
                              sample_allocs=peaks)
    _wait(futs)
    ws_auto = fleet.worker_seconds()
    scale_events = fleet.autoscaler.actions
    # the probe: fixed rows, no deadline, held against a single-tenant
    # server below
    rng = np.random.RandomState(99)
    probe = {n: [rng.rand(features[n]).astype(np.float32)
                 for _ in range(4 * bsz)] for n in features}
    probe_preds = {n: [int(fleet.submit(n, r).result(timeout=60))
                       for r in probe[n]] for n in probe}
    auto = {}
    for name in features:
        hr, oc = hit_rate(futs[name])
        auto[name] = dict(requests=len(futs[name]), hit_rate=hr, **oc,
                          sheds=sheds_auto[name],
                          peak_workers=peaks.get(name, 1),
                          slo=fleet.registry.get(name).slo.snapshot())
        print(f"  autoscaled {name:>6}: {len(futs[name])} requests, "
              f"hit rate {hr * 100:.1f}% (target {SLO * 100:.0f}%), "
              f"peak {peaks.get(name, 1)} worker(s)")
    fleet.drain(timeout=30)
    print(f"  autoscaled worker-seconds: {ws_auto:.1f} "
          f"({scale_events} scale action(s))")

    # -- 2. equal to a single-tenant run of the same model ------------------
    bit_equal = True
    for spec in specs(1, PEAK_CHAT, 1, PEAK_EMBED):
        single = InferenceServer(spec.classifier,
                                 batch_buckets=list(spec.batch_buckets),
                                 device=device)
        try:
            ref = [int(single.submit(r).result(timeout=60))
                   for r in probe[spec.name]]
        finally:
            single.drain(timeout=30)
        if ref != probe_preds[spec.name]:
            bit_equal = False
            print(f"  BIT-EQUALITY FAILED for tenant {spec.name}")
    print(f"  per-tenant outputs bit-equal to single-tenant runs: "
          f"{'OK' if bit_equal else 'FAILED'}")

    # -- 3. static peak provisioning ---------------------------------------
    static_fleet = FleetServer(
        specs(PEAK_CHAT, PEAK_CHAT, PEAK_EMBED, PEAK_EMBED),
        max_workers=PEAK_CHAT + PEAK_EMBED, autoscale=False, device=device)
    futs_s, _ = _drive(static_fleet, plan, features, classes, args.seed)
    _wait(futs_s)
    ws_static = static_fleet.worker_seconds()
    static = {}
    for name in features:
        hr, oc = hit_rate(futs_s[name])
        static[name] = dict(requests=len(futs_s[name]), hit_rate=hr,
                            **oc)
        print(f"  static     {name:>6}: {len(futs_s[name])} requests, "
              f"hit rate {hr * 100:.1f}%")
    static_fleet.drain(timeout=30)
    ws_ratio = ws_auto / ws_static if ws_static > 0 else float("inf")
    print(f"  static worker-seconds: {ws_static:.1f}  ->  autoscaled / "
          f"static = {ws_ratio:.2f}x (gate < 0.8)")

    # -- 4. noisy neighbour: flood chat, embed's budget must hold -----------
    noisy = FleetServer(specs(1, 1, 1, 1, chat_queue=8 * bsz),
                        max_workers=2, autoscale=False, device=device)
    flood_futs: List = []
    flood_sheds = {"queue_full": 0, "other": 0}

    def flood():
        r = np.random.RandomState(7)
        for _ in range(args.flood):
            try:
                flood_futs.append(noisy.submit(
                    "chat", r.rand(CHAT_F).astype(np.float32),
                    priority_class="interactive"))
            except QueueFullError:
                flood_sheds["queue_full"] += 1
            except ShedError:
                flood_sheds["other"] += 1

    th = threading.Thread(target=flood)
    th.start()
    victim_plan = [(max(1.0, args.burst_s), {"embed": args.low_rps})]
    vfuts, vsheds = _drive(noisy, victim_plan, {"embed": EMBED_F},
                           {"embed": classes["embed"]}, args.seed + 1)
    th.join()
    _wait({"flood": flood_futs, **vfuts})
    victim_hr, victim_oc = hit_rate(vfuts["embed"])
    embed_sheds = vsheds["embed"]
    noisy_stats = noisy.stats()["tenants"]
    noisy.drain(timeout=30)
    sheds_typed = flood_sheds["queue_full"] > 0 \
        and flood_sheds["other"] == 0
    chat_shed_counter = noisy_stats["chat"]["counters"].get(
        "serve.shed.queue_full", 0)
    print(f"  noisy neighbor: {flood_sheds['queue_full']} typed "
          f"queue_full sheds on chat (counter sees "
          f"{int(chat_shed_counter)}), victim embed hit rate "
          f"{victim_hr * 100:.1f}% ({embed_sheds} embed sheds)")

    acceptance = {
        "slo_met_autoscaled": {n: auto[n]["hit_rate"] >= SLO
                               for n in features},
        "slo_met_static": {n: static[n]["hit_rate"] >= SLO
                           for n in features},
        "worker_seconds_ratio": ws_ratio,
        "worker_seconds_under_0p8": ws_ratio < 0.8,
        "outputs_bit_equal_to_single_tenant": bit_equal,
        "noisy_sheds_typed_and_attributed": bool(
            sheds_typed and chat_shed_counter > 0 and embed_sheds == 0),
        "victim_hit_rate": victim_hr,
        "victim_within_error_budget": victim_hr >= SLO,
        "autoscaler_acted": scale_events > 0,
    }
    holds = (all(acceptance["slo_met_autoscaled"].values())
             and acceptance["worker_seconds_under_0p8"]
             and acceptance["outputs_bit_equal_to_single_tenant"]
             and acceptance["noisy_sheds_typed_and_attributed"]
             and acceptance["victim_within_error_budget"])
    acceptance["holds"] = holds

    out = {
        "bench": "fleet_r15",
        "meta": {
            "delay_ms": args.delay_ms, "batch": bsz,
            "phases_s": [args.lull_s, args.burst_s, args.cool_s],
            "low_rps": args.low_rps, "burst_rps": args.burst_rps,
            "flood": args.flood, "slo_target": SLO,
            "peak_provision": {"chat": PEAK_CHAT, "embed": PEAK_EMBED},
            "deadline_s": {"chat": chat_ddl, "embed": embed_ddl},
            "weights": {"chat": 3, "embed": 1},
            "smoke": bool(args.smoke), "seed": args.seed,
            "platform": str(device).split(":")[0],
        },
        "autoscaled": dict(worker_seconds=ws_auto,
                           scale_actions=scale_events, tenants=auto),
        "static": dict(worker_seconds=ws_static, tenants=static),
        "noisy_neighbor": dict(
            flood_requests=args.flood,
            flood_sheds=flood_sheds,
            chat_shed_counter=int(chat_shed_counter),
            victim=dict(hit_rate=victim_hr, sheds=embed_sheds,
                        **victim_oc)),
        "acceptance": acceptance,
    }
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(f"  acceptance {'HOLDS' if holds else 'FAILED'}"
          + (f" -> {args.out}" if args.out else ""))
    return 0 if holds else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
