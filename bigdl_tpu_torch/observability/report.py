"""Offline run-ledger reader — ``python -m bigdl_tpu_torch.cli run-report
<dir>`` (``bigdl_tpu/observability/report.py``, copied whole).

It works on records alone, so it keeps every section of the reference,
the serving, SLO, memory, ingest, fleet and cost sections included, and
renders the same text and the same JSON for the same ledger.  The
reference's wording stays as it is (its "XLA" compile and cost lines
read, for the port, the kernel builds and the ATen FLOP counts).

Reconstructs, from the JSONL ledger alone, what the run spent its time
on: per-phase wall-time breakdown (exclusive span time, nested spans
subtracted from their parents), step-time percentiles (p50/p95/p99),
throughput in records/s, XLA (re)compile cost, and the resilience ledger
(skipped/retried/injected/watchdog events by kind).  The coverage figure
— top-level span time over run wall time — is the report's own honesty
check: a breakdown that explains <90% of the wall means an
uninstrumented seam is eating time.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import sys
from typing import Dict, List, Optional, Tuple


def ledger_files(run_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(run_dir, "events-*.jsonl")))


def load_ledger(run_dir: str,
                strict: bool = False) -> Tuple[List[dict], int]:
    """All records across the run directory's per-process files, each
    tagged with ``_pid``; returns ``(records, bad_line_count)``.  With
    ``strict`` a malformed line raises instead of being counted — the
    tier-1 ledger test runs strict."""
    records: List[dict] = []
    bad = 0
    for path in ledger_files(run_dir):
        m = re.search(r"events-(\d+)\.jsonl$", path)
        pid = int(m.group(1)) if m else -1
        with open(path, "r", encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    if strict:
                        raise ValueError(
                            f"{path}:{lineno}: malformed ledger line")
                    bad += 1
                    continue
                rec["_pid"] = pid
                records.append(rec)
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records, bad


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile (ceil(q/100 * n)) on an ascending list."""
    if not sorted_vals:
        return 0.0
    rank = math.ceil(q / 100.0 * len(sorted_vals))
    return sorted_vals[min(len(sorted_vals) - 1, max(0, rank - 1))]


def build_report(records: List[dict]) -> dict:
    spans = [r for r in records if r.get("type") == "span"]
    steps = [r for r in records if r.get("type") == "step"]
    events = [r for r in records if r.get("type") == "event"]
    compiles = [r for r in records if r.get("type") == "compile"]
    starts = [r for r in records if r.get("type") == "run.start"]
    ends = [r for r in records if r.get("type") == "run.end"]

    # -- run windows: pair each run.start with the next run.end of the
    # same pid.  A killed run (start without end — the crash-recovery
    # case) contributes its spans to the breakdown but NOT to wall or
    # coverage, so a kill-and-relaunch directory still reports an honest
    # coverage for the runs that completed.
    windows = []                      # (pid, thread, mono0, mono1)
    by_pid_starts: Dict[int, List[dict]] = {}
    for s in sorted(starts, key=lambda r: r.get("mono", 0.0)):
        by_pid_starts.setdefault(s["_pid"], []).append(s)
    by_pid_ends: Dict[int, List[dict]] = {}
    for e in ends:
        by_pid_ends.setdefault(e["_pid"], []).append(e)
    for pid, pid_starts in by_pid_starts.items():
        for i, s in enumerate(pid_starts):
            # a start superseded by another start of the same pid before
            # any end is a CRASHED run — it must not steal the relaunch's
            # run.end and report a wall spanning both runs
            limit = (pid_starts[i + 1]["mono"]
                     if i + 1 < len(pid_starts) else float("inf"))
            cands = [e for e in by_pid_ends.get(pid, [])
                     if s.get("mono", 0.0) <= e.get("mono", 0.0) < limit]
            if cands:
                e = min(cands, key=lambda r: r["mono"])
                by_pid_ends[pid].remove(e)
                windows.append((pid, s.get("thread"), s["mono"],
                                e["mono"]))
    wall = sum(t1 - t0 for _, _, t0, t1 in windows)
    if wall == 0.0 and records:
        monos = [r["mono"] for r in records if "mono" in r]
        if monos:
            wall = max(monos) - min(monos)

    # -- per-phase breakdown: exclusive time (children subtracted)
    child_time: Dict[Tuple[int, int], float] = {}
    for sp in spans:
        parent = sp.get("parent")
        if parent is not None:
            key = (sp["_pid"], parent)
            child_time[key] = child_time.get(key, 0.0) + sp.get("dur_s", 0.0)
    phases: Dict[str, dict] = {}
    for sp in spans:
        name = sp.get("name", "?")
        p = phases.setdefault(name, {"count": 0, "total_s": 0.0,
                                     "exclusive_s": 0.0, "errors": 0})
        dur = sp.get("dur_s", 0.0)
        p["count"] += 1
        p["total_s"] += dur
        p["exclusive_s"] += max(
            0.0, dur - child_time.get((sp["_pid"], sp.get("span")), 0.0))
        if sp.get("error"):
            p["errors"] += 1

    # -- coverage: top-level main-thread span time inside each complete
    # run's window, over the summed window lengths
    coverage = None
    if wall > 0 and windows:
        covered = 0.0
        for pid, thread, t0, t1 in windows:
            covered += sum(
                sp.get("dur_s", 0.0) for sp in spans
                if sp["_pid"] == pid and "parent" not in sp
                and sp.get("thread") == thread
                and t0 <= sp.get("mono", -1.0) <= t1)
        coverage = covered / wall

    # -- step statistics
    durs = sorted(float(s.get("dur_s", 0.0)) for s in steps)
    total_records = sum(int(s.get("records", 0)) for s in steps)
    total_step_time = sum(durs)
    step_stats = {
        "count": len(steps),
        "p50_s": _percentile(durs, 50),
        "p95_s": _percentile(durs, 95),
        "p99_s": _percentile(durs, 99),
        "mean_s": total_step_time / len(durs) if durs else 0.0,
        "records": total_records,
        "records_per_s": (total_records / total_step_time
                          if total_step_time > 0 else 0.0),
        "skipped": sum(1 for s in steps if s.get("skipped")),
    }

    # -- resilience ledger: events by kind
    by_kind: Dict[str, int] = {}
    for ev in events:
        kind = ev.get("kind", "?")
        by_kind[kind] = by_kind.get(kind, 0) + 1

    comp = {"count": len(compiles),
            "total_s": sum(float(c.get("dur_s", 0.0)) for c in compiles)}

    # -- overlapping I/O (``io`` records): producer-side time that
    # already sits inside some span's duration, reported separately so
    # the phase breakdown never double-counts it
    io: Dict[str, dict] = {}
    for r in records:
        if r.get("type") == "io":
            entry = io.setdefault(r.get("name", "?"),
                                  {"count": 0, "total_s": 0.0,
                                   "records": 0})
            entry["count"] += 1
            entry["total_s"] += float(r.get("dur_s", 0.0))
            entry["records"] += int(r.get("records", 0))

    scalars: Dict[str, int] = {}
    for r in records:
        if r.get("type") == "scalar":
            tag = f"{r.get('src', '?')}/{r.get('tag', '?')}"
            scalars[tag] = scalars.get(tag, 0) + 1

    # -- serving (``serving/server.py``): per-request outcomes, batch
    # occupancy, shed census and breaker transitions for an online-
    # serving run (or a ``serve-drill``); None when the run never served
    serve_reqs = [r for r in records if r.get("type") == "serve.request"]
    serve_batches = [r for r in records if r.get("type") == "serve.batch"]
    shed_by_reason: Dict[str, int] = {}
    breaker_transitions: Dict[str, int] = {}
    for ev in events:
        if ev.get("kind") == "serve.shed":
            reason = ev.get("reason", "?")
            shed_by_reason[reason] = (shed_by_reason.get(reason, 0)
                                      + int(ev.get("count", 1)))
        elif ev.get("kind") == "serve.breaker":
            t = f"{ev.get('from', '?')}->{ev.get('to', '?')}"
            breaker_transitions[t] = breaker_transitions.get(t, 0) + 1
    serve_slots = [r for r in records if r.get("type") == "serve.slots"]
    serving = None
    if serve_reqs or serve_batches or shed_by_reason or breaker_transitions \
            or serve_slots:
        by_status: Dict[str, int] = {}
        for r in serve_reqs:
            st = r.get("status", "?")
            by_status[st] = by_status.get(st, 0) + 1
        ok_durs = sorted(float(r.get("dur_s", 0.0)) for r in serve_reqs
                         if r.get("status") == "ok")
        occs = [float(b["occupancy"]) for b in serve_batches
                if "occupancy" in b]
        # per-worker census (pool mode: serve.batch records carry a
        # worker id) — the figure that shows one faulted worker's
        # failures staying isolated from the rest of the fleet
        workers: Dict[int, dict] = {}
        for b in serve_batches:
            wid = b.get("worker")
            if wid is None:
                continue
            w = workers.setdefault(int(wid), {"batches": 0, "rows": 0,
                                              "ok": 0, "failed": 0})
            w["batches"] += 1
            w["rows"] += int(b.get("size", 0))
            if b.get("status") == "ok":
                w["ok"] += 1
            elif b.get("status") in ("failed", "pack_failed",
                                     "breaker_open"):
                w["failed"] += 1
        # per-bucket census: how the ladder traded padding against
        # latency (mean padding efficiency = live rows / bucket rows)
        buckets: Dict[int, dict] = {}
        for b in serve_batches:
            bk = b.get("bucket")
            if bk is None:
                continue
            e = buckets.setdefault(int(bk), {"batches": 0, "rows": 0,
                                             "_eff": []})
            e["batches"] += 1
            e["rows"] += int(b.get("size", 0))
            if "padding_efficiency" in b:
                e["_eff"].append(float(b["padding_efficiency"]))
        for e in buckets.values():
            eff = e.pop("_eff")
            e["mean_padding_efficiency"] = (sum(eff) / len(eff)
                                            if eff else 0.0)
        # continuous batching (serve.slots per decode chunk): slot
        # occupancy is the generation analogue of batch occupancy
        slots = None
        if serve_slots:
            soccs = [float(s.get("occupancy", 0.0)) for s in serve_slots]
            slots = {
                "chunks": len(serve_slots),
                "tokens": sum(int(s.get("tokens", 0))
                              for s in serve_slots),
                "mean_occupancy": sum(soccs) / len(soccs),
                "capacity": max(int(s.get("slots", 0))
                                for s in serve_slots),
            }
        # paged KV (serve.pages per decode chunk): TOKEN-level occupancy
        # — the honest utilization figure; the row-occupancy number
        # above overstates it, since a row is "full" the moment any
        # request sits in it regardless of tokens actually held
        pages = None
        serve_pages = [r for r in records if r.get("type") == "serve.pages"]
        if serve_pages:
            toccs = [float(p.get("token_occupancy", 0.0))
                     for p in serve_pages]
            pages = {
                "chunks": len(serve_pages),
                "capacity_tokens": max(int(p.get("capacity_tokens", 0))
                                       for p in serve_pages),
                "pages_total": max(int(p.get("pages_total", 0))
                                   for p in serve_pages),
                "mean_token_occupancy": sum(toccs) / len(toccs),
                "peak_tokens_held": max(int(p.get("tokens_held", 0))
                                        for p in serve_pages),
                "peak_prefix_pages": max(int(p.get("prefix_pages", 0))
                                         for p in serve_pages),
            }
        # prefix cache (serve.cache per admit + evictions): page-level
        # hit rate — shared full pages over shareable full pages
        prefix = None
        cache_recs = [r for r in records if r.get("type") == "serve.cache"]
        admits = [r for r in cache_recs if r.get("event") == "admit"]
        if cache_recs:
            looked = sum(int(r.get("lookup_pages", 0)) for r in admits)
            hit = sum(int(r.get("hit_pages", 0)) for r in admits)
            prefix = {
                "admits": len(admits),
                "lookup_pages": looked,
                "hit_pages": hit,
                "hit_rate": hit / looked if looked else 0.0,
                "shared_tokens": sum(int(r.get("shared_tokens", 0))
                                     for r in admits),
                "inserted_pages": sum(int(r.get("inserted", 0))
                                      for r in admits),
                "evicted_pages": sum(int(r.get("pages", 0))
                                     for r in cache_recs
                                     if r.get("event") == "evict"),
            }
        # speculative decoding (serve.spec per chunk): draft accept rate
        spec = None
        spec_recs = [r for r in records if r.get("type") == "serve.spec"]
        if spec_recs:
            proposed = sum(int(r.get("proposed", 0)) for r in spec_recs)
            accepted = sum(int(r.get("accepted", 0)) for r in spec_recs)
            spec = {
                "chunks": len(spec_recs),
                "proposed": proposed,
                "accepted": accepted,
                "accept_rate": accepted / proposed if proposed else 0.0,
                "emitted": sum(int(r.get("emitted", 0))
                               for r in spec_recs),
            }
        serving = {
            "requests": by_status,
            "request_count": len(serve_reqs),
            "latency": {"p50_s": _percentile(ok_durs, 50),
                        "p95_s": _percentile(ok_durs, 95),
                        "p99_s": _percentile(ok_durs, 99)},
            "batches": {"count": len(serve_batches),
                        "rows": sum(int(b.get("size", 0))
                                    for b in serve_batches),
                        "mean_occupancy": (sum(occs) / len(occs)
                                           if occs else 0.0)},
            "workers": workers,
            "buckets": buckets,
            "slots": slots,
            "pages": pages,
            "prefix": prefix,
            "spec": spec,
            "shed": shed_by_reason,
            "breaker": breaker_transitions,
        }

    # -- multi-tenant fleet (``serving/fleet``): per-tenant census
    # over the tenant-tagged ``serve.*`` records plus the
    # ``fleet.dispatch`` stream and ``fleet.register`` /
    # ``fleet.scale`` / ``fleet.reap`` / ``fleet.deregister`` events —
    # one run directory holding N tenants stays attributable per
    # tenant.  ``None`` when the run never served a fleet.
    fleet = None
    fleet_dispatches = [r for r in records
                        if r.get("type") == "fleet.dispatch"]
    fleet_events = [ev for ev in events
                    if str(ev.get("kind", "")).startswith("fleet.")]
    fleet_runs = [r for r in records if r.get("type") == "run.end"
                  and r.get("kind") == "FleetServer"]
    if fleet_dispatches or fleet_events or fleet_runs:
        tenants: Dict[str, dict] = {}

        def _tenant(name) -> dict:
            return tenants.setdefault(str(name), {
                "kind": None, "weight": None, "requests": {},
                "sheds": {}, "dispatches": 0, "rows": 0,
                "scale_up": 0, "scale_down": 0, "reaped": 0,
                "registered": 0, "deregistered": 0})

        for ev in fleet_events:
            tn = ev.get("tenant")
            if tn is None:
                continue
            t = _tenant(tn)
            k = ev.get("kind")
            if k == "fleet.register":
                t["registered"] += 1
                t["kind"] = ev.get("tenant_kind", t["kind"])
                t["weight"] = ev.get("weight", t["weight"])
            elif k == "fleet.deregister":
                t["deregistered"] += 1
            elif k == "fleet.scale":
                if ev.get("direction") == "up":
                    t["scale_up"] += 1
                else:
                    t["scale_down"] += 1
            elif k == "fleet.reap":
                t["reaped"] += 1
        for r in fleet_dispatches:
            t = _tenant(r.get("tenant", "?"))
            t["dispatches"] += 1
            t["rows"] += int(r.get("size", 0))
        for r in serve_reqs:
            tn = r.get("tenant")
            if tn is None:
                continue
            st = str(r.get("status", "?"))
            reqs = _tenant(tn)["requests"]
            reqs[st] = reqs.get(st, 0) + 1
        for ev in events:
            if ev.get("kind") == "serve.shed" and ev.get("tenant"):
                sheds = _tenant(ev["tenant"])["sheds"]
                reason = str(ev.get("reason", "?"))
                sheds[reason] = sheds.get(reason, 0) \
                    + int(ev.get("count", 1))
        fleet = {
            "tenants": tenants,
            "dispatches": len(fleet_dispatches),
            "scale_events": sum(t["scale_up"] + t["scale_down"]
                                for t in tenants.values()),
            "reaps": sum(t["reaped"] for t in tenants.values()),
            "worker_seconds": (float(fleet_runs[-1]
                                     .get("worker_seconds", 0.0))
                               if fleet_runs else None),
        }

    # -- ingest pipeline (``dataset/sharded`` + ``dataset/staging``):
    # per-stage busy time, records and effective capacity from the
    # ``ingest.*`` spans.  Stages run CONCURRENTLY (worker processes,
    # ring threads), so the honest per-stage figure is capacity —
    # records per second of busy time times the number of lanes
    # (distinct pid/thread pairs) that produced spans — and the BOUND
    # stage is the one with the lowest capacity: the stage a tuning
    # pass should attack first.  ``None`` when the run never ingested
    # through the sharded pipeline.
    ingest = None
    ing_spans = [sp for sp in spans
                 if str(sp.get("name", "")).startswith("ingest.")]
    if ing_spans:
        stages: Dict[str, dict] = {}
        for sp in ing_spans:
            st = stages.setdefault(sp["name"],
                                   {"count": 0, "busy_s": 0.0,
                                    "records": 0, "_lanes": set(),
                                    "errors": 0})
            st["count"] += 1
            st["busy_s"] += float(sp.get("dur_s", 0.0))
            st["records"] += int((sp.get("attrs") or {}).get("records", 0))
            st["_lanes"].add((sp["_pid"], sp.get("thread")))
            if sp.get("error"):
                st["errors"] += 1
        for st in stages.values():
            lanes = len(st.pop("_lanes"))
            st["lanes"] = lanes
            st["rate_per_lane"] = (st["records"] / st["busy_s"]
                                   if st["busy_s"] > 0 else 0.0)
            st["capacity_records_per_s"] = st["rate_per_lane"] * lanes
        rated = {k: v for k, v in stages.items()
                 if v["records"] > 0 and v["busy_s"] > 0}
        bound = (min(rated, key=lambda k:
                     rated[k]["capacity_records_per_s"])
                 if rated else None)
        ingest = {"stages": stages, "bound_stage": bound}

    # -- resident param bytes by dtype (``mem.params`` records from the
    # serving stack — DLClassifier / ContinuousGenerator quantization):
    # the ledger-backed footprint figure behind every int8 residency
    # claim (docs/performance.md).  Latest record per kind wins.
    param_bytes: Dict[str, dict] = {}
    for r in records:
        if r.get("type") == "mem.params":
            param_bytes[str(r.get("kind", "?"))] = {
                "bytes_by_dtype": r.get("bytes_by_dtype", {}),
                "total_bytes": int(r.get("total_bytes", 0)),
                "mode": r.get("mode"),
            }

    # -- device cost attribution (``cost.analysis`` records — the train
    # step, every serving bucket rung, the bench forwards): FLOPs, bytes
    # accessed and achieved intensity per compiled executable, the
    # roofline-style table that quantifies what e.g. the int8 kernels
    # buy.  Latest record per label wins.
    costs: Dict[str, dict] = {}
    for r in records:
        if r.get("type") == "cost.analysis":
            costs[str(r.get("label", "?"))] = {
                "flops": float(r.get("flops", 0.0)),
                "bytes_accessed": float(r.get("bytes_accessed", 0.0)),
                "output_bytes": float(r.get("output_bytes", 0.0)),
                "intensity_flops_per_byte":
                    float(r.get("intensity_flops_per_byte", 0.0)),
                "quantize": r.get("quantize"),
            }

    # -- HBM high watermark (``mem.hbm`` per-step samples; absent on
    # backends without memory_stats)
    hbm = None
    hbm_samples = [r for r in records if r.get("type") == "mem.hbm"]
    if hbm_samples:
        peaks = [int(r.get("peak_bytes", 0)) for r in hbm_samples]
        hbm = {"samples": len(hbm_samples),
               "peak_bytes": max(peaks),
               "mean_bytes_in_use": (sum(int(r.get("bytes_in_use", 0))
                                         for r in hbm_samples)
                                     / len(hbm_samples))}

    # -- SLO tracking (``slo.burn`` events from the serving layer's
    # sliding-window deadline-hit-rate tracker + the triggered trace
    # captures they fired)
    slo = None
    burns = [r for r in records if r.get("type") == "slo.burn"]
    captures = [r for r in records if r.get("type") == "trace.capture"]
    if burns or captures:
        slo = {"burn_events": len(burns),
               "max_burn_rate": max((float(r.get("burn", 0.0))
                                     for r in burns), default=0.0),
               "min_hit_rate": min((float(r.get("hit_rate", 1.0))
                                    for r in burns), default=1.0),
               "target": burns[-1].get("target") if burns else None,
               "captures": len(captures),
               "capture_paths": [r.get("path") for r in captures
                                 if r.get("path")]}

    # -- trace identity (``trace.bind``: one per per-pid file) and the
    # cross-process stitch census trace-export works from
    trace_ids = sorted({str(r.get("trace")) for r in records
                        if r.get("type") == "trace.bind" and r.get("trace")})
    link_edges = sum(1 for r in spans if "link" in r)

    # -- lint gate (graftlint): did the static-analysis gate run for
    # this run directory, and what did it say?  Latest event wins.
    lint = None
    for r in records:
        if r.get("type") == "lint.run":
            lint = {"runs": (lint or {}).get("runs", 0) + 1,
                    "findings": int(r.get("findings", 0)),
                    "baselined": int(r.get("baselined", 0)),
                    "suppressed": int(r.get("suppressed", 0)),
                    "files": int(r.get("files", 0)),
                    "errors": int(r.get("errors", 0)),
                    "clean": bool(r.get("clean", False)),
                    "per_rule": r.get("per_rule", {}),
                    "tiers": r.get("tiers", {})}

    # -- kernel tuning (``tune.run`` records from ``cli tune`` /
    # ``ops/tuning.py``): what was swept vs served from cache, and what
    # the winners bought over the hand-picked fallback tiles.  Latest
    # record wins per field; winners merge across records.
    tuning = None
    tune_runs = [r for r in records if r.get("type") == "tune.run"]
    if tune_runs:
        winners: Dict[str, dict] = {}
        ops: set = set()
        for r in tune_runs:
            ops.update(r.get("ops", []))
            for k, v in (r.get("winners") or {}).items():
                winners[str(k)] = {"tiles": v.get("tiles", []),
                                   "speedup": float(v.get("speedup",
                                                          1.0))}
        speedups = [w["speedup"] for w in winners.values()]
        tuning = {
            "runs": len(tune_runs),
            "platform": tune_runs[-1].get("platform"),
            "ops": sorted(ops),
            "swept": sum(int(r.get("swept", 0)) for r in tune_runs),
            "cache_hits": sum(int(r.get("cache_hits", 0))
                              for r in tune_runs),
            "winners": winners,
            "mean_speedup": (sum(speedups) / len(speedups)
                             if speedups else 1.0),
            "max_speedup": max(speedups, default=1.0),
            "store": tune_runs[-1].get("store"),
        }

    # -- mesh topology: the trainer/serving mesh shape + analytic
    # per-axis collective bytes (mesh.topology events; latest per mode)
    mesh = {}
    for r in records:
        if r.get("type") == "mesh.topology":
            mesh[r.get("mode", "?")] = {
                "axes": r.get("axes", {}),
                "devices": r.get("devices"),
                "collective_bytes": r.get("collective_bytes", {})}

    # -- elasticity census (``elastic.*`` events from the membership
    # coordinator + the trainers' reshape path, ``resilience/elastic.py``):
    # how often the fleet changed shape and what each change cost.
    # ``None`` when the run never ran elastic.
    elastic = None
    el = [e for e in events
          if str(e.get("kind", "")).startswith("elastic.")]
    if el:
        gens = [e for e in el if e.get("kind") == "elastic.generation"]
        elastic = {
            "generations": len(gens),
            "max_generation": max((int(e.get("gen", 0)) for e in gens),
                                  default=0),
            "final_world": (int(gens[-1].get("world", 0))
                            if gens else None),
            "hosts_lost": sum(1 for e in el
                              if e.get("kind") == "elastic.lease_lost"),
            "hosts_joined": sum(1 for e in el
                                if e.get("kind") == "elastic.join"),
            "reshapes": sum(1 for e in el
                            if e.get("kind") == "elastic.reshape"),
            "restores": sum(1 for e in el
                            if e.get("kind") == "elastic.restore"),
            "steps_replayed": sum(int(e.get("replayed_steps", 0))
                                  for e in el
                                  if e.get("kind") == "elastic.resume"),
            "watchdog_pauses": by_kind.get("watchdog.paused", 0),
            "fenced": sum(1 for e in el
                          if e.get("kind") == "elastic.fenced"),
        }

    # -- cross-host fleet census (``fleet.host.*`` events from the
    # serving cluster, ``serving/fleet/cluster.py``): which hosts
    # carried the fleet, what host loss cost (re-placements, salvaged
    # request files) and how often dispatch crossed hosts (spills).
    # ``None`` when the run never served cross-host.
    fleet_hosts = None
    fh = [e for e in events
          if str(e.get("kind", "")).startswith("fleet.host.")]
    if fh:
        lost_events = [e for e in fh
                       if e.get("kind") == "fleet.host.lost"]
        gens = [e for e in events
                if e.get("kind") == "elastic.generation"]
        spill_by_reason: Dict[str, int] = {}
        for e in fh:
            if e.get("kind") == "fleet.host.spill":
                reason = str(e.get("reason", "?"))
                spill_by_reason[reason] = \
                    spill_by_reason.get(reason, 0) + 1
        fleet_hosts = {
            "hosts_joined": len({e.get("host") for e in fh
                                 if e.get("kind") == "fleet.host.join"}),
            "hosts_lost": len({e.get("host") for e in lost_events}),
            "generations": len(gens),
            "max_generation": max((int(e.get("gen", 0)) for e in gens),
                                  default=0),
            "placements": sum(1 for e in fh
                              if e.get("kind") == "fleet.host.place"
                              and e.get("action") == "register"),
            "evictions": sum(1 for e in fh
                             if e.get("kind") == "fleet.host.place"
                             and e.get("action") == "deregister"),
            "spills": sum(spill_by_reason.values()),
            "spill_by_reason": spill_by_reason,
            "salvaged": sum(int(e.get("salvaged", 0))
                            for e in lost_events),
        }

    # -- rollout census: the durable ``rollout.*`` transition
    # trail from ``serving/fleet/rollout.py`` — which versions the
    # controller saw, how canaries were judged, how many traffic-shift
    # steps ran, and what was promoted vs rolled back (including
    # recovery resumes after a controller died mid-rollout).  ``None``
    # when the run never rolled a version.
    rollout = None
    ro = [e for e in events
          if str(e.get("kind", "")).startswith("rollout.")]
    if ro:
        verdicts = [e for e in ro if e.get("kind") == "rollout.verdict"]
        committed = [e for e in ro
                     if e.get("kind") == "rollout.committed"]
        versions = set()
        for e in ro:
            for key in ("target", "version"):
                try:
                    if e.get(key) is not None:
                        versions.add(int(e[key]))
                except (TypeError, ValueError):
                    pass
        resume_actions: Dict[str, int] = {}
        for e in ro:
            if e.get("kind") == "rollout.resume":
                a = str(e.get("action", "?"))
                resume_actions[a] = resume_actions.get(a, 0) + 1
        promote_times = [float(e["elapsed_s"]) for e in committed
                         if e.get("elapsed_s") is not None]
        rollout = {
            "tenants": sorted({str(e.get("tenant")) for e in ro
                               if e.get("tenant")}),
            "versions_seen": sorted(versions),
            "discovered": sum(1 for e in ro
                              if e.get("kind") == "rollout.discovered"),
            "canary_verdicts": {
                "pass": sum(1 for e in verdicts if e.get("passed")),
                "fail": sum(1 for e in verdicts if not e.get("passed")),
            },
            "shift_steps": sum(1 for e in ro
                               if e.get("kind") == "rollout.shift"),
            "promotes": len(committed),
            "rollbacks": sum(1 for e in ro
                             if e.get("kind") == "rollout.rolled_back"),
            "resumes": sum(resume_actions.values()),
            "resume_actions": resume_actions,
            "mean_time_to_promote_s": (sum(promote_times)
                                       / len(promote_times)
                                       if promote_times else None),
        }

    # -- fleet trace census: how the cross-host request bus
    # stitched.  ``bus.claim``/``bus.respond`` events and the
    # fleet.submit/fleet.dispatch/fleet.respond span vocabulary come
    # from ``serving/fleet/cluster.py``; the link figures are the same
    # stitch math trace-export prints (multi-link ``links`` lists and
    # durable claim anchors included).  ``None`` when the run never
    # touched the bus.
    fleet_trace = None
    bus_events = [e for e in events
                  if e.get("kind") in ("bus.claim", "bus.respond")]
    bus_spans = [r for r in spans
                 if str(r.get("name", "")).startswith("fleet.")
                 and r.get("name") in ("fleet.submit", "fleet.dispatch",
                                       "fleet.respond")]
    if bus_events or bus_spans:
        from bigdl_tpu_torch.observability.trace import stitch_stats
        st = stitch_stats(records)
        fleet_trace = {
            "trace_ids": trace_ids,
            "link_edges": st["link_edges"],
            "resolved_edges": st["resolved_edges"],
            "cross_pid_edges": st["cross_pid_edges"],
            "submits": sum(1 for r in bus_spans
                           if r.get("name") == "fleet.submit"),
            "claims": sum(1 for e in bus_events
                          if e.get("kind") == "bus.claim"),
            "responds": len({e.get("id") for e in bus_events
                             if e.get("kind") == "bus.respond"}),
            "redrives": sum(1 for e in bus_events
                            if e.get("kind") == "bus.claim"
                            and e.get("salvaged_from")),
        }

    # -- fleet telemetry census: the per-host heartbeat blocks
    # mirrored into the ledger (``fleet.telemetry``).  Last snapshot
    # per host wins — the flight recorder's last-known-good reading
    # for a host that never wrote ``run.end``.
    fleet_telemetry = None
    tel = [e for e in events if e.get("kind") == "fleet.telemetry"]
    if tel:
        by_host: Dict[str, dict] = {}
        for e in tel:
            by_host[str(e.get("host", "?"))] = {
                "backlog": e.get("backlog"), "slo": e.get("slo"),
                "hbm": e.get("hbm"), "resident": e.get("resident")}
        fleet_telemetry = {"samples": len(tel), "hosts": by_host}

    # -- memory census: the device-byte budget ledger
    # (``mem.budget`` from ``serving/scheduler/membudget.py``) and the
    # host-RAM offload tier's park/resume trail (``mem.offload`` from
    # the paged scheduler).  Per-tenant charged-bytes-by-class is an
    # exact replay of the charge/discharge/transfer deltas — the same
    # arithmetic the budgeter itself does — so report and budgeter
    # cannot disagree.  ``None`` when the run never charged a byte.
    memory = None
    mb = [r for r in records if r.get("type") == "mem.budget"]
    mo = [r for r in records if r.get("type") == "mem.offload"]
    if mb or mo:
        mem_tenants: Dict[str, dict] = {}

        def _mt(name) -> dict:
            return mem_tenants.setdefault(str(name), {
                "charged": {}, "device_bytes": 0, "budget": None,
                "sheds": 0, "shed_bytes": 0, "reclaims": 0,
                "reclaimed_bytes": 0})

        for e in mb:
            t = _mt(e.get("tenant", "?"))
            a = e.get("action")
            ch = t["charged"]
            if a == "budget":
                t["budget"] = e.get("budget")
            elif a == "charge":
                c = str(e.get("cls"))
                ch[c] = ch.get(c, 0) + int(e.get("bytes", 0))
            elif a == "discharge":
                c = str(e.get("cls"))
                ch[c] = ch.get(c, 0) - int(e.get("bytes", 0))
            elif a == "transfer":
                src, dst = str(e.get("src")), str(e.get("dst"))
                n = int(e.get("bytes", 0))
                ch[src] = ch.get(src, 0) - n
                ch[dst] = ch.get(dst, 0) + n
            elif a == "shed":
                t["sheds"] += 1
                t["shed_bytes"] += int(e.get("bytes", 0))
            elif a == "reclaim":
                t["reclaims"] += 1
                t["reclaimed_bytes"] += int(e.get("bytes", 0))
            if e.get("device_bytes") is not None:
                t["device_bytes"] = int(e["device_bytes"])
        memory = {
            "tenants": mem_tenants,
            "parks": sum(1 for e in mo if e.get("action") == "park"),
            "resumes": sum(1 for e in mo
                           if e.get("action") == "resume"),
            "closes": sum(1 for e in mo if e.get("action") == "close"),
            "park_bytes": sum(int(e.get("bytes", 0)) for e in mo
                              if e.get("action") == "park"),
            "resume_bytes": sum(int(e.get("bytes", 0)) for e in mo
                                if e.get("action") == "resume"),
            "sheds": sum(t["sheds"] for t in mem_tenants.values()),
            "reclaims": sum(t["reclaims"]
                            for t in mem_tenants.values()),
        }

    return {"runs": len(starts), "completed_runs": len(windows),
            "processes": len({r["_pid"] for r in records}),
            "wall_s": wall, "coverage": coverage, "phases": phases,
            "steps": step_stats, "events": by_kind, "compile": comp,
            "io": io, "scalars": scalars, "serving": serving,
            "fleet": fleet, "fleet_hosts": fleet_hosts,
            "rollout": rollout, "fleet_trace": fleet_trace,
            "fleet_telemetry": fleet_telemetry, "memory": memory,
            "param_bytes": param_bytes,
            "ingest": ingest, "lint": lint, "mesh": mesh,
            "elastic": elastic, "tuning": tuning,
            "costs": costs, "hbm": hbm, "slo": slo,
            "trace_ids": trace_ids, "link_edges": link_edges,
            "record_count": len(records)}


def _fmt_bytes(n: int) -> str:
    return f"{n / 1e6:.2f}MB" if n >= 1e6 else f"{n / 1e3:.1f}KB"


def _param_bytes_lines(rep: dict) -> List[str]:
    """Resident-bytes-by-dtype serving lines from ``mem.params``
    records — the ledger-backed figure behind int8 footprint claims."""
    out = []
    for kind, pm in sorted(rep.get("param_bytes", {}).items()):
        parts = " + ".join(
            f"{dt} {_fmt_bytes(int(b))}"
            for dt, b in sorted(pm["bytes_by_dtype"].items()))
        mode = f", {pm['mode']}" if pm.get("mode") else ""
        out.append(f"  resident params ({kind}{mode}): {parts} = "
                   f"{_fmt_bytes(pm['total_bytes'])}")
    return out


def render_report(rep: dict) -> str:
    L = ["========== bigdl_tpu run report =========="]
    crashed = rep["runs"] - rep["completed_runs"]
    L.append(f"records: {rep['record_count']}  runs: {rep['runs']}"
             + (f" ({crashed} did not complete)" if crashed > 0 else "")
             + f"  processes: {rep['processes']}  "
             f"wall: {rep['wall_s']:.2f}s")
    if rep["coverage"] is not None:
        L.append(f"instrumented coverage: {rep['coverage'] * 100:.1f}% "
                 "of wall time (top-level spans, main thread, "
                 "completed runs)")
    if rep.get("trace_ids"):
        edges = rep.get("link_edges", 0)
        L.append(f"trace: {', '.join(rep['trace_ids'])}"
                 + (f"  ({edges} cross-boundary link(s) — "
                    "`cli trace-export` renders the stitched timeline)"
                    if edges else ""))
    L.append("")
    L.append("-- per-phase breakdown (exclusive time) --")
    wall = rep["wall_s"] or 1.0
    for name, p in sorted(rep["phases"].items(),
                          key=lambda kv: -kv[1]["exclusive_s"]):
        err = f"  errors={p['errors']}" if p["errors"] else ""
        L.append(f"  {name:<28} {p['exclusive_s']:9.3f}s "
                 f"({p['exclusive_s'] / wall * 100:5.1f}%)  "
                 f"x{p['count']}{err}")
    s = rep["steps"]
    L.append("")
    L.append("-- steps --")
    L.append(f"  count: {s['count']}  skipped: {s['skipped']}")
    L.append(f"  step time p50/p95/p99: {s['p50_s'] * 1e3:.1f} / "
             f"{s['p95_s'] * 1e3:.1f} / {s['p99_s'] * 1e3:.1f} ms "
             f"(mean {s['mean_s'] * 1e3:.1f} ms)")
    L.append(f"  throughput: {s['records_per_s']:.1f} records/s "
             f"({s['records']} records)")
    c = rep["compile"]
    L.append("")
    L.append(f"-- xla compilation: {c['count']} events, "
             f"{c['total_s']:.2f}s total --")
    if rep.get("costs"):
        # roofline-style attribution: what each compiled executable
        # costs per dispatch, by XLA's own model.  Intensity
        # (FLOPs/byte) is the figure that separates compute-bound from
        # HBM-bound executables — and shows what int8 packing buys.
        L.append("")
        L.append("-- device cost attribution (per compiled executable, "
                 "per dispatch) --")
        L.append(f"  {'executable':<34} {'GFLOPs':>9} {'MB moved':>9} "
                 f"{'MB out':>8} {'FLOPs/B':>8}")
        for label, co in sorted(rep["costs"].items(),
                                key=lambda kv: -kv[1]["flops"]):
            L.append(f"  {label:<34} {co['flops'] / 1e9:9.3f} "
                     f"{co['bytes_accessed'] / 1e6:9.2f} "
                     f"{co['output_bytes'] / 1e6:8.2f} "
                     f"{co['intensity_flops_per_byte']:8.1f}")
    hbm = rep.get("hbm")
    if hbm:
        L.append(f"  hbm high watermark: {_fmt_bytes(hbm['peak_bytes'])} "
                 f"peak/device ({hbm['samples']} samples, mean in-use "
                 f"{_fmt_bytes(int(hbm['mean_bytes_in_use']))}/device)")
    if rep["io"]:
        L.append("")
        L.append("-- overlapping I/O (already inside spans above) --")
        for name, e in sorted(rep["io"].items()):
            L.append(f"  {name:<28} {e['total_s']:9.3f}s  x{e['count']}"
                     f"  ({e['records']} records)")
    L.append("")
    L.append("-- resilience ledger (events by kind) --")
    if rep["events"]:
        for kind, n in sorted(rep["events"].items()):
            L.append(f"  {kind:<28} {n}")
    else:
        L.append("  (none)")
    if rep["scalars"]:
        L.append("")
        L.append("-- summary scalars --")
        for tag, n in sorted(rep["scalars"].items()):
            L.append(f"  {tag:<28} {n} points")
    serving = rep.get("serving")
    if serving:
        L.append("")
        L.append("-- serving --")
        reqs = ", ".join(f"{k}={v}" for k, v in
                         sorted(serving["requests"].items()))
        L.append(f"  requests: {serving['request_count']}"
                 + (f" ({reqs})" if reqs else ""))
        lat = serving["latency"]
        L.append(f"  ok latency p50/p95/p99: {lat['p50_s'] * 1e3:.1f} / "
                 f"{lat['p95_s'] * 1e3:.1f} / "
                 f"{lat['p99_s'] * 1e3:.1f} ms")
        b = serving["batches"]
        L.append(f"  batches: {b['count']}  rows: {b['rows']}  "
                 f"mean occupancy: {b['mean_occupancy'] * 100:.1f}%")
        for wid, w in sorted(serving.get("workers", {}).items()):
            L.append(f"  worker {wid}: {w['batches']} batches "
                     f"({w['ok']} ok, {w['failed']} failed, "
                     f"{w['rows']} rows)")
        for bk, e in sorted(serving.get("buckets", {}).items()):
            L.append(f"  bucket {bk}: {e['batches']} batches, "
                     f"{e['rows']} rows, padding efficiency "
                     f"{e['mean_padding_efficiency'] * 100:.1f}%")
        slots = serving.get("slots")
        if slots:
            L.append(f"  slots: {slots['capacity']} capacity, "
                     f"{slots['chunks']} decode chunks, "
                     f"{slots['tokens']} tokens, mean occupancy "
                     f"{slots['mean_occupancy'] * 100:.1f}%")
        pages = serving.get("pages")
        if pages:
            L.append(f"  pages: {pages['pages_total']} x "
                     f"{pages['capacity_tokens'] // max(pages['pages_total'], 1)}"
                     f" tokens, mean TOKEN occupancy "
                     f"{pages['mean_token_occupancy'] * 100:.1f}% "
                     f"(peak {pages['peak_tokens_held']} of "
                     f"{pages['capacity_tokens']} tokens held, "
                     f"{pages['peak_prefix_pages']} prefix pages)")
        prefix = serving.get("prefix")
        if prefix:
            L.append(f"  prefix cache: {prefix['hit_rate'] * 100:.1f}% "
                     f"page hit rate ({prefix['hit_pages']}/"
                     f"{prefix['lookup_pages']} pages over "
                     f"{prefix['admits']} admits, "
                     f"{prefix['shared_tokens']} prefill tokens saved, "
                     f"{prefix['inserted_pages']} inserted, "
                     f"{prefix['evicted_pages']} evicted)")
        spec = serving.get("spec")
        if spec:
            L.append(f"  speculative: {spec['accept_rate'] * 100:.1f}% "
                     f"draft accept rate ({spec['accepted']}/"
                     f"{spec['proposed']} proposed, {spec['emitted']} "
                     f"emitted over {spec['chunks']} chunks)")
        if serving["shed"]:
            L.append("  shed by reason: "
                     + ", ".join(f"{k}={v}" for k, v in
                                 sorted(serving["shed"].items())))
        if serving["breaker"]:
            L.append("  breaker transitions: "
                     + ", ".join(f"{k} x{v}" for k, v in
                                 sorted(serving["breaker"].items())))
        slo = rep.get("slo")
        if slo:
            cap = (f", {slo['captures']} triggered trace capture(s)"
                   if slo["captures"] else "")
            L.append(f"  slo: {slo['burn_events']} burn event(s) "
                     f"(max burn {slo['max_burn_rate']:.1f}x, min "
                     f"hit rate {slo['min_hit_rate'] * 100:.1f}%"
                     + (f", target {slo['target'] * 100:.1f}%"
                        if slo.get("target") else "") + f"){cap}")
        for line in _param_bytes_lines(rep):
            L.append(line)
    fleet = rep.get("fleet")
    if fleet:
        L.append("")
        L.append("-- fleet (per-tenant census) --")
        ws = fleet.get("worker_seconds")
        L.append(f"  dispatches: {fleet['dispatches']}  scale events: "
                 f"{fleet['scale_events']}  reaps: {fleet['reaps']}"
                 + (f"  worker-seconds: {ws:.1f}"
                    if ws is not None else ""))
        for name, t in sorted(fleet["tenants"].items()):
            reqs = ", ".join(f"{k}={v}" for k, v in
                             sorted(t["requests"].items()))
            line = (f"  tenant {name}"
                    + (f" [{t['kind']}" + (f" w={t['weight']}"
                                           if t.get("weight") else "")
                       + "]" if t.get("kind") else "")
                    + f": {t['dispatches']} dispatches, "
                    f"{t['rows']} rows"
                    + (f" ({reqs})" if reqs else ""))
            if t["scale_up"] or t["scale_down"]:
                line += (f", scaled +{t['scale_up']}/"
                         f"-{t['scale_down']}")
            if t["reaped"]:
                line += f", {t['reaped']} worker(s) reaped"
            L.append(line)
            if t["sheds"]:
                L.append("    shed by reason: "
                         + ", ".join(f"{k}={v}" for k, v in
                                     sorted(t["sheds"].items())))
    if not serving and rep.get("param_bytes"):
        # a quantized classifier ran offline (no serve.* records):
        # the footprint line still belongs on the report
        L.append("")
        L.append("-- resident params --")
        for line in _param_bytes_lines(rep):
            L.append(line)
    ingest = rep.get("ingest")
    if ingest:
        L.append("")
        L.append("-- ingest pipeline (per-stage capacity) --")
        for name, st in sorted(
                ingest["stages"].items(),
                key=lambda kv: kv[1]["capacity_records_per_s"]):
            mark = "  <-- bound" if name == ingest["bound_stage"] else ""
            err = f"  errors={st['errors']}" if st["errors"] else ""
            L.append(f"  {name:<16} {st['capacity_records_per_s']:10.1f} "
                     f"records/s capacity  ({st['lanes']} lane(s) x "
                     f"{st['rate_per_lane']:.1f}/s, busy "
                     f"{st['busy_s']:.3f}s, {st['records']} records)"
                     f"{err}{mark}")
        if ingest["bound_stage"]:
            L.append(f"  bound stage: {ingest['bound_stage']} — scale its "
                     "workers/depth first (BIGDL_TPU_INGEST_*)")
    for mode, m in sorted(rep.get("mesh", {}).items()):
        axes = "x".join(f"{k}={v}" for k, v in m["axes"].items())
        bytes_s = ", ".join(
            (f"{k}: {v / 1e6:.2f}MB/step" if v >= 1e6 else
             f"{k}: {v / 1e3:.1f}KB/step")
            for k, v in sorted((m.get("collective_bytes") or {}).items())
            if isinstance(v, (int, float)))
        L.append(f"-- mesh ({mode}): {axes} over {m.get('devices')} "
                 f"devices" + (f"  collectives/device: {bytes_s}"
                               if bytes_s else ""))
    tn = rep.get("tuning")
    if tn:
        L.append(f"-- kernel tuning ({tn.get('platform')}): "
                 f"{len(tn['ops'])} op(s), {tn['swept']} swept, "
                 f"{tn['cache_hits']} cache hit(s), winner speedup "
                 f"mean {tn['mean_speedup']:.2f}x / max "
                 f"{tn['max_speedup']:.2f}x vs fallback tiles")
        for key, w in sorted(tn["winners"].items(),
                             key=lambda kv: -kv[1]["speedup"])[:8]:
            L.append(f"  {key:<48} {str(tuple(w['tiles'])):>16} "
                     f"{w['speedup']:6.2f}x")
    el = rep.get("elastic")
    if el:
        L.append(f"-- elasticity: {el['generations']} generation(s) "
                 f"committed (max gen {el['max_generation']}, final "
                 f"world {el['final_world']}), {el['hosts_lost']} host(s) "
                 f"lost, {el['hosts_joined']} joined, {el['reshapes']} "
                 f"reshape(s), {el['restores']} resharded restore(s), "
                 f"{el['steps_replayed']} step(s) replayed, "
                 f"{el['watchdog_pauses']} watchdog pause(s)"
                 + (f", {el['fenced']} host(s) fenced"
                    if el.get("fenced") else ""))
    fh = rep.get("fleet_hosts")
    if fh:
        spills = fh.get("spill_by_reason") or {}
        spill_detail = (" (" + ", ".join(
            f"{k}={v}" for k, v in sorted(spills.items())) + ")"
            if spills else "")
        L.append(f"-- fleet hosts: {fh['hosts_joined']} joined, "
                 f"{fh['hosts_lost']} lost, {fh['generations']} "
                 f"generation(s) (max gen {fh['max_generation']}), "
                 f"{fh['placements']} placement(s), "
                 f"{fh['evictions']} eviction(s), {fh['spills']} "
                 f"spill(s){spill_detail}, {fh['salvaged']} request(s) "
                 "salvaged")
    mem = rep.get("memory")
    if mem:
        L.append("")
        L.append("-- memory (budget & offload census) --")
        L.append(f"  parks: {mem['parks']} "
                 f"({_fmt_bytes(mem['park_bytes'])} D2H)  resumes: "
                 f"{mem['resumes']} ({_fmt_bytes(mem['resume_bytes'])} "
                 f"H2D)  closes: {mem['closes']}  sheds: "
                 f"{mem['sheds']}  reclaims: {mem['reclaims']}")
        for name, t in sorted(mem["tenants"].items()):
            classes = ", ".join(
                f"{c}={_fmt_bytes(b)}"
                for c, b in sorted(t["charged"].items()) if b)
            line = (f"  tenant {name}: "
                    f"{_fmt_bytes(t['device_bytes'])} on device"
                    + (f" [{classes}]" if classes else "")
                    + (f", budget {_fmt_bytes(t['budget'])}"
                       if t.get("budget") else ""))
            if t["sheds"]:
                line += (f", {t['sheds']} byte-shed(s) "
                         f"({_fmt_bytes(t['shed_bytes'])} refused)")
            if t["reclaims"]:
                line += (f", {t['reclaims']} reclaim(s) "
                         f"({_fmt_bytes(t['reclaimed_bytes'])} freed)")
            L.append(line)
    ro = rep.get("rollout")
    if ro:
        cv = ro.get("canary_verdicts") or {}
        versions = ",".join(f"v{v}" for v in ro.get("versions_seen", []))
        promote_s = ro.get("mean_time_to_promote_s")
        L.append(f"-- rollout: {ro['discovered']} version(s) "
                 f"discovered [{versions}], canary verdicts "
                 f"{cv.get('pass', 0)} pass / {cv.get('fail', 0)} fail, "
                 f"{ro['shift_steps']} weight-shift step(s), "
                 f"{ro['promotes']} promote(s), {ro['rollbacks']} "
                 f"rollback(s), {ro['resumes']} recovery resume(s)"
                 + (f", mean time-to-promote {promote_s:.2f}s"
                    if promote_s is not None else ""))
    ft = rep.get("fleet_trace")
    if ft:
        L.append(f"-- fleet trace: {ft['submits']} submit(s), "
                 f"{ft['claims']} claim(s), {ft['responds']} "
                 f"response(s), {ft['redrives']} re-drive(s); "
                 f"{ft['link_edges']} link edge(s), "
                 f"{ft['resolved_edges']} resolved "
                 f"({ft['cross_pid_edges']} cross-process) — "
                 "`cli fleet-report` merges the whole fleet")
    ftel = rep.get("fleet_telemetry")
    if ftel:
        L.append(f"-- fleet telemetry: {ftel['samples']} heartbeat "
                 f"sample(s) over {len(ftel['hosts'])} host(s)")
        for host in sorted(ftel["hosts"]):
            snap = ftel["hosts"][host]
            backlog = snap.get("backlog") or {}
            depth = sum(int(v) for v in backlog.values()) \
                if backlog else 0
            hbm = snap.get("hbm") or {}
            resident = snap.get("resident") or {}
            L.append(f"  {host:<10} backlog={depth}"
                     + (f" hbm_peak={_fmt_bytes(int(hbm['peak_bytes']))}"
                        if hbm.get("peak_bytes") else "")
                     + (" resident=" + "+".join(
                         f"{dt}:{_fmt_bytes(int(b))}"
                         for dt, b in sorted(resident.items()))
                        if resident else ""))
    L.append("")
    lint = rep.get("lint")
    if lint:
        if lint.get("errors"):
            verdict = f"BROKEN ({lint['errors']} internal error(s))"
        elif lint["clean"]:
            verdict = "clean"
        else:
            verdict = f"{lint['findings']} finding(s)"
        detail = ", ".join(f"{k}={v}" for k, v in
                           sorted(lint["per_rule"].items()))
        # per-tier rule counts: how much of the catalog ran
        tiers = " ".join(f"{k}:{v}" for k, v in
                         sorted((lint.get("tiers") or {}).items()))
        L.append(f"-- lint gate (graftlint): {verdict} over "
                 f"{lint['files']} files "
                 f"({lint['suppressed']} suppressed, "
                 f"{lint['baselined']} baselined)"
                 + (f" [rules {tiers}]" if tiers else "")
                 + (f" [{detail}]" if detail else " --"))
    else:
        L.append("-- lint gate (graftlint): did not run for this "
                 "run dir --")
    L.append("==========================================")
    return "\n".join(L)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        "run-report", description="Render a training-run ledger directory")
    p.add_argument("run_dir", help="directory holding events-*.jsonl")
    p.add_argument("--json", action="store_true",
                   help="emit the report as JSON instead of text")
    p.add_argument("--strict", action="store_true",
                   help="fail on any malformed ledger line")
    args = p.parse_args(argv)
    if not ledger_files(args.run_dir):
        print(f"run-report: no events-*.jsonl under {args.run_dir!r}",
              file=sys.stderr)
        return 2
    records, bad = load_ledger(args.run_dir, strict=args.strict)
    rep = build_report(records)
    rep["malformed_lines"] = bad
    if args.json:
        print(json.dumps(rep, indent=2, sort_keys=True))
    else:
        if bad:
            print(f"warning: {bad} malformed ledger line(s) skipped",
                  file=sys.stderr)
        print(render_report(rep))
    return 0
