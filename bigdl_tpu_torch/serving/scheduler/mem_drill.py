"""Memory-pressure survival drill
(``bigdl_tpu/serving/scheduler/mem_drill.py``, phases A and B):

    python -m bigdl_tpu_torch.serving.scheduler.mem_drill [--smoke]
        [--device cuda|cpu] [--run-dir DIR] [--out results.json]

Exit 0 only when both phases hold and the run ledger (``--run-dir``, a
temporary directory by default) gives a run-report memory census with the
drill's parks, resumes and sheds.

**Phase A — sessions past the page pool.**  A paged
:class:`~.continuous.ContinuousGenerator` with a tiny page pool (tokens are
scarce) and a :class:`~.membudget.MemoryBudgeter` one page short of the
pool opens far more sessions than the device holds.  Idle sessions must
park to host RAM instead of anything failing, the open sessions' token
census must reach 3x the pool, and a second turn on every session (parked
ones resume) must equal ``TransformerLM.generate`` over the whole history.
A pool-sized request sheds ``MemoryBudgetError`` at submit while the
turns in flight land; after every session closes the ``kv_pages`` and
``host_offload`` charges are exactly 0.

**Phase B — victims under a greedy flood.**  Small "victim" requests
interleaved with pool-sized "flood" requests run twice: budgeted (floods
shed typed at submit) and unbudgeted (floods admitted, holding the pool).
The victims' completion rate under the budget must be no worse; their mean
latency is reported beside.

Random seeded weights on ``--device`` (the generator's default, CUDA, or
the CPU when asked); ``--out`` writes the results as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

VOCAB = 64


def _expect(ok: bool, what: str, failures: List[str]) -> bool:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        failures.append(what)
    return ok


def _lm(max_len=64):
    from bigdl_tpu_torch.models import TransformerLM
    return TransformerLM(VOCAB, max_len=max_len, embed_dim=32, num_heads=2,
                         num_layers=2).reset(0).evaluate()


def _prompts(n, lo, hi, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, VOCAB + 1,
                       size=int(rs.randint(lo, hi))).astype(np.int64)
            for _ in range(n)]


def _ref(m, prompt, max_new, device):
    return m.generate(torch.from_numpy(np.asarray(prompt)[None]), max_new,
                      device=device)[0].cpu().numpy()


def _generator(m, args, budgeter, tenant):
    from bigdl_tpu_torch.serving import ContinuousGenerator
    return ContinuousGenerator(
        m, num_slots=2, seq_buckets=[16], steps_per_sync=2, paged=True,
        page_size=args.page_size, num_pages=args.num_pages,
        budgeter=budgeter, budget_tenant=tenant, device=args.device)


# -- phase A: flood the pool, park, resume, equal to generate -----------------

def _phase_a(args, failures: List[str]) -> dict:
    from bigdl_tpu_torch.serving import MemoryBudgetError, MemoryBudgeter

    m = _lm()
    budgeter = MemoryBudgeter()
    print(f"phase A: {args.sessions} sessions vs a {args.num_pages}-page "
          f"pool (page_size={args.page_size}) on {args.device}")
    with _generator(m, args, budgeter, "a") as g:
        pb = g.stats()["pages"]["page_bytes"]
        pool_tokens = args.num_pages * args.page_size
        # one page short of the pool: a pool-sized request can never fit
        budgeter.set_budget("a", (args.num_pages - 1) * pb)

        # every session opens with the same system prompt: its published
        # pages are pinned once and shared, where N unique pinned chains
        # would exhaust the pool whatever is parked
        sys_prompt = np.arange(1, 2 * args.page_size + 1, dtype=np.int64)
        futs = [g.submit(sys_prompt, args.max_new, session=f"s{i}")
                for i in range(args.sessions)]
        flood = _prompts(1, 10, 11, seed=2)[0]
        shed_typed = False
        try:
            g.submit(flood, pool_tokens - flood.size)
        except MemoryBudgetError as e:
            shed_typed = e.reason == "byte_starved"
        _expect(shed_typed, "pool-sized request shed typed "
                "(MemoryBudgetError, reason=byte_starved)", failures)
        out1 = [f.result(timeout=180.0) for f in futs]

        st = g.stats()
        resident = int(st["sessions"]["total_tokens"])
        _expect(int(st["sessions"]["open"]) == args.sessions,
                f"every session survived the flood "
                f"({st['sessions']['open']}/{args.sessions} open)", failures)
        _expect(resident >= 3 * pool_tokens,
                f"resident-token capacity {resident} >= 3x the device page "
                f"pool ({pool_tokens} tokens)", failures)
        parks = int(st["offload"]["parks"])
        _expect(parks >= 1 and int(st["sessions"]["parked"]) >= 1,
                f"pressure parked idle sessions to host RAM ({parks} "
                f"park(s), {st['sessions']['parked']} parked now)", failures)

        turn2 = _prompts(args.sessions, 3, 6, seed=3)
        futs2 = [g.submit(p, args.max_new2, session=f"s{i}")
                 for i, p in enumerate(turn2)]
        out2 = [f.result(timeout=180.0) for f in futs2]
        mismatches = 0
        r1 = _ref(m, sys_prompt, args.max_new, args.device)
        for i in range(args.sessions):
            full2 = np.concatenate([sys_prompt, out1[i], turn2[i]])
            r2 = _ref(m, full2, args.max_new2, args.device)
            if not (np.array_equal(r1, out1[i])
                    and np.array_equal(r2, out2[i])):
                mismatches += 1
        resumes = int(g.stats()["offload"]["resumes"])
        _expect(resumes >= 1, f"parked sessions resumed transparently "
                f"({resumes} resume(s))", failures)
        _expect(mismatches == 0,
                f"both turns equal to generate() over the whole history "
                f"across {args.sessions} sessions", failures)

        for i in range(args.sessions):
            g.close_session(f"s{i}").result(timeout=30.0)
        g.drain(timeout=60.0)
        snap = budgeter.snapshot()["tenants"]["a"]
        _expect(snap["charged"]["kv_pages"] == 0
                and snap["charged"]["host_offload"] == 0,
                f"budget accounting exact after close-all "
                f"(kv={snap['charged']['kv_pages']}, "
                f"host={snap['charged']['host_offload']})", failures)
        sheds = int(snap["sheds"])
        _expect(sheds >= 1, f"shed attributed to the tenant in the "
                f"budgeter census ({sheds})", failures)
        return {"sessions": args.sessions, "pool_tokens": pool_tokens,
                "resident_tokens": resident,
                "capacity_ratio": resident / max(1, pool_tokens),
                "parks": parks, "resumes": resumes,
                "mismatches": mismatches, "typed_sheds": sheds,
                "kv_pages_after_close": snap["charged"]["kv_pages"],
                "host_offload_after_close":
                    snap["charged"]["host_offload"]}


# -- phase B: victims, budgeted and unbudgeted --------------------------------

def _victim_run(args, budgeted: bool) -> dict:
    from bigdl_tpu_torch.serving import MemoryBudgetError, MemoryBudgeter

    m = _lm()
    budgeter = MemoryBudgeter() if budgeted else None
    with _generator(m, args, budgeter, "noisy") as g:
        pb = g.stats()["pages"]["page_bytes"]
        pool_tokens = args.num_pages * args.page_size
        if budgeter is not None:
            budgeter.set_budget("noisy", (args.num_pages - 1) * pb)
        victims = _prompts(args.victims, 5, 8, seed=4)
        floods = _prompts(args.floods, 10, 11, seed=5)
        vfuts, t0s, sheds, untyped = [], [], 0, 0
        for i, v in enumerate(victims):
            if i % 3 == 0 and i // 3 < len(floods):
                f = floods[i // 3]
                try:
                    g.submit(f, pool_tokens - f.size)
                except MemoryBudgetError:
                    sheds += 1
                except Exception:
                    untyped += 1
            t0s.append(time.monotonic())
            vfuts.append(g.submit(v, args.max_new))
        lats, ok = [], 0
        for t0, f in zip(t0s, vfuts):
            try:
                f.result(timeout=300.0)
                ok += 1
                lats.append(time.monotonic() - t0)
            except Exception:
                pass
        g.drain(timeout=120.0)
    return {"victims": len(victims), "ok": ok,
            "ok_rate": ok / max(1, len(victims)),
            "mean_latency_s": (sum(lats) / len(lats)) if lats else None,
            "floods": len(floods), "floods_shed_typed": sheds,
            "untyped_errors": untyped}


def _phase_b(args, failures: List[str]) -> dict:
    print(f"phase B: {args.victims} victims + {args.floods} pool-sized "
          f"floods, budgeted vs unbudgeted")
    base = _victim_run(args, budgeted=False)
    bud = _victim_run(args, budgeted=True)
    _expect(bud["floods_shed_typed"] == args.floods,
            f"every flood shed typed under the budget "
            f"({bud['floods_shed_typed']}/{args.floods})", failures)
    _expect(bud["untyped_errors"] == 0 and base["untyped_errors"] == 0,
            "zero untyped errors in either run", failures)
    _expect(bud["ok_rate"] >= base["ok_rate"],
            f"victim completion no worse than unbudgeted baseline "
            f"({bud['ok_rate']:.2f} vs {base['ok_rate']:.2f})", failures)
    if bud["mean_latency_s"] and base["mean_latency_s"]:
        print(f"  victim mean latency: {bud['mean_latency_s'] * 1e3:.0f}ms "
              f"budgeted vs {base['mean_latency_s'] * 1e3:.0f}ms baseline")
    return {"baseline": base, "budgeted": bud}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        "mem_drill", description="memory-pressure survival drill: sessions "
        "parked to host RAM, typed byte-starved sheds")
    p.add_argument("--sessions", type=int, default=18,
                   help="multi-turn sessions to open against the pool")
    p.add_argument("--page-size", type=int, default=4)
    p.add_argument("--num-pages", type=int, default=16,
                   help="device page pool (tiny, so tokens are scarce)")
    p.add_argument("--max-new", type=int, default=6)
    p.add_argument("--max-new2", type=int, default=4,
                   help="second-turn decode budget")
    p.add_argument("--victims", type=int, default=9)
    p.add_argument("--floods", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device of the generator (default cuda)")
    p.add_argument("--run-dir", default=None,
                   help="run-ledger directory (default: a temp dir)")
    p.add_argument("--out", default=None,
                   help="write the results to this JSON file")
    p.add_argument("--smoke", action="store_true",
                   help="fast preset: fewer sessions and victims")
    args = p.parse_args(argv)
    if args.smoke:
        args.sessions = 16
        args.victims = 6
        args.floods = 2

    from bigdl_tpu_torch.observability import ledger as run_ledger
    from bigdl_tpu_torch.observability.report import (build_report,
                                                      load_ledger)
    os.environ.pop("BIGDL_TPU_TRACE_ID", None)
    run_dir = args.run_dir or tempfile.mkdtemp(prefix="bigdl-mem-drill-")
    prev = run_ledger.get_ledger()
    run_ledger.set_run_dir(run_dir)
    failures: List[str] = []
    try:
        a = _phase_a(args, failures)
        b = _phase_b(args, failures)
        run_ledger.flush()
    finally:
        run_ledger.set_run_dir(prev.dir if prev is not None else None)
    # the ledger trail: mem.budget / mem.offload records feed run-report's
    # memory census
    records, _bad = load_ledger(run_dir)
    census = build_report(records).get("memory") or {}
    print("ledger: run-report memory census")
    _expect(census.get("parks", 0) >= 1
            and census.get("resumes", 0) >= 1
            and census.get("sheds", 0) >= 1,
            f"memory census carries the drill's parks/resumes/sheds "
            f"(parks={census.get('parks')}, "
            f"resumes={census.get('resumes')}, "
            f"sheds={census.get('sheds')})", failures)
    gates = {
        "capacity_3x": a["resident_tokens"] >= 3 * a["pool_tokens"],
        "typed_attributed_sheds": a["typed_sheds"] >= 1,
        "park_resume_equal": a["mismatches"] == 0 and a["resumes"] >= 1,
        "accounting_exact": a["kv_pages_after_close"] == 0
        and a["host_offload_after_close"] == 0,
        "victim_slo_no_worse": (b["budgeted"]["ok_rate"]
                                >= b["baseline"]["ok_rate"]),
    }
    passed = all(gates.values()) and not failures
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"smoke": bool(args.smoke), "device": args.device,
                       "phase_a": a, "phase_b": b,
                       "memory_census": census, "gates": gates,
                       "pass": passed}, f, indent=2, default=str)
    print("\n-- gates --")
    for k, v in gates.items():
        print(f"  [{'ok' if v else 'FAIL'}] {k}")
    if not passed:
        print(f"\nmem_drill: {len(failures)} check(s) FAILED (ledger "
              f"kept under {run_dir})")
        return 1
    print("\nmem_drill: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
