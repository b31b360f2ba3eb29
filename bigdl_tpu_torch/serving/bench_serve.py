"""Serving-scheduler benchmark (``bigdl_tpu/serving/bench_serve.py``):

    python -m bigdl_tpu_torch.cli bench-serve [--requests N] [--batch N]
        [--smoke] [--device cuda|cpu] [--out PATH]

Mixed-length generation traffic with a shared system-prompt head
(``--prefix-frac`` of the requests open with the same ``--prefix-len``
token head), served these ways:

* **static**: waves of ``--batch`` requests in arrival order, every wave
  decoding the global maximum ``max_new`` through ``TransformerLM.generate``;
* **bucketed**: waves grouped by a ``max_new`` bucket ladder, each decoding
  its rung;
* **continuous (row_slot)**: ``ContinuousGenerator(paged=False)``,
  contiguous max-capacity cache rows, admit per chunk, evict on finish;
  the baseline the ablations must beat;
* **ablations**, the same traffic through the paged scheduler with each
  feature turned on in turn: ``paged`` (block-paged KV, the gathered
  view), ``paged_kernel`` (decode reads the pages through the paged
  attention kernel, K12 on the card), ``paged_prefix`` (+ the prefix cache:
  the shared head is prefilled once) and ``paged_prefix_spec`` (+
  speculative decoding against a truncated draft packed int8, K13 on the
  card).  Every ablation's outputs must equal the row-slot run's: the bench
  never reports tokens/s for wrong tokens.  A divergence raises with the
  first divergent request, its position and the row-slot model's top-2
  log-probability margin there.

Useful tokens = the sum of the requested ``max_new``; a mode's tokens/s
divides that by its wall, so decode steps past a request's budget count
against the mode that spent them.  Warm-ups are outside every timing.  The
row-slot run is scraped mid-traffic through a live ``/metrics`` endpoint
over its counters; the bench exits 1 unless that scrape answered.

The model (seeded random weights) runs on ``--device``: CUDA by default,
the CPU when asked.  ``--out`` writes the result as JSON; without it
nothing is written.  Each mode's result names the kernel launches it made
(``kernel_launches``; the plain versions on the CPU count none).
``--fleet`` runs the multi-tenant fleet's bench instead
(:mod:`serving.fleet.bench_fleet`, its own flags); ``--cluster``, the
cross-host round, raises ``NotImplementedError`` naming its part of the
port.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

CLUSTER = ("bench-serve --cluster comes with the cross-host cluster "
           "(ROADMAP.md Queue 1 item 13, part 3b: serving/fleet/cluster.py, "
           "bench_cluster.py)")


def _traffic(rng, n: int, prompt_len: int, prefix_len: int,
             prefix_frac: float, vocab: int,
             short: tuple, long: tuple, long_frac: float):
    """Seeded consumer traffic: fixed-length prompts, a fraction opening
    with the same shared head, bimodal token budgets."""
    import numpy as np
    head = rng.randint(1, vocab + 1, size=prefix_len).astype(np.int32)
    prompts = []
    for _ in range(n):
        p = rng.randint(1, vocab + 1, size=prompt_len).astype(np.int32)
        if rng.rand() < prefix_frac:
            p[:prefix_len] = head
        prompts.append(p)
    budgets = [int(rng.randint(long[0], long[1] + 1))
               if rng.rand() < long_frac
               else int(rng.randint(short[0], short[1] + 1))
               for _ in range(n)]
    return list(zip(prompts, budgets))


def _launched_since(before: dict) -> dict:
    """The kernel launches since ``before`` (``ops.launch_counts()``)."""
    from bigdl_tpu_torch.ops import launch_counts
    return {k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}


def _mode_result(name: str, useful: int, wall: float,
                 lats: List[float], **extra) -> dict:
    # the nearest-rank helper run-report renders with, so the result's
    # percentiles never disagree with a report's
    from bigdl_tpu_torch.observability.report import _percentile
    s = sorted(lats)
    return dict(mode=name, useful_tokens=useful, wall_s=wall,
                tokens_per_s=useful / wall if wall > 0 else 0.0,
                latency_p50_s=_percentile(s, 50),
                latency_p95_s=_percentile(s, 95), **extra)


def _run_waves(requests, batch: int, bucket_of, compiled) -> tuple:
    """The static and bucketed modes: group arrivals into full waves per
    decode bucket, run each wave through that bucket's warmed generate,
    count only requested tokens as useful."""
    import numpy as np

    waves = {}                           # bucket -> its requests
    order = []                           # (bucket, wave) in formation order
    for prompt, max_new in requests:
        b = bucket_of(max_new)
        waves.setdefault(b, []).append((prompt, max_new))
        if len(waves[b]) == batch:
            order.append((b, waves.pop(b)))
    for b, wave in sorted(waves.items()):
        order.append((b, wave))          # partial tails, padded to batch

    useful = 0
    lats: List[float] = []
    pad_eff: List[float] = []
    t0 = time.monotonic()
    for b, wave in order:
        prompts = [p for p, _ in wave]
        while len(prompts) < batch:      # pad the wave with row 0
            prompts.append(prompts[0])
        compiled[b](np.stack(prompts))
        t_done = time.monotonic() - t0
        for _, max_new in wave:
            useful += max_new
            lats.append(t_done)          # all submitted at t=0
        pad_eff.append(sum(n for _, n in wave) / (batch * b))
    wall = time.monotonic() - t0
    return useful, wall, lats, pad_eff


def _run_continuous(gen, requests, useful_total: int, name: str,
                    live_url: Optional[List] = None) -> tuple:
    """Drive one ContinuousGenerator over the whole mix; returns (mode
    result, outputs in submission order, the live scrape's verdict)."""
    t0 = time.monotonic()
    lats: List[float] = []

    def stamp(_f):
        # completion time at resolution, not at the submission-order walk:
        # a short request finishing behind a long one must not inherit its
        # latency
        lats.append(time.monotonic() - t0)

    futs = []
    for p, n in requests:
        f = gen.submit(p, n)
        f.add_done_callback(stamp)
        futs.append(f)
    live_ok = None
    if live_url is not None:
        # scraped mid-traffic: submitted, not yet resolved
        from bigdl_tpu_torch.observability.live import scrape
        live_ok = "bigdl_tpu_" in (scrape(live_url[0]) or "")
    outs = [f.result() for f in futs]
    wall = time.monotonic() - t0
    st = gen.stats()
    extra = dict(mean_slot_occupancy=st["mean_occupancy"],
                 decode_chunks=st["chunks"])
    if st.get("paged"):
        extra["mean_token_occupancy"] = st["pages"]["mean_token_occupancy"]
        if st.get("prefix"):
            extra["prefix_hit_rate"] = st["prefix"]["hit_rate"]
            extra["prefix_shared_tokens"] = \
                st["prefix"]["hit_pages"] * st["pages"]["page_size"]
    if st.get("spec"):
        extra["draft_accept_rate"] = st["spec"]["accept_rate"]
    res = _mode_result(name, useful_total, wall, lats, **extra)
    return res, outs, live_ok


def _truncated_draft(model, layers: int):
    """A draft LM: the target's first ``layers`` blocks with its embeddings
    and final norm, the cheap proposer the speculative ablation verifies
    against."""
    from bigdl_tpu_torch.models import TransformerLM

    dm = TransformerLM(model.vocab_size, max_len=model.max_len,
                       embed_dim=model.embed_dim,
                       num_heads=model.blocks[0].attn.num_heads,
                       num_layers=layers)
    keep = {k: v for k, v in model.state_dict().items()
            if not k.startswith("blocks.") or int(k.split(".")[1]) < layers}
    dm.load_state_dict(keep)
    return dm.to(model.tensor_device()).evaluate()


def _divergence(model, name, ref_outs, outs, requests, device) -> str:
    """The first request whose output differs from the row-slot run's, the
    first differing position, and the row-slot model's top-2 log-prob
    margin there (a near tie splits two exact runs)."""
    import numpy as np
    import torch
    for i, (a, b) in enumerate(zip(ref_outs, outs)):
        if np.array_equal(a, b):
            continue
        pos = int(np.flatnonzero(np.asarray(a) != np.asarray(b))[0])
        ids = np.concatenate([requests[i][0], np.asarray(a)[:pos]])
        with torch.inference_mode():
            lp = model(torch.as_tensor(ids[None], device=device).long())
        top2 = torch.topk(lp[0, -1].float(), 2).values
        margin = float(top2[0] - top2[1])
        return (f"{name}: request {i} output diverged from the row-slot "
                f"baseline at position {pos} ({int(a[pos])} vs "
                f"{int(b[pos])}; top-2 log-prob margin there {margin:.3g})")
    return ""


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        import sys
        argv = sys.argv[1:]
    argv = list(argv)
    if "--fleet" in argv:
        # the fleet round: two-tenant autoscaling vs static peak and
        # noisy-neighbour isolation, with its own flags
        argv.remove("--fleet")
        from bigdl_tpu_torch.serving.fleet.bench_fleet import \
            main as fleet_main
        return fleet_main(argv)
    if "--cluster" in argv:
        raise NotImplementedError(CLUSTER)
    ap = argparse.ArgumentParser(
        "bench-serve",
        description="static vs bucketed vs continuous-batching generate, "
                    "with paged / +kernel / +prefix / +speculative "
                    "ablations")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--batch", type=int, default=8,
                    help="wave size for static/bucketed AND the "
                         "continuous scheduler's slot count")
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--prefix-len", type=int, default=80,
                    help="length of the shared system-prompt head")
    ap.add_argument("--prefix-frac", type=float, default=0.75,
                    help="fraction of requests opening with the shared "
                         "head")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--spec-k", type=int, default=3,
                    help="draft proposals per speculative chunk")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="layers in the truncated draft (0 = half of "
                         "--layers, min 1)")
    ap.add_argument("--short-range", default="8,24",
                    help="lo,hi token budget of the short mode")
    ap.add_argument("--long-range", default="32,48",
                    help="lo,hi token budget of the long tail")
    ap.add_argument("--long-frac", type=float, default=0.25,
                    help="fraction of long requests in the mix")
    ap.add_argument("--new-buckets", default="24,48",
                    help="max_new bucket ladder for the bucketed mode")
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--embed", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps-per-sync", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="fast mode: tiny model, few requests")
    ap.add_argument("--out", default=None,
                    help="write the result as JSON (default: no file)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.requests, args.batch = 12, 4
        args.prompt_len, args.vocab = 12, 64
        args.prefix_len, args.page_size = 8, 4
        args.embed, args.heads, args.layers = 32, 2, 2
        args.short_range, args.long_range = "4,8", "16,24"
        args.new_buckets = "8,24"
        args.steps_per_sync = 4
        args.spec_k = 3

    import numpy as np

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.observability.live import LiveMetricsServer
    from bigdl_tpu_torch.observability.prometheus import \
        metrics_to_prometheus
    from bigdl_tpu_torch.ops import launch_counts
    from bigdl_tpu_torch.serving.scheduler.buckets import BucketLadder
    from bigdl_tpu_torch.serving.scheduler.continuous import \
        ContinuousGenerator

    device = resolve_device(args.device)
    short = tuple(int(v) for v in args.short_range.split(","))
    long = tuple(int(v) for v in args.long_range.split(","))
    new_ladder = BucketLadder([int(v) for v in args.new_buckets.split(",")],
                              name="max_new")
    if new_ladder.max < long[1]:
        raise ValueError(f"largest max_new bucket {new_ladder.max} < "
                         f"long-range hi {long[1]}")
    if not 0 < args.prefix_len < args.prompt_len:
        raise ValueError(f"--prefix-len must be in (0, {args.prompt_len})")
    max_len = args.prompt_len + new_ladder.max
    model = TransformerLM(args.vocab + 1, max_len=max_len,
                          embed_dim=args.embed, num_heads=args.heads,
                          num_layers=args.layers).reset(args.seed)
    model = model.to(device).evaluate()
    rng = np.random.RandomState(args.seed)
    requests = _traffic(rng, args.requests, args.prompt_len,
                        args.prefix_len, args.prefix_frac, args.vocab,
                        short, long, args.long_frac)
    useful_total = sum(n for _, n in requests)
    print(f"bench-serve: {args.requests} requests, prompt "
          f"{args.prompt_len} ({args.prefix_frac:.0%} share a "
          f"{args.prefix_len}-token head), max_new "
          f"{short[0]}..{short[1]} (+{args.long_frac:.0%} long "
          f"{long[0]}..{long[1]}; {useful_total} useful tokens), "
          f"batch/slots {args.batch}, on {device}")

    # one warmed generate per decode bucket (the static mode only uses the
    # top rung); the warm-up is outside the timing
    compiled = {}
    for b in new_ladder:
        def gen(prompt, _b=b):
            return model.generate(prompt, max_new=_b, temperature=0.0,
                                  device=device).cpu()
        compiled[b] = gen
        gen(np.ones((args.batch, args.prompt_len), np.int32))

    # -- static: every wave decodes the global max ------------------------
    before = launch_counts()
    useful, wall, lats, eff = _run_waves(
        requests, args.batch, bucket_of=lambda n: new_ladder.max,
        compiled=compiled)
    static = _mode_result("static", useful, wall, lats,
                          mean_padding_efficiency=sum(eff) / len(eff),
                          kernel_launches=_launched_since(before))
    print(f"  static:       {static['tokens_per_s']:9.1f} tok/s  "
          f"p95 {static['latency_p95_s'] * 1e3:7.1f} ms  "
          f"padding eff {static['mean_padding_efficiency'] * 100:.0f}%")

    # -- bucketed: every wave decodes its rung ----------------------------
    before = launch_counts()
    useful, wall, lats, eff = _run_waves(
        requests, args.batch, bucket_of=new_ladder.pick, compiled=compiled)
    bucketed = _mode_result("bucketed", useful, wall, lats,
                            mean_padding_efficiency=sum(eff) / len(eff),
                            kernel_launches=_launched_since(before))
    print(f"  bucketed:     {bucketed['tokens_per_s']:9.1f} tok/s  "
          f"p95 {bucketed['latency_p95_s'] * 1e3:7.1f} ms  "
          f"padding eff {bucketed['mean_padding_efficiency'] * 100:.0f}%")

    # continuous rungs: the full prompt and the post-prefix suffix, so a
    # prefix hit prefills the short rung instead of the whole prompt
    aligned = (args.prefix_len // args.page_size) * args.page_size
    seq_buckets = sorted({args.prompt_len,
                          max(args.prompt_len - aligned, 1)})
    draft_layers = args.draft_layers or max(1, args.layers // 2)
    dm = _truncated_draft(model, draft_layers)

    variants = [
        ("continuous", dict(paged=False), True),
        # the gathered view asked for by name: on a CUDA device
        # paged_kernel defaults to K12, which would make this rung and the
        # next the same
        ("paged", dict(paged=True, page_size=args.page_size,
                       prefix_cache=False, paged_kernel=False), False),
        # decode reads the pages through the paged attention kernel (K12
        # on the card, its plain version on the CPU), with no gathered
        # view; the outputs must stay equal to the row-slot run's
        ("paged_kernel", dict(paged=True, page_size=args.page_size,
                              prefix_cache=False, paged_kernel=True),
         False),
        ("paged_prefix", dict(paged=True, page_size=args.page_size,
                              prefix_cache=True), False),
        ("paged_prefix_spec", dict(paged=True, page_size=args.page_size,
                                   prefix_cache=True, draft_model=dm,
                                   draft_quantize="w8",
                                   spec_k=args.spec_k), False),
    ]
    results = {}
    ref_outs = None
    live_ok = False
    for name, kw, scrape_live in variants:
        gen = ContinuousGenerator(
            model, num_slots=args.batch, max_len=max_len,
            seq_buckets=seq_buckets, temperature=0.0,
            steps_per_sync=args.steps_per_sync, warmup=True,
            queue_capacity=max(args.requests, 256), device=device, **kw)
        # live /metrics over the generator's counters, scraped while
        # traffic is decoding
        live = (LiveMetricsServer(
            lambda g=gen: metrics_to_prometheus(g.metrics))
            if scrape_live else None)
        try:
            # the warm-up's launches are the generator's set-up, not the
            # mode's
            before = launch_counts()
            res, outs, ok = _run_continuous(
                gen, requests, useful_total, name,
                live_url=[live.url] if live else None)
            gen.drain(timeout=60)
        finally:
            if live is not None:
                live.close()     # a failed phase must not leak the socket
        res["kernel_launches"] = _launched_since(before)
        if ok is not None:
            live_ok = ok
            print(f"  live /metrics mid-traffic: "
                  f"{'OK' if ok else 'FAILED'}")
        # every variant must produce the row-slot run's exact tokens: no
        # tokens/s number for wrong tokens
        if ref_outs is None:
            ref_outs = outs
        else:
            why = _divergence(model, name, ref_outs, outs, requests, device)
            if why:
                raise AssertionError(why)
        results[name] = res
        rates = "".join(
            f"  {k.replace('_', ' ')} {res[k] * 100:.0f}%"
            for k in ("prefix_hit_rate", "draft_accept_rate") if k in res)
        print(f"  {name + ':':<13} {res['tokens_per_s']:9.1f} tok/s  "
              f"p95 {res['latency_p95_s'] * 1e3:7.1f} ms{rates}")

    continuous = results.pop("continuous")
    best_name = max(results, key=lambda k: results[k]["tokens_per_s"])
    row = continuous["tokens_per_s"]
    ratio = results[best_name]["tokens_per_s"] / row if row > 0 else 0.0
    out = {
        "bench": "serve_r11",
        "meta": {
            "requests": args.requests, "batch": args.batch,
            "prompt_len": args.prompt_len,
            "prefix_len": args.prefix_len,
            "prefix_frac": args.prefix_frac,
            "page_size": args.page_size,
            "steps_per_sync": args.steps_per_sync,
            "spec_k": args.spec_k, "draft_layers": draft_layers,
            "short_range": list(short), "long_range": list(long),
            "long_frac": args.long_frac,
            "new_buckets": list(new_ladder),
            "seq_buckets": seq_buckets,
            "model": {"vocab": args.vocab, "embed": args.embed,
                      "heads": args.heads, "layers": args.layers,
                      "max_len": max_len},
            "platform": "gpu" if device.type == "cuda" else device.type,
            "smoke": bool(args.smoke), "seed": args.seed,
        },
        "modes": {"static": static, "bucketed": bucketed,
                  "continuous": continuous},
        "ablations": results,
        "acceptance": {
            "best_ablation": best_name,
            "best_vs_row_slot_tokens_per_s": ratio,
            "per_feature_vs_row_slot": {
                k: (v["tokens_per_s"] / row if row > 0 else 0.0)
                for k, v in results.items()},
            "paged_kernel_vs_paged_tokens_per_s": (
                results["paged_kernel"]["tokens_per_s"]
                / results["paged"]["tokens_per_s"]
                if results["paged"]["tokens_per_s"] > 0 else 0.0),
            "prefix_hit_rate":
                results["paged_prefix"].get("prefix_hit_rate", 0.0),
            "draft_accept_rate":
                results["paged_prefix_spec"].get("draft_accept_rate", 0.0),
            "outputs_bit_equal_across_variants": True,
            "holds": ratio > 1.0,
            "live_endpoint_mid_traffic": live_ok,
        },
    }
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(f"  best ablation ({best_name}) vs row-slot continuous: "
          f"{ratio:.2f}x tokens/s "
          f"({'OK' if ratio > 1.0 else 'BELOW 1.0'})"
          + (f" -> {args.out}" if args.out else ""))
    return 0 if live_ok else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
