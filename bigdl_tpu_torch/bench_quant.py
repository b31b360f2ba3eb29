"""Quantized-inference benchmark (``bigdl_tpu/bench_quant.py``):

    python -m bigdl_tpu_torch.cli bench-infer [--smoke] [--device cuda|cpu]
        [--out PATH]

The int8 serving path's speed is gated behind an accuracy budget: every
config records tokens/s (or images/s), the resident parameter bytes by
dtype, and the top-1 and logit deltas of the int8 forward against the bf16
baseline, and the bench exits 1 when any config's quality delta is over
the declared budget, so a fast but wrong kernel change cannot land on a
throughput headline.

Paths compared, per config:

* **bf16 baseline**: parameters cast to bf16, activations bf16;
* **int8**: ``quant.quantize_model`` w8 packing (per-channel weight
  scales; the LM configs also pack the tied embedding table,
  ``extra_keys=("tok",)``), every product through the fused dequant
  matmul (K13 on the card).  The LM's int8 copy serves f32 activations,
  as the reference's does; the image config (LeNet-5) serves bf16
  activations over int8 weights (``cast_rest=torch.bfloat16``).

The models carry seeded random weights and run on ``--device``: CUDA by
default, the CPU when asked.  ``--smoke`` is the fast mode: tiny configs,
the same gate.  ``--out`` writes the result as JSON; without it nothing is
written.  With the run ledger on, every timed forward writes one
``cost.analysis`` record (ATen's FLOPs, ``observability/costs.py``: the
hand-written kernels' work is not in the count, so on the card the int8
rows leave out the K13 products).  Each row names the kernel launches of
one int8 forward (``int8_kernel_launches``; none on the CPU).
"""

from __future__ import annotations

import copy
import json
import sys
import time

# The declared accuracy budget (the gate).  The top-1 figure is a drop
# budget: the f32 forward is truth, and the gate bounds how much more top-1
# agreement int8 loses than the bf16 baseline already loses to its own
# rounding (near-tied logits flip under any low-precision mode).  Logit
# deltas are absolute, against the bf16 baseline the int8 path replaces.
BUDGET = {
    "max_top1_drop_vs_bf16": 0.02,
    "max_mean_abs_logit_delta": 0.10,
}


def _sync(x):
    return x.cpu()


def _time_forward(fn, *args, iters=8, windows=2):
    """Best-of-windows steady-state seconds a call (the first call, the
    warm-up, is left out)."""
    _sync(fn(*args))
    best = float("inf")
    for _ in range(windows):
        t0 = time.time()
        for _ in range(iters):
            y = fn(*args)
        _sync(y)
        best = min(best, (time.time() - t0) / iters)
    return best


def _quality(lp_f32, lp_bf16, lp_int8):
    import numpy as np
    truth = np.asarray(lp_f32, np.float32).argmax(-1)
    a = np.asarray(lp_bf16, np.float32)
    b = np.asarray(lp_int8, np.float32)
    top1_bf16 = float(np.mean(a.argmax(-1) == truth))
    top1_int8 = float(np.mean(b.argmax(-1) == truth))
    d = np.abs(a - b)
    return {"top1_vs_f32_bf16": round(top1_bf16, 4),
            "top1_vs_f32_int8": round(top1_int8, 4),
            "top1_drop_vs_bf16": round(top1_bf16 - top1_int8, 4),
            "max_abs_logit_delta": round(float(d.max()), 4),
            "mean_abs_logit_delta": round(float(d.mean()), 4)}


def _np32(t):
    return t.float().cpu().numpy()


def _priced(label: str, fn, *args, **attrs):
    """One call of ``fn(*args)`` under a FLOP counter, ledgered as the
    ``cost.analysis`` record ``label`` (no record with the ledger off)."""
    from bigdl_tpu_torch.observability import costs
    probe = costs.cost_probe(label, *args)
    if probe is None:
        return
    with probe:
        _sync(fn(*args))
    costs.emit_cost(probe, **attrs)


def _launches_of(fn, *args) -> dict:
    """The kernel launches of one call of ``fn(*args)``."""
    from bigdl_tpu_torch.ops import launch_counts
    before = launch_counts()
    _sync(fn(*args))
    return {k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}


def bench_lm(name, *, vocab, embed, heads, layers, seqlen, batch,
             iters, windows, device):
    """tokens/s of the full-sequence scoring forward, bf16 parameters vs
    int8-packed (weights and the tied tok table)."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.ops import quant

    model = TransformerLM(vocab, max_len=seqlen, embed_dim=embed,
                          num_heads=heads, num_layers=layers).reset(0)
    model = model.to(device).evaluate()
    m_bf16 = copy.deepcopy(model).to(device, torch.bfloat16)
    # int8 weights with f32 activations: the generator's default for
    # quantize= without a compute dtype
    m_int8 = quant.quantize_model(model, "w8", extra_keys=("tok",))
    toks = torch.as_tensor(np.random.RandomState(0).randint(
        1, vocab + 1, (batch, seqlen)), device=device).long()

    @torch.inference_mode()
    def score(m, t):
        # a small on-device reduction: the per-sequence mean next-token
        # log-prob (fetching (B, T, vocab) would time the copy)
        y = m(t)
        lp = torch.gather(y[:, :-1], -1, t[:, 1:, None] - 1)[..., 0]
        return lp.float().mean(dim=-1)

    @torch.inference_mode()
    def logits(m, t):
        return m(t)

    t_bf16 = _time_forward(score, m_bf16, toks, iters=iters,
                           windows=windows)
    t_int8 = _time_forward(score, m_int8, toks, iters=iters,
                           windows=windows)
    # with the ledger on, price both forwards: run-report's cost table
    _priced(f"lm.score.bf16[{name}]", score, m_bf16, toks,
            quantize=None, config=name)
    _priced(f"lm.score.int8[{name}]", score, m_int8, toks,
            quantize="w8", config=name)
    launches = _launches_of(score, m_int8, toks)
    qual = _quality(_np32(logits(model, toks)), _np32(logits(m_bf16, toks)),
                    _np32(logits(m_int8, toks)))
    bytes_bf16 = quant.param_bytes_by_dtype(m_bf16)
    bytes_int8 = quant.param_bytes_by_dtype(m_int8)
    tot_bf16, tot_int8 = sum(bytes_bf16.values()), sum(bytes_int8.values())
    tps = batch * seqlen
    return {
        "config": name,
        "model": f"transformer_lm {layers}L/{embed}d/{heads}h "
                 f"vocab={vocab}",
        "batch": batch, "seqlen": seqlen,
        "bf16_tokens_per_sec": round(tps / t_bf16, 1),
        "int8_tokens_per_sec": round(tps / t_int8, 1),
        "speedup_int8_vs_bf16": round(t_bf16 / t_int8, 3),
        "resident_param_bytes": {
            "bf16": tot_bf16, "int8": tot_int8,
            "int8_by_dtype": bytes_int8,
            "ratio_int8_vs_bf16": round(tot_int8 / tot_bf16, 3)},
        "quality_vs_bf16": qual,
        "int8_kernel_launches": launches,
    }


def bench_image(name, make_model, *, image, channels, batch,
                iters, windows, device):
    """images/s of the classifier forward (argmax on the device), bf16 vs
    int8 weights, both on bf16 activations."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.ops import quant

    model = make_model().to(device).evaluate()
    m_bf16 = copy.deepcopy(model).to(device, torch.bfloat16)
    m_int8 = quant.quantize_model(model, "w8", cast_rest=torch.bfloat16)
    x = torch.as_tensor(np.random.RandomState(0).rand(
        batch, channels, image, image), device=device).to(torch.bfloat16)

    @torch.inference_mode()
    def pred(m, x):
        return m(x).argmax(dim=-1).int()

    @torch.inference_mode()
    def logits(m, x):
        return m(x)

    t_bf16 = _time_forward(pred, m_bf16, x, iters=iters, windows=windows)
    t_int8 = _time_forward(pred, m_int8, x, iters=iters, windows=windows)
    _priced(f"image.pred.bf16[{name}]", pred, m_bf16, x,
            quantize=None, config=name)
    _priced(f"image.pred.int8[{name}]", pred, m_int8, x,
            quantize="w8", config=name)
    launches = _launches_of(pred, m_int8, x)
    qual = _quality(_np32(logits(model, x.float())),
                    _np32(logits(m_bf16, x)), _np32(logits(m_int8, x)))
    bytes_bf16 = quant.param_bytes_by_dtype(m_bf16)
    bytes_int8 = quant.param_bytes_by_dtype(m_int8)
    tot_bf16, tot_int8 = sum(bytes_bf16.values()), sum(bytes_int8.values())
    return {
        "config": name, "batch": batch,
        "bf16_imgs_per_sec": round(batch / t_bf16, 1),
        "int8_imgs_per_sec": round(batch / t_int8, 1),
        "speedup_int8_vs_bf16": round(t_bf16 / t_int8, 3),
        "resident_param_bytes": {
            "bf16": tot_bf16, "int8": tot_int8,
            "ratio_int8_vs_bf16": round(tot_int8 / tot_bf16, 3)},
        "quality_vs_bf16": qual,
        "int8_kernel_launches": launches,
    }


def _gate(rows):
    """Apply the accuracy budget; returns the failures (empty: the gate
    holds)."""
    failures = []
    for r in rows:
        q = r["quality_vs_bf16"]
        if q["top1_drop_vs_bf16"] > BUDGET["max_top1_drop_vs_bf16"]:
            failures.append(
                f"{r['config']}: top-1 drop vs bf16 "
                f"{q['top1_drop_vs_bf16']} > "
                f"{BUDGET['max_top1_drop_vs_bf16']}")
        if q["mean_abs_logit_delta"] > BUDGET["max_mean_abs_logit_delta"]:
            failures.append(
                f"{r['config']}: mean |Δlogit| "
                f"{q['mean_abs_logit_delta']} > "
                f"{BUDGET['max_mean_abs_logit_delta']}")
    return failures


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        "bench-infer", description="int8 quantized inference: tokens/s, "
        "images/s and resident bytes vs bf16, accuracy-gated")
    p.add_argument("--smoke", action="store_true",
                   help="fast mode: tiny configs, the same accuracy gate")
    p.add_argument("--device", default="cuda",
                   help="torch device of the models (default cuda)")
    p.add_argument("--out", default=None,
                   help="write the result as JSON (default: no file)")
    args = p.parse_args(argv)

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.models import LeNet5

    device = resolve_device(args.device)
    lm_rows, img_rows = [], []
    if args.smoke:
        lm_rows.append(bench_lm(
            "tlm-smoke", vocab=2000, embed=128, heads=4, layers=2,
            seqlen=128, batch=4, iters=3, windows=1, device=device))
        img_rows.append(bench_image(
            "lenet5-smoke", lambda: LeNet5(10).reset(0), image=28,
            channels=1, batch=64, iters=3, windows=1, device=device))
    else:
        lm_rows.append(bench_lm(
            "tlm-2L128d", vocab=2000, embed=128, heads=4, layers=2,
            seqlen=256, batch=8, iters=6, windows=2, device=device))
        lm_rows.append(bench_lm(
            "tlm-8L512d", vocab=32000, embed=512, heads=8, layers=8,
            seqlen=512, batch=8, iters=4, windows=2, device=device))
        img_rows.append(bench_image(
            "lenet5", lambda: LeNet5(10).reset(0), image=28, channels=1,
            batch=512, iters=6, windows=2, device=device))

    rows = lm_rows + img_rows
    for r in rows:
        print(json.dumps(r))
    failures = _gate(rows)

    out = {
        "metric": "quantized_inference_r9",
        "note": "int8 (per-channel weight scales, fused dequant matmul; "
                "LM configs pack the tied tok table) vs the bf16 "
                "baseline, the same eager device forward both sides, "
                "best-of-windows steady state.  LM int8 models serve f32 "
                "activations; the image config serves bf16 activations.",
        "accuracy_budget": BUDGET,
        "smoke": bool(args.smoke),
        "platform": "gpu" if device.type == "cuda" else device.type,
        "lm": lm_rows,
        "image": img_rows,
        "gate": {"passed": not failures, "failures": failures},
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    # a run-dir'd bench leaves a complete ledger behind when main returns
    from bigdl_tpu_torch.observability import ledger as run_ledger
    run_ledger.flush()
    best = max(r["speedup_int8_vs_bf16"] for r in lm_rows)
    print(f"best lm int8 speedup vs bf16: {best}x; gate "
          + ("PASSED" if not failures else
             "FAILED: " + "; ".join(failures)))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
