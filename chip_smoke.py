#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. card line (name and power limit from nvidia-smi) and the nvcc build of
   every kernel from ``bigdl_tpu_torch/csrc``;
2. every kernel against its plain PyTorch version on the card, at the
   shapes full-width Inception-v1 gives it at batch 32 and at ragged
   shapes, in float32 and bfloat16;
3. serving: full-width ``Inception_v1(1000)`` with seeded random weights
   behind ``InferenceServer(DLClassifier(..., device="cuda"),
   batch_buckets=(8, 32))``; every request must resolve to the same class
   as ``DLClassifier.predict``, 8 rows must agree with a CPU run of the
   same weights, and each kernel's launch count must show that every
   forward went through it;
4. timings: each kernel's median time at the serving shapes beside its
   bound, its plain version and the library call that computes the same
   function; the classifier's forward per bucket (median of 20, packed
   rows in, predictions back on the host); then the closed-loop serving
   images/s and request latency per bucket.

The line before the last is a JSON object with a ``kernels`` list; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH = 32
IMAGE = 224
CLASSES = 1000
BUCKETS = (8, 32)
N_ROWS = 96
CPU_ROWS = 8
WAVES = {8: 3, 32: 2}          # closed-loop serving waves per bucket
TIMING_REPS = 20
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 rate outside tensor cores

# (name, input shape at batch 32, kh, kw, sh, sw, ph, pw, ceil) of the 13
# SpatialMaxPooling layers of Inception-v1 in forward order
POOLS = [
    ("pool1/3x3_s2", (BATCH, 64, 112, 112), 3, 3, 2, 2, 0, 0, True),
    ("pool2/3x3_s2", (BATCH, 192, 56, 56), 3, 3, 2, 2, 0, 0, True),
    ("inception_3a/pool", (BATCH, 192, 28, 28), 3, 3, 1, 1, 1, 1, False),
    ("inception_3b/pool", (BATCH, 256, 28, 28), 3, 3, 1, 1, 1, 1, False),
    ("pool3/3x3_s2", (BATCH, 480, 28, 28), 3, 3, 2, 2, 0, 0, True),
    ("inception_4a/pool", (BATCH, 480, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("inception_4b/pool", (BATCH, 512, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("inception_4c/pool", (BATCH, 512, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("inception_4d/pool", (BATCH, 512, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("inception_4e/pool", (BATCH, 528, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("pool4/3x3_s2", (BATCH, 832, 14, 14), 3, 3, 2, 2, 0, 0, True),
    ("inception_5a/pool", (BATCH, 832, 7, 7), 3, 3, 1, 1, 1, 1, False),
    ("inception_5b/pool", (BATCH, 832, 7, 7), 3, 3, 1, 1, 1, 1, False),
]
RAGGED_POOLS = [
    ("odd HW, ceil, pad 1", (2, 3, 13, 11), 3, 3, 2, 2, 1, 1, True),
    ("odd HW, floor, pad 1", (2, 7, 9, 7), 3, 3, 2, 2, 1, 1, False),
    ("C=3, 2x2 floor", (3, 3, 15, 15), 2, 2, 2, 2, 0, 0, False),
    ("C=7, ceil, rect window", (2, 7, 10, 13), 3, 2, 2, 3, 0, 1, True),
]
# (name, shape, size, alpha, beta, k) of the 2 LRN layers, then ragged
LRNS = [
    ("pool1/norm1", (BATCH, 64, 56, 56), 5, 1e-4, 0.75, 1.0),
    ("conv2/norm2", (BATCH, 192, 56, 56), 5, 1e-4, 0.75, 1.0),
]
RAGGED_LRNS = [
    ("C=3, HW=35", (2, 3, 5, 7), 5, 1.0, 0.75, 1.0),
    ("C=7, HW=117, even window", (3, 7, 9, 13), 4, 1.0, 0.75, 2.0),
    ("beta 0.5", (2, 7, 9, 13), 5, 1.0, 0.5, 1.0),
    ("beta 1.0 (powf)", (2, 5, 3, 45), 3, 0.5, 1.0, 1.0),
]
LRN_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2e-2, 1e-2)}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# -- timing -------------------------------------------------------------------

def median_ms(fn, device, reps=TIMING_REPS, flush=None):
    """Median wall time of ``fn()`` in ms: CUDA events on the card (with
    the L2 flushed between calls when ``flush`` is given), the host clock
    on the CPU."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# -- phase 2: kernels against their plain versions ------------------------------

def _pool_input(shape, dtype, device, gen, ties):
    import torch
    if ties:
        x = torch.randint(-3, 4, shape, generator=gen, device=device)
        return x.to(dtype)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def check_kernels(device):
    """Hold each kernel against its plain version; returns, per kernel, the
    largest float32 error, the count of cases and the count of mismatches
    (outputs out of tolerance, or argmax codes that differ)."""
    import torch
    from bigdl_tpu_torch.ops import (cross_map_lrn, lrn_plain, max_pool2d,
                                     max_pool2d_plain)
    gen = torch.Generator(device=device).manual_seed(SEED)
    errs = {"max_pool2d_fwd": 0.0, "lrn_fwd": 0.0}
    cases = {"max_pool2d_fwd": 0, "lrn_fwd": 0}
    misses = {"max_pool2d_fwd": 0, "lrn_fwd": 0}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, kh, kw, sh, sw, ph, pw, ceil in POOLS + RAGGED_POOLS:
            for ties in (False, True):
                x = _pool_input(shape, dtype, device, gen, ties)
                geom = (kh, kw, sh, sw, ph, pw, ceil)
                yk, ik = max_pool2d(x, *geom, return_indices=True)
                yk_noidx = max_pool2d(x, *geom)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                yp, ip = max_pool2d_plain(x, *geom)
                err = max((yk.float() - yp.float()).abs().max().item(),
                          (yk_noidx.float() - yp.float()).abs().max().item())
                bad = (ik != ip).sum().item()
                if dtype == torch.float32:
                    errs["max_pool2d_fwd"] = max(errs["max_pool2d_fwd"], err)
                cases["max_pool2d_fwd"] += 1
                if err != 0.0 or bad:
                    misses["max_pool2d_fwd"] += 1
                    fail(f"max_pool2d {name} {tuple(shape)} {dtype} "
                         f"ties={ties}: not bit-equal to the plain version "
                         f"(max |dy| {err}, {bad} idx differ)")
        for name, shape, size, alpha, beta, k in LRNS + RAGGED_LRNS:
            x = torch.randn(shape, generator=gen, device=device).to(dtype)
            yk, sk = cross_map_lrn(x, size, alpha, beta, k,
                                   return_scale=True)
            yk_noscale = cross_map_lrn(x, size, alpha, beta, k)
            if device.type == "cuda":
                torch.cuda.synchronize()
            yp, sp = lrn_plain(x, size, alpha, beta, k)
            rtol, atol = LRN_TOL[str(dtype).split(".")[-1]]
            for got, want, what in ((yk, yp, "y"), (sk, sp, "scale"),
                                    (yk_noscale, yp, "y (no scale)")):
                ok = torch.allclose(got.float(), want.float(), rtol=rtol,
                                    atol=atol)
                err = (got.float() - want.float()).abs().max().item()
                if not ok or not torch.isfinite(got).all():
                    misses["lrn_fwd"] += 1
                    fail(f"lrn {name} {tuple(shape)} {dtype} {what}: max "
                         f"|err| {err} beyond rtol {rtol} / atol {atol}")
                if dtype == torch.float32:
                    errs["lrn_fwd"] = max(errs["lrn_fwd"], err)
            cases["lrn_fwd"] += 1
    log(f"kernels vs plain: max_pool2d_fwd bit-equal in "
        f"{cases['max_pool2d_fwd']} cases; lrn_fwd within tolerance in "
        f"{cases['lrn_fwd']} cases (f32 max |err| {errs['lrn_fwd']:.3g})")
    return errs, cases, misses


# -- phase 3: serving -----------------------------------------------------------

def build_model():
    from bigdl_tpu_torch.models import Inception_v1
    return Inception_v1(CLASSES).reset(SEED)


def make_rows(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((3, IMAGE, IMAGE)).astype(np.float32)
            for _ in range(n)]


def serve(device):
    """Drive the serving path; returns (report, launches, model, rows)."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.api import DLClassifier
    from bigdl_tpu_torch.serving import InferenceServer

    model = build_model()
    cpu_model = copy.deepcopy(model)
    clf = DLClassifier(model, (BATCH, 3, IMAGE, IMAGE), device=device)
    t0 = time.monotonic()
    server = InferenceServer(clf, batch_buckets=BUCKETS, device=device)
    warm_s = time.monotonic() - t0
    rows = make_rows(N_ROWS, SEED)
    wave_rows = {b: make_rows(b * WAVES[b], SEED + b) for b in BUCKETS}

    def timed_wave(batch_rows):
        done = {}
        t_sub = {}
        futs = []
        for i, r in enumerate(batch_rows):
            t_sub[i] = time.monotonic()
            f = server.submit(r)
            f.add_done_callback(
                lambda _f, i=i: done.__setitem__(i, time.monotonic()))
            futs.append(f)
        preds = [f.result(timeout=600) for f in futs]
        while len(done) < len(futs):     # callbacks run after result()
            time.sleep(0.001)
        return preds, [done[i] - t_sub[i] for i in range(len(futs))]

    try:
        ops.reset_launches()             # the main path starts here
        served, _ = timed_wave(rows)
        per_bucket = {}
        for b in BUCKETS:
            lats, preds_b = [], []
            t_b = time.monotonic()
            for w in range(WAVES[b]):
                p, lat = timed_wave(wave_rows[b][w * b:(w + 1) * b])
                preds_b += p
                lats += lat
            wall = time.monotonic() - t_b
            lats.sort()
            # a closed-loop smoke, not a throughput or tail measurement:
            # each wave is awaited before the next is sent, and with a few
            # dozen samples only the median and the maximum are reported
            per_bucket[b] = {"images": len(lats), "waves": WAVES[b],
                             "images_per_s": len(lats) / wall,
                             "p50_ms": 1e3 * lats[len(lats) // 2],
                             "max_ms": 1e3 * lats[-1],
                             "preds": preds_b}
        launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
        stats = server.stats()           # the main path ends here
    finally:
        if not server.drain(timeout=120):
            fail("server did not drain")

    forwards = sum(v["batches"] for v in stats["buckets"].values())
    total = N_ROWS + sum(b * WAVES[b] for b in BUCKETS)
    if stats["counters"].get("serve.completed") != total:
        fail(f"{stats['counters']} — expected {total} completed requests")
    if launches["max_pool2d"] != 13 * forwards or \
            launches["cross_map_lrn"] != 2 * forwards:
        fail(f"launches {launches} for {forwards} forwards: expected 13 "
             "max-pool and 2 LRN launches per forward")

    # predictions equal DLClassifier.predict on the same rows
    all_rows = rows + [r for b in BUCKETS for r in wave_rows[b]]
    all_served = served + [p for b in BUCKETS for p in per_bucket[b]["preds"]]
    offline = clf.predict(all_rows)
    if list(offline) != list(all_served):
        bad = sum(int(a != b) for a, b in zip(offline, all_served))
        fail(f"{bad} of {len(all_rows)} served predictions differ from "
             "DLClassifier.predict")

    # the same weights on the CPU (plain ops), TF32 off on the card
    x8 = torch.from_numpy(np.stack(rows[:CPU_ROWS]))
    with torch.inference_mode():
        lp_dev = model(x8.to(device)).float().cpu()
        lp_cpu = cpu_model.evaluate()(x8)
    if lp_dev.shape != (CPU_ROWS, CLASSES) or \
            not torch.isfinite(lp_dev).all():
        fail(f"device log-probs have shape {tuple(lp_dev.shape)} or are "
             "not finite")
    diff = (lp_dev - lp_cpu).abs().max().item()
    if diff > 1e-3 or not torch.equal(lp_dev.argmax(1), lp_cpu.argmax(1)):
        fail(f"device vs CPU log-probs: max |diff| {diff} (atol 1e-3), "
             f"argmax {lp_dev.argmax(1).tolist()} vs "
             f"{lp_cpu.argmax(1).tolist()}")
    if (lp_cpu.argmax(1) + 1).tolist() != list(served[:CPU_ROWS]):
        fail("served predictions disagree with the CPU run")
    log(f"serving: {total} requests answered in {forwards} forwards, equal "
        f"to DLClassifier.predict; {CPU_ROWS} rows match the CPU run "
        f"(max |dlogp| {diff:.3g}); launches {launches}")
    for b in BUCKETS:
        per_bucket[b].pop("preds")
    report = {"warmup_s": warm_s, "forwards": forwards, "requests": total,
              "classifier": clf,
              "cpu_max_abs_logp_diff": diff, "per_bucket": per_bucket,
              "forward_by_bucket": stats["buckets"],
              "latency_p50_ms": 1e3 * stats["latency_p50_s"]}
    return report, launches


# -- phase 4: timings -----------------------------------------------------------

def time_forwards(clf, device):
    """Median ms of one bucket forward as a worker runs it (packed host
    rows to the device, predictions back to the host), per bucket."""
    rows = make_rows(max(BUCKETS), SEED + 7)
    out = {}
    for b in BUCKETS:
        x = clf._pack(rows[:b], size=b)
        out[b] = median_ms(lambda: clf._run(x).cpu(), device)
    return out


def time_kernels(device):
    """Per kernel, summed over one batch-32 forward's calls: median kernel
    time, bound, plain version, library call."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import (cross_map_lrn, lrn_plain, max_pool2d,
                                     max_pool2d_plain, pool_geometry)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device) \
        if device.type == "cuda" else None
    out = {}
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for _, shape, kh, kw, sh, sw, ph, pw, ceil in POOLS:
        x = torch.randn(shape, generator=gen, device=device)
        n, c, h, w = shape
        oh, ow, _, _ = pool_geometry(h, w, kh, kw, sh, sw, ph, pw, ceil)
        nbytes = 4 * (x.numel() + n * c * oh * ow)
        nops = n * c * oh * ow * kh * kw
        t["bound_ms"] += 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                   nops / F32_FLOPS)
        geom = (kh, kw, sh, sw, ph, pw, ceil)
        t["ms"] += median_ms(lambda: max_pool2d(x, *geom), device,
                             flush=flush)
        t["plain_ms"] += median_ms(lambda: max_pool2d_plain(x, *geom),
                                   device, flush=flush)
        t["library_ms"] += median_ms(
            lambda: F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw),
                                 ceil_mode=ceil), device, flush=flush)
    out["max_pool2d_fwd"] = dict(t, bound_by="bytes")
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for _, shape, size, alpha, beta, k in LRNS:
        x = torch.randn(shape, generator=gen, device=device)
        nbytes = 4 * 2 * x.numel()
        nops = x.numel() * (2 * size + 6)
        t["bound_ms"] += 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                   nops / F32_FLOPS)
        t["ms"] += median_ms(lambda: cross_map_lrn(x, size, alpha, beta, k),
                             device, flush=flush)
        t["plain_ms"] += median_ms(lambda: lrn_plain(x, size, alpha, beta, k),
                                   device, flush=flush)
        t["library_ms"] += median_ms(
            lambda: F.local_response_norm(x, size, alpha, beta, k), device,
            flush=flush)
    out["lrn_fwd"] = dict(t, bound_by="bytes")
    return out


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


KERNELS = [
    {"name": "max_pool2d_fwd", "wrapper": "max_pool2d", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/max_pool.cu",
     "replaces": "bigdl_tpu/ops/pooling.py:99"},
    {"name": "lrn_fwd", "wrapper": "cross_map_lrn", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/lrn.cu",
     "replaces": "bigdl_tpu/ops/lrn.py:123"},
]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a machine with a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bigdl_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    # full float32 everywhere, so the card and the CPU compute alike
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 1
    log(f"card: {card_line()}")
    t0 = time.perf_counter()
    _build.load()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc "
        f"{' '.join(_build.ARCH)}, {len(_build.sources())} sources)")

    # phase 2
    errs, cases, misses = check_kernels(device)
    # phase 3
    report, launches = serve(device)
    # phase 4
    times = time_kernels(device)
    fwd_ms = time_forwards(report.pop("classifier"), device)
    for b in BUCKETS:
        log(f"forward bucket {b}: {fwd_ms[b]:.3f} ms median of "
            f"{TIMING_REPS} ({b / fwd_ms[b] * 1e3:.1f} images/s)")
    report["forward_ms"] = fwd_ms
    for b, r in report["per_bucket"].items():
        log(f"serving bucket {b} (closed loop, {r['waves']} waves of {b}): "
            f"{r['images_per_s']:.1f} images/s, request p50 "
            f"{r['p50_ms']:.2f} ms, max {r['max_ms']:.2f} ms "
            f"({r['images']} requests)")
    log("serving: " + json.dumps(report))
    kernels = []
    for k in KERNELS:
        tk = times[k["name"]]
        kernels.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": launches[k["wrapper"]],
            "max_abs_err": errs[k["name"]],
            "match": misses[k["name"]] == 0, "cases": cases[k["name"]],
            "mismatches": misses[k["name"]], "ms": tk["ms"],
            "plain_ms": tk["plain_ms"], "bound_ms": tk["bound_ms"],
            "bound_by": tk["bound_by"], "library_ms": tk["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
