#!/usr/bin/env python3
"""The port's quantized matmuls K13-K15 on the card: per-stage times of a
checkout, a parent checkout against this one, the kernels' ptxas figures,
the mutation check of ``chip_smoke.py`` phase 2c, and ablations of the bf16
and the f32 kernels.

Run from the root of a checkout on a machine with one CUDA card:

    python3 bench_quant.py times [<checkout>] [--out <dir>]
    python3 bench_quant.py ab <parent checkout> [--out <dir>]
    python3 bench_quant.py ptxas
    python3 bench_quant.py mutants
    python3 bench_quant.py ablate
    python3 bench_quant.py ablate-f32

``times`` runs this checkout's ``chip_smoke.time_quant_kernels`` (every
product of the quantized Inception-v1 forward at buckets 8 and 32: K13 int8
in bf16 at both buckets and in f32 at batch 32; K13 e4m3, K15 and K14 at the
classifier at both buckets, K13 e4m3 and K15 also in f32 at batch 32; CUDA
events, torch.profiler device time, the wrapper's host time, the plain
version and ``F.linear`` on the widened weight) against the package of
``<checkout>`` (this one by default), prints the sums per stage, and
writes every product's row to ``<dir>/bench_quant_<label>.json``
(``build/bench_quant`` by default).
``ab`` does that in the parent and in this checkout in turns (parent,
this, this, parent), each in its own process, and runs phase 3d in each:
``serve_quantized`` (w8 bf16 serving, logits against the CPU) and
``serve_quantized_f32`` (the default f32 w8 classifier, logits against the
CPU) with its forward per bucket and the profiler's device time of the
forward and of its K13 kernels (``F32FORWARD`` lines).
Make the parent with ``git archive <commit> bigdl_tpu_torch | tar -x -C
build/parent`` (``build/`` is not committed).  ``ptxas`` compiles the
quantized-matmul sources with ``-Xptxas -v`` under ``build/ptxas/`` and
prints each kernel's registers, shared memory and spills (the bf16 kernel
by weight kind and N tile, the f32 kernel by weight kind and block tile,
K14 by output type and N tile) and whether ptxas serialized a wgmma (info
C7515: the bf16 kernel, K14).  ``mutants`` copies the port and
``chip_smoke.py`` under ``build/mutant_<name>/``, breaks one kernel in
each copy (K15's nibble decoder, the split-K pass, the f32 kernel's ring
read a stage late, K14's sum of the split partial sums without the last
split), and fails unless ``check_quant_kernels`` fails in every copy.
``ablate`` times K13 (int8, bf16, device time) at ABLATE_SHAPES in copies
of the port with one part of the kernel taken out or one choice of its
plan changed (ABLATIONS), each built anew under ``build/ablate_<name>/``.
``ablate-f32`` times the f32 K13 (int8) over the batch-32 f32 w8 forward's
56 products (CUDA events, L2 flushed) with a part taken out or a choice
changed (F32_ABLATIONS): edited copies of ``quant_matmul.cu`` built in
parallel beside the bf16 objects, built once, all in one process.  The
machinery of copies, edits and A/B runs is ``bench_common.py``'s.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import bench_common as bc

HERE = bc.HERE

# one run of ``times``: this checkout's chip_smoke against <checkout>'s
# package; argv: label, checkout, 3d ("1" runs serve_quantized), this
# checkout, the output directory
_RUN = """
import importlib.util, json, os, sys, torch
sys.path.insert(0, sys.argv[2])
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(sys.argv[4], "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
from bigdl_tpu_torch.ops import quant
probe = quant.quantize_model(cs.build_model().to(dev), "w8",
                             cast_rest=torch.bfloat16)
prods = {b: cs.quant_products(probe, dev, b, torch.bfloat16)
         for b in cs.BUCKETS}
del probe
label = sys.argv[1]
sums, rows = cs.time_quant_kernels(dev, prods)
res = {"label": label, "card": cs.card_line(), "package": sys.argv[2],
       "sums": sums}
if sys.argv[3] == "1":
    report, launches, _ = cs.serve_quantized(dev)
    res["serve_quantized"] = {k: report[k] for k in (
        "cpu_max_abs_logit_diff", "cpu_logit_limit", "cpu_max_abs_logp_diff",
        "cpu_logp_limit", "forwards", "requests")}
    res["serve_quantized"]["launches"] = launches
    report, launches, clf = cs.serve_quantized_f32(dev)
    # the parent's f32 K13 is dequant_mm_f32
    report.update(cs.time_quantized_f32(res["card"], clf, dev, dict(
        cs.F32_K13_KERNELS, dequant_mm_f32="dequant_mm_f32<")))
    res["serve_quantized_f32"] = dict(report, launches=launches)
    for b in cs.BUCKETS:
        p = report[f"profile_bucket_{b}"]
        print(f"F32FORWARD {label} | bucket {b} | forward "
              f"{report['forward_ms'][b]:.3f} ms | device "
              f"{p['device_ms']:.3f} ms | K13 device "
              f"{sum(p['groups'].values()):.3f} ms | busy "
              f"{p['busy_share']:.3f}", flush=True)
os.makedirs(sys.argv[5], exist_ok=True)
out = os.path.join(sys.argv[5],
                   "bench_quant_" + label.replace(" ", "_") + ".json")
with open(out, "w") as f:
    json.dump(dict(res, rows=rows), f, indent=1)
for name, t in sums.items():
    for b, stages in t["stages"].items():
        for s, v in stages.items():
            print(f"STAGE {label} | {name} | bucket {b} | {s} | calls "
                  f"{v['calls']} | device {v['device_ms']} | events "
                  f"{v['ms']:.4f} | host {v['host_ms']:.4f} | library device "
                  f"{v['library_device_ms']} | library events "
                  f"{v['library_ms']} | bound {v['bound_ms']:.4f}",
                  flush=True)
print("RESULT " + json.dumps({k: v for k, v in res.items() if k != "sums"}),
      flush=True)
"""


def run_times(label: str, checkout: str, with_3d: bool, out: str) -> int:
    r = subprocess.run([sys.executable, "-c", _RUN, label, checkout,
                        "1" if with_3d else "0", HERE, out], cwd=checkout,
                       capture_output=True, text=True)
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith(("STAGE ", "F32FORWARD ", "RESULT "))]
    print("\n".join(lines) if lines else f"{label}: rc {r.returncode}",
          flush=True)
    if r.returncode:
        print(r.stderr[-3000:], flush=True)
    return r.returncode


def cmd_ab(parent: str, out: str) -> int:
    return bc.ab(parent, lambda label, tree: run_times(label, tree, True,
                                                       out))


QUANT_SOURCES = ["bigdl_tpu_torch/csrc/quant_bf16_int8.cu",
                 "bigdl_tpu_torch/csrc/quant_bf16_e4m3.cu",
                 "bigdl_tpu_torch/csrc/quant_bf16_int4.cu",
                 "bigdl_tpu_torch/csrc/quant_matmul.cu"]
BF16_CUH = "bigdl_tpu_torch/csrc/quant_bf16.cuh"
QUANT_CU = "bigdl_tpu_torch/csrc/quant_matmul.cu"


def smem_bytes(kind: str, bn: int, bm: int = 128) -> int:
    """Dynamic shared memory of the bf16 kernel at (bm, bn): quant_bf16.cuh
    Layout's sum (x ring, two buffers of widened tiles, packed ring,
    mbarriers, 1024 for the alignment) at launch_bf16's ring depth."""
    halves, step_bytes = (2, 32) if kind == "Int4" else (1, 64)
    stages = 3 if bm == 64 and bn <= 192 else 4
    b_half = -(-bn * 128 // halves // 1024) * 1024
    return (stages * bm * 128 + 2 * halves * b_half +
            stages * bn * step_bytes + (2 * stages + 4) * 8 + 1024)


# the f32 kernel's tiles by its template arguments (micro-tile columns,
# column lanes): (rows, columns) a block
F32_TILES = {(8, 16): (64, 128), (8, 8): (128, 64), (4, 8): (128, 32)}


def f32_smem_bytes(kind: str, bm: int, bn: int) -> int:
    """Dynamic shared memory of the f32 kernel (quant_matmul.cu
    launch_f32_tile): x's 3-stage ring and the widened weight in rows of
    20 floats, the packed weight's ring (16 bytes a row a step, int4 8);
    or the staged output tile (rows of bn + 8 floats) where larger."""
    ring = 4 * (3 * bm * 20 + bn * 20) + 3 * bn * (8 if kind == "Int4"
                                                    else 16)
    return max(ring, 4 * bm * (bn + 8))


def kernel_name(mangled: str) -> str:
    """A readable name for a quantized kernel: the bf16 kernel's weight
    kind and N tile (with its shared memory at bm 128), the f32 kernel's
    weight kind and block tile, K14's output type and N tile, or the
    first 60 characters of another kernel's mangled name."""
    m = re.search(r"dequant_mm_wgmmaI\w*?(Int8|E4m3|Int4)ELi(\d+)E", mangled)
    if m:
        return (f"dequant_mm_wgmma {m.group(1)} BN {m.group(2)} (smem "
                f"{smem_bytes(m.group(1), int(m.group(2)))} B at bm 128)")
    m = re.search(r"f32_mmI\w*?F(Int8|E4m3|Int4)ELi(\d+)ELi(\d+)E", mangled)
    if m:
        bm, bn = F32_TILES[(int(m.group(2)), int(m.group(3)))]
        return (f"f32_mm {m.group(1)} {bm} x {bn} (smem "
                f"{f32_smem_bytes(m.group(1), bm, bn)} B)")
    m = re.search(r"a8_wgmmaI(f|13__nv_bfloat16)Li(\d+)E", mangled)
    if m:
        bn = int(m.group(2))
        return (f"a8_wgmma (K14) y {'f32' if m.group(1) == 'f' else 'bf16'} "
                f"BN {bn} (smem {4 * (64 + bn) * 128 + 1024} B)")
    return mangled[:60]


def ptxas_lines(log: str):
    """One line a kernel from ``nvcc -Xptxas -v``'s log (:func:`kernel_name`):
    registers and spills."""
    out, name, spills = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        elif name and "spill" in ln:
            spills = ln.strip()
        elif name and "Used" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spills}")
    return out


def cmd_ptxas() -> int:
    sys.path.insert(0, HERE)
    from bigdl_tpu_torch.ops import _build
    os.makedirs("build/ptxas", exist_ok=True)
    procs = [(cu, subprocess.Popen(
        [_build._nvcc(), *_build.ARCH, *_build.FLAGS, "-Xptxas", "-v", "-c",
         cu, "-o", f"build/ptxas/{os.path.basename(cu)}.o"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cu in QUANT_SOURCES]
    rc = 0
    for cu, p in procs:
        out, _ = p.communicate()
        print(f"nvcc -Xptxas -v {cu}: rc {p.returncode}")
        print("\n".join(ptxas_lines(out)))
        c7515 = [ln for ln in out.splitlines() if "C7515" in ln]
        print("C7515 (wgmma serialized; quant_matmul.cu: K14): " + (
            f"REPORTED {len(c7515)} times: {c7515[:2]}" if c7515
            else "not reported"), flush=True)
        if p.returncode:
            print(out[-3000:])
            rc = p.returncode
    return rc


# K15, the split-K pass, the f32 kernel's ring and K14's split sums broken
# one way each: each copy must fail 2c
MUTANTS = {
    # ((b >> 4) & 15) - 8: the high nibble without its sign
    "k15_high_nibble_unsigned": (
        BF16_CUH, "biased4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8.0f)",
        "biased4((w >> 4) & 0x0F0F0F0Fu, 8.0f)"),
    "splitk_drops_last_split": (
        QUANT_CU, "for (int j = 1; j < splits; ++j)",
        "for (int j = 1; j < splits - 1; ++j)"),
    # the f32 kernel's products read x from the stage of the step before
    "f32_reads_ring_stage_late": (
        QUANT_CU,
        "const float* xr = xs + s * kBM * kFLd + ao * kFLd;",
        "const float* xr = xs + (it + kFStages - 1) % kFStages * kBM * kFLd"
        " + ao * kFLd;"),
    # K14's last block of a tile adds every split's partial sums but the last
    "k14_drops_last_split": (
        QUANT_CU, "for (int j = 0; j < a.splits; ++j)",
        "for (int j = 0; j < a.splits - 1; ++j)"),
}

_CHECK_2C = """
import torch, chip_smoke as cs
from bigdl_tpu_torch.ops import quant
dev = torch.device("cuda", 0)
probe = quant.quantize_model(cs.build_model().to(dev), "w8",
                             cast_rest=torch.bfloat16)
prods = {b: cs.quant_products(probe, dev, b, torch.bfloat16)
         for b in cs.BUCKETS}
lin = [(m, k, n) for b in cs.BUCKETS for _, kind, m, k, n, _ in prods[b]
       if kind == "linear"]
cs.check_quant_kernels(dev, {
    "w8_matmul": [(m, k, n) for b in cs.BUCKETS
                  for _, _, m, k, n, _ in prods[b]],
    "f8_matmul": lin, "a8_matmul": lin, "w4_matmul": lin})
"""


def cmd_mutants() -> int:
    caught = True
    for name, edit in MUTANTS.items():
        root = bc.copy_port(os.path.join(HERE, "build", f"mutant_{name}"))
        bc.apply_edits(root, [edit], f"mutant {name}")
        r = subprocess.run([sys.executable, "-c", _CHECK_2C], cwd=root,
                           capture_output=True, text=True)
        why = [ln for ln in r.stderr.splitlines()
               if "FAILED" in ln or "Error" in ln]
        print(f"mutant {name}: rc {r.returncode}; "
              f"{why[-1] if why else r.stderr[-300:]}", flush=True)
        caught = caught and r.returncode != 0
        shutil.rmtree(root, ignore_errors=True)
    print("every mutant failed phase 2c" if caught else
          "A MUTANT PASSED PHASE 2c")
    return 0 if caught else 1


# ablate: what two parts of the bf16 kernel cost, and three of its choices,
# at path shapes of the batch-32 forward (conv2/3x3 and inception_3b/3x3,
# unsplit; 4a/1x1, 4c/1x1 and 4e/1x1, two splits; 5a/1x1, seven; the
# classifier, sixteen), K13 int8, device time
ABLATE_SHAPES = [(100352, 576, 192), (25088, 1152, 192), (6272, 480, 192),
                 (6272, 512, 128), (6272, 528, 256), (1568, 832, 256),
                 (32, 1024, 1000)]
_NO_WIDENING = [(BF16_CUH, "      widen_units<W, BN, T>(",
                 "      if (n_iter < 0) widen_units<W, BN, T>(")]
_NO_PRODUCTS = [(BF16_CUH, "    wg::Ss<kC>::template mma<kFirst>(",
                 "    if (b == 1u) wg::Ss<kC>::template mma<kFirst>(")]
_STAGES_4 = [(BF16_CUH, "  a.stages = a.bm == 64 && a.bn <= 192 ? 3 : 4;",
              "  a.stages = 4;")]
# (file, text, replacement): copies of the sources with a part taken out
# or a choice changed; a name with "one split" also plans every shape
# unsplit, one with "bm 128" plans 128 rows a block where the plan has 192
ABLATIONS = {
    "as is": [],
    "no widening": _NO_WIDENING,
    "no products": _NO_PRODUCTS,
    "one split": [],
    "4 stages everywhere": _STAGES_4,
    "bm 128 at most": [],
}

_ABLATE_RUN = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from bigdl_tpu_torch.ops import quant
plain = quant.bf16_plan
if "one split" in sys.argv[2]:
    quant.bf16_plan = lambda m, k, n, nib=False, sms=132: plain(
        m, k, n, nib, sms)._replace(splits=1, per=plain(m, k, n, nib).steps)
if "bm 128" in sys.argv[2]:
    quant.bf16_plan = lambda m, k, n, nib=False, sms=132: plain(
        m, k, n, nib, sms)._replace(bm=min(128, plain(m, k, n, nib).bm))
dev = torch.device("cuda", 0)
flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
g = torch.Generator(device=dev).manual_seed(0)
out = {}
for m, k, n in json.loads(sys.argv[3]):
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    qt = quant.pack(torch.randn((n, k), generator=g, device=dev))
    out[f"{m}x{k}x{n}"] = round(1e3 * cs.device_ms(
        lambda: quant.w8_matmul(x, qt["q8"], qt["scale"]), flush), 2)
print("ABLATE " + json.dumps(out), flush=True)
"""


def cmd_ablate() -> int:
    rc = 0
    for name, edits in ABLATIONS.items():
        root = bc.copy_port(os.path.join(
            HERE, "build", "ablate_" + re.sub(r"\W", "_", name)))
        bc.apply_edits(root, edits, f"ablation {name}")
        r = subprocess.run([sys.executable, "-c", _ABLATE_RUN, root,
                            name,
                            json.dumps(ABLATE_SHAPES)],
                           cwd=root, capture_output=True, text=True)
        got = [ln for ln in r.stdout.splitlines() if ln.startswith("ABLATE")]
        print(f"{name}: " + (got[-1][7:] if got else
                             f"rc {r.returncode} {r.stderr[-800:]}"),
              flush=True)
        rc = rc or r.returncode
        shutil.rmtree(root, ignore_errors=True)
    return rc


# ablate-f32: the f32 K13's parts and plan choices, each an edited copy of
# quant_matmul.cu (the bf16 objects built once) or a setting of the plan,
# timed over the batch-32 f32 w8 forward's 56 products
_NO_PRODUCTS_F32 = [(QUANT_CU, "    for (int kk = 0; kk < kFK; kk += 4) {",
                     "    for (int kk = 0; kk < kFK * (n_iter < 0); kk += 4) "
                     "{")]
_NO_COPIES_F32 = [(QUANT_CU, "    if (it + kFStages - 1 < n_iter) "
                   "load(it + kFStages - 1);",
                   "    if (n_iter < 0) load(it + kFStages - 1);")]
_STAGES_4_F32 = [(QUANT_CU, "constexpr int kFThreads = 128, kFStages = 3;",
                  "constexpr int kFThreads = 128, kFStages = 4;")]
# name: (edits of quant_matmul.cu, plan settings of ops/quant.py)
F32_ABLATIONS = {
    "as is": ([], {}),
    "no products": (_NO_PRODUCTS_F32, {}),
    "no copies after the first stages": (_NO_COPIES_F32, {}),
    "4 stages": (_STAGES_4_F32, {}),
    "fill 1 block an SM": ([], {"F32_BLOCKS_PER_SM": 1}),
    "fill 3 blocks an SM": ([], {"F32_BLOCKS_PER_SM": 3}),
}

_ABLATE_F32_RUN = """
import json, os, sys, torch
sys.path.insert(0, os.getcwd())
import bench_common, chip_smoke as cs
from bigdl_tpu_torch.ops import _build, quant
names = json.loads(sys.argv[1])
libs = {name: bench_common.load_library(lib) for name, lib in names.items()}
settings = json.loads(sys.argv[2])
plain = {k: getattr(quant, k) for k in ("F32_BLOCKS_PER_SM",)}
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
probe = quant.quantize_model(cs.build_model().to(dev), "w8")
counts = {}
for _, _, m, k, n, _ in cs.quant_products(probe, dev, cs.BATCH, torch.float32):
    counts[(m, k, n)] = counts.get((m, k, n), 0) + 1
del probe
g = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
ops = {mkn: (torch.randn(mkn[:2], generator=g, device=dev),
             quant.pack(torch.randn((mkn[2], mkn[1]), generator=g,
                                    device=dev))) for mkn in counts}
flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
for name in list(names) + [list(names)[0]]:
    _build._lib = libs[name]
    for key, v in plain.items():
        setattr(quant, key, settings[name].get(key, v))
    quant.f32_plan.cache_clear()
    per = {}
    for (m, k, n), (x, qt) in ops.items():
        per[f"{m}x{k}x{n}"] = cs.median_ms(
            lambda: quant.w8_matmul(x, qt["q8"], qt["scale"]), dev,
            flush=flush)
    total = sum(counts[tuple(map(int, key.split("x")))] * t
                for key, t in per.items())
    print("ABLATE-F32 " + json.dumps({"name": name, "sum_ms": total,
                                      "per_product_ms": per}), flush=True)
"""


def cmd_ablate_f32() -> int:
    root = os.path.join(HERE, "build", "ablate_f32")
    libs = bc.build_libraries({name: edits for name, (edits, _) in
                               F32_ABLATIONS.items()}, root, [QUANT_CU],
                              extra=QUANT_SOURCES[:3])
    settings = {name: plan for name, (_, plan) in F32_ABLATIONS.items()}
    r = subprocess.run([sys.executable, "-c", _ABLATE_F32_RUN,
                        json.dumps(libs), json.dumps(settings)],
                       cwd=HERE, capture_output=True, text=True)
    for ln in r.stdout.splitlines():
        if ln.startswith("ABLATE-F32 "):
            row = json.loads(ln[11:])
            print(f"{row['name']}: sum over the batch-32 f32 w8 forward's "
                  f"products {row['sum_ms']:.4f} ms (CUDA events); "
                  + json.dumps(row["per_product_ms"]), flush=True)
    if r.returncode:
        print(r.stderr[-3000:], flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return r.returncode


def main(argv) -> int:
    if not bc.card_or_exit("bench_quant"):
        return 2
    out = os.path.join(HERE, "build", "bench_quant")
    if "--out" in argv[:-1]:
        i = argv.index("--out")
        out = os.path.abspath(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    cmd = argv[0] if argv else ""
    if cmd == "times" and len(argv) <= 2:
        tree = os.path.abspath(argv[1]) if len(argv) == 2 else HERE
        return run_times("parent" if len(argv) == 2 else "this", tree,
                         False, out)
    if cmd == "ab" and len(argv) == 2:
        return cmd_ab(os.path.abspath(argv[1]), out)
    if cmd == "ptxas":
        return cmd_ptxas()
    if cmd == "mutants":
        return cmd_mutants()
    if cmd == "ablate":
        return cmd_ablate()
    if cmd == "ablate-f32":
        return cmd_ablate_f32()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
