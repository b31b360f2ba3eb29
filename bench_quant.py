#!/usr/bin/env python3
"""The port's quantized matmuls K13-K15 on the card: per-stage times of a
checkout, a parent checkout against this one, the bf16 kernel's ptxas
figures, the mutation check of ``chip_smoke.py`` phase 2c, and an
ablation of the bf16 kernel.

Run from the root of a checkout on a machine with one CUDA card:

    python3 bench_quant.py times [<checkout>] [--out <dir>]
    python3 bench_quant.py ab <parent checkout> [--out <dir>]
    python3 bench_quant.py ptxas
    python3 bench_quant.py mutants
    python3 bench_quant.py ablate

``times`` runs this checkout's ``chip_smoke.time_quant_kernels`` (every
product of the quantized Inception-v1 forward at buckets 8 and 32: CUDA
events, torch.profiler device time, the wrapper's host time, the plain
version and ``F.linear`` on the widened weight) against the package of
``<checkout>`` (this one by default), prints the sums per stage, and
writes every product's row to ``<dir>/bench_quant_<label>.json``
(``build/bench_quant`` by default).
``ab`` does that in the parent and in this checkout in turns (parent,
this, this, parent), each in its own process, and runs phase 3d
(``serve_quantized``: w8 bf16 serving, logits against the CPU) in each.
Make the parent with ``git archive <commit> bigdl_tpu_torch | tar -x -C
build/parent`` (``build/`` is not committed).  ``ptxas`` compiles the
quantized-matmul sources with ``-Xptxas -v`` under ``build/ptxas/`` and
prints each bf16 kernel's registers, shared memory and spills and whether
ptxas serialized its wgmma (info C7515).  ``mutants`` copies the port and
``chip_smoke.py`` under ``build/mutant_<name>/``, breaks K15's nibble
decoder in one copy and the split-K pass in another, and fails unless
``check_quant_kernels`` fails in every copy.  ``ablate`` times K13 (int8,
bf16, device time) at ABLATE_SHAPES in copies of the port with one part
of the kernel taken out or one choice of its plan changed (ABLATIONS),
each built anew under ``build/ablate_<name>/``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

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
             if ln.startswith(("STAGE ", "RESULT "))]
    print("\n".join(lines) if lines else f"{label}: rc {r.returncode}",
          flush=True)
    if r.returncode:
        print(r.stderr[-3000:], flush=True)
    return r.returncode


def cmd_ab(parent: str, out: str) -> int:
    rc = 0
    for label, tree in (("parent 1", parent), ("change 1", HERE),
                        ("change 2", HERE), ("parent 2", parent)):
        rc = rc or run_times(label, tree, True, out)
    return rc


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


def ptxas_lines(log: str):
    """One line a kernel from ``nvcc -Xptxas -v``'s log: the bf16 kernel's
    weight kind and N tile (with its shared memory at bm 128), or another
    kernel's name; registers and spills."""
    out, name, spills = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            m2 = re.search(r"dequant_mm_wgmmaI\w*?(Int8|E4m3|Int4)ELi(\d+)E",
                           m.group(1))
            name = (f"dequant_mm_wgmma {m2.group(1)} BN {m2.group(2)} "
                    f"(smem {smem_bytes(m2.group(1), int(m2.group(2)))} B "
                    "at bm 128)" if m2 else m.group(1)[:60])
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
        print("C7515 (wgmma serialized): " + (
            f"REPORTED {len(c7515)} times: {c7515[:2]}" if c7515
            else "not reported"), flush=True)
        if p.returncode:
            print(out[-3000:])
            rc = p.returncode
    return rc


# K15 and the split-K pass broken one way each: each copy must fail 2c
MUTANTS = {
    # ((b >> 4) & 15) - 8: the high nibble without its sign
    "k15_high_nibble_unsigned": (
        BF16_CUH, "biased4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8.0f)",
        "biased4((w >> 4) & 0x0F0F0F0Fu, 8.0f)"),
    "splitk_drops_last_split": (
        QUANT_CU, "for (int j = 1; j < splits; ++j)",
        "for (int j = 1; j < splits - 1; ++j)"),
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
    for name, (path, text, broken) in MUTANTS.items():
        root = os.path.join("build", f"mutant_{name}")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        shutil.copytree("bigdl_tpu_torch", f"{root}/bigdl_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy("chip_smoke.py", root)
        src = open(f"{root}/{path}").read()
        if text not in src:
            raise SystemExit(f"mutant {name}: {path} no longer holds the "
                             "text to break")
        open(f"{root}/{path}", "w").write(src.replace(text, broken))
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
        root = os.path.join("build", "ablate_" + re.sub(r"\W", "_", name))
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        shutil.copytree("bigdl_tpu_torch", f"{root}/bigdl_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy("chip_smoke.py", root)
        for path, text, repl in edits:
            src = open(f"{root}/{path}").read()
            if text not in src:
                raise SystemExit(f"ablation {name}: {path} no longer holds "
                                 "the text to change")
            open(f"{root}/{path}", "w").write(src.replace(text, repl))
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


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_quant: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
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
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
