#!/usr/bin/env python3
"""The port's max-pool kernels K1 and K3 on the card: a parent checkout
against this one, the mutation check of ``chip_smoke.py`` phases 2 and 2b,
ablations of the kernels and of their plan, and the kernels' instructions.
(``bench_pool.py`` is the JAX package's and times the TPU kernels.)

Run from the root of a checkout on a machine with one CUDA card:

    python3 bench_maxpool.py ab <parent checkout> [--out <dir>]
    python3 bench_maxpool.py mutants
    python3 bench_maxpool.py ablate [<name> ...]
    python3 bench_maxpool.py sass [<parent checkout>]

``ab`` runs the parent and this checkout in turns (parent, this, this,
parent), each in its own process with its own package and this
checkout's ``chip_smoke.time_pool_layers``: K1 in bf16 with its index (as
training calls it) and in f32 without (as serving does), and K3 in bf16,
at each of Inception-v1's 13 pools at batch 32 by CUDA events (L2
flushed) and torch.profiler device time, ATen's calls beside them
(``F.max_pool2d``, ``max_pool2d_with_indices_backward``); then the bf16
Inception-v1 training step at batch 32 (median host time of the last 20
of 30 steps, and the profiler's device time a step) and the f32 serving
forward at bucket 32 (median time as a worker runs it, and its device
time).  Each run writes its rows to ``<dir>/bench_maxpool_<label>.json``
(``build/bench_maxpool`` by default).  Make the parent with ``git archive
<commit> bigdl_tpu_torch chip_smoke.py | tar -x -C build/parent``
(``build/`` is not committed).
``mutants`` builds edited copies of ``csrc/max_pool.cu`` under
``build/maxpool_mutants/`` (K3 summing window rows in descending order, K1
comparing with ``>=``, K1's band halo one row short, a K1 tile's halo one
column short, the misaligned head of a staged span skipped, K1 reading a
window wholly past the plane), each its own library beside ``lrn.cu``,
and fails unless ``check_kernels`` (phase 2) or ``check_backward_kernels``
(phase 2b) fails on every one.
``ablate`` times K1 and K3 (device time, summed over the 13 pools) with a
part of the kernels taken out (edited copies of ``max_pool.cu``, built in
parallel) or a setting of ``ops/pooling.py``'s plan changed (ABLATIONS,
or those named, beside the kernels as they are).
``sass`` compiles ``max_pool.cu`` of this checkout (and of a parent) to a
cubin and counts, per kernel, its SASS instructions and those of integer
division (calls, ``MUFU.RCP`` sequences).  The machinery of copies,
edits and A/B runs is ``bench_common.py``'s.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import bench_common as bc

HERE = bc.HERE
POOL_CU = "bigdl_tpu_torch/csrc/max_pool.cu"
LRN_CU = "bigdl_tpu_torch/csrc/lrn.cu"

# one run of ``ab``: this checkout's chip_smoke against <checkout>'s
# package; argv: label, checkout, this checkout, the output directory
_RUN = """
import importlib.util, json, os, sys, torch
sys.path.insert(0, sys.argv[2])
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(sys.argv[3], "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
label, card = sys.argv[1], cs.card_line()
res = {"label": label, "card": card, "package": sys.argv[2], "kernels": {}}
for key, dtype, bwd in (("K1 bf16 with index", torch.bfloat16, False),
                        ("K1 f32", torch.float32, False),
                        ("K3 bf16", torch.bfloat16, True)):
    rows = cs.time_pool_layers(dev, dtype, bwd, plain=False)
    res["kernels"][key] = cs.pool_sums(rows)
    for r in rows:
        print(f"LAYER {label} | {key} | {r['layer']} | events "
              f"{r['ms']:.4f} | device {cs.fmt_ms(r['device_ms'])} | bound "
              f"{r['bound_ms']:.4f} | ATen events {r['library_ms']:.4f} | "
              f"ATen device {cs.fmt_ms(r['library_device_ms'])}", flush=True)
    t = res["kernels"][key]
    print(f"SUM {label} | {key} | events {t['ms']:.4f} | device "
          f"{cs.fmt_ms(t['device_ms'])} | bound {t['bound_ms']:.4f} | ATen "
          f"events {t['library_ms']:.4f} | ATen device "
          f"{cs.fmt_ms(t['library_device_ms'])}", flush=True)
from bigdl_tpu_torch.models import Inception_v1
opt = cs.make_trainer(Inception_v1(cs.CLASSES, dropout=0.4).reset(cs.SEED),
                      cs.make_samples(cs.TRAIN_SAMPLES, cs.SEED + 100),
                      cs.BATCH, cs.TRAIN_STEPS, True, dev)
opt.optimize()
step = cs.step_ms(opt)
prof = cs.profile_train_steps(dev, True)
res["train_bf16"] = {"step_ms": step, "profile": prof}
print(f"STEP {label} | bf16 train step | wall {step:.3f} ms | device "
      f"{prof['device_ms']:.3f} ms", flush=True)
from bigdl_tpu_torch.api import DLClassifier
clf = DLClassifier(cs.build_model(), (cs.BATCH, 3, cs.IMAGE, cs.IMAGE),
                   device=dev)
fwd = cs.time_forwards(clf, dev)[cs.BATCH]
prof = cs.profile_forward(clf, dev, cs.BATCH)
res["serve_f32"] = {"forward_ms": fwd, "profile": prof}
print(f"STEP {label} | f32 forward, bucket {cs.BATCH} | wall {fwd:.3f} ms | "
      f"device {prof['device_ms']:.3f} ms", flush=True)
os.makedirs(sys.argv[4], exist_ok=True)
with open(os.path.join(sys.argv[4], "bench_maxpool_" +
                       label.replace(" ", "_") + ".json"), "w") as f:
    json.dump(res, f, indent=1)
"""


def cmd_ab(parent: str, out: str) -> int:
    def run_one(label, tree):
        r = subprocess.run([sys.executable, "-c", _RUN, label, tree, HERE,
                            out], cwd=tree, capture_output=True, text=True)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith(("LAYER ", "SUM ", "STEP "))]
        print("\n".join(lines) if lines else f"{label}: rc {r.returncode}",
              flush=True)
        if r.returncode:
            print(r.stderr[-3000:], flush=True)
        return r.returncode
    return bc.ab(parent, run_one)


# each copy must fail phase 2 or 2b
MUTANTS = {
    "K3 sums window rows in descending order": [
        (POOL_CU,
         "for (int i = 0; i < NI; ++i) {  // window rows in ascending order",
         "for (int i = NI - 1; i >= 0; --i) {")],
    "K1 compares with >=": [(POOL_CU, "if (v > best) {", "if (v >= best) {")],
    "K1's band halo one row short": [
        (POOL_CU, "ir1 = max(ir0, min(a.h, (oy0 + R - 1) * sh - a.ph + kh));",
         "ir1 = max(ir0, min(a.h, (oy0 + R - 1) * sh - a.ph + kh - 1));")],
    "K1's tile halo one column short": [
        (POOL_CU, "ic1 = max(ic0, min(a.w, (oc0 + Cn - 1) * sw - a.pw + kw));",
         "ic1 = max(ic0, min(a.w, (oc0 + Cn - 1) * sw - a.pw + kw - 1));")],
    "the misaligned head skipped": [
        (POOL_CU,
         "  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = "
         "src[i];\n  for (int v = threadIdx.x; v < body; v += blockDim.x)\n"
         "    bigdl::wg::cp16(",
         "  for (int v = threadIdx.x; v < body; v += blockDim.x)\n"
         "    bigdl::wg::cp16(")],
    "K1 reads a window wholly past the plane": [
        (POOL_CU, "const bool none = !kFixed && (y0 >= a.h || x0 >= a.w);",
         "const bool none = false;")],
}

_CHECK = """
import sys, torch, bench_common, chip_smoke as cs
bench_common.use_library(sys.argv[1])
dev = torch.device("cuda", 0)
failed = []
for fn in (cs.check_kernels, cs.check_backward_kernels):
    try:
        fn(dev)
    except SystemExit as e:
        failed.append(f"{fn.__name__}: {e}")
        break
print("CAUGHT " + failed[0] if failed else "PASSED", flush=True)
"""


def cmd_mutants() -> int:
    libs = bc.build_libraries(MUTANTS, os.path.join(HERE, "build",
                                                    "maxpool_mutants"),
                              [POOL_CU], extra=[LRN_CU])
    caught = True
    for name, lib in libs.items():
        r = subprocess.run([sys.executable, "-c", _CHECK, lib], cwd=HERE,
                           capture_output=True, text=True)
        said = [ln for ln in r.stdout.splitlines()
                if ln.startswith(("CAUGHT", "PASSED"))]
        print(f"mutant {name}: " + (said[-1][:400] if said else
                                    f"rc {r.returncode} {r.stderr[-600:]}"),
              flush=True)
        caught = caught and bool(said) and said[-1].startswith("CAUGHT")
    print("every mutant failed phase 2 or 2b" if caught else
          "A MUTANT PASSED PHASES 2 AND 2b", flush=True)
    return 0 if caught else 1


# ablate: a part of the kernels taken out (edits of max_pool.cu) or a
# setting of the plan changed (ops/pooling.py)
_NO_WINDOWS = [
    (POOL_CU, "for (int p = 0; p < kh; ++p) {",
     "for (int p = 0; p < kh * (a.planes < 0); ++p) {"),
    (POOL_CU,
     "for (int i = 0; i < NI; ++i) {  // window rows in ascending order",
     "for (int i = 0; i < NI * (a.planes < 0); ++i) {")]
_NO_COPIES = [(POOL_CU, "for (int v = threadIdx.x; v < body; v += "
               "blockDim.x)\n    bigdl::wg::cp16(",
               "for (int v = threadIdx.x; v < body * (n < 0); v += "
               "blockDim.x)\n    bigdl::wg::cp16(")]
_NO_STORES = [(POOL_CU, "for (int v = threadIdx.x; v < body; v += "
               "blockDim.x) d[v] = s[v];",
               "for (int v = threadIdx.x; v < body * (n < 0); v += "
               "blockDim.x) d[v] = s[v];")]
ABLATIONS = {
    "as is": ([], {}),
    "no window work": (_NO_WINDOWS, {}),
    "no input copies": (_NO_COPIES, {}),
    "no output stores": (_NO_STORES, {}),
    "copies alone (no windows, no stores)": (_NO_WINDOWS + _NO_STORES, {}),
    "2 blocks an SM": ([], {"POOL_BLOCKS_PER_SM": 2}),
    "32 blocks an SM": ([], {"POOL_BLOCKS_PER_SM": 32}),
    "budget 16 KB": ([], {"POOL_SMEM_BUDGET": 16 * 1024}),
    "budget 96 KB": ([], {"POOL_SMEM_BUDGET": 96 * 1024}),
}

_ABLATE = """
import json, sys, torch, chip_smoke as cs
from bench_common import use_library as use
from bigdl_tpu_torch.ops import pooling
libs, settings = json.loads(sys.argv[1]), json.loads(sys.argv[2])
plain = {k: getattr(pooling, k) for k in ("POOL_BLOCKS_PER_SM",
                                          "POOL_SMEM_BUDGET")}
dev = torch.device("cuda", 0)
for name in list(libs) + [list(libs)[0]]:
    use(libs[name])
    for key, v in plain.items():
        setattr(pooling, key, settings[name].get(key, v))
    pooling.pool_plan.cache_clear()
    row = {"name": name}
    for key, dtype, bwd in (("K1 bf16 with index", torch.bfloat16, False),
                            ("K1 f32", torch.float32, False),
                            ("K3 bf16", torch.bfloat16, True)):
        rows = cs.time_pool_layers(dev, dtype, bwd, plain=False,
                                   library=False)
        row[key] = {"device_ms": cs.pool_sums(rows)["device_ms"],
                    "per_layer": {r["layer"]: r["device_ms"] for r in rows}}
    print("ABLATE " + json.dumps(row), flush=True)
"""


def cmd_ablate(names) -> int:
    chosen = {n: ABLATIONS[n] for n in ["as is"] + [
        n for n in (names or ABLATIONS) if n != "as is"]}
    libs = bc.build_libraries({name: edits for name, (edits, _) in
                               chosen.items() if edits or name == "as is"},
                              os.path.join(HERE, "build", "maxpool_ablate"),
                              [POOL_CU])
    names = {name: libs.get(name, libs["as is"]) for name in chosen}
    r = subprocess.run([sys.executable, "-c", _ABLATE, json.dumps(names),
                        json.dumps({n: s for n, (_, s) in
                                    chosen.items()})],
                       cwd=HERE, capture_output=True, text=True)
    for ln in r.stdout.splitlines():
        if ln.startswith("ABLATE "):
            row = json.loads(ln[7:])
            print(f"{row['name']}: " + ", ".join(
                f"{k} {row[k]['device_ms']} ms" for k in row
                if k != "name") + " (device time, summed over the 13 "
                "pools); per layer " + json.dumps(
                    {k: row[k]["per_layer"] for k in row if k != "name"}),
                flush=True)
    if r.returncode:
        print(r.stderr[-3000:], flush=True)
    return r.returncode


def cmd_sass(parent) -> int:
    trees = [("this", HERE)] + ([("parent", parent)] if parent else [])
    for label, tree in trees:
        counts = bc.sass_counts(os.path.join(tree, POOL_CU),
                                os.path.join(HERE, "build", "maxpool_sass",
                                             label),
                                {"calls": " CALL", "mufu_rcp": "MUFU.RCP"})
        for name, c in sorted(counts.items()):
            print(f"SASS {label} | {name[:80]} | {c['instructions']} "
                  f"instructions | {c['calls']} calls | {c['mufu_rcp']} "
                  "MUFU.RCP", flush=True)
    return 0


def main(argv) -> int:
    if not bc.card_or_exit("bench_maxpool"):
        return 2
    out = os.path.join(HERE, "build", "bench_maxpool")
    if "--out" in argv[:-1]:
        i = argv.index("--out")
        out = os.path.abspath(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    cmd = argv[0] if argv else ""
    if cmd == "ab" and len(argv) == 2:
        return cmd_ab(os.path.abspath(argv[1]), out)
    if cmd == "mutants":
        return cmd_mutants()
    if cmd == "ablate":
        return cmd_ablate(argv[1:])
    if cmd == "sass" and len(argv) <= 2:
        return cmd_sass(os.path.abspath(argv[1]) if len(argv) == 2 else None)
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
