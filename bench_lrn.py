#!/usr/bin/env python3
"""The port's cross-map LRN kernels K2 and K4 on the card: a parent
checkout against this one, the mutation check of ``chip_smoke.py`` phases
2 and 2b, ablations of the kernels and of their plan, and the kernels'
instructions.

Run from the root of a checkout on a machine with one CUDA card:

    python3 bench_lrn.py ab <parent checkout> [--out <dir>]
    python3 bench_lrn.py mutants
    python3 bench_lrn.py ablate [<name> ...]
    python3 bench_lrn.py sass [<parent checkout>]

``ab`` runs the parent and this checkout in turns (parent, this, this,
parent), each in its own process with its own package and this
checkout's ``chip_smoke.time_lrn_layers``: K2 in bf16 with its scale (as
training calls it) and in f32 without (as serving does), and K4 in bf16,
at Inception-v1's two LRN layers at batch 32 by CUDA events (L2 flushed)
and torch.profiler device time, the library calls beside them
(``F.local_response_norm``, autograd's backward of it); then the bf16
Inception-v1 training step at batch 32 (median host time of the last 20
of 30 steps, and the profiler's device time a step) and the f32 serving
forward at bucket 32 (median time as a worker runs it, and its device
time).  The first run of each tree also writes y, scale and dx of both
layers from seeded inputs (under ``build/lrn_outputs``), and ``ab``
reports the largest |difference| between the trees' kernels.  Each run
writes its rows to ``<dir>/bench_lrn_<label>.json`` (``build/bench_lrn``
by default).  Make
the parent with ``git archive <commit> bigdl_tpu_torch chip_smoke.py |
tar -x -C build/parent`` (``build/`` is not committed).
``mutants`` builds edited copies of ``csrc/lrn.cu`` under
``build/lrn_mutants/`` (MUTANTS: a window sum one channel short at a chunk
boundary, the last pixel vector of a plane skipped, q's window taken
forwards, K4 centred one channel off, K4's halo above a chunk one channel
short, bf16 lanes swapped), each its own library beside ``max_pool.cu``,
and fails unless ``check_kernels`` (phase 2) or ``check_backward_kernels``
(phase 2b) fails on every one.
``ablate`` times K2 and K4 (device time, summed over the two layers) with
a part of the kernels taken out (edited copies of ``lrn.cu``, built in
parallel) or a setting of ``ops/lrn.py``'s plan changed (ABLATIONS, or
those named, beside the kernels as they are).
``sass`` compiles ``lrn.cu`` of this checkout (and of a parent) to a cubin
and counts, per kernel, its SASS instructions, its special-function
instructions (MUFU), the calls of the division's slow path, and its
16-byte and other global loads and stores.  The machinery of copies,
edits and A/B runs is ``bench_common.py``'s.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import bench_common as bc

HERE = bc.HERE
LRN_CU = "bigdl_tpu_torch/csrc/lrn.cu"
POOL_CU = "bigdl_tpu_torch/csrc/max_pool.cu"

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
label, out = sys.argv[1], sys.argv[4]
os.makedirs(out, exist_ok=True)
res = {"label": label, "card": cs.card_line(), "package": sys.argv[2],
       "kernels": {}}
from bigdl_tpu_torch.ops import cross_map_lrn, lrn_bwd
if label.endswith(" 1"):    # the outputs, from seeded inputs
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    outs = {}
    for name, shape, size, alpha, beta, k in cs.LRNS:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
            y, scale = cross_map_lrn(x, size, alpha, beta, k,
                                     return_scale=True)
            key = f"{name} {str(dtype)[6:]}"
            outs[key + " y"] = y.cpu()
            outs[key + " y (no scale)"] = cross_map_lrn(
                x, size, alpha, beta, k).cpu()
            outs[key + " scale"] = scale.cpu()
            outs[key + " dx"] = lrn_bwd(x, scale, dy, size, alpha,
                                        beta).cpu()
    keep = os.path.join(sys.argv[3], "build", "lrn_outputs")
    os.makedirs(keep, exist_ok=True)
    torch.save(outs, os.path.join(keep, label.split()[0] + ".pt"))
for key, dtype, bwd, with_scale in (
        ("K2 bf16 with scale", torch.bfloat16, False, True),
        ("K2 f32", torch.float32, False, False),
        ("K4 bf16", torch.bfloat16, True, False)):
    rows = cs.time_lrn_layers(dev, dtype, bwd, with_scale, plain=False)
    res["kernels"][key] = cs.pool_sums(rows)
    for r in rows:
        print(f"LAYER {label} | {key} | {r['layer']} | events "
              f"{r['ms']:.4f} | device {cs.fmt_ms(r['device_ms'])} | bound "
              f"{r['bound_ms']:.4f} | library events {r['library_ms']:.4f} "
              f"| library device {cs.fmt_ms(r['library_device_ms'])}",
              flush=True)
    t = res["kernels"][key]
    print(f"SUM {label} | {key} | events {t['ms']:.4f} | device "
          f"{cs.fmt_ms(t['device_ms'])} | bound {t['bound_ms']:.4f} | "
          f"library events {t['library_ms']:.4f} | library device "
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
with open(os.path.join(out, "bench_lrn_" + label.replace(" ", "_") +
                       ".json"), "w") as f:
    json.dump(res, f, indent=1)
"""


def output_deltas():
    """The largest |difference| between the parent's and this checkout's
    outputs, per output, from the files the first run of each wrote."""
    import torch
    keep = os.path.join(HERE, "build", "lrn_outputs")
    a = torch.load(os.path.join(keep, "parent.pt"))
    b = torch.load(os.path.join(keep, "change.pt"))
    return {key: (a[key].float() - b[key].float()).abs().max().item()
            for key in a}


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
    rc = bc.ab(parent, run_one)
    if rc == 0:
        for key, d in output_deltas().items():
            print(f"DELTA {key}: max |parent - change| {d}", flush=True)
    return rc


# each copy must fail phase 2 or 2b
MUTANTS = {
    "a window sum one channel short at a chunk boundary": [
        (LRN_CU, "below[i] = fetch<T, V>(x, base, c0 - lo + i, true, g, "
         "0.0f);",
         "below[i] = fetch<T, V>(x, base, c0 - lo + i, i > 0, g, 0.0f);")],
    "the last pixel vector of a plane skipped": [
        (LRN_CU, "if (t >= g.total) return false;",
         "if (t >= g.total || (t + 1) % g.vecs == 0) return false;")],
    "q's window taken forwards": [
        (LRN_CU, "const int j0 = max(0, ch - hi), j1 = min(g.c - 1, ch + lo);",
         "const int j0 = max(0, ch - lo), j1 = min(g.c - 1, ch + hi);")],
    "K4 centred one channel off": [
        (LRN_CU, "coef * xs[u + hi][p] * rsum;",
         "coef * xs[u + hi - 1][p] * rsum;")],
    "K4's halo above a chunk one channel short": [
        (LRN_CU, "o0 + kGroup + S - 1 + u, o0 + kGroup + u < nout);",
         "o0 + kGroup + S - 1 + u, o0 + kGroup + u + 1 < nout);")],
    "bf16 lanes swapped": [
        (LRN_CU, "p % 2 ? w[p / 2] & 0xffff0000u : w[p / 2] << 16",
         "p % 2 ? w[p / 2] << 16 : w[p / 2] & 0xffff0000u")],
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
                                                    "lrn_mutants"),
                              [LRN_CU], extra=[POOL_CU])
    caught = True
    runs = {name: subprocess.Popen([sys.executable, "-c", _CHECK, lib],
                                   cwd=HERE, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
            for name, lib in libs.items()}       # all at once, on one card
    for name, proc in runs.items():
        out, err = proc.communicate()
        said = [ln for ln in out.splitlines()
                if ln.startswith(("CAUGHT", "PASSED"))]
        print(f"mutant {name}: " + (said[-1][:400] if said else
                                    f"rc {proc.returncode} {err[-600:]}"),
              flush=True)
        caught = caught and bool(said) and said[-1].startswith("CAUGHT")
    print("every mutant failed phase 2 or 2b" if caught else
          "A MUTANT PASSED PHASES 2 AND 2b", flush=True)
    return 0 if caught else 1


# ablate: a part of the kernels taken out (edits of lrn.cu) or a setting
# of the plan changed (ops/lrn.py)
_NO_HALO = [(LRN_CU, "c0 - lo + i, true, g, 0.0f);",
             "c0 - lo + i, false, g, 0.0f);"),
            (LRN_CU, "c0 - hi + i, true, g, 0.0f);",
             "c0 - hi + i, false, g, 0.0f);", 2),
            (LRN_CU, "c0 - hi + i, true, g, 1.0f);",
             "c0 - hi + i, false, g, 1.0f);")]
ABLATIONS = {
    "as is": ([], {}),
    "group of 1": ([(LRN_CU, "constexpr int kGroup = 2;",
                     "constexpr int kGroup = 1;")], {}),
    "group of 4": ([(LRN_CU, "constexpr int kGroup = 2;",
                     "constexpr int kGroup = 4;")], {}),
    "no division": ([(LRN_CU, "q[i][p] = ds[i][p] * xs[i][p] * pb[i][p] / s;",
                      "q[i][p] = ds[i][p] * xs[i][p] * pb[i][p] * s;")], {}),
    "no rsqrt or sqrt": ([(LRN_CU, "    const float r = rsqrtf(s);\n"
                           "    return r * sqrtf(r);",
                           "    return s;")], {}),
    "no halo below a chunk": (_NO_HALO, {}),
    "one pixel a thread": ([], {"LRN_VECTOR_BYTES": {"fwd": 1, "bwd": 1}}),
    "4-byte vectors": ([], {"LRN_VECTOR_BYTES": {"fwd": 4, "bwd": 4}}),
    "8-byte vectors": ([], {"LRN_VECTOR_BYTES": {"fwd": 8, "bwd": 8}}),
    "16-byte vectors": ([], {"LRN_VECTOR_BYTES": {"fwd": 16, "bwd": 16}}),
    "fewer threads an SM": ([], {"LRN_THREADS_PER_SM": {"fwd": 1024,
                                                        "bwd": 256}}),
    "more threads an SM": ([], {"LRN_THREADS_PER_SM": {"fwd": 4096,
                                                       "bwd": 1024}}),
    "256 threads a block": ([], {"LRN_THREADS": 256}),
    "chunks of 8 or more": ([], {"LRN_MIN_CHUNK": 8}),
}

_ABLATE = """
import json, sys, torch, chip_smoke as cs
from bench_common import use_library as use
from bigdl_tpu_torch.ops import lrn
libs, settings = json.loads(sys.argv[1]), json.loads(sys.argv[2])
keys = ("LRN_VECTOR_BYTES", "LRN_THREADS_PER_SM", "LRN_THREADS",
        "LRN_MIN_CHUNK")
plain = {k: getattr(lrn, k) for k in keys}
dev = torch.device("cuda", 0)
for name in list(libs) + [list(libs)[0]]:
    use(libs[name])
    for key, v in plain.items():
        setattr(lrn, key, settings[name].get(key, v))
    lrn.lrn_plan.cache_clear()
    row = {"name": name}
    for key, dtype, bwd, with_scale in (
            ("K2 bf16 with scale", torch.bfloat16, False, True),
            ("K2 f32", torch.float32, False, False),
            ("K4 bf16", torch.bfloat16, True, False)):
        rows = cs.time_lrn_layers(dev, dtype, bwd, with_scale, plain=False,
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
                              os.path.join(HERE, "build", "lrn_ablate"),
                              [LRN_CU])
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
                if k != "name") + " (device time, summed over the 2 LRN "
                "layers); per layer " + json.dumps(
                    {k: row[k]["per_layer"] for k in row if k != "name"}),
                flush=True)
    if r.returncode:
        print(r.stderr[-3000:], flush=True)
    return r.returncode


SASS_PATTERNS = {"mufu": "MUFU.", "calls": " CALL", "ldg128": "LDG.E.128",
                 "ldg": "LDG.", "stg128": "STG.E.128", "stg": "STG."}


def cmd_sass(parent) -> int:
    trees = [("this", HERE)] + ([("parent", parent)] if parent else [])
    for label, tree in trees:
        counts = bc.sass_counts(os.path.join(tree, LRN_CU),
                                os.path.join(HERE, "build", "lrn_sass",
                                             label), SASS_PATTERNS)
        for name, c in sorted(counts.items()):
            print(f"SASS {label} | {name[:90]} | " + " | ".join(
                f"{v} {k}" for k, v in c.items()), flush=True)
    return 0


def main(argv) -> int:
    if not bc.card_or_exit("bench_lrn"):
        return 2
    out = os.path.join(HERE, "build", "bench_lrn")
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
