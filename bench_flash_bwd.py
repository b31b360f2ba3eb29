#!/usr/bin/env python3
"""The port's attention kernels on the card (the forward K8/K9 and the
flash backward K10/K11): a parent checkout against this one, the kernels'
ptxas figures, and the mutation checks of ``chip_smoke.py`` phases 2d and
2f.

Run from the root of a checkout on a machine with one CUDA card:

    python3 bench_flash_bwd.py ab <parent checkout>
    python3 bench_flash_bwd.py ptxas
    python3 bench_flash_bwd.py mutants

``ab`` runs each checkout's own ``chip_smoke.long_context_training``
(phase 3h), ``chip_smoke.time_attention`` (K8 and K9 per call beside
SDPA), the bf16 LM scoring forwards (8 x 2048 and 1 x 8192, with their
device time by torch.profiler) and ``chip_smoke.time_flash`` (K10, K11
and, where the tree has it, the delta pass, beside SDPA's backward at
FLASH_PATH's shapes) in the parent and in this
checkout in turns (parent, this, this, parent), each in its own process,
and prints one ``RESULT {json}`` line a run.  Make the parent with ``git
archive <commit> bigdl_tpu_torch chip_smoke.py | tar -x -C build/parent``
(``build/`` is not committed).  ``ptxas`` compiles ``attention.cu`` and
``flash_attention_bwd.cu`` with ``-Xptxas -v`` under ``build/ptxas/`` and
prints each kernel's registers, spills and whether ptxas serialized its
wgmma (info C7515).  ``mutants`` copies the port and ``chip_smoke.py`` under
``build/mutant_<name>/``, breaks one step of K8/K9 or one product of K11 in
each copy, and fails unless phase 2d (``check_attention_kernels``) or 2f
(``check_flash_kernels``) fails in every copy.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

CU = "bigdl_tpu_torch/csrc/flash_attention_bwd.cu"
FWD_CU = "bigdl_tpu_torch/csrc/attention.cu"
WGMMA = "bigdl_tpu_torch/csrc/wgmma.cuh"

# one run of ``ab``, in the checkout it is started in
_AB_RUN = """
import json, sys, torch
import chip_smoke as cs
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
res = {"label": sys.argv[1], "card": cs.card_line()}
# the training step first, as chip_smoke.py runs it: before the timings'
# large plain operands have filled the allocator's cache
long, _ = cs.long_context_training(dev)
for key in ("remat", "no_remat"):
    res[key] = {k: long[key][k] for k in ("ms_per_step", "tokens_per_s",
                                          "launches_per_step")}
res["busy_share"] = long["profile"]["busy_share"]
res["device_ms_per_step"] = long["profile"]["device_ms"]
attn, sweep = cs.time_attention(dev)
res["attention"] = {name: {k: r.get(k) for k in (
    "kernel", "dtype", "ms", "device_ms", "library_ms", "bound_ms")}
    for name, r in attn.items()}
res["k8_vs_k9"] = [[r["T"], r["k8_ms"], r["k9_ms"]] for r in sweep]
with torch.inference_mode():
    for key, model, ids in (
            ("lm_scoring_forward", cs.lm_model(), (cs.LM_BATCH, cs.LM_T)),
            ("long_context_forward", cs.lm_model(cs.LONG_VOCAB, cs.LONG_T),
             (1, cs.LONG_T))):
        model = model.to(dev, torch.bfloat16)
        x = torch.from_numpy(cs.lm_ids(ids, cs.SEED + 52,
                                       model.vocab_size)).to(dev)
        ms = cs.median_ms(lambda: model(x), dev, reps=5)
        prof = cs.device_profile(lambda: model(x), 1)
        res[key] = {"ms": ms, "device_ms": prof["device_ms"],
                    "busy_share": prof["device_ms"] / ms}
        del model, x
for name, r in cs.time_flash(dev).items():
    ms = {k: r[k]["ms"] for k in ("flash_bwd_delta",
                                  "attention_stream_bwd_dq",
                                  "attention_stream_bwd_dkv") if k in r}
    res[name] = dict(ms, sum_ms=sum(ms.values()),
                     sdpa_bwd_ms=r["attention_stream_bwd_dq"]["library_ms"])
print("RESULT " + json.dumps(res), flush=True)
"""


def cmd_ab(parent: str) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    rc = 0
    for label, cwd in (("parent 1", parent), ("change 1", here),
                       ("change 2", here), ("parent 2", parent)):
        r = subprocess.run([sys.executable, "-c", _AB_RUN, label], cwd=cwd,
                           capture_output=True, text=True)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        print(lines[-1] if lines else f"{label}: rc {r.returncode}\n"
              f"{r.stderr[-3000:]}", flush=True)
        rc = rc or r.returncode
    return rc


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name."""
    m = re.search(r"(attn_(?:bf16|f32))ILi(\d+)ELb([01])ELb([01])ELb([01])E",
                  mangled)
    if m:
        return (f"{'K9' if m.group(3) == '1' else 'K8'} {m.group(1)} D "
                f"{m.group(2)} bias {m.group(4)} lse {m.group(5)}")
    m = re.search(r"((?:dq|dkv)_(?:bf16|f32))ILi(\d+)ELb([01])E", mangled)
    if m:
        return f"{m.group(1)} D {m.group(2)} bias {m.group(3)}"
    return "delta_kernel " + ("bf16" if "bfloat16" in mangled else "f32")


def ptxas_lines(log: str):
    """One line a kernel from ``nvcc -Xptxas -v``'s log: its name and
    template arguments, registers and spills."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
        elif name and "spill" in ln:
            spills = ln.strip()
        elif name and "Used" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spills}")
    return out


def cmd_ptxas() -> int:
    sys.path.insert(0, os.getcwd())
    from bigdl_tpu_torch.ops import _build
    os.makedirs("build/ptxas", exist_ok=True)
    runs = {cu: subprocess.Popen(
        [_build._nvcc(), *_build.ARCH, *_build.FLAGS, "-Xptxas", "-v", "-c",
         cu, "-o", f"build/ptxas/{os.path.basename(cu)}.o"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cu in (FWD_CU, CU)}   # both at once
    rc = 0
    for cu, proc in runs.items():
        err = proc.communicate()[1]
        print(f"nvcc -Xptxas -v {cu}: rc {proc.returncode}")
        print("\n".join(ptxas_lines(err)))
        if proc.returncode:
            print(err[-3000:])
        print("C7515 (wgmma serialized): " +
              ("REPORTED" if "C7515" in err else "not reported"))
        rc = rc or proc.returncode
    return rc


# K8/K9 broken three ways, each copy must fail phase 2d; K11 two ways,
# each must fail phase 2f.  The products p·V (K8/K9) and pᵀ·dO (K11's dv)
# read their B operand MN-major (transpose bit 1); those mutants read it
# through a K-major descriptor with the bit 0, i.e. transposed inside its
# tile
_PV = "    wg::mma_rs(acc, a[c], wg::Tile<D>::template mnmajor<kBK>(vs, c));"
_PV_T0 = ("    if constexpr (D == 64)\n      wg::mma_rs_t0(acc, a[c], "
          "wg::Tile<D>::template kmajor<kBK>(vs, c));\n    else\n  " + _PV)
_DV = ("      wg::mma_rs(dva, pa[c], T::template mnmajor<kTile>(ds + cols, "
       "c));")
_DV_T0 = ("      if constexpr (D == 64)\n        wg::mma_rs_t0(dva, pa[c], "
          "T::template kmajor<kTile>(ds, c));\n      else\n  " + _DV)
# K8's second pass with each tile's own row max in place of the max over
# every key
_K8_P2 = ("      }} else if (raw) {{  // K8 pass 2\n"
          "        {0}probs<true, false>(sc, l, {1}, p.scale);\n"
          "      }} else {{\n"
          "        {2}probs<false, false>(sc, l, {1}, p.scale);\n")
_K8_TILE_MAX = _K8_P2.format(
    "float mt[2];\n        row_max<true>(sc, mt, p.scale);\n        ", "mt",
    "float mt[2];\n        row_max<false>(sc, mt, p.scale);\n        ")


def _with_t0(wgmma: str) -> str:
    """wgmma.cuh with a copy of the N 64 ``mma_rs``, ``mma_rs_t0``, whose
    B operand's transpose bit is 0."""
    start = wgmma.index("__device__ __forceinline__ void mma_rs(float "
                        "(&d)[32],")
    end = wgmma.index("\n}\n", start) + 3
    fn = wgmma[start:end].replace("mma_rs(", "mma_rs_t0(").replace(
        "p, 1, 1, 1;", "p, 1, 1, 0;")
    return wgmma[:end] + "\n" + fn + wgmma[end:]


# name: (the edits, the phase's check that must fail)
MUTANTS = {
    # K9's online softmax without its rescale of l and acc (alpha = 1)
    "k9_no_alpha_rescale": ([(FWD_CU, lambda s: s.replace(
        "const float alpha = ex2((m[ri] - m_new) * kLog2e);",
        "const float alpha = 1.0f;"))], "check_attention_kernels"),
    "k8_k9_v_kmajor": ([(WGMMA, _with_t0),
                        (FWD_CU, lambda s: s.replace(_PV, _PV_T0))],
                       "check_attention_kernels"),
    "k8_per_tile_max": ([(FWD_CU, lambda s: s.replace(
        _K8_P2.format("", "m", ""), _K8_TILE_MAX))],
        "check_attention_kernels"),
    # the diagonal tile takes the unmasked path: no causal mask
    "k11_no_diagonal_mask": ([(CU, lambda s: s.replace(
        "    if ((p.causal && q0 < k0 + kTile - 1) || q0 + kTile > p.tq ||",
        "    if (q0 + kTile > p.tq ||"))], "check_flash_kernels"),
    "k11_dv_transpose_bit": ([(WGMMA, _with_t0),
                              (CU, lambda s: s.replace(_DV, _DV_T0))],
                             "check_flash_kernels"),
}


def cmd_mutants() -> int:
    caught = True
    for name, (edits, check) in MUTANTS.items():
        root = os.path.join("build", f"mutant_{name}")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        shutil.copytree("bigdl_tpu_torch", f"{root}/bigdl_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy("chip_smoke.py", root)
        for path, edit in edits:
            text = open(f"{root}/{path}").read()
            if edit(text) == text:
                raise SystemExit(f"mutant {name}: {path} no longer holds "
                                 "the text to break")
            open(f"{root}/{path}", "w").write(edit(text))
        r = subprocess.run(
            [sys.executable, "-c", "import torch, chip_smoke as cs; "
             f"cs.{check}(torch.device('cuda'))"],
            cwd=root, capture_output=True, text=True)
        why = [ln for ln in r.stderr.splitlines()
               if "FAILED" in ln or "Error" in ln]
        print(f"mutant {name} ({check}): rc {r.returncode}; "
              f"{why[-1] if why else r.stderr[-300:]}", flush=True)
        caught = caught and r.returncode != 0
        shutil.rmtree(root, ignore_errors=True)
    print("every mutant failed its phase" if caught else
          "A MUTANT PASSED ITS PHASE")
    return 0 if caught else 1


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_flash_bwd: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    cmd = argv[0] if argv else ""
    if cmd == "ab" and len(argv) == 2:
        return cmd_ab(os.path.abspath(argv[1]))
    if cmd == "ptxas":
        return cmd_ptxas()
    if cmd == "mutants":
        return cmd_mutants()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
