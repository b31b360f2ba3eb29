#!/usr/bin/env python3
"""The port's flash backward on the card: a parent checkout against this
one, the kernels' ptxas figures, and the mutation check of
``chip_smoke.py`` phase 2f.

Run from the root of a checkout on a machine with one CUDA card:

    python3 bench_flash_bwd.py ab <parent checkout>
    python3 bench_flash_bwd.py ptxas
    python3 bench_flash_bwd.py mutants

``ab`` runs each checkout's own ``chip_smoke.time_flash`` (K10, K11 and,
where the tree has it, the delta pass, beside SDPA's backward at
FLASH_PATH's shapes) and ``chip_smoke.long_context_training`` (phase 3h) in
the parent and in this checkout in turns (parent, this, this, parent), each
in its own process, and prints one ``RESULT {json}`` line a run.  Make the
parent with ``git archive <commit> bigdl_tpu_torch chip_smoke.py | tar -x -C
build/parent`` (``build/`` is not committed).  ``ptxas`` compiles
``flash_attention_bwd.cu`` with ``-Xptxas -v`` under ``build/ptxas/`` and
prints each kernel's registers, spills and whether ptxas serialized its
wgmma (info C7515).  ``mutants`` copies the port and ``chip_smoke.py`` under
``build/mutant_<name>/``, breaks one product of K11 in each copy, and fails
unless ``check_flash_kernels`` fails in every copy.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

CU = "bigdl_tpu_torch/csrc/flash_attention_bwd.cu"
WGMMA = "bigdl_tpu_torch/csrc/wgmma.cuh"

# one run of ``ab``, in the checkout it is started in
_AB_RUN = """
import json, sys, torch
import chip_smoke as cs
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
res = {"label": sys.argv[1], "card": cs.card_line()}
for name, r in cs.time_flash(dev).items():
    ms = {k: r[k]["ms"] for k in ("flash_bwd_delta",
                                  "attention_stream_bwd_dq",
                                  "attention_stream_bwd_dkv") if k in r}
    res[name] = dict(ms, sum_ms=sum(ms.values()),
                     sdpa_bwd_ms=r["attention_stream_bwd_dq"]["library_ms"])
long, _ = cs.long_context_training(dev)
for key in ("remat", "no_remat"):
    res[key] = {k: long[key][k] for k in ("ms_per_step", "tokens_per_s",
                                          "launches_per_step")}
res["busy_share"] = long["profile"]["busy_share"]
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


def ptxas_lines(log: str):
    """One line a kernel from ``nvcc -Xptxas -v``'s log: its name and
    template arguments, registers and spills."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            m2 = re.search(r"((?:dq|dkv)_(?:bf16|f32))ILi(\d+)ELb([01])E",
                           m.group(1))
            name = (f"{m2.group(1)} D {m2.group(2)} bias {m2.group(3)}"
                    if m2 else "delta_kernel " +
                    ("bf16" if "bfloat16" in m.group(1) else "f32"))
        elif name and "spill" in ln:
            spills = ln.strip()
        elif name and "Used" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spills}")
    return out


def cmd_ptxas() -> int:
    sys.path.insert(0, os.getcwd())
    from bigdl_tpu_torch.ops import _build
    os.makedirs("build/ptxas", exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.ARCH, *_build.FLAGS,
                        "-Xptxas", "-v", "-c", CU, "-o",
                        "build/ptxas/flash_attention_bwd.o"],
                       capture_output=True, text=True)
    print(f"nvcc -Xptxas -v {CU}: rc {r.returncode}")
    print("\n".join(ptxas_lines(r.stderr)))
    if r.returncode:
        print(r.stderr[-3000:])
    print("C7515 (wgmma serialized): " +
          ("REPORTED" if "C7515" in r.stderr else "not reported"))
    return r.returncode


# K11 broken two ways: each copy must fail phase 2f.  The dv product
# pᵀ·dO reads dO MN-major (transpose bit 1); the second mutant reads it
# through a K-major descriptor with the bit 0, i.e. dO transposed inside
# its tile
_DV = "      wg::mma_rs(dva, pa[c], T::template mnmajor<kTile>(ds, c));"
_DV_T0 = ("      if constexpr (D == 64)\n        wg::mma_rs_t0(dva, pa[c], "
          "T::template kmajor<kTile>(ds, c));\n      else\n  " + _DV)


def _with_t0(wgmma: str) -> str:
    """wgmma.cuh with a copy of the N 64 ``mma_rs``, ``mma_rs_t0``, whose
    B operand's transpose bit is 0."""
    start = wgmma.index("__device__ __forceinline__ void mma_rs(float "
                        "(&d)[32],")
    end = wgmma.index("\n}\n", start) + 3
    fn = wgmma[start:end].replace("mma_rs(", "mma_rs_t0(").replace(
        "p, 1, 1, 1;", "p, 1, 1, 0;")
    return wgmma[:end] + "\n" + fn + wgmma[end:]


MUTANTS = {
    # the diagonal tile takes the unmasked path: no causal mask
    "k11_no_diagonal_mask": [(CU, lambda s: s.replace(
        "    if ((p.causal && q0 < k0 + kTile - 1) || q0 + kTile > p.tq ||",
        "    if (q0 + kTile > p.tq ||"))],
    "k11_dv_transpose_bit": [(WGMMA, _with_t0),
                             (CU, lambda s: s.replace(_DV, _DV_T0))],
}


def cmd_mutants() -> int:
    caught = True
    for name, edits in MUTANTS.items():
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
             "cs.check_flash_kernels(torch.device('cuda'))"],
            cwd=root, capture_output=True, text=True)
        why = [ln for ln in r.stderr.splitlines()
               if "FAILED" in ln or "Error" in ln]
        print(f"mutant {name}: rc {r.returncode}; "
              f"{why[-1] if why else r.stderr[-300:]}", flush=True)
        caught = caught and r.returncode != 0
        shutil.rmtree(root, ignore_errors=True)
    print("every mutant failed phase 2f" if caught else
          "A MUTANT PASSED PHASE 2f")
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
