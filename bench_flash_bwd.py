#!/usr/bin/env python3
"""The port's attention kernels on the card (the forward K8/K9 and the
flash backward K10/K11): a parent checkout against this one, the kernels'
ptxas figures, and the mutation checks of ``chip_smoke.py`` phases 2d and
2f.

Run from the root of a checkout on a machine with one CUDA card:

    python3 bench_flash_bwd.py ab <parent checkout>
    python3 bench_flash_bwd.py ptxas
    python3 bench_flash_bwd.py mutants [name ...]
    python3 bench_flash_bwd.py ablate [fwd|bwd]

``ab`` runs each checkout's own ``chip_smoke.long_context_training``
(phase 3h), ``chip_smoke.train_main_long`` (phase 3i, f32 ``train_main``
at 8 x 4096, then 3j's resume), ``chip_smoke.time_attention`` (K8 and K9
per call beside SDPA, the f32 ones at ``train_main``'s shape and at the
f32 LM scoring shape), the LM scoring forwards (bf16 8 x 2048 and 1 x
8192, f32 8 x 2048, with their device time by torch.profiler) and
``chip_smoke.time_flash`` (K10, K11 and, where the tree has it, the delta
pass, beside SDPA's backward at FLASH_PATH's shapes) in the parent and in
this checkout in turns (parent, this, this, parent), each in its own
process, and prints one ``RESULT {json}`` line a run.  Make the parent
with ``git archive <commit> bigdl_tpu_torch chip_smoke.py | tar -x -C
build/parent`` (``build/`` is not committed).  ``ptxas`` compiles
``attention.cu`` and ``flash_attention_bwd.cu`` with ``-Xptxas -v`` under
``build/ptxas/`` and prints each kernel's registers, spills and whether
ptxas serialized its wgmma (info C7515).  ``mutants`` copies the port and
``chip_smoke.py`` under ``build/mutant_<name>/``, breaks one step of K8/K9
(bf16 or f32), of the bf16 K11 or of the f32 K10 or K11 in each copy, and
fails unless phase 2d (``check_attention_kernels``) or 2f
(``check_flash_kernels``) fails in every copy (only the named mutants
where names are given).  ``ablate`` builds edited
copies of the sources under ``build/ablate/<n>/``, each into a library of
its own (all ``nvcc`` runs started together), and times them in turns, the
unedited copy first and last: ``fwd`` copies of ``attention.cu`` (and
``ffma.cuh``) timing the f32 K9 with its LSE and K8 at ``train_main``'s
shape and K8 at the f32 LM scoring shape, ``bwd`` copies of
``flash_attention_bwd.cu`` (and ``ffma.cuh``) timing the f32 K10 and K11 at
``train_main``'s shape (FLASH_PATH's f32 case); CUDA events, the L2
flushed.  The edits switch parts of the kernels off, to see where their
time goes, or try other tile shapes; without an argument both run.  The
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

CU = "bigdl_tpu_torch/csrc/flash_attention_bwd.cu"
FWD_CU = "bigdl_tpu_torch/csrc/attention.cu"
WGMMA = "bigdl_tpu_torch/csrc/wgmma.cuh"
FFMA = "bigdl_tpu_torch/csrc/ffma.cuh"

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
tm, _, _ = cs.train_main_long(dev)   # f32, 8 x 4096: 8 K10 + 8 K11 a step
res["train_main"] = {k: tm[k] for k in ("step_ms_median_after_first",
                                        "step_ms", "losses")}
attn, sweep = cs.time_attention(dev)
res["attention"] = {name: {k: r.get(k) for k in (
    "kernel", "dtype", "ms", "device_ms", "library_ms", "bound_ms")}
    for name, r in attn.items()}
res["k8_vs_k9"] = [[r["T"], r["k8_ms"], r["k9_ms"]] for r in sweep]
# the f32 K8 and K9 (with and without the LSE) and SDPA at the f32 LM
# scoring shape and at train_main's, by both clocks, the same in each tree
from bigdl_tpu_torch.ops import attention as A
gen = torch.Generator(device=dev).manual_seed(cs.SEED + 9)
flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
res["f32_attention"] = {}
for b, t in ((cs.LM_BATCH, cs.LM_T), (8, 4096)):
    q, k, v, _ = cs.attention_operands(("f32", b, 8, 8, t, t, 64, True, None),
                                       torch.float32, dev, gen)
    runs = {"k8": lambda: A.attention_fwd(q, k, v, True),
            "k9": lambda: A.attention_stream_fwd(q, k, v, True),
            "k9_lse": lambda: A._launch(
                A.attention_stream_fwd, "bigdl_attention_stream_fwd", q, k,
                v, None, True, 0.125, with_lse=True),
            "sdpa": cs.sdpa_call(q, k, v, True, None)}
    res["f32_attention"][f"({b}, 8, {t}, 64)"] = {
        n: {"ms": cs.median_ms(fn, dev, flush=flush),
            "device_ms": cs.device_ms(fn, flush)} for n, fn in runs.items()}
    del q, k, v
with torch.inference_mode():
    for key, model, ids, dt in (
            ("lm_scoring_forward", cs.lm_model(), (cs.LM_BATCH, cs.LM_T),
             torch.bfloat16),
            ("long_context_forward", cs.lm_model(cs.LONG_VOCAB, cs.LONG_T),
             (1, cs.LONG_T), torch.bfloat16),
            ("lm_scoring_forward_f32", cs.lm_model(), (cs.LM_BATCH, cs.LM_T),
             torch.float32)):
        model = model.to(dev, dt)
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
    def run_one(label, cwd):
        r = subprocess.run([sys.executable, "-c", _AB_RUN, label], cwd=cwd,
                           capture_output=True, text=True)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        print(lines[-1] if lines else f"{label}: rc {r.returncode}\n"
              f"{r.stderr[-3000:]}", flush=True)
        return r.returncode
    return bc.ab(parent, run_one)


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name."""
    m = re.search(r"(attn_(?:bf16|f32_ring))ILi(\d+)ELb([01])ELb([01])"
                  r"ELb([01])E", mangled)
    if m:
        return (f"{'K9' if m.group(3) == '1' else 'K8'} {m.group(1)} D "
                f"{m.group(2)} bias {m.group(4)} lse {m.group(5)}")
    m = re.search(r"((?:dq|dkv)_(?:bf16|f32_ring))ILi(\d+)ELb([01])E",
                  mangled)
    if m:
        return f"{m.group(1)} D {m.group(2)} bias {m.group(3)}"
    m = re.search(r"((?:attn|dq|dkv)_wide)I(f|13__nv_bfloat16)((?:Lb[01]E?)+)",
                  mangled)
    if m:
        flags = " ".join(re.findall(r"Lb([01])", m.group(3)))
        return (f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'bf16'} "
                f"flags {flags}")
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


# The bf16 K8/K9 broken three ways and the f32 K8/K9 three ways, each copy
# must fail phase 2d; the bf16 K11 two ways and the f32 K10 and K11 one way
# each, each must fail phase 2f.  The products p·V (the bf16 K8/K9) and
# pᵀ·dO (K11's dv) read their B operand MN-major (transpose bit 1); those
# mutants read it through a K-major descriptor with the bit 0, i.e.
# transposed inside its tile
_PV = "    mma_rs(acc, a[c], Tile<D>::template mnmajor<64>(vs, c));"
_PV_T0 = ("    if constexpr (D == 64)\n      mma_rs_t0(acc, a[c], "
          "Tile<D>::template kmajor<64>(vs, c));\n    else\n  " + _PV)
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
    "k9_no_alpha_rescale": ([(FWD_CU,
        "const float alpha = ex2((m[ri] - m_new) * kLog2e);",
        "const float alpha = 1.0f;")], "check_attention_kernels"),
    # (the p·V product of K8/K9 is wgmma.cuh's `accumulate`)
    "k8_k9_v_kmajor": ([(WGMMA, _with_t0),
                        (WGMMA, _PV, _PV_T0)],
                       "check_attention_kernels"),
    "k8_per_tile_max": ([(FWD_CU,
        _K8_P2.format("", "m", ""), _K8_TILE_MAX)],
        "check_attention_kernels"),
    # the diagonal tile takes the unmasked path: no causal mask
    "k11_no_diagonal_mask": ([(CU,
        "    if ((p.causal && q0 < k0 + kTile - 1) || q0 + kTile > p.tq ||",
        "    if (q0 + kTile > p.tq ||")], "check_flash_kernels"),
    "k11_dv_transpose_bit": ([(WGMMA, _with_t0),
                              (CU, _DV, _DV_T0)],
                             "check_flash_kernels"),
    # the f32 K11 sums dv from ds in place of p
    "k11_f32_dv_from_ds": ([(CU,
        "outer<C, kInner>(acc, ps + ln.co, dot + ln.cc * C::kVec);",
        "outer<C, kInner>(acc, dss + ln.co, dot + ln.cc * C::kVec);")],
        "check_flash_kernels"),
    # the f32 K10 reads K and V from the ring stage one tile late (the
    # stage of tile it - 1, which the copies of tile it + 1 are filling)
    "k10_f32_stage_late": ([(CU,
        "    const float* kt = ks + s * C::kTileF;\n"
        "    const float* vt = vs + s * C::kTileF;",
        "    const float* kt = ks + (s ^ 1) * C::kTileF;\n"
        "    const float* vt = vs + (s ^ 1) * C::kTileF;")],
        "check_flash_kernels"),
    # the f32 K8/K9 read K and V from the ring a stage late (the stage the
    # copies of the next slot are filling)
    "k8_k9_f32_stage_late": ([(FWD_CU,
        "    const float* kt = ks + st * C::kTileF;\n"
        "    const float* vt = vs + st * C::kTileF;",
        "    const float* kt = ks + (st + 1) % S * C::kTileF;\n"
        "    const float* vt = vs + (st + 1) % S * C::kTileF;")],
        "check_attention_kernels"),
    # the f32 K8's first pass leaves the last tile out of the row max
    "k8_f32_pass1_skips_last_tile": ([(FWD_CU,
        "    if (!kStream && !second) {  // K8 pass 1: the row max over every "
        "key\n",
        "    if (!kStream && !second) {  // K8 pass 1: the row max over every "
        "key\n      if (it == n_tiles - 1) continue;\n")],
        "check_attention_kernels"),
    # the f32 K9's online softmax rescales l but not acc
    "k9_f32_no_acc_rescale": ([(FWD_CU,
        "for (int c = 0; c < C::kCc; ++c) acc[i][c] *= alpha;",
        "for (int c = 0; c < C::kCc; ++c) acc[i][c] *= 1.0f;")],
        "check_attention_kernels"),
}


def cmd_mutants(names) -> int:
    unknown = set(names) - set(MUTANTS)
    if unknown:
        raise SystemExit(f"no mutant named {sorted(unknown)}")
    caught = True
    for name, (edits, check) in MUTANTS.items():
        if names and name not in names:
            continue
        root = bc.copy_port(os.path.join(bc.HERE, "build",
                                         f"mutant_{name}"))
        bc.apply_edits(root, edits, f"mutant {name}")
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


# name: (path, old, new) edits of the sources (the first is the unedited
# copy).  Switched-off parts keep their code (a condition the kernel cannot
# know to be false), so the rest compiles as before; their outputs are
# wrong.
_NEVER = "if (p.tq < 0) "
ABLATIONS = {
    "as committed": [],
    # no second products: dq = ds k, and dv = p^T dO, dk = ds^T q
    "no second products": [
        (CU, "    outer<C, kHalf>(acc,",
         "    " + _NEVER + "outer<C, kHalf>(acc,"),
        (CU, "    outer<C, kInner>(acc,",
         "    " + _NEVER + "outer<C, kInner>(acc,", 2)],
    # s and dp over the first 2 of D's columns only
    "scores over 2 columns": [
        (FFMA, "  for (int d = 0; d < C::kD; d += 2) {",
         "  for (int d = 0; d < 2; d += 2) {")],
    "scores unrolled 1": [
        (FFMA, "#pragma unroll 2\n  for (int d = 0; d < C::kD; d += 2) {",
         "#pragma unroll 1\n  for (int d = 0; d < C::kD; d += 2) {")],
    "scores unrolled 4": [
        (FFMA, "#pragma unroll 2\n  for (int d = 0; d < C::kD; d += 2) {",
         "#pragma unroll 4\n  for (int d = 0; d < C::kD; d += 2) {")],
    "second products unrolled 2": [
        (FFMA, "#pragma unroll 4\n  for (int r = 0; r < N; ++r) {",
         "#pragma unroll 2\n  for (int r = 0; r < N; ++r) {")],
}
# the same for the f32 K8/K9 (attention.cu)
FWD_ABLATIONS = {
    "as committed": [],
    # neither s = q k^T nor acc += p v (s stays zero)
    "no products": [
        (FWD_CU, "    float s[C::kR][C::kAi];\n    dots<C>(",
         "    float s[C::kR][C::kAi] = {};\n    " + _NEVER + "dots<C>("),
        (FWD_CU, "      outer<C, 8>(acc,",
         "      " + _NEVER + "outer<C, 8>(acc,")],
    # s, the softmax and p's chunks, but no acc += p v
    "no p v": [
        (FWD_CU, "      outer<C, 8>(acc,",
         "      " + _NEVER + "outer<C, 8>(acc,")],
    # the ring's first stages only: every later tile reads stale stages
    "no copies after the first stages": [
        (FWD_CU, "    if (it + S - 1 < n_it) load(it + S - 1);",
         "    if (p.tq < 0 && it + S - 1 < n_it) load(it + S - 1);")],
    # three ring stages (one block an SM at D 64)
    "3 stages": [
        (FWD_CU, "  static constexpr int kStages = 2;",
         "  static constexpr int kStages = 3;")],
    # 8 warps, 256 query rows a block at D 64 (one block an SM)
    "8 warps a block at D 64": [
        (FWD_CU, "  static constexpr int kWarps = D <= 64 ? 4 : 8;",
         "  static constexpr int kWarps = D <= 32 ? 4 : 8;")],
}


def _build_copies(src: str, ablations, tag: str):
    """Each ablation's edited copy of the sources, ``src`` compiled into a
    library of its own under ``build/ablate/<tag>/`` (bench_common
    build_libraries); {name: loaded library}."""
    libs = bc.build_libraries(ablations, os.path.join(
        bc.HERE, "build", "ablate", tag), [src])
    return {name: bc.load_library(lib) for name, lib in libs.items()}


def _in_turns(libs, timed) -> None:
    """Each library's times, the unedited copy again at the end."""
    for name in list(libs) + [next(iter(libs))]:
        print("RESULT " + json.dumps(dict(timed(libs[name]), name=name)),
              flush=True)


def ablate_bwd(dev) -> None:
    import torch
    import chip_smoke as cs
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import attention as attn
    libs = _build_copies(CU, ABLATIONS, "bwd")
    case = cs.FLASH_PATH[1]
    b, h, hk, t, tk, d = case[1:7]
    q, k, v, bias, o, lse, do = cs.flash_grads(case, torch.float32, dev,
                                               cs.SEED + 500)
    delta = attn.flash_bwd_delta(o, do)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), delta.data_ptr(),
              lse.data_ptr(), do.data_ptr(), None)

    def timed(lib):
        ms = {}
        for key, entry, outs in (("k10_ms", "bigdl_flash_bwd_dq", (dq,)),
                                 ("k11_ms", "bigdl_flash_bwd_dkv", (dk, dv))):
            fn = getattr(lib, entry)
            args = common + tuple(x.data_ptr() for x in outs) + (
                0, b, h, hk, t, tk, d, d ** -0.5, 1,
                _build.stream_ptr(q))
            ms[key] = cs.median_ms(lambda: _build.check(fn(*args), entry),
                                   dev, flush=flush)
        return ms
    _in_turns(libs, timed)


def ablate_fwd(dev) -> None:
    import torch
    import chip_smoke as cs
    from bigdl_tpu_torch.ops import _build
    libs = _build_copies(FWD_CU, FWD_ABLATIONS, "fwd")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 501)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    shapes = {"train_main": cs.ATTN_TIMED[0][:9],
              "lm_scoring": cs.ATTN_TIMED[1][:9]}
    ops = {}
    for key, case in shapes.items():
        _, b, h, hk, t, tk, d, causal, _ = case
        q, k, v, _ = cs.attention_operands(case, torch.float32, dev, gen)
        o, lse = torch.empty_like(q), q.new_empty((b, h, t))
        ops[key] = (q, k, v, o, lse, (0, b * h, h, hk, t, tk, d, d ** -0.5,
                                      int(causal), _build.stream_ptr(q)))

    def timed(lib):
        ms = {}
        for key, (q, k, v, o, lse, rest) in ops.items():
            qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr())
            runs = [("k8", "bigdl_attention_fwd", qkv + (o.data_ptr(),))]
            if key == "train_main":
                runs.append(("k9_lse", "bigdl_attention_stream_fwd",
                             qkv + (None, o.data_ptr(), lse.data_ptr())))
            for what, entry, ptrs in runs:
                fn = getattr(lib, entry)
                args = ptrs + rest
                ms[f"{what}_{key}_ms"] = cs.median_ms(
                    lambda: _build.check(fn(*args), entry), dev, flush=flush)
        return ms
    _in_turns(libs, timed)


def cmd_ablate(which: str) -> int:
    import torch
    sys.path.insert(0, os.getcwd())
    dev = torch.device("cuda", 0)
    if which in ("", "fwd"):
        ablate_fwd(dev)
    if which in ("", "bwd"):
        ablate_bwd(dev)
    return 0


def main(argv) -> int:
    if not bc.card_or_exit("bench_flash_bwd"):
        return 2
    cmd = argv[0] if argv else ""
    if cmd == "ab" and len(argv) == 2:
        return cmd_ab(os.path.abspath(argv[1]))
    if cmd == "ptxas":
        return cmd_ptxas()
    if cmd == "mutants":
        return cmd_mutants(argv[1:])
    if cmd == "ablate" and len(argv) <= 2 and argv[1:] in ([], ["fwd"],
                                                           ["bwd"]):
        return cmd_ablate(argv[1] if len(argv) == 2 else "")
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
