"""What the port's per-kernel bench scripts share (``bench_maxpool.py``,
``bench_lrn.py``, ``bench_quant.py``, ``bench_flash_bwd.py``): the card
check and its line, the parent/change/change/parent order of an A/B in one
call, edits of the kernel sources that must apply a known number of times,
copies of the port, libraries built from edited copies of
``bigdl_tpu_torch/csrc`` (every ``nvcc`` started together) and loaded in
place of the package's, and SASS instruction counts per kernel.

An edit is ``(path, old, new)``, which must match exactly once,
``(path, old, new, count)``, which must match ``count`` times, or ``(path,
fn)``, where ``fn(text)`` must change the text; ``path`` is relative to
the root of a checkout.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("bigdl_tpu_torch", "csrc")


def card_or_exit(tool: str) -> bool:
    """Print the card's name and power limit; False (and a note on stderr)
    where there is no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        print(f"{tool}: CUDA is not available", file=sys.stderr)
        return False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return True


def ab(parent: str, run_one) -> int:
    """The runs of an A/B in one call, ``run_one(label, checkout)`` for
    parent, this checkout, this checkout, parent, every one of them; the
    first non-zero exit code, or 0."""
    rc = 0
    for label, tree in (("parent 1", parent), ("change 1", HERE),
                        ("change 2", HERE), ("parent 2", parent)):
        r = run_one(label, tree)
        rc = rc or r
    return rc


def edited(text: str, edits, what: str) -> str:
    """``text`` with each of ``edits`` (without their paths) applied: an
    ``(old, new)`` or ``(old, new, count)`` that does not match the text
    exactly once (``count`` times), or a function that leaves it as it
    was, stops the run."""
    for e in edits:
        if callable(e[0]):
            new = e[0](text)
            if new == text:
                raise SystemExit(f"{what}: an edit no longer changes the "
                                 "text")
            text = new
            continue
        old, new, count = (tuple(e) + (1,))[:3]
        if text.count(old) != count:
            raise SystemExit(f"{what}: the text to change is there "
                             f"{text.count(old)} times, not {count}: "
                             f"{old[:70]!r}")
        text = text.replace(old, new)
    return text


def apply_edits(root: str, edits, what: str) -> None:
    """Apply ``edits`` to the files under ``root``."""
    paths = []
    for e in edits:
        if e[0] not in paths:
            paths.append(e[0])
    for path in paths:
        full = os.path.join(root, path)
        with open(full) as f:
            text = f.read()
        text = edited(text, [e[1:] for e in edits if e[0] == path],
                      f"{what} ({path})")
        with open(full, "w") as f:
            f.write(text)


def check_edits(edits, what: str, root: str = HERE) -> None:
    """Stop unless every edit applies to the sources under ``root`` as
    they are (nothing is written)."""
    paths = {e[0] for e in edits}
    for path in paths:
        with open(os.path.join(root, path)) as f:
            edited(f.read(), [e[1:] for e in edits if e[0] == path],
                   f"{what} ({path})")


def copy_port(root: str) -> str:
    """A fresh copy of the port and ``chip_smoke.py`` under ``root`` (it
    builds its own library at first use)."""
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shutil.copytree(os.path.join(HERE, "bigdl_tpu_torch"),
                    os.path.join(root, "bigdl_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(HERE, "chip_smoke.py"), root)
    return root


def build_libraries(variants, root: str, sources, extra=()):
    """One library for each name of ``variants`` ({name: edits}): an
    edited copy of ``bigdl_tpu_torch/csrc`` under ``root/<n>``, whose
    ``sources`` are compiled and linked with ``extra`` (compiled once,
    unedited).  Every copy is written first, so an edit that no longer
    applies stops the run before any ``nvcc`` starts; then all compile at
    once.  Returns {name: library path}."""
    sys.path.insert(0, HERE)
    from bigdl_tpu_torch.ops import _build
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cc = [_build._nvcc(), *_build.ARCH, *_build.FLAGS]
    dirs = {}
    for i, (name, edits) in enumerate(variants.items()):
        d = os.path.join(root, str(i))
        shutil.copytree(os.path.join(HERE, CSRC), os.path.join(d, CSRC))
        apply_edits(d, edits, name)
        dirs[name] = d

    def obj(d, src):
        return os.path.join(d, os.path.basename(src) + ".o")

    procs = [(f"{src} (unedited)", subprocess.Popen(
        cc + ["-c", os.path.join(HERE, src), "-o", obj(root, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in extra]
    procs += [(name, subprocess.Popen(
        cc + ["-c", os.path.join(d, src), "-o", obj(d, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, d in dirs.items() for src in sources]
    for what, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{what}: nvcc failed\n{out[-3000:]}")
    libs = {}
    for name, d in dirs.items():
        libs[name] = os.path.join(d, "lib.so")
        subprocess.run([_build._nvcc(), *_build.ARCH, "-shared", "-o",
                        libs[name]] + [obj(d, s) for s in sources] +
                       [obj(root, s) for s in extra], check=True)
    return libs


def sass_counts(cu: str, root: str, patterns):
    """Per kernel of ``cu``, compiled to a cubin under ``root``: its SASS
    instruction count and, for each ``patterns`` entry {name: text}, the
    instructions that contain the text."""
    import re
    sys.path.insert(0, HERE)
    from bigdl_tpu_torch.ops import _build
    os.makedirs(root, exist_ok=True)
    cubin = os.path.join(root, os.path.basename(cu) + ".cubin")
    subprocess.run([_build._nvcc(), *_build.ARCH, *_build.FLAGS, "-cubin",
                    cu, "-o", cubin], check=True,
                   cwd=os.path.dirname(os.path.abspath(cu)))
    nvcc_dir = os.path.dirname(_build._nvcc())
    sass = subprocess.run([os.path.join(nvcc_dir, "cuobjdump"), "-sass",
                           cubin], check=True, capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            out[name] = dict.fromkeys(["instructions", *patterns], 0)
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", ln):
            out[name]["instructions"] += 1
            for key, text in patterns.items():
                out[name][key] += text in ln
    return out


def load_library(path: str):
    """The library at ``path``, its entry points typed as the package's."""
    import ctypes
    sys.path.insert(0, HERE)
    from bigdl_tpu_torch.ops import _build
    lib = ctypes.CDLL(os.path.abspath(path))
    for fn, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def use_library(path: str):
    """Load the library at ``path`` in place of the package's."""
    from bigdl_tpu_torch.ops import _build
    _build._lib = load_library(path)
    return _build._lib
