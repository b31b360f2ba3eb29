"""The sharded feed's benchmark (``bigdl_tpu/dataset/bench_ingest.py``):
``python -m bigdl_tpu_torch.dataset.bench_ingest``.

Measures the multi-process feed alone, without a training step: records/s
of one full pass at each worker count of ``--workers-list`` over the same
recipe, the ImageNet training pipeline's shape (decode, a random 224 crop,
a horizontal flip, the per-channel normalize, the NCHW pack, then the
staging ring to the card in bf16 unless ``--no-staging``).  Two recipes:

* ``jpeg`` (the reference's): in-memory JPEG records (PIL-encoded once at
  the start), decoded by PIL in the workers (``JpegBytesToBGRImg``); needs
  PIL;
* ``seqfile``: BTSF record files of seeded 256-short-side images
  (``write_seq_records``) read and decoded by ``LocalSeqFileToBytes >>
  SeqBytesToBGRImg``, one file a task; needs nothing beyond the port
  (the files go to a temporary folder, removed after).

The rates leave out the pool's start and the first batch.  Then one
instrumented pass at the largest worker count writes its ``ingest.*``
spans to a run ledger (``--run-dir``, a temporary directory by default),
and the run report's ingest section turns them into per-stage capacities
(records per busy second times lanes) and the bound stage, the lowest
capacity.  ``--smoke`` is a tiny run at
workers 0 and 1 without staging.  Spawned workers re-import the main
module: a script that calls ``main`` keeps its entry point under ``if
__name__ == "__main__":``.
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import List, Optional

import numpy as np

from bigdl_tpu_torch.dataset.image import ByteRecord, LabeledImage
from bigdl_tpu_torch.dataset.transformer import Transformer

SEQ_SIDES = (256, 288, 320, 341)       # the long side, in turn


def synth_jpeg_records(n: int, height: int = 256, width: int = 340,
                       quality: int = 85, seed: int = 0) -> List:
    """``n`` in-memory JPEG records with labels: up to 8 distinct images
    (smooth gradients plus noise, which compress like a photo) cycled.
    Encoding is set-up; every record's decode is a full decode."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    blobs = []
    for _ in range(min(n, 8)):
        yy, xx = np.mgrid[0:height, 0:width]
        img = (np.stack([(yy * 255 / height), (xx * 255 / width),
                         ((yy + xx) * 255 / (height + width))], axis=-1)
               + rng.randint(0, 48, (height, width, 3))).clip(0, 255)
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(buf, "JPEG",
                                                   quality=quality)
        blobs.append(buf.getvalue())
    return [ByteRecord(blobs[i % len(blobs)], float(i % 10) + 1)
            for i in range(n)]


def write_seq_records(folder: str, n: int, block: int, seed: int = 0,
                      classes: int = 1000) -> List[str]:
    """``n`` seeded 256-short-side BGR images (the long side from
    ``SEQ_SIDES`` in turn, landscape and portrait alternating), labels
    drawn from 1-``classes``, written by ``BGRImgToLocalSeqFile`` in files
    of ``block``; returns the files."""
    from bigdl_tpu_torch.dataset.seqfile import BGRImgToLocalSeqFile
    rng = np.random.RandomState(seed)
    os.makedirs(folder, exist_ok=True)

    def images():
        for i in range(n):
            long_side = SEQ_SIDES[i % len(SEQ_SIDES)]
            hw = (256, long_side) if i % 2 else (long_side, 256)
            yield LabeledImage(rng.randint(0, 256, hw + (3,))
                               .astype(np.float32),
                               float(rng.randint(1, classes + 1)))
    return list(BGRImgToLocalSeqFile(block, os.path.join(folder, "part"))
                .apply(images()))


class JpegBytesToBGRImg(Transformer):
    """ByteRecord of JPEG bytes -> LabeledImage, decoded by PIL (real codec
    work a record).  Top-level: spawn pickles worker chains by
    reference."""

    def __init__(self, normalize: float = 255.0):
        self.normalize = normalize

    def apply(self, prev):
        from PIL import Image
        for rec in prev:
            with Image.open(io.BytesIO(rec.data)) as im:
                rgb = np.asarray(im.convert("RGB"), np.float32)
            yield LabeledImage(rgb[..., ::-1] / self.normalize, rec.label)


def _recipe(batch: int, recipe: str):
    """(decode, augment, batcher): the ImageNet training recipe."""
    from bigdl_tpu_torch.dataset.image import (BGRImgCropper,
                                               BGRImgNormalizer,
                                               BGRImgToBatch, HFlip)
    from bigdl_tpu_torch.dataset.seqfile import (LocalSeqFileToBytes,
                                                 SeqBytesToBGRImg)
    augment = (BGRImgCropper(224, 224) >> HFlip() >>
               BGRImgNormalizer((0.406, 0.456, 0.485),
                                (0.225, 0.224, 0.229)))
    decode = JpegBytesToBGRImg() if recipe == "jpeg" else \
        LocalSeqFileToBytes() >> SeqBytesToBGRImg()
    return decode, augment, BGRImgToBatch(batch)


def measure_workers(items, workers: int, batch: int, chunk: int,
                    staging: bool, depth: Optional[int], dtype,
                    recipe: str = "jpeg", device="cuda") -> float:
    """Records/s of one full pass at ``workers`` ingest processes (the
    first batch, which waits for the pool's start, left out)."""
    from bigdl_tpu_torch.dataset.sharded import ShardedDataSet

    decode, augment, batcher = _recipe(batch, recipe)
    ds = ShardedDataSet(items, decode=decode, augment=augment,
                        batcher=batcher, pack_in_workers=workers > 0,
                        staging=staging, staging_depth=depth,
                        staging_dtype=dtype, device=device,
                        workers=workers, chunk=chunk)
    try:
        it = ds.data(train=False)
        first = next(it)
        n = 0
        t0 = time.perf_counter()
        for b in it:
            n += b.size()
        if staging and first.data.is_cuda:
            import torch
            torch.cuda.synchronize(first.data.device)
        dt = time.perf_counter() - t0
        return n / dt if dt > 0 else 0.0
    finally:
        ds.close()


def attribution_pass(items, workers: int, batch: int, chunk: int,
                     staging: bool, depth: Optional[int], dtype,
                     run_dir: str, recipe: str = "jpeg",
                     device="cuda") -> dict:
    """One instrumented pass; returns the run report's ``ingest`` section
    (per-stage capacities and the bound stage) computed from its
    ledger."""
    from bigdl_tpu_torch.observability import ledger
    from bigdl_tpu_torch.observability.report import (build_report,
                                                      load_ledger)

    prev = ledger.get_ledger()
    led = ledger.set_run_dir(run_dir)
    try:
        measure_workers(items, workers, batch, chunk, staging, depth,
                        dtype, recipe=recipe, device=device)
        led.flush()
    finally:
        ledger.set_run_dir(prev.dir if prev is not None else None)
    records, _ = load_ledger(run_dir)
    return build_report(records)["ingest"] or {}


def main(argv: Optional[List[str]] = None) -> dict:
    import argparse
    p = argparse.ArgumentParser(
        "bench_ingest",
        description="Sharded-ingest throughput: records/s at each worker "
                    "count over the ImageNet training recipe")
    p.add_argument("--records", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--chunk", type=int, default=32,
                   help="records a task (jpeg); the seqfile recipe takes "
                        "one file a task, --chunk records a file")
    p.add_argument("--workers-list", default=None,
                   help="comma-separated worker counts (default 0,1,2,4; "
                        "--smoke: 0,1)")
    p.add_argument("--recipe", choices=("jpeg", "seqfile"), default="jpeg")
    p.add_argument("--depth", type=int, default=None,
                   help="staging-ring depth (default BIGDL_TPU_INGEST_DEPTH "
                        "or 2)")
    p.add_argument("--dtype", default="bf16",
                   help="staging cast (bf16/f16/f32, keep: none)")
    p.add_argument("--no-staging", action="store_true",
                   help="stop at host batches (no device)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="write the result as JSON")
    p.add_argument("--run-dir", default=None,
                   help="ledger dir of the attribution pass (default: a "
                        "temp dir)")
    p.add_argument("--smoke", action="store_true",
                   help="a tiny run: workers 0,1, no staging")
    args = p.parse_args(argv)

    if args.smoke:
        args.records = min(args.records, 64)
        args.batch_size = min(args.batch_size, 16)
        args.chunk = min(args.chunk, 8)
        if args.workers_list is None:
            args.workers_list = "0,1"
        args.no_staging = True
    if args.workers_list is None:
        args.workers_list = "0,1,2,4"
    staging = not args.no_staging
    dtype = None if args.dtype in ("keep", "") else args.dtype
    workers_list = [int(w) for w in args.workers_list.split(",")]

    tmp = None
    if args.recipe == "jpeg":
        items, chunk = synth_jpeg_records(args.records), args.chunk
    else:
        import tempfile
        tmp = tempfile.mkdtemp(prefix="bench_ingest_records_")
        items = write_seq_records(tmp, args.records, args.chunk)
        chunk = 1
    try:
        curve = {}
        for w in workers_list:
            rate = measure_workers(items, w, args.batch_size, chunk,
                                   staging, args.depth, dtype,
                                   recipe=args.recipe, device=args.device)
            curve[str(w)] = rate
            print(json.dumps({"workers": w, "images_per_sec": rate}),
                  flush=True)
        import tempfile
        run_dir = args.run_dir or tempfile.mkdtemp(prefix="bench_ingest_")
        attr_workers = max(workers_list)
        ingest = attribution_pass(items, attr_workers, args.batch_size,
                                  chunk, staging, args.depth, dtype,
                                  run_dir, recipe=args.recipe,
                                  device=args.device)
    finally:
        if tmp is not None:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)

    # scaling compares process counts: workers=0 runs in the caller's
    # process, and its lack of IPC is no worker-scaling win
    base = curve.get("1", 0.0)
    procs = [k for k in curve if int(k) >= 1]
    best = max(procs or curve, key=lambda k: curve[k])
    out = {
        "metric": "ingest_images_per_sec",
        "recipe": {"jpeg": "synthetic in-memory JPEG -> PIL decode",
                   "seqfile": "BTSF record files -> LocalSeqFileToBytes >> "
                              "SeqBytesToBGRImg"}[args.recipe]
        + " -> random 224 crop -> hflip -> normalize -> NCHW pack"
        + (f" -> staging ring ({args.dtype}) to {args.device}" if staging
           else " (host batches only)"),
        "records": args.records, "batch": args.batch_size,
        "chunk": chunk, "host_cores": os.cpu_count() or 1,
        "worker_scaling_imgs_per_sec": curve,
        "scaling_x_vs_1_worker": curve[best] / base if base else None,
        "best_workers": int(best),
        "stage_attribution": {
            name: {"capacity_records_per_s": st["capacity_records_per_s"],
                   "lanes": st["lanes"], "busy_s": st["busy_s"]}
            for name, st in (ingest.get("stages") or {}).items()},
        "bound_stage": ingest.get("bound_stage"),
        "attribution_workers": attr_workers,
        "run_dir": run_dir,
        "note": "rates leave out the pool's start and the first batch; "
                "stage capacities come from the ledger's spans (records "
                "per busy second x lanes), the bound stage is the lowest "
                "capacity",
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
