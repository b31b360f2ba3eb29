"""Synthetic-data throughput harnesses of the port
(``bigdl_tpu/models/perf.py``, the counterpart of BigDL's
``LocalOptimizerPerf``).

``local_perf_main`` trains one of the ``_INPUT_SIZES`` models in float32
on one synthetic host batch, uploaded each step as the reference hands its
numpy batch to each jitted step (``ClassNLLCriterion``, SGD 0.01): one
warm-up step, then ``-i`` timed steps, each waiting for its loss, logged
per iteration; it returns records per second.  ``infer_perf_main`` times
the upload, the eval forward and its argmax, fetched to the host each
iteration: bf16 parameters and input by default (BatchNorm's running
statistics stay f32), ``--fp32`` keeps float32.  On the card their max
pools run K1 (and K3 in a step) and their LRNs K2 (and K4).
``longcontext_perf_main`` trains ``TransformerLM`` at one sequence length
on seeded random ids (targets: the ids rolled by one) with bf16 mixed
precision, ``remat`` and SGD 0.1, one warm-up step and then ``-i`` timed
steps, and returns tokens per second; its attention runs K9 with its LSE
forward and the flash backward K10 and K11.  None of them changes torch's
global TF32 flags.  ``ingest_perf_main`` times the host's record-file
pipeline (read, decode, crop and flip, the multi-threaded batcher) in
images per second, in one process or in ``-w`` spawned worker processes,
one record file a task.

``main`` dispatches as the reference's does (``local`` by default).  The
``distri`` subcommand and ``--dataType double`` raise
``NotImplementedError`` naming the work they wait for.
"""

from __future__ import annotations

import argparse
import logging
import time

logger = logging.getLogger("bigdl_tpu_torch.models.perf")

_INPUT_SIZES = {
    "alexnet": (3, 227, 227),
    "alexnetowt": (3, 224, 224),
    "inception_v1": (3, 224, 224),
    "inception_v2": (3, 224, 224),
    "vgg16": (3, 224, 224),
    "vgg19": (3, 224, 224),
}

# subcommands of the reference's dispatcher that wait for later work
_LATER = {"distri": "the DistriOptimizer slice of the port (ROADMAP.md "
                    "Queue 1 item 12)"}
_DOUBLE = ("--dataType double needs float64 instantiations of the max-pool "
           "and LRN kernels (ROADMAP.md Queue 1 item 14, perf --dataType "
           "double); only float is ported")


def _build(name: str, class_num: int = 1000):
    from bigdl_tpu_torch.models.alexnet import AlexNet, AlexNet_OWT
    from bigdl_tpu_torch.models.inception import Inception_v1, Inception_v2
    from bigdl_tpu_torch.models.vgg import Vgg_16, Vgg_19
    factory = {"alexnet": AlexNet, "alexnetowt": AlexNet_OWT,
               "inception_v1": Inception_v1, "inception_v2": Inception_v2,
               "vgg16": Vgg_16, "vgg19": Vgg_19}
    if name not in factory:
        raise SystemExit(
            f"model can only be {' | '.join(sorted(factory))}, got {name}")
    return factory[name](class_num)


def _parser(name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(name)
    p.add_argument("-b", "--batchSize", type=int, default=128)
    p.add_argument("-i", "--iteration", type=int, default=50)
    p.add_argument("-m", "--model", default="inception_v1",
                   help="alexnet | alexnetowt | inception_v1 | inception_v2"
                        " | vgg16 | vgg19")
    p.add_argument("-d", "--inputdata", default="random",
                   choices=["constant", "random"])
    p.add_argument("--dataType", default="float",
                   choices=["float", "double"],
                   help="float = f32; double is not ported yet")
    p.add_argument("-c", "--corePerNode", type=int, default=None,
                   help="accepted for reference flag parity and ignored")
    return p


def _check_flags(args) -> None:
    if args.corePerNode is not None:
        logger.info("corePerNode=%d accepted for flag parity and ignored",
                    args.corePerNode)
    if args.dataType == "double":
        raise NotImplementedError(_DOUBLE)


def _synthetic_batch(model_name: str, batch: int, kind: str):
    """The reference's batch: every value 0.01 (``constant``) or
    ``RandomState(0).rand`` (``random``), float32 NCHW at the model's input
    size; labels ``arange(batch) % 1000 + 1``."""
    import numpy as np
    c, h, w = _INPUT_SIZES[model_name]
    if kind == "constant":
        data = np.full((batch, c, h, w), 0.01, np.float32)
    else:
        data = np.random.RandomState(0).rand(batch, c, h, w) \
            .astype(np.float32)
    labels = (np.arange(batch) % 1000 + 1).astype(np.float32)
    return data, labels


def local_step(model, data, labels, device):
    """The harness's train step for ``model`` (already on ``device``, in
    training mode, with a generator for its dropout) on one host batch:
    ``step(i)`` uploads the batch, runs the forward, ``ClassNLLCriterion``,
    the gradient and SGD 0.01 in place, and returns the loss tensor (not
    yet fetched).  The batch goes to the device in every step, as the
    reference hands its numpy batch to every jitted step."""
    import torch

    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils.table import T

    params = list(model.param_leaves())
    crit = ClassNLLCriterion()
    optim = SGD(learning_rate=0.01)
    state = {"opt": optim.init_state([p.detach() for p in params])}
    x, y = torch.from_numpy(data), torch.from_numpy(labels)

    def step(i):
        loss = crit(model(x.to(device)), y.to(device))
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            new, state["opt"] = optim.update(
                list(grads), [p.detach() for p in params], state["opt"],
                T(), i)
            for p, v in zip(params, new):
                p.copy_(v)
        return loss.detach()
    return step


def infer_forward(model, data, fp32, device):
    """The harness's inference call for ``model`` (already on ``device``,
    in eval mode) on one host batch: ``fwd()`` uploads the batch, runs the
    forward and its argmax and fetches the classes to the host.  Without
    ``fp32`` the parameters and the host batch are cast to bf16 once, as
    the reference's ``cast_tree`` and ``astype`` cast them; BatchNorm's
    running statistics stay f32."""
    import torch
    from torch.func import functional_call

    from bigdl_tpu_torch.core.precision import cast_tensors

    x = torch.from_numpy(data)
    if fp32:
        run = model
    else:
        x = x.to(torch.bfloat16)
        tensors = cast_tensors(model, torch.bfloat16)
        run = lambda v: functional_call(model, tensors, (v,))  # noqa: E731

    def fwd():
        with torch.inference_mode():
            return run(x.to(device)).argmax(dim=-1).cpu()
    return fwd


def local_perf_main(argv=None, device="cuda"):
    """``LocalOptimizerPerf`` on ``device`` (CUDA by default; it raises
    without CUDA unless asked for the CPU): the model from the port's seeded
    init, its dropout drawing from a generator seeded 1, one warm-up step
    outside the timed loop, then ``-i`` steps each timed to its loss on the
    host.  Returns records/s over the timed steps."""
    import torch

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.utils.log import init_logging

    args = _parser("local-optimizer-perf").parse_args(argv)
    init_logging()
    _check_flags(args)
    device = resolve_device(device)
    model = _build(args.model).to(device).training_()
    model.set_generator(torch.Generator(device).manual_seed(1))
    data, labels = _synthetic_batch(args.model, args.batchSize,
                                    args.inputdata)
    step = local_step(model, data, labels, device)
    float(step(0))              # the warm-up, outside the timed loop

    total0 = time.time()
    for i in range(1, args.iteration + 1):
        t0 = time.time()
        loss = float(step(i))
        dt = time.time() - t0
        logger.info(
            "Iteration %d, Loss %.4f, Throughput %.1f records/second",
            i, loss, args.batchSize / dt)
    ips = args.batchSize * args.iteration / (time.time() - total0)
    logger.info("Average throughput %.1f records/second", ips)
    return ips


def infer_perf_main(argv=None, device="cuda"):
    """Inference throughput on ``device`` (CUDA by default; it raises
    without CUDA unless asked for the CPU): :func:`infer_forward` once
    outside the timed loop, then ``-i`` times.  Returns records/s."""
    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.utils.log import init_logging

    p = _parser("infer-perf")
    p.add_argument("--fp32", action="store_true",
                   help="keep f32 parameters and activations (default "
                        "casts them to bf16)")
    args = p.parse_args(argv)
    init_logging()
    _check_flags(args)
    device = resolve_device(device)
    model = _build(args.model).to(device).evaluate()
    data, _ = _synthetic_batch(args.model, args.batchSize, args.inputdata)
    fwd = infer_forward(model, data, args.fp32, device)
    fwd()                       # the warm-up, outside the timed loop

    total0 = time.time()
    for i in range(1, args.iteration + 1):
        t0 = time.time()
        fwd()
        logger.info("Iteration %d, Throughput %.1f records/second",
                    i, args.batchSize / (time.time() - t0))
    ips = args.batchSize * args.iteration / (time.time() - total0)
    logger.info("Average inference throughput %.1f records/second", ips)
    return ips


def longcontext_perf_main(argv=None, device="cuda"):
    """One TransformerLM train step after another at ``--seqLen`` on
    ``device`` (CUDA by default; it raises without CUDA unless asked for
    the CPU): ``TransformerLM(vocab, max_len=T, embed, heads, layers,
    remat)`` built from its seeded init, ids from ``RandomState(0)``, bf16
    mixed precision over f32 weights, per-token NLL averaged over time, SGD
    0.1.  Logs ms per step, tokens/s and the first and last losses; returns
    tokens/s."""
    import numpy as np
    import torch

    from bigdl_tpu_torch.core.device import resolve_device, synchronize
    from bigdl_tpu_torch.core.precision import mixed_forward
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils.table import T

    p = argparse.ArgumentParser("longcontext-perf")
    p.add_argument("-t", "--seqLen", type=int, default=8192)
    p.add_argument("-b", "--batchSize", type=int, default=1)
    p.add_argument("-l", "--layers", type=int, default=8)
    p.add_argument("-e", "--embed", type=int, default=512)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--vocab", type=int, default=8192)
    p.add_argument("-i", "--iteration", type=int, default=5)
    p.add_argument("--no-remat", dest="remat", action="store_false")
    args = p.parse_args(argv)
    device = resolve_device(device)

    model = TransformerLM(args.vocab, max_len=args.seqLen,
                          embed_dim=args.embed, num_heads=args.heads,
                          num_layers=args.layers, remat=args.remat)
    model = model.to(device).training_()
    params = list(model.param_leaves())
    crit = TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)
    optim = SGD(learning_rate=0.1)
    opt_state = optim.init_state([x.detach() for x in params])
    rs = np.random.RandomState(0)
    ids_np = rs.randint(1, args.vocab + 1, (args.batchSize, args.seqLen))
    ids = torch.from_numpy(ids_np).to(device)
    tgt = torch.from_numpy(np.roll(ids_np, -1, axis=1)
                           .astype(np.float32)).to(device)

    def step(i):
        nonlocal opt_state
        loss = crit(mixed_forward(model, ids), tgt)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            new, opt_state = optim.update(
                list(grads), [x.detach() for x in params], opt_state, T(),
                i)
            for x, y in zip(params, new):
                x.copy_(y)
        return loss.detach()

    first = float(step(0))   # the host waits for the step
    synchronize(device)
    t0 = time.time()
    for i in range(1, args.iteration + 1):
        loss = step(i)
    last = float(loss)
    dt = (time.time() - t0) / args.iteration
    toks = args.batchSize * args.seqLen / dt
    logger.info("T=%d L=%d E=%d remat=%s: %.1f ms/step, %.0f tokens/sec, "
                "loss %.3f -> %.3f", args.seqLen, args.layers, args.embed,
                args.remat, dt * 1e3, toks, first, last)
    return toks


def ingest_perf_main(argv=None, device="cuda"):
    """Record-file ingest throughput on the host: ``-n`` seeded images of
    ``--size``² written once under ``--workDir`` (rewritten when the
    parameters change) as record files, then ``-e`` passes of the training
    pipeline over them (``_ingest_pipeline``: read, decode, random
    ``--crop`` crop, HFlip(0.5), the two-thread batcher), each logged in
    images/s.  ``-w`` above 1 runs one pipeline a record file in that many
    spawned worker processes, started and warmed before the timing.  The
    device is checked as every entry point's (CUDA by default; it raises
    without CUDA unless asked for the CPU), and the harness runs on the
    host.  Returns the last pass's images/s."""
    import json
    import os
    import tempfile

    import numpy as np

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.dataset import ingest_config
    from bigdl_tpu_torch.dataset.image import LabeledImage
    from bigdl_tpu_torch.dataset.seqfile import (BGRImgToLocalSeqFile,
                                                 seq_file_paths)
    from bigdl_tpu_torch.utils.log import init_logging

    p = argparse.ArgumentParser("ingest-perf")
    p.add_argument("-b", "--batchSize", type=int, default=256)
    p.add_argument("-n", "--images", type=int, default=4096,
                   help="synthetic images to generate")
    p.add_argument("--size", type=int, default=256,
                   help="stored image edge (the 256 short side)")
    p.add_argument("--crop", type=int, default=224)
    p.add_argument("-w", "--workers", type=int, default=1,
                   help="ingest worker processes, one pipeline each; scale "
                        "to the host's cores")
    p.add_argument("--workDir", default=os.path.join(
        tempfile.gettempdir(), "bigdl_tpu_torch_ingest"))
    p.add_argument("-e", "--epochs", type=int, default=2,
                   help="passes over the data (the first warms the page "
                        "cache)")
    args = p.parse_args(argv)
    resolve_device(device)
    init_logging()

    os.makedirs(args.workDir, exist_ok=True)
    # files of other parameters would time another workload
    params = {"images": args.images, "size": args.size,
              "workers": args.workers}
    marker = os.path.join(args.workDir, "params.json")
    try:
        with open(marker) as f:
            stale = json.load(f) != params
    except (OSError, ValueError):   # a missing or torn marker
        stale = True
    if stale or not seq_file_paths(args.workDir):
        for f in seq_file_paths(args.workDir):
            os.remove(f)
        rng = np.random.RandomState(0)

        def imgs():
            for i in range(args.images):
                yield LabeledImage(
                    rng.randint(0, 256, (args.size, args.size, 3))
                    .astype(np.float32), float(i % 1000 + 1))

        # at least one file a worker, else -w cannot scale
        block = max(1, args.images // max(args.workers, 4))
        files = list(BGRImgToLocalSeqFile(
            block, os.path.join(args.workDir, "part")).apply(imgs()))
        with open(marker, "w") as f:
            json.dump(params, f)
        logger.info("generated %d record files (%d images)", len(files),
                    args.images)

    shards = seq_file_paths(args.workDir)
    pool = None
    n_pool = 1
    if args.workers > 1:
        if args.workers > (os.cpu_count() or 1):
            logger.warning("%d workers on a %d-core host: expect overhead, "
                           "not speedup", args.workers, os.cpu_count() or 1)
        if args.workers > len(shards):
            logger.warning("only %d file shards for %d workers: "
                           "parallelism capped", len(shards), args.workers)
        # processes over file shards: the per-image Python chain holds the
        # GIL, so each worker runs a whole pipeline over whole files
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        ctx = multiprocessing.get_context(ingest_config.start_method())
        n_pool = min(args.workers, len(shards))
        pool = ProcessPoolExecutor(n_pool, mp_context=ctx)

    ips = 0.0
    try:
        if pool is not None:
            # every worker imports before the timing: a barrier as wide as
            # the pool keeps one quick worker from taking every warm-up
            mgr = ctx.Manager()
            try:
                barrier = mgr.Barrier(n_pool)
                list(pool.map(_ingest_warm, [barrier] * n_pool))
            finally:
                mgr.shutdown()
        for epoch in range(args.epochs):
            t0 = time.time()
            count = 0
            if pool is not None:
                for c in pool.map(
                        _ingest_shard_count,
                        [(s, args.crop, args.batchSize) for s in shards]):
                    count += c
            else:
                pipeline = _ingest_pipeline(args.crop, args.batchSize)
                for batch in pipeline(iter(shards)):
                    count += batch.data.shape[0]
            dt = time.time() - t0
            ips = count / dt
            logger.info("epoch %d: %d images in %.2fs -> %.1f images/sec "
                        "(%d workers)", epoch, count, dt, ips, n_pool)
    finally:
        if pool is not None:
            pool.shutdown()
    return ips


def _ingest_warm(barrier):
    """A worker process's imports, before the timing; the barrier makes
    every process of the pool take one."""
    _ingest_pipeline(224, 256)
    barrier.wait(timeout=300)
    return 0


def _ingest_pipeline(crop, batch_size):
    from bigdl_tpu_torch.dataset import (BGRImgCropper, HFlip,
                                         LocalSeqFileToBytes,
                                         SeqBytesToBGRImg)
    from bigdl_tpu_torch.dataset.prefetch import MTLabeledBGRImgToBatch
    return (LocalSeqFileToBytes() >> SeqBytesToBGRImg() >>
            BGRImgCropper(crop, crop) >> HFlip(0.5) >>
            MTLabeledBGRImgToBatch(crop, crop, batch_size, workers=2))


def _ingest_shard_count(job):
    """One worker process: the whole pipeline over one record file; the
    images it batched."""
    path, crop, batch_size = job
    n = 0
    for batch in _ingest_pipeline(crop, batch_size)(iter([path])):
        n += batch.data.shape[0]
    return n


def main(argv=None, device="cuda"):
    """Subcommand dispatcher (the reference's ``bigdl-tpu-perf``):
    ``local`` (the default), ``infer``, ``ingest`` and ``longcontext``;
    ``distri`` raises until its slice."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _LATER:
        raise NotImplementedError(
            f"the {argv[0]!r} perf harness comes with {_LATER[argv[0]]}")
    if argv and argv[0] == "infer":
        return infer_perf_main(argv[1:], device=device)
    if argv and argv[0] == "ingest":
        return ingest_perf_main(argv[1:], device=device)
    if argv and argv[0] == "longcontext":
        return longcontext_perf_main(argv[1:], device=device)
    if argv and argv[0] == "local":
        return local_perf_main(argv[1:], device=device)
    return local_perf_main(argv, device=device)


if __name__ == "__main__":
    main()
