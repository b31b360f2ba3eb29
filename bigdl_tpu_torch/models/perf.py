"""Synthetic-data training throughput of the port
(``bigdl_tpu/models/perf.py``, the long-context harness).

``longcontext_perf_main`` trains ``TransformerLM`` at one sequence length
on seeded random ids (targets: the ids rolled by one) with bf16 mixed
precision, ``remat`` and SGD 0.1, one warm-up step and then ``-i`` timed
steps, and returns tokens per second.  On the card its attention runs K9
with its LSE forward and the flash backward K10 and K11.  The reference's
other subcommands (``local``, ``distri``, ``infer``, ``ingest``) come with
their slices.
"""

from __future__ import annotations

import argparse
import logging
import time

logger = logging.getLogger("bigdl_tpu_torch.models.perf")

# subcommands of the reference's dispatcher and the slice each comes with
_LATER = {"local": "layer-zoo", "distri": "DistriOptimizer",
          "infer": "layer-zoo", "ingest": "data-feed"}


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


def main(argv=None, device="cuda"):
    """Subcommand dispatcher (the reference's ``bigdl-tpu-perf``): only
    ``longcontext`` is ported."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "longcontext":
        return longcontext_perf_main(argv[1:], device=device)
    name = argv[0] if argv and argv[0] in _LATER else "local"
    raise NotImplementedError(
        f"the {name!r} perf harness comes with the {_LATER[name]} slice of "
        "the port; only 'longcontext' is ported")


if __name__ == "__main__":
    main()
