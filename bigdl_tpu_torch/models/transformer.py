"""Decoder-only transformer language model (``bigdl_tpu/models/
transformer.py``): pre-LayerNorm residual blocks of multi-head attention
and a GELU feed-forward, learned positions (or rope), and a weight-tied
output head.

``TransformerLM(ids)`` takes 1-based token ids (B, T) and returns the
log-softmax of the tied logits (B, T, vocab).  Its attention runs K8 or K9
on the card (``ops/attention.py`` picks them as the reference does), and in
training K9's backward runs the flash backward kernels K10 and K11; with
``remat`` each block is recomputed in the backward instead of keeping its
activations (the reference's ``jax.checkpoint``); the
decode paths (:meth:`TransformerLM.decode`, :meth:`TransformerLM.generate`
and the slot-addressable :meth:`TransformerLM.decode_slots`) are plain
tensor math through a KV cache written in place, as the reference's
``apply_decode`` is plain einsum math; :meth:`TransformerLM.decode_pages`
reads a block-paged pool through K12 on the card.  A cache dtype other
than the model's promotes as ``jnp`` does.  Every path serves a
``quant.quantize_model(lm, mode, extra_keys=("tok",))`` copy, as the
reference's serve a packed tree: its projections run K13, K14 or K15 by
rung, its tied table is gathered packed with only the gathered rows
widened, to float32 (so the copy computes in f32 from the embedding on, as
the reference's does), and its head runs ``quant.int8_matmul``.  Sampling draws from an
explicit ``torch.Generator``: JAX's key stream cannot be matched, so only
greedy decoding reproduces the reference token for token.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from bigdl_tpu_torch.core.module import Module, seeded
from bigdl_tpu_torch.core.precision import promote
from bigdl_tpu_torch.nn.activation import gelu
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.dropout import Dropout
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.normalization import LayerNorm
from bigdl_tpu_torch.ops import quant
from bigdl_tpu_torch.utils.file import File, load_model_snapshot


class TransformerBlock(Module):
    """Pre-LN residual block: x + attn(ln1(x)); x + fc2(gelu(fc1(ln2(x)))).
    Dropout (when > 0) acts in training mode only."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.0, causal: bool = True,
                 num_kv_heads: Optional[int] = None, rope: bool = False):
        super().__init__()
        self.ln1 = LayerNorm(embed_dim)
        self.attn = MultiHeadAttention(embed_dim, num_heads, causal=causal,
                                       num_kv_heads=num_kv_heads, rope=rope)
        self.ln2 = LayerNorm(embed_dim)
        self.fc1 = Linear(embed_dim, ffn_dim)
        self.fc2 = Linear(ffn_dim, embed_dim)
        self.dropout = Dropout(dropout) if dropout > 0 else None

    def _drop(self, x):
        return x if self.dropout is None else self.dropout(x)

    def _ffn(self, x):
        return self.fc2(gelu(self.fc1(self.ln2(x))))

    def forward(self, x, key_padding_mask=None):
        x = x + self._drop(self.attn(self.ln1(x),
                                     key_padding_mask=key_padding_mask))
        return x + self._drop(self._ffn(x))

    def decode_step(self, x_t, cache, pos: int):
        """The block for tokens at ``[pos, pos+S)`` through the KV cache,
        the FFN as in eval."""
        x = x_t + self.attn.apply_decode(self.ln1(x_t), cache, pos)
        return x + self._ffn(x)

    def decode_step_slots(self, x_t, cache, pos, active):
        """:meth:`decode_step` with each row a cache slot at its own depth
        ``pos`` (B,), ``active`` (B,) gating its write."""
        x = x_t + self.attn.apply_decode_slots(self.ln1(x_t), cache, pos,
                                               active)
        return x + self._ffn(x)

    def decode_step_pages(self, x_t, cache, pages, pos, active):
        """:meth:`decode_step_slots` through the page table ``pages``
        (B, Lp) into a shared page pool."""
        x = x_t + self.attn.apply_decode_pages(self.ln1(x_t), cache, pages,
                                               pos, active)
        return x + self._ffn(x)


def _recomputed(blk, x, key_padding_mask):
    """``blk(x)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward.  The recompute must compute what the forward did, so it runs
    on the parameter tensors the forward saw (``mixed_forward`` swaps in
    bf16 casts only while the forward runs) and, when the block drops out,
    draws the same mask: the generator is rewound to the state the forward
    started from and put back where it was after, as the reference
    re-derives the block's key (``child_rng(rng, i)``)."""
    names = [n for n, _ in blk.named_parameters()]
    tensors = [functools.reduce(getattr, n.split("."), blk) for n in names]
    drop = blk.dropout
    gen = drop.generator if drop is not None and drop.training and \
        drop.p > 0 else None
    start = None if gen is None else gen.get_state()
    forwards = []

    def run(x_, kpm, *ts):
        rewind = bool(forwards) and gen is not None
        forwards.append(1)
        if rewind:
            now = gen.get_state()
            gen.set_state(start)
        try:
            return functional_call(blk, dict(zip(names, ts)), (x_,),
                                   {"key_padding_mask": kpm})
        finally:
            if rewind:
                gen.set_state(now)

    return checkpoint(run, x, key_padding_mask, *tensors,
                      use_reentrant=False)


class TransformerLM(Module):

    def __init__(self, vocab_size: int, max_len: int = 512,
                 embed_dim: int = 256, num_heads: int = 4,
                 num_layers: int = 4, ffn_dim: Optional[int] = None,
                 dropout: float = 0.0, causal: bool = True,
                 num_kv_heads: Optional[int] = None,
                 position: str = "learned", remat: bool = False):
        super().__init__()
        if position not in ("learned", "rope"):
            raise ValueError(f"position must be 'learned' or 'rope', got "
                             f"{position!r}")
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.embed_dim = embed_dim
        self.position = position
        ffn_dim = ffn_dim or 4 * embed_dim
        self.tok = nn.Parameter(torch.empty(vocab_size, embed_dim))
        self.pos = nn.Parameter(torch.empty(max_len, embed_dim)) \
            if position == "learned" else None
        self.blocks = nn.ModuleList(
            TransformerBlock(embed_dim, num_heads, ffn_dim, dropout=dropout,
                             causal=causal, num_kv_heads=num_kv_heads,
                             rope=position == "rope")
            for _ in range(num_layers))
        self.ln_f = LayerNorm(embed_dim)
        self.remat = remat
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        scale = 1.0 / math.sqrt(self.embed_dim)
        with torch.no_grad():
            for p in (self.tok, self.pos):
                if p is not None:
                    p.copy_(torch.randn(tuple(p.shape), generator=gen) *
                            scale)

    def _tok_rows(self, ids):
        """Rows of the 0-based ``ids`` of the tied table: gathered packed
        and widened to float32 where a ``quantize_model(...,
        extra_keys=("tok",))`` copy packs it (``_embed_rows``)."""
        qt = quant.packed_weight(self, "tok")
        if qt is not None:
            return quant.int8_gather_rows(qt, ids)
        return F.embedding(ids, self.tok)

    def _embed(self, ids, offset: int):
        """Token rows of the 1-based ``ids`` plus learned positions from
        ``offset``."""
        ids = torch.as_tensor(ids, device=self.tensor_device()).long() - 1
        x = self._tok_rows(ids)
        if self.pos is not None:
            x = x + self.pos[offset:offset + ids.shape[1]][None]
        return x

    def _embed_rows(self, ids, pos):
        """Token rows of the 1-based ``ids`` (B, S) plus, for learned
        positions, the table rows at each row's ``pos_b + [0, S)``, clipped
        into the table: an out-of-table position (a right-pad token, a row
        at its cache end) gives a finite row, where a NaN written to the
        trash page would reach every row through 0 * NaN."""
        ids = torch.as_tensor(ids, device=self.tensor_device()).long()
        x = self._tok_rows(ids - 1)
        if self.pos is not None:
            pos = torch.as_tensor(pos, device=self.tensor_device()).long()
            positions = pos[:, None] + torch.arange(ids.shape[1],
                                                    device=pos.device)
            x = x + self.pos[positions.clamp(0, self.max_len - 1)]
        return x

    def _tied_logits(self, x):
        """``x @ tok.T``, the weight-tied head (``_tied_logits``): a packed
        table runs ``quant.int8_matmul`` with the per-row scales of the
        gather, in x's dtype."""
        qt = quant.packed_weight(self, "tok")
        if qt is not None:
            return quant.int8_matmul(x, qt)
        return torch.matmul(*promote(x, self.tok.t()))

    def _head(self, x):
        """Tied logits of the final hidden states: ``ln_f(x) @ tok.T``."""
        return self._tied_logits(self.ln_f(x))

    def logits(self, input, key_padding_mask=None):
        """LogSoftMax's input: the tied logits (B, T, vocab)."""
        t = input.shape[1]
        if self.position == "learned" and t > self.max_len:
            raise ValueError(f"positions 0+{t} exceed max_len "
                             f"{self.max_len}")
        x = self._embed(input, 0)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = _recomputed(blk, x, key_padding_mask)
            else:
                x = blk(x, key_padding_mask=key_padding_mask)
        return self._head(x)

    def forward(self, input, key_padding_mask=None):
        """``key_padding_mask``: optional (B, T) boolean, True = real
        token.  Padded keys are left out of every attention row (K9 on the
        card); padded query rows still give logits, to be masked in the
        loss."""
        return torch.log_softmax(
            self.logits(input, key_padding_mask=key_padding_mask), dim=-1)

    # -- autoregressive inference (KV cache) ----------------------------------

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   dtype=torch.float32):
        """Per-layer KV caches for :meth:`decode`/:meth:`generate`, on the
        model's device (GQA models cache only the KV heads)."""
        ml = max_len or self.max_len
        return [b.attn.init_cache(batch, ml, dtype) for b in self.blocks]

    def decode(self, tokens, cache, pos: int):
        """Incremental forward: ``tokens`` (B, S) 1-based ids at positions
        ``[pos, pos+S)`` against a cache holding ``[0, pos)``; writes their
        K/V into ``cache`` in place.  Returns the log-probs (B, S, vocab).
        One call with S = prompt length is the prefill, S = 1 calls are
        generation steps.  The caller keeps ``pos + S`` within the cache
        and, for learned positions, ``max_len``."""
        x = self._embed(tokens, pos)
        for blk, c in zip(self.blocks, cache):
            x = blk.decode_step(x, c, pos)
        return torch.log_softmax(self._head(x), dim=-1)

    def decode_slots(self, tokens, cache, pos, active):
        """Slot-addressable :meth:`decode`: row ``b`` is a cache slot whose
        tokens (B, S) sit at ``[pos_b, pos_b + S)``; ``pos`` (B,) int,
        ``active`` (B,) bool.  An inactive slot computes garbage log-probs
        and never writes its cache.  Returns the log-probs (B, S, vocab).
        The caller bounds ``pos + S`` by the cache length (the scheduler
        sheds an over-capacity request at submit)."""
        x = self._embed_rows(tokens, pos)
        for blk, c in zip(self.blocks, cache):
            x = blk.decode_step_slots(x, c, pos, active)
        return torch.log_softmax(self._head(x), dim=-1)

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype=torch.float32):
        """Per-layer block-paged KV pools for :meth:`decode_pages`, each
        (num_pages + 1, H_kv, page_size, D), the last page the trash
        page."""
        return [b.attn.init_paged_cache(num_pages, page_size, dtype)
                for b in self.blocks]

    def decode_pages(self, tokens, cache, pages, pos, active):
        """Page-table :meth:`decode_slots`: row ``b``'s cache positions live
        in the shared pool at ``pages[b, p // page_size]`` ((B, Lp) int).
        Inactive rows and positions past the table write to the trash page,
        never to a page another slot (or a shared prefix) owns.  Every row
        writes its K/V before any row reads, so a row sees the positions
        that rows before it wrote in the same call.  Returns the log-probs
        (B, S, vocab)."""
        x = self._embed_rows(tokens, pos)
        for blk, c in zip(self.blocks, cache):
            x = blk.decode_step_pages(x, c, pages, pos, active)
        return torch.log_softmax(self._head(x), dim=-1)

    def generate(self, prompt, max_new: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 max_len: Optional[int] = None, cache_dtype=torch.float32,
                 top_k: int = 0, top_p: float = 1.0, device="cuda"):
        """Autoregressive generation on ``device`` (CUDA by default; the
        model moves there, and a CUDA device without CUDA raises): one
        prefill over ``prompt`` (B, Tp) 1-based, then ``max_new - 1``
        single-token decode steps, greedy at ``temperature == 0``, else
        sampled from ``generator`` (on ``device``), truncated to the
        ``top_k`` most likely tokens and/or the ``top_p`` nucleus (its
        first token always kept).  Returns (B, max_new) 1-based ids on
        ``device``."""
        self.to(device)   # outside inference mode: the parameters stay
                          # usable by autograd afterwards
        prompt = torch.as_tensor(prompt).to(self.tensor_device()).long()
        b, tp = prompt.shape
        ml = max_len or self.max_len
        if tp + max_new > ml:
            raise ValueError(
                f"prompt {tp} + max_new {max_new} exceeds cache length {ml}")
        if self.position == "learned" and tp + max_new > self.max_len:
            raise ValueError(
                f"prompt {tp} + max_new {max_new} exceeds learned-position "
                f"table length {self.max_len}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new} "
                             "(the prefill always samples one token)")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if temperature > 0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs a generator")

        def pick(logp):
            if temperature <= 0:
                return logp.argmax(dim=-1) + 1
            lp = logp.float() / temperature
            if top_k and top_k < lp.shape[-1]:
                kth = lp.topk(top_k, dim=-1).values[..., -1:]
                lp = torch.where(lp < kth, float("-inf"), lp)
            if top_p < 1.0:
                srt = lp.sort(dim=-1, descending=True).values
                probs = torch.softmax(srt, dim=-1)
                exclusive = probs.cumsum(dim=-1) - probs
                kept = torch.where(exclusive < top_p, srt, float("inf"))
                thresh = kept.amin(dim=-1, keepdim=True)
                lp = torch.where(lp < thresh, float("-inf"), lp)
            return torch.multinomial(torch.softmax(lp, dim=-1), 1,
                                     generator=generator)[:, 0] + 1

        with torch.inference_mode():
            cache = self.init_cache(b, ml, cache_dtype)
            out = torch.empty((b, max_new), dtype=torch.long,
                              device=prompt.device)
            out[:, 0] = pick(self.decode(prompt, cache, 0)[:, -1])
            for i in range(1, max_new):
                lp = self.decode(out[:, i - 1:i], cache, tp + i - 1)
                out[:, i] = pick(lp[:, -1])
        return out


def train_main(argv=None, device="cuda"):
    """CLI training of the LM on a text corpus (``bigdl_tpu/models/
    transformer.py`` ``train_main``, the flags of ``models/rnn/
    Train.scala:35-105``), on ``device`` (CUDA by default; it raises
    without CUDA unless asked for the CPU): ``WordTokenizer`` over
    ``<folder>/input.txt``, ``load_in_data``'s 80/20 split, fixed-length
    1-based ids in batches (the last short one dropped), float32
    ``TransformerLM(vocab + 2, max_len=--maxLen, ...)``, per-token
    ``ClassNLLCriterion`` averaged over time, SGD or Adam with an optional
    linear ``Warmup``, validation by ``Loss`` every epoch.  ``--model``
    starts from a ``model.<n>`` snapshot, ``--state`` resumes a
    ``state.<n>`` snapshot's progress and optimizer state, and
    ``--checkpoint <dir>`` writes a snapshot pair every epoch.  Returns the
    trained model."""
    import argparse

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.dataset import (DataSet, LabeledSentenceToTokens,
                                         SampleToBatch, WordTokenizer,
                                         load_in_data)
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import (SGD, Adam, Loss, Optimizer, Trigger,
                                       Warmup)

    p = argparse.ArgumentParser("transformer-train")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--model", default=None, help="model snapshot location")
    p.add_argument("--state", default=None, help="state snapshot location")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("-r", "--learningRate", type=float, default=0.01)
    p.add_argument("-m", "--momentum", type=float, default=0.0)
    p.add_argument("--optim", choices=["sgd", "adam"], default="sgd")
    p.add_argument("--warmup", type=int, default=0,
                   help="linear LR warmup iterations (0 = off)")
    p.add_argument("--vocab", type=int, default=4000)
    p.add_argument("--embed", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--maxLen", type=int, default=256)
    p.add_argument("-e", "--nEpochs", type=int, default=10)
    p.add_argument("-b", "--batchSize", type=int, default=8)
    args = p.parse_args(argv)
    if args.optim == "adam" and args.momentum:
        p.error("--momentum applies to sgd only (Adam's beta1 is the "
                "analogous knob)")
    device = resolve_device(device)

    dictionary_length = args.vocab + 1
    WordTokenizer(f"{args.folder}/input.txt", args.folder,
                  dictionary_length=dictionary_length).process()
    train, val, train_max, val_max = load_in_data(args.folder,
                                                  dictionary_length)
    fix = min(max(train_max, val_max), args.maxLen)
    train_set = DataSet.array(train) >> LabeledSentenceToTokens(fix) >> \
        SampleToBatch(args.batchSize, drop_last=True)
    val_set = DataSet.array(val) >> LabeledSentenceToTokens(fix) >> \
        SampleToBatch(args.batchSize, drop_last=True)
    # the position table's length comes from the flag, not the corpus
    model = TransformerLM(dictionary_length + 1, max_len=args.maxLen,
                          embed_dim=args.embed, num_heads=args.heads,
                          num_layers=args.layers)
    if args.model:
        load_model_snapshot(model, args.model)
    criterion = TimeDistributedCriterion(ClassNLLCriterion(),
                                         size_average=True)
    optimizer = Optimizer(model=model, dataset=train_set,
                          criterion=criterion, device=device)
    sched = Warmup(args.warmup) if args.warmup > 0 else None
    if args.optim == "adam":
        optimizer.set_optim_method(Adam(learning_rate=args.learningRate,
                                        learning_rate_schedule=sched))
    else:
        optimizer.set_optim_method(SGD(learning_rate=args.learningRate,
                                       momentum=args.momentum,
                                       learning_rate_schedule=sched))
    if args.state:
        optimizer.set_state(File.load(args.state))
    optimizer.set_end_when(Trigger.max_epoch(args.nEpochs))
    optimizer.set_validation(Trigger.every_epoch(), val_set,
                             [Loss(criterion)])
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return optimizer.optimize()


def generate_main(argv=None, device="cuda"):
    """CLI generation (``bigdl_tpu/models/transformer.py`` ``generate_main``,
    the counterpart of ``models/rnn/Test.scala:39-92``) on ``device`` (CUDA
    by default; it raises without CUDA unless asked for the CPU): the model
    of a ``model.<n>`` snapshot extends each ``test.txt`` sentence by
    ``--words`` tokens through :meth:`TransformerLM.generate`, greedy at
    ``--temperature 0``, else sampled from a generator seeded ``--seed +
    i`` for sentence ``i`` (JAX's key stream cannot be matched, so only
    greedy output is the reference's).  Prints the grown sentences and
    returns them."""
    import argparse

    import numpy as np

    from bigdl_tpu_torch.core.device import resolve_device
    from bigdl_tpu_torch.dataset import Dictionary, read_sentence

    p = argparse.ArgumentParser("transformer-generate")
    p.add_argument("-f", "--folder", default="./")
    p.add_argument("--model", required=True)
    p.add_argument("--words", type=int, required=True)
    p.add_argument("--vocab", type=int, default=4000)
    p.add_argument("--embed", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--maxLen", type=int, default=256)
    p.add_argument("--temperature", type=float, default=1.0,
                   help="0 = greedy")
    p.add_argument("--topK", type=int, default=0)
    p.add_argument("--topP", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(device)

    dictionary_length = args.vocab + 1
    vocab = Dictionary(args.folder)
    model = TransformerLM(dictionary_length + 1, max_len=args.maxLen,
                          embed_dim=args.embed, num_heads=args.heads,
                          num_layers=args.layers)
    load_model_snapshot(model, args.model)
    model.evaluate()

    sentences = [[float(vocab.get_index(t)) for t in line]
                 for line in read_sentence(args.folder)]
    results = []
    for i, seq in enumerate(sentences):
        prompt = torch.from_numpy(np.asarray(seq, np.int64)[None] + 1)
        gen = None
        if args.temperature > 0:
            gen = torch.Generator(device=device).manual_seed(args.seed + i)
        out = model.generate(prompt, max_new=args.words,
                             temperature=args.temperature, generator=gen,
                             top_k=args.topK, top_p=args.topP,
                             device=device)
        grown = seq + [float(t - 1) for t in out[0].tolist()]
        results.append(" ".join(vocab.get_word(t) for t in grown))
    for line in results:
        print(line)
    return results


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["generate"]:
        generate_main(sys.argv[2:])
    else:
        train_main()
