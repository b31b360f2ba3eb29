#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. card line (name and power limit from nvidia-smi) and the nvcc build of
   every kernel from ``bigdl_tpu_torch/csrc``;
2. every forward kernel (K1 max pool, K2 LRN) against its plain PyTorch
   version on the card, at the shapes full-width Inception-v1 gives it at
   batch 32 and at ragged shapes, in float32 and bfloat16;
2b. the backward kernels (K3 max pool, K4 LRN) the same way, K3 on the
   argmax codes K1 wrote, and one autograd round trip per layer on the
   card against the same on the CPU;
2c. the quantized matmuls (K13 with int8 and e4m3 weights, K14 int8 x
   int8, K15 int4) against their plain versions at every (M, K, N) that
   quantized Inception-v1 gives them at buckets 8 and 32, at ragged shapes
   and at the edges of the bf16 kernel's tiles and plan (M 63-65 and
   127-129, N 8/24/256/257/384, K 600, odd K, K split unevenly over
   blocks, x at row 1 of a larger tensor), in float32 and bfloat16: K14
   bit-equal, K13/K15 within 1e-4 of each output's sum of |products| (f32
   sums in another order), plus one bfloat16 rounding step in bfloat16;
   K13 (both weight kinds) and K15 bit-equal over two bf16 launches at a
   split-K shape and at conv2's; then the bf16 kernel's plan (rows and
   columns a block, splits of K) and x's copy (TMA or loads) at every
   product of the path;
3. serving: full-width ``Inception_v1(1000)`` with seeded random weights
   behind ``InferenceServer(DLClassifier(..., device="cuda"),
   batch_buckets=(8, 32))``; every request must resolve to the same class
   as ``DLClassifier.predict``, 8 rows must agree with a CPU run of the
   same weights, and each kernel's launch count must show that every
   forward went through it;
3b. training: full-width ``Inception_v1(1000)`` (dropout 0.4, seeded
   weights) trained 30 steps at batch 32 by ``LocalOptimizer`` with the
   SGD of ``bigdl_tpu/models/inception.py`` ``train_main`` under bf16
   mixed precision, on 64 seeded synthetic images (two epochs per 4 steps,
   so it shuffles), validated by Top1/Top5 every 10 steps; every loss must
   be finite, no step skipped, and the launch counts must show 13 K1 + 13
   K3 + 2 K2 + 2 K4 per step (validation forwards run K1/K2 alone);
3c. the same weights (dropout 0) trained 2 float32 steps at batch 4 on the
   card and on the CPU: losses to rtol 1e-4, every weight to 1e-4;
3d. quantized serving: the same seeded Inception-v1 behind
   ``InferenceServer(DLClassifier(..., quantize="w8",
   compute_dtype=torch.bfloat16), batch_buckets=(8, 32))``; every request
   must equal ``DLClassifier.predict``, each forward must launch 56 K13 +
   13 K1 + 2 K2 and nothing else, and 8 rows must agree with a CPU run of
   the same packed copy: logits within 3 bfloat16 steps of their largest
   magnitude with equal argmax on every row, log-probs within one; then one
   batch-32 forward each of ``w8a8`` (calibrated on 8 seeded rows),
   ``w4`` and ``f8`` with their launch counts (55 K13 + 1 K14; 1 K15;
   1 K13 with e4m3 weights), and for every
   rung its top-1 agreement and mean |dlog-prob| against the unquantized
   bf16 forward and its resident bytes against the bf16 tree (reported,
   not gated: the weights are random);
2d. the attention-forward kernels (K8, K9) against their plain versions
   at the LM paths' shapes ((8, 8, 2048, 64) causal for K8 and for K9 with
   the padded batch's bias, (1, 8, 8192, 64) causal for K9) and at ragged
   ones (GQA 8/2 and 8/1, non-causal, Tq != Tk, head dims 16/32/128/256
   and 48/80/96/160 (zero-padded to the kernels' sizes), T 8, 24 and 200,
   a row with every key padded, at head dim 256 too), in float32 (within
   1e-5 of each output's sum of |p·v|) and bfloat16 (within 2 bfloat16
   steps of it);
2e. the paged-attention kernel K12 against ``paged_attention_plain`` with
   a NaN-poisoned trash page, at the continuous path's decode shape (8
   slots, 8 heads, S 1, d 64, page size 16, Lp 128, at the traffic's
   positions), its prefill shapes (S 512, and S 128 after a 384-token
   head) and ragged ones (GQA 8/2 and 8/1, page sizes 5 and 8, d 48/96/128,
   S 2/3/17, an inactive all-trash row, integer q/k with |s| ~ 30 where
   the scores' bf16 rounding shows), in float32 and bfloat16, and f32
   queries over a bf16 cache; the same tolerances as 2d;
2f. the flash backward: K9 with its row logsumexp, the delta pass
   (``rowsum(dO·O)``, shared by K10 and K11), K10 (dQ) and K11 (dK, dV)
   against their plain versions at the training paths' shapes ((1, 8,
   8192, 64) causal bf16, the long-context run; (8, 8, 4096, 64) causal
   f32, ``train_main``'s) and at ragged ones (T 520 and 1000, T 63, 64, 65
   and 129 at the kernels' 64-row tiles, GQA 8/2, 8/1 and 8/1 at T 8191,
   Tq != Tk, a padded bias with a row whose every key is padded, head dims
   16/32/128/256 (causal too, the wgmma widths N 16 and 128) and
   48/80/96/160) in
   float32 and bfloat16: o as in 2d, lse within 1e-5 of max(1, |lse|),
   delta within 1e-5 of each row's sum |dO·O|, each gradient within 1e-4
   (f32) or two bfloat16 steps (bf16) of its largest magnitude, zero
   gradients where every key is padded; K10 and K11 each bit-equal over two
   launches (head dims 64 and 256); and two autograd round trips through ``fused_attention`` (T
   2112 past the K/V budget, and a key-padding mask) against autograd of
   the chunked plain form, with one K9, one delta pass, one K10 and one K11
   launch each;
2g. the fp16 wire codec K5 (compress), K6 (decompress) and K7 (add, with
   subnormals flushed) against their plain versions: the 42 652 672-element
   f32 parameter vector of 3e's LM, lengths 1, 7, 8191 and 2^20 + 3, views at
   an odd element offset (one K7 operand aligned, one not, and both
   misaligned alike), strided views, and a table of special values (signed
   zeros, subnormals, the smallest and largest normals, infinities, NaNs
   with high and low payloads, quiet and signalling; every pair of the wire
   table for K7): bit-equal wherever the plain result is not a NaN, a NaN
   where it is; K7's flush cases equal the sums XLA gives on the CPU;
3e. LM scoring: the full-width ``TransformerLM`` of ``bench_infer.py``
   (vocab 32000, embed 512, 8 heads, 8 layers, T 2048) with seeded random
   weights cast to bf16, scored by ``LocalValidator`` with
   ``Loss(TimeDistributedCriterion(ClassNLLCriterion(), size_average=True))``
   over 16 sequences (two batches of 8): a finite loss and exactly 8 K8
   per forward and no other kernel; the same batch with a key-padding mask
   of per-row lengths launches exactly 8 K9 and its real positions agree
   with the unpadded forward; the long-context model (vocab 8192, T 8192)
   launches exactly 8 K9 in one forward at batch 1; one row in float32
   against a CPU run of the same weights (log-probs), and the bf16 logits
   of 2 rows against a CPU bf16 run in bf16 steps, with argmax equal
   wherever the top-2 margin exceeds that limit, on most of the 4096
   positions; the same LM at head dim 256 (embed 512 over 2 heads, T 2048)
   scored at batch 4 with exactly 8 K9 and no other kernel, one row's
   logits against a CPU bf16 run within 3 bf16 steps, then one bf16 SGD
   step (lr 0.1) on one row, on the card with exactly 8 K9 (with its LSE),
   8 delta passes, 8 K10 and 8 K11, and on the CPU: losses and the stepped
   models' logits within 3 bf16 steps;
3f. generation at ``measure_lm_decode``'s configuration (batch 8, prompt
   128, 128 new tokens, bf16 cache), greedy and sampled (top_k 50, top_p
   0.9): no K8/K9 launch (the decode path is plain, as in the reference),
   ids in range, sampling reproducible from the generator's seed, and
   greedy float32 tokens of 2 rows x 16 equal to the CPU's and to top_k 1
   sampling in float32 (bf16 log-probs tie at the top, and top_k keeps
   every tie, as the reference's does);
3g. continuous serving: the LM of 3e (bf16 weights, a bf16 pool of 1024
   pages of 16 tokens) behind ``ContinuousGenerator(num_slots=8,
   max_len=2048, page_size=16, seq_buckets=(128, 512))`` (paged, prefix
   cache, K12 on the read path), serving bench_serve.py's traffic mix at
   this width (32 prompts of 512 tokens, about 24 with one 384-token head,
   budgets 16-64 or, for a quarter, 96-128): every output in range and as
   long as its budget, exactly 8 K12 per prefill and per decode step and
   no other kernel, prefix hits, every private page free after
   ``drain()``, an over-capacity request shed typed; one request through
   the bf16 model over the default f32 cache; an f32 copy serving 8
   requests x 32 tokens equal to ``generate`` and to
   ``paged_kernel=False``, request by request;
3h. long-context training: ``models/perf.py`` ``longcontext_perf_main`` at
   its defaults (T 8192, 8 layers, embed 512, 8 heads, vocab 8192, remat,
   bf16 mixed precision, SGD 0.1, one warm-up and 5 timed steps): finite
   losses, the last below the first, and exactly 16 K9 (8 forward, 8
   recomputed), 8 delta passes, 8 K10 and 8 K11 a step and no other
   kernel; one step pair
   with ``--no-remat`` (8 K9 a step); a profile of the default run; one f32
   step of the same model cut to 2 layers on the card and on the CPU (loss
   within 1e-4, every gradient within 1e-4 of its largest magnitude);
3i. ``models/transformer.py`` ``train_main`` at the long-context widths
   (``--vocab 8000 --embed 512 --heads 8 --layers 8 --maxLen 4096 -b 8 -e
   1``, f32) on a corpus written here (40 lines of about 4200 Zipf-drawn
   words over 12 000 types): 4 steps and one validation, finite losses, 8
   K9 + 8 delta + 8 K10 + 8 K11 a step and 8 K9 for the validation forward;
3j. snapshots and resume on that corpus at those widths: A ``train_main -e
   2``, B ``-e 1 --checkpoint <dir>``, C a fresh ``--model <dir>/model.4
   --state <dir>/state.4 -e 2``: C's four losses equal A's steps 5-8 within
   1e-5 relative, every run 8 K9 + 8 delta + 8 K10 + 8 K11 a step; a
   ``model.<n>``
   without its ``state.<n>`` is never picked; ``generate_main --model
   <dir>/model.4 --temperature 0 --words 16`` on two 64-word test
   sentences: ids in range, its sentences those of greedy
   ``TransformerLM.generate`` on the loaded model;
3k. the fp16 codec on the path: the flat f32 gradients (33 608 704
   elements) of two float32 SGD steps of 3h's model compressed by K5,
   summed by K7 and widened by K6, one launch each a call: bit-equal to the plain chain,
   each gradient's round trip within 2^-7 of each value;
4. timings, each line stamped with the card: each kernel's median time at
   the serving shapes and at the training shapes (bf16) beside its bound,
   its plain version and the library call that computes the same
   function; the classifier's forward per bucket; the closed-loop serving
   images/s and request latency per bucket; the train step in bf16 mixed
   precision and in float32; K13-K15 at every distinct product of the
   quantized forward at buckets 32 and 8 (CUDA events, device time from
   torch.profiler, the wrapper's host time), summed per stage of
   Inception-v1 and over the batch-32 forward beside their bounds, plain
   versions and library calls (``F.linear`` on the widened weight; K14
   ``torch._int_mm`` + scale) by both clocks, the
   fused conv (unfold + K13) against cuDNN at three layers, and the ``w8``
   bf16 forward per bucket with a profiler breakdown of its device time;
   K8 and K9 per call at the LM paths' shapes, at train_main's f32 shape
   (8, 8, 4096, 64) and at the LM widths over head dims 128 and 256 in bf16
   (CUDA events and torch.profiler's device time) beside their bound, plain
   version and ``F.scaled_dot_product_attention``, K8 against K9 at T 512
   to 16384, LM scoring tokens/s at both configurations, generation new
   tokens/s and a profiler breakdown of one scoring forward; K12 per call
   at the decode and prefill shapes beside its bound, plain version and
   SDPA on the pre-gathered view, the continuous run's new tokens/s,
   request latency p50 and max, slot occupancy, chunks and prefix hit rate
   with a profiler breakdown of the same traffic, and the same requests
   through ``generate`` in static waves of 8; K9 with and without its LSE,
   the delta pass, K10 and K11 per call at both training shapes beside
   their bounds (6·D and 8·D FLOPs per unmasked pair and head; the delta
   pass by its bytes), their plain versions, and their sum beside SDPA's
   backward (forward + backward less forward), the long-context
   step and tokens/s with a profiler breakdown, and ``train_main``'s step;
   K5, K6 and K7 per call at 42 652 672 elements beside their bytes bound,
   plain versions and, for K6, ``u.view(torch.bfloat16).float()`` (the
   bf16 cast's time beside K5 as a reference of the same traffic), and the
   save and load time of 3j's snapshot pair.

The line before the last is a JSON object with a ``kernels`` list; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH = 32
IMAGE = 224
CLASSES = 1000
BUCKETS = (8, 32)
N_ROWS = 96
CPU_ROWS = 8
WAVES = {8: 3, 32: 2}          # closed-loop serving waves per bucket
TIMING_REPS = 20
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 rate outside tensor cores

# (name, input shape at batch 32, kh, kw, sh, sw, ph, pw, ceil) of the 13
# SpatialMaxPooling layers of Inception-v1 in forward order
POOLS = [
    ("pool1/3x3_s2", (BATCH, 64, 112, 112), 3, 3, 2, 2, 0, 0, True),
    ("pool2/3x3_s2", (BATCH, 192, 56, 56), 3, 3, 2, 2, 0, 0, True),
    ("inception_3a/pool", (BATCH, 192, 28, 28), 3, 3, 1, 1, 1, 1, False),
    ("inception_3b/pool", (BATCH, 256, 28, 28), 3, 3, 1, 1, 1, 1, False),
    ("pool3/3x3_s2", (BATCH, 480, 28, 28), 3, 3, 2, 2, 0, 0, True),
    ("inception_4a/pool", (BATCH, 480, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("inception_4b/pool", (BATCH, 512, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("inception_4c/pool", (BATCH, 512, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("inception_4d/pool", (BATCH, 512, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("inception_4e/pool", (BATCH, 528, 14, 14), 3, 3, 1, 1, 1, 1, False),
    ("pool4/3x3_s2", (BATCH, 832, 14, 14), 3, 3, 2, 2, 0, 0, True),
    ("inception_5a/pool", (BATCH, 832, 7, 7), 3, 3, 1, 1, 1, 1, False),
    ("inception_5b/pool", (BATCH, 832, 7, 7), 3, 3, 1, 1, 1, 1, False),
]
RAGGED_POOLS = [
    ("odd HW, ceil, pad 1", (2, 3, 13, 11), 3, 3, 2, 2, 1, 1, True),
    ("odd HW, floor, pad 1", (2, 7, 9, 7), 3, 3, 2, 2, 1, 1, False),
    ("C=3, 2x2 floor", (3, 3, 15, 15), 2, 2, 2, 2, 0, 0, False),
    ("C=7, ceil, rect window", (2, 7, 10, 13), 3, 2, 2, 3, 0, 1, True),
]
# (name, shape, size, alpha, beta, k) of the 2 LRN layers, then ragged
LRNS = [
    ("pool1/norm1", (BATCH, 64, 56, 56), 5, 1e-4, 0.75, 1.0),
    ("conv2/norm2", (BATCH, 192, 56, 56), 5, 1e-4, 0.75, 1.0),
]
RAGGED_LRNS = [
    ("C=3, HW=35", (2, 3, 5, 7), 5, 1.0, 0.75, 1.0),
    ("C=7, HW=117, even window", (3, 7, 9, 13), 4, 1.0, 0.75, 2.0),
    ("beta 0.5", (2, 7, 9, 13), 5, 1.0, 0.5, 1.0),
    ("beta 1.0 (powf)", (2, 5, 3, 45), 3, 0.5, 1.0, 1.0),
]
LRN_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2e-2, 1e-2)}
# K4 against a plain version that rounds to bf16 at every op
LRN_BWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
QWAVES = {8: 3, 32: 1}         # quantized serving waves per bucket
QCPU_ROWS = 8
QCAL_ROWS = 8
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
INT8_OPS = 1979e12             # H100 SXM dense int8 tensor-core rate
QSUM_RTOL = 1e-4               # K13/K15 vs plain, of sum |x * w| per output
BF16_STEP = 2.0 ** -7          # one bfloat16 rounding step of the output
# w8 bf16 logits, card vs CPU, in bf16 steps of their largest magnitude:
# the card's sums in another order have shown 2, a wrong product far more
QLOGIT_STEPS = 3
RAGGED_MATMULS = [(1, 7, 5), (13, 33, 17), (37, 130, 70), (129, 577, 191),
                  (1, 1024, 1000), (8, 1023, 999), (65, 9, 3),
                  (300, 1728, 384)]
# (M, K, N) at the edges of the bf16 kernel's tiles and plan: M around its
# 64 and 128 rows and ragged at 192, N 8, 24, 256, 257 and 384, K 600
# (8-byte weight rows; K15's 300-byte rows in 4-byte pieces and its x by
# loads, since its high tile would start off 16 bytes), odd K (K15's rows
# byte by byte, x not by TMA), and shapes whose K steps split unevenly (13
# steps in 7 splits, 19 in 19, 8 in 2 at a path width)
QUANT_EDGES = [(63, 64, 8), (64, 128, 24), (65, 192, 256), (127, 256, 257),
               (128, 600, 384), (129, 333, 56), (25400, 72, 40),
               (1568, 832, 160), (392, 1200, 128), (6272, 512, 24)]
# x at row 1 of a larger tensor: k 1001 puts it off 16 bytes (no TMA)
QUANT_OFFSET = [(33, 1001, 48), (130, 512, 96)]
# K13 and K15 bit-equal over two bf16 launches: a split-K shape and conv2
QUANT_BITEQ = [(1568, 832, 160), (100352, 576, 192)]
# fused convs (unfold + K13) timed end to end against cuDNN
QCONVS = ["conv2/3x3", "inception_3a/1x1", "inception_4e/5x5"]
# TransformerLM: the model of bench_infer.py measure_lm_scoring /
# measure_lm_decode, and bigdl_tpu/models/perf.py's long-context model
LM_VOCAB, LM_EMBED, LM_HEADS, LM_LAYERS = 32000, 512, 8, 8
LM_BATCH, LM_T, LM_SEQS = 8, 2048, 16
LM_PAD_LENGTHS = [2048, 1900, 1536, 1024, 777, 512, 129, 1]
LONG_VOCAB, LONG_T = 8192, 8192
GEN_PROMPT, GEN_NEW = 128, 128
GEN_CPU_ROWS, GEN_CPU_NEW = 2, 16
LM_CPU_ROWS = 2
# the padded rows held against the CPU at every position: lengths 777 and
# 1, so most of their query rows are padded and see the key bias
LM_PAD_CPU_ROWS = [4, 7]
# K8/K9 against their plain versions: f32 within ATTN_F32_RTOL of each
# output's sum of |p·v| (softmax weights times |v|); bf16 within
# ATTN_BF16_STEPS bf16 steps of it (the two outputs' roundings can land one
# step apart; the kernels round p to bf16 for the tensor cores)
ATTN_F32_RTOL = 1e-5
ATTN_BF16_STEPS = 2
# (name, b, h, hk, t, tk, d, causal, padded lengths or None)
ATTN_PATH = [
    ("LM scoring, K8", LM_BATCH, LM_HEADS, LM_HEADS, LM_T, LM_T, 64, True,
     None),
    ("LM padded scoring, K9 + bias", LM_BATCH, LM_HEADS, LM_HEADS, LM_T,
     LM_T, 64, True, LM_PAD_LENGTHS),
    ("long context, K9", 1, LM_HEADS, LM_HEADS, LONG_T, LONG_T, 64, True,
     None),
]
ATTN_RAGGED = [
    ("d 48 (padded to 64)", 2, 8, 2, 40, 40, 48, True, None),
    ("d 80 (padded to 128), padded keys", 2, 4, 4, 72, 72, 80, True,
     [72, 30]),
    ("d 96 (padded to 128), non-causal", 1, 4, 2, 33, 50, 96, False, None),
    ("GQA 8/2, T 24", 2, 8, 2, 24, 24, 64, True, None),
    ("MQA 8/1, T 8", 1, 8, 1, 8, 8, 64, True, None),
    ("non-causal, d 32", 2, 4, 4, 40, 40, 32, False, None),
    ("Tq != Tk, d 128", 1, 4, 4, 70, 33, 128, True, None),
    ("Tq < Tk, non-causal, d 16", 2, 2, 1, 24, 100, 16, False, None),
    ("a row with every key padded", 2, 8, 2, 96, 96, 64, True, [0, 50]),
    ("padded, non-causal, d 128", 3, 4, 4, 130, 130, 128, False,
     [130, 64, 1]),
    # head dims 129-256 (zero-padded to 256) and 256, and a T that is not
    # a multiple of the bf16 block's 128 query rows
    ("d 160 (padded to 256)", 2, 4, 2, 100, 100, 160, True, None),
    ("d 256, causal, GQA 8/2", 2, 8, 2, 200, 200, 256, True, None),
    ("d 256, padded keys, a row with every key padded", 3, 4, 4, 130, 130,
     256, True, [130, 0, 77]),
    ("d 256, Tq != Tk", 1, 4, 4, 70, 33, 256, True, None),
    ("T 200", 2, 8, 8, 200, 200, 64, True, None),
]
# phase 4 beside ATTN_PATH: (name, b, h, hk, t, tk, d, causal, lengths,
# dtype) of K8 and K9 (both timed at each): train_main's f32 shape, and the
# bf16 LM widths at head dims 128 and 256 (embed 512 over 4 and 2 heads)
ATTN_TIMED = [
    ("train_main's shape, f32", 8, LM_HEADS, LM_HEADS, 4096, 4096, 64, True,
     None, "float32"),
    ("d 128", LM_BATCH, 4, 4, LM_T, LM_T, 128, True, None, "bfloat16"),
    ("d 256", LM_BATCH, 2, 2, LM_T, LM_T, 256, True, None, "bfloat16"),
]
# card vs CPU on the LM: f32 log-probs of one row; bf16 logits (of the
# unpadded rows, of the padded rows at every position, and of the padded
# forward's real positions against the unpadded forward's, K9 vs K8) in
# bf16 steps of their largest magnitude
LM_F32_ATOL = 3e-5
LM_LOGIT_STEPS = 3
# phase 3e at head dim 256: the LM of 3e at embed 512 over 2 heads, T 2048
# (K9: its keys pass the 512 KB K/V budget), scored on the card at
# LM_D256_BATCH and held against the CPU on LM_D256_CPU_ROWS; then one bf16
# SGD step (LM_D256_LR) on one row on the card and on the CPU: the losses
# and the stepped model's logits within LM_LOGIT_STEPS bf16 steps
LM_D256_HEADS, LM_D256_BATCH, LM_D256_CPU_ROWS, LM_D256_LR = 2, 4, 1, 0.1
# argmax is compared where the top-2 margin exceeds that limit, and those
# positions must be more than this share: most of the unpadded rows'
# positions; a quarter of the padded rows', whose margins run narrower
# (on an H100, 1287 of their 4096 positions above the limit: 334 of 778
# real and 953 of 3318 padded ones)
LM_FIRM_SHARE, LM_PAD_FIRM_SHARE = 0.5, 0.25
# continuous serving (phase 3g): the LM served by ContinuousGenerator(
# num_slots=8, max_len=2048, page_size=16, seq_buckets=(128, 512)) with a
# bf16 pool of 1024 pages; bench_serve.py's _traffic mix at this width
CG_SLOTS, CG_PAGE, CG_BUCKETS = 8, 16, (128, 512)
CG_REQUESTS, CG_PROMPT, CG_HEAD, CG_HEAD_FRAC = 32, 512, 384, 0.75
CG_SHORT, CG_LONG, CG_LONG_FRAC = (16, 64), (96, 128), 0.25
CG_F32_REQUESTS, CG_F32_NEW = 8, 32       # the f32 copy, half sharing the head
# K12 against its plain version (phase 2e): (name, b, h, hkv, s, d, page
# size, lp, tokens per row (0: an inactive row, all-trash table),
# integer-valued q/k at scale 0.3, so that |s| ~ 30); the decode case
# takes its rows' lengths from the traffic.  Pools carry NaN on the trash
# page.  Tolerances as K8/K9's (ATTN_F32_RTOL, ATTN_BF16_STEPS of each
# output's sum of |p·v|).
PAGED_RAGGED = [
    ("prefill S 512", 1, 8, 8, 512, 64, 16, 128, [512], False),
    ("prefill S 128 after a 384-token head", 1, 8, 8, 128, 64, 16, 128,
     [512], False),
    ("GQA 8/2, page size 5", 3, 8, 2, 1, 64, 5, 40, [150, 37, 1], False),
    ("MQA 8/1, page size 8, S 2", 2, 8, 1, 2, 64, 8, 30, [200, 9], False),
    ("d 48, S 3", 2, 8, 8, 3, 48, 16, 16, [100, 250], False),
    ("d 96, GQA 8/4", 2, 8, 4, 1, 96, 16, 16, [60, 255], False),
    ("d 128, S 17", 2, 4, 4, 17, 128, 8, 20, [160, 17], False),
    ("an inactive row (all trash)", 3, 8, 8, 1, 64, 16, 8, [100, 0, 50],
     False),
    ("large scores, |s| ~ 30", 2, 8, 8, 4, 64, 16, 16, [200, 77], True),
]
# the flash backward (phase 2f): K9 with its LSE, K10 and K11 against their
# plain versions at the training paths' shapes, each in its dtype (the
# long-context run in bf16, train_main's in f32), and at ragged ones in
# both; (name, b, h, hk, t, tk, d, causal, padded lengths or None).  o as in
# 2d; lse within FLASH_LSE_RTOL of max(1, |lse|); dq, dk, dv (from the same
# o, lse and a seeded dO) within FLASH_F32_RTOL (f32) or FLASH_BF16_STEPS
# bf16 steps (bf16) of each gradient's largest magnitude: the sums run in
# another order, and in bf16 ds and p are rounded where the reference
# rounds them, so one of them can land a step apart
FLASH_PATH = [
    ("long context, bf16", 1, LM_HEADS, LM_HEADS, LONG_T, LONG_T, 64, True,
     None, "bfloat16"),
    ("train_main, f32", 8, LM_HEADS, LM_HEADS, 4096, 4096, 64, True, None,
     "float32"),
]
FLASH_RAGGED = [
    ("T 520", 2, 8, 8, 520, 520, 64, True, None),
    ("T 1000, GQA 8/2", 1, 8, 2, 1000, 1000, 64, True, None),
    ("MQA 8/1, T 200", 2, 8, 1, 200, 200, 64, True, None),
    ("Tq < Tk (70 x 200), d 32", 1, 4, 4, 70, 200, 32, True, None),
    ("Tq > Tk (130 x 40), non-causal, d 16", 2, 4, 2, 130, 40, 16, False,
     None),
    ("padded, a row with every key padded, GQA 8/2", 3, 8, 2, 192, 192, 64,
     True, [192, 0, 77]),
    ("padded, non-causal, d 128", 2, 4, 4, 130, 130, 128, False, [130, 1]),
    ("d 48 (padded to 64), GQA 8/2", 2, 8, 2, 100, 100, 48, True, None),
    ("d 80 (padded to 128), padded keys", 2, 4, 4, 72, 72, 80, True,
     [72, 30]),
    ("d 96 (padded to 128), Tq < Tk, non-causal", 1, 4, 2, 33, 50, 96,
     False, None),
    # the edges of the bf16 kernels' 64-row (K10) and 64-key (K11) tiles,
    # and the wgmma widths N 16 and 128 on the causal path
    ("T 63", 1, 8, 8, 63, 63, 64, True, None),
    ("T 64", 1, 8, 8, 64, 64, 64, True, None),
    ("T 65", 1, 8, 8, 65, 65, 64, True, None),
    ("T 129, GQA 8/2", 1, 8, 2, 129, 129, 64, True, None),
    ("MQA 8/1, T 8191", 1, 8, 1, 8191, 8191, 64, True, None),
    ("d 16, T 300", 1, 4, 4, 300, 300, 16, True, None),
    ("d 128, T 300, GQA 4/2", 1, 4, 2, 300, 300, 128, True, None),
    # head dims 129-256: the bf16 ring of two stages, K11's column halves,
    # the f32 tiles of 32 rows (K10) and 32 keys (K11)
    ("d 160 (padded to 256), GQA 8/2", 1, 8, 2, 200, 200, 160, True, None),
    ("d 256, T 300", 1, 4, 4, 300, 300, 256, True, None),
    ("d 256, padded, non-causal, a row with every key padded", 2, 4, 2, 130,
     130, 256, False, [130, 0]),
]
FLASH_LSE_RTOL = 1e-5
# the delta pass within FLASH_DELTA_RTOL of each row's sum |dO·O| (f32 sums
# in another order)
FLASH_DELTA_RTOL = 1e-5
FLASH_F32_RTOL = 1e-4
FLASH_BF16_STEPS = 2
# one autograd round trip through fused_attention (K9 + K10 + K11) against
# autograd of _chunked_attention_reference on the card, f32: (b, h, hk, t,
# d, padded lengths or None); T 2112 at d 64 is past the 512 KB K/V budget
FLASH_AUTOGRAD = [(1, 8, 2, 2112, 64, None), (2, 4, 4, 520, 64, [520, 300])]
# phase 3h: bigdl_tpu/models/perf.py longcontext_perf_main's defaults (T
# 8192, 8 layers, embed 512, 8 heads, vocab 8192, remat, bf16, SGD 0.1, 5
# timed steps after one warm-up); card vs CPU on one f32 step of the same
# model cut to 2 layers: the loss within LONG_LOSS_ATOL, every gradient
# within LONG_GRAD_RTOL of its largest magnitude (f32 sums in another order
# over 8192 positions)
LONG_ITERS, LONG_CPU_LAYERS = 5, 2
LONG_LOSS_ATOL, LONG_GRAD_RTOL = 1e-4, 1e-4
# phase 3i: bigdl_tpu/models/transformer.py train_main at the long-context
# widths, f32, on a corpus written here: TM_LINES lines of about TM_WORDS
# Zipf-drawn words over TM_TYPES types (32 train, 8 validation sentences)
TM_LINES, TM_WORDS, TM_TYPES, TM_BATCH, TM_STEPS = 40, 4200, 12000, 8, 4
TM_FLAGS = ["--vocab", "8000", "--embed", "512", "--heads", "8", "--layers",
            "8", "--maxLen", "4096", "-b", str(TM_BATCH), "-e", "1"]
# phase 2g: the fp16 codec K5-K7 against its plain versions, bit-equal
# wherever the plain result is not a NaN and a NaN where it is: the flat
# f32 parameter vector of 3e's LM (vocab 32000, embed 512, 8 x 8, T 2048),
# ragged lengths, an odd element offset, a strided view, and a table of
# special values (float32 bits for K5; wire values for K6 and, every pair,
# for K7, with K7's subnormal flush cases as (a, b, sum))
CODEC_N = 42_652_672
CODEC_RAGGED = [1, 7, 8191, (1 << 20) + 3]
CODEC_F32 = [0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF,
             0x807FFFFF, 0x00010000, 0x80010000, 0x00800000, 0x80800000,
             0x7F7FFFFF, 0xFF7FFFFF, 0x7F800000, 0xFF800000, 0x7F800001,
             0xFF800001, 0x7FA00000, 0x7FC00000, 0xFFC00000, 0x7FFFFFFF,
             0x3F800000, 0x3F80FFFF, 0x3F818000, 0xBF80FFFF, 0x4B000001]
CODEC_U16 = [0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x807F, 0x0080, 0x8080,
             0x0081, 0x8081, 0x0100, 0x8100, 0x7F7F, 0xFF7F, 0x7F80, 0xFF80,
             0x7F81, 0xFFBF, 0x7FC0, 0xFFC0, 0x7FFF, 0x3F80, 0xBF80, 0x3F81]
CODEC_ADD_CASES = [(0x0001, 0x0001, 0x0000), (0x8001, 0x8001, 0x8000),
                   (0x807F, 0x0000, 0x0000), (0x0081, 0x8080, 0x0000),
                   (0x8081, 0x0080, 0x8000), (0x0001, 0x3F80, 0x3F80),
                   (0x0100, 0x8080, 0x0080)]
# phase 3k: the flat f32 gradient of 3h's model; its round trip through the
# wire loses less than 2^-7 of each value (FP16ParameterSpec's bound)
LONG_PARAMS = 33_608_704
CODEC_RT_RTOL = 2.0 ** -7
# phase 3j: snapshots and resume at 3i's widths; the resumed run's losses
# within RESUME_RTOL of the uninterrupted run's (on the card the library's
# backward ops may sum in another order from run to run)
RESUME_RTOL = 1e-5
GEN_WORDS, GEN_PROMPT_WORDS = 16, 64
TRAIN_SAMPLES, VAL_SAMPLES = 64, 32
TRAIN_STEPS, VAL_EVERY, TIMED_STEPS = 30, 10, 20
CPU_BATCH, CPU_STEPS = 4, 2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def launches_now():
    from bigdl_tpu_torch import ops
    return {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}


def per_forward(counts, forwards):
    """Every wrapper's expected launches: ``counts`` per forward, 0 else."""
    from bigdl_tpu_torch import ops
    return {fn.__name__: counts.get(fn.__name__, 0) * forwards
            for fn in ops.KERNEL_WRAPPERS}


# -- timing -------------------------------------------------------------------

def median_ms(fn, device, reps=TIMING_REPS, flush=None):
    """Median wall time of ``fn()`` in ms: CUDA events on the card (with
    the L2 flushed between calls when ``flush`` is given), the host clock
    on the CPU."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# -- phase 2: kernels against their plain versions ----------------------------

def _pool_input(shape, dtype, device, gen, ties):
    import torch
    if ties:
        x = torch.randint(-3, 4, shape, generator=gen, device=device)
        return x.to(dtype)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def check_kernels(device):
    """Hold each kernel against its plain version; returns, per kernel, the
    largest float32 error, the count of cases and the count of mismatches
    (outputs out of tolerance, or argmax codes that differ)."""
    import torch
    from bigdl_tpu_torch.ops import (cross_map_lrn, lrn_plain, max_pool2d,
                                     max_pool2d_plain)
    gen = torch.Generator(device=device).manual_seed(SEED)
    errs = {"max_pool2d_fwd": 0.0, "lrn_fwd": 0.0}
    cases = {"max_pool2d_fwd": 0, "lrn_fwd": 0}
    misses = {"max_pool2d_fwd": 0, "lrn_fwd": 0}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, kh, kw, sh, sw, ph, pw, ceil in POOLS + RAGGED_POOLS:
            for ties in (False, True):
                x = _pool_input(shape, dtype, device, gen, ties)
                geom = (kh, kw, sh, sw, ph, pw, ceil)
                yk, ik = max_pool2d(x, *geom, return_indices=True)
                yk_noidx = max_pool2d(x, *geom)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                yp, ip = max_pool2d_plain(x, *geom)
                err = max((yk.float() - yp.float()).abs().max().item(),
                          (yk_noidx.float() - yp.float()).abs().max().item())
                bad = (ik != ip).sum().item()
                if dtype == torch.float32:
                    errs["max_pool2d_fwd"] = max(errs["max_pool2d_fwd"], err)
                cases["max_pool2d_fwd"] += 1
                if err != 0.0 or bad:
                    misses["max_pool2d_fwd"] += 1
                    fail(f"max_pool2d {name} {tuple(shape)} {dtype} "
                         f"ties={ties}: not bit-equal to the plain version "
                         f"(max |dy| {err}, {bad} idx differ)")
        for name, shape, size, alpha, beta, k in LRNS + RAGGED_LRNS:
            x = torch.randn(shape, generator=gen, device=device).to(dtype)
            yk, sk = cross_map_lrn(x, size, alpha, beta, k,
                                   return_scale=True)
            yk_noscale = cross_map_lrn(x, size, alpha, beta, k)
            if device.type == "cuda":
                torch.cuda.synchronize()
            yp, sp = lrn_plain(x, size, alpha, beta, k)
            rtol, atol = LRN_TOL[str(dtype).split(".")[-1]]
            for got, want, what in ((yk, yp, "y"), (sk, sp, "scale"),
                                    (yk_noscale, yp, "y (no scale)")):
                ok = torch.allclose(got.float(), want.float(), rtol=rtol,
                                    atol=atol)
                err = (got.float() - want.float()).abs().max().item()
                if not ok or not torch.isfinite(got).all():
                    misses["lrn_fwd"] += 1
                    fail(f"lrn {name} {tuple(shape)} {dtype} {what}: max "
                         f"|err| {err} beyond rtol {rtol} / atol {atol}")
                if dtype == torch.float32:
                    errs["lrn_fwd"] = max(errs["lrn_fwd"], err)
            cases["lrn_fwd"] += 1
    log(f"kernels vs plain: max_pool2d_fwd bit-equal in "
        f"{cases['max_pool2d_fwd']} cases; lrn_fwd within tolerance in "
        f"{cases['lrn_fwd']} cases (f32 max |err| {errs['lrn_fwd']:.3g})")
    return errs, cases, misses


# -- phase 2b: backward kernels against their plain versions ------------------

def check_backward_kernels(device):
    """Hold K3 (on codes K1 wrote) and K4 (on the scale K2 wrote) against
    their plain versions, then one autograd round trip per layer on the
    card against the CPU; returns errors, cases and mismatches per kernel
    as :func:`check_kernels` does."""
    import torch
    import bigdl_tpu_torch.nn as tnn
    from bigdl_tpu_torch.ops import (cross_map_lrn, lrn_bwd, lrn_bwd_plain,
                                     max_pool2d, max_pool2d_bwd,
                                     max_pool2d_bwd_plain)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    errs = {"max_pool2d_bwd": 0.0, "lrn_bwd": 0.0}
    cases = {"max_pool2d_bwd": 0, "lrn_bwd": 0}
    misses = {"max_pool2d_bwd": 0, "lrn_bwd": 0}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, kh, kw, sh, sw, ph, pw, ceil in POOLS + RAGGED_POOLS:
            for ties in (False, True):
                x = _pool_input(shape, dtype, device, gen, ties)
                geom = (kh, kw, sh, sw, ph, pw, ceil)
                _, idx = max_pool2d(x, *geom, return_indices=True)
                dy = torch.randn(tuple(idx.shape), generator=gen,
                                 device=device).to(dtype)
                dx = max_pool2d_bwd(dy, idx, geom, shape[2], shape[3])
                if device.type == "cuda":
                    torch.cuda.synchronize()
                want = max_pool2d_bwd_plain(dy, idx, geom, shape[2],
                                            shape[3])
                err = (dx.float() - want.float()).abs().max().item()
                cases["max_pool2d_bwd"] += 1
                if dtype == torch.float32:
                    errs["max_pool2d_bwd"] = max(errs["max_pool2d_bwd"], err)
                if dx.dtype != dtype or not torch.equal(dx, want):
                    misses["max_pool2d_bwd"] += 1
                    fail(f"max_pool2d_bwd {name} {tuple(shape)} {dtype} "
                         f"ties={ties}: not bit-equal to the plain version "
                         f"(max |ddx| {err})")
        for name, shape, size, alpha, beta, k in LRNS + RAGGED_LRNS:
            x = torch.randn(shape, generator=gen, device=device).to(dtype)
            dy = torch.randn(shape, generator=gen, device=device).to(dtype)
            _, scale = cross_map_lrn(x, size, alpha, beta, k,
                                     return_scale=True)
            dx = lrn_bwd(x, scale, dy, size, alpha, beta)
            if device.type == "cuda":
                torch.cuda.synchronize()
            want = lrn_bwd_plain(x, scale, dy, size, alpha, beta)
            rtol, atol = LRN_BWD_TOL[str(dtype).split(".")[-1]]
            err = (dx.float() - want.float()).abs().max().item()
            cases["lrn_bwd"] += 1
            if dtype == torch.float32:
                errs["lrn_bwd"] = max(errs["lrn_bwd"], err)
            if not torch.allclose(dx.float(), want.float(), rtol=rtol,
                                  atol=atol) or not torch.isfinite(dx).all():
                misses["lrn_bwd"] += 1
                fail(f"lrn_bwd {name} {tuple(shape)} {dtype}: max |err| "
                     f"{err} beyond rtol {rtol} / atol {atol}")
    # one autograd round trip per layer: y.backward(g) on the card against
    # the same on CPU tensors (plain versions), float32
    for layer, shape in ((tnn.SpatialMaxPooling(3, 3, 2, 2).ceil(),
                          (2, 64, 112, 112)),
                         (tnn.SpatialCrossMapLRN(5, 1e-4, 0.75),
                          (2, 64, 56, 56))):
        x = torch.randn(shape, generator=gen, device=device)
        grads = []
        for dev in (device, torch.device("cpu")):
            xd = x.detach().to(dev).requires_grad_()
            y = layer.training_()(xd)
            g = torch.arange(y.numel(), dtype=torch.float32, device=dev)
            y.backward((g.reshape(y.shape) % 7 - 3.0) / 3.0)
            grads.append(xd.grad.cpu())
        err = (grads[0] - grads[1]).abs().max().item()
        pool = isinstance(layer, tnn.SpatialMaxPooling)
        ok = torch.equal(*grads) if pool else torch.allclose(
            *grads, rtol=LRN_BWD_TOL["float32"][0],
            atol=LRN_BWD_TOL["float32"][1])
        what = "max_pool2d_bwd" if pool else "lrn_bwd"
        cases[what] += 1
        errs[what] = max(errs[what], err)
        if not ok:
            misses[what] += 1
            fail(f"{type(layer).__name__} backward on the card vs the CPU: "
                 f"max |err| {err}")
    log(f"backward kernels vs plain: max_pool2d_bwd bit-equal in "
        f"{cases['max_pool2d_bwd']} cases; lrn_bwd within tolerance in "
        f"{cases['lrn_bwd']} cases (f32 max |err| {errs['lrn_bwd']:.3g}); "
        "autograd round trip card vs CPU held for both layers")
    return errs, cases, misses


# -- phase 2c: the quantized matmuls against their plain versions -------------

def quant_products(qmodel, device, bucket, dtype):
    """Every packed product of ``qmodel``'s forward at batch ``bucket``, in
    forward order: ``(layer name, kind, M, K, N, conv geometry)``, kind
    ``"conv"`` for a fused conv (unfold + K13), ``"linear"`` for a packed
    Linear; widened convs run cuDNN and are left out.  Found with forward
    pre-hooks over one batch-1 forward in ``dtype``."""
    import torch
    import bigdl_tpu_torch.nn as tnn
    from bigdl_tpu_torch.ops import quant
    seen = []

    def hook(m, args):
        seen.append((m, tuple(args[0].shape)))

    handles = [m.register_forward_pre_hook(hook) for m in qmodel.modules()
               if quant.packed_weight(m) is not None]
    x = torch.zeros((1, 3, IMAGE, IMAGE), device=device, dtype=dtype)
    with torch.inference_mode():
        qmodel(x)
    for h in handles:
        h.remove()
    out = []
    for m, shape in seen:
        qt = quant.packed_weight(m)
        if isinstance(m, tnn.Linear):
            out.append((m.name, "linear", bucket, m.input_size,
                        m.output_size, None))
        elif m._fused_int8_eligible(qt):
            _, c, h, w = shape
            oh = h + 2 * m.pad_h - m.kernel_h + 1
            ow = w + 2 * m.pad_w - m.kernel_w + 1
            out.append((m.name, "conv", bucket * oh * ow,
                        c * m.kernel_h * m.kernel_w, m.n_output_plane,
                        (c, h, w, m.kernel_h, m.kernel_w, m.pad_h, m.pad_w)))
    return out


def quant_close(got, want, x, wide):
    """(max |err|, within tolerance) of a K13/K15 result against its plain
    version: QSUM_RTOL of each output's sum of |products| (f32 sums in
    another order), plus one bf16 rounding step of the output in bf16."""
    import torch
    err = (got.float() - want.float()).abs()
    bound = QSUM_RTOL * (x.float().abs() @ wide.float().abs().t())
    if got.dtype == torch.bfloat16:
        bound = bound + BF16_STEP * want.float().abs()
    return err.max().item() if err.numel() else 0.0, bool(
        (err <= bound).all()) and bool(torch.isfinite(got).all())


def check_quant_kernels(device, path_shapes):
    """Hold K13 (int8 and e4m3 weights), K14 and K15 against their plain
    versions at ``path_shapes`` ({wrapper: [(M, K, N), ...]}, the path's
    products at buckets 8 and 32), at RAGGED_MATMULS and QUANT_EDGES, and
    with x at row 1 of a larger tensor (QUANT_OFFSET), in float32 and
    bfloat16; then K13 and K15 bit-equal over two bf16 launches at
    QUANT_BITEQ.  Returns per-kernel errors (float32 cases), cases and
    mismatches as :func:`check_kernels` does."""
    import torch
    from bigdl_tpu_torch.ops import quant
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    names = ("w8_matmul", "f8_matmul", "a8_matmul", "w4_matmul")
    errs = {k: 0.0 for k in names}
    errs_bf16 = {k: 0.0 for k in names}
    counts = {k: 0 for k in names}
    misses = {k: 0 for k in names}
    cases = [(mkn, False) for mkn in RAGGED_MATMULS + QUANT_EDGES] + \
        [(mkn, True) for mkn in QUANT_OFFSET]
    for name in names:
        for (m, k, n), offset in [(mkn, False) for mkn in
                                  sorted(set(path_shapes[name]))] + cases:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((m + offset, k), generator=gen,
                                device=device).to(dtype)[offset:]
                w = torch.randn((n, k), generator=gen, device=device)
                if name == "a8_matmul":
                    qt = quant.pack(w, sx=3.0 / 127)
                    xq = quant.quantize_act(x, qt["sx"])
                    s = qt["scale"] * qt["sx"]
                    got = quant.a8_matmul(xq, qt["q8"], s, dtype)
                    torch.cuda.synchronize()
                    want = quant.int8_a8_matmul_plain(xq, qt["q8"], s, dtype)
                    err = (got.float() - want.float()).abs().max().item()
                    ok = torch.equal(got, want)
                elif name == "w4_matmul":
                    qt = quant.pack(w, mode="w4")
                    got = quant.w4_matmul(x, qt["q4"], qt["scale"], k)
                    torch.cuda.synchronize()
                    want = quant.int4_matmul_plain(x, qt["q4"], qt["scale"],
                                                   k)
                    err, ok = quant_close(got, want, x, quant.unpack(qt))
                else:
                    mode = "w8" if name == "w8_matmul" else "f8"
                    qt = quant.pack(w, mode=mode)
                    q = qt["q8" if mode == "w8" else "f8"]
                    fn = getattr(quant, name)
                    got = fn(x, q, qt["scale"])
                    torch.cuda.synchronize()
                    want = quant.int8_matmul_plain(x, q, qt["scale"])
                    err, ok = quant_close(got, want, x, quant.unpack(qt))
                into = errs if dtype == torch.float32 else errs_bf16
                into[name] = max(into[name], err)
                if not ok or got.shape != (m, n) or got.dtype != dtype:
                    misses[name] += 1
                    fail(f"{name} {(m, k, n)} {dtype}"
                         f"{' at row 1' if offset else ''}: max |err| {err} "
                         "beyond tolerance (K14: not bit-equal)")
                counts[name] += 1
    for m, k, n in QUANT_BITEQ:
        x = torch.randn((m, k), generator=gen,
                        device=device).to(torch.bfloat16)
        w = torch.randn((n, k), generator=gen, device=device)
        for mode, fn in (("w8", quant.w8_matmul), ("f8", quant.f8_matmul),
                         ("w4", quant.w4_matmul)):
            qt = quant.pack(w, mode=mode)
            args = (x, qt[{"w8": "q8", "f8": "f8", "w4": "q4"}[mode]],
                    qt["scale"]) + ((k,) if mode == "w4" else ())
            a, b = fn(*args), fn(*args)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"{fn.__name__} {(m, k, n)} bf16: two launches differ")
    log("quantized kernels vs plain: " + "; ".join(
        f"{k} {counts[k]} cases, max |err| f32 {errs[k]:.3g} bf16 "
        f"{errs_bf16[k]:.3g}" for k in names) + " (a8_matmul bit-equal); "
        f"w8/f8/w4_matmul bit-equal over two bf16 launches at {QUANT_BITEQ}")
    return errs, counts, misses


def log_quant_plans(path_shapes):
    """One line: the bf16 kernel's plan at every product of the path, and
    whether x comes by TMA there (every Inception shape should)."""
    import torch
    from bigdl_tpu_torch.ops import quant
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = []
    for name, nib in (("w8_matmul", False), ("w4_matmul", True)):
        for m, k, n in sorted(set(path_shapes[name])):
            p = quant.bf16_plan(m, k, n, nib, sms)
            blocks = -(-m // p.bm) * p.n_tiles * p.splits
            tma = k % 8 == 0 and (not nib or (k + 1) // 2 % 8 == 0)
            plans.append(f"{'K15' if nib else 'K13'} {m}x{k}x{n}: bm {p.bm} "
                         f"bn {p.bn}x{p.n_tiles} splits {p.splits}x{p.per}/"
                         f"{p.steps} = {blocks} blocks, x by "
                         f"{'TMA' if tma else 'loads'}")
    log("bf16 plans: " + "; ".join(plans))


# -- phase 2d: the attention kernels against their plain versions -------------

def attention_operands(case, dtype, device, gen):
    """q, k, v and the (B, Tk) key-padding bias (or None) of a case."""
    import torch
    from bigdl_tpu_torch.ops.attention import NEG_INF
    _, b, h, hk, t, tk, d, _, lengths = case
    q = torch.randn((b, h, t, d), generator=gen, device=device).to(dtype)
    k = torch.randn((b, hk, tk, d), generator=gen, device=device).to(dtype)
    v = torch.randn((b, hk, tk, d), generator=gen, device=device).to(dtype)
    bias = None
    if lengths is not None:
        keep = torch.arange(tk, device=device)[None, :] < \
            torch.tensor(lengths, device=device)[:, None]
        bias = torch.where(keep, 0.0, NEG_INF).float()
    return q, k, v, bias


def check_attention_kernels(device):
    """Hold K8 and K9 against their plain versions at the LM paths' shapes
    (ATTN_PATH) and at ATTN_RAGGED, in float32 and bfloat16: K8 on every
    case without padding, K9 on every case.  Returns per-kernel errors
    (float32 cases), cases and mismatches as :func:`check_kernels`
    does."""
    import torch
    from bigdl_tpu_torch.ops import attention as attn
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    names = ("attention_fwd", "attention_stream_fwd")
    errs = {k: 0.0 for k in names}
    rels = {k: 0.0 for k in names}
    rels_bf16 = {k: 0.0 for k in names}
    cases = {k: 0 for k in names}
    misses = {k: 0 for k in names}
    for case in ATTN_PATH + ATTN_RAGGED:
        causal = case[7]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = attention_operands(case, dtype, device, gen)
            runs = [("attention_stream_fwd",
                     lambda: attn.attention_stream_fwd(q, k, v, causal, None,
                                                       bias),
                     lambda x, y, z: attn.attention_stream_plain(
                         x, y, z, causal, None, bias))]
            if bias is None:
                runs.insert(0, ("attention_fwd",
                                lambda: attn.attention_fwd(q, k, v, causal),
                                lambda x, y, z: attn.attention_reference(
                                    x, y, z, causal)))
            for name, kern, plain in runs:
                got = kern()
                torch.cuda.synchronize()
                want = plain(q, k, v)
                mag = plain(q.float(), k.float(), v.float().abs())
                err = (got.float() - want.float()).abs()
                rel = (err / mag.clamp_min(1e-30)).max().item()
                tol = (ATTN_F32_RTOL if dtype == torch.float32 else
                       ATTN_BF16_STEPS * BF16_STEP) * mag
                ok = bool((err <= tol).all()) and \
                    bool(torch.isfinite(got).all()) and \
                    got.shape == q.shape and got.dtype == dtype
                if case[8] is not None and 0 in case[8]:
                    ok = ok and not got[case[8].index(0)].float().abs().any()
                cases[name] += 1
                into = rels if dtype == torch.float32 else rels_bf16
                into[name] = max(into[name], rel)
                if dtype == torch.float32:
                    errs[name] = max(errs[name], err.max().item())
                if not ok:
                    misses[name] += 1
                    fail(f"{name} {case[0]} {dtype}: max |err| / sum |p·v| "
                         f"{rel:.3g} beyond tolerance")
                del got, want, mag
    log("attention kernels vs plain: " + "; ".join(
        f"{k} {cases[k]} cases, max |err| / sum |p·v| f32 {rels[k]:.3g} "
        f"(limit {ATTN_F32_RTOL}; max |err| {errs[k]:.3g}) bf16 "
        f"{rels_bf16[k]:.3g} (limit "
        f"{ATTN_BF16_STEPS * BF16_STEP:.4g})" for k in names))
    return errs, cases, misses


# -- phase 2e: the paged-attention kernel against its plain version ----------

def cg_traffic(seed=SEED + 70):
    """bench_serve.py's ``_traffic`` at this width: CG_REQUESTS prompts of
    CG_PROMPT tokens, a CG_HEAD_FRAC share opening with one shared
    CG_HEAD-token head, budgets from CG_SHORT or, at CG_LONG_FRAC, CG_LONG
    (seeded).  Returns the prompts, the budgets and which prompts share
    the head."""
    rng = np.random.RandomState(seed)
    head = rng.randint(1, LM_VOCAB + 1, size=CG_HEAD)
    prompts, shared = [], []
    for _ in range(CG_REQUESTS):
        p = rng.randint(1, LM_VOCAB + 1, size=CG_PROMPT)
        shared.append(bool(rng.rand() < CG_HEAD_FRAC))
        if shared[-1]:
            p[:CG_HEAD] = head
        prompts.append(p)
    budgets = [int(rng.randint(CG_LONG[0], CG_LONG[1] + 1))
               if rng.rand() < CG_LONG_FRAC
               else int(rng.randint(CG_SHORT[0], CG_SHORT[1] + 1))
               for _ in range(CG_REQUESTS)]
    return prompts, budgets, shared


def paged_decode_case():
    """The path's decode shape: 8 slots, 8 heads, S 1, d 64, page size 16,
    Lp 128, each row halfway through the budget of one of the traffic's
    first 8 requests."""
    _, budgets, _ = cg_traffic()
    return ("decode, the path's shape", CG_SLOTS, LM_HEADS, LM_HEADS, 1, 64,
            CG_PAGE, LM_T // CG_PAGE,
            [CG_PROMPT + n // 2 for n in budgets[:CG_SLOTS]], False)


def paged_operands(case, dtype, cache_dtype, device, seed):
    """q, pools (NaN on the trash page), page table, positions and scale
    of a K12 case: each row's pages drawn from a shuffled pool, its S
    queries at the last S of its tokens."""
    import torch
    _, b, h, hkv, s, d, ps, lp, lengths, large = case
    g = torch.Generator().manual_seed(seed)
    p = sum(-(-n // ps) for n in lengths) + 3
    if large:
        q = torch.randint(-3, 4, (b, h, s, d), generator=g).float()
        k = torch.randint(-3, 4, (p + 1, hkv, ps, d), generator=g).float()
    else:
        q = torch.randn((b, h, s, d), generator=g)
        k = torch.randn((p + 1, hkv, ps, d), generator=g)
    v = torch.randn((p + 1, hkv, ps, d), generator=g)
    k[p], v[p] = float("nan"), float("nan")
    perm = torch.randperm(p, generator=g).int()
    pages = torch.full((b, lp), p, dtype=torch.int32)
    positions = torch.empty((b, s), dtype=torch.int32)
    used = 0
    for r, n in enumerate(lengths):
        if n == 0:
            positions[r] = torch.arange(s) + 5
            continue
        np_ = -(-n // ps)
        pages[r, :np_] = perm[used:used + np_]
        used += np_
        positions[r] = torch.arange(n - s, n)
    scale = 0.3 if large else d ** -0.5
    return (q.to(device, dtype), k.to(device, cache_dtype),
            v.to(device, cache_dtype), pages.to(device), positions.to(device),
            scale)


def check_paged_kernel(device):
    """Hold K12 against ``paged_attention_plain`` at the path's decode
    shape and at PAGED_RAGGED, in float32 and bfloat16, and with f32
    queries over a bf16 cache at the decode shape and the GQA case.
    Returns errors, cases and mismatches as :func:`check_kernels` does."""
    import torch
    from bigdl_tpu_torch.ops import attention as attn
    name = "paged_attention"
    err = rel = rel_bf16 = 0.0
    cases = misses = 0
    runs = [(c, dt, dt) for c in [paged_decode_case()] + PAGED_RAGGED
            for dt in (torch.float32, torch.bfloat16)]
    runs += [(c, torch.float32, torch.bfloat16)
             for c in (paged_decode_case(), PAGED_RAGGED[2])]
    for i, (case, qdt, cdt) in enumerate(runs):
        q, k, v, pages, pos, scale = paged_operands(case, qdt, cdt, device,
                                                    SEED + 80 + i)
        got = attn.paged_attention(q, k, v, pages, pos, scale)
        torch.cuda.synchronize()
        want = attn.paged_attention_plain(q, k, v, pages, pos, scale)
        mag = attn.paged_attention_plain(q.float(), k.float(),
                                         v.float().abs(), pages, pos, scale)
        e = (got.float() - want.float()).abs()
        r = (e / mag.clamp_min(1e-30)).max().item()
        tol = (ATTN_F32_RTOL if cdt == torch.float32 else
               ATTN_BF16_STEPS * BF16_STEP) * mag
        ok = bool((e <= tol).all()) and bool(torch.isfinite(got).all()) \
            and got.shape == q.shape and got.dtype == cdt
        if 0 in case[8]:
            ok = ok and not got[case[8].index(0)].float().abs().any()
        cases += 1
        if cdt == torch.float32:
            rel, err = max(rel, r), max(err, e.max().item())
        else:
            rel_bf16 = max(rel_bf16, r)
        if not ok:
            misses += 1
            fail(f"{name} {case[0]} q {qdt} cache {cdt}: max |err| / "
                 f"sum |p·v| {r:.3g} beyond tolerance")
        del q, k, v, got, want, mag
    log(f"paged attention kernel vs plain: {cases} cases, max |err| / sum "
        f"|p·v| f32 {rel:.3g} (limit {ATTN_F32_RTOL}; max |err| {err:.3g}) "
        f"bf16 cache {rel_bf16:.3g} (limit "
        f"{ATTN_BF16_STEPS * BF16_STEP:.4g})")
    return {name: err}, {name: cases}, {name: misses}


# -- phase 2f: the flash backward against its plain version --------------------

def flash_grads(case, dtype, device, seed):
    """q, k, v, the bias, the plain forward's o and lse, and a seeded dO of
    a phase-2f case."""
    import torch
    from bigdl_tpu_torch.ops import attention as attn
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, bias = attention_operands(case[:9], dtype, device, gen)
    o, lse = attn.attention_stream_plain(q, k, v, case[7], None, bias,
                                         with_lse=True)
    do = torch.randn(q.shape, generator=gen, device=device).to(dtype)
    return q, k, v, bias, o, lse, do


def check_flash_kernels(device):
    """Hold K9 with its LSE, the delta pass, K10 and K11 against their plain
    versions at FLASH_PATH (each in its dtype) and FLASH_RAGGED (f32 and
    bf16): o, lse, delta, and dq, dk, dv from the plain forward's o and lse
    and the delta pass's delta; rows and KV heads with every key padded
    must get zero gradients.  Then K10 and K11 twice each on the same
    inputs, bit-equal, and the autograd round trips of FLASH_AUTOGRAD.
    Returns per-kernel errors (f32 cases), cases and mismatches as
    :func:`check_kernels` does."""
    import torch
    from bigdl_tpu_torch.ops import attention as attn
    names = ("attention_stream_fwd", "flash_bwd_delta",
             "attention_stream_bwd_dq", "attention_stream_bwd_dkv")
    errs = {k: 0.0 for k in names}
    rels = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    cases = {k: 0 for k in names}
    misses = {k: 0 for k in names}
    runs = [(c, c[9]) for c in FLASH_PATH] + \
        [(c + (dt,), dt) for c in FLASH_RAGGED
         for dt in ("float32", "bfloat16")]
    for i, (case, dt) in enumerate(runs):
        dtype = getattr(torch, dt)
        causal, lengths = case[7], case[8]
        q, k, v, bias, o, lse, do = flash_grads(case, dtype, device,
                                                SEED + 200 + i)
        got_o, got_lse = attn._launch(
            attn.attention_stream_fwd, "bigdl_attention_stream_fwd", q, k,
            v, bias, causal, case[6] ** -0.5, with_lse=True)
        torch.cuda.synchronize()
        mag = attn.attention_stream_plain(q.float(), k.float(),
                                          v.float().abs(), causal, None, bias)
        err = (got_o.float() - o.float()).abs()
        rel_o = (err / mag.clamp_min(1e-30)).max().item()
        tol = (ATTN_F32_RTOL if dt == "float32" else
               ATTN_BF16_STEPS * BF16_STEP) * mag
        lse_err = ((got_lse - lse).abs() /
                   lse.abs().clamp_min(1.0)).max().item()
        ok = bool((err <= tol).all()) and lse_err <= FLASH_LSE_RTOL and \
            bool(torch.isfinite(got_o).all())
        checks = [("attention_stream_fwd", ok, max(rel_o, lse_err),
                   err.max().item())]
        delta = attn.flash_bwd_delta(o, do)
        torch.cuda.synchronize()
        derr = (delta - attn.flash_bwd_delta_plain(o, do)).abs()
        dmag = (do.float() * o.float()).abs().sum(dim=-1)
        checks.append(("flash_bwd_delta", bool(
            (derr <= FLASH_DELTA_RTOL * dmag).all()) and
            delta.dtype == torch.float32 and delta.shape == lse.shape,
            (derr / dmag.clamp_min(1e-30)).max().item(), derr.max().item()))
        dq = attn.attention_stream_bwd_dq(q, k, v, o, lse, do, causal, None,
                                          bias, delta=delta)
        dk, dv = attn.attention_stream_bwd_dkv(q, k, v, o, lse, do, causal,
                                               None, bias, delta=delta)
        torch.cuda.synchronize()
        want = attn.flash_bwd_plain(q, k, v, o, lse, do, causal, None, bias)
        for name, got, w in (("attention_stream_bwd_dq", [dq], want[:1]),
                             ("attention_stream_bwd_dkv", [dk, dv],
                              want[1:])):
            rel, aerr, ok = 0.0, 0.0, True
            for a, b in zip(got, w):
                top = b.float().abs().max().item()
                e = (a.float() - b.float()).abs().max().item()
                limit = (FLASH_F32_RTOL if dt == "float32" else
                         FLASH_BF16_STEPS * BF16_STEP) * top
                ok = ok and e <= limit and bool(torch.isfinite(a).all()) \
                    and a.shape == b.shape and a.dtype == b.dtype
                rel, aerr = max(rel, e / max(top, 1e-30)), max(aerr, e)
            if lengths is not None and 0 in lengths:
                row = lengths.index(0)
                ok = ok and not any(x[row].float().abs().any() for x in got)
            checks.append((name, ok, rel, aerr))
        for name, ok, rel, aerr in checks:
            cases[name] += 1
            rels[name][dt] = max(rels[name][dt], rel)
            if dt == "float32":
                errs[name] = max(errs[name], aerr)
            if not ok:
                misses[name] += 1
                fail(f"{name} {case[0]} {dt}: max |err| {aerr:.3g}, "
                     f"relative {rel:.3g} beyond tolerance")
        del q, k, v, o, lse, do, dq, dk, dv, want, mag, delta
    # K10 and K11 run no atomics: two launches on the same inputs are
    # bit-equal, at head dim 256 too (two ring stages, K11's column halves;
    # the f32 32-row and 32-key tiles)
    for case in (FLASH_PATH[0], FLASH_RAGGED[5] + ("bfloat16",),
                 FLASH_RAGGED[18] + ("bfloat16",),
                 FLASH_RAGGED[19] + ("float32",)):
        q, k, v, bias, o, lse, do = flash_grads(
            case, getattr(torch, case[9]), device, SEED + 300)
        args = (q, k, v, o, lse, do, case[7], None, bias)
        for name, fn in (("attention_stream_bwd_dq",
                          lambda: (attn.attention_stream_bwd_dq(*args),)),
                         ("attention_stream_bwd_dkv",
                          lambda: attn.attention_stream_bwd_dkv(*args))):
            a, b = fn(), fn()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                fail(f"{name} {case[0]}: two launches differ")
            del a, b
        del q, k, v, o, lse, do
    # autograd through the dispatcher against autograd of the chunked form
    gen = torch.Generator(device=device).manual_seed(SEED + 310)
    for b, h, hk, t, d, lengths in FLASH_AUTOGRAD:
        q, k, v, bias = attention_operands(
            ("autograd", b, h, hk, t, t, d, True, lengths), torch.float32,
            device, gen)
        do = torch.randn(q.shape, generator=gen, device=device)
        kpm = None if bias is None else bias > -1.0
        ours = [x.clone().requires_grad_() for x in (q, k, v)]
        before = launches_now()
        attn.fused_attention(*ours, causal=True,
                             key_padding_mask=kpm).backward(do)
        after = launches_now()
        ref = [x.clone().requires_grad_() for x in (q, k, v)]
        attn._chunked_attention_reference(*ref, True, d ** -0.5,
                                          bias=bias).backward(do)
        torch.cuda.synchronize()
        ran = {n: after[n] - before[n] for n in names}
        if ran != {n: 1 for n in names}:
            fail(f"fused_attention autograd at T {t}: launches {ran}, want "
                 "one K9, one delta pass, one K10 and one K11")
        for x, r in zip(ours, ref):
            top = r.grad.abs().max().item()
            e = (x.grad - r.grad).abs().max().item()
            if not e <= FLASH_F32_RTOL * top:
                fail(f"fused_attention autograd at T {t}: max |err| {e:.3g} "
                     f"beyond {FLASH_F32_RTOL} of {top:.3g}")
        del q, k, v, do, ours, ref
    log("flash backward vs plain: " + "; ".join(
        f"{k} {cases[k]} cases, max |err| relative f32 "
        f"{rels[k]['float32']:.3g} bf16 {rels[k]['bfloat16']:.3g}"
        for k in names) + f" (limits: o {ATTN_F32_RTOL} / "
        f"{ATTN_BF16_STEPS * BF16_STEP:.4g} of sum |p·v|, lse "
        f"{FLASH_LSE_RTOL}, delta {FLASH_DELTA_RTOL} of sum |dO·O|, "
        f"gradients {FLASH_F32_RTOL} / {FLASH_BF16_STEPS * BF16_STEP:.4g} of "
        "their largest magnitude); K10 and K11 bit-equal over two launches; "
        f"{len(FLASH_AUTOGRAD)} autograd round trips held")
    return ({f"{k}_lse" if k == "attention_stream_fwd" else k: v
             for k, v in errs.items()},
            {f"{k}_lse" if k == "attention_stream_fwd" else k: v
             for k, v in cases.items()},
            {f"{k}_lse" if k == "attention_stream_fwd" else k: v
             for k, v in misses.items()})


# -- phase 3: serving ---------------------------------------------------------

def build_model():
    from bigdl_tpu_torch.models import Inception_v1
    return Inception_v1(CLASSES).reset(SEED)


def make_rows(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((3, IMAGE, IMAGE)).astype(np.float32)
            for _ in range(n)]


def serve(device):
    """Drive the serving path; returns (report, launches, model, rows)."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.api import DLClassifier
    from bigdl_tpu_torch.serving import InferenceServer

    model = build_model()
    cpu_model = copy.deepcopy(model)
    clf = DLClassifier(model, (BATCH, 3, IMAGE, IMAGE), device=device)
    t0 = time.monotonic()
    server = InferenceServer(clf, batch_buckets=BUCKETS, device=device)
    warm_s = time.monotonic() - t0
    rows = make_rows(N_ROWS, SEED)
    wave_rows = {b: make_rows(b * WAVES[b], SEED + b) for b in BUCKETS}

    def timed_wave(batch_rows):
        done = {}
        t_sub = {}
        futs = []
        for i, r in enumerate(batch_rows):
            t_sub[i] = time.monotonic()
            f = server.submit(r)
            f.add_done_callback(
                lambda _f, i=i: done.__setitem__(i, time.monotonic()))
            futs.append(f)
        preds = [f.result(timeout=600) for f in futs]
        while len(done) < len(futs):     # callbacks run after result()
            time.sleep(0.001)
        return preds, [done[i] - t_sub[i] for i in range(len(futs))]

    try:
        ops.reset_launches()             # the main path starts here
        served, _ = timed_wave(rows)
        per_bucket = {}
        for b in BUCKETS:
            lats, preds_b = [], []
            t_b = time.monotonic()
            for w in range(WAVES[b]):
                p, lat = timed_wave(wave_rows[b][w * b:(w + 1) * b])
                preds_b += p
                lats += lat
            wall = time.monotonic() - t_b
            lats.sort()
            # a closed-loop smoke, not a throughput or tail measurement:
            # each wave is awaited before the next is sent, and with a few
            # dozen samples only the median and the maximum are reported
            per_bucket[b] = {"images": len(lats), "waves": WAVES[b],
                             "images_per_s": len(lats) / wall,
                             "p50_ms": 1e3 * lats[len(lats) // 2],
                             "max_ms": 1e3 * lats[-1],
                             "preds": preds_b}
        launches = launches_now()
        stats = server.stats()           # the main path ends here
    finally:
        if not server.drain(timeout=120):
            fail("server did not drain")

    forwards = sum(v["batches"] for v in stats["buckets"].values())
    total = N_ROWS + sum(b * WAVES[b] for b in BUCKETS)
    if stats["counters"].get("serve.completed") != total:
        fail(f"{stats['counters']} — expected {total} completed requests")
    if launches != per_forward({"max_pool2d": 13, "cross_map_lrn": 2},
                               forwards):
        fail(f"launches {launches} for {forwards} forwards: expected 13 "
             "max-pool and 2 LRN launches per forward and nothing else")

    # predictions equal DLClassifier.predict on the same rows
    all_rows = rows + [r for b in BUCKETS for r in wave_rows[b]]
    all_served = served + [p for b in BUCKETS for p in per_bucket[b]["preds"]]
    offline = clf.predict(all_rows)
    if list(offline) != list(all_served):
        bad = sum(int(a != b) for a, b in zip(offline, all_served))
        fail(f"{bad} of {len(all_rows)} served predictions differ from "
             "DLClassifier.predict")

    # the same weights on the CPU (plain ops), TF32 off on the card
    x8 = torch.from_numpy(np.stack(rows[:CPU_ROWS]))
    with torch.inference_mode():
        lp_dev = model(x8.to(device)).float().cpu()
        lp_cpu = cpu_model.evaluate()(x8)
    if lp_dev.shape != (CPU_ROWS, CLASSES) or \
            not torch.isfinite(lp_dev).all():
        fail(f"device log-probs have shape {tuple(lp_dev.shape)} or are "
             "not finite")
    diff = (lp_dev - lp_cpu).abs().max().item()
    if diff > 1e-3 or not torch.equal(lp_dev.argmax(1), lp_cpu.argmax(1)):
        fail(f"device vs CPU log-probs: max |diff| {diff} (atol 1e-3), "
             f"argmax {lp_dev.argmax(1).tolist()} vs "
             f"{lp_cpu.argmax(1).tolist()}")
    if (lp_cpu.argmax(1) + 1).tolist() != list(served[:CPU_ROWS]):
        fail("served predictions disagree with the CPU run")
    log(f"serving: {total} requests answered in {forwards} forwards, equal "
        f"to DLClassifier.predict; {CPU_ROWS} rows match the CPU run "
        f"(max |dlogp| {diff:.3g}); launches {launches}")
    for b in BUCKETS:
        per_bucket[b].pop("preds")
    report = {"warmup_s": warm_s, "forwards": forwards, "requests": total,
              "classifier": clf,
              "cpu_max_abs_logp_diff": diff, "per_bucket": per_bucket,
              "forward_by_bucket": stats["buckets"],
              "latency_p50_ms": 1e3 * stats["latency_p50_s"]}
    return report, launches


# -- phase 3b/3c: training ----------------------------------------------------

def make_samples(n, seed):
    from bigdl_tpu_torch.dataset import Sample
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, 3, IMAGE, IMAGE)).astype(np.float32)
    y = rng.randint(1, CLASSES + 1, size=n).astype(np.float32)
    return [Sample(x[i], y[i]) for i in range(n)]


def make_trainer(model, samples, batch, steps, mixed, device, val=None):
    """``train_main``'s trainer (``bigdl_tpu/models/inception.py``): SGD
    with weight decay 2e-4, momentum 0.9, no dampening and Poly(0.5) over
    the run's horizon."""
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Poly,
                                       Top1Accuracy, Top5Accuracy, Trigger)
    opt = LocalOptimizer(model, ClassNLLCriterion(),
                         DataSet.array(samples) >> SampleToBatch(batch),
                         Trigger.max_iteration(steps), device=device)
    opt.set_optim_method(SGD(learning_rate=0.01, weight_decay=2e-4,
                             momentum=0.9, dampening=0.0,
                             learning_rate_schedule=Poly(0.5, steps)))
    opt.set_mixed_precision(mixed).set_seed(SEED)
    if val is not None:
        opt.set_validation(Trigger.several_iteration(VAL_EVERY),
                           DataSet.array(val) >> SampleToBatch(batch),
                           [Top1Accuracy(), Top5Accuracy()])
    return opt


def step_ms(opt):
    """Median host time of the last TIMED_STEPS steps (batch upload to the
    loss on the host), ms."""
    return 1e3 * statistics.median(
        r["dur_s"] for r in opt.step_records[-TIMED_STEPS:])


def train(device):
    """Drive the training path (bf16 mixed precision); returns the report
    and the launch counts of that run."""
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.models import Inception_v1
    from bigdl_tpu_torch.optim import SKIPPED_STEPS
    model = Inception_v1(CLASSES, dropout=0.4).reset(SEED)
    opt = make_trainer(model, make_samples(TRAIN_SAMPLES, SEED + 100), BATCH,
                       TRAIN_STEPS, True, device,
                       val=make_samples(VAL_SAMPLES, SEED + 200))
    ops.reset_launches()                 # the training path starts here
    opt.optimize()
    launches = launches_now()
    losses = [r["loss"] for r in opt.step_records]   # the path ends here
    log(f"train losses (bf16 mixed, {len(losses)} steps): "
        + json.dumps([round(v, 6) for v in losses]))
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        fail(f"training gave {len(losses)} losses, finite: "
             f"{bool(np.isfinite(losses).all())}")
    if opt.metrics.get(SKIPPED_STEPS) or opt.state.get("skippedSteps"):
        fail(f"{opt.state.get('skippedSteps')} steps skipped as non-finite")
    top1, top5 = opt.state.get("lastValidation") or (None, None)
    if top1 is None or top1.count != VAL_SAMPLES or top5.count != VAL_SAMPLES:
        fail(f"validation did not run on {VAL_SAMPLES} samples: {top1}")
    val_fwd = TRAIN_STEPS // VAL_EVERY * (VAL_SAMPLES // BATCH)
    want = per_forward({"max_pool2d": 13 * (TRAIN_STEPS + val_fwd),
                        "cross_map_lrn": 2 * (TRAIN_STEPS + val_fwd),
                        "max_pool2d_bwd": 13 * TRAIN_STEPS,
                        "lrn_bwd": 2 * TRAIN_STEPS}, 1)
    if launches != want:
        fail(f"training launches {launches}, expected {want} (13 K1 + 13 K3 "
             f"+ 2 K2 + 2 K4 per step, K1/K2 per validation forward)")
    log(f"training: {TRAIN_STEPS} steps, epochs {opt.state['epoch'] - 1} "
        f"done, none skipped; validation {top1!r} / {top5!r}; launches "
        f"{launches}")
    return {"losses": losses, "step_ms": step_ms(opt),
            "top1": top1.result()[0], "top5": top5.result()[0]}, launches


def train_f32_step_ms(device):
    from bigdl_tpu_torch.models import Inception_v1
    model = Inception_v1(CLASSES, dropout=0.4).reset(SEED)
    opt = make_trainer(model, make_samples(TRAIN_SAMPLES, SEED + 100), BATCH,
                       TRAIN_STEPS, False, device)
    opt.optimize()
    return step_ms(opt)


def train_vs_cpu(device):
    """2 float32 steps of the same weights (dropout 0) on the card and on
    the CPU: losses to rtol 1e-4, every weight to max |diff| 1e-4."""
    import torch
    from bigdl_tpu_torch.models import Inception_v1
    samples = make_samples(CPU_BATCH * CPU_STEPS, SEED + 300)
    runs = []
    for dev in (device, torch.device("cpu")):
        opt = make_trainer(Inception_v1(CLASSES, dropout=0.0).reset(SEED),
                           samples, CPU_BATCH, CPU_STEPS, False, dev)
        opt.optimize()
        runs.append(opt)
    la = [r["loss"] for r in runs[0].step_records]
    lb = [r["loss"] for r in runs[1].step_records]
    if not np.allclose(la, lb, rtol=1e-4, atol=0.0):
        fail(f"card vs CPU losses {la} vs {lb} (rtol 1e-4)")
    dw = max((a.detach().cpu() - b.detach()).abs().max().item()
             for a, b in zip(runs[0].model.param_leaves(),
                             runs[1].model.param_leaves()))
    if dw > 1e-4:
        fail(f"card vs CPU weights after {CPU_STEPS} steps: max |diff| {dw}")
    log(f"train card vs CPU ({CPU_STEPS} f32 steps, batch {CPU_BATCH}): "
        f"losses {la} vs {lb}, max |dw| {dw:.3g}")
    return {"losses_card": la, "losses_cpu": lb, "max_abs_dw": dw}


# -- phase 3d: quantized serving ----------------------------------------------

# launches per forward of each rung (K1 and K2 as in fp serving)
RUNG_LAUNCHES = {
    "w8": {"w8_matmul": 56, "max_pool2d": 13, "cross_map_lrn": 2},
    "w8a8": {"w8_matmul": 55, "a8_matmul": 1, "max_pool2d": 13,
             "cross_map_lrn": 2},
    "w4": {"w4_matmul": 1, "max_pool2d": 13, "cross_map_lrn": 2},
    "f8": {"f8_matmul": 1, "max_pool2d": 13, "cross_map_lrn": 2},
}


def bf16_step(v: float) -> float:
    """One bfloat16 rounding step at magnitude ``v``."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def logits_and_logp(model, x):
    """A packed Inception's logits (its LogSoftMax's input) and log-probs,
    as float32 on the host."""
    *body, head = model.layers
    for m in body:
        x = m(x)
    return x.float().cpu(), head(x).float().cpu()


def quant_classifier(model, mode, device, cal_rows=None):
    import torch
    from bigdl_tpu_torch.api import DLClassifier
    return DLClassifier(model, (BATCH, 3, IMAGE, IMAGE), quantize=mode,
                        compute_dtype=torch.bfloat16, device=device,
                        calibration_rows=cal_rows)


def serve_quantized(device):
    """Drive quantized serving (w8, bf16, buckets 8 and 32), then one
    batch-32 forward of each other rung; returns the report, the launches
    by path and the w8 classifier."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.core.precision import mixed_forward
    from bigdl_tpu_torch.ops import quant
    from bigdl_tpu_torch.serving import InferenceServer

    model = build_model()
    clf = quant_classifier(model, "w8", device)
    t0 = time.monotonic()
    server = InferenceServer(clf, batch_buckets=BUCKETS, device=device)
    warm_s = time.monotonic() - t0
    wave_rows = {b: make_rows(b * QWAVES[b], SEED + 20 + b) for b in BUCKETS}
    served = []
    try:
        ops.reset_launches()             # the w8 serving path starts here
        for b in BUCKETS:
            for w in range(QWAVES[b]):
                futs = [server.submit(r)
                        for r in wave_rows[b][w * b:(w + 1) * b]]
                served += [f.result(timeout=600) for f in futs]
        launches = launches_now()
        stats = server.stats()           # the w8 serving path ends here
    finally:
        if not server.drain(timeout=120):
            fail("quantized server did not drain")
    forwards = sum(v["batches"] for v in stats["buckets"].values())
    total = sum(b * QWAVES[b] for b in BUCKETS)
    if stats["counters"].get("serve.completed") != total:
        fail(f"{stats['counters']} — expected {total} completed requests")
    want = per_forward(RUNG_LAUNCHES["w8"], forwards)
    if launches != want:
        fail(f"w8 serving launches {launches} for {forwards} forwards, "
             f"expected {want}")
    all_rows = [r for b in BUCKETS for r in wave_rows[b]]
    offline = clf.predict(all_rows)
    if list(offline) != served:
        bad = sum(int(a != b) for a, b in zip(offline, served))
        fail(f"{bad} of {total} quantized served predictions differ from "
             "DLClassifier.predict")

    # the same packed copy on the CPU (plain versions), on the first wave.
    # The logits (LogSoftMax's input) are held to QLOGIT_STEPS bf16 steps
    # of their largest magnitude, where a wrong product shows; the bf16
    # log-probs of random weights are nearly uniform, so they are held to
    # one bf16 step at their own magnitude, which rounding alone reaches.
    cpu_q = copy.deepcopy(clf.qmodel).to("cpu")
    x8 = clf._pack(all_rows[:QCPU_ROWS], size=QCPU_ROWS)
    with torch.inference_mode():
        lg_dev, lp_dev = logits_and_logp(clf.qmodel, x8.to(device))
        lg_cpu, lp_cpu = logits_and_logp(cpu_q, x8)
    if lp_dev.shape != (QCPU_ROWS, CLASSES) or \
            not torch.isfinite(lp_dev).all():
        fail(f"quantized log-probs have shape {tuple(lp_dev.shape)} or are "
             "not finite")
    lg_tol = QLOGIT_STEPS * bf16_step(lg_cpu.abs().max().item())
    lp_tol = bf16_step(lp_cpu.abs().max().item())
    lg_diff = (lg_dev - lg_cpu).abs().max().item()
    diff = (lp_dev - lp_cpu).abs().max().item()
    top2 = lg_cpu.topk(2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1]).min().item()
    if lg_diff > lg_tol or diff > lp_tol or \
            not torch.equal(lg_dev.argmax(1), lg_cpu.argmax(1)):
        fail(f"w8 card vs CPU: max |dlogit| {lg_diff} (limit {lg_tol}), "
             f"max |dlogp| {diff} (limit {lp_tol}), argmax "
             f"{lg_dev.argmax(1).tolist()} vs {lg_cpu.argmax(1).tolist()}")
    if (lp_dev.argmax(1) + 1).tolist() != served[:QCPU_ROWS]:
        fail("w8 served predictions disagree with the same batch's forward")
    log(f"quantized serving (w8, bf16): {total} requests in {forwards} "
        f"forwards, equal to DLClassifier.predict; {QCPU_ROWS} rows vs the "
        f"CPU: max |dlogit| {lg_diff:.4g} (limit {lg_tol:.4g}, smallest "
        f"top-2 margin {margin:.4g}), argmax equal on all {QCPU_ROWS}, max "
        f"|dlogp| {diff:.4g} (limit {lp_tol:.4g}); launches {launches}")

    # every rung against the unquantized bf16 forward, one batch of 32;
    # the other rungs' forward is each one's main path
    rows32 = make_rows(BATCH, SEED + 30)
    x32 = clf._pack(rows32).to(device)
    with torch.inference_mode():
        lp_bf16 = mixed_forward(model, x32, torch.bfloat16)
    bf16_bytes = 2 * sum(p.numel() for p in model.parameters())
    rungs, by_path = {}, {"serve_w8": launches}
    for mode in ("w8", "w8a8", "w4", "f8"):
        c = clf
        if mode != "w8":
            cal = make_rows(QCAL_ROWS, SEED + 40) if mode == "w8a8" else None
            c = quant_classifier(model, mode, device, cal)
            ops.reset_launches()         # this rung's path starts here
            c.predict(rows32)
            got = launches_now()         # and ends here
            if got != per_forward(RUNG_LAUNCHES[mode], 1):
                fail(f"{mode} forward launches {got}, expected "
                     f"{per_forward(RUNG_LAUNCHES[mode], 1)}")
            by_path[mode] = got
        with torch.inference_mode():
            lp = c.qmodel(x32).float()
        by_dtype = quant.param_bytes_by_dtype(c.qmodel)
        rungs[mode] = {
            "top1_agreement_vs_bf16":
                (lp.argmax(1) == lp_bf16.argmax(1)).float().mean().item(),
            "mean_abs_dlogp_vs_bf16": (lp - lp_bf16).abs().mean().item(),
            "bytes_by_dtype": by_dtype,
            "resident_ratio_vs_bf16": sum(by_dtype.values()) / bf16_bytes,
            "budget": quant.RUNG_BUDGETS[mode]}
    report = {"warmup_s": warm_s, "forwards": forwards, "requests": total,
              "cpu_max_abs_logit_diff": lg_diff, "cpu_logit_limit": lg_tol,
              "cpu_min_top2_margin": margin, "cpu_max_abs_logp_diff": diff,
              "cpu_logp_limit": lp_tol,
              "bf16_tree_bytes": bf16_bytes, "rungs": rungs}
    return report, by_path, clf


# -- phase 3e/3f: TransformerLM scoring and generation ------------------------

def lm_model(vocab=None, max_len=None):
    """A full-width TransformerLM (embed 512, 8 heads, 8 layers, GELU FFN
    2048, learned positions) with seeded random weights, on the CPU;
    LM_VOCAB and LM_T unless given."""
    from bigdl_tpu_torch.models import TransformerLM
    return TransformerLM(vocab or LM_VOCAB, max_len=max_len or LM_T,
                         embed_dim=LM_EMBED,
                         num_heads=LM_HEADS, num_layers=LM_LAYERS).reset(
                             SEED).evaluate()


def lm_ids(shape, seed, vocab=None):
    return np.random.RandomState(seed).randint(1, (vocab or LM_VOCAB) + 1,
                                               shape)


def pad_mask(lengths, t):
    import torch
    return torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]


def bf16_limit(ref, steps):
    """``steps`` bfloat16 steps at the largest magnitude of ``ref``."""
    return steps * bf16_step(ref.abs().max().item())


def held_logits(what, got, want, min_share=LM_FIRM_SHARE):
    """Hold bf16 logits ``got`` against ``want`` (float, one device, the
    same positions): max |d| within LM_LOGIT_STEPS bf16 steps of ``want``'s
    largest magnitude, and argmax equal at every position whose top-2
    margin exceeds that limit, which must be more than ``min_share`` of
    them.  Returns the figures and the positions compared, as a mask."""
    limit = bf16_limit(want, LM_LOGIT_STEPS)
    diff = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    firm = (top2[..., 0] - top2[..., 1]) > limit
    compared, positions = int(firm.sum()), firm.numel()
    agree = int((got.argmax(-1) == want.argmax(-1))[firm].sum())
    if not math.isfinite(diff) or diff > limit or agree != compared or \
            compared <= min_share * positions:
        fail(f"{what}: max |dlogit| {diff} (limit {limit}); argmax equal at "
             f"{agree} of the {compared} positions (of {positions}, at least "
             f"{min_share} of them) whose top-2 margin exceeds it")
    return {"max_abs_dlogit": diff, "limit": limit,
            "argmax_compared": compared, "positions": positions}, firm


def lm_scoring(device):
    """Drive LM scoring (bf16 weights): LocalValidator with the Loss of
    ``train_main`` over LM_SEQS seeded sequences, the padded forward, the
    long-context forward; hold the card against the CPU.  Returns the
    report, the launches by path and the bf16 model on the card."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import Loss, LocalValidator

    base = lm_model()
    model = copy.deepcopy(base).to(device, torch.bfloat16)
    seqs = lm_ids((LM_SEQS, LM_T + 1), SEED + 50)
    val = DataSet.array([Sample(q[:-1], q[1:]) for q in seqs]) >> \
        SampleToBatch(LM_BATCH)
    crit = TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)
    ops.reset_launches()                 # the LM scoring path starts here
    (res,) = LocalValidator(model, val, device=device).test([Loss(crit)])
    score_launches = launches_now()      # and ends here
    forwards = LM_SEQS // LM_BATCH
    if score_launches != per_forward({"attention_fwd": LM_LAYERS}, forwards):
        fail(f"LM scoring launches {score_launches} for {forwards} forwards, "
             f"expected {LM_LAYERS} attention_fwd per forward")
    loss, count = res.result()
    if not math.isfinite(loss) or count != LM_SEQS:
        fail(f"LM scoring loss {loss} over {count} sequences")

    ids = torch.from_numpy(seqs[:LM_BATCH, :-1]).to(device)
    mask = pad_mask(LM_PAD_LENGTHS, LM_T).to(device)
    with torch.inference_mode():
        ops.reset_launches()             # the padded LM path starts here
        lp_pad = model(ids, key_padding_mask=mask)
        pad_launches = launches_now()    # and ends here
    if pad_launches != per_forward({"attention_stream_fwd": LM_LAYERS}, 1):
        fail(f"padded LM forward launches {pad_launches}, expected "
             f"{LM_LAYERS} attention_stream_fwd")
    if lp_pad.shape != (LM_BATCH, LM_T, LM_VOCAB) or \
            not torch.isfinite(lp_pad).all():
        fail(f"padded LM log-probs {tuple(lp_pad.shape)} not finite")
    del lp_pad
    # causal attention over right padding: the real positions of every row
    # see only real keys, so their logits must agree with the unpadded
    # forward's (K9 vs K8)
    with torch.inference_mode():
        lg_pad = model.logits(ids, key_padding_mask=mask)
        real, _ = held_logits("padded vs unpadded LM logits at the real "
                              "positions", lg_pad[mask].float(),
                              model.logits(ids)[mask].float())
    # the padded rows against a CPU bf16 run with the same mask at every
    # position: a padded query row sees its padded keys only through K9's
    # bias
    rows = LM_PAD_CPU_ROWS
    cpu_bf16 = copy.deepcopy(base).to("cpu", torch.bfloat16)
    with torch.inference_mode():
        padded, firm = held_logits(
            "padded bf16 LM logits, card vs CPU",
            lg_pad[rows].float().cpu(),
            cpu_bf16.logits(ids[rows].cpu(),
                            key_padding_mask=mask[rows].cpu()).float(),
            LM_PAD_FIRM_SHARE)
    pad_real = mask[rows].cpu()
    del lg_pad

    # the long-context model, one eval forward at batch 1 x T 8192
    long_model = lm_model(LONG_VOCAB, LONG_T).to(device, torch.bfloat16)
    long_ids = torch.from_numpy(lm_ids((1, LONG_T), SEED + 51,
                                       LONG_VOCAB)).to(device)
    with torch.inference_mode():
        ops.reset_launches()             # the long-context path starts here
        lp_long = long_model(long_ids)
        long_launches = launches_now()   # and ends here
    if long_launches != per_forward({"attention_stream_fwd": LM_LAYERS}, 1):
        fail(f"long-context forward launches {long_launches}, expected "
             f"{LM_LAYERS} attention_stream_fwd")
    if lp_long.shape != (1, LONG_T, LONG_VOCAB) or \
            not torch.isfinite(lp_long).all():
        fail(f"long-context log-probs {tuple(lp_long.shape)} not finite")
    del lp_long

    # card vs CPU: one row in float32 (TF32 off), the log-probs
    row = torch.from_numpy(seqs[:1, :-1])
    f32 = copy.deepcopy(base).to(device)
    with torch.inference_mode():
        lp_dev = f32(row.to(device)).float().cpu()
        lp_cpu = base(row)
    del f32
    f32_diff = (lp_dev - lp_cpu).abs().max().item()
    if f32_diff > LM_F32_ATOL:
        fail(f"f32 LM row, card vs CPU: max |dlogp| {f32_diff} (limit "
             f"{LM_F32_ATOL})")
    # card vs CPU in bf16: the logits (LogSoftMax's input) of two rows
    rows = torch.from_numpy(seqs[:LM_CPU_ROWS, :-1])
    with torch.inference_mode():
        unpadded, _ = held_logits(
            "bf16 LM logits, card vs CPU",
            model.logits(rows.to(device)).float().cpu(),
            cpu_bf16.logits(rows).float())
    del cpu_bf16

    def said(r):
        return (f"max |dlogit| {r['max_abs_dlogit']:.4g} (limit "
                f"{r['limit']:.4g}), argmax equal at all "
                f"{r['argmax_compared']} positions compared of "
                f"{r['positions']}")

    log(f"LM scoring (bf16, batch {LM_BATCH} x T {LM_T}): loss {loss:.5f} "
        f"over {count} sequences, launches {score_launches}; padded forward "
        f"launches {pad_launches}, real positions vs unpadded: {said(real)}; "
        f"long context (1 x {LONG_T}) launches {long_launches}; f32 row vs "
        f"CPU max |dlogp| {f32_diff:.3g} (limit {LM_F32_ATOL}); bf16 vs CPU, "
        f"{LM_CPU_ROWS} rows: {said(unpadded)}; padded rows "
        f"{LM_PAD_CPU_ROWS}: {said(padded)}, of them "
        f"{int(firm[pad_real].sum())} of {int(pad_real.sum())} real and "
        f"{int(firm[~pad_real].sum())} of {int((~pad_real).sum())} padded")
    report = {"loss": loss, "sequences": count,
              "f32_cpu_max_abs_dlogp": f32_diff,
              "padded_vs_unpadded": real, "bf16_vs_cpu": unpadded,
              "padded_bf16_vs_cpu": padded}
    by_path = {"lm_score": score_launches, "lm_padded": pad_launches,
               "lm_long": long_launches}
    return report, by_path, model, long_model


def lm_head_dim_256(device):
    """Phase 3e at head dim 256: the LM of 3e at embed 512 over
    LM_D256_HEADS heads (bf16, seeded), scored at LM_D256_BATCH x LM_T on
    the card with exactly 8 K9 and no other kernel, its logits held against
    a CPU bf16 run on LM_D256_CPU_ROWS rows; then one bf16 SGD step on one
    row on the card (8 K9 with LSE, 8 delta passes, 8 K10, 8 K11) and on the
    CPU: the losses and the stepped models' logits within LM_LOGIT_STEPS
    bf16 steps.  Returns the report and the launches by path."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    base = TransformerLM(LM_VOCAB, max_len=LM_T, embed_dim=LM_EMBED,
                         num_heads=LM_D256_HEADS,
                         num_layers=LM_LAYERS).reset(SEED + 1).evaluate()
    card = copy.deepcopy(base).to(device, torch.bfloat16)
    cpu = copy.deepcopy(base).to("cpu", torch.bfloat16)
    del base
    seqs = lm_ids((LM_D256_BATCH, LM_T + 1), SEED + 54)
    ids = torch.from_numpy(seqs[:, :-1])
    with torch.inference_mode():
        ops.reset_launches()             # the head-dim-256 scoring starts
        lg = card.logits(ids.to(device))
        score = launches_now()           # and ends here
        expect_launches("head dim 256 LM scoring", score,
                        {"attention_stream_fwd": LM_LAYERS})
        if lg.shape != (LM_D256_BATCH, LM_T, LM_VOCAB) or \
                not torch.isfinite(lg).all():
            fail(f"head dim 256 LM logits {tuple(lg.shape)} not finite")
        rows = slice(0, LM_D256_CPU_ROWS)
        scored, _ = held_logits("head dim 256 bf16 LM logits, card vs CPU",
                                lg[rows].float().cpu(),
                                cpu.logits(ids[rows]).float())
    del lg
    crit = TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)
    x, y = ids[:1], torch.from_numpy(seqs[:1, 1:].astype(np.float32))
    losses, step = [], None
    for model, dev in ((card, device), (cpu, torch.device("cpu"))):
        model.training_()
        params = list(model.param_leaves())
        ops.reset_launches()             # the training step starts here
        loss = crit(model(x.to(dev)), y.to(dev))
        grads = torch.autograd.grad(loss, params)
        if dev.type == "cuda":
            step = launches_now()        # and ends here
        with torch.no_grad():
            for w, g in zip(params, grads):
                w.sub_(LM_D256_LR * g)
        model.evaluate()
        losses.append(loss.item())
        del loss, grads, params
    expect_launches("head dim 256 LM training step", step,
                    {n: LM_LAYERS for n in (
                        "attention_stream_fwd", "flash_bwd_delta",
                        "attention_stream_bwd_dq",
                        "attention_stream_bwd_dkv")})
    loss_limit = LM_LOGIT_STEPS * bf16_step(abs(losses[1]))
    if not abs(losses[0] - losses[1]) <= loss_limit:
        fail(f"head dim 256 LM step, card vs CPU: loss {losses[0]} vs "
             f"{losses[1]} (limit {loss_limit})")
    with torch.inference_mode():
        stepped, _ = held_logits(
            "head dim 256 LM after one SGD step, card vs CPU",
            card.logits(x.to(device)).float().cpu(),
            cpu.logits(x).float())
    del card, cpu
    log(f"LM at head dim 256 (bf16, embed {LM_EMBED} over {LM_D256_HEADS} "
        f"heads, {LM_LAYERS} layers, {LM_D256_BATCH} x T {LM_T}): scoring "
        f"launches {score}, {LM_D256_CPU_ROWS} row vs CPU max |dlogit| "
        f"{scored['max_abs_dlogit']:.4g} (limit {scored['limit']:.4g}); one "
        f"SGD step ({LM_D256_LR}) launches {step}, loss {losses[0]:.5f} vs "
        f"CPU {losses[1]:.5f} (limit {loss_limit:.4g}), stepped logits max "
        f"|dlogit| {stepped['max_abs_dlogit']:.4g} (limit "
        f"{stepped['limit']:.4g})")
    return ({"bf16_vs_cpu": scored, "step_loss_card": losses[0],
             "step_loss_cpu": losses[1], "stepped_vs_cpu": stepped},
            {"lm_d256": score, "lm_d256_step": step})


def lm_generation(device):
    """Drive generation at the decode configuration (bf16 weights and
    cache, batch 8, prompt 128, 128 new tokens), greedy and sampled; hold
    greedy f32 tokens against the CPU.  Returns the report, the launches
    and the bf16 model on the card."""
    import torch
    from bigdl_tpu_torch import ops
    base = lm_model(max_len=GEN_PROMPT + GEN_NEW)
    model = copy.deepcopy(base).to(device, torch.bfloat16)
    prompt = torch.from_numpy(lm_ids((LM_BATCH, GEN_PROMPT),
                                     SEED + 60)).to(device)

    def gen(seed=None, **kw):
        g = None
        if seed is not None:
            g = torch.Generator(device=device).manual_seed(seed)
        return model.generate(prompt, GEN_NEW, generator=g,
                              cache_dtype=torch.bfloat16, device=device, **kw)

    ops.reset_launches()                 # the generation path starts here
    greedy = gen()
    sampled = gen(SEED, temperature=1.0, top_k=50, top_p=0.9)
    launches = launches_now()            # and ends here
    if any(launches.values()):
        fail(f"generation launched kernels {launches}; the decode path "
             "runs none")
    again = gen(SEED, temperature=1.0, top_k=50, top_p=0.9)
    for name, out in (("greedy", greedy), ("sampled", sampled)):
        if out.shape != (LM_BATCH, GEN_NEW) or \
                not bool(((out >= 1) & (out <= LM_VOCAB)).all()):
            fail(f"{name} generation gave {tuple(out.shape)} or ids out of "
                 "range")
    if not torch.equal(sampled, again):
        fail("sampling with the same generator seed is not reproducible")
    # greedy in float32, card vs CPU; and top_k=1 sampling against greedy
    # in float32 (bf16 log-probs tie at the top, and top_k keeps every
    # tie, as the reference's does)
    f32 = copy.deepcopy(base).to(device)
    p2 = prompt[:GEN_CPU_ROWS]
    got = f32.generate(p2, GEN_CPU_NEW, device=device)
    top1 = f32.generate(p2, GEN_CPU_NEW, temperature=1.0, top_k=1,
                        generator=torch.Generator(device=device).manual_seed(
                            SEED + 1), device=device)
    want = base.generate(p2.cpu(), GEN_CPU_NEW, device="cpu")
    del f32
    if not torch.equal(got.cpu(), want):
        fail(f"greedy f32 tokens differ from the CPU's: {got.tolist()} vs "
             f"{want.tolist()}")
    if not torch.equal(top1, got):
        fail("f32 sampling with top_k=1 differs from greedy decoding")
    log(f"LM generation (bf16, batch {LM_BATCH}, prompt {GEN_PROMPT}, "
        f"{GEN_NEW} new): greedy and sampled (top_k 50, top_p 0.9) in range, "
        f"sampling reproducible, launches {launches}; greedy f32 "
        f"{GEN_CPU_ROWS} rows x {GEN_CPU_NEW} tokens equal to the CPU's and "
        f"to f32 top_k 1 sampling")
    report = {"greedy_sampled_differ_at": int((greedy != sampled).sum()),
              "cpu_tokens_equal": GEN_CPU_ROWS * GEN_CPU_NEW}
    return report, {"lm_generate": launches}, model, prompt


# -- phase 3g: continuous serving ----------------------------------------------

def continuous_serving(device):
    """Drive ``ContinuousGenerator`` at the LM's full width (bf16 weights,
    bf16 pool) over the traffic of :func:`cg_traffic`, every request
    submitted at once; check its outputs, launches, prefix hits and page
    accounting, one over-capacity shed, the mixed path (a bf16 model over
    the default f32 cache) and an f32 copy's tokens against ``generate``
    and against ``paged_kernel=False``.  Returns the report, the launches
    and what phase 4 times again."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.serving import ContinuousGenerator, SlotCapacityError
    base = lm_model()
    model = copy.deepcopy(base).to(device, torch.bfloat16)
    prompts, budgets, shared = cg_traffic()
    kw = dict(num_slots=CG_SLOTS, max_len=LM_T, page_size=CG_PAGE,
              seq_buckets=CG_BUCKETS, device=device)
    t0 = time.perf_counter()
    gen = ContinuousGenerator(model, cache_dtype=torch.bfloat16, **kw)
    warm_s = time.perf_counter() - t0
    ops.reset_launches()                 # the continuous path starts here
    run = drive_continuous(gen, prompts, budgets)
    try:
        gen.submit(prompts[0], LM_T)
        fail("an over-capacity request was admitted")
    except SlotCapacityError:
        pass
    gen.drain()
    launches = launches_now()            # and ends here
    st = gen.stats()
    prefills = st["counters"]["serve.gen.prefills"]
    steps = st["counters"]["serve.gen.steps"]
    want = per_forward({"paged_attention": LM_LAYERS * (prefills + steps)}, 1)
    if launches != want or prefills != CG_REQUESTS:
        fail(f"continuous serving launches {launches} for {prefills} "
             f"prefills and {steps} decode steps, expected {want}")
    for out, n in zip(run.pop("outputs"), budgets):
        if out.shape != (n,) or out.min() < 1 or out.max() > LM_VOCAB:
            fail(f"continuous serving gave {out.shape} ids or ids out of "
                 f"range for max_new {n}")
    pages, prefix = st["pages"], st["prefix"]
    if prefix["hit_pages"] <= 0 or \
            pages["free"] + prefix["entries"] != pages["total"]:
        fail(f"prefix hits {prefix} or pages {pages}: a shared head must "
             "hit, and every private page be free after drain()")
    if st["counters"].get("serve.shed.over_capacity") != 1:
        fail(f"over-capacity shed not counted: {st['counters']}")

    # the mixed path: a bf16 model over the default f32 cache
    with ContinuousGenerator(model, **kw) as g:
        mixed = g.submit(prompts[0], CG_SHORT[0]).result(timeout=600)
        mixed_pool = g.stats()["pages"]["pool_bytes"]
    with torch.inference_mode():
        pool = model.init_paged_cache(LM_T // CG_PAGE, CG_PAGE)
        table = torch.arange(LM_T // CG_PAGE, dtype=torch.int32,
                             device=device)[None]
        lp = model.decode_pages(torch.from_numpy(prompts[0][None]).to(device),
                                pool, table, torch.zeros(1, device=device),
                                torch.ones(1, dtype=torch.bool, device=device))
        finite = bool(torch.isfinite(lp).all())
    del pool, lp
    if not finite or mixed.shape != (CG_SHORT[0],) or mixed.min() < 1 or \
            mixed.max() > LM_VOCAB:
        fail(f"bf16 model over an f32 cache: log-probs finite {finite}, "
             f"ids {mixed}")

    # an f32 copy: tokens equal to generate() and to paged_kernel=False
    f32 = copy.deepcopy(base).to(device)
    pick = [i for i in range(CG_REQUESTS) if shared[i]][:CG_F32_REQUESTS // 2]
    pick += [i for i in range(CG_REQUESTS)
             if not shared[i]][:CG_F32_REQUESTS - len(pick)]
    fprompts = [prompts[i] for i in pick]
    outs = {}
    for name, extra in (("kernel", {}), ("hoisted", {"paged_kernel": False})):
        with ContinuousGenerator(f32, **kw, **extra) as g:
            outs[name] = g.generate(fprompts, CG_F32_NEW)
    ref = [f32.generate(torch.from_numpy(p[None]).to(device), CG_F32_NEW,
                        device=device)[0].cpu().numpy() for p in fprompts]
    del f32
    for name, got in outs.items():
        for i, (a, b) in enumerate(zip(got, ref)):
            if not np.array_equal(a, b):
                fail(f"f32 continuous ({name}) request {i} differs from "
                     f"generate(): {a.tolist()} vs {b.tolist()}")
    log(f"continuous serving (bf16, {CG_REQUESTS} requests of {CG_PROMPT} "
        f"tokens, {sum(shared)} with the {CG_HEAD}-token head, "
        f"{sum(budgets)} new tokens): {prefills} prefills, {steps} decode "
        f"steps in {st['chunks']} chunks, launches {launches}; prefix hit "
        f"pages {prefix['hit_pages']} of {prefix['lookup_pages']}; pages "
        f"free {pages['free']} + cached {prefix['entries']} of "
        f"{pages['total']} after drain; over-capacity shed typed; bf16 "
        f"model over the f32 cache: finite log-probs, ids in range; f32 "
        f"copy: {CG_F32_REQUESTS} requests x {CG_F32_NEW} equal to "
        f"generate() with K12 and with paged_kernel=False")
    report = dict(run, warmup_s=warm_s, prefills=prefills,
                  decode_steps=steps, chunks=st["chunks"],
                  mean_slot_occupancy=st["mean_occupancy"],
                  mean_token_occupancy=pages["mean_token_occupancy"],
                  prefix=prefix, pool_bytes=pages["pool_bytes"],
                  mixed_pool_bytes=mixed_pool,
                  f32_requests_equal=CG_F32_REQUESTS)
    return report, {"lm_continuous": launches}, (model, prompts, budgets, kw)


def drive_continuous(gen, prompts, budgets):
    """Submit every request at once, stamp each at its resolution, and
    return the outputs, the wall time, new tokens/s and the latencies."""
    done = {}
    t0 = time.perf_counter()
    futs = []
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        f = gen.submit(p, n)
        f.add_done_callback(
            lambda _f, i=i: done.__setitem__(i, time.perf_counter() - t0))
        futs.append(f)
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    lats = sorted(done.values())
    return {"outputs": outs, "wall_s": wall,
            "new_tokens_per_s": sum(budgets) / wall,
            "latency_p50_ms": 1e3 * lats[(len(lats) - 1) // 2],
            "latency_max_ms": 1e3 * lats[-1]}


# -- phase 3h/3i: TransformerLM training --------------------------------------

class LogArgs:
    """Collects the arguments of one logger's records whose message starts
    with ``prefix`` (the harness's and the trainer's unrounded numbers)."""

    def __init__(self, name, prefix):
        import logging
        self.args = []
        self.log = logging.getLogger(name)
        outer = self

        class Grab(logging.Handler):
            def emit(self, record):
                if str(record.msg).startswith(prefix):
                    outer.args.append(record.args)

        self.handler = Grab(logging.INFO)

    def __enter__(self):
        import logging
        self.level = self.log.level
        self.log.addHandler(self.handler)
        self.log.setLevel(logging.INFO)
        return self.args

    def __exit__(self, *exc):
        self.log.removeHandler(self.handler)
        self.log.setLevel(self.level)


def expect_launches(what, counts, want):
    """Fail unless every wrapper's count is ``want``'s (0 where absent)."""
    from bigdl_tpu_torch import ops
    full = {fn.__name__: want.get(fn.__name__, 0)
            for fn in ops.KERNEL_WRAPPERS}
    if counts != full:
        fail(f"{what}: launches {counts}, want {full}")


def long_context_training(device):
    """Phase 3h: ``longcontext_perf_main`` at its defaults (1 warm-up and
    LONG_ITERS timed steps at T 8192, 8 layers, remat, bf16, SGD 0.1): finite
    losses falling, 16 K9 + 8 delta + 8 K10 + 8 K11 a step and no other
    kernel; one step pair with ``--no-remat`` (8 K9 a step); a profile of
    the default run; then one f32 step at full width and T but
    LONG_CPU_LAYERS layers on the card and on the CPU."""
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.models import perf
    report, by_path = {}, {}
    for key, argv, k9 in (("remat", [], 16), ("no_remat", ["--no-remat",
                                                            "-i", "1"], 8)):
        steps = 1 + (LONG_ITERS if not argv else 1)
        with LogArgs("bigdl_tpu_torch.models.perf", "T=") as rec:
            ops.reset_launches()
            toks = perf.longcontext_perf_main(argv, device=device)
            counts = launches_now()
        by_path["long_context" if key == "remat" else
                "long_context_no_remat"] = counts
        expect_launches(f"long context ({key})", counts,
                        {"attention_stream_fwd": k9 * steps,
                         "flash_bwd_delta": 8 * steps,
                         "attention_stream_bwd_dq": 8 * steps,
                         "attention_stream_bwd_dkv": 8 * steps})
        t, layers, embed, remat, ms, tps, first, last = rec[-1]
        if not (math.isfinite(first) and math.isfinite(last) and
                last < first):
            fail(f"long context ({key}): losses {first} -> {last}")
        report[key] = {"ms_per_step": ms, "tokens_per_s": tps,
                       "first_loss": first, "last_loss": last,
                       "steps": steps, "returned_tokens_per_s": toks,
                       "launches_per_step": {k: v // steps for k, v in
                                             counts.items() if v}}
    prof = device_profile(lambda: perf.longcontext_perf_main(
        ["-i", str(LONG_ITERS)], device=device), 1 + LONG_ITERS)
    prof["busy_share"] = (prof["device_ms"] - prof["htod_ms"]) / \
        report["remat"]["ms_per_step"]
    report["profile"] = prof
    report["card_vs_cpu"] = long_context_vs_cpu(device)
    return report, by_path


def long_context_vs_cpu(device):
    """One f32 step of the long-context model (T 8192, embed 512, 8 heads,
    vocab 8192, remat) cut to LONG_CPU_LAYERS layers, on the card (K9, K10,
    K11, TF32 off) and on the CPU (the plain versions) from the same seeded
    weights and ids: the losses within LONG_LOSS_ATOL, every gradient within
    LONG_GRAD_RTOL of its largest magnitude (the key bias's, zero but for
    rounding, of its block's key weight gradient's)."""
    import torch
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    ids_np = np.random.RandomState(0).randint(1, LONG_VOCAB + 1, (1, LONG_T))
    tgt_np = np.roll(ids_np, -1, axis=1).astype(np.float32)
    crit = TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)
    out = []
    for dev in (device, torch.device("cpu")):
        model = TransformerLM(LONG_VOCAB, max_len=LONG_T, embed_dim=LM_EMBED,
                              num_heads=LM_HEADS, num_layers=LONG_CPU_LAYERS,
                              remat=True).reset(SEED).to(dev).training_()
        names = {id(p): n for n, p in model.named_parameters()}
        params = list(model.param_leaves())
        t0 = time.perf_counter()
        loss = crit(model(torch.from_numpy(ids_np).to(dev)),
                    torch.from_numpy(tgt_np).to(dev))
        grads = torch.autograd.grad(loss, params)
        out.append((loss.item(), {names[id(p)]: g.cpu()
                                  for p, g in zip(params, grads)},
                    time.perf_counter() - t0))
        del model, params, loss, grads
    (lc, gc, tc), (lh, gh, th) = out
    # the key projection's bias gets no gradient in exact arithmetic (it
    # adds one constant to a query row's scores, which the softmax drops):
    # both sides give rounding noise, held against the same block's key
    # weight gradient
    worst = max((gc[n] - gh[n]).abs().max().item() / max(
        gh[n[:-2] + "wk" if n.endswith("attn.bk") else n].abs().max().item(),
        1e-30) for n in gh)
    if abs(lc - lh) > LONG_LOSS_ATOL or worst > LONG_GRAD_RTOL:
        fail(f"long context card vs CPU: loss {lc} vs {lh}, worst gradient "
             f"{worst:.3g} of its largest magnitude (limits "
             f"{LONG_LOSS_ATOL}, {LONG_GRAD_RTOL})")
    log(f"long context card vs CPU (f32, {LONG_CPU_LAYERS} layers, T "
        f"{LONG_T}): loss {lc:.7f} / {lh:.7f}, worst gradient "
        f"{worst:.3g} of its largest magnitude over {len(gc)} tensors "
        f"(limits {LONG_LOSS_ATOL}, {LONG_GRAD_RTOL}); CPU step {th:.1f} s")
    return {"loss_card": lc, "loss_cpu": lh, "worst_grad_rel": worst,
            "tensors": len(gc), "cpu_s": th}


def write_corpus(folder):
    """TM_LINES lines of about TM_WORDS words each, drawn from a seeded
    Zipf law (exponent 1.1) over TM_TYPES word types, so that the
    dictionary fills and discards."""
    rng = np.random.RandomState(SEED + 400)
    p = 1.0 / np.arange(1, TM_TYPES + 1) ** 1.1
    with open(os.path.join(folder, "input.txt"), "w") as f:
        for _ in range(TM_LINES):
            n = TM_WORDS + int(rng.randint(-50, 51))
            draw = rng.choice(TM_TYPES, size=n, p=p / p.sum())
            f.write(" ".join(f"w{i}" for i in draw) + ".\n")


def train_main_long(device):
    """Phase 3i: ``train_main`` at the long-context widths (TM_FLAGS, f32)
    on a corpus written here: finite losses, 8 K9 + 8 delta + 8 K10 + 8 K11
    a step and 8 K9 per validation forward; then phase 3j on the same
    corpus (:func:`snapshots_and_resume`)."""
    import shutil
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.models import transformer
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_corpus")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    try:
        write_corpus(folder)
        with LogArgs("bigdl_tpu_torch.optim", "Epoch ") as steps, \
                LogArgs("bigdl_tpu_torch.optim", "%s is %r") as vals:
            ops.reset_launches()
            t0 = time.perf_counter()
            transformer.train_main(["-f", folder] + TM_FLAGS, device=device)
            wall = time.perf_counter() - t0
            counts = launches_now()
        resume = snapshots_and_resume(device, folder)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    n = len(steps)
    expect_launches("train_main", counts,
                    {"attention_stream_fwd": 8 * n + 8 * len(vals),
                     "flash_bwd_delta": 8 * n,
                     "attention_stream_bwd_dq": 8 * n,
                     "attention_stream_bwd_dkv": 8 * n})
    losses = [a[3] for a in steps]
    if n != TM_STEPS or len(vals) != 1 or \
            not all(math.isfinite(x) for x in losses):
        fail(f"train_main: {n} steps with losses {losses}, {len(vals)} "
             f"validations (want {TM_STEPS} and 1)")
    val = vals[0][1].result()[0]
    if not math.isfinite(val):
        fail(f"train_main: validation loss {val}")
    ms = [1e3 * TM_BATCH / a[4] for a in steps]
    return {"losses": losses, "validation_loss": val, "step_ms": ms,
            "step_ms_median_after_first": statistics.median(ms[1:]),
            "wall_s": wall, "launches": {k: v for k, v in counts.items()
                                         if v}}, counts, resume


# -- phase 2g: the fp16 codec against its plain versions --------------------

def u16_nan(u):
    """Which wire values are NaNs (exponent all ones, mantissa not 0)."""
    import torch
    w = u.to(torch.int32)
    return ((w & 0x7F80) == 0x7F80) & ((w & 0x7F) != 0)


def codec_diff(got, want):
    """(positions that break the codec's rule, max |error| at them): the
    bits equal wherever ``want`` is not a NaN, a NaN wherever it is; the
    error is taken on the values (wire values widened to float32)."""
    import torch
    from bigdl_tpu_torch.ops import fp16_decompress_reference as widen
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.numel(), 1), math.inf
    if want.dtype == torch.float32:
        nan, gnan = torch.isnan(want), torch.isnan(got)
        same = got.view(torch.int32) == want.view(torch.int32)
        gv, wv = got, want
    else:
        nan, gnan = u16_nan(want), u16_nan(got)
        same = got.to(torch.int32) == want.to(torch.int32)
        gv, wv = widen(got), widen(want)
    bad = (gnan != nan) | (~nan & ~same)
    n = int(bad.sum().item())
    if not n:
        return 0, 0.0
    err = (gv[bad] - wv[bad]).abs()
    return n, float(torch.nan_to_num(err, nan=math.inf).max().item())


def codec_wire(values, device):
    import torch
    return torch.tensor(values, dtype=torch.int32).to(torch.uint16).to(
        device)


def codec_cases(device):
    """(name, K5 input, K6 input, K7 inputs) of phase 2g, the values drawn
    on the card from a seeded generator: normals for the full-width vector,
    normals times 2^[-140, 127] (subnormals and infinities among them) for
    the ragged lengths."""
    import torch
    from bigdl_tpu_torch.ops import fp16_compress_reference as wire
    gen = torch.Generator(device=device).manual_seed(SEED + 800)
    x = torch.randn(CODEC_N, generator=gen, device=device)
    u, v = wire(x), wire(torch.randn(CODEC_N, generator=gen, device=device))
    cases = [(f"n {CODEC_N}", x, u, (u, v)),
             (f"n {CODEC_N} at offset 1", x[1:], u[1:], (u[1:], v[:-1])),
             ("both operands at offset 1", None, None, (u[1:], v[1:])),
             ("strided", x[::3], u[::3], (u[::3], v[::3]))]
    for n in CODEC_RAGGED:
        r = torch.randn(n + 1, generator=gen, device=device) * torch.pow(
            2.0, torch.randint(-140, 128, (n + 1,), generator=gen,
                               device=device).float())
        rw = wire(r)
        cases.append((f"n {n}", r[:n], rw[:n], (rw[:n], wire(r.flip(0))[:n])))
        cases.append((f"n {n} at offset 1", r[1:], rw[1:],
                      (rw[1:], wire(r.flip(0))[1:])))
    special = torch.tensor(CODEC_F32, dtype=torch.int64).to(
        torch.int32).view(torch.float32).to(device)
    pairs = torch.tensor(CODEC_U16, dtype=torch.int32)
    a = torch.cat([pairs.repeat_interleave(len(CODEC_U16)),
                   torch.tensor([c[0] for c in CODEC_ADD_CASES])])
    b = torch.cat([pairs.repeat(len(CODEC_U16)),
                   torch.tensor([c[1] for c in CODEC_ADD_CASES])])
    cases.append(("special values", special, codec_wire(CODEC_U16, device),
                  (a.to(torch.uint16).to(device),
                   b.to(torch.uint16).to(device))))
    return cases


def check_codec_kernels(device):
    """Phase 2g: K5, K6 and K7 against their plain versions on the card
    (:func:`codec_cases`), and K7's flush cases against the sums XLA gives
    on the CPU.  Returns per-kernel errors, cases and mismatches."""
    import torch
    from bigdl_tpu_torch import ops
    names = ("fp16_compress", "fp16_decompress", "fp16_add")
    errs = {k: 0.0 for k in names}
    cases = {k: 0 for k in names}
    misses = {k: 0 for k in names}
    for name, x, u, (a, b) in codec_cases(device):
        runs = [("fp16_add", lambda: ops.fp16_add(a, b),
                 lambda: ops.fp16_add_plain(a.reshape(-1), b.reshape(-1)))]
        if x is not None:
            runs += [("fp16_compress", lambda: ops.fp16_compress(x),
                      lambda: ops.fp16_compress_reference(x.reshape(-1))),
                     ("fp16_decompress", lambda: ops.fp16_decompress(u),
                      lambda: ops.fp16_decompress_reference(u.reshape(-1)))]
        for kernel, run, plain in runs:
            got = run()
            torch.cuda.synchronize()
            n, err = codec_diff(got, plain())
            cases[kernel] += 1
            errs[kernel] = max(errs[kernel], err)
            if n:
                misses[kernel] += 1
                fail(f"{kernel} {name}: {n} positions break bit equality "
                     f"(max |err| {err:.3g})")
    a, b, want = (codec_wire(c, device) for c in zip(*CODEC_ADD_CASES))
    got = ops.fp16_add(a, b).cpu().to(torch.int32).tolist()
    if got != [c[2] for c in CODEC_ADD_CASES]:
        misses["fp16_add"] += 1
        fail(f"fp16_add flush cases: {got}, want "
             f"{[c[2] for c in CODEC_ADD_CASES]}")
    log("fp16 codec vs plain: " + "; ".join(
        f"{k} bit-equal in {cases[k]} cases" for k in names) +
        f" (NaN where the plain result is NaN); K7's {len(CODEC_ADD_CASES)} "
        "flush cases equal XLA's sums")
    return errs, cases, misses


# -- phase 3k: the codec on the long-context gradient ------------------------

def codec_chain(device):
    """Phase 3k: the flat f32 gradients of two SGD steps (0.1) of 3h's model
    (remat, T 8192) in float32, compressed by K5, summed by K7 as the
    reference's aggregation does and widened by K6, with one launch of each
    kernel per call: the chain bit-equal to the plain chain, each
    gradient's round trip within CODEC_RT_RTOL of each value.  In float32,
    not 3h's bf16 mixed precision: a mixed-precision gradient carries bf16
    values, which the wire keeps exactly."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    model = TransformerLM(LONG_VOCAB, max_len=LONG_T, embed_dim=LM_EMBED,
                          num_heads=LM_HEADS, num_layers=LM_LAYERS,
                          remat=True).reset(SEED).to(device).training_()
    crit = TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)
    params = list(model.param_leaves())
    grads = []
    for step in range(2):
        ids = lm_ids((1, LONG_T), SEED + 900 + step, LONG_VOCAB)
        tgt = torch.from_numpy(np.roll(ids, -1, axis=1).astype(np.float32))
        loss = crit(model(torch.from_numpy(ids).to(device)), tgt.to(device))
        g = torch.autograd.grad(loss, params)
        grads.append(torch.cat([t.reshape(-1).float() for t in g]))
        with torch.no_grad():
            for p, t in zip(params, g):
                p.sub_(0.1 * t)
    del model, params, g
    g1, g2 = grads
    if g1.numel() != LONG_PARAMS:
        fail(f"codec chain: gradient of {g1.numel()} elements, want "
             f"{LONG_PARAMS}")
    ops.reset_launches()
    w1, w2 = ops.fp16_compress(g1), ops.fp16_compress(g2)
    total = ops.fp16_decompress(ops.fp16_add(w1, w2))
    backs = [ops.fp16_decompress(w) for w in (w1, w2)]
    torch.cuda.synchronize()
    counts = launches_now()
    expect_launches("codec chain", counts, {"fp16_compress": 2,
                                            "fp16_add": 1,
                                            "fp16_decompress": 3})
    pw = [ops.fp16_compress_reference(g) for g in (g1, g2)]
    plain = ops.fp16_decompress_reference(ops.fp16_add_plain(*pw))
    for what, got, want in (("K5, first", w1, pw[0]),
                            ("K5, second", w2, pw[1]),
                            ("the chain", total, plain)):
        n, err = codec_diff(got, want)
        if n:
            fail(f"codec chain: {what} breaks bit equality at {n} "
                 f"positions (max |err| {err:.3g})")
    worst = 0.0
    for g, back in zip((g1, g2), backs):
        over = (back - g).abs() - (g.abs() * CODEC_RT_RTOL + 1e-30)
        worst = max(worst, ((back - g).abs() / g.abs().clamp_min(1e-30))
                    .max().item())
        if (over > 0).any() or not torch.isfinite(back).all():
            fail(f"codec chain: round trip beyond {CODEC_RT_RTOL} of the "
                 f"gradient at {int((over > 0).sum())} positions")
    # the wire sum against the f32 sum, relative to |g1| + |g2| (a sum that
    # cancels has no relative error bound of its own)
    scale = (g1.abs() + g2.abs()).clamp_min(1e-30)
    sum_rel = ((total - (g1 + g2)).abs() / scale).max().item()
    report = {"elements": g1.numel(), "wire_bytes": 2 * g1.numel(),
              "round_trip_worst_rel": worst,
              "wire_sum_worst_vs_f32_sum": sum_rel,
              "zeros": int((g1 == 0).sum())}
    log(f"codec chain on the long-context gradient ({g1.numel()} elements, "
        f"{2 * g1.numel() / 1e6:.1f} MB on the wire): K5 x2, K7, K6 bit-equal "
        f"to the plain chain; round trip worst {worst:.3g} of a value (limit "
        f"{CODEC_RT_RTOL:.3g}); the wire sum differs from the f32 sum by "
        f"{sum_rel:.3g} of |g1| + |g2| at worst")
    return report, counts


# -- phase 3j: snapshots and resume ------------------------------------------

def snapshots_and_resume(device, folder):
    """Phase 3j on 3i's corpus at 3i's widths: A ``train_main -e 2``; B ``-e
    1 --checkpoint``; C a fresh ``--model/--state`` of B's pair ``-e 2``: C's
    losses equal A's last four within RESUME_RTOL, each run launching 8 K9 +
    8 delta + 8 K10 + 8 K11 a step and 8 K9 a validation forward; a model
    file without its state is never picked; greedy ``generate_main`` on B's
    model extends test sentences with ids in range, its words those of
    ``TransformerLM.generate`` on the loaded model.  Also the save and load
    time of the snapshot pair."""
    import shutil
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.dataset import Dictionary, read_sentence
    from bigdl_tpu_torch.models import transformer
    from bigdl_tpu_torch.optim import LocalOptimizer
    from bigdl_tpu_torch.utils import File, load_model_snapshot
    from bigdl_tpu_torch.utils.random_generator import RNG
    ck = os.path.join(folder, "ck")
    two = TM_FLAGS[:-2] + ["-e", "2"]
    saves = []
    real_checkpoint = LocalOptimizer._maybe_checkpoint

    def timed_checkpoint(self):
        t0 = time.perf_counter()
        real_checkpoint(self)
        saves.append(time.perf_counter() - t0)

    runs, by_path = {}, {}
    snap = f"{ck}/%s.{TM_STEPS}"             # B's pair, after its epoch
    for key, argv in (("A", two), ("B", TM_FLAGS + ["--checkpoint", ck]),
                      ("C", two + ["--model", snap % "model",
                                   "--state", snap % "state"])):
        RNG().set_seed(SEED + 600)           # one train/validation split
        LocalOptimizer._maybe_checkpoint = timed_checkpoint
        try:
            with LogArgs("bigdl_tpu_torch.optim", "Epoch ") as steps, \
                    LogArgs("bigdl_tpu_torch.optim", "%s is %r") as vals:
                ops.reset_launches()
                transformer.train_main(["-f", folder] + argv, device=device)
                counts = launches_now()
        finally:
            LocalOptimizer._maybe_checkpoint = real_checkpoint
        n = len(steps)
        expect_launches(f"train_main run {key}", counts,
                        {"attention_stream_fwd": 8 * n + 8 * len(vals),
                         "flash_bwd_delta": 8 * n,
                         "attention_stream_bwd_dq": 8 * n,
                         "attention_stream_bwd_dkv": 8 * n})
        runs[key] = [a[3] for a in steps]
        by_path[f"train_main_resume_{key}"] = counts
    if [len(runs[k]) for k in "ABC"] != [2 * TM_STEPS, TM_STEPS, TM_STEPS]:
        fail(f"resume: steps {[len(runs[k]) for k in 'ABC']}, want "
             f"{2 * TM_STEPS}, {TM_STEPS}, {TM_STEPS}")
    rel = max(abs(c - a) / abs(a)
              for c, a in zip(runs["C"], runs["A"][TM_STEPS:]))
    rel_b = max(abs(b - a) / abs(a) for b, a in zip(runs["B"], runs["A"]))
    if max(rel, rel_b) > RESUME_RTOL:
        fail(f"resume: C {runs['C']} against A's last {TM_STEPS} "
             f"{runs['A'][TM_STEPS:]} (worst {rel:.3g}), B {runs['B']} "
             f"against A's first (worst {rel_b:.3g}); limit {RESUME_RTOL}")
    t0 = time.perf_counter()
    model_snap = File.load(snap % "model")
    state_snap = File.load(snap % "state")
    load_s = time.perf_counter() - t0
    pair_bytes = sum(os.path.getsize(snap % f) for f in ("model", "state"))
    del model_snap, state_snap
    # a model file whose state never landed (a crash between the writes)
    shutil.copy(snap % "model", f"{ck}/model.{TM_STEPS + 4}")
    if LocalOptimizer._latest_file_snapshot(ck) != f".{TM_STEPS}":
        fail(f"resume: a torn pair was picked: "
             f"{LocalOptimizer._latest_file_snapshot(ck)}")
    # generation from B's model
    vocab = Dictionary(folder)
    with open(os.path.join(folder, "input.txt")) as f:
        lines = [f.readline().split()[:GEN_PROMPT_WORDS] for _ in range(2)]
    with open(os.path.join(folder, "test.txt"), "w") as f:
        f.write("\n".join(" ".join(w) for w in lines) + "\n")
    gen_argv = ["-f", folder, "--model", snap % "model",
                "--words", str(GEN_WORDS), "--temperature", "0"] + \
        TM_FLAGS[:-4]
    RNG().set_seed(SEED + 601)
    t0 = time.perf_counter()
    grown = transformer.generate_main(gen_argv, device=device)
    gen_s = time.perf_counter() - t0
    vocab_size = int(TM_FLAGS[1]) + 2
    model = transformer.TransformerLM(
        vocab_size, max_len=int(TM_FLAGS[9]), embed_dim=int(TM_FLAGS[3]),
        num_heads=int(TM_FLAGS[5]), num_layers=int(TM_FLAGS[7]))
    load_model_snapshot(model, snap % "model").evaluate()
    RNG().set_seed(SEED + 601)
    expected = []
    for words in read_sentence(folder):
        seq = [float(vocab.get_index(w)) for w in words]
        out = model.generate(torch.tensor([seq], dtype=torch.long) + 1,
                             max_new=GEN_WORDS, device=device)[0].tolist()
        if not all(1 <= t <= vocab_size for t in out):
            fail(f"generate_main: ids out of [1, {vocab_size}]: {out}")
        expected.append(" ".join(vocab.get_word(t) for t in
                                 seq + [float(t - 1) for t in out]))
    if grown != expected or [len(g.split()) for g in grown] != \
            [len(w) + GEN_WORDS for w in lines]:
        fail("generate_main: its sentences differ from greedy "
             "TransformerLM.generate on the loaded model")
    del model
    report = {"losses": runs, "resumed_worst_rel": rel,
              "first_epoch_worst_rel": rel_b,
              "save_s": max(saves), "load_s": load_s,
              "pair_bytes": pair_bytes, "generate_s": gen_s,
              "generated": [g.split()[-GEN_WORDS:] for g in grown]}
    return report, by_path


# -- phase 4: timings ---------------------------------------------------------

def time_forwards(clf, device):
    """Median ms of one bucket forward as a worker runs it (packed host
    rows to the device, predictions back to the host), per bucket."""
    rows = make_rows(max(BUCKETS), SEED + 7)
    out = {}
    for b in BUCKETS:
        x = clf._pack(rows[:b], size=b)
        out[b] = median_ms(lambda: clf._run(x).cpu(), device)
    return out


def time_kernels(device):
    """Per kernel, summed over one batch-32 forward's calls: median kernel
    time, bound, plain version, library call."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import (cross_map_lrn, lrn_plain, max_pool2d,
                                     max_pool2d_plain, pool_geometry)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device) \
        if device.type == "cuda" else None
    out = {}
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for _, shape, kh, kw, sh, sw, ph, pw, ceil in POOLS:
        x = torch.randn(shape, generator=gen, device=device)
        n, c, h, w = shape
        oh, ow, _, _ = pool_geometry(h, w, kh, kw, sh, sw, ph, pw, ceil)
        nbytes = 4 * (x.numel() + n * c * oh * ow)
        nops = n * c * oh * ow * kh * kw
        t["bound_ms"] += 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                   nops / F32_FLOPS)
        geom = (kh, kw, sh, sw, ph, pw, ceil)
        t["ms"] += median_ms(lambda: max_pool2d(x, *geom), device,
                             flush=flush)
        t["plain_ms"] += median_ms(lambda: max_pool2d_plain(x, *geom),
                                   device, flush=flush)
        t["library_ms"] += median_ms(
            lambda: F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw),
                                 ceil_mode=ceil), device, flush=flush)
    out["max_pool2d_fwd"] = dict(t, bound_by="bytes")
    t = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for _, shape, size, alpha, beta, k in LRNS:
        x = torch.randn(shape, generator=gen, device=device)
        nbytes = 4 * 2 * x.numel()
        nops = x.numel() * (2 * size + 6)
        t["bound_ms"] += 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                   nops / F32_FLOPS)
        t["ms"] += median_ms(lambda: cross_map_lrn(x, size, alpha, beta, k),
                             device, flush=flush)
        t["plain_ms"] += median_ms(lambda: lrn_plain(x, size, alpha, beta, k),
                                   device, flush=flush)
        t["library_ms"] += median_ms(
            lambda: F.local_response_norm(x, size, alpha, beta, k), device,
            flush=flush)
    out["lrn_fwd"] = dict(t, bound_by="bytes")
    return out


def time_train_kernels(device):
    """Per kernel, summed over one training step's calls at batch 32 in
    bf16: K1 with the index write, K2 with the scale write, K3 and K4;
    median kernel time, bound, plain version, library call."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import (cross_map_lrn, lrn_bwd, lrn_bwd_plain,
                                     lrn_plain, max_pool2d, max_pool2d_bwd,
                                     max_pool2d_bwd_plain, max_pool2d_plain)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device) \
        if device.type == "cuda" else None
    out = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "bound_by": "bytes"}
           for k in ("max_pool2d_fwd", "lrn_fwd", "max_pool2d_bwd",
                     "lrn_bwd")}

    def add(name, nbytes, nops, kern, plain, lib):
        t = out[name]
        t["bound_ms"] += 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                   nops / F32_FLOPS)
        t["ms"] += median_ms(kern, device, flush=flush)
        t["plain_ms"] += median_ms(plain, device, flush=flush)
        t["library_ms"] += median_ms(lib, device, flush=flush)

    for _, shape, kh, kw, sh, sw, ph, pw, ceil in POOLS:
        x = torch.randn(shape, generator=gen, device=device).to(bf16)
        geom = (kh, kw, sh, sw, ph, pw, ceil)
        _, idx = max_pool2d(x, *geom, return_indices=True)
        dy = torch.randn(tuple(idx.shape), generator=gen,
                         device=device).to(bf16)
        y64, idx64 = F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw),
                                  ceil_mode=ceil, return_indices=True)
        if y64.shape != idx.shape:
            fail(f"F.max_pool2d gives {tuple(y64.shape)} windows, the port "
                 f"{tuple(idx.shape)}: no library yardstick")
        nwin = idx.numel() * kh * kw
        add("max_pool2d_fwd", 2 * x.numel() + 3 * idx.numel(), nwin,
            lambda: max_pool2d(x, *geom, return_indices=True),
            lambda: max_pool2d_plain(x, *geom),
            lambda: F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw),
                                 ceil_mode=ceil, return_indices=True))
        add("max_pool2d_bwd", 3 * idx.numel() + 2 * x.numel(), nwin,
            lambda: max_pool2d_bwd(dy, idx, geom, shape[2], shape[3]),
            lambda: max_pool2d_bwd_plain(dy, idx, geom, shape[2], shape[3]),
            lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                dy, x, [kh, kw], [sh, sw], [ph, pw], [1, 1], ceil, idx64))
    for _, shape, size, alpha, beta, k in LRNS:
        x = torch.randn(shape, generator=gen, device=device).to(bf16)
        dy = torch.randn(shape, generator=gen, device=device).to(bf16)
        _, scale = cross_map_lrn(x, size, alpha, beta, k, return_scale=True)
        xr = x.clone().requires_grad_()
        yr = F.local_response_norm(xr, size, alpha, beta, k)
        add("lrn_fwd", 2 * 3 * x.numel(), x.numel() * (2 * size + 6),
            lambda: cross_map_lrn(x, size, alpha, beta, k,
                                  return_scale=True),
            lambda: lrn_plain(x, size, alpha, beta, k),
            lambda: F.local_response_norm(x, size, alpha, beta, k))
        add("lrn_bwd", 2 * 4 * x.numel(), x.numel() * (6 * size + 8),
            lambda: lrn_bwd(x, scale, dy, size, alpha, beta),
            lambda: lrn_bwd_plain(x, scale, dy, size, alpha, beta),
            lambda: torch.autograd.grad(yr, xr, dy, retain_graph=True))
    return out


QSTAGES = ("conv2", "3a/3b", "4a-4e", "5a/5b", "classifier")


def quant_stage(layer):
    """The Inception-v1 stage of a packed product, from its layer's name."""
    for prefix, stage in (("conv2", "conv2"), ("inception_3", "3a/3b"),
                          ("inception_4", "4a-4e"),
                          ("inception_5", "5a/5b")):
        if layer.startswith(prefix):
            return stage
    return "classifier"


_FLUSH_KERNELS = set()


def _profiled_us(run):
    """Device time in us by kernel (and copy) name of ``run()`` under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out[evt.key] = out.get(evt.key, 0.0) + us
    return out


def device_ms(fn, flush, reps=TIMING_REPS):
    """Device time of one ``fn()`` in ms from torch.profiler: every kernel
    it launches, summed, over ``reps`` calls each after an L2 flush (the
    flush's own kernels left out).  The profiler now and then misses a
    kernel, which only lowers a sum, so this takes the larger of two
    windows, and of four where both read nothing; None (not measured)
    where all four do."""
    for _ in range(3):  # the flush's own kernels, once the profiler is warm
        if _FLUSH_KERNELS:
            break
        _profiled_us(flush.zero_)
        _FLUSH_KERNELS.update(k for k, v in _profiled_us(flush.zero_).items()
                              if v > 0)
    fn()

    def run():
        for _ in range(reps):
            flush.zero_()
            fn()

    def flush_kernel(name):  # zero_ is a fill kernel (or a memset)
        return name in _FLUSH_KERNELS or "FillFunctor" in name or \
            name.startswith("Memset")

    us = 0.0
    for window in range(4):
        us = max(us, sum(v for name, v in _profiled_us(run).items()
                         if not flush_kernel(name)))
        if window and us > 0:
            return us / 1e3 / reps
    log("torch.profiler recorded no kernel of a timed call in four windows: "
        "its device time is not measured")
    return None


def host_ms(fn, reps=TIMING_REPS):
    """Median host time of one ``fn()`` in ms: perf_counter around the call
    with no synchronize, the card idle before each call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def quant_cases(prods):
    """``{(wrapper, bucket, stage, (M, K, N)): calls}``: K13 int8 at every
    product of the w8 forward (bf16 at both buckets, f32 at batch 32), and
    K13 e4m3 and K15 (both buckets) and K14 (batch 32) at the classifier,
    the one product each of those rungs runs."""
    cases = {}
    for b, ps in prods.items():
        for layer, kind, m, k, n, _ in ps:
            names = ["w8_matmul"] + (["w8_matmul_f32"] if b == BATCH else [])
            if kind == "linear":
                names += ["f8_matmul", "w4_matmul"] + \
                    (["a8_matmul"] if b == BATCH else [])
            for name in names:
                key = (name, b, quant_stage(layer), (m, k, n))
                cases[key] = cases.get(key, 0) + 1
    return cases


QSUM_KEYS = ("ms", "device_ms", "host_ms", "plain_ms", "library_ms",
             "library_device_ms", "bound_ms", "bytes_ms", "ops_ms")


def _quant_sums(rows):
    """Σ calls · value over ``rows`` for QSUM_KEYS (None if any is None)."""
    t = {"calls": sum(r["calls"] for r in rows)}
    for key in QSUM_KEYS:
        vals = [r[key] for r in rows]
        t[key] = None if any(v is None for v in vals) else sum(
            r["calls"] * r[key] for r in rows)
    t["bound_by"] = "bytes" if t["bytes_ms"] >= t["ops_ms"] else \
        "operations"
    return t


def time_quant_kernels(device, prods):
    """K13-K15 per distinct product of the quantized forward (``prods``:
    :func:`quant_products` per bucket, QUANT_CASES' wrappers): per product
    the kernel's CUDA-event median (L2 flushed between calls), its device
    time from torch.profiler, its wrapper's host time, the plain version's
    time (batch 32), and ``F.linear`` on the widened weight (K14:
    ``torch._int_mm`` + scale) by both clocks, beside the bound; the bf16
    kernel's plan where the package has one.  Returns ``(sums, rows)``:
    per wrapper (``w8_matmul_f32`` for K13 int8 in f32) the batch-32 sums
    over the forward's calls with ``"buckets"`` ({bucket: sums}) and
    ``"stages"`` ({bucket: {stage: sums}}), and the per-product rows."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import quant
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    bf16 = torch.bfloat16
    plan = getattr(quant, "bf16_plan", None)
    rows = []
    for (name, b, stage, (m, k, n)), c in sorted(quant_cases(prods).items()):
        dtype = torch.float32 if name == "w8_matmul_f32" else bf16
        xb = 2 if dtype == bf16 else 4
        x = torch.randn((m, k), generator=gen, device=device).to(dtype)
        w = torch.randn((n, k), generator=gen, device=device)
        if name == "a8_matmul":
            qt = quant.pack(w, sx=3.0 / 127)
            xq = quant.quantize_act(x, qt["sx"])
            s = qt["scale"] * qt["sx"]
            q8t = qt["q8"].t()
            nbytes = m * k + n * k + 4 * n + xb * m * n
            peak = INT8_OPS
            kern = lambda: quant.a8_matmul(xq, qt["q8"], s, dtype)
            plain = lambda: quant.int8_a8_matmul_plain(xq, qt["q8"], s,
                                                       dtype)
            lib = lambda: (torch._int_mm(xq, q8t).float() * s).to(dtype)
            try:        # the yardstick only: its shape rules may refuse
                lib()
            except RuntimeError as e:
                log(f"torch._int_mm refuses {(m, k, n)}: {e}")
                lib = None
        else:
            mode = {"w4_matmul": "w4", "f8_matmul": "f8"}.get(name, "w8")
            qt = quant.pack(w, mode=mode)
            wide = quant.unpack(qt, dtype)
            qbytes = n * ((k + 1) // 2) if mode == "w4" else n * k
            nbytes = xb * m * k + qbytes + 4 * n + xb * m * n
            peak = BF16_FLOPS if dtype == bf16 else F32_FLOPS
            if mode == "w4":
                kern = lambda: quant.w4_matmul(x, qt["q4"], qt["scale"], k)
                plain = lambda: quant.int4_matmul_plain(x, qt["q4"],
                                                        qt["scale"], k)
            else:
                q = qt["q8" if mode == "w8" else "f8"]
                fn = quant.w8_matmul if mode == "w8" else quant.f8_matmul
                kern = lambda: fn(x, q, qt["scale"])
                plain = lambda: quant.int8_matmul_plain(x, q, qt["scale"])
            lib = lambda: F.linear(x, wide)
        r = {"name": name, "bucket": b, "stage": stage, "M": m, "K": k,
             "N": n, "calls": c, "dtype": str(dtype).replace("torch.", ""),
             "ms": median_ms(kern, device, flush=flush),
             "device_ms": device_ms(kern, flush), "host_ms": host_ms(kern),
             "plain_ms": median_ms(plain, device, flush=flush)
             if b == BATCH else None,
             "library_ms": None if lib is None else
             median_ms(lib, device, flush=flush),
             "library_device_ms": None if lib is None else
             device_ms(lib, flush),
             "bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
             "ops_ms": 1e3 * 2 * m * n * k / peak}
        r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
        if plan is not None and dtype == bf16 and name != "a8_matmul":
            r["plan"] = plan(m, k, n, nibbles=name == "w4_matmul")._asdict()
        rows.append(r)
    out = {}
    for name in sorted({r["name"] for r in rows}):
        mine = [r for r in rows if r["name"] == name]
        t = _quant_sums([r for r in mine if r["bucket"] == BATCH])
        t["dtype"] = mine[0]["dtype"]
        t["buckets"] = {b: _quant_sums([r for r in mine if r["bucket"] == b])
                        for b in sorted({r["bucket"] for r in mine})}
        t["stages"] = {b: {s: _quant_sums([r for r in mine
                                           if r["bucket"] == b and
                                           r["stage"] == s])
                           for s in QSTAGES
                           if any(r["bucket"] == b and r["stage"] == s
                                  for r in mine)}
                       for b in t["buckets"]}
        out[name] = t
    return out, rows


def fmt_ms(v):
    """A time in ms for the log, or "not measured" (None)."""
    return "not measured" if v is None else f"{v:.4f} ms"


def log_quant_times(card, qtimes, qrows):
    """Phase 4's K13-K15 lines: per wrapper its batch-32 sums, per stage
    and bucket the bf16 K13 int8 sums, and every product in one line."""
    for name, t in qtimes.items():
        log(f"[{card}] {name} ({t['dtype']}, {t['calls']} calls of a batch-"
            f"{BATCH} quantized forward): events {t['ms']:.4f} ms, device "
            f"{fmt_ms(t['device_ms'])}, wrapper host {t['host_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}; bytes "
            f"{t['bytes_ms']:.4f}, operations {t['ops_ms']:.4f}), plain "
            f"{fmt_ms(t['plain_ms'])}, library events "
            f"{fmt_ms(t['library_ms'])}, device "
            f"{fmt_ms(t['library_device_ms'])}")
        for b, stages in t["stages"].items():
            if name == "w8_matmul":
                log(f"[{card}] {name} bucket {b} by stage (device / events, "
                    "kernel | library; bound ms): " + "; ".join(
                        f"{s} x{v['calls']} {fmt_ms(v['device_ms'])} / "
                        f"{fmt_ms(v['ms'])} | "
                        f"{fmt_ms(v['library_device_ms'])} / "
                        f"{fmt_ms(v['library_ms'])}; {v['bound_ms']:.4f}"
                        for s, v in stages.items()))
    log("quantized products: " + json.dumps(qrows))


def time_quant_convs(device, prods32):
    """The fused conv end to end (unfold + K13, bf16, batch 32) against
    cuDNN ``F.conv2d`` on the widened weight at the QCONVS layers, and the
    unfold alone; median ms each, L2 flushed."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import quant
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    out = {}
    for name, kind, m, k, n, geom in prods32:
        if name not in QCONVS:
            continue
        c, h, w, kh, kw, ph, pw = geom
        x = torch.randn((BATCH, c, h, w), generator=gen,
                        device=device).to(torch.bfloat16)
        qt = quant.pack(torch.randn((n, c, kh, kw), generator=gen,
                                    device=device))
        wide = quant.unpack(qt, torch.bfloat16)
        out[name] = {
            "M": m, "K": k, "N": n,
            "fused_ms": median_ms(lambda: quant.int8_conv2d(x, qt, (ph, pw)),
                                  device, flush=flush),
            "unfold_ms": median_ms(
                lambda: F.unfold(x, (kh, kw), padding=(ph, pw))
                .transpose(1, 2).reshape(m, k), device, flush=flush),
            "cudnn_ms": median_ms(lambda: F.conv2d(x, wide, padding=(ph, pw)),
                                  device, flush=flush)}
    return out


def attention_work(case, dtype):
    """(bytes, FLOPs) that a call needs: q, k, v (and the bias) read once
    and o written once; 4·D FLOPs per (query, key) pair the masks let
    through, counted from this case's causal mask and padded lengths."""
    _, b, h, hk, t, tk, d, causal, lengths = case
    eb = 2 if str(dtype).endswith("bfloat16") else 4
    nbytes = eb * (2 * b * h * t * d + 2 * b * hk * tk * d)
    if lengths is not None:
        nbytes += 4 * b * tk
    rows = [min(tk, L) if lengths is not None else tk
            for L in (lengths or [tk] * b)]
    pairs = 0
    for real in rows:
        if causal:   # query i sees keys [0, min(i + 1, real))
            full = min(t, real)
            pairs += full * (full + 1) // 2 + max(t - full, 0) * real
        else:
            pairs += t * real
    return nbytes, 4 * h * d * pairs


def sdpa_call(q, k, v, causal, bias):
    """The same attention as one ``F.scaled_dot_product_attention`` call
    (the yardstick only: the port never calls it): GQA heads expanded,
    padding as a boolean ``attn_mask`` combined with the causal one."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops.attention import expand_kv_heads
    k, v = expand_kv_heads(q, k, v)
    if bias is None:
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
    t, tk = q.shape[2], k.shape[2]
    keep = (bias > -1.0)[:, None, None, :]
    if causal:
        keep = keep & (torch.arange(t, device=q.device)[:, None] >=
                       torch.arange(tk, device=q.device)[None, :])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)


def time_attention(device):
    """K8 and K9 per call at the LM paths' shapes in bf16 (ATTN_PATH) and
    at ATTN_TIMED (both kernels at each): median kernel time with the L2
    flushed by CUDA events and by torch.profiler's device time, its bound
    (the bf16 tensor cores' or the f32 FFMA rate), the plain version and
    SDPA by both clocks; then K8 against K9 at rising T (bf16, causal, d
    64), where the reference's rule switches from K8 to K9 past T 2048."""
    import torch
    from bigdl_tpu_torch.ops import attention as attn
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    bf16 = torch.bfloat16
    runs = [(c[0], c[:9], "bfloat16",
             "attention_fwd" if c[0].endswith("K8") else
             "attention_stream_fwd") for c in ATTN_PATH]
    runs += [(f"{c[0]}, {k}", c[:9], c[9], k) for c in ATTN_TIMED
             for k in ("attention_fwd", "attention_stream_fwd")]
    out = {}
    for key, case, dt, name in runs:
        causal, dtype = case[7], getattr(torch, dt)
        q, k, v, bias = attention_operands(case, dtype, device, gen)
        if name == "attention_fwd":
            kern = lambda: attn.attention_fwd(q, k, v, causal)
            plain = lambda: attn.attention_reference(q, k, v, causal)
        else:
            kern = lambda: attn.attention_stream_fwd(q, k, v, causal, None,
                                                     bias)
            plain = lambda: attn.attention_stream_plain(q, k, v, causal,
                                                        None, bias)
        lib = sdpa_call(q, k, v, causal, bias)
        nbytes, flops = attention_work(case, dtype)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * flops / (BF16_FLOPS if dtype == bf16 else F32_FLOPS)
        out[key] = {
            "kernel": name, "shape": list(case[1:7]), "dtype": dt,
            "ms": median_ms(kern, device, flush=flush),
            "device_ms": device_ms(kern, flush),
            "plain_ms": median_ms(plain, device, reps=5, flush=flush),
            "library_ms": median_ms(lib, device, flush=flush),
            "library_device_ms": device_ms(lib, flush),
            "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        del q, k, v, bias
    sweep = []
    for b, t in ((8, 512), (8, 1024), (8, 2048), (4, 4096), (1, 8192),
                 (1, 16384)):
        case = ("sweep", b, LM_HEADS, LM_HEADS, t, t, 64, True, None)
        q, k, v, _ = attention_operands(case, bf16, device, gen)
        k8 = median_ms(lambda: attn.attention_fwd(q, k, v, True), device,
                       flush=flush)
        k9 = median_ms(lambda: attn.attention_stream_fwd(q, k, v, True),
                       device, flush=flush)
        sweep.append({"batch": b, "T": t, "k8_ms": k8, "k9_ms": k9,
                      "k8_over_k9": k8 / k9,
                      "bound_ms": 1e3 * attention_work(case, bf16)[1] /
                      BF16_FLOPS})
        del q, k, v
    return out, sweep


def flash_work(case, dtype):
    """(bytes, K10 FLOPs, K11 FLOPs) of a phase-2f case: q, o, dO, k, v and
    lse read once, dq (K10) or dk and dv (K11) written once; 6·D (K10) and
    8·D (K11) FLOPs per (query, key) pair and head the causal mask lets
    through."""
    _, b, h, hk, t, tk, d, causal, _ = case[:9]
    eb = 2 if str(dtype).endswith("bfloat16") else 4
    reads = eb * (3 * b * h * t * d + 2 * b * hk * tk * d) + 4 * b * h * t
    pairs = b * h * (sum(min(i + 1, tk) for i in range(t)) if causal
                     else t * tk)
    return ((reads + eb * b * h * t * d, reads + eb * 2 * b * hk * tk * d),
            6 * d * pairs, 8 * d * pairs)


def time_flash(device):
    """K9 with and without its LSE, the delta pass, K10 and K11 per call at
    FLASH_PATH (each in its dtype): median kernel time with the L2 flushed,
    the bound, the plain versions, and SDPA's backward (fwd + bwd less fwd,
    causal) as the library yardstick for both K10 and K11 and for their sum
    with the delta pass (K10 and K11 timed on a precomputed delta).  The
    delta pass's library call is ``torch.linalg.vecdot(do, o)`` in f32,
    held once against the plain version within FLASH_DELTA_RTOL of each
    row's sum |dO·O|; in bf16 it has none (a bf16 ``vecdot`` rounds its
    sums to bf16)."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import attention as attn
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    out = {}
    for i, case in enumerate(FLASH_PATH):
        dt = getattr(torch, case[9])
        q, k, v, bias, o, lse, do = flash_grads(case, dt, device,
                                                SEED + 500 + i)
        causal, scale = case[7], case[6] ** -0.5
        rate = BF16_FLOPS if case[9] == "bfloat16" else F32_FLOPS
        (b10, b11), f10, f11 = flash_work(case, dt)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        sdpa_fwd = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), device, flush=flush)
        sdpa_both = median_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal),
            (qg, kg, vg), do), device, flush=flush)
        lib = sdpa_both - sdpa_fwd
        plain_bwd = median_ms(lambda: attn.flash_bwd_plain(
            q, k, v, o, lse, do, causal, scale), device, reps=3, flush=flush)
        row = {"shape": list(case[1:7]), "dtype": case[9],
               "k9_ms": median_ms(lambda: attn._launch(
                   attn.attention_stream_fwd, "bigdl_attention_stream_fwd",
                   q, k, v, None, causal, scale), device, flush=flush),
               "k9_lse_ms": median_ms(lambda: attn._launch(
                   attn.attention_stream_fwd, "bigdl_attention_stream_fwd",
                   q, k, v, None, causal, scale, with_lse=True), device,
                   flush=flush),
               "k9_lse_plain_ms": median_ms(
                   lambda: attn.attention_stream_plain(
                       q, k, v, causal, scale, with_lse=True), device,
                   reps=3, flush=flush),
               "sdpa_fwd_ms": sdpa_fwd, "sdpa_fwd_bwd_ms": sdpa_both}
        delta = attn.flash_bwd_delta(o, do)
        delta_lib = None
        if case[9] == "float32":
            derr = (torch.linalg.vecdot(do, o, dim=-1) -
                    attn.flash_bwd_delta_plain(o, do)).abs()
            if not bool((derr <= FLASH_DELTA_RTOL * (do * o).abs().sum(
                    dim=-1)).all()):
                fail(f"torch.linalg.vecdot at {case[0]}: max |err| "
                     f"{derr.max().item():.3g} against the plain delta")
            delta_lib = median_ms(lambda: torch.linalg.vecdot(do, o, dim=-1),
                                  device, flush=flush)
        eb = do.element_size()
        for name, fn, plain, nbytes, flops, library in (
                ("flash_bwd_delta", lambda: attn.flash_bwd_delta(o, do),
                 median_ms(lambda: attn.flash_bwd_delta_plain(o, do), device,
                           flush=flush),
                 2 * eb * o.numel() + 4 * lse.numel(), 2 * o.numel(),
                 delta_lib),
                ("attention_stream_bwd_dq",
                 lambda: attn.attention_stream_bwd_dq(
                     q, k, v, o, lse, do, causal, scale, delta=delta),
                 plain_bwd, b10, f10, lib),
                ("attention_stream_bwd_dkv",
                 lambda: attn.attention_stream_bwd_dkv(
                     q, k, v, o, lse, do, causal, scale, delta=delta),
                 plain_bwd, b11, f11, lib)):
            bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, \
                1e3 * flops / rate
            row[name] = {"ms": median_ms(fn, device, flush=flush),
                         "plain_ms": plain, "library_ms": library,
                         "bound_ms": max(bytes_ms, ops_ms),
                         "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                         "bound_by": "bytes" if bytes_ms >= ops_ms
                         else "operations"}
        row["bwd_sum_ms"] = sum(row[n]["ms"] for n in (
            "flash_bwd_delta", "attention_stream_bwd_dq",
            "attention_stream_bwd_dkv"))
        row["sdpa_bwd_ms"] = lib
        out[case[0]] = row
        del q, k, v, o, lse, do, qg, kg, vg, delta
    return out


def time_codec(device):
    """K5, K6 and K7 per call at CODEC_N elements: median kernel time with
    the L2 flushed, the bytes bound (6 bytes an element: each input read
    once, the output written once), the plain versions and, for K6, the
    one PyTorch call that computes the same function
    (``u.view(torch.bfloat16).float()``), and for K5 (the high half of each
    word, ``x.view(torch.int16)[1::2].contiguous()`` on this little-endian
    card, held bit-equal to the plain version here).  No one call computes
    K7."""
    import torch
    from bigdl_tpu_torch import ops
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 850)
    x = torch.randn(CODEC_N, generator=gen, device=device)
    u = ops.fp16_compress_reference(x)
    v = ops.fp16_compress_reference(torch.randn(CODEC_N, generator=gen,
                                                device=device))
    bound = 1e3 * 6 * CODEC_N / HBM_BYTES_PER_S

    def high_halves():
        return x.view(torch.int16)[1::2].contiguous()

    if not torch.equal(high_halves().view(torch.uint16).to(torch.int32),
                       ops.fp16_compress_reference(x).to(torch.int32)):
        fail("x.view(torch.int16)[1::2] is not K5's function on this card")
    out = {}
    for name, kern, plain, lib in (
            ("fp16_compress", lambda: ops.fp16_compress(x),
             lambda: ops.fp16_compress_reference(x), high_halves),
            ("fp16_decompress", lambda: ops.fp16_decompress(u),
             lambda: ops.fp16_decompress_reference(u),
             lambda: u.view(torch.bfloat16).float()),
            ("fp16_add", lambda: ops.fp16_add(u, v),
             lambda: ops.fp16_add_plain(u, v), None)):
        out[name] = {"ms": median_ms(kern, device, flush=flush),
                     "plain_ms": median_ms(plain, device, flush=flush),
                     "library_ms": None if lib is None else
                     median_ms(lib, device, flush=flush),
                     "bound_ms": bound, "bytes_ms": bound, "ops_ms": 0.0,
                     "bound_by": "bytes", "elements": CODEC_N}
    return out


def time_lm(score_model, long_model, gen_model, prompt, device):
    """Scoring tokens/s (one bf16 forward, median of 5) at both
    configurations, generation new tokens/s (median of 3), and a profiler
    breakdown of one scoring forward."""
    import torch
    ids = torch.from_numpy(lm_ids((LM_BATCH, LM_T), SEED + 52)).to(device)
    long_ids = torch.from_numpy(lm_ids((1, LONG_T), SEED + 53,
                                       LONG_VOCAB)).to(device)
    out = {}
    with torch.inference_mode():
        for name, model, x in (("score", score_model, ids),
                               ("long", long_model, long_ids)):
            ms = median_ms(lambda: model(x), device, reps=5)
            out[name] = {"forward_ms": ms,
                         "tokens_per_s": x.numel() / ms * 1e3}
        prof = device_profile(lambda: score_model(ids), 1)
    prof["busy_share"] = prof["device_ms"] / out["score"]["forward_ms"]
    out["score"]["profile"] = prof
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_model.generate(prompt, GEN_NEW, cache_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    out["generate"] = {"ms": ms, "new_tokens_per_s":
                       prompt.shape[0] * GEN_NEW / ms * 1e3}
    return out


def paged_work(q, k, pages, positions):
    """(bytes, FLOPs) a K12 call needs: the K/V of each row's visible keys
    read once per (row, KV head), q, the output, the table and the
    positions once; 4·D FLOPs per visible (query, key) pair and head."""
    h, d = q.shape[1], q.shape[3]
    hkv, ps = k.shape[1], k.shape[2]
    length = pages.shape[1] * ps
    seen = (positions.long() + 1).clamp(max=length)
    nbytes = (int(seen.amax(dim=1).sum()) * hkv * d * 2 * k.element_size() +
              q.numel() * q.element_size() + q.numel() * k.element_size() +
              4 * (pages.numel() + positions.numel()))
    return nbytes, 4 * d * h * int(seen.sum())


def time_paged(device):
    """K12 per call at the path's decode shape and its two prefill shapes
    (bf16): median kernel time with the L2 flushed, its bound, the plain
    version (which gathers the view) and SDPA on the pre-gathered view
    with the boolean mask (the gather excluded from its time)."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import attention as attn
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    bf16 = torch.bfloat16
    out = {}
    for key, case in (("decode", paged_decode_case()),
                      ("prefill_512", PAGED_RAGGED[0]),
                      ("prefill_128", PAGED_RAGGED[1])):
        q, k, v, pages, pos, scale = paged_operands(case, bf16, bf16, device,
                                                    SEED + 90)
        b, h, s, d = q.shape
        ps, lp = k.shape[2], pages.shape[1]
        # the pre-gathered view, trash zeroed, heads expanded, and the mask
        tmask = (pages.long() == k.shape[0] - 1).repeat_interleave(
            ps, dim=1)[:, None, :, None]
        kk, vv = (torch.where(tmask, 0, x[pages.long()].transpose(1, 2)
                              .reshape(b, -1, lp * ps, d)) for x in (k, v))
        kk, vv = attn.expand_kv_heads(q, kk, vv)
        mask = (torch.arange(lp * ps, device=device)[None, None, :] <=
                pos.long()[:, :, None])[:, None]
        nbytes, flops = paged_work(q, k, pages, pos)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * flops / BF16_FLOPS
        out[key] = {
            "case": case[0], "shape": [b, h, k.shape[1], s, d, ps, lp],
            "dtype": "bfloat16",
            "ms": median_ms(lambda: attn.paged_attention(
                q, k, v, pages, pos, scale), device, flush=flush),
            "plain_ms": median_ms(lambda: attn.paged_attention_plain(
                q, k, v, pages, pos, scale), device, reps=5, flush=flush),
            "library_ms": median_ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, attn_mask=mask, scale=scale), device,
                flush=flush),
            "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        del q, k, v, kk, vv
    return out


def time_continuous(model, prompts, budgets, kw, device):
    """The traffic again through a fresh generator under the profiler
    (device time by kernel; the busy share against the unprofiled run),
    then the same requests through ``TransformerLM.generate`` in static
    waves of CG_SLOTS in arrival order, each decoding the traffic's
    largest budget, as bench_serve.py's static mode does (every request of
    a wave resolves when the wave ends)."""
    import torch
    from bigdl_tpu_torch.serving import ContinuousGenerator
    with ContinuousGenerator(model, cache_dtype=torch.bfloat16, **kw) as g:
        prof = device_profile(lambda: drive_continuous(g, prompts, budgets),
                              1)
    top = max(budgets)
    done = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in range(0, len(prompts), CG_SLOTS):
        x = torch.from_numpy(np.stack(prompts[w:w + CG_SLOTS])).to(device)
        model.generate(x, top, cache_dtype=torch.bfloat16, device=device)
        torch.cuda.synchronize()
        done += [time.perf_counter() - t0] * x.shape[0]
    wall = time.perf_counter() - t0
    static = {"wall_s": wall, "new_tokens_per_s": sum(budgets) / wall,
              "latency_p50_ms": 1e3 * sorted(done)[(len(done) - 1) // 2],
              "latency_max_ms": 1e3 * max(done), "decoded_per_request": top}
    return prof, static


def profile_train_steps(device, mixed, steps=3):
    """Device time by kernel over ``steps`` training steps after as many
    warm-up steps (:func:`device_profile`)."""
    from bigdl_tpu_torch.models import Inception_v1
    from bigdl_tpu_torch.optim import Trigger
    opt = make_trainer(Inception_v1(CLASSES, dropout=0.4).reset(SEED),
                       make_samples(TRAIN_SAMPLES, SEED + 100), BATCH, steps,
                       mixed, device)
    opt.optimize()
    opt.set_end_when(Trigger.max_iteration(2 * steps))
    return device_profile(opt.optimize, steps)


def profile_forward(clf, device, bucket, reps=3):
    """Device time by kernel of one bucket forward as a worker runs it,
    over ``reps`` forwards after :func:`time_forwards` warmed it."""
    x = clf._pack(make_rows(bucket, SEED + 7), size=bucket)

    def run():
        for _ in range(reps):
            clf._run(x).cpu()
    return device_profile(run, reps)


def device_profile(fn, n):
    """``torch.profiler`` over ``fn()``, which runs ``n`` steps or forwards:
    the summed kernel and copy time per step and the kernels that take the
    most of it.  The profiler slows the host, so the busy share is taken
    against an unprofiled time by the caller."""
    kernels = {name: us / 1e3 / n for name, us in _profiled_us(fn).items()
               if us > 0}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"device_ms": sum(kernels.values()),
            "htod_ms": sum(ms for name, ms in kernels.items()
                           if name.startswith("Memcpy HtoD")),
            "top": [[name[:90], ms] for name, ms in top]}


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


KERNELS = [
    {"name": "max_pool2d_fwd", "wrapper": "max_pool2d", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/max_pool.cu",
     "replaces": "bigdl_tpu/ops/pooling.py:99"},
    {"name": "lrn_fwd", "wrapper": "cross_map_lrn", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/lrn.cu",
     "replaces": "bigdl_tpu/ops/lrn.py:123"},
    {"name": "max_pool2d_bwd", "wrapper": "max_pool2d_bwd", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/max_pool.cu",
     "replaces": "bigdl_tpu/ops/pooling.py:130"},
    {"name": "lrn_bwd", "wrapper": "lrn_bwd", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/lrn.cu",
     "replaces": "bigdl_tpu/ops/lrn.py:133"},
    {"name": "w8_matmul", "wrapper": "w8_matmul", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/quant_matmul.cu",
     "replaces": "bigdl_tpu/ops/quant.py:417"},
    {"name": "f8_matmul", "wrapper": "f8_matmul", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/quant_matmul.cu",
     "replaces": "bigdl_tpu/ops/quant.py:417"},
    {"name": "a8_matmul", "wrapper": "a8_matmul", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/quant_matmul.cu",
     "replaces": "bigdl_tpu/ops/quant.py:459"},
    {"name": "w4_matmul", "wrapper": "w4_matmul", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/quant_matmul.cu",
     "replaces": "bigdl_tpu/ops/quant.py:441"},
    {"name": "attention_fwd", "wrapper": "attention_fwd", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/attention.cu",
     "replaces": "bigdl_tpu/ops/attention.py:117"},
    {"name": "attention_stream_fwd", "wrapper": "attention_stream_fwd",
     "route": "cuda", "source": "bigdl_tpu_torch/csrc/attention.cu",
     "replaces": "bigdl_tpu/ops/attention.py:207"},
    {"name": "paged_attention", "wrapper": "paged_attention",
     "route": "cuda", "source": "bigdl_tpu_torch/csrc/paged_attention.cu",
     "replaces": "bigdl_tpu/ops/attention.py:782"},
    {"name": "attention_stream_bwd_dq", "wrapper": "attention_stream_bwd_dq",
     "route": "cuda", "source": "bigdl_tpu_torch/csrc/flash_attention_bwd.cu",
     "replaces": "bigdl_tpu/ops/attention.py:363"},
    {"name": "attention_stream_bwd_dkv",
     "wrapper": "attention_stream_bwd_dkv", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/flash_attention_bwd.cu",
     "replaces": "bigdl_tpu/ops/attention.py:415"},
    # a helper of K10/K11 with no TPU kernel of its own: the delta that
    # _bwd_dq_kernel and _bwd_dkv_kernel recomputed per block
    {"name": "flash_bwd_delta", "wrapper": "flash_bwd_delta", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/flash_attention_bwd.cu",
     "replaces": "bigdl_tpu/ops/attention.py:389"},
    {"name": "fp16_compress", "wrapper": "fp16_compress", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/fp16_codec.cu",
     "replaces": "bigdl_tpu/ops/fp16.py:59"},
    {"name": "fp16_decompress", "wrapper": "fp16_decompress",
     "route": "cuda", "source": "bigdl_tpu_torch/csrc/fp16_codec.cu",
     "replaces": "bigdl_tpu/ops/fp16.py:64"},
    {"name": "fp16_add", "wrapper": "fp16_add", "route": "cuda",
     "source": "bigdl_tpu_torch/csrc/fp16_codec.cu",
     "replaces": "bigdl_tpu/ops/fp16.py:69"},
]
TIME_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "a machine with a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bigdl_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    # full float32 everywhere, so the card and the CPU compute alike
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 1
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.load()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc "
        f"{' '.join(_build.ARCH)}, {len(_build.sources())} sources)")

    # phase 2, 2b and 2c; 2c at the products of the w8 forward
    from bigdl_tpu_torch.ops import quant
    probe = quant.quantize_model(build_model().to(device), "w8",
                                 cast_rest=torch.bfloat16)
    prods = {b: quant_products(probe, device, b, torch.bfloat16)
             for b in BUCKETS}
    del probe
    lin = [(m, k, n) for b in BUCKETS for _, kind, m, k, n, _ in prods[b]
           if kind == "linear"]
    path_shapes = {"w8_matmul": [(m, k, n) for b in BUCKETS
                                 for _, _, m, k, n, _ in prods[b]],
                   "f8_matmul": lin, "a8_matmul": lin, "w4_matmul": lin}
    errs, cases, misses = check_kernels(device)
    for d, more in zip((errs, cases, misses), check_backward_kernels(device)):
        d.update(more)
    for d, more in zip((errs, cases, misses),
                       check_quant_kernels(device, path_shapes)):
        d.update(more)
    log_quant_plans(path_shapes)
    for d, more in zip((errs, cases, misses),
                       check_attention_kernels(device)):
        d.update(more)
    for d, more in zip((errs, cases, misses), check_paged_kernel(device)):
        d.update(more)
    for d, more in zip((errs, cases, misses), check_flash_kernels(device)):
        d.update(more)
    for d, more in zip((errs, cases, misses), check_codec_kernels(device)):
        d.update(more)
    # phase 3, 3b, 3c and 3d: each path's launches counted from 0
    report, serve_launches = serve(device)
    train_report, train_launches = train(device)
    train_report["card_vs_cpu"] = train_vs_cpu(device)
    qreport, quant_launches, qclf = serve_quantized(device)
    for mode, r in qreport["rungs"].items():
        log(f"[{card}] rung {mode} (bf16 activations, batch {BATCH}): top-1 "
            "agreement with the bf16 forward "
            f"{r['top1_agreement_vs_bf16']:.4f}, mean |dlogp| "
            f"{r['mean_abs_dlogp_vs_bf16']:.5f}, resident "
            f"{r['resident_ratio_vs_bf16']:.4f} of the bf16 tree (budget "
            f"{r['budget']['max_resident_ratio_vs_bf16']}), bytes "
            f"{r['bytes_by_dtype']}")
    lm_report, lm_launches, score_model, long_model = lm_scoring(device)
    lm_report["head_dim_256"], more = lm_head_dim_256(device)
    lm_launches.update(more)
    gen_report, gen_launches, gen_model, prompt = lm_generation(device)
    lm_launches.update(gen_launches)
    cg_report, cg_launches, cg_run = continuous_serving(device)
    lm_launches.update(cg_launches)
    # phase 3h and 3i: TransformerLM training
    long_report, long_launches = long_context_training(device)
    lm_launches.update(long_launches)
    for key, r in long_report.items():
        if key in ("remat", "no_remat"):
            log(f"[{card}] long-context training ({key}, bf16, T {LONG_T}, "
                f"{LM_LAYERS} layers, {r['steps']} steps): "
                f"{r['ms_per_step']:.1f} ms a step, "
                f"{r['tokens_per_s']:.0f} tokens/s, loss "
                f"{r['first_loss']:.4f} -> {r['last_loss']:.4f}, launches a "
                f"step {r['launches_per_step']}")
    p = long_report["profile"]
    log(f"[{card}] long-context training profile ({1 + LONG_ITERS} steps): "
        f"device {p['device_ms']:.1f} ms a step ({p['htod_ms']:.1f} of it "
        f"the model's upload), busy share {p['busy_share']:.3f} of the "
        f"{long_report['remat']['ms_per_step']:.1f} ms step; top kernels "
        "(ms a step): " + json.dumps(p["top"]))
    tm_report, lm_launches["train_main"], (resume_report, resume_launches) \
        = train_main_long(device)
    lm_launches.update(resume_launches)
    losses = resume_report["losses"]
    log(f"[{card}] snapshots and resume (train_main f32, "
        f"{' '.join(TM_FLAGS[:-2])}): A -e 2 {losses['A']}; B -e 1 --checkpoint {losses['B']}; C "
        f"--model/--state of B's pair -e 2 {losses['C']}: C within "
        f"{resume_report['resumed_worst_rel']:.3g} of A's last {TM_STEPS} "
        f"(limit {RESUME_RTOL}), B within "
        f"{resume_report['first_epoch_worst_rel']:.3g} of A's first; "
        f"snapshot pair {resume_report['pair_bytes'] / 1e6:.1f} MB, save "
        f"{resume_report['save_s']:.3f} s, load {resume_report['load_s']:.3f}"
        f" s; generate_main (greedy, {GEN_WORDS} words after "
        f"{GEN_PROMPT_WORDS}) {resume_report['generate_s']:.2f} s, equal to "
        "TransformerLM.generate on the loaded model")
    # phase 3k: the codec on the long-context model's gradients
    codec_report, lm_launches["codec"] = codec_chain(device)
    log(f"[{card}] train_main (f32, {' '.join(TM_FLAGS)}): "
        f"{len(tm_report['losses'])} steps, losses {tm_report['losses']}, "
        f"validation loss {tm_report['validation_loss']:.4f}, step "
        f"{tm_report['step_ms_median_after_first']:.1f} ms (median after the "
        f"first; {tm_report['step_ms'][0]:.1f} ms the first), launches "
        f"{tm_report['launches']}")
    # phase 4
    times = time_kernels(device)
    train_times = time_train_kernels(device)
    fwd_ms = time_forwards(report.pop("classifier"), device)
    for b in BUCKETS:
        log(f"[{card}] forward bucket {b}: {fwd_ms[b]:.3f} ms median of "
            f"{TIMING_REPS} ({b / fwd_ms[b] * 1e3:.1f} images/s)")
    report["forward_ms"] = fwd_ms
    qfwd_ms = time_forwards(qclf, device)
    for b in BUCKETS:
        log(f"[{card}] w8 bf16 forward bucket {b}: {qfwd_ms[b]:.3f} ms "
            f"median of {TIMING_REPS} ({b / qfwd_ms[b] * 1e3:.1f} images/s)")
    qreport["forward_ms"] = qfwd_ms
    for b in BUCKETS:
        p = profile_forward(qclf, device, b)
        p["busy_share"] = p["device_ms"] / qfwd_ms[b]
        log(f"[{card}] w8 bf16 forward profile bucket {b}: device "
            f"{p['device_ms']:.3f} ms per forward, busy share "
            f"{p['busy_share']:.3f} of the {qfwd_ms[b]:.3f} ms forward; top "
            "kernels and copies (ms per forward): " + json.dumps(p["top"]))
        qreport[f"profile_bucket_{b}"] = p
    qtimes, qrows = time_quant_kernels(device, prods)
    log_quant_times(card, qtimes, qrows)
    qreport["convs"] = time_quant_convs(device, prods[BATCH])
    for name, t in qreport["convs"].items():
        log(f"[{card}] fused conv {name} (bf16, batch {BATCH}, M {t['M']} K "
            f"{t['K']} N {t['N']}): unfold + K13 {t['fused_ms']:.4f} ms "
            f"(unfold alone {t['unfold_ms']:.4f}), cuDNN on the widened "
            f"weight {t['cudnn_ms']:.4f} ms")
    log("quantized serving: " + json.dumps(qreport))
    for b, r in report["per_bucket"].items():
        log(f"[{card}] serving bucket {b} (closed loop, {r['waves']} waves "
            f"of {b}): {r['images_per_s']:.1f} images/s, request p50 "
            f"{r['p50_ms']:.2f} ms, max {r['max_ms']:.2f} ms "
            f"({r['images']} requests)")
    log("serving: " + json.dumps(report))
    train_report["step_ms_f32"] = train_f32_step_ms(device)
    for what, key in (("bf16 mixed", "step_ms"), ("float32", "step_ms_f32")):
        ms = train_report[key]
        log(f"[{card}] train step ({what}, batch {BATCH}, median of the "
            f"last {TIMED_STEPS} of {TRAIN_STEPS}): {ms:.3f} ms "
            f"({BATCH / ms * 1e3:.1f} images/s)")
    for what, mixed, key in (("bf16 mixed", True, "step_ms"),
                             ("float32", False, "step_ms_f32")):
        p = profile_train_steps(device, mixed)
        p["busy_share"] = p["device_ms"] / train_report[key]
        log(f"[{card}] train step profile ({what}, batch {BATCH}): device "
            f"{p['device_ms']:.3f} ms per step, busy share "
            f"{p['busy_share']:.3f} of the {train_report[key]:.3f} ms step; "
            "top kernels and copies (ms per step): " + json.dumps(p["top"]))
        train_report["profile_" + key] = p
    log("training: " + json.dumps(train_report))
    attn_times, sweep = time_attention(device)
    for name, t in attn_times.items():
        log(f"[{card}] {t['kernel']} at {name} {t['shape']} ({t['dtype']}, "
            f"per call): {t['ms']:.4f} ms, device {fmt_ms(t['device_ms'])}, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}; bytes "
            f"{t['bytes_ms']:.4f}, operations {t['ops_ms']:.4f}), plain "
            f"{t['plain_ms']:.3f} ms, SDPA {t['library_ms']:.4f} ms, device "
            f"{fmt_ms(t['library_device_ms'])}")
    for r in sweep:
        log(f"[{card}] K8 vs K9 (bf16, causal, batch {r['batch']}, 8 heads, "
            f"T {r['T']}, d 64): K8 {r['k8_ms']:.4f} ms, K9 "
            f"{r['k9_ms']:.4f} ms, K8/K9 {r['k8_over_k9']:.3f}, bound "
            f"{r['bound_ms']:.4f} ms")
    lm_report["timings"] = time_lm(score_model, long_model, gen_model,
                                   prompt, device)
    lt = lm_report["timings"]
    log(f"[{card}] LM scoring forward (bf16, {LM_BATCH} x {LM_T}): "
        f"{lt['score']['forward_ms']:.3f} ms "
        f"({lt['score']['tokens_per_s']:.0f} tokens/s); long context (1 x "
        f"{LONG_T}): "
        f"{lt['long']['forward_ms']:.3f} ms ({lt['long']['tokens_per_s']:.0f} "
        f"tokens/s); generation ({LM_BATCH} x {GEN_NEW} new after "
        f"{GEN_PROMPT}): {lt['generate']['ms']:.1f} ms "
        f"({lt['generate']['new_tokens_per_s']:.1f} new tokens/s)")
    p = lt["score"]["profile"]
    log(f"[{card}] LM scoring forward profile: device {p['device_ms']:.3f} ms"
        f", busy share {p['busy_share']:.3f}; top ops (ms per forward): "
        + json.dumps(p["top"]))
    lm_report["generation"] = gen_report
    lm_report["kernel_sweep"] = sweep
    log("transformer LM: " + json.dumps(lm_report))
    paged_times = time_paged(device)
    for key, t in paged_times.items():
        log(f"[{card}] paged_attention at {t['case']} {t['shape']} (bf16, "
            f"per call): {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}; bytes {t['bytes_ms']:.4f}, operations "
            f"{t['ops_ms']:.4f}), plain {t['plain_ms']:.3f} ms, SDPA on the "
            f"pre-gathered view {t['library_ms']:.4f} ms")
    cg_prof, cg_static = time_continuous(*cg_run, device)
    cg_prof["busy_share"] = cg_prof["device_ms"] / (1e3 * cg_report["wall_s"])
    cg_report.update(profile=cg_prof, static_waves=cg_static)
    log(f"[{card}] continuous serving (bf16 weights and pool, "
        f"{CG_REQUESTS} requests, {sum(cg_run[2])} new tokens): "
        f"{cg_report['new_tokens_per_s']:.1f} new tokens/s, request p50 "
        f"{cg_report['latency_p50_ms']:.1f} ms, max "
        f"{cg_report['latency_max_ms']:.1f} ms, mean slot occupancy "
        f"{cg_report['mean_slot_occupancy']:.3f}, {cg_report['chunks']} "
        f"chunks, prefix hit rate {cg_report['prefix']['hit_rate']:.3f}; "
        f"profiled run: device {cg_prof['device_ms']:.1f} ms, busy share "
        f"{cg_prof['busy_share']:.3f} (of the unprofiled wall); top: "
        + json.dumps(cg_prof["top"]))
    log(f"[{card}] static waves of {CG_SLOTS} through generate (bf16, each "
        f"decoding {cg_static['decoded_per_request']}): "
        f"{cg_static['new_tokens_per_s']:.1f} new tokens/s, request p50 "
        f"{cg_static['latency_p50_ms']:.1f} ms, max "
        f"{cg_static['latency_max_ms']:.1f} ms")
    log("continuous serving: " + json.dumps(cg_report))
    flash_times = time_flash(device)
    for name, t in flash_times.items():
        log(f"[{card}] flash attention at {name} {t['shape']} (per call): K9 "
            f"{t['k9_ms']:.4f} ms, K9 with LSE {t['k9_lse_ms']:.4f} ms (plain "
            f"{t['k9_lse_plain_ms']:.3f} ms); SDPA forward "
            f"{t['sdpa_fwd_ms']:.4f} ms, forward + backward "
            f"{t['sdpa_fwd_bwd_ms']:.4f} ms")
        for k in ("flash_bwd_delta", "attention_stream_bwd_dq",
                  "attention_stream_bwd_dkv"):
            r = t[k]
            plain = "delta alone" if k == "flash_bwd_delta" else \
                "dq, dk, dv together"
            lib = "none" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f} ms (" + (
                    "torch.linalg.vecdot" if k == "flash_bwd_delta" else
                    "SDPA backward, dq, dk, dv together") + ")"
            log(f"[{card}] {k} at {name}: {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}; bytes "
                f"{r['bytes_ms']:.4f}, operations {r['ops_ms']:.4f}), plain "
                f"({plain}) {r['plain_ms']:.3f} ms, library {lib}")
        ratio = t["bwd_sum_ms"] / t["sdpa_bwd_ms"]
        log(f"[{card}] flash backward at {name}: delta + K10 + K11 "
            f"{t['bwd_sum_ms']:.4f} ms, SDPA backward "
            f"{t['sdpa_bwd_ms']:.4f} ms ({ratio:.2f}x)")
    long_report["kernel_times"] = flash_times
    long_report["train_main"] = tm_report
    long_report["snapshots_and_resume"] = resume_report
    codec_times = time_codec(device)
    for name, t in codec_times.items():
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"[{card}] {name} at {CODEC_N} elements (per call): "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes), plain "
            f"{t['plain_ms']:.4f} ms, library {lib} ms")
    codec_report["kernel_times"] = codec_times
    log("fp16 codec: " + json.dumps(codec_report))
    log("transformer LM training: " + json.dumps(long_report))
    for where, tt in (("serving shapes, f32", times),
                      ("training shapes, bf16", train_times)):
        for name, t in tt.items():
            log(f"[{card}] {name} ({where}, per step): {t['ms']:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
                f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms")
    kernels = []
    for k in KERNELS:
        name, wrapper = k["name"], k["wrapper"]
        by_path = {"serve": serve_launches[wrapper],
                   "train": train_launches[wrapper]}
        by_path.update({p: v[wrapper] for p, v in quant_launches.items()})
        by_path.update({p: v[wrapper] for p, v in lm_launches.items()})
        entry = {"name": name, "route": k["route"], "source": k["source"],
                 "replaces": k["replaces"],
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": errs[name], "match": misses[name] == 0,
                 "cases": cases[name], "mismatches": misses[name]}
        if name in times:        # forward kernels: serving shapes, f32
            entry.update({key: times[name][key] for key in TIME_KEYS})
            entry["train"] = dict(train_times[name], dtype="bfloat16")
        elif wrapper in ("attention_fwd", "attention_stream_fwd"):
            # per call at the LM path's shape, bf16 (K9: the padded LM)
            key = ATTN_PATH[0][0] if wrapper == "attention_fwd" else \
                ATTN_PATH[1][0]
            entry.update({k2: attn_times[key][k2] for k2 in TIME_KEYS +
                          ("device_ms", "library_device_ms")})
            entry["shape"] = attn_times[key]["shape"]
            entry["other_shapes"] = {
                n: t for n, t in attn_times.items()
                if t["kernel"] == wrapper and n not in
                (ATTN_PATH[0][0], ATTN_PATH[1][0], ATTN_PATH[2][0])}
            if wrapper == "attention_stream_fwd":
                entry["long_context"] = attn_times[ATTN_PATH[2][0]]
                entry["with_lse"] = {
                    "max_abs_err": errs["attention_stream_fwd_lse"],
                    "cases": cases["attention_stream_fwd_lse"],
                    "mismatches": misses["attention_stream_fwd_lse"],
                    "times": {n: {k2: t[k2] for k2 in ("shape", "dtype",
                                                       "k9_ms", "k9_lse_ms",
                                                       "k9_lse_plain_ms")}
                              for n, t in flash_times.items()}}
                entry["match"] = entry["match"] and \
                    misses["attention_stream_fwd_lse"] == 0
        elif wrapper in ("attention_stream_bwd_dq",
                         "attention_stream_bwd_dkv", "flash_bwd_delta"):
            # per call at the long-context path's shape, bf16; train_main's
            # f32 shape beside it
            first, second = (flash_times[c[0]] for c in FLASH_PATH)
            entry.update({k2: first[wrapper][k2] for k2 in TIME_KEYS})
            entry["shape"], entry["dtype"] = first["shape"], first["dtype"]
            entry[FLASH_PATH[1][0]] = dict(second[wrapper],
                                           shape=second["shape"],
                                           dtype=second["dtype"])
        elif wrapper == "paged_attention":
            # per call at the continuous path's decode shape, bf16
            entry.update({k2: paged_times["decode"][k2] for k2 in TIME_KEYS})
            entry["shape"] = paged_times["decode"]["shape"]
            entry["prefill"] = {k2: paged_times[k2]
                                for k2 in ("prefill_512", "prefill_128")}
        elif name in codec_times:    # per call at CODEC_N elements
            entry.update({k2: codec_times[name][k2] for k2 in TIME_KEYS})
            entry["elements"] = CODEC_N
        elif name in qtimes:     # quantized: one batch-32 forward, bf16
            entry.update({key: qtimes[name][key] for key in TIME_KEYS +
                          ("device_ms", "library_device_ms", "host_ms",
                           "stages")})
            entry["calls_per_forward"] = qtimes[name]["calls"]
            if name == "w8_matmul":
                entry["f32"] = {key: v for key, v in
                                qtimes["w8_matmul_f32"].items()
                                if key != "stages"}
        else:
            entry.update({key: train_times[name][key] for key in TIME_KEYS})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
