#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

(``python3 chip_smoke.py --repeat-3s-a RUNS E [E ...]`` runs phase 3s-a
alone, RUNS times at each epoch count E, and logs each run's Top-1.)

Phases, each of which ends the run with a non-zero exit on failure:

1. card line (name and power limit from nvidia-smi) and the nvcc build of
   every kernel from ``bigdl_tpu_torch/csrc``;
2. every forward kernel (K1 max pool, K2 LRN) against its plain PyTorch
   version on the card, at the shapes full-width Inception-v1 gives it at
   batch 32 (K1 also at ResNet-50's stem pool and Inception-v2's five
   pools, ``RESNET_POOLS`` and ``V2_POOLS``, and at the perf harness's
   pools at batch 128: AlexNet's and AlexNet-OWT's 3x3/2 and VGG's five
   2x2/2 on 224 to 14-pixel planes, ``ALEXNET_POOLS`` and ``VGG_POOLS``;
   K2 also at AlexNet's two LRNs at batch 128, ``ALEXNET_LRNS``) and at
   ragged shapes, in float32 and bfloat16; K2 also at the
   edges of its plan (``RAGGED_LRNS``: odd planes, planes no multiple of
   16 bytes, a batch slice off 16 bytes, C below the window, C = 1, C off
   a multiple of the chunk, sizes 1 and 4, AlexNet's two LRNs), logging
   each case's plan and failing unless the size-5 and generic
   instantiations both ran with vectors and with one pixel a thread; K1
   bit-equal also at the edges of its plan (``POOL_EDGES``: n*c off a
   multiple of the planes a block, 7x7 and 13x11 planes whose bytes are
   no multiple of 16, an input off 16 bytes, planes over the shared-memory
   budget in bands and rows over it in column tiles at every
   instantiation, ResNet's stem, ceil-mode windows wholly past the plane),
   at the Fast R-CNN trunk's four pools (``RCNN_POOLS``, bands of
   600x800 planes and pool4's odd 75 rows) and at the text classifier's
   three (``TEXT_POOLS``: one-row planes at batch 128, 1x5/5 over 996 and
   195 columns, 1x35/35 on the generic instantiation),
   logging the instantiation and plan of each case, and failing unless
   every instantiation (3x3/2, 3x3/1, 2x2/2, generic) ran on whole planes,
   on bands and on column tiles;
2b. the backward kernels (K3 max pool, K4 LRN) the same way (K4 on the
   scale K2 wrote, at the same cases and with the same coverage rule), K3
   on the argmax codes K1 wrote (dy and codes off 16 bytes where the case's
   input is), with the same coverage rule, K3 through autograd with a
   strided dy, and one autograd round trip per layer on the card against
   the same on the CPU;
2c. the quantized matmuls (K13 with int8 and e4m3 weights, K14 int8 x
   int8, K15 int4) against their plain versions at every (M, K, N) that
   quantized Inception-v1 gives them at buckets 8 and 32, at ragged shapes
   and at the edges of the bf16 kernel's tiles and plan (M 63-65 and
   127-129, N 8/24/256/257/384, K 600, odd K, K split unevenly over
   blocks, x at row 1 of a larger tensor), in float32 and bfloat16: K14
   bit-equal, K13/K15 within 1e-4 of each output's sum of |products| (f32
   sums in another order), plus one bfloat16 rounding step in bfloat16;
   K13 (both weight kinds) and K15 bit-equal over two bf16 launches at a
   split-K shape and at conv2's, and over two f32 launches at a split-K
   shape and at the classifier (both split K); K14 bit-equal over two
   launches at the classifier at buckets 32 and 8 (split K); then the
   bf16 kernel's plan (rows and columns a block, splits of K) and x's copy
   (TMA or loads), the f32 kernel's plan and x's copy (16- or 4-byte), and
   K14's plan at every product of the path; the same at the packed LM's
   products (``LM_QUANT_MS`` x ``LM_QUANT_KN``: M 8, 32, 128, 512 and 33
   against (K, N) (512, 512), (512, 2048), (2048, 512) and (512, 32000))
   for every rung in both dtypes;
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
   not gated: the weights are random); then the default quantized
   classifier, ``DLClassifier(..., quantize="w8")`` with no
   ``compute_dtype`` (f32 activations, every product on the f32 K13),
   behind an ``InferenceServer`` at buckets 8 and 32, one wave each: 56 K13
   + 13 K1 + 2 K2 a forward and nothing else, classes equal to
   ``DLClassifier.predict``'s, and 8 rows against a CPU run of the same
   packed copy (argmax on every row, logits within 1e-4 of their largest
   magnitude);
2d. the attention-forward kernels (K8, K9) against their plain versions
   at the LM paths' shapes ((8, 8, 2048, 64) causal for K8 and for K9 with
   the padded batch's bias, (1, 8, 8192, 64) causal for K9) and at ragged
   ones (GQA 8/2 and 8/1, non-causal, Tq != Tk, head dims 16/32/128/256
   and 48/80/96/160 (zero-padded to the kernels' sizes), 320 and 512 and
   300 (padded to 320) on the D-chunked kernels, T 8, 24 and 200, a row
   with every key padded, at head dims 256 and 512 too), in float32 (within
   1e-5 of each output's sum of |p·v|) and bfloat16 (within 2 bfloat16
   steps of it); in float32 also at the f32 kernel's block edges (T 127,
   128, 129 and 257, GQA 8/2 at head dims 128 and 256 with T not a
   multiple of the block, key-padding holes that pad whole tiles inside a
   block's causal range, Tq < Tk without the causal mask at Tk 300), and
   the f32 K8 and K9 (with the bias and its LSE) bit-equal over two
   launches;
2e. the paged-attention kernel K12 against ``paged_attention_plain`` with
   a NaN-poisoned trash page, at the continuous path's decode shape (8
   slots, 8 heads, S 1, d 64, page size 16, Lp 128, at the traffic's
   positions), its prefill shapes (S 512, and S 128 after a 384-token
   head) and ragged ones (GQA 8/2 and 8/1, page sizes 5 and 8, d 48/96/128
   /256/512, S 2/3/17, GQA rows packed across the tensor-core path's
   64-row tile, an inactive all-trash row, integer q/k with |s| ~ 30 where
   the scores' bf16 rounding shows, a 65 536-token table past the old
   kernel's limit, a session's next turn: S 128 from a 530-token history,
   a mid-page start), in float32 and bfloat16, and f32 queries over a bf16
   cache, logging the path each case took (tensor cores or page split);
   the speculative verify shape (8 slots x 4 rows at S 1, each table
   repeated, positions pos + i) in the same three dtype pairs; the same
   tolerances as 2d; two launches bit-equal on each path;
2f. the flash backward: K9 with its row logsumexp, the delta pass
   (``rowsum(dO·O)``, shared by K10 and K11), K10 (dQ) and K11 (dK, dV)
   against their plain versions at the training paths' shapes ((1, 8,
   8192, 64) causal bf16, the long-context run; (8, 8, 4096, 64) causal
   f32, ``train_main``'s) and at ragged ones (T 520 and 1000, T 63, 64, 65
   and 129 at the kernels' 64-row tiles, GQA 8/2, 8/1 and 8/1 at T 8191,
   Tq != Tk, a padded bias with a row whose every key is padded, head dims
   16/32/128/256 (causal too, the wgmma widths N 16 and 128),
   48/80/96/160 and 320/512 (the D-chunked kernels)) in
   float32 and bfloat16: o as in 2d, lse within 1e-5 of max(1, |lse|),
   delta within 1e-5 of each row's sum |dO·O|, each gradient within 1e-4
   (f32) or two bfloat16 steps (bf16) of its largest magnitude, zero
   gradients where every key is padded; K10 and K11 each bit-equal over two
   launches (head dims 64, 256 and 512); and two autograd round trips through ``fused_attention`` (T
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
   (exactly 8 K8) against a CPU run of the same weights (log-probs), and
   the bf16 logits
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
   ``paged_kernel=False``, request by request (phase 4 reports K12's
   device time summed over the traffic, by path);
3p. the same LM quantized behind the same generator
   (``quantize="w8"`` over the whole traffic, ``"w8a8"`` calibrated on 4
   of its prompts, ``"w4"`` and ``"f8"`` over the f32 copy's 8 requests x
   32 tokens): each rung's launches exactly ``LM_RUNG_LAUNCHES`` and 8 K12
   a prefill and a decode step (over the run, and in one prefill and one
   step, whose products must be f32 but the out projection's, bf16 from
   the pool), resident bytes within the rung's ``RUNG_BUDGETS`` ratio to
   the bf16 model, new tokens/s, latency and the first-token agreement
   with the fp generator logged, the plan of every product of a step;
   f32 copies' w8 and w8a8 prefill log-probs of two requests on the card
   against the CPU on the same packed copy (``QF32_LOGIT_RTOL`` of their
   largest magnitude, argmax where the top-2 margin is wider than twice
   that; w8a8's CPU run takes the card's activation codes, each within one
   code of its own, every differing one within ``QA8_EDGE`` of a rounding
   edge); a profile of 8 requests under w8; then speculative decoding: the
   bf16 LM with a ``draft_quantize="w8"`` draft of its first 4 blocks,
   ``spec_k`` 3, over the whole traffic: exactly 25 K13 a draft prefill
   and a draft step (4 a round) and 8 K12 a prefill and a verify pass,
   the accept rate, a round's host time and a profile of 8 requests; on
   f32 copies the
   tokens with that draft, with a draft of the first 7 blocks (accept rate
   strictly between 0 and 1) and with the target as its own draft equal
   to plain continuous decoding's and ``generate``'s;
3q. multi-turn sessions: 3g's bf16 LM and generator with the pool cut to
   256 pages (4096 tokens) and a ``MemoryBudgeter`` of 192 pages' bytes:
   48 sessions open with 3g's 384-token head and 12 seeded tokens (32 new),
   then take a second turn of 64 seeded tokens (32 new), so byte pressure
   parks idle sessions to host RAM and their next turns resume them: the
   open sessions' token census at least 3x the pool after turn 1, parks
   above 0, parks = resumes + sessions still parked, every session
   resident or parked after each turn, the budget's device bytes within
   it and its ``kv_pages`` and ``host_offload`` equal to the sessions'
   private pages and the parked bytes after each turn and 0 after every
   session closes, exactly 8 K12 a prefill and a decode step, ids in
   range; a request over a second generator's 96-page budget shed
   ``MemoryBudgetError`` at submit; an f32 copy's 8 sessions (3g's f32
   requests, then 16 tokens and 16 new) parked explicitly between turns,
   with K12 and with ``paged_kernel=False``: every turn's tokens equal to
   ``generate`` over the whole history and to a run that never parks;
   ``mem_drill --smoke`` on the card returns 0;
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
3l. ResNet-50 (``ResNet(1000, 50, "B", "imagenet")``, seeded weights, its
   BN statistics set by one training-mode forward over 8 seeded images, as
   a trained model has them) behind ``InferenceServer(DLClassifier(...),
   batch_buckets=(8, 32))`` in float32 with 3's waves: answers equal to
   ``DLClassifier.predict``, 2 rows against a CPU copy (log-probs within
   1e-3), exactly 1 K1 a forward; one bf16 eval forward of 2 rows against
   the CPU's, within the CPU's own bf16 error (its bf16 logits against its
   f32 ones); then ``models/resnet.py`` ``train_main``'s recipe (SGD 0.1,
   weight decay 1e-4, momentum 0.9, nesterov, ``EpochDecay(cifar10_decay)``,
   ``CrossEntropyCriterion``) in bf16 mixed precision, 30 steps at batch 32,
   validated every 10: finite losses, none skipped, 1 K1 + 1 K3 a step and
   1 K1 a validation forward, every BN layer's running statistics f32,
   finite and moved from 0 and 1; then 2 f32 steps at batch 2 on the card
   and on the CPU: step 1's loss and statistics within 1e-4, later
   quantities within 4 times the CPU's distance from itself under a one-ulp
   change of its input (the gradient at random init amplifies rounding);
3m. Inception-v2 (BN-Inception) the same way: one f32 serving wave at each
   bucket (5 K1 a forward), ``models/inception.py`` ``train_main``'s recipe
   (SGD 0.01, weight decay 2e-4, momentum 0.9, ``Poly(0.5)``,
   ``ClassNLLCriterion``) in bf16 for 20 steps (5 K1 + 5 K3 a step), the
   running-statistics check and the card-vs-CPU steps;
3n. the CIFAR-10 ResNet-20 (shortcut A: ``Padding``) by ResNet's recipe in
   float32 at batch 128 for 8 steps: finite losses, no pool kernel
   launched, the statistics moved;
3o. the perf harness, ``models/perf.py`` ``local_perf_main`` (f32 train
   steps, SGD 0.01) and ``infer_perf_main`` (bf16 forward, argmax to the
   host) for each of its six models (AlexNet, AlexNet-OWT, Inception-v1
   and v2, VGG-16 and VGG-19) at batch 128, ``-d random``, ``-i 5``:
   finite losses, and each wrapper's launches the model's count a
   forward (AlexNet 3 K1 + 2 K2, AlexNet-OWT 3 K1, Inception-v1 13 K1 + 2
   K2, Inception-v2 and VGG 5 K1) or a step (K3 and K4 besides, as many)
   times the warm-up and the 5 iterations; per run the records/s, ms a
   step, a profiled run's device time and busy share, the peak of
   allocated memory and the K1-K4 plans it took; then the harness's step
   on a dropout-free AlexNet-OWT at batch 2 on the card and on the CPU
   (two losses within 1e-4), AlexNet's and VGG-16's f32 eval log-probs at
   batch 1 against the CPU's (1e-4 of their largest magnitude), and their
   bf16 eval logits on 2 rows within the CPU's own bf16-vs-f32 error;
3r. the criterions, the table ops, ``RoiPooling`` and ``Nms``: (a) the
   autoencoder's recipe (``bigdl_tpu/models/autoencoder.py``:
   ``Autoencoder(32)`` through ``Optimizer(..., MSECriterion())``, SGD 0.01
   with momentum 0.9, batch 150) on 1500 seeded 28x28 images (one image
   under per-image noise of 16 grey levels) for 30 f32
   steps: finite losses, the mean of the last 5 below the mean of the
   first 5, no kernel launched, the first two losses within 1e-5 relative
   of a CPU run from the same weights; (b) Fast R-CNN's VGG16 head (the
   port's ``Vgg_16(21)`` modules 0-29 beside the rois, ``RoiPooling(7, 7,
   1/16)``, fc6 and fc7, a ``ConcatTable`` of 21 scores and 84 box
   regressions; ``ParallelCriterion`` of ``SoftmaxWithCriterion`` and
   ``SmoothL1CriterionWithWeights``) over 2 seeded 3x600x800 images and
   256 rois: one training forward, loss and backward (finite loss,
   RoiPooling's (256, 512, 7, 7), a finite nonzero conv1_1 weight
   gradient, exactly 4 K1 + 4 K3), an eval forward (4 K1) with ``Nms`` at
   IoU 0.3 for the 20 foreground classes equal to a numpy greedy walk,
   and card vs CPU at 1 x 3 x 192 x 256 and 32 rois (``RCNN_*_TOL``
   constants; ``Nms`` on the card's scores equal on both, and on the CPU's
   own scores equal in every class without two scores within twice the
   score error); (c) each of the 24 criterions' forward and backward at
   (128, 1000) and each table, shape and distance layer's forward and
   input gradient at a shape users meet, card vs CPU within 1e-5 of the
   largest value;
3s. the recurrent layers, ``LookupTable``, the other convolutions and the
   spatial normalizations: (a) ``example/textclassification.py`` ``main``
   at its defaults but ``-e 4`` (seqLen 1000, embed 100, batch 128,
   Adagrad 0.01 with decay 0.0002, Top-1 each epoch) on a folder staged
   under ``build/`` and removed after (20 classes of 64 seeded documents
   of Zipf-drawn words, half of them the class's own 10 words, and seeded
   100-d vectors in ``glove.6B/glove.6B.100d.txt``): finite losses, the
   last epoch's mean below the first's, the last Top-1 above twice
   chance, exactly 3 K1 + 3 K3 a step and 3 K1 a validation forward, the
   first loss within 1e-5 relative of a CPU forward of the same weights
   on the same batch, step ms, records/s, busy share and peak memory;
   (b) ``models/rnn.py`` ``train_main`` at its defaults but ``-e 2
   --checkpoint`` on 1200 written lines (the split seeded): finite losses,
   no kernel launched, the first loss within 1e-5 relative of the CPU's,
   then ``test_main --words 8`` on the last snapshot, and a profile of 3
   steps; (c) each new layer at users' shapes (``SpatialFullConvolution(
   512, 256, 4, 4, 2, 2, 1, 1)`` on 64 x 512 x 8 x 8, a dilated 3x3 at
   dilation 2 on 16 x 512 x 28 x 28, ``SpatialConvolutionMap(full(16,
   32), 5, 5)`` and the three spatial normalizations (gaussian 7) on 128 x
   16 x 32 x 32, ``LookupTable(20000, 100, max_norm)`` on 128 x 1000 ids,
   ``Recurrent`` with each cell on 32 x 50 x 128, ...): forward within
   1e-5 and input and parameter gradients within 1e-4 of the largest
   value, card vs CPU; the text classifier, ``SimpleRNN(4001)`` and
   ``TextClassifierRNN(20000)`` under ``quantize_model("w8")``, card vs
   CPU on the same packed copy within 1e-4, with their launches (4 K13 +
   3 K1; 1 K13; none);
3t. the model loaders and the two image mains, f32 at batch 32, on PNG
   files written under ``build/`` by the port's encoder (no PIL) and
   removed after: 4 class folders of 16 at 256x341, 341x256, 300x300 and
   256x256 (the resize runs on the host), rows through all five PNG
   filters: (a) ``example/loadmodel.py`` ``main -m inception -t caffe``
   with ``Inception_v1(1000)``'s seeded weights in a caffemodel (V2
   records, its GoogLeNet names, match_all), every weighted parameter on
   the card equal to its blob bit for bit, 64 images counted, exactly 13
   K1 + 2 K2 a forward, 2 rows within 1e-5 of a CPU copy loaded from the
   same file; (d) ``-t bigdl``: (a)'s model through ``Module.save`` and
   ``nn.load``, Top-1 and Top-5 equal to (a)'s; (b) ``-m alexnet -t caffe
   --meanFile`` with ``AlexNet(1000)`` (grouped convs) and a 256x256x3
   mean file ``File.save`` wrote, on square images, 3 K1 + 2 K2 a forward,
   the same checks; (e) ``example/imageclassification.py`` ``main
   --modelType caffe --topN 5`` on 32 flat files with (b)'s caffemodel,
   the classes equal to a CPU copy's wherever the top-6 gaps exceed 1e-4;
   (c) ``-m inception -t torch`` with ``AlexNet_OWT(1000)`` written by
   ``save_torch`` and read by ``nn.load_torch`` onto the card, 3 K1 a
   forward, 2 rows within 1e-5 of the saved module's; each with images/s,
   the host pipeline's and the forwards' shares, the busy share, the
   files' bytes and the load, save, write and read times;
3u. record-file training and the conv nets' mains, on files written under
   ``build/`` and removed after: (a) ``dataset/seqfile.py`` ``main -p 2
   -b 5`` over a PNG tree of 4 classes (train and val, mixed sizes),
   ``check_file`` on every file, the records rewritten as Hadoop
   SequenceFiles read back as the same images; (b)
   ``models/inception.py`` ``train_main -b 32 -e 3 --checkpoint`` (bf16,
   SGD under Poly over the record count) on 320 seeded 256-short-side
   records in 5 files, 128 to validate, labels 1-1000: 13 K1 + 13 K3 +
   2 K2 + 2 K4 a step and 13 K1 + 2 K2 a validation forward exactly, ms a
   step, images/s and the share of ``next(data_iter)``, the pipeline's
   host ms an image by stage, a profile of 3 more steps, ``test_main --model`` on the last snapshot equal to
   ``LocalValidator`` on the in-memory model, ``-b 4 -i 2`` card vs CPU
   (dropout 0, bf16 rule) and the run resumed from the first epoch's
   snapshot pair (the same records, other crops: within 5 % a step);
   (c) ``PrefetchToDevice`` after the pipeline: 6 batches equal to the
   host's bit for bit (f32, bf16), ``train_main -e 1`` with it at (b)'s
   losses, its step, a batch's pageable and pinned upload; (d) the
   LeNet-5 (``-b 128``), ResNet-20, VggForCifar10 (``-b 112``) and
   autoencoder (``-b 150``) mains, one epoch each on 6 000 MNIST and
   5 000 CIFAR-10 records of seeded files, their launches exactly (2 K1 +
   2 K3 a LeNet step, 5 a VGG one, none else), ms a step, the first loss
   against the CPU within 1e-4 and ``test_main``; (e) ``perf ingest -n
   1024 -e 2`` at ``-w 1`` and ``-w 4`` (images/s on the host); (f)
   ``LBFGS.optimize`` (line search) and ``SGD``/``Adam``/``Adagrad.
   optimize`` on a 4096 x 64 logistic regression on the card, losses
   against the CPU's (3u's pipelines run the native host helpers);
3v. the native host helpers and the sharded multi-process feed, on 3u's
   320 seeded records written again under ``build/``: (a) the host
   library (``bigdl_tpu_torch/native.py``, built by ``g++``, with or
   without libjpeg) and each helper bit-equal to its numpy plain version
   at the path's shapes (224x224x3 f32, 256x341 planar bytes, a 32-image
   pack) and at the CIFAR mains' 32x32, ms an image of each, the native
   record scan equal to the Python reader, and the committed JPEG
   fixtures through ``LocalImgReader`` where the library has libjpeg; (b)
   3u-b's and 3u-c's figures on the native branches beside the inline
   pipeline's earlier figures, and 3u-d's mains' steps beside their
   earlier ones; (c) Inception-v1 trained (bf16, batch
   32, ``train_main``'s SGD under Poly) by ``LocalOptimizer`` over
   ``ShardedDataSet.from_seq_folder(workers=4, staging=True)`` for 30
   steps: 13 K1 + 13 K3 + 2 K2 + 2 K4 a step exactly, ms a step, images/s,
   ``next(data_iter)``'s share, the busy share (3 more steps profiled),
   the bf16 upload's ms; the first 4 batches and the first loss at
   workers 0 and 4 bit-equal; (d) ``bench_ingest``'s curve (the seqfile
   recipe, staged to the card in bf16) at workers 0, 1, 2 and 4 beside
   the host's cores and 3u-e's ``perf ingest``; (e) the fault drills:
   ``ingest.worker.kill`` under (c)'s trainer ends in ``IngestWorkerDied``
   within a stated time, and a run armed with ``io.read*1`` and
   ``prefetch.put*1`` (both ``OSError``) completes with both retries
   counted;
3w. the run ledger and what reads it (``bigdl_tpu_torch.observability``),
   each part with the ledger on under ``build/`` and off after: (a)
   Inception-v1 (bf16, batch 32) trained 20 steps by ``LocalOptimizer``
   with a ``TrainSummary`` of every tag every step, a
   ``ValidationSummary`` of one validation after step 10,
   ``set_step_timeout(120)``, ``BIGDL_TPU_HBM_EVERY=4`` and the cost
   record: 13 K1 + 13 K3 + 2 K2 + 2 K4 a step and 13 K1 + 2 K2 for the
   validation forward exactly, 20 ``step`` records of strict JSON, the
   tfevents ``Loss`` scalars equal to the step records' losses, the
   report's ``mem.hbm`` peak between the parameters' bytes and
   ``max_memory_allocated``, a ``cost.analysis`` record, and ``python -m
   bigdl_tpu_torch.cli run-report`` and ``trace-export`` exiting 0 in
   subprocesses; (b) the ledger's cost: 20 more steps with it off, on, on
   and off, ms a step printed, not gated; (c) ``set_step_timeout(2)`` over
   a criterion sleeping 6 s at step 2 ends in ``WatchdogTimeout`` within
   10 s, with its ``watchdog.timeout`` record and a stack dump on stderr;
   (d) 3v's records through ``ShardedDataSet(workers=2)`` (host batches)
   for 6 steps (13/13/2/2 a step), then ``trace-export``: span rows from
   the trainer's pid and every worker pid the pool's census shows served
   a chunk, every worker chunk span linked back to the trainer, one trace
   id, and a bound stage in the report; then ``bench_ingest --run-dir``
   and its attribution pass (decode, augment, pack, stage and h2d
   stages, a bound one); (e) Inception-v1 (f32, K1 and K2) behind
   ``InferenceServer(metrics_port=0)``: 64 requests, 13 K1 + 2 K2 a
   forward, the scraped ``/metrics`` counter 64; 3g's bf16 LM behind
   ``ContinuousGenerator(ledger_tags={"tenant": ...})`` with a
   ``MemoryBudgeter``, 8 requests, 8 K12 a prefill and a decode step:
   every generator record tagged, the report's request count 64 + 8 and
   its memory census equal to the budgeter's own (``mem_drill``'s census
   check runs in 3q);
3x. the trainer's and serving's fault sites, the drill and the benches,
   files under ``build/`` removed after: (a) Inception-v1 (f32, batch 32)
   trained one step under ``grad.nan@0`` keeps every weight bit for bit
   with ``skippedSteps`` 1 and 13/13/2/2 launches, 3 steps under
   ``grad.nan@1`` train steps 0 and 2, and ``train.step@2`` with File
   snapshots every step and ``auto_resume`` raises ``InjectedFault`` after
   step 2's snapshot; relaunched in this process the run resumes at
   ``neval`` 2, ends at 4, and its weights lie within 1e-5 (max |dw|) and
   its losses within rtol 1e-5 of an uninterrupted 4-step run (bit-equality
   logged: cuDNN's backward may not be deterministic); (b) Inception-v1
   (f32) behind ``InferenceServer(num_workers=2, forward_retries=2)`` with
   the bucket ladder: ``serve.forward*2=OSError`` retried away with two
   ``retry`` events and the unfaulted answers, ``serve.worker0.forward``
   twice opens worker 0's breaker while worker 1 answers every later
   request as the unfaulted forward, ``serve.pack`` fails one batch with
   ``PackFailedError`` and leaves the breakers as they were, drain loses
   no request, 13 K1 + 2 K2 a forward that ran; (c) ``cli serve-drill`` at
   its defaults (phases 1-12) exits 0 and ``run-report``'s serving and
   fleet census is ``tests/test_serving.py``'s, K12 launched in phase 11;
   (d) ``cli bench-serve`` at its defaults: every ablation's
   outputs equal to the row-slot run's, each mode's tokens/s, p95 and K12
   and K13 launches, the prefix hit and draft accept rates logged; (e)
   ``cli bench-infer`` without ``--smoke`` (tlm-2L128d, tlm-8L512d, LeNet-5
   at batch 512) passes its accuracy gate, its int8 and bf16 rates,
   resident bytes, quality deltas and one int8 forward's K8 and K13
   launches logged;
3y. the multi-tenant fleet, files under ``build/`` removed after: one
   ``FleetServer`` with a ``MemoryBudgeter`` and the autoscaler serves
   ``vision`` (Inception-v1 f32, buckets 8 and 32, 1-3 workers, weight 3,
   interactive and batch classes), ``vision-w8`` (the same weights under
   ``w8`` in f32 activations, one worker) and ``chat`` (3g's LM under
   ``w8a8`` calibrated on 4 prompts, its own ``ContinuousGenerator``): (a)
   every answer equal to a single-tenant ``InferenceServer`` or
   ``ContinuousGenerator`` of the same classifier, rung and calibration on
   the same rows and prompts, each tenant's ``params`` charge equal to its
   tree's bytes; (b) ``vision-w8`` deregistered under traffic with no
   request lost, then ``UnknownTenantError``, registered again with equal
   answers and its charge back; (c) ``vision`` flooded past its queue
   while one of its workers, a batch waiting in its inbox, is killed:
   every shed ``QueueFullError`` on ``vision``, none on the others, their
   SLO kept, the worker reaped and its batches salvaged, every answer
   equal, none lost or answered twice; (d) a burst at 4x one worker's
   rows/s grows ``vision``; launches exact over (a)-(d): 13 K1 + 2 K2 a
   classifier forward, 56 K13 a ``w8`` one, 48 K14 + 1 K13 + 8 K12 a chat
   prefill or step; (e) ``cli serve-drill`` (phases 1-12, its fleet
   census), ``serve-drill --fleet-smoke`` and ``bench-serve --fleet`` at
   their defaults exit 0 in subprocesses (the two drills at once, then
   the bench alone, its timed gates' margins logged); (f) per tenant
   rows/s, p50 and
   max latency, the device's busy share over a profiled mixed wave, peak
   allocated memory and the run report's census of (a)-(c);
4. timings, each line stamped with the card: each kernel's median time at
   the serving shapes and at the training shapes (bf16) beside its bound,
   its plain version and the library call that computes the same
   function, K1 (f32 without its index, bf16 with it) and K3 per pool
   layer and summed, by CUDA events and torch.profiler device time (a
   profiled window counts only with every launch recorded and, for a
   kernel, not under its bound), the library's too; the classifier's forward per bucket; the closed-loop serving
   images/s and request latency per bucket; the train step in bf16 mixed
   precision and in float32; K13-K15 at every distinct product of the
   quantized forward at buckets 32 and 8 (CUDA events, device time from
   torch.profiler, the wrapper's host time), summed per stage of
   Inception-v1 and over the batch-32 forward beside their bounds, plain
   versions and library calls (``F.linear`` on the widened weight; K14
   ``torch._int_mm`` + scale) by both clocks (K14 at buckets 8 and 32,
   and K13-e4m3 and K15 also in f32 at the classifier), each rung's
   kernels summed over the packed LM's decode step (49 products at M 8,
   f32 but the out projection's bf16) beside the same bound and library
   calls, the
   fused conv (unfold + K13) against cuDNN at three layers, and the ``w8``
   bf16 and the default f32 ``w8`` forward per bucket with a profiler
   breakdown of their device time (the f32 K13's share of it);
   K8 and K9 per call at the LM paths' shapes, at train_main's f32 shape
   (8, 8, 4096, 64) and the f32 LM scoring shape (8, 8, 2048, 64), at the
   LM widths over head dims 128 and 256 in bf16
   and at (1, 2, 2048, 512) in bf16
   (CUDA events and torch.profiler's device time) beside their bound, plain
   version and ``F.scaled_dot_product_attention``, K8 against K9 at T 512
   to 16384, LM scoring tokens/s at both configurations, generation new
   tokens/s and a profiler breakdown of one scoring forward; K12 per call
   at the decode shape (the page split), the prefill shapes (the
   tensor-core path) and the speculative verify shape (32 rows) with its
   plan and the blocks that hold visible keys
   (at least one an SM at the decode shape), and at a session's next-turn
   prefill (S 128 from a mid-page start), by CUDA events and
   torch.profiler's device time, beside its bound, plain version and SDPA
   on the pre-gathered view; the continuous run's new tokens/s,
   request latency p50 and max, slot occupancy, chunks and prefix hit rate
   with a profiler breakdown of the same traffic (K12's device time by
   path among it), and the same requests
   through ``generate`` in static waves of 8; a park and a resume of one
   9-page session at 3q's widths (CUDA events around the gather, the D2H
   copy, the H2D copy and the in-place write; GB/s beside the host
   link's rate); K9 with and without its LSE,
   the delta pass, K10 and K11 per call at both training shapes and at
   (1, 2, 2048, 512) in bf16 beside
   their bounds (6·D and 8·D FLOPs per unmasked pair and head; the delta
   pass by its bytes), their plain versions, and their sum beside SDPA's
   backward (forward + backward less forward), the long-context
   step and tokens/s with a profiler breakdown, and ``train_main``'s step;
   K5, K6 and K7 per call at 42 652 672 elements beside their bytes bound,
   plain versions and, for K6, ``u.view(torch.bfloat16).float()`` (the
   bf16 cast's time beside K5 as a reference of the same traffic), the
   save and load time of 3j's snapshot pair; K1 (f32, and bf16 with its
   index) and K3 at ResNet-50's and Inception-v2's pools beside their
   bounds, plain versions and ATen's; both models' f32 forward per bucket
   and serving images/s and latency, their bf16 step and images/s trained,
   and a profile of the step (BN's kernels, K1/K3 and the busy share), and
   the CIFAR ResNet's f32 step; K1 and K3 at VGG's five pools and
   AlexNet's three, K2 and K4 at AlexNet's two LRNs (odd planes, one pixel
   a thread), at batch 128 in float32 as ``perf local`` calls them and K1
   and K2 in bfloat16 as ``perf infer`` does, per layer and summed beside
   their bounds, plain versions and ATen's calls (``F.max_pool2d``,
   ``max_pool2d_with_indices_backward``, ``F.local_response_norm`` and
   autograd's backward of it), by events and device time; K1 (f32 with
   its index) and K3 at the Fast R-CNN trunk's four pools (batch 2 on
   600x800 input) the same way, with each launch's plan; the head's forward and step, RoiPooling's device
   time, the 20 ``Nms`` calls and the autoencoder's step; K1 (f32 with its
   index) and K3 at the text classifier's three pools (batch 128) and at
   LeNet-5's two (batch 128) and VggForCifar10's five (batch 112) the same
   way.

The line before the last is a JSON object with a ``kernels`` list; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import copy
import glob
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
# the SpatialMaxPooling layers of ResNet-50 (phase 3l) and Inception-v2
# (phase 3m) at batch 32, in forward order
RESNET_POOLS = [
    ("resnet50/stem 3x3_s2 pad 1", (BATCH, 64, 112, 112), 3, 3, 2, 2, 1, 1,
     False),
]
V2_POOLS = [
    ("inception_v2/pool1 3x3_s2", (BATCH, 64, 112, 112), 3, 3, 2, 2, 0, 0,
     True),
    ("inception_v2/pool2 3x3_s2", (BATCH, 192, 56, 56), 3, 3, 2, 2, 0, 0,
     True),
    ("inception_v2/3c pool 3x3_s2", (BATCH, 320, 28, 28), 3, 3, 2, 2, 0, 0,
     True),
    ("inception_v2/4e pool 3x3_s2", (BATCH, 576, 14, 14), 3, 3, 2, 2, 0, 0,
     True),
    ("inception_v2/5b pool 3x3_s1", (BATCH, 1024, 7, 7), 3, 3, 1, 1, 1, 1,
     True),
]
# the SpatialMaxPooling layers of the perf harness's models (phase 3o) at
# its batch of 128: AlexNet's and AlexNet-OWT's 3x3/2 pools on 55, 27 and
# 13-pixel planes, and the five 2x2/2 pools of VGG-16 and VGG-19 on 224,
# 112, 56, 28 and 14-pixel planes, in forward order
HARNESS_BATCH = 128
ALEXNET_POOLS = [
    ("alexnet/pool1 3x3_s2", (HARNESS_BATCH, 96, 55, 55), 3, 3, 2, 2, 0, 0,
     False),
    ("alexnet/pool2 3x3_s2", (HARNESS_BATCH, 256, 27, 27), 3, 3, 2, 2, 0, 0,
     False),
    ("alexnet/pool5 3x3_s2", (HARNESS_BATCH, 256, 13, 13), 3, 3, 2, 2, 0, 0,
     False),
    ("alexnetowt/pool1 3x3_s2", (HARNESS_BATCH, 64, 55, 55), 3, 3, 2, 2, 0,
     0, False),
    ("alexnetowt/pool2 3x3_s2", (HARNESS_BATCH, 192, 27, 27), 3, 3, 2, 2, 0,
     0, False),
]
VGG_POOLS = [
    (f"vgg/pool{i + 1} 2x2_s2", (HARNESS_BATCH, c, hw, hw), 2, 2, 2, 2, 0, 0,
     False)
    for i, (c, hw) in enumerate(((64, 224), (128, 112), (256, 56), (512, 28),
                                 (512, 14)))]
RAGGED_POOLS = [
    ("odd HW, ceil, pad 1", (2, 3, 13, 11), 3, 3, 2, 2, 1, 1, True),
    ("odd HW, floor, pad 1", (2, 7, 9, 7), 3, 3, 2, 2, 1, 1, False),
    ("C=3, 2x2 floor", (3, 3, 15, 15), 2, 2, 2, 2, 0, 0, False),
    ("C=7, ceil, rect window", (2, 7, 10, 13), 3, 2, 2, 3, 0, 1, True),
]
# K1/K3 at the edges of their plan (ops/pooling.py pool_plan): n*c not a
# multiple of the planes a block (25792 planes of 7x7, 24 a block: 98-byte
# bf16 planes start off 16 bytes); 13x11 planes (286 bytes in bf16) two a
# block; an input at element 1 of a larger tensor (dy and the codes too in
# phase 2b); planes over the shared-memory budget, so bands of rows run,
# at each fixed window and the generic one (n*c 1056: bands by the budget;
# n*c 6: one-row bands to fill the card); rows over the budget, so column
# tiles run, at each fixed window and the generic one (3x3/2 with pad 1:
# K3's stride cells straddle its tiles); ResNet's stem (3x3/2, pad 1) and
# 2x2/2 pools on whole planes and on VGG's 224x224 ones; ceil-mode windows
# with the stride past the window, the last of them wholly past the plane
# (-inf and code 0).  (name, shape, kh, kw, sh, sw, ph, pw, ceil, at
# element 1 of a larger tensor)
POOL_EDGES = [
    ("7x7, planes not a multiple", (31, 832, 7, 7), 3, 3, 1, 1, 1, 1, False,
     False),
    ("13x11, two planes a block", (4, 600, 13, 11), 3, 3, 2, 2, 0, 0, True,
     False),
    ("base off 16 bytes", (4, 96, 28, 28), 3, 3, 1, 1, 1, 1, False, True),
    ("base off 16 bytes, 7x7", (31, 832, 7, 7), 3, 3, 2, 2, 0, 0, True,
     True),
    ("224x224 bands, 3x3/2", (8, 132, 224, 224), 3, 3, 2, 2, 0, 0, True,
     False),
    ("224x224 bands, 3x3/1", (8, 132, 224, 224), 3, 3, 1, 1, 1, 1, False,
     False),
    ("224x224 bands, 2x2/2 (VGG)", (8, 132, 224, 224), 2, 2, 2, 2, 0, 0,
     False, False),
    ("224x224 bands, generic 3x2/(2,3)", (8, 132, 224, 224), 3, 2, 2, 3, 0,
     1, True, False),
    ("one-row bands, 3x3/2", (2, 3, 224, 224), 3, 3, 2, 2, 0, 0, True, True),
    ("one-row bands, 3x3/1", (2, 3, 224, 224), 3, 3, 1, 1, 1, 1, False,
     False),
    ("one-row bands, 2x2/2", (2, 3, 224, 224), 2, 2, 2, 2, 0, 0, False,
     False),
    ("one-row bands, generic 3x3/3", (2, 3, 224, 224), 3, 3, 3, 3, 1, 1,
     True, False),
    ("ResNet stem 3x3/2 pad 1", (32, 64, 112, 112), 3, 3, 2, 2, 1, 1, False,
     False),
    ("2x2/2, whole planes", (32, 64, 56, 56), 2, 2, 2, 2, 0, 0, False,
     False),
    ("generic 2x3/(1,2), planes a block", (16, 256, 14, 14), 2, 3, 1, 2, 1,
     1, True, False),
    ("column tiles, 3x3/2", (1, 2, 5, 30001), 3, 3, 2, 2, 0, 0, True, True),
    ("column tiles, 3x3/2 pad 1", (1, 3, 5, 20001), 3, 3, 2, 2, 1, 1, False,
     False),
    ("column tiles, 3x3/1", (1, 2, 4, 30000), 3, 3, 1, 1, 1, 1, False,
     False),
    ("column tiles, 2x2/2", (1, 2, 4, 30000), 2, 2, 2, 2, 0, 0, False,
     False),
    ("column tiles, generic 2x2/3, windows past the plane", (1, 2, 6, 30000),
     2, 2, 3, 3, 0, 0, True, False),
    ("windows past the plane, 2x2/3", (2, 3, 6, 6), 2, 2, 3, 3, 0, 0, True,
     False),
    ("windows past the plane, 1x1/3", (1, 1, 5, 5), 1, 1, 3, 3, 0, 0, True,
     False),
]
# K3 through autograd with a strided gradient (every other column of a
# wider tensor): (name, shape, kh, kw, sh, sw, ph, pw, ceil)
POOL_STRIDED_DY = [
    ("pool2/3x3_s2", (8, 192, 56, 56), 3, 3, 2, 2, 0, 0, True),
    ("inception_4a/pool", (8, 480, 14, 14), 3, 3, 1, 1, 1, 1, False),
]
# (name, shape, size, alpha, beta, k) of the 2 LRN layers, then ragged
LRNS = [
    ("pool1/norm1", (BATCH, 64, 56, 56), 5, 1e-4, 0.75, 1.0),
    ("conv2/norm2", (BATCH, 192, 56, 56), 5, 1e-4, 0.75, 1.0),
]
# AlexNet's two LRN layers at the harness's batch (phase 3o): planes of
# 3025 and 729 pixels, odd, so one pixel a thread
ALEXNET_LRNS = [
    ("alexnet/norm1", (HARNESS_BATCH, 96, 55, 55), 5, 1e-4, 0.75, 1.0),
    ("alexnet/norm2", (HARNESS_BATCH, 256, 27, 27), 5, 1e-4, 0.75, 1.0),
]
# K2/K4 at the edges of their plan (ops/lrn.py lrn_plan), each in f32 and
# bf16: odd planes (35, 117 and AlexNet's 55x55 pixels: one pixel a
# thread), planes of 36 and 34 pixels (8- and 4-byte vectors), a
# contiguous slice x[1:] of a batch of odd planes and a tensor at element
# 1 of a larger one (bases aligned to one element: one pixel a thread; dy
# too in phase 2b), C below the window, C = 1, C off a multiple of the
# chunk (7, 13, 97), window sizes 1, 3 and 4 (the generic instantiation; 4
# is even, lo != hi) with vectors and one pixel a thread, AlexNet's (2, 96,
# 55, 55) and (2, 256, 27, 27).
# (name, shape, size, alpha, beta, k[, "slice" or "element 1"])
RAGGED_LRNS = [
    ("C=3, HW=35", (2, 3, 5, 7), 5, 1.0, 0.75, 1.0),
    ("C=7, HW=117, even window", (3, 7, 9, 13), 4, 1.0, 0.75, 2.0),
    ("beta 0.5", (2, 7, 9, 13), 5, 1.0, 0.5, 1.0),
    ("beta 1.0 (powf)", (2, 5, 3, 45), 3, 0.5, 1.0, 1.0),
    ("odd HW, x[1:] of a batch", (3, 7, 9, 13), 5, 1.0, 0.75, 1.0, "slice"),
    ("HW=64, at element 1", (2, 9, 8, 8), 5, 1.0, 0.75, 1.0, "element 1"),
    ("HW=36, not a multiple of 8", (2, 9, 6, 6), 5, 1.0, 0.75, 1.0),
    ("HW=34, not a multiple of 4", (2, 9, 2, 17), 5, 1.0, 0.75, 1.0),
    ("C=3 < size", (2, 3, 8, 8), 5, 1.0, 0.75, 1.0),
    ("C=1", (2, 1, 8, 8), 5, 1e-4, 0.75, 1.0),
    ("C=7, chunks of 4", (4, 7, 16, 16), 5, 1.0, 0.75, 1.0),
    ("C=13, beta 0.5", (2, 13, 8, 8), 5, 1.0, 0.5, 2.0),
    ("C=97, many chunks", (1, 97, 8, 8), 5, 1.0, 0.75, 1.0),
    ("size 1", (2, 6, 8, 8), 1, 1.0, 0.75, 1.0),
    ("size 4, vectors", (2, 11, 8, 8), 4, 1.0, 0.75, 2.0),
    ("AlexNet norm1", (2, 96, 55, 55), 5, 1e-4, 0.75, 1.0),
    ("AlexNet norm2", (2, 256, 27, 27), 5, 1e-4, 0.75, 1.0),
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
# K13 and K15 bit-equal over two bf16 launches: a split-K shape and conv2;
# over two f32 launches: a split-K shape and the classifier (both split);
# K14 over two launches at the classifier, buckets 32 and 8 (split K)
QUANT_BITEQ = [(1568, 832, 160), (100352, 576, 192)]
QUANT_BITEQ_F32 = [(1568, 832, 160), (32, 1024, 1000)]
QUANT_BITEQ_A8 = [(32, 1024, 1000), (8, 1024, 1000)]
# the default f32 w8 forward's logits, card vs CPU, of their largest
# magnitude: f32 sums in another order through 22 layers (no bf16
# rounding; the H100 showed 4.5e-7); a wrong product shows far above it
QF32_LOGIT_RTOL = 1e-4
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
    # head dims above 256: the D-chunked kernels (320 and 512 as they are,
    # 300 zero-padded to 320)
    ("d 320, GQA 8/2", 2, 8, 2, 100, 100, 320, True, None),
    ("d 300 (padded to 320), non-causal, Tq != Tk", 1, 4, 4, 70, 33, 300,
     False, None),
    ("d 512, padded keys, a row with every key padded", 2, 4, 4, 130, 130,
     512, True, [130, 0]),
]
# f32 cases at the edges of the f32 kernel's blocks (128 query rows up to d
# 128, 64 at d 256; key tiles of 64, 32 at d 256): T one short of, equal
# to and past a block, GQA at d 128 and 256 with T not a multiple of the
# block, key-padding holes ((lo, hi): keys [lo, hi) padded) that pad whole
# tiles inside a block's causal range (the tiles are skipped, the ring goes
# on), Tq < Tk without the causal mask at a Tk that is not a multiple of 64
ATTN_F32_EDGES = [
    ("T 127", 2, 4, 2, 127, 127, 64, True, None),
    ("T 128", 2, 4, 2, 128, 128, 64, True, None),
    ("T 129", 2, 4, 2, 129, 129, 64, True, None),
    ("T 257", 1, 8, 2, 257, 257, 64, True, None),
    ("d 128, GQA 8/2, T 200", 2, 8, 2, 200, 200, 128, True, None),
    ("d 256, GQA 8/2, T 100", 2, 8, 2, 100, 100, 256, True, None),
    ("padded middle tiles, a row with every key padded", 2, 4, 2, 384, 384,
     64, True, [(64, 256), 0]),
    ("d 256, padded middle tiles", 1, 4, 4, 200, 200, 256, True, [(40, 130)]),
    ("Tq < Tk, non-causal, Tk 300", 1, 4, 4, 100, 300, 64, False, None),
    ("Tq < Tk, non-causal, Tk 300, padded keys", 2, 4, 4, 100, 300, 64,
     False, [300, 150]),
]
# f32 K8 and K9 (with the bias and its LSE) bit-equal over two launches:
# each row's sums run over its key tiles in a fixed order
ATTN_F32_BITEQ = [
    ("T 257, GQA 8/2", 2, 8, 2, 257, 257, 64, True, [257, 100]),
    ("d 256, T 130", 2, 4, 4, 130, 130, 256, True, [130, 77]),
]
# phase 4 beside ATTN_PATH: (name, b, h, hk, t, tk, d, causal, lengths,
# dtype) of K8 and K9 (both timed at each): train_main's f32 shape, the
# f32 LM scoring shape (K8's path in f32), and the bf16 LM widths at head
# dims 128 and 256 (embed 512 over 4 and 2 heads)
ATTN_TIMED = [
    ("train_main's shape, f32", 8, LM_HEADS, LM_HEADS, 4096, 4096, 64, True,
     None, "float32"),
    ("LM scoring, f32", LM_BATCH, LM_HEADS, LM_HEADS, LM_T, LM_T, 64, True,
     None, "float32"),
    ("d 128", LM_BATCH, 4, 4, LM_T, LM_T, 128, True, None, "bfloat16"),
    ("d 256", LM_BATCH, 2, 2, LM_T, LM_T, 256, True, None, "bfloat16"),
    ("d 512", 1, 2, 2, LM_T, LM_T, 512, True, None, "bfloat16"),
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
# quantized and speculative continuous serving (phase 3p): the LM of 3g
# behind the same generator under each rung (w8 over the whole traffic, the
# other rungs over the f32 copy's requests; w8a8 calibrated on the first
# CG_QCAL_PROMPTS of the traffic's prompts), and with a draft of its first
# SPEC_DRAFT_LAYERS blocks (bench_serve.py's truncated draft at its default
# half) under w8, proposing SPEC_K tokens a round (its default); the f32
# token check adds a draft of the first SPEC_PARTIAL_LAYERS blocks, which
# agrees with the target part of the time (0 < accept rate < 1), so rounds
# that accept some proposals and leave the rejected ones' K/V behind are
# held to plain decoding
CG_QCAL_PROMPTS, SPEC_K, SPEC_DRAFT_LAYERS = 4, 3, 4
SPEC_PARTIAL_LAYERS = LM_LAYERS - 1
# multi-turn sessions (phase 3q): 3g's LM and generator with the pool cut
# to SESS_PAGES pages and a budget of SESS_BUDGET_PAGES pages' bytes, so
# byte pressure parks sessions before the free list runs dry; SESS_N
# sessions open with 3g's CG_HEAD-token head and SESS_UNIQUE seeded tokens
# (every session's published chain is that head's 24 pages: unique long
# prompts would pin a chain each, which no parking frees), then take a turn
# of SESS_TURN2 seeded tokens, SESS_NEW new tokens each turn; a second
# generator's budget of SESS_SMALL_BUDGET pages sheds a 2048-token request
# (128 pages) at submit; the f32 check's second turn: SESS_F32_TURN2 tokens
# and as many new
SESS_PAGES, SESS_BUDGET_PAGES, SESS_SMALL_BUDGET = 256, 192, 96
SESS_N, SESS_UNIQUE, SESS_TURN2, SESS_NEW = 48, 12, 64, 32
SESS_F32_TURN2 = 16
# phase 4: a park and a resume of a session of SESS_PARK_PAGES private
# pages; the host link's rate per direction (PCIe Gen5 x16 on the H100 SXM
# data sheet: 128 GB/s both ways)
SESS_PARK_PAGES = 9
HOST_LINK_BYTES_PER_S = 64e9
# the LM's packed products a forward, by rung: 8 x (4 projections + fc1 +
# fc2) and the tied head; the head has no activation scale in w8a8 (the
# reference never observes it), so it runs K13 weight-only there
LM_RUNG_LAUNCHES = {
    "w8": {"w8_matmul": 49}, "w8a8": {"a8_matmul": 48, "w8_matmul": 1},
    "w4": {"w4_matmul": 49}, "f8": {"f8_matmul": 49}}
# K13-K15 against their plain versions at the LM's products (phase 2c): M
# of a decode step, of a verify pass (8 x (SPEC_K + 1)), of the two prefill
# buckets and a ragged M; (K, N) of the projections, fc1, fc2 and the head
LM_QUANT_MS = (8, 32, 128, 512, 33)
LM_QUANT_KN = ((512, 512), (512, 2048), (2048, 512), (512, 32000))
# the f32 w8a8 prefill, card vs CPU (phase 3p): an activation code the card
# rounds otherwise than the CPU lies within this of a rounding edge, in
# units of the activation scale
QA8_EDGE = 1e-3
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
    # the tensor-core path's shapes in bf16 (the page split in f32): GQA
    # rows packed across the 64-row tile, page sizes 5 and 8, head dims 128
    # and 256, large scores; and past the old kernel's table limit
    ("GQA 8/2, S 17: 68 packed rows", 2, 8, 2, 17, 64, 16, 8, [100, 40],
     False),
    ("page size 5, d 128, 80 packed rows", 1, 8, 2, 20, 128, 5, 30, [140],
     False),
    ("page size 8, d 256, 128 packed rows, an inactive row", 2, 4, 1, 32,
     256, 8, 20, [150, 0], False),
    ("large scores, 128 packed rows", 2, 8, 1, 16, 64, 16, 6, [90, 17],
     True),
    ("d 512, S 2", 2, 4, 2, 2, 512, 16, 8, [100, 30], False),
    ("a 65 536-token table, decode", 2, 4, 4, 1, 64, 16, 4096,
     [40000, 65536], False),
    ("a 65 536-token table, 64 packed rows", 1, 2, 2, 64, 64, 16, 4096,
     [65536], False),
]
# a session's next turn (phase 3q's shape): S 128 prefilled from a
# 530-token history, so its first position is mid-page
PAGED_SESSION = ("session continuation: S 128 after a 530-token history",
                 1, 8, 8, 128, 64, 16, 128, [658], False)
PAGED_RAGGED.append(PAGED_SESSION)
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
    # head dims above 256: the D-chunked kernels
    ("d 320, GQA 8/2", 1, 8, 2, 200, 200, 320, True, None),
    ("d 512, padded, a row with every key padded", 2, 4, 2, 130, 130, 512,
     True, [130, 0]),
    # the edges of the f32 kernels' tiles (a block's own x streamed): up to
    # d 64 K10 128 query rows x 64 keys and K11 128 keys x 64 query rows
    # (T 63-65 above), at d 128 K10 64 x 64 and K11 64 x 32, at d 256 both
    # 32 x 32; a padded GQA batch whose second row leaves whole tiles padded
    ("T 127", 1, 8, 8, 127, 127, 64, True, None),
    ("T 128", 1, 8, 8, 128, 128, 64, True, None),
    ("T 2049, GQA 8/2, padded", 2, 8, 2, 2049, 2049, 64, True,
     [2049, 1500]),
    ("T 31, d 128", 1, 4, 4, 31, 31, 128, True, None),
    ("T 32, d 128", 1, 4, 4, 32, 32, 128, True, None),
    ("T 33, d 128, GQA 4/2", 1, 4, 2, 33, 33, 128, True, None),
    ("T 65, d 128, GQA 8/2, padded", 2, 8, 2, 65, 65, 128, True, [65, 40]),
    ("T 31, d 256", 1, 4, 4, 31, 31, 256, True, None),
    ("T 32, d 256", 1, 4, 4, 32, 32, 256, True, None),
    ("T 33, d 256, GQA 4/2", 1, 4, 2, 33, 33, 256, True, None),
    ("T 65, d 32, GQA 8/2", 1, 8, 2, 65, 65, 32, True, None),
    ("T 63, d 16, non-causal, padded", 2, 4, 4, 63, 63, 16, False, [63, 20]),
    ("T 63, d 128", 1, 4, 4, 63, 63, 128, True, None),
    ("T 64, d 128", 1, 4, 4, 64, 64, 128, True, None),
]
# phase 4 beside FLASH_PATH: K9 with its LSE, the delta pass, K10 and K11
# once at head dim 512 (the D-chunked kernels), bf16
FLASH_TIMED = [("d 512, bf16", 1, 2, 2, LM_T, LM_T, 512, True, None,
                "bfloat16")]
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


class PhaseClock:
    """Logs each phase's wall seconds and the run's so far (the run must
    end inside its time limit, build included)."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds = {}

    def stamp(self, phase: str) -> None:
        now = time.perf_counter()
        self.seconds[phase] = now - self.last
        self.last = now
        log(f"phase {phase}: {self.seconds[phase]:.1f} s "
            f"({now - self.start:.1f} s so far)")


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

def _pool_input(shape, dtype, device, gen, ties, offset=False):
    """A seeded pool input; with ``offset``, a contiguous view at element 1
    of a larger tensor (its base off 16 bytes)."""
    import torch
    if ties:
        x = torch.randint(-3, 4, shape, generator=gen, device=device)
    else:
        x = torch.randn(shape, generator=gen, device=device)
    return _offset_copy(x.to(dtype)) if offset else x.to(dtype)


def _offset_copy(t):
    """A copy of ``t`` as a contiguous view at element 1 of a larger
    tensor."""
    import torch
    big = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    big[1:].copy_(t.reshape(-1))
    return big[1:].view(t.shape)


def pool_cases():
    """Phase 2's and 2b's pool cases: (name, shape, geometry, offset)."""
    for case in (POOLS + RESNET_POOLS + V2_POOLS + ALEXNET_POOLS + VGG_POOLS
                 + RCNN_POOLS + TEXT_POOLS + LENET_POOLS + CIFAR_VGG_POOLS
                 + RAGGED_POOLS + POOL_EDGES):
        name, shape = case[:2]
        yield name, shape, tuple(case[2:9]), len(case) > 9 and case[9]


POOL_MODES = ("whole planes", "bands", "column tiles")


def pool_take(shape, geom, dtype, backward):
    """The instantiation and plan K1 (or K3) takes at a case, as the
    library picks it and the wrapper plans it: (variant, plan, mode), mode
    one of POOL_MODES."""
    import torch
    from bigdl_tpu_torch.ops import pooling
    n, c, h, w = shape
    plan = pooling.pool_plan(
        n, c, h, w, geom, dtype, backward=backward,
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    return pooling.pool_variant(*geom[:4]), plan, pool_mode(plan)


def pool_mode(plan):
    """The POOL_MODES entry of a K1/K3 plan."""
    return POOL_MODES[2 if plan.tiles > 1 else 1 if plan.bands > 1 else 0]


def fmt_plan(plan):
    return (f"{plan.planes} planes x {plan.rows} rows x {plan.cols} "
            f"columns a block, {plan.bands} bands x {plan.tiles} tiles, "
            f"{plan.blocks} blocks of {plan.threads} threads, {plan.smem} B "
            "shared")


def lrn_cases():
    """Phase 2's and 2b's LRN cases: (name, shape, size, alpha, beta, k,
    placement), placement None, "slice" or "element 1"."""
    for case in LRNS + ALEXNET_LRNS + RAGGED_LRNS:
        yield tuple(case[:6]) + (case[6] if len(case) > 6 else None,)


def lrn_input(shape, dtype, device, gen, placement):
    """A seeded LRN input: a contiguous slice x[1:] of a batch one image
    larger, a copy at element 1 of a larger tensor, or a fresh tensor."""
    import torch
    if placement == "slice":
        return torch.randn((shape[0] + 1,) + tuple(shape[1:]), generator=gen,
                           device=device).to(dtype)[1:]
    x = torch.randn(shape, generator=gen, device=device).to(dtype)
    return _offset_copy(x) if placement == "element 1" else x


def lrn_mode(plan, dtype):
    """What :func:`lrn_coverage` counts of a case: its instantiation,
    vectors or one pixel a thread, and its dtype."""
    import torch
    return (plan.variant, "vectors" if plan.vec > 1 else "one pixel",
            "f32" if dtype == torch.float32 else "bf16")


def fmt_lrn_plan(plan):
    return (f"{plan.variant}, {plan.vec} pixels x {plan.chunk} channels a "
            f"thread, {plan.chunks} chunks x {plan.vecs} vectors, "
            f"{plan.blocks} blocks of {plan.threads} threads")


def lrn_coverage(what, seen):
    """Fail unless the size-5 and generic instantiations each ran with
    vectors and with one pixel a thread, in both dtypes."""
    missing = [f"{v} {m} {d}" for v in ("size 5", "generic")
               for m in ("vectors", "one pixel") for d in ("f32", "bf16")
               if (v, m, d) not in seen]
    if missing:
        fail(f"{what}: untested instantiations: {missing}")


def max_abs_diff(got, want):
    """The largest |got - want| in f32, where cells that are equal (-inf
    among them) count 0."""
    import torch
    d = (got.float() - want.float()).abs()
    return torch.where(got.float() == want.float(), torch.zeros_like(d),
                       d).max().item()


def pool_coverage(what, seen, ragged_groups):
    """Fail unless every instantiation ran on whole planes, on bands and
    on column tiles, and some case's n*c was not a multiple of its planes
    a block."""
    from bigdl_tpu_torch.ops.pooling import POOL_VARIANTS
    missing = [f"{v} {m}" for v in POOL_VARIANTS
               for m in POOL_MODES if (v, m) not in seen]
    if missing:
        fail(f"{what}: untested instantiations and paths: {missing}")
    if not ragged_groups:
        fail(f"{what}: no case had n*c off a multiple of its planes a block")


def check_kernels(device):
    """Hold each kernel against its plain version; returns, per kernel, the
    largest float32 error, the count of cases and the count of mismatches
    (outputs out of tolerance, or argmax codes that differ)."""
    import torch
    from bigdl_tpu_torch.ops import (cross_map_lrn, lrn_plain, max_pool2d,
                                     max_pool2d_plain)
    from bigdl_tpu_torch.ops.lrn import lrn_plan_for
    gen = torch.Generator(device=device).manual_seed(SEED)
    errs = {"max_pool2d_fwd": 0.0, "lrn_fwd": 0.0}
    cases = {"max_pool2d_fwd": 0, "lrn_fwd": 0}
    misses = {"max_pool2d_fwd": 0, "lrn_fwd": 0}
    seen, ragged_groups = set(), 0
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, geom, offset in pool_cases():
            variant, plan, mode = pool_take(shape, geom, dtype, False)
            seen.add((variant, mode))
            ragged_groups += shape[0] * shape[1] % plan.planes != 0
            log(f"max_pool2d {name} {tuple(shape)} {dtype}"
                f"{', base off 16 bytes' if offset else ''}: {variant}, "
                f"{mode}, {fmt_plan(plan)}")
            for ties in (False, True):
                x = _pool_input(shape, dtype, device, gen, ties, offset)
                yk, ik = max_pool2d(x, *geom, return_indices=True)
                yk_noidx = max_pool2d(x, *geom)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                yp, ip = max_pool2d_plain(x, *geom)
                err = max(max_abs_diff(yk, yp), max_abs_diff(yk_noidx, yp))
                bad = (ik != ip).sum().item()
                if dtype == torch.float32:
                    errs["max_pool2d_fwd"] = max(errs["max_pool2d_fwd"], err)
                cases["max_pool2d_fwd"] += 1
                if not (torch.equal(yk, yp) and torch.equal(yk_noidx, yp)) \
                        or bad:
                    misses["max_pool2d_fwd"] += 1
                    fail(f"max_pool2d {name} {tuple(shape)} {dtype} "
                         f"ties={ties}: not bit-equal to the plain version "
                         f"(max |dy| {err}, {bad} idx differ)")
    pool_coverage("max_pool2d (phase 2)", seen, ragged_groups)
    seen = set()
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, size, alpha, beta, k, placement in lrn_cases():
            x = lrn_input(shape, dtype, device, gen, placement)
            plan = lrn_plan_for((x,), size)
            seen.add(lrn_mode(plan, dtype))
            log(f"lrn {name} {tuple(shape)} {dtype}"
                f"{', ' + placement if placement else ''}: "
                f"{fmt_lrn_plan(plan)}")
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
    lrn_coverage("lrn (phase 2)", seen)
    log(f"kernels vs plain: max_pool2d_fwd bit-equal in "
        f"{cases['max_pool2d_fwd']} cases (every instantiation on whole "
        f"planes, bands and column tiles); lrn_fwd within tolerance in "
        f"{cases['lrn_fwd']} cases (every instantiation with vectors and "
        f"one pixel a thread; f32 max |err| {errs['lrn_fwd']:.3g})")
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
                                     max_pool2d_bwd_plain, max_pool2d_plain)
    from bigdl_tpu_torch.ops.lrn import lrn_plan_for
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    errs = {"max_pool2d_bwd": 0.0, "lrn_bwd": 0.0}
    cases = {"max_pool2d_bwd": 0, "lrn_bwd": 0}
    misses = {"max_pool2d_bwd": 0, "lrn_bwd": 0}
    seen, ragged_groups = set(), 0

    def held(what, dx, want, dtype):
        err = (dx.float() - want.float()).abs().max().item()
        cases["max_pool2d_bwd"] += 1
        if dtype == torch.float32:
            errs["max_pool2d_bwd"] = max(errs["max_pool2d_bwd"], err)
        if dx.dtype != dtype or not torch.equal(dx, want):
            misses["max_pool2d_bwd"] += 1
            fail(f"max_pool2d_bwd {what}: not bit-equal to the plain "
                 f"version (max |ddx| {err})")

    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, geom, offset in pool_cases():
            variant, plan, mode = pool_take(shape, geom, dtype, True)
            seen.add((variant, mode))
            ragged_groups += shape[0] * shape[1] % plan.planes != 0
            log(f"max_pool2d_bwd {name} {tuple(shape)} {dtype}"
                f"{', dy and codes off 16 bytes' if offset else ''}: "
                f"{variant}, {mode}, {fmt_plan(plan)}")
            for ties in (False, True):
                x = _pool_input(shape, dtype, device, gen, ties)
                _, idx = max_pool2d(x, *geom, return_indices=True)
                dy = torch.randn(tuple(idx.shape), generator=gen,
                                 device=device).to(dtype)
                if offset:
                    dy, idx = _offset_copy(dy), _offset_copy(idx)
                dx = max_pool2d_bwd(dy, idx, geom, shape[2], shape[3])
                if device.type == "cuda":
                    torch.cuda.synchronize()
                want = max_pool2d_bwd_plain(dy, idx, geom, shape[2],
                                            shape[3])
                held(f"{name} {tuple(shape)} {dtype} ties={ties}", dx, want,
                     dtype)
        # through autograd with a strided gradient: the wrapper makes dy
        # contiguous before K3
        for name, shape, *geom in POOL_STRIDED_DY:
            geom = tuple(geom)
            x = _pool_input(shape, dtype, device, gen, False)
            xr = x.clone().requires_grad_()
            y = tnn_pool(tnn, geom).training_()(xr)
            wide = torch.randn(y.shape[:3] + (2 * y.shape[3],),
                               generator=gen, device=device).to(dtype)
            g = wide[..., ::2]
            if g.is_contiguous():
                fail("the strided gradient is contiguous")
            y.backward(g)
            if device.type == "cuda":
                torch.cuda.synchronize()
            _, idx = max_pool2d_plain(x, *geom)
            want = max_pool2d_bwd_plain(g.contiguous(), idx, geom, shape[2],
                                        shape[3])
            held(f"{name} {tuple(shape)} {dtype} through autograd with a "
                 "strided dy", xr.grad, want, dtype)
    pool_coverage("max_pool2d_bwd (phase 2b)", seen, ragged_groups)
    seen = set()
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, size, alpha, beta, k, placement in lrn_cases():
            x = lrn_input(shape, dtype, device, gen, placement)
            dy = torch.randn(shape, generator=gen, device=device).to(dtype)
            if placement:
                dy = _offset_copy(dy)
            _, scale = cross_map_lrn(x, size, alpha, beta, k,
                                     return_scale=True)
            plan = lrn_plan_for((x, scale, dy), size, backward=True)
            seen.add(lrn_mode(plan, dtype))
            log(f"lrn_bwd {name} {tuple(shape)} {dtype}"
                f"{', x and dy ' + placement if placement else ''}: "
                f"{fmt_lrn_plan(plan)}")
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
    lrn_coverage("lrn_bwd (phase 2b)", seen)
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
        f"{cases['max_pool2d_bwd']} cases (every instantiation on whole "
        f"planes, bands and column tiles, strided dy through autograd); "
        f"lrn_bwd within tolerance in {cases['lrn_bwd']} cases (every "
        f"instantiation with vectors and one pixel a thread; f32 max |err| "
        f"{errs['lrn_bwd']:.3g}); autograd round trip card vs CPU held for "
        "both layers")
    return errs, cases, misses


def tnn_pool(tnn, geom):
    """``nn.SpatialMaxPooling`` of a phase-2b geometry."""
    kh, kw, sh, sw, ph, pw, ceil = geom
    layer = tnn.SpatialMaxPooling(kw, kh, sw, sh, pw, ph)
    return layer.ceil() if ceil else layer


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
    for dtype, shapes in ((torch.bfloat16, QUANT_BITEQ),
                          (torch.float32, QUANT_BITEQ_F32)):
        for m, k, n in shapes:
            x = torch.randn((m, k), generator=gen, device=device).to(dtype)
            w = torch.randn((n, k), generator=gen, device=device)
            for mode, fn in (("w8", quant.w8_matmul),
                             ("f8", quant.f8_matmul),
                             ("w4", quant.w4_matmul)):
                qt = quant.pack(w, mode=mode)
                args = (x, qt[{"w8": "q8", "f8": "f8", "w4": "q4"}[mode]],
                        qt["scale"]) + ((k,) if mode == "w4" else ())
                a, b = fn(*args), fn(*args)
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    fail(f"{fn.__name__} {(m, k, n)} {dtype}: two launches "
                         "differ")
    for m, k, n in QUANT_BITEQ_A8:
        x = torch.randn((m, k), generator=gen, device=device)
        qt = quant.pack(torch.randn((n, k), generator=gen, device=device),
                        sx=3.0 / 127)
        xq = quant.quantize_act(x, qt["sx"])
        s = qt["scale"] * qt["sx"]
        a = quant.a8_matmul(xq, qt["q8"], s, torch.float32)
        b = quant.a8_matmul(xq, qt["q8"], s, torch.float32)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            fail(f"a8_matmul {(m, k, n)}: two launches differ")
    log("quantized kernels vs plain: " + "; ".join(
        f"{k} {counts[k]} cases, max |err| f32 {errs[k]:.3g} bf16 "
        f"{errs_bf16[k]:.3g}" for k in names) + " (a8_matmul bit-equal); "
        f"w8/f8/w4_matmul bit-equal over two bf16 launches at {QUANT_BITEQ} "
        f"and two f32 launches at {QUANT_BITEQ_F32}; a8_matmul over two "
        f"launches at {QUANT_BITEQ_A8}")
    return errs, counts, misses


def log_quant_plans(path_shapes):
    """Three lines: the bf16 kernel's plan at every product of the path,
    and whether x comes by TMA there (every Inception shape should); the
    f32 kernel's plan there, and whether x comes by 16-byte copies; K14's
    plan at its products."""
    import torch
    from bigdl_tpu_torch.ops import quant
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans, f32, a8 = [], [], []
    for name, nib in (("w8_matmul", False), ("w4_matmul", True)):
        tag = "K15" if nib else "K13"
        for m, k, n in sorted(set(path_shapes[name])):
            p = quant.bf16_plan(m, k, n, nib, sms)
            blocks = -(-m // p.bm) * p.n_tiles * p.splits
            tma = k % 8 == 0 and (not nib or (k + 1) // 2 % 8 == 0)
            plans.append(f"{tag} {m}x{k}x{n}: bm {p.bm} "
                         f"bn {p.bn}x{p.n_tiles} splits {p.splits}x{p.per}/"
                         f"{p.steps} = {blocks} blocks, x by "
                         f"{'TMA' if tma else 'loads'}")
            p = quant.f32_plan(m, k, n, nib, sms)
            blocks = -(-m // p.bm) * p.n_tiles * p.splits
            vec = k % 4 == 0 and (not nib or (k + 1) // 2 % 4 == 0)
            f32.append(f"{tag} {m}x{k}x{n}: {p.bm}x{p.bn} x{p.n_tiles} "
                       f"splits {p.splits}x{p.per}/{p.steps} = {blocks} "
                       f"blocks, x by {16 if vec else 4}-byte copies")
    for m, k, n in sorted(set(path_shapes["a8_matmul"])):
        p = quant.a8_plan(m, k, n, sms)
        blocks = -(-m // quant.A8_BM) * p.n_tiles * p.splits
        a8.append(f"K14 {m}x{k}x{n}: bn {p.bn}x{p.n_tiles} splits "
                  f"{p.splits}x{p.per}/{p.steps} = {blocks} blocks")
    log("bf16 plans: " + "; ".join(plans))
    log("f32 plans: " + "; ".join(f32))
    log("K14 plans: " + "; ".join(a8))


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
    if lengths is not None:   # a length, or a (lo, hi) hole of padded keys
        pos = torch.arange(tk, device=device)
        keep = torch.stack([
            (pos < L) if isinstance(L, int) else (pos < L[0]) | (pos >= L[1])
            for L in lengths])
        bias = torch.where(keep, 0.0, NEG_INF).float()
    return q, k, v, bias


def check_attention_kernels(device):
    """Hold K8 and K9 against their plain versions at the LM paths' shapes
    (ATTN_PATH) and at ATTN_RAGGED, in float32 and bfloat16, and at
    ATTN_F32_EDGES in float32: K8 on every case without padding, K9 on
    every case; then the f32 K8 and K9 (with the bias and its LSE)
    bit-equal over two launches at ATTN_F32_BITEQ.  Returns per-kernel
    errors (float32 cases), cases and mismatches as :func:`check_kernels`
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
    both = (torch.float32, torch.bfloat16)
    for case, dtypes in [(c, both) for c in ATTN_PATH + ATTN_RAGGED] + \
            [(c, (torch.float32,)) for c in ATTN_F32_EDGES]:
        causal = case[7]
        for dtype in dtypes:
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
    for case in ATTN_F32_BITEQ:
        q, k, v, bias = attention_operands(case, torch.float32, device, gen)
        runs = (("attention_fwd",
                 lambda: (attn.attention_fwd(q, k, v, case[7]),)),
                ("attention_stream_fwd",
                 lambda: attn._launch(attn.attention_stream_fwd,
                                      "bigdl_attention_stream_fwd", q, k, v,
                                      bias, case[7], case[6] ** -0.5,
                                      with_lse=True)))
        for name, run in runs:
            a, b = run(), run()
            torch.cuda.synchronize()
            cases[name] += 1
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                misses[name] += 1
                fail(f"{name} {case[0]} float32: two launches differ")
        del q, k, v, bias
    log("attention kernels vs plain: " + "; ".join(
        f"{k} {cases[k]} cases, max |err| / sum |p·v| f32 {rels[k]:.3g} "
        f"(limit {ATTN_F32_RTOL}; max |err| {errs[k]:.3g}) bf16 "
        f"{rels_bf16[k]:.3g} (limit "
        f"{ATTN_BF16_STEPS * BF16_STEP:.4g})" for k in names) +
        f"; f32 K8 and K9 (bias, LSE) bit-equal over two launches at "
        f"{[c[0] for c in ATTN_F32_BITEQ]}")
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


def cg_picks(shared):
    """The f32 copy's requests: the first CG_F32_REQUESTS // 2 of the
    traffic that share the head, the rest from those that do not."""
    pick = [i for i in range(CG_REQUESTS) if shared[i]][:CG_F32_REQUESTS // 2]
    return pick + [i for i in range(CG_REQUESTS)
                   if not shared[i]][:CG_F32_REQUESTS - len(pick)]


def paged_decode_case():
    """The path's decode shape: 8 slots, 8 heads, S 1, d 64, page size 16,
    Lp 128, each row halfway through the budget of one of the traffic's
    first 8 requests."""
    _, budgets, _ = cg_traffic()
    return ("decode, the path's shape", CG_SLOTS, LM_HEADS, LM_HEADS, 1, 64,
            CG_PAGE, LM_T // CG_PAGE,
            [CG_PROMPT + n // 2 for n in budgets[:CG_SLOTS]], False)


def paged_verify_operands(dtype, cache_dtype, device, seed):
    """A speculative verify pass at the path's decode shape: each of the
    CG_SLOTS rows of :func:`paged_decode_case` expanded into SPEC_K + 1
    rows at S 1, its page table repeated, positions ``pos + i`` over its
    last SPEC_K + 1 tokens.  Returns the case (its b the expanded rows)
    and the operands."""
    import torch
    case = paged_decode_case()
    q, k, v, pages, pos, scale = paged_operands(case, dtype, cache_dtype,
                                                device, seed)
    r = SPEC_K + 1
    g = torch.Generator().manual_seed(seed + 1)
    qv = torch.randn((case[1] * r,) + tuple(q.shape[1:]), generator=g)
    vpos = (pos - SPEC_K + torch.arange(r, device=device)).reshape(-1, 1)
    vcase = ("verify pass, the path's shape",
             case[1] * r) + case[2:8] + ([n for n in case[8] for _ in
                                          range(r)], False)
    return vcase, (qv.to(device, dtype), k, v,
                   pages.repeat_interleave(r, dim=0), vpos, scale)


def check_paged_verify(device):
    """K12 at the verify shape (:func:`paged_verify_operands`) against its
    plain version, in f32, bf16 and f32 q over a bf16 cache.  Returns (max
    |err| f32, max relative error f32 and bf16, cases, mismatches, the
    plan of the verify rows)."""
    import torch
    from bigdl_tpu_torch.ops import attention as attn
    err = rel = rel_bf16 = 0.0
    cases = misses = 0
    for i, (qdt, cdt) in enumerate(((torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16))):
        case, ops = paged_verify_operands(qdt, cdt, device, SEED + 110 + i)
        q, k, v, pages, pos, scale = ops
        got = attn.paged_attention(*ops)
        torch.cuda.synchronize()
        want = attn.paged_attention_plain(*ops)
        mag = attn.paged_attention_plain(q.float(), k.float(),
                                         v.float().abs(), pages, pos, scale)
        e = (got.float() - want.float()).abs()
        rr = (e / mag.clamp_min(1e-30)).max().item()
        tol = (ATTN_F32_RTOL if cdt == torch.float32 else
               ATTN_BF16_STEPS * BF16_STEP) * mag
        ok = bool((e <= tol).all()) and bool(torch.isfinite(got).all())
        cases += 1
        if cdt == torch.float32:
            rel, err = max(rel, rr), max(err, e.max().item())
        else:
            rel_bf16 = max(rel_bf16, rr)
        if not ok:
            misses += 1
            fail(f"paged_attention {case[0]} q {qdt} cache {cdt}: max |err| "
                 f"/ sum |p·v| {rr:.3g}")
    plan = attn.paged_plan(CG_SLOTS * (SPEC_K + 1), *paged_decode_case()[2:8],
                           torch.float32, torch.float32)._asdict()
    return err, rel, rel_bf16, cases, misses, plan


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
    queries over a bf16 cache at the decode shape and the GQA case, logging
    the path each case took (``paged_plan``); then two launches of the
    decode shape and of the 68-row GQA case on each path, bit-equal.
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
    paths = {"tensor_core": [], "split": []}
    for i, (case, qdt, cdt) in enumerate(runs):
        q, k, v, pages, pos, scale = paged_operands(case, qdt, cdt, device,
                                                    SEED + 80 + i)
        plan = attn.paged_plan(*case[1:8], qdt, cdt)
        paths[plan.path].append(f"{case[0]} (q {qdt}, cache {cdt}, "
                                f"{plan.splits} splits)")
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
            fail(f"{name} {case[0]} q {qdt} cache {cdt} ({plan.path}): max "
                 f"|err| / sum |p·v| {r:.3g} beyond tolerance")
        del q, k, v, got, want, mag
    # no atomics on either path: two launches are bit-equal
    for i, case in enumerate((paged_decode_case(), PAGED_RAGGED[9])):
        for dt in (torch.float32, torch.bfloat16):
            ops = paged_operands(case, dt, dt, device, SEED + 95 + i)
            a = attn.paged_attention(*ops)
            b = attn.paged_attention(*ops)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                fail(f"{name} {case[0]} {dt}: two launches differ")
            del ops, a, b
    v_err, v_rel, v_rel_bf16, v_cases, v_misses, v_plan = \
        check_paged_verify(device)
    err, rel, rel_bf16 = max(err, v_err), max(rel, v_rel), \
        max(rel_bf16, v_rel_bf16)
    cases, misses = cases + v_cases, misses + v_misses
    log(f"paged attention at the verify shape ({CG_SLOTS} slots x "
        f"{SPEC_K + 1} rows, tables repeated, positions pos + i; f32, bf16, "
        f"f32 q over a bf16 cache): within tolerance (f32 plan {v_plan})")
    log(f"paged attention kernel vs plain: {cases} cases, max |err| / sum "
        f"|p·v| f32 {rel:.3g} (limit {ATTN_F32_RTOL}; max |err| {err:.3g}) "
        f"bf16 cache {rel_bf16:.3g} (limit "
        f"{ATTN_BF16_STEPS * BF16_STEP:.4g}); two launches bit-equal on "
        f"both paths; tensor-core path: {'; '.join(paths['tensor_core'])}; "
        f"page split: {'; '.join(paths['split'])}")
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
    # the f32 32 x 32 tiles), at 512 (the D-chunked kernels) and on the f32
    # tiles of d 64 and d 128
    for case in (FLASH_PATH[0], FLASH_RAGGED[5] + ("bfloat16",),
                 FLASH_RAGGED[18] + ("bfloat16",),
                 FLASH_RAGGED[19] + ("float32",),
                 FLASH_RAGGED[21] + ("bfloat16",),
                 FLASH_RAGGED[5] + ("float32",),
                 FLASH_RAGGED[28] + ("float32",)):
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


def serve(device, model=None, counts=None, what="serving", n_rows=N_ROWS,
          waves=None, cpu_rows=CPU_ROWS, atol=1e-3):
    """Drive the serving path of ``model`` (Inception-v1 by default) with
    ``n_rows`` requests, then ``waves`` closed-loop waves per bucket;
    ``counts`` are the launches a forward makes (13 K1 + 2 K2 by default),
    and ``cpu_rows`` rows are held against a CPU copy to ``atol``.  Returns
    (report, launches)."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.api import DLClassifier
    from bigdl_tpu_torch.serving import InferenceServer

    model = build_model() if model is None else model
    counts = {"max_pool2d": 13, "cross_map_lrn": 2} if counts is None \
        else counts
    waves = WAVES if waves is None else waves
    cpu_model = copy.deepcopy(model).to("cpu")
    clf = DLClassifier(model, (BATCH, 3, IMAGE, IMAGE), device=device)
    t0 = time.monotonic()
    server = InferenceServer(clf, batch_buckets=BUCKETS, device=device)
    warm_s = time.monotonic() - t0
    rows = make_rows(n_rows, SEED)
    wave_rows = {b: make_rows(b * waves[b], SEED + b) for b in BUCKETS}

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
            for w in range(waves[b]):
                p, lat = timed_wave(wave_rows[b][w * b:(w + 1) * b])
                preds_b += p
                lats += lat
            wall = time.monotonic() - t_b
            lats.sort()
            # a closed-loop smoke, not a throughput or tail measurement:
            # each wave is awaited before the next is sent, and with a few
            # dozen samples only the median and the maximum are reported
            per_bucket[b] = {"images": len(lats), "waves": waves[b],
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
    total = n_rows + sum(b * waves[b] for b in BUCKETS)
    if stats["counters"].get("serve.completed") != total:
        fail(f"{what}: {stats['counters']} — expected {total} completed "
             "requests")
    if launches != per_forward(counts, forwards):
        fail(f"{what}: launches {launches} for {forwards} forwards: expected "
             f"{counts} per forward and nothing else")

    # predictions equal DLClassifier.predict on the same rows
    all_rows = rows + [r for b in BUCKETS for r in wave_rows[b]]
    all_served = served + [p for b in BUCKETS for p in per_bucket[b]["preds"]]
    offline = clf.predict(all_rows)
    if list(offline) != list(all_served):
        bad = sum(int(a != b) for a, b in zip(offline, all_served))
        fail(f"{what}: {bad} of {len(all_rows)} served predictions differ "
             "from DLClassifier.predict")

    # the same weights on the CPU (plain ops), TF32 off on the card
    x8 = torch.from_numpy(np.stack(rows[:cpu_rows]))
    with torch.inference_mode():
        lp_dev = model(x8.to(device)).float().cpu()
        lp_cpu = cpu_model.evaluate()(x8)
    if lp_dev.shape != (cpu_rows, CLASSES) or \
            not torch.isfinite(lp_dev).all():
        fail(f"{what}: device log-probs have shape {tuple(lp_dev.shape)} or "
             "are not finite")
    diff = (lp_dev - lp_cpu).abs().max().item()
    if diff > atol or not torch.equal(lp_dev.argmax(1), lp_cpu.argmax(1)):
        fail(f"{what}: device vs CPU log-probs: max |diff| {diff} (atol "
             f"{atol}), argmax {lp_dev.argmax(1).tolist()} vs "
             f"{lp_cpu.argmax(1).tolist()}")
    if (lp_cpu.argmax(1) + 1).tolist() != list(served[:cpu_rows]):
        fail(f"{what}: served predictions disagree with the CPU run")
    log(f"{what}: {total} requests answered in {forwards} forwards, equal "
        f"to DLClassifier.predict; {cpu_rows} rows match the CPU run "
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

def make_samples(n, seed, image=IMAGE, classes=CLASSES):
    from bigdl_tpu_torch.dataset import Sample
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, 3, image, image)).astype(np.float32)
    y = rng.randint(1, classes + 1, size=n).astype(np.float32)
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
    if opt.state.get("skippedSteps"):
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


def serve_quantized_f32(device):
    """The default quantized classifier: the same seeded Inception-v1 under
    ``DLClassifier(..., quantize="w8")`` with no ``compute_dtype`` (f32
    activations, every product on the f32 K13) behind an
    ``InferenceServer`` at buckets 8 and 32, one wave each: every forward
    launches 56 K13 + 13 K1 + 2 K2 and nothing else, the served classes
    equal ``DLClassifier.predict``'s, and 8 rows agree with a CPU run of
    the same packed copy (argmax on every row, logits within
    QF32_LOGIT_RTOL of their largest magnitude).  Returns the report, the
    launches by bucket and the classifier."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.api import DLClassifier
    from bigdl_tpu_torch.serving import InferenceServer

    clf = DLClassifier(build_model(), (BATCH, 3, IMAGE, IMAGE),
                       quantize="w8", device=device)
    server = InferenceServer(clf, batch_buckets=BUCKETS, device=device)
    rows = {b: make_rows(b, SEED + 50 + b) for b in BUCKETS}
    served, by_path = {}, {}
    try:
        for b in BUCKETS:
            before = server.stats()["buckets"]
            ops.reset_launches()         # this bucket's wave starts here
            futs = [server.submit(r) for r in rows[b]]
            served[b] = [f.result(timeout=600) for f in futs]
            got = launches_now()         # and ends here
            after = server.stats()["buckets"]
            forwards = sum(v["batches"] for v in after.values()) - \
                sum(v["batches"] for v in before.values())
            if got != per_forward(RUNG_LAUNCHES["w8"], forwards):
                fail(f"f32 w8 serving, a wave of {b}: launches {got} for "
                     f"{forwards} forwards, expected "
                     f"{per_forward(RUNG_LAUNCHES['w8'], forwards)}")
            by_path[f"serve_w8_f32_wave_{b}"] = got
    finally:
        if not server.drain(timeout=120):
            fail("f32 quantized server did not drain")
    for b in BUCKETS:
        if list(clf.predict(rows[b])) != served[b]:
            fail(f"f32 w8 served classes of the wave of {b} differ from "
                 "DLClassifier.predict")
    cpu_q = copy.deepcopy(clf.qmodel).to("cpu")
    x8 = clf._pack(rows[8], size=QCPU_ROWS)
    with torch.inference_mode():
        lg_dev, _ = logits_and_logp(clf.qmodel, x8.to(device))
        lg_cpu, _ = logits_and_logp(cpu_q, x8)
    if lg_dev.shape != (QCPU_ROWS, CLASSES) or \
            not torch.isfinite(lg_dev).all():
        fail(f"f32 w8 logits have shape {tuple(lg_dev.shape)} or are not "
             "finite")
    tol = QF32_LOGIT_RTOL * lg_cpu.abs().max().item()
    diff = (lg_dev - lg_cpu).abs().max().item()
    if diff > tol or not torch.equal(lg_dev.argmax(1), lg_cpu.argmax(1)):
        fail(f"f32 w8 card vs CPU: max |dlogit| {diff} (limit {tol}), "
             f"argmax {lg_dev.argmax(1).tolist()} vs "
             f"{lg_cpu.argmax(1).tolist()}")
    log(f"quantized serving (w8, f32, the default): waves of {BUCKETS} "
        "equal to DLClassifier.predict; launches by wave "
        f"{json.dumps(by_path)}; {QCPU_ROWS} rows vs the CPU: max |dlogit| "
        f"{diff:.4g} (limit {tol:.4g}), argmax equal on all {QCPU_ROWS}")
    report = {"cpu_max_abs_logit_diff": diff, "cpu_logit_limit": tol}
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
        ops.reset_launches()             # the f32 LM scoring path starts here
        lp_dev = f32(row.to(device)).float().cpu()
        f32_launches = launches_now()    # and ends here
        lp_cpu = base(row)
    del f32
    if f32_launches != per_forward({"attention_fwd": LM_LAYERS}, 1):
        fail(f"f32 LM forward launches {f32_launches}, expected {LM_LAYERS} "
             "attention_fwd")
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
        f"long context (1 x {LONG_T}) launches {long_launches}; f32 row "
        f"launches {f32_launches}, vs "
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
               "lm_long": long_launches, "lm_f32_row": f32_launches}
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
    fprompts = [prompts[i] for i in cg_picks(shared)]
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


# -- phase 3p: quantized and speculative continuous serving -----------------

def timed_calls(obj, name, into):
    """Wrap ``obj.<name>`` so each call appends its wall seconds to
    ``into`` (a generator's chunk or round, called by its worker)."""
    real = getattr(obj, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            into.append(time.perf_counter() - t0)
    setattr(obj, name, timed)


def lm_step_launches(qmodel, device):
    """Each wrapper's launches in one prefill (1 x CG_PROMPT) and in one
    decode step (CG_SLOTS x 1) of a packed LM through ``decode_pages`` on
    a scratch bf16 pool, the step's packed products as (M, K, N, x dtype,
    rung) and the dtype of its log-probs."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.ops import quant
    lp = CG_PROMPT // CG_PAGE + 1
    seen = []
    real = quant.int8_matmul

    def spy(x, qt):
        seen.append((x.numel() // x.shape[-1], x.shape[-1],
                     qt["scale"].shape[0], str(x.dtype).replace("torch.", ""),
                     quant.packed_kind(qt) + ("+sx" if "sx" in qt else "")))
        return real(x, qt)

    ids = torch.from_numpy(lm_ids((CG_SLOTS, CG_PROMPT + 1), SEED + 75))
    ids = ids.to(device)
    ones = torch.ones(CG_SLOTS, dtype=torch.bool, device=device)
    quant.int8_matmul = spy
    try:
        with torch.inference_mode():
            pool = qmodel.init_paged_cache(CG_SLOTS * lp, CG_PAGE,
                                           torch.bfloat16)
            table = torch.arange(CG_SLOTS * lp, dtype=torch.int32,
                                 device=device).reshape(CG_SLOTS, lp)
            ops.reset_launches()
            qmodel.decode_pages(ids[:1, :CG_PROMPT], pool, table[:1],
                                torch.zeros(1, device=device), ones[:1])
            torch.cuda.synchronize()
            prefill = launches_now()
            del seen[:]
            ops.reset_launches()
            out = qmodel.decode_pages(
                ids[:, CG_PROMPT:], pool, table,
                torch.full((CG_SLOTS,), CG_PROMPT, device=device), ones)
            torch.cuda.synchronize()
            step = launches_now()
    finally:
        quant.int8_matmul = real
    return prefill, step, seen, out.dtype


def held_f32(what, got, want):
    """Hold f32 log-probs ``got`` against ``want`` (the CPU's): max |d|
    within QF32_LOGIT_RTOL of ``want``'s largest magnitude (the rule phase
    3d holds the f32 w8 logits to), and argmax equal wherever the top-2
    margin exceeds twice that.  Returns the figures."""
    limit = QF32_LOGIT_RTOL * want.abs().max().item()
    diff = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    firm = (top2[..., 0] - top2[..., 1]) > 2 * limit
    agree = int((got.argmax(-1) == want.argmax(-1))[firm].sum())
    if not math.isfinite(diff) or diff > limit or agree != int(firm.sum()):
        fail(f"{what}: max |dlogp| {diff} (limit {limit}); argmax equal at "
             f"{agree} of the {int(firm.sum())} positions whose top-2 margin "
             "exceeds twice the limit")
    return {"max_abs_dlogp": diff, "mean_abs_dlogp":
            (got - want).abs().mean().item(), "limit": limit,
            "argmax_compared": int(firm.sum()), "positions": firm.numel()}


def quant_card_vs_cpu(device, base, prompts):
    """The w8 and w8a8 prefill log-probs of two requests (f32 copies, the
    same packed copy on the card and on the CPU; w8a8 calibrated on the
    card over CG_QCAL_PROMPTS prompts) through ``decode_pages``, held by
    :func:`held_f32`.  w8a8 rounds every product's input to its int8
    grid, so where an element lies on a rounding edge the card's and the
    CPU's f32 sums, one ulp apart, round it to neighbouring codes and the
    forwards part from there.  So the CPU run takes the card's codes
    (recorded in call order): each must be within one code of the CPU's
    own, and every element that differs must lie within QA8_EDGE of a
    rounding edge on the CPU; the flips are counted."""
    import torch
    from bigdl_tpu_torch.ops import quant
    f32 = copy.deepcopy(base).to(device)
    calib = quant.calibrate(f32, [p.reshape(1, -1)
                                  for p in prompts[:CG_QCAL_PROMPTS]])
    del f32
    ids = torch.from_numpy(np.stack(prompts[:2]))
    lp = CG_PROMPT // CG_PAGE
    real = quant.quantize_act
    codes, flips = [], {"elements": 0, "codes": 0, "edge": 0.0}

    def record(x, sx):
        q = real(x, sx)
        codes.append(q.cpu())
        flips["codes"] += q.numel()
        return q

    def replay(x, sx):
        q, card = real(x, sx), codes.pop(0)
        off = q.int() - card.int()
        if off.abs().max().item() > 1:
            fail(f"w8a8 card vs CPU: an activation code {off.abs().max()} "
                 "steps from the CPU's")
        off = off != 0
        if off.any():
            v = (x.float() / sx)[off]
            flips["elements"] += int(off.sum())
            flips["edge"] = max(flips["edge"], (
                v - v.floor() - 0.5).abs().max().item())
        return card

    def prefill(m, d, act):
        quant.quantize_act = act
        try:
            with torch.inference_mode():
                pool = m.init_paged_cache(2 * lp, CG_PAGE)
                table = torch.arange(2 * lp, dtype=torch.int32,
                                     device=d).reshape(2, lp)
                return m.decode_pages(
                    ids.to(d), pool, table, torch.zeros(2, device=d),
                    torch.ones(2, dtype=torch.bool, device=d)).cpu()
        finally:
            quant.quantize_act = real

    out = {}
    for mode in ("w8", "w8a8"):
        cpu_q = quant.quantize_model(base, mode, extra_keys=("tok",),
                                     calib=calib if mode == "w8a8" else None)
        card = prefill(copy.deepcopy(cpu_q).to(device), device, record)
        cpu = prefill(cpu_q, torch.device("cpu"),
                      replay if mode == "w8a8" else real)
        out[mode] = held_f32(f"{mode} f32 prefill, card vs CPU", card, cpu)
        if mode == "w8a8":
            if codes or flips["edge"] > QA8_EDGE:
                fail(f"w8a8 card vs CPU: {len(codes)} products unreplayed, "
                     f"or a flipped code {flips['edge']} from a rounding "
                     f"edge (limit {QA8_EDGE})")
            out[mode]["flipped_codes"] = dict(flips)
    return out


def quantized_continuous(device, model, card):
    """Phase 3p, the rungs: ``model`` (3g's bf16 LM on the card, bf16 pool)
    behind ContinuousGenerator(quantize=mode) for each rung, w8 over the
    whole traffic and the others over the f32 copy's requests.  Fails on a
    resident ratio over the rung's budget or launch counts other than
    LM_RUNG_LAUNCHES and 8 K12 a prefill and a step (over the run, and in
    one prefill and one step); logs tokens/s, latency, bytes by dtype and
    the first-token agreement with the fp generator, then the f32 card vs
    CPU check and a profile of the w8 traffic.  Returns the report and the
    launches by path."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.ops import quant
    from bigdl_tpu_torch.serving import ContinuousGenerator
    prompts, budgets, shared = cg_traffic()
    picks = cg_picks(shared)
    fprompts = [prompts[i] for i in picks]
    kw = dict(num_slots=CG_SLOTS, max_len=LM_T, page_size=CG_PAGE,
              seq_buckets=CG_BUCKETS, cache_dtype=torch.bfloat16,
              device=device)
    with ContinuousGenerator(model, **kw) as g:
        fp = g.generate(fprompts, CG_F32_NEW)
    fp_bytes = sum(quant.param_bytes_by_dtype(model).values())
    report, launches, w8 = {}, {}, None
    for mode in quant.MODES:
        extra = {"calibration_prompts": prompts[:CG_QCAL_PROMPTS]} \
            if mode == "w8a8" else {}
        t0 = time.perf_counter()
        gen = ContinuousGenerator(model, quantize=mode, **extra, **kw)
        build_s = time.perf_counter() - t0
        full = mode == "w8"
        rp, rb = (prompts, budgets) if full else \
            (fprompts, [CG_F32_NEW] * len(fprompts))
        chunks = []
        timed_calls(gen, "_plain_chunk", chunks)
        ops.reset_launches()                 # this rung's run starts here
        run = drive_continuous(gen, rp, rb)
        gen.drain()
        got = launches_now()                 # and ends here
        st = gen.stats()
        prefills = st["counters"]["serve.gen.prefills"]
        steps = st["counters"]["serve.gen.steps"]
        per = dict(LM_RUNG_LAUNCHES[mode], paged_attention=LM_LAYERS)
        if got != per_forward(per, prefills + steps):
            fail(f"{mode} continuous serving: launches {got} for {prefills} "
                 f"prefills and {steps} decode steps, expected "
                 f"{per_forward(per, prefills + steps)}")
        outs = run.pop("outputs")
        for out, n in zip(outs, rb):
            if out.shape != (n,) or out.min() < 1 or out.max() > LM_VOCAB:
                fail(f"{mode} continuous serving gave {out.shape} ids or ids "
                     f"out of range for max_new {n}")
        mine = [outs[i] for i in picks] if full else outs
        first = float(np.mean([a[0] == b[0] for a, b in zip(mine, fp)]))
        same = float(np.mean([np.mean(a[:len(b)] == b[:len(a)])
                              for a, b in zip(mine, fp)]))
        by_dtype = quant.param_bytes_by_dtype(gen.model)
        ratio = sum(by_dtype.values()) / fp_bytes
        budget = quant.RUNG_BUDGETS[mode]
        if ratio > budget["max_resident_ratio_vs_bf16"]:
            fail(f"{mode}: resident {ratio:.4f} of the bf16 model's bytes, "
                 f"over its budget {budget['max_resident_ratio_vs_bf16']}")
        prefill1, step1, products, out_dtype = lm_step_launches(gen.model,
                                                                device)
        if prefill1 != per_forward(per, 1) or step1 != per_forward(per, 1):
            fail(f"{mode}: one prefill launched {prefill1} and one decode "
                 f"step {step1}, expected {per_forward(per, 1)} each")
        want_products = sorted(
            (CG_SLOTS, k, n, dt) for k, n, calls, dt in lm_step_products()
            for _ in range(calls))
        if out_dtype != torch.float32 or \
                sorted(p[:4] for p in products) != want_products:
            fail(f"{mode}: the packed LM's step gave {out_dtype} log-probs "
                 f"from products {sorted(set(products))}, expected f32 from "
                 f"{lm_step_products()} at M {CG_SLOTS}")
        kinds = sorted({(m, k, n, dt, kind) for m, k, n, dt, kind
                        in products})
        plans = [f"{kind} {m}x{k}x{n} {dt}: " + json.dumps(
            quant.a8_plan(m, k, n)._asdict() if kind == "q8+sx" else
            (quant.f32_plan if dt == "float32" else quant.bf16_plan)(
                m, k, n, kind == "q4")._asdict())
            for m, k, n, dt, kind in kinds]
        report[mode] = dict(
            run, requests=len(rp), new_tokens=sum(rb), build_s=build_s,
            prefills=prefills, decode_steps=steps,
            chunk_ms_median=1e3 * statistics.median(chunks),
            first_token_agreement_vs_fp=first,
            token_agreement_vs_fp=same, bytes_by_dtype=by_dtype,
            resident_ratio_vs_bf16=ratio, budget=budget,
            launches_per_forward=per, step_products=kinds)
        launches[f"lm_quant_{mode}"] = got
        log(f"[{card}] quantized continuous serving {mode} (bf16 model and "
            f"pool; f32 activations from the packed gather, the out "
            f"projection's bf16 from the pool; {len(rp)} "
            f"requests, {sum(rb)} new tokens): "
            f"{run['new_tokens_per_s']:.1f} new tokens/s, request p50 "
            f"{run['latency_p50_ms']:.1f} ms, max "
            f"{run['latency_max_ms']:.1f} ms, {prefills} prefills, {steps} "
            f"decode steps, a chunk of {gen.steps_per_sync} steps "
            f"{report[mode]['chunk_ms_median']:.2f} ms (median); first "
            f"tokens equal to the fp generator's on {first:.3f} of "
            f"{len(fp)} requests, tokens on {same:.3f} (random weights; "
            f"budget top-1 drop {budget['max_top1_drop']}); resident "
            f"{ratio:.4f} of the bf16 model (limit "
            f"{budget['max_resident_ratio_vs_bf16']}), bytes {by_dtype}; "
            f"launches {per} a prefill and a step; the step's products and "
            "plans: " + "; ".join(plans))
        del gen
    report["card_vs_cpu"] = quant_card_vs_cpu(device, lm_model(), prompts)
    log(f"[{card}] quantized LM, f32 copies, card vs CPU (two {CG_PROMPT}-"
        "token prefills, the same packed copy; log-probs within "
        f"QF32_LOGIT_RTOL {QF32_LOGIT_RTOL} of their largest magnitude; "
        "w8a8's CPU run on the card's activation codes, each flip within "
        f"QA8_EDGE {QA8_EDGE} of a rounding edge): " +
        json.dumps(report["card_vs_cpu"]))
    with ContinuousGenerator(model, quantize="w8", **kw) as g:
        prof = profiled_run(g, fprompts, "serve.gen.steps")
    report["w8"]["profile"] = prof
    log(f"[{card}] w8 continuous serving profile ({len(fprompts)} requests "
        f"x {CG_F32_NEW}): device {prof['device_ms']:.1f} ms "
        f"({prof['device_ms_per_step']:.3f} ms a decode step with the "
        f"prefills spread over them), busy share {prof['busy_share']:.3f} of "
        f"the unprofiled {prof['unprofiled_wall_s']:.3f} s; by kernel "
        f"{json.dumps(prof['groups'])}; top: " + json.dumps(prof["top"]))
    return report, launches


def profiled_run(gen, prompts, counter):
    """``prompts`` x CG_F32_NEW through the warm ``gen`` unprofiled, then
    again under torch.profiler: the device time by kernel, the busy share
    against the unprofiled wall time, and the device time per ``counter``
    (a decode step or a speculative round) of the profiled run."""
    budgets = [CG_F32_NEW] * len(prompts)
    wall = drive_continuous(gen, prompts, budgets)["wall_s"]
    before = gen.stats()["counters"][counter]
    prof = device_profile(lambda: drive_continuous(gen, prompts, budgets),
                          1, QUANT_LM_KERNELS)
    n = gen.stats()["counters"][counter] - before
    prof.update(unprofiled_wall_s=wall,
                busy_share=prof["device_ms"] / (1e3 * wall),
                device_ms_per_step=prof["device_ms"] / n)
    return prof


def draft_of(base, layers):
    """``base``'s first ``layers`` blocks with its ``tok``, ``pos`` and
    ``ln_f`` (bench_serve.py's truncated draft), on the CPU."""
    from bigdl_tpu_torch.convert import export_params, load_jax_params
    from bigdl_tpu_torch.models import TransformerLM
    tree = export_params(base)
    tree["blocks"] = tree["blocks"][:layers]
    draft = TransformerLM(LM_VOCAB, max_len=LM_T, embed_dim=LM_EMBED,
                          num_heads=LM_HEADS, num_layers=layers)
    return load_jax_params(draft, tree).evaluate()


def speculative_continuous(device, model, card):
    """Phase 3p, speculation: ``model`` (3g's bf16 LM on the card) with a
    w8 draft of its first SPEC_DRAFT_LAYERS blocks, SPEC_K proposals a
    round, over the whole traffic with the prefix cache on: launches
    exactly 25 K13 a draft prefill and a draft step (SPEC_K + 1 a round)
    and 8 K12 a prefill and a verify pass; then on f32 copies the tokens
    with the truncated w8 draft, with a draft of SPEC_PARTIAL_LAYERS blocks
    (which must accept some proposals and reject others) and with the
    target as its own draft equal to plain continuous decoding's and to
    ``generate``'s, and a profile of the traffic.  Returns the report and the launches by path."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.serving import ContinuousGenerator
    prompts, budgets, shared = cg_traffic()
    base = lm_model()
    draft = draft_of(base, SPEC_DRAFT_LAYERS).to(device, torch.bfloat16)
    kw = dict(num_slots=CG_SLOTS, max_len=LM_T, page_size=CG_PAGE,
              seq_buckets=CG_BUCKETS, device=device)
    spec = dict(draft_model=draft, draft_quantize="w8", spec_k=SPEC_K)
    gen = ContinuousGenerator(model, cache_dtype=torch.bfloat16, **spec,
                              **kw)
    rounds_s = []
    timed_calls(gen, "_spec_chunk", rounds_s)
    ops.reset_launches()                 # the speculative run starts here
    run = drive_continuous(gen, prompts, budgets)
    gen.drain()
    got = launches_now()                 # and ends here
    st = gen.stats()
    prefills = st["counters"]["serve.gen.prefills"]
    rounds = st["counters"]["serve.gen.steps"]
    draft_products = 6 * SPEC_DRAFT_LAYERS + 1
    want = per_forward({}, 0)
    want.update(w8_matmul=draft_products * (prefills + (SPEC_K + 1) * rounds),
                paged_attention=LM_LAYERS * (prefills + rounds))
    if got != want or prefills != CG_REQUESTS:
        fail(f"speculative serving: launches {got} for {prefills} prefills "
             f"and {rounds} rounds, expected {want}")
    for out, n in zip(run.pop("outputs"), budgets):
        if out.shape != (n,) or out.min() < 1 or out.max() > LM_VOCAB:
            fail(f"speculative serving gave {out.shape} ids or ids out of "
                 f"range for max_new {n}")
    fprompts = [prompts[i] for i in cg_picks(shared)]
    with ContinuousGenerator(model, cache_dtype=torch.bfloat16, **spec,
                             **kw) as g:
        prof = profiled_run(g, fprompts, "serve.gen.steps")
    report = dict(run, prefills=prefills, rounds=rounds, spec=st["spec"],
                  prefix=st["prefix"], round_ms_median=1e3 * statistics.median(
                      rounds_s),
                  launches_per_round={"w8_matmul": draft_products *
                                      (SPEC_K + 1),
                                      "paged_attention": LM_LAYERS},
                  profile=prof)

    # f32 copies: the speculative tokens are plain decoding's
    f32 = copy.deepcopy(base).to(device)
    fdraft = draft_of(base, SPEC_DRAFT_LAYERS).to(device)
    pdraft = draft_of(base, SPEC_PARTIAL_LAYERS).to(device)
    with ContinuousGenerator(f32, **kw) as g:
        plain = g.generate(fprompts, CG_F32_NEW)
    ref = [f32.generate(torch.from_numpy(p[None]).to(device), CG_F32_NEW,
                        device=device)[0].cpu().numpy() for p in fprompts]
    checks = {}
    for name, extra in (("truncated w8 draft",
                         dict(draft_model=fdraft, draft_quantize="w8",
                              spec_k=SPEC_K)),
                        ("partial draft", dict(draft_model=pdraft,
                                               spec_k=SPEC_K)),
                        ("self-draft", dict(draft_model=f32, spec_k=SPEC_K))):
        with ContinuousGenerator(f32, **extra, **kw) as g:
            outs = g.generate(fprompts, CG_F32_NEW)
            checks[name] = g.stats()["spec"]
        for i, (a, b, c) in enumerate(zip(outs, plain, ref)):
            if not (np.array_equal(a, b) and np.array_equal(a, c)):
                fail(f"f32 speculative ({name}) request {i} differs from "
                     f"plain continuous decoding or generate(): "
                     f"{a.tolist()} vs {b.tolist()} and {c.tolist()}")
    rate = checks["partial draft"]["accept_rate"]
    if not 0.0 < rate < 1.0:
        fail(f"f32 speculative (partial draft of {SPEC_PARTIAL_LAYERS} "
             f"blocks): accept rate {rate}, so no round accepted part of its "
             "proposals")
    del f32, fdraft, pdraft, draft
    report["f32_token_check"] = checks
    s = st["spec"]
    log(f"[{card}] speculative continuous serving (bf16 target and pool, "
        f"w8 draft of {SPEC_DRAFT_LAYERS} blocks, spec_k {SPEC_K}; "
        f"{CG_REQUESTS} requests, {sum(budgets)} new tokens): "
        f"{run['new_tokens_per_s']:.1f} new tokens/s, request p50 "
        f"{run['latency_p50_ms']:.1f} ms, max {run['latency_max_ms']:.1f} "
        f"ms; {rounds} rounds (median {report['round_ms_median']:.2f} ms a "
        f"round on the host's clock; over {len(fprompts)} requests x "
        f"{CG_F32_NEW} profiled: device {prof['device_ms_per_step']:.3f} ms "
        f"a round with the prefills spread over them, busy share "
        f"{prof['busy_share']:.3f}), accept "
        f"rate {s['accept_rate']:.4f} ({s['accepted']} of {s['proposed']} "
        f"proposed); launches a round {report['launches_per_round']}, "
        f"{draft_products} K13 and {LM_LAYERS} K12 a prefill; by kernel "
        f"{json.dumps(prof['groups'])}; top: " + json.dumps(prof["top"]))
    log(f"[{card}] f32 speculative tokens ({CG_F32_REQUESTS} requests x "
        f"{CG_F32_NEW}) equal to plain continuous decoding's and "
        f"generate()'s with the truncated w8 draft (accept rate "
        f"{checks['truncated w8 draft']['accept_rate']:.4f}), the draft of "
        f"{SPEC_PARTIAL_LAYERS} blocks (accept rate {rate:.4f}) and the "
        f"self-draft (accept rate {checks['self-draft']['accept_rate']:.4f})")
    return report, {"lm_speculative": got}


# -- phase 3q: multi-turn sessions, parking and the memory budget -----------

def session_traffic():
    """3q's two turns: SESS_N prompts of 3g's CG_HEAD-token head and
    SESS_UNIQUE seeded tokens, then SESS_N seeded turns of SESS_TURN2."""
    prompts, _, shared = cg_traffic()
    head = prompts[shared.index(True)][:CG_HEAD]
    rng = np.random.RandomState(SEED + 140)
    turn1 = [np.concatenate([head, rng.randint(1, LM_VOCAB + 1,
                                               SESS_UNIQUE)])
             for _ in range(SESS_N)]
    turn2 = [rng.randint(1, LM_VOCAB + 1, SESS_TURN2) for _ in range(SESS_N)]
    return turn1, turn2


def session_turn(gen, prompts, max_new):
    """Submit one turn of every session at once; return the outputs and
    the wall seconds to the last."""
    t0 = time.perf_counter()
    futs = [gen.submit(p, max_new, session=f"s{i}")
            for i, p in enumerate(prompts)]
    outs = [f.result(timeout=600) for f in futs]
    return outs, time.perf_counter() - t0


def check_session_books(what, gen, budgeter, tenant, budget_bytes, n):
    """After a turn: every session resident or parked, the tenant's device
    bytes within its budget, ``kv_pages`` the sessions' private pages and
    ``host_offload`` the tier's parked bytes.  Returns the stats."""
    st = gen.stats()
    pb = st["pages"]["page_bytes"]
    infos = [gen.session_info(f"s{i}") for i in range(n)]
    states = sorted({i["state"] for i in infos if i is not None})
    if None in infos or not set(states) <= {"resident", "parked"}:
        fail(f"sessions after {what}: states {states}, "
             f"{sum(i is None for i in infos)} unknown")
    snap = budgeter.snapshot()["tenants"][tenant]
    charged = snap["charged"]
    priv = sum(i["private_pages"] for i in infos)
    if snap["device_bytes"] > budget_bytes:
        fail(f"after {what} the budget's device bytes {snap['device_bytes']}"
             f" exceed the budget {budget_bytes}")
    if charged["kv_pages"] != priv * pb or \
            charged["host_offload"] != st["offload"]["parked_bytes"]:
        fail(f"budget after {what}: {charged}; the sessions hold {priv} "
             f"private pages of {pb} bytes, the tier "
             f"{st['offload']['parked_bytes']} bytes")
    return st


def session_serving(device, model, card):
    """Phase 3q: ``model`` (3g's bf16 LM on the card) behind 3g's generator
    with the pool cut to SESS_PAGES pages and a budget of
    SESS_BUDGET_PAGES pages' bytes, two turns of SESS_N sessions
    (:func:`session_traffic`); the checks of the module doc, then the
    shed on a second generator, the f32 check and ``mem_drill --smoke``.
    Returns the report and the launches of the two turns."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.serving import (ContinuousGenerator,
                                         MemoryBudgetError, MemoryBudgeter)
    from bigdl_tpu_torch.serving.scheduler import mem_drill
    turn1, turn2 = session_traffic()
    kw = dict(num_slots=CG_SLOTS, max_len=LM_T, page_size=CG_PAGE,
              seq_buckets=CG_BUCKETS, device=device)
    budgeter = MemoryBudgeter()
    gen = ContinuousGenerator(model, cache_dtype=torch.bfloat16,
                              num_pages=SESS_PAGES, budgeter=budgeter,
                              budget_tenant="chat", **kw)
    pages = gen.stats()["pages"]
    budget_bytes = SESS_BUDGET_PAGES * pages["page_bytes"]
    budgeter.set_budget("chat", budget_bytes)
    ops.reset_launches()                 # the session path starts here
    out1, wall1 = session_turn(gen, turn1, SESS_NEW)
    st1 = check_session_books("turn 1", gen, budgeter, "chat", budget_bytes,
                              SESS_N)
    out2, wall2 = session_turn(gen, turn2, SESS_NEW)
    launches = launches_now()            # and ends here
    st2 = check_session_books("turn 2", gen, budgeter, "chat", budget_bytes,
                              SESS_N)
    census = st1["sessions"]["total_tokens"]
    if census < 3 * pages["capacity_tokens"]:
        fail(f"open sessions hold {census} tokens after turn 1, under 3x "
             f"the pool's {pages['capacity_tokens']}")
    off = st2["offload"]
    if off["parks"] <= 0 or \
            off["parks"] != off["resumes"] + off["parked_sessions"]:
        fail(f"parks {off['parks']}, resumes {off['resumes']}, still parked "
             f"{off['parked_sessions']}: a parked copy was lost or none "
             "was made")
    prefills = st2["counters"]["serve.gen.prefills"]
    steps = st2["counters"]["serve.gen.steps"]
    want = per_forward({"paged_attention": LM_LAYERS * (prefills + steps)}, 1)
    if launches != want or prefills != 2 * SESS_N:
        fail(f"sessions launched {launches} over {prefills} prefills and "
             f"{steps} decode steps, expected {want}")
    for out in out1 + out2:
        if out.shape != (SESS_NEW,) or out.min() < 1 or \
                out.max() > LM_VOCAB:
            fail(f"a session turn gave {out.shape} ids or ids out of range")
    for i in range(SESS_N):
        if gen.close_session(f"s{i}").result(timeout=60) is not True:
            fail(f"session s{i} did not close")
    charged = budgeter.snapshot()["tenants"]["chat"]["charged"]
    gen.drain()
    if charged["kv_pages"] or charged["host_offload"]:
        fail(f"budget after closing every session: {charged}")

    # a request whose pages can never fit a budget under 128 pages
    small = MemoryBudgeter()
    with ContinuousGenerator(model, cache_dtype=torch.bfloat16,
                             num_pages=SESS_PAGES, budgeter=small,
                             warmup=False, **kw) as g:
        small.set_budget("default", SESS_SMALL_BUDGET * pages["page_bytes"])
        try:       # 128 pages at most: max_len 2048 allows no more
            g.submit(turn1[0], LM_T - turn1[0].size)
            fail("a request over the whole budget was admitted")
        except MemoryBudgetError as e:
            shed = str(e)
    f32 = sessions_f32(device)
    drill = mem_drill.main(["--smoke", "--device", "cuda"])
    if drill != 0:
        fail(f"mem_drill --smoke returned {drill} on the card")
    report = {
        "sessions": SESS_N, "pool_pages": SESS_PAGES,
        "budget_pages": SESS_BUDGET_PAGES,
        "page_bytes": pages["page_bytes"],
        "census_tokens_after_turn1": census,
        "turn1_wall_s": wall1, "turn2_wall_s": wall2,
        "turn2_new_tokens_per_s": SESS_N * SESS_NEW / wall2,
        "offload": off, "sessions_after_turn2": st2["sessions"],
        "budget_after_turn2": st2["budget"], "prefills": prefills,
        "decode_steps": steps, "chunks": st2["chunks"],
        "prefix": st2["prefix"], "small_budget_shed": shed,
        "f32": f32, "mem_drill_smoke": drill}
    log(f"[{card}] sessions (bf16, {SESS_N} sessions, pool {SESS_PAGES} "
        f"pages, budget {SESS_BUDGET_PAGES} pages of "
        f"{pages['page_bytes']} B): census after turn 1 {census} tokens "
        f"({census / pages['capacity_tokens']:.2f}x the pool); turn 1 "
        f"{wall1:.3f} s, turn 2 {wall2:.3f} s "
        f"({report['turn2_new_tokens_per_s']:.1f} new tokens/s); parks "
        f"{off['parks']}, resumes {off['resumes']}, still parked "
        f"{off['parked_sessions']}, peak parked {off['peak_parked_bytes']} B; "
        f"{prefills} prefills, {steps} decode steps, launches {launches}; "
        f"budget exact after each turn and 0 after the closes; "
        f"byte-starved shed typed; f32 tokens equal generate() and a run "
        f"that never parks with K12 and paged_kernel=False; mem_drill "
        f"--smoke 0")
    return report, {"lm_sessions": launches}


def sessions_f32(device):
    """3q's f32 check: 3g's f32 requests as 8 sessions, all parked after
    turn 1, then SESS_F32_TURN2 seeded tokens and as many new, with K12
    and with ``paged_kernel=False``: each turn's tokens equal ``generate``
    over the whole history on the card and a run that never parks."""
    import torch
    from bigdl_tpu_torch.serving import ContinuousGenerator
    prompts, _, shared = cg_traffic()
    first = [prompts[i] for i in cg_picks(shared)]
    rng = np.random.RandomState(SEED + 141)
    second = [rng.randint(1, LM_VOCAB + 1, SESS_F32_TURN2) for _ in first]
    f32 = lm_model().to(device)
    kw = dict(num_slots=CG_SLOTS, max_len=LM_T, page_size=CG_PAGE,
              seq_buckets=CG_BUCKETS, device=device)

    def gen_ref(p, n):
        return f32.generate(torch.from_numpy(np.asarray(p)[None]).to(device),
                            n, device=device)[0].cpu().numpy()

    ref1 = [gen_ref(p, CG_F32_NEW) for p in first]
    ref2 = [gen_ref(np.concatenate([p, r, q]), SESS_F32_TURN2)
            for p, r, q in zip(first, ref1, second)]
    runs = {}
    for name, extra in (("kernel", {}), ("hoisted", {"paged_kernel": False})):
        for park in (True, False):
            with ContinuousGenerator(f32, **kw, **extra) as g:
                a, _ = session_turn(g, first, CG_F32_NEW)
                if park and not all(g.park(f"s{i}").result(timeout=60)
                                    for i in range(len(first))):
                    fail(f"f32 sessions ({name}): a park was refused")
                b, _ = session_turn(g, second, SESS_F32_TURN2)
                off = g.stats()["offload"]
            want = len(first) if park else 0
            if off["parks"] != want or off["resumes"] != want:
                fail(f"f32 sessions ({name}, park {park}): {off}")
            runs[(name, park)] = a + b
    for key, outs in runs.items():
        for i, (o, r) in enumerate(zip(outs, ref1 + ref2)):
            if not np.array_equal(o, r):
                fail(f"f32 session turn {1 + i // len(first)} ({key}) of "
                     f"request {i % len(first)} differs from generate(): "
                     f"{o.tolist()} vs {r.tolist()}")
    del f32
    return {"sessions": len(first), "turn1_new": CG_F32_NEW,
            "turn2_tokens": SESS_F32_TURN2, "runs_equal": len(runs)}


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


# -- phase 3l/3m/3n: ResNet-50, Inception-v2 and the CIFAR-10 ResNet ---------

# rows and batch held against the CPU: a CPU forward of ResNet-50 takes
# about a second a row, Inception-v2's two
CNN_CPU_ROWS = 2
CNN_CPU_BATCH = 2
CNN_TOL = 1e-4                 # f32 card vs CPU, of the largest magnitude
CNN_FLOOR_FACTOR = 4           # card vs CPU after an update, of the floor
CNN_WAVES = {8: 1, 32: 1}      # Inception-v2: one serving wave per bucket
V2_STEPS = 20
CIFAR_IMAGE, CIFAR_CLASSES = 32, 10
CIFAR_BATCH, CIFAR_STEPS, CIFAR_SAMPLES = 128, 8, 512
# BatchNorm's kernels by name, ATen's own (a BN without weight, as the port
# calls it) and cuDNN's, and K1's and K3's (csrc/max_pool.cu)
CNN_KERNELS = {"batch_norm (ATen)": "batch_norm", "batch_norm (cuDNN)": "bn_",
               "K1": "pool_fwd<", "K3": "pool_bwd<"}


def resnet50():
    from bigdl_tpu_torch.models import ResNet
    return ResNet(CLASSES, 50, "B", "imagenet").reset(SEED)


def inception_v2():
    from bigdl_tpu_torch.models import Inception_v2
    return Inception_v2(CLASSES).reset(SEED)


def cifar_resnet20():
    from bigdl_tpu_torch.models import ResNet
    return ResNet(CIFAR_CLASSES, 20, "A", "cifar10").reset(SEED)


def resnet_recipe(steps):
    """``models/resnet.py`` ``train_main``'s criterion and SGD: lr 0.1,
    weight decay 1e-4, momentum 0.9, no dampening, nesterov,
    ``EpochDecay(cifar10_decay)``."""
    from bigdl_tpu_torch.models import cifar10_decay
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, EpochDecay
    return CrossEntropyCriterion(), SGD(
        learning_rate=0.1, weight_decay=1e-4, momentum=0.9, dampening=0.0,
        nesterov=True, learning_rate_schedule=EpochDecay(cifar10_decay))


def inception_recipe(steps):
    """``models/inception.py`` ``train_main``'s: ClassNLL, SGD 0.01, weight
    decay 2e-4, momentum 0.9, no dampening, ``Poly(0.5)`` over the run."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Poly
    return ClassNLLCriterion(), SGD(
        learning_rate=0.01, weight_decay=2e-4, momentum=0.9, dampening=0.0,
        learning_rate_schedule=Poly(0.5, steps))


def cnn_trainer(model, recipe, samples, batch, steps, mixed, device,
                val=None):
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.optim import (LocalOptimizer, Top1Accuracy,
                                       Top5Accuracy, Trigger)
    criterion, method = recipe(steps)
    opt = LocalOptimizer(model, criterion,
                         DataSet.array(samples) >> SampleToBatch(batch),
                         Trigger.max_iteration(steps), device=device)
    opt.set_optim_method(method).set_mixed_precision(mixed).set_seed(SEED)
    if val is not None:
        opt.set_validation(Trigger.several_iteration(VAL_EVERY),
                           DataSet.array(val) >> SampleToBatch(batch),
                           [Top1Accuracy(), Top5Accuracy()])
    return opt


def bn_layers(model):
    from bigdl_tpu_torch.nn import BatchNormalization
    return [m for m in model.modules() if isinstance(m, BatchNormalization)]


def calibrate_bn(model, device, seed):
    """Give every BN layer of ``model`` the statistics of one training-mode
    forward over 8 seeded images (momentum 1 for that forward), as a trained
    model has statistics that fit its activations; with the reset ones (0
    and 1) the activations of an eval forward vanish and the log-probs are
    the classifier's bias.  Returns the model on ``device``, in eval
    mode."""
    import torch
    layers = bn_layers(model)
    saved = [m.momentum for m in layers]
    x = torch.from_numpy(np.stack(make_rows(8, seed))).to(device)
    for m in layers:
        m.momentum = 1.0
    model.to(device).training_()
    with torch.no_grad():
        model(x)
    for m, momentum in zip(layers, saved):
        m.momentum = momentum
    return model.evaluate()


def check_running_stats(what, model):
    """Fail unless every BN layer's running mean and variance are f32,
    finite, and moved from their reset values 0 and 1."""
    import torch
    layers = bn_layers(model)
    bad = [i for i, m in enumerate(layers)
           if m.running_mean.dtype != torch.float32
           or m.running_var.dtype != torch.float32
           or not torch.isfinite(m.running_mean).all()
           or not torch.isfinite(m.running_var).all()
           or not bool((m.running_mean != 0).any())
           or not bool((m.running_var != 1).any())]
    if not layers or bad:
        fail(f"{what}: the running statistics of BN layers {bad} (of "
             f"{len(layers)}) are not f32, not finite or did not move")
    return len(layers)


def train_cnn(device, what, build, recipe, steps, counts, val_counts,
              mixed=True, batch=None, image=IMAGE, classes=CLASSES,
              n_samples=None, validate=True):
    """Train ``build()`` ``steps`` steps by ``recipe`` (bf16 mixed precision
    by default), validating every VAL_EVERY steps; fail unless the losses
    are finite, no step is skipped, the launches are ``counts`` a step and
    ``val_counts`` a validation forward, and every BN layer's running
    statistics moved.  Returns (report, launches, trainer)."""
    from bigdl_tpu_torch import ops
    batch = BATCH if batch is None else batch
    n_samples = TRAIN_SAMPLES if n_samples is None else n_samples
    val = make_samples(VAL_SAMPLES, SEED + 200, image, classes) \
        if validate else None
    opt = cnn_trainer(build(), recipe,
                      make_samples(n_samples, SEED + 100, image, classes),
                      batch, steps, mixed, device, val=val)
    ops.reset_launches()                 # the training path starts here
    opt.optimize()
    launches = launches_now()
    losses = [r["loss"] for r in opt.step_records]   # the path ends here
    log(f"{what} losses ({'bf16 mixed' if mixed else 'f32'}, "
        f"{len(losses)} steps): "
        + json.dumps([round(v, 6) for v in losses]))
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"{what}: {len(losses)} losses, finite: "
             f"{bool(np.isfinite(losses).all())}")
    if opt.state.get("skippedSteps"):
        fail(f"{what}: {opt.state.get('skippedSteps')} steps skipped as "
             "non-finite")
    val_fwd = 0
    report = {}
    if validate:
        top1, top5 = opt.state.get("lastValidation") or (None, None)
        if top1 is None or top1.count != VAL_SAMPLES:
            fail(f"{what}: validation did not run on {VAL_SAMPLES} "
                 f"samples: {top1}")
        val_fwd = steps // VAL_EVERY * (VAL_SAMPLES // batch)
        report.update(top1=top1.result()[0], top5=top5.result()[0])
    want = {k: v * steps for k, v in counts.items()}
    for k, v in val_counts.items():
        want[k] = want.get(k, 0) + v * val_fwd
    expect_launches(f"{what} training", launches, want)
    n_bn = check_running_stats(f"{what} training", opt.model)
    report.update(losses=losses, steps=steps, batch=batch, bn_layers=n_bn,
                  step_ms=1e3 * statistics.median(
                      r["dur_s"] for r in opt.step_records[1:]),
                  first_step_ms=1e3 * opt.step_records[0]["dur_s"])
    report["images_per_s"] = batch / report["step_ms"] * 1e3
    log(f"{what} training: {steps} steps at batch {batch}, none skipped, "
        f"{n_bn} BN layers' running statistics moved; launches {launches}")
    return report, launches, opt


def rel_l2(got, want):
    """||got - want|| / ||want|| over every tensor of the two lists
    together, in f64 on the host."""
    num = sum(float((a.detach().double().cpu() - b.detach().double().cpu())
                    .pow(2).sum()) for a, b in zip(got, want))
    den = sum(float(b.detach().double().cpu().pow(2).sum()) for b in want)
    return math.sqrt(num / max(den, 1e-300))


def largest_rel(got, want):
    """max over pairs of max |got - want| / max |want|."""
    return max((a.detach().float().cpu() - b.detach().float().cpu()).abs()
               .max().item() / max(b.detach().float().abs().max().item(),
                                   1e-30)
               for a, b in zip(got, want))


def perturbed(samples, seed):
    """``samples`` with every input value moved by about one f32 rounding
    step (x * (1 + 1e-7 z), z standard normal)."""
    from bigdl_tpu_torch.dataset import Sample
    rng = np.random.RandomState(seed)
    return [Sample((s.feature * (1 + 1e-7 * rng.standard_normal(
        s.feature.shape))).astype(np.float32), s.label) for s in samples]


def two_steps(build, recipe, samples, batch, device):
    """Two f32 steps of ``recipe``: (losses, state leaves after step 1,
    weights and state leaves after step 2) on the host."""
    from bigdl_tpu_torch.optim import Trigger
    opt = cnn_trainer(build(), recipe, samples, batch, 1, False, device)
    opt.optimize()
    state1 = [b.detach().cpu().clone() for b in opt.model.state_leaves()]
    opt.set_end_when(Trigger.max_iteration(2))
    opt.optimize()
    return ([r["loss"] for r in opt.step_records], state1,
            [p.detach().cpu() for p in opt.model.param_leaves()],
            [b.detach().cpu() for b in opt.model.state_leaves()])


def cnn_train_vs_cpu(device, what, build, recipe, batch=CNN_CPU_BATCH):
    """Two f32 steps of the recipe from the same weights on the card and on
    the CPU.  Step 1's loss and the running statistics it leaves are a
    forward's and agree within CNN_TOL of their largest magnitude.  From
    step 1's update on, the two runs part as the model amplifies rounding
    (at random init BatchNorm makes the gradient sensitive to it), so the
    weights, step 2's loss and the statistics after it are held within
    CNN_FLOOR_FACTOR times the CPU's distance from itself when its input
    moves by one f32 rounding step (a third run), by the same measures
    (losses relative, tensors by relative L2 over all of them), and never
    tighter than CNN_TOL."""
    import torch
    samples = make_samples(2 * batch, SEED + 300)
    card = two_steps(build, recipe, samples, batch, device)
    cpu = two_steps(build, recipe, samples, batch, torch.device("cpu"))
    moved = two_steps(build, recipe, perturbed(samples, SEED + 301), batch,
                      torch.device("cpu"))

    def measures(run):
        return {"loss1": abs(run[0][0] - cpu[0][0]) / abs(cpu[0][0]),
                "state1": largest_rel(run[1], cpu[1]),
                "loss2": abs(run[0][1] - cpu[0][1]) / abs(cpu[0][1]),
                "weights2": rel_l2(run[2], cpu[2]),
                "state2": rel_l2(run[3], cpu[3])}
    got, floor = measures(card), measures(moved)
    limits = {k: CNN_TOL if k in ("loss1", "state1") else
              max(CNN_TOL, CNN_FLOOR_FACTOR * floor[k]) for k in got}
    log(f"{what} train card vs CPU (2 f32 steps, batch {batch}): "
        f"losses {card[0]} vs {cpu[0]}; card "
        + ", ".join(f"{k} {got[k]:.3g} (limit {limits[k]:.3g}, CPU floor "
                    f"{floor[k]:.3g})" for k in got))
    bad = [k for k in got if not got[k] <= limits[k]]
    if bad:
        fail(f"{what}: card vs CPU beyond the limits at {bad}")
    return {"losses_card": card[0], "losses_cpu": cpu[0], "card": got,
            "cpu_floor": floor, "limits": limits}


def cnn_bf16_vs_cpu(device, what, model, rows, min_steps=0):
    """One bf16 eval forward (``mixed_forward``) of ``model`` (on the card,
    its statistics calibrated) on ``rows`` against the same on the CPU.
    Over a deep net bf16 rounding adds up: the limit is the CPU's own bf16
    error on these rows (max |bf16 - f32| of its logits), also given in
    bf16 steps of the largest logit, and never below ``min_steps`` of
    those steps (the logits are themselves rounded to bf16, so where the
    CPU's own error is under one step, one rounding of the last layer's
    output can part the two by one step); argmax equal on every row whose
    top-2 margin exceeds the limit."""
    import torch
    from bigdl_tpu_torch.core.precision import mixed_forward
    from bigdl_tpu_torch.nn import Sequential
    body = Sequential(*list(model.layers)[:-1]).evaluate()
    cpu_body = copy.deepcopy(body).to("cpu")
    x = torch.from_numpy(np.stack(rows))
    with torch.inference_mode():
        got = mixed_forward(body, x.to(device)).cpu()
        want = mixed_forward(cpu_body, x)
        exact = cpu_body(x)
    step = bf16_step(want.abs().max().item())
    limit = max((want - exact).abs().max().item(), min_steps * step)
    steps = limit / step
    diff = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    firm = (top2[:, 0] - top2[:, 1]) > limit
    agree = bool((got.argmax(-1) == want.argmax(-1))[firm].all())
    log(f"{what} bf16 eval forward card vs CPU ({len(rows)} rows): max "
        f"|dlogit| {diff:.4g}, limit {limit:.4g} (the CPU's bf16 against its "
        f"f32: {(want - exact).abs().max().item() / step:.1f} bf16 steps of "
        f"{want.abs().max().item():.4g}; at least {min_steps}); argmax "
        f"compared on {int(firm.sum())} rows")
    if not math.isfinite(diff) or diff > limit or not agree:
        fail(f"{what}: bf16 eval logits card vs CPU: max |d| {diff} beyond "
             f"{limit}, or argmax differs on a firm row")
    return {"max_abs_dlogit": diff, "limit": limit, "limit_bf16_steps": steps,
            "argmax_compared": int(firm.sum())}


def cnn_path(device, what, build, recipe, steps, pools, n_rows, waves):
    """Phases 3l and 3m: serve ``build()`` (statistics calibrated) through
    ``DLClassifier`` + ``InferenceServer`` (``n_rows`` requests, then
    ``waves`` per bucket), train it by ``recipe`` in bf16, hold 2 f32 steps
    and a bf16 eval forward against the CPU.  ``pools`` is its count of K1
    a forward (and of K3 a step).  Returns (serving report, training
    report, launches by path)."""
    model = calibrate_bn(build(), device, SEED + 9)
    report, serve_launches = serve(
        device, model, {"max_pool2d": pools}, f"{what} serving",
        n_rows=n_rows, waves=waves, cpu_rows=CNN_CPU_ROWS)
    report["bf16_vs_cpu"] = cnn_bf16_vs_cpu(
        device, what, model, make_rows(CNN_CPU_ROWS, SEED + 11))
    train_report, train_launches, _ = train_cnn(
        device, what, build, recipe, steps,
        {"max_pool2d": pools, "max_pool2d_bwd": pools},
        {"max_pool2d": pools})
    train_report["card_vs_cpu"] = cnn_train_vs_cpu(device, what, build,
                                                   recipe)
    return report, train_report, {"serve": serve_launches,
                                  "train": train_launches}


def cifar_path(device):
    """Phase 3n: the CIFAR-10 ResNet-20 (shortcut A: ``Padding``) trained
    by the reference recipe in f32 at batch 128: no pool kernel runs."""
    report, launches, _ = train_cnn(
        device, "CIFAR-10 ResNet-20", cifar_resnet20, resnet_recipe,
        CIFAR_STEPS, {}, {}, mixed=False, batch=CIFAR_BATCH,
        image=CIFAR_IMAGE, classes=CIFAR_CLASSES, n_samples=CIFAR_SAMPLES,
        validate=False)
    return report, launches


def profile_cnn_steps(device, build, recipe, mixed=True, steps=3):
    """Device time by kernel over ``steps`` training steps after as many
    warm-up steps, BN's and K1/K3's kernels grouped (CNN_KERNELS)."""
    from bigdl_tpu_torch.optim import Trigger
    opt = cnn_trainer(build(), recipe, make_samples(TRAIN_SAMPLES, SEED + 100),
                      BATCH, steps, mixed, device)
    opt.optimize()
    opt.set_end_when(Trigger.max_iteration(2 * steps))
    return device_profile(opt.optimize, steps, CNN_KERNELS)


def time_cnn(card, device, what, path, pools):
    """Phase 4 of a CNN path: K1/K3 at its pools (f32 serving, bf16
    training), its serving forward per bucket, its bf16 step, and a
    profile of the step (BN's share, the device's busy share)."""
    import torch
    serve_report, train_report, build, recipe = path
    fwd = {"max_pool2d_fwd": pool_sums(
               time_pool_layers(device, torch.float32, False, layers=pools))}
    train = {"max_pool2d_fwd": pool_sums(time_pool_layers(
                 device, torch.bfloat16, False, layers=pools)),
             "max_pool2d_bwd": pool_sums(time_pool_layers(
                 device, torch.bfloat16, True, layers=pools))}
    log_pool_times(card, f"{what} max_pool2d_fwd (f32, no index, serving)",
                   fwd["max_pool2d_fwd"])
    log_pool_times(card, f"{what} max_pool2d_fwd (bf16 with index, "
                   "training)", train["max_pool2d_fwd"])
    log_pool_times(card, f"{what} max_pool2d_bwd (bf16, training)",
                   train["max_pool2d_bwd"])
    fwd_ms = time_forwards(serve_report.pop("classifier"), device)
    serve_report["forward_ms"] = fwd_ms
    for b in BUCKETS:
        r = serve_report["per_bucket"][b]
        log(f"[{card}] {what} forward bucket {b} (f32): {fwd_ms[b]:.3f} ms "
            f"median of {TIMING_REPS} ({b / fwd_ms[b] * 1e3:.1f} images/s); "
            f"serving (closed loop, {r['waves']} waves of {b}): "
            f"{r['images_per_s']:.1f} images/s, request p50 "
            f"{r['p50_ms']:.2f} ms, max {r['max_ms']:.2f} ms")
    ms = train_report["step_ms"]
    p = profile_cnn_steps(device, build, recipe)
    p["busy_share"] = p["device_ms"] / ms
    train_report["profile"] = p
    bn = p["groups"]["batch_norm (ATen)"] + p["groups"]["batch_norm (cuDNN)"]
    log(f"[{card}] {what} train step (bf16 mixed, batch {BATCH}, median "
        f"after the first of {train_report['steps']}): {ms:.3f} ms "
        f"({train_report['images_per_s']:.1f} images/s); profile: device "
        f"{p['device_ms']:.3f} ms a step, busy share "
        f"{p['busy_share']:.3f}; BN kernels {bn:.3f} ms a step "
        f"({bn / p['device_ms']:.3f} of the device time; "
        f"{json.dumps(p['groups'])}); top kernels (ms a step): "
        + json.dumps(p["top"]))
    return fwd, train


# -- phase 3o: the perf harness (models/perf.py local and infer) -----------

HARNESS_ITERS = 5              # the harness's -i, cut from its default 50
# each wrapper's launches in one forward of the harness's models; a step
# launches each backward kernel as often as its forward
HARNESS_FORWARD = {
    "alexnet": {"max_pool2d": 3, "cross_map_lrn": 2},
    "alexnetowt": {"max_pool2d": 3},
    "inception_v1": {"max_pool2d": 13, "cross_map_lrn": 2},
    "inception_v2": {"max_pool2d": 5},
    "vgg16": {"max_pool2d": 5},
    "vgg19": {"max_pool2d": 5},
}
BACKWARD_OF = {"max_pool2d": "max_pool2d_bwd", "cross_map_lrn": "lrn_bwd"}
# K1-K4 by kernel name (csrc/max_pool.cu, csrc/lrn.cu), cuDNN's layout
# transforms around its bf16 and NHWC convolutions, PyTorch's elementwise
# kernels and BatchNorm's; the rest of the device time is cuDNN's
# convolutions and cuBLAS's products
HARNESS_KERNELS = {"K1": "pool_fwd<", "K3": "pool_bwd<", "K2": "lrn_fwd",
                   "K4": "lrn_bwd",
                   "layout transforms": ("nchwToNhwc", "nhwcToNchw",
                                         "genericTranspose"),
                   "elementwise": "elementwise_kernel",
                   "batch_norm": "batch_norm"}


def harness_step_counts(name):
    fwd = HARNESS_FORWARD[name]
    return dict(fwd, **{BACKWARD_OF[k]: v for k, v in fwd.items()})


class PlanLog:
    """Records the plan of every K1-K4 launch while open, by (kernel,
    shape, geometry or window, dtype)."""

    def __enter__(self):
        from bigdl_tpu_torch.ops import lrn, pooling
        self.seen = {}
        self.saved = (pooling.pool_plan, lrn.lrn_plan_for)
        pool_plan, lrn_plan_for = self.saved

        def pool_wrapped(n, c, h, w, geom, dtype, backward=False, **kw):
            plan = pool_plan(n, c, h, w, geom, dtype, backward=backward,
                             **kw)
            self.seen[("K3" if backward else "K1", (n, c, h, w),
                       tuple(geom), str(dtype))] = plan
            return plan

        def lrn_wrapped(tensors, size, backward=False):
            plan = lrn_plan_for(tensors, size, backward)
            self.seen[("K4" if backward else "K2", tuple(tensors[0].shape),
                       size, str(tensors[0].dtype))] = plan
            return plan
        pooling.pool_plan, lrn.lrn_plan_for = pool_wrapped, lrn_wrapped
        return self.seen

    def __exit__(self, *exc):
        from bigdl_tpu_torch.ops import lrn, pooling
        pooling.pool_plan, lrn.lrn_plan_for = self.saved


def fmt_seen_plan(key, plan):
    kernel, shape, geom, dtype = key
    dtype = dtype.replace("torch.", "")
    if kernel in ("K1", "K3"):
        return (f"{kernel} {shape} {dtype} {geom}: {pool_mode(plan)}, "
                f"{fmt_plan(plan)}")
    return f"{kernel} {shape} {dtype} size {geom}: {fmt_lrn_plan(plan)}"


def harness_profile(name, sub, device, steps=3):
    """Device time a step (``local``) or a forward (``infer``, bf16) of
    the harness's own step or forward on a fresh build of ``name`` at its
    batch, over ``steps`` after one, by torch.profiler, its kernels
    grouped (HARNESS_KERNELS)."""
    import torch
    from bigdl_tpu_torch.models import perf
    model = perf._build(name).to(device)
    data, labels = perf._synthetic_batch(name, HARNESS_BATCH, "random")
    if sub == "local":
        model.training_().set_generator(
            torch.Generator(device).manual_seed(1))
        step = perf.local_step(model, data, labels, device)
        float(step(0))

        def run():
            for i in range(1, steps + 1):
                float(step(i))
    else:
        fwd = perf.infer_forward(model.evaluate(), data, False, device)
        fwd()

        def run():
            for _ in range(steps):
                fwd()
    return device_profile(run, steps, HARNESS_KERNELS)


def perf_harness(device, card):
    """Phase 3o: ``perf local`` and ``perf infer`` (bf16) for each model of
    the harness at batch 128, ``-d random``, ``-i HARNESS_ITERS``, through
    ``models/perf.py``'s own entry points.  Fails unless every loss is
    finite and every wrapper's launches are the model's counts a step (or
    a forward) times the warm-up and the timed iterations.  Logs records/s,
    ms a step, the device time and busy share of a profiled run of the
    harness's step or forward, the peak of allocated memory and the K1-K4
    plans each run took.  Returns (report, launches by path)."""
    import gc
    import logging
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.models import perf
    torch.cuda.init()       # the allocator's statistics need it
    root = logging.getLogger("bigdl_tpu_torch")
    saved = (list(root.handlers), root.propagate, root.level)
    report, launches = {}, {}
    try:
        for name in perf._INPUT_SIZES:
            report[name] = {}
            for sub, main_fn, counts in (
                    ("local", perf.local_perf_main,
                     harness_step_counts(name)),
                    ("infer", perf.infer_perf_main, HARNESS_FORWARD[name])):
                argv = ["-m", name, "-b", str(HARNESS_BATCH), "-i",
                        str(HARNESS_ITERS), "-d", "random"]
                torch.cuda.reset_peak_memory_stats(device)
                with LogArgs("bigdl_tpu_torch.models.perf",
                             "Iteration ") as lines, PlanLog() as plans:
                    ops.reset_launches()        # the harness starts here
                    ips = main_fn(argv, device=device)
                    got = launches_now()        # and ends here
                peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
                gc.collect()
                torch.cuda.empty_cache()
                path = f"perf_{sub}_{name}"
                launches[path] = got
                expect_launches(f"perf {sub} {name}", got,
                                {k: v * (HARNESS_ITERS + 1)
                                 for k, v in counts.items()})
                losses = [a[1] for a in lines] if sub == "local" else []
                if len(lines) != HARNESS_ITERS or \
                        not np.isfinite(losses).all():
                    fail(f"perf {sub} {name}: {len(lines)} iterations "
                         f"logged, losses {losses}")
                for key, plan in sorted(plans.items()):
                    log(f"perf {sub} {name} plan: {fmt_seen_plan(key, plan)}")
                prof = harness_profile(name, sub, device)
                gc.collect()
                torch.cuda.empty_cache()
                ms = HARNESS_BATCH / ips * 1e3
                prof["busy_share"] = prof["device_ms"] / ms
                prof["groups"]["the rest: convolutions, products"] = \
                    prof["device_ms"] - prof["htod_ms"] - \
                    sum(prof["groups"].values())
                r = {"records_per_s": ips, "ms": ms, "losses": losses,
                     "iteration_records_per_s": [a[-1] for a in lines],
                     "peak_allocated_gib": peak, "profile": prof,
                     "launches_per_step": {k: v // (HARNESS_ITERS + 1)
                                           for k, v in got.items() if v}}
                report[name][sub] = r
                what = ("f32 train step" if sub == "local"
                        else "bf16 forward with the argmax to the host")
                log(f"[{card}] perf {sub} -m {name} -b {HARNESS_BATCH} -i "
                    f"{HARNESS_ITERS}: {ips:.1f} records/s, {ms:.3f} ms a "
                    f"{what}; profiled: device {prof['device_ms']:.3f} ms "
                    f"({prof['htod_ms']:.3f} of it the upload), busy share "
                    f"{prof['busy_share']:.3f}; peak allocated "
                    f"{peak:.2f} GiB; groups (ms) "
                    + json.dumps({k: round(v, 4)
                                  for k, v in prof["groups"].items()})
                    + "; top (ms): " + json.dumps(prof["top"][:6]))
    finally:        # init_logging gave the port's logger its own handler
        root.handlers[:] = saved[0]
        root.propagate = saved[1]
        root.setLevel(saved[2])
    report["card_vs_cpu"] = harness_vs_cpu(device)
    return report, launches


def harness_vs_cpu(device):
    """Phase 3o's checks against the CPU, float32 unless named: step 1's
    and step 2's losses of the harness's step on a dropout-free
    ``AlexNet_OWT`` at batch 2 within CNN_TOL relative; AlexNet's and
    VGG-16's eval log-probs at batch 1 within CNN_TOL of their largest
    magnitude, argmax equal where the top-2 margin exceeds that; their bf16
    eval logits (``infer``'s cast) on CNN_CPU_ROWS rows within the CPU's own
    bf16-vs-f32 error and at least one bf16 step of the largest logit
    (``cnn_bf16_vs_cpu``: at random init these shallow nets' CPU error is
    under one step)."""
    import torch
    from bigdl_tpu_torch.models import AlexNet, AlexNet_OWT, Vgg_16, perf
    cpu = torch.device("cpu")
    out = {}
    data, labels = perf._synthetic_batch("alexnetowt", CNN_CPU_BATCH,
                                         "random")
    losses = []
    for dev in (device, cpu):
        model = AlexNet_OWT(CLASSES, has_dropout=False).reset(SEED)
        step = perf.local_step(model.to(dev).training_(), data, labels, dev)
        losses.append([float(step(i)) for i in range(2)])
    rel = [abs(a - b) / abs(b) for a, b in zip(*losses)]
    log(f"perf local alexnetowt (no dropout) card vs CPU, batch "
        f"{CNN_CPU_BATCH}: losses {losses[0]} vs {losses[1]}, relative "
        f"{rel} (limit {CNN_TOL})")
    if not all(math.isfinite(v) and v <= CNN_TOL for v in rel):
        fail(f"perf local alexnetowt: card vs CPU losses differ by {rel}")
    out["alexnetowt_losses"] = {"card": losses[0], "cpu": losses[1],
                                "relative": rel}
    for name, build in (("alexnet", AlexNet), ("vgg16", Vgg_16)):
        c, h, w = perf._INPUT_SIZES[name]
        rng = np.random.RandomState(SEED + 12)
        x = torch.from_numpy(rng.standard_normal((1, c, h, w))
                             .astype(np.float32))
        model = build(CLASSES).reset(SEED).evaluate()
        with torch.inference_mode():
            want = model(x)[0]
            got = copy.deepcopy(model).to(device)(x.to(device))[0].cpu()
        limit = CNN_TOL * want.abs().max().item()
        err = (got - want).abs().max().item()
        top2 = want.topk(2).values
        firm = bool(top2[0] - top2[1] > limit)
        log(f"perf {name} eval log-probs card vs CPU (batch 1): max |d| "
            f"{err:.3g} (limit {limit:.3g}); argmax "
            + ("compared" if firm else "not compared (top-2 within the "
               "limit)"))
        if not err <= limit or (firm and got.argmax() != want.argmax()):
            fail(f"perf {name}: card vs CPU log-probs differ by {err}")
        rows = [rng.standard_normal((c, h, w)).astype(np.float32)
                for _ in range(CNN_CPU_ROWS)]
        out[name] = {"max_abs_dlogp": err, "limit": limit,
                     "bf16": cnn_bf16_vs_cpu(device, f"perf {name}",
                                             model.to(device), rows,
                                             min_steps=1)}
        del model
    return out


# -- phase 3r: the criterions, the table ops, RoiPooling and Nms -------------

# the autoencoder's recipe (bigdl_tpu/models/autoencoder.py:16-69): 784 ->
# 32 -> 784, MSECriterion, SGD 0.01 with momentum 0.9 at batch 150, MNIST
# normalised by its mean and std; cut to 1500 seeded images and 30 steps
AE_SAMPLES, AE_BATCH, AE_STEPS, AE_CPU_STEPS = 1500, 150, 30, 2
AE_MEAN, AE_STD = 0.13066047740239506, 0.3081078
AE_NOISE = 16.0                # grey levels, per image
AE_LOSS_RTOL = 1e-5            # card vs CPU, the first two losses
# Fast R-CNN's VGG16 setting (Girshick, ICCV 2015): a 7x7 RoI pool at 1/16
# over conv5_3, 2 images of 128 rois each, the 21 PASCAL VOC classes; the
# longer side cut from up to 1000 to 800 so both images share one shape
RCNN_CLASSES, RCNN_POOLED, RCNN_SCALE = 21, 7, 1.0 / 16
RCNN_IMAGES, RCNN_H, RCNN_W, RCNN_ROIS = 2, 600, 800, 128
RCNN_FG = 0.25                 # foreground share of the rois
RCNN_NMS_IOU = 0.3
RCNN_BOX_OFFSET = 4096.0       # per image, so one Nms call never mixes two
# card vs CPU at a cut: 1 image of 3x192x256, 32 rois
RCNN_CPU = (1, 192, 256, 32)
RCNN_LOSS_RTOL = 1e-5          # the loss, relative
RCNN_ROI_TOL = 1e-5            # RoiPooling's output, of its largest value
RCNN_GRAD_RTOL = 1e-4          # fc6's and conv5_3's weight gradients, rel L2
# the trunk's four 2x2/2 pools (K1, K3) at batch 2 on 600x800 input
RCNN_POOLS = [
    (f"vgg16-rcnn/pool{i + 1} 2x2_s2", (RCNN_IMAGES, c, h, w), 2, 2, 2, 2,
     0, 0, False)
    for i, (c, h, w) in enumerate(((64, 600, 800), (128, 300, 400),
                                   (256, 150, 200), (512, 75, 100)))]
SWEEP_ROWS, SWEEP_CLASSES = 128, 1000     # the classifier's output
SWEEP_RTOL = 1e-5              # card vs CPU, of each result's largest value


def ae_samples(n, seed):
    """Seeded 28x28 grey images in [0, 255]: one seeded image under
    per-image noise of AE_NOISE grey levels, rounded and clipped, as
    bytes; normalised as ``GreyImgNormalizer(AE_MEAN, AE_STD)`` and
    flattened; the target is the input (``Train.scala``'s
    ``toAutoencoderBatch``).  The shared image gives the model something
    to learn in AE_STEPS steps: over images of independent pixels the
    loss moves less in 30 steps than its spread from batch to batch."""
    from bigdl_tpu_torch.dataset import Sample
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, 784).astype(np.float32)
    raw = np.clip(np.round(base + rng.normal(0, AE_NOISE, (n, 784))), 0, 255)
    flat = ((raw / 255.0 - AE_MEAN) / AE_STD).astype(np.float32)
    return [Sample(flat[i], flat[i]) for i in range(n)]


def ae_trainer(model, steps, device):
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.nn import MSECriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    opt = Optimizer(model, DataSet.array(ae_samples(AE_SAMPLES, SEED + 90))
                    >> SampleToBatch(AE_BATCH), MSECriterion(),
                    Trigger.max_iteration(steps), device=device)
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    return opt.set_seed(SEED)


def autoencoder_recipe(device, card):
    """Phase 3r-a: the autoencoder's recipe through ``Optimizer`` with
    ``MSECriterion``, AE_STEPS steps at batch AE_BATCH in float32.  Fails
    unless every loss is finite, the mean of the last 5 is below the mean
    of the first 5, no kernel launched (the path has none), and the first
    two losses agree with a CPU run from the same weights within
    AE_LOSS_RTOL.  Returns (report, launches)."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.models import Autoencoder
    from bigdl_tpu_torch.optim import Trigger
    init = Autoencoder(32).reset(SEED + 91)
    opt = ae_trainer(copy.deepcopy(init), AE_STEPS, device)
    ops.reset_launches()                 # the path starts here
    opt.optimize()
    launches = launches_now()            # and ends here
    expect_launches("autoencoder recipe", launches, {})
    losses = [r["loss"] for r in opt.step_records]
    if len(losses) != AE_STEPS or not np.isfinite(losses).all() or \
            not np.mean(losses[-5:]) < np.mean(losses[:5]):
        fail(f"autoencoder recipe: losses {losses}")
    cpu = ae_trainer(copy.deepcopy(init), AE_CPU_STEPS, torch.device("cpu"))
    cpu.optimize()
    cpu_losses = [r["loss"] for r in cpu.step_records]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)]
    if len(rel) != AE_CPU_STEPS or not max(rel) <= AE_LOSS_RTOL:
        fail(f"autoencoder recipe card vs CPU: losses {losses[:2]} vs "
             f"{cpu_losses} (relative {rel}, limit {AE_LOSS_RTOL})")
    ms = 1e3 * statistics.median(
        r["dur_s"] for r in opt.step_records[-TIMED_STEPS:])
    opt.set_end_when(Trigger.max_iteration(AE_STEPS + 3))
    prof = device_profile(opt.optimize, 3)
    report = {"losses": losses, "cpu_losses": cpu_losses,
              "card_vs_cpu_rel": rel, "step_ms": ms,
              "records_per_s": AE_BATCH / ms * 1e3,
              "busy_share": prof["device_ms"] / ms, "profile": prof}
    log(f"[{card}] autoencoder recipe (f32, batch {AE_BATCH}, {AE_STEPS} "
        f"steps): loss {losses[0]:.6f} -> {losses[-1]:.6f} (mean of the "
        f"first 5 {np.mean(losses[:5]):.6f}, of the last 5 "
        f"{np.mean(losses[-5:]):.6f}); card vs CPU, steps 1-2, relative "
        f"{max(rel):.3g} (limit {AE_LOSS_RTOL}); step {ms:.3f} ms (median "
        f"of the last {TIMED_STEPS}), {report['records_per_s']:.1f} "
        f"records/s; device {prof['device_ms']:.3f} ms a step "
        f"({prof['htod_ms']:.3f} of it the upload), busy share "
        f"{report['busy_share']:.3f}; top (ms): "
        + json.dumps(prof["top"][:5]))
    return report, launches


def rcnn_head(seed):
    """Fast R-CNN's head on the port's ``Vgg_16(21)``: its modules 0-29
    (13 convs, their ReLUs, 4 pools) as the trunk beside the rois,
    ``RoiPooling(7, 7, 1/16)``, ``View(25088)``, Vgg_16's modules 32-37
    (fc6, Threshold, Dropout, fc7, Threshold, Dropout) and a
    ``ConcatTable`` of the class scores and the 84 box regressions; every
    weight drawn from one generator seeded ``seed``."""
    import bigdl_tpu_torch.nn as nn
    from bigdl_tpu_torch.models import Vgg_16
    vgg = Vgg_16(RCNN_CLASSES)
    head = (nn.Sequential()
            .add(nn.ParallelTable().add(nn.Sequential(*vgg.layers[:30]))
                 .add(nn.Identity()))
            .add(nn.RoiPooling(RCNN_POOLED, RCNN_POOLED, RCNN_SCALE))
            .add(nn.View(512 * RCNN_POOLED * RCNN_POOLED)))
    for m in vgg.layers[32:38]:
        head.add(m)
    head.add(nn.ConcatTable().add(nn.Linear(4096, RCNN_CLASSES))
             .add(nn.Linear(4096, 4 * RCNN_CLASSES)))
    return head.reset(seed)


def rcnn_criterion(n_rois):
    from bigdl_tpu_torch.nn import (ParallelCriterion,
                                    SmoothL1CriterionWithWeights,
                                    SoftmaxWithCriterion)
    return (ParallelCriterion()
            .add(SoftmaxWithCriterion(), 1.0)
            .add(SmoothL1CriterionWithWeights(1.0, n_rois), 1.0))


def rcnn_inputs(images, h, w, per_image, seed):
    """Seeded images and rois (1-based image index, box in image pixels,
    16 to 600 wide; a third with corners and sides on multiples of 8,
    which land on .5 at 1/16, and some reaching the image's edge) and Fast
    R-CNN's targets: a quarter of the rois foreground (labels 2-21, the 4
    columns of their class weighed 1), the rest background (label 1,
    weight 0)."""
    rng = np.random.RandomState(seed)
    img = rng.standard_normal((images, 3, h, w)).astype(np.float32)
    rois = []
    for b in range(images):
        for i in range(per_image):
            bw = rng.randint(16, min(600, w) + 1)
            bh = rng.randint(16, min(600, h) + 1)
            x1, y1 = rng.randint(0, w - 8), rng.randint(0, h - 8)
            if i % 3 == 0:
                x1, y1, bw, bh = (8 * (v // 8) for v in (x1, y1, bw, bh))
            rois.append([b + 1, x1, y1, min(x1 + bw, w - 1),
                         min(y1 + bh, h - 1)])
    rois = np.asarray(rois, np.float32)
    r = len(rois)
    labels = np.ones(r, np.float32)
    fg = rng.permutation(r)[:int(r * RCNN_FG)]
    labels[fg] = rng.randint(2, RCNN_CLASSES + 1, len(fg))
    targets = rng.standard_normal((r, 4 * RCNN_CLASSES)).astype(np.float32)
    weights = np.zeros((r, 4 * RCNN_CLASSES), np.float32)
    for i in fg:
        c = int(labels[i]) - 1
        weights[i, 4 * c:4 * c + 4] = 1.0
    return img, rois, [labels, [targets, weights, weights.copy()]]


def rcnn_boxes(rois):
    """The rois' boxes, each image's offset by RCNN_BOX_OFFSET, so that
    boxes of two images never overlap."""
    return rois[:, 1:5] + (rois[:, :1] - 1) * RCNN_BOX_OFFSET


def nms_walk(scores, boxes, thresh):
    """An independent greedy NMS in numpy float32: boxes in descending
    score (a stable sort), each kept unless its IoU (+1 pixel convention)
    with a box kept before it is above ``thresh``."""
    scores = np.asarray(scores, np.float32)
    boxes = np.asarray(boxes, np.float32)
    thresh, one, zero = np.float32(thresh), np.float32(1), np.float32(0)
    areas = (boxes[:, 2] - boxes[:, 0] + one) * \
        (boxes[:, 3] - boxes[:, 1] + one)
    kept = []
    for i in np.argsort(-scores, kind="stable"):
        bi = boxes[i]
        for k in kept:
            bk = boxes[k]
            iw = min(bi[2], bk[2]) - max(bi[0], bk[0]) + one
            ih = min(bi[3], bk[3]) - max(bi[1], bk[1]) + one
            inter = max(iw, zero) * max(ih, zero)
            if inter / (areas[k] + areas[i] - inter) > thresh:
                break
        else:
            kept.append(int(i))
    return kept


def rcnn_nms(scores, rois):
    """``Nms`` at RCNN_NMS_IOU for each of the 20 foreground classes over
    every roi (:func:`rcnn_boxes`): the kept lists by class."""
    from bigdl_tpu_torch.nn import Nms
    nms, boxes = Nms(), rcnn_boxes(rois)
    return [nms(scores[:, c], boxes, RCNN_NMS_IOU).tolist()
            for c in range(1, RCNN_CLASSES)]


class Capture:
    """The output of one module's forward, while open."""

    def __init__(self, module):
        self.module, self.out = module, None

    def __enter__(self):
        def hook(m, args, out):
            self.out = out
        self.handle = self.module.register_forward_hook(hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


def rcnn_run(head, img, rois, target, device, train=True):
    """One forward and the loss of ``head`` on ``device``, in training
    mode (with its backward) or in eval mode; returns (loss, outputs,
    RoiPooling's output)."""
    import torch
    head.train(train)
    with Capture(head.layers[1]) as roi:
        out = head([torch.from_numpy(img).to(device),
                    torch.from_numpy(rois).to(device)])
    loss = rcnn_criterion(len(rois))(out, [
        torch.from_numpy(target[0]).to(device),
        [torch.from_numpy(t).to(device) for t in target[1]]])
    if train:
        loss.backward()
    return loss, out, roi.out


def fast_rcnn_head(device, card):
    """Phase 3r-b: a Fast R-CNN head on VGG-16 (:func:`rcnn_head`) over
    RCNN_IMAGES seeded 3x600x800 images and 256 rois.  Training mode: one
    forward, the loss and one backward through the module and criterion
    API; fails unless the loss is finite, RoiPooling's output is (256,
    512, 7, 7), conv1_1's weight gradient is finite and nonzero (the
    gradient crossed RoiPooling and the trunk), and the step launched
    exactly 4 K1 and 4 K3.  Eval mode: a forward (4 K1), a softmax over the
    21 scores and ``Nms`` for each foreground class, whose kept lists must
    equal :func:`nms_walk`'s.  Then card vs CPU (:func:`rcnn_vs_cpu`) and
    the timings (:func:`time_rcnn`).  Returns (report, launches by
    path)."""
    import torch
    from bigdl_tpu_torch import ops
    torch.cuda.init()       # the allocator's statistics need it
    head = rcnn_head(SEED + 80)
    cpu_head = copy.deepcopy(head)
    head.to(device).set_generator(torch.Generator(device).manual_seed(SEED))
    img, rois, target = rcnn_inputs(RCNN_IMAGES, RCNN_H, RCNN_W, RCNN_ROIS,
                                    SEED + 81)
    n_rois = len(rois)
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()                 # the training path starts here
    loss, out, pooled = rcnn_run(head, img, rois, target, device)
    train_launches = launches_now()      # and ends here
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    conv1 = head.layers[0].layers[0].layers[0].weight.grad
    expect_launches("Fast R-CNN head, training step", train_launches,
                    {"max_pool2d": 4, "max_pool2d_bwd": 4})
    if not math.isfinite(loss.item()):
        fail(f"Fast R-CNN head: loss {loss.item()}")
    if tuple(pooled.shape) != (n_rois, 512, RCNN_POOLED, RCNN_POOLED):
        fail(f"Fast R-CNN head: RoiPooling's output {tuple(pooled.shape)}")
    if conv1 is None or not bool(torch.isfinite(conv1).all()) or \
            not conv1.abs().max().item() > 0:
        fail("Fast R-CNN head: conv1_1's weight gradient is missing, "
             "non-finite or zero: the gradient did not cross RoiPooling")
    log(f"Fast R-CNN head (training): loss {loss.item():.6f}, RoiPooling "
        f"{tuple(pooled.shape)}, conv1_1's weight gradient max |g| "
        f"{conv1.abs().max().item():.3g}, launches {train_launches}")
    del loss, out, pooled
    head.zero_grad(set_to_none=True)

    head.evaluate()
    r = torch.from_numpy(rois).to(device)
    ops.reset_launches()                 # the eval path starts here
    with torch.no_grad():
        out = head([torch.from_numpy(img).to(device), r])
        scores = torch.softmax(out[0], dim=1)
        kept = rcnn_nms(scores, r)
    eval_launches = launches_now()       # and ends here
    expect_launches("Fast R-CNN head, eval forward", eval_launches,
                    {"max_pool2d": 4})
    boxes = rcnn_boxes(rois)
    want = [nms_walk(scores[:, c].cpu().numpy(), boxes, RCNN_NMS_IOU)
            for c in range(1, RCNN_CLASSES)]
    if kept != want:
        fail(f"Fast R-CNN head: Nms kept {kept}, the numpy walk {want}")
    log(f"Fast R-CNN head (eval): Nms at IoU {RCNN_NMS_IOU} kept "
        f"{[len(k) for k in kept]} of {n_rois} rois by class, equal to the "
        "numpy walk")
    report = {"peak_allocated_gib": peak, "kept": [len(k) for k in kept],
              "card_vs_cpu": rcnn_vs_cpu(head, cpu_head, device)}
    del cpu_head
    report.update(time_rcnn(head, img, rois, target, scores, device))
    log(f"[{card}] Fast R-CNN head on VGG-16 (f32, {RCNN_IMAGES} x 3 x "
        f"{RCNN_H} x {RCNN_W}, {n_rois} rois): eval forward "
        f"{report['forward_ms']:.3f} ms, training forward + loss + backward "
        f"{report['step_ms']:.3f} ms (median of 5; device "
        f"{report['step_device_ms']:.3f} ms, busy share "
        f"{report['busy_share']:.3f}); RoiPooling forward "
        f"{fmt_ms(report['roi_fwd_device_ms'])} and backward "
        f"{fmt_ms(report['roi_bwd_device_ms'])} of device time (forward "
        f"{report['roi_fwd_ms']:.4f} ms by events); 20 Nms calls "
        f"{report['nms_ms']:.3f} ms (host clock, median of 5); peak "
        f"allocated {peak:.2f} GiB (the training step); top (ms): "
        + json.dumps(report["top"][:6]))
    return report, {"rcnn_train": train_launches, "rcnn_eval": eval_launches}


def rcnn_vs_cpu(head, cpu_head, device):
    """Card vs CPU at RCNN_CPU, eval mode (no dropout), the same weights:
    the loss within RCNN_LOSS_RTOL, RoiPooling's output within
    RCNN_ROI_TOL of its largest value, fc6's and conv5_3's weight
    gradients within RCNN_GRAD_RTOL relative L2, and the card's ``Nms``
    lists equal to the CPU's on the same scores, and to the CPU's on its
    own scores in every class where no two scores lie within twice the
    largest score error, card vs CPU (so that the error cannot reorder
    them); the classes left out for such near ties are logged."""
    import torch
    images, h, w, per = RCNN_CPU
    img, rois, target = rcnn_inputs(images, h, w, per, SEED + 82)
    runs = []
    for model, dev in ((head, device), (cpu_head, torch.device("cpu"))):
        model.zero_grad(set_to_none=True)
        loss, out, pooled = rcnn_run(model, img, rois, target, dev,
                                     train=False)
        loss.backward()
        grads = [model.layers[3].weight.grad,                   # fc6
                 model.layers[0].layers[0].layers[28].weight.grad]  # conv5_3
        runs.append((loss.item(), out, pooled, grads))
    (la, oa, pa, ga), (lb, ob, pb, gb) = runs
    loss_rel = abs(la - lb) / abs(lb)
    roi_err = (pa.detach().cpu() - pb.detach()).abs().max().item() / \
        pb.abs().max().item()
    grad_rel = [rel_l2([a], [b]) for a, b in zip(ga, gb)]
    head.zero_grad(set_to_none=True)
    scores = torch.softmax(oa[0].detach(), dim=1)
    r = torch.from_numpy(rois)
    kept_card = rcnn_nms(scores, r.to(device))
    kept_cpu = rcnn_nms(scores.cpu(), r)
    own_scores = torch.softmax(ob[0].detach(), dim=1)
    own_cpu = rcnn_nms(own_scores, r)
    score_err = (scores.cpu() - own_scores).abs().max().item()
    gaps = own_scores.sort(dim=0).values.diff(dim=0).min(dim=0).values
    classes = range(1, RCNN_CLASSES)
    near_ties = [c for c in classes if gaps[c].item() <= 2 * score_err]
    own_missed = [c for c in classes if c not in near_ties
                  and kept_card[c - 1] != own_cpu[c - 1]]
    log(f"Fast R-CNN head card vs CPU ({images} x 3 x {h} x {w}, {per} "
        f"rois, eval): loss {la:.7f} vs {lb:.7f} (relative {loss_rel:.3g}, "
        f"limit {RCNN_LOSS_RTOL}); RoiPooling {roi_err:.3g} of its largest "
        f"(limit {RCNN_ROI_TOL}); fc6's and conv5_3's weight gradients, "
        f"relative L2 {grad_rel[0]:.3g} and {grad_rel[1]:.3g} (limit "
        f"{RCNN_GRAD_RTOL}); Nms on the card "
        + ("equal" if kept_card == kept_cpu else "NOT equal")
        + " to the CPU's on the same scores; on the CPU's own scores (score "
        f"error {score_err:.3g}) "
        + (f"NOT equal in classes {own_missed}" if own_missed else
           f"equal in the {len(classes) - len(near_ties)} classes held")
        + (f"; classes {near_ties} not held, two of their scores lying "
           f"within {2 * score_err:.3g} (there "
           + ("equal too" if kept_card == own_cpu else "not equal") + ")"
           if near_ties else ""))
    if not (loss_rel <= RCNN_LOSS_RTOL and roi_err <= RCNN_ROI_TOL and
            max(grad_rel) <= RCNN_GRAD_RTOL and kept_card == kept_cpu
            and not own_missed):
        fail("Fast R-CNN head: card vs CPU out of its limits")
    return {"loss": [la, lb], "loss_rel": loss_rel, "roi_err": roi_err,
            "grad_rel_l2": {"fc6": grad_rel[0], "conv5_3": grad_rel[1]},
            "score_err": score_err, "nms_near_tie_classes": near_ties,
            "nms_equal_on_own_cpu_scores": kept_card == own_cpu}


def time_rcnn(head, img, rois, target, scores, device):
    """The head's eval forward and training step (CUDA events, median of
    5), a profile of one step, RoiPooling's forward and backward device
    time at the head's shapes (L2 flushed), and the 20 ``Nms`` calls (host
    clock, median of 5)."""
    import torch
    x = torch.from_numpy(img).to(device)
    r = torch.from_numpy(rois).to(device)

    def forward():
        with torch.no_grad():
            head([x, r])

    def step():
        head.zero_grad(set_to_none=True)
        rcnn_run(head, img, rois, target, device)

    head.evaluate()
    out = {"forward_ms": median_ms(forward, device, reps=5),
           "step_ms": median_ms(step, device, reps=5)}
    prof = device_profile(step, 1)
    out.update(step_device_ms=prof["device_ms"], top=prof["top"],
               busy_share=prof["device_ms"] / out["step_ms"])
    head.zero_grad(set_to_none=True)
    head.evaluate()
    with torch.no_grad():
        feat = head.layers[0]([x, r])[0]
    roi = head.layers[1]
    leaf = feat.clone().requires_grad_(True)
    pooled = roi([leaf, r])
    g = torch.randn_like(pooled)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    out["roi_fwd_device_ms"] = device_ms(lambda: roi([feat, r]), flush)
    out["roi_bwd_device_ms"] = device_ms(
        lambda: torch.autograd.grad(pooled, leaf, g, retain_graph=True),
        flush)
    out["roi_fwd_ms"] = median_ms(lambda: roi([feat, r]), device,
                                  flush=flush)

    def nms_calls():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rcnn_nms(scores, r)
        return (time.perf_counter() - t0) * 1e3
    out["nms_ms"] = statistics.median(nms_calls() for _ in range(5))
    return out


def sweep_criterions(n=SWEEP_ROWS, c=SWEEP_CLASSES):
    """(name, criterion, input, target) of the 24 criterions at (n, c), by
    default the classifier's output (SWEEP_ROWS x SWEEP_CLASSES, f32;
    TimeDistributed over 4 steps of it), each target seeded to its
    contract.  The card's tests take the same cases at a smaller size."""
    import bigdl_tpu_torch.nn as nn
    rng = np.random.RandomState(SEED + 95)
    f32 = np.float32

    def normal(*shape):
        return rng.standard_normal(shape).astype(f32)

    def log_softmax(v):
        v = v - v.max(-1, keepdims=True)
        return (v - np.log(np.exp(v).sum(-1, keepdims=True))).astype(f32)

    def signs(*shape):
        return np.where(rng.rand(*shape) > 0.5, 1, -1).astype(f32)

    x, x2, x3 = normal(n, c), normal(n, c), normal(n, c)
    labels = rng.randint(1, c + 1, n).astype(f32)
    bits = (rng.rand(n, c) > 0.5).astype(f32)
    probs = np.clip(1 / (1 + np.exp(-x)), 0.01, 0.99).astype(f32)
    dist = np.exp(log_softmax(normal(n, c)))
    dist[rng.rand(n, c) < 0.1] = 0
    multi = np.zeros((n, c), f32)
    for i in range(n):
        k = rng.randint(0, 6)
        multi[i, :k] = rng.choice(c, k, replace=False) + 1
    inside = np.zeros((n, c), f32)
    inside[:, :84] = bits[:, :84]
    return [
        ("ClassNLLCriterion", nn.ClassNLLCriterion(), log_softmax(x),
         labels),
        ("CrossEntropyCriterion", nn.CrossEntropyCriterion(), x, labels),
        ("TimeDistributedCriterion", nn.TimeDistributedCriterion(
            nn.ClassNLLCriterion(), size_average=True),
         log_softmax(normal(n, 4, c)),
         rng.randint(1, c + 1, (n, 4)).astype(f32)),
        ("MSECriterion", nn.MSECriterion(), x, x2),
        ("AbsCriterion", nn.AbsCriterion(), x, x2),
        ("BCECriterion", nn.BCECriterion(), probs, bits),
        ("ClassSimplexCriterion", nn.ClassSimplexCriterion(c), x, labels),
        ("CosineEmbeddingCriterion", nn.CosineEmbeddingCriterion(0.1),
         [x, x2], signs(n)),
        ("DistKLDivCriterion", nn.DistKLDivCriterion(), log_softmax(x),
         dist),
        ("HingeEmbeddingCriterion", nn.HingeEmbeddingCriterion(), x,
         signs(n, c)),
        ("L1Cost", nn.L1Cost(), x, None),
        ("L1HingeEmbeddingCriterion", nn.L1HingeEmbeddingCriterion(2e5),
         [x, x2], f32(-1)),
        ("MarginCriterion", nn.MarginCriterion(), x, signs(n, c)),
        ("MarginRankingCriterion", nn.MarginRankingCriterion(0.5), [x, x2],
         signs(n, c)),
        ("MultiCriterion", nn.MultiCriterion().add(nn.MSECriterion())
         .add(nn.AbsCriterion(), 0.1), x, x2),
        ("ParallelCriterion", nn.ParallelCriterion()
         .add(nn.CrossEntropyCriterion()).add(nn.MSECriterion(), 0.5),
         [x, x2], [labels, x3]),
        ("MultiLabelMarginCriterion", nn.MultiLabelMarginCriterion(), x,
         multi),
        ("MultiLabelSoftMarginCriterion",
         nn.MultiLabelSoftMarginCriterion(), x, bits),
        ("MultiMarginCriterion", nn.MultiMarginCriterion(), x, labels),
        ("SmoothL1Criterion", nn.SmoothL1Criterion(), x, x2),
        ("SmoothL1CriterionWithWeights", nn.SmoothL1CriterionWithWeights(
            1.0, n), x, [x2, inside, inside.copy()]),
        ("SoftMarginCriterion", nn.SoftMarginCriterion(), x, signs(n, c)),
        ("SoftmaxWithCriterion", nn.SoftmaxWithCriterion(ignore_label=1),
         x, labels),
        ("CriterionTable", nn.CriterionTable(nn.MSECriterion()), [x, x2],
         None),
    ]


def sweep_layers():
    """(name, layer, input) of each table, shape and distance layer of
    this slice at a shape where users meet it, f32, the layers seeded."""
    import bigdl_tpu_torch.nn as nn
    rng = np.random.RandomState(SEED + 96)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    gates = np.exp(normal(32, 4))
    gates = (gates / gates.sum(1, keepdims=True)).astype(np.float32)
    inception_3a = [normal(32, 64, 28, 28), normal(32, 128, 28, 28),
                    normal(32, 32, 28, 28), normal(32, 32, 28, 28)]
    maps = [normal(32, 256, 14, 14), normal(32, 256, 14, 14)]
    divisor = (np.sign(normal(32, 256, 14, 14)) *
               rng.uniform(0.5, 2.0, (32, 256, 14, 14))).astype(np.float32)
    rcnn_out = [normal(256, 21), normal(256, 84)]
    siamese = [normal(128, 512), normal(128, 512)]
    layers = [
        ("ParallelTable", nn.ParallelTable().add(nn.Linear(4096, 21))
         .add(nn.Linear(4096, 84)), [normal(256, 4096), normal(256, 4096)]),
        ("MapTable", nn.MapTable(nn.Linear(512, 512)),
         [normal(32, 512) for _ in range(3)]),
        ("MixtureTable", nn.MixtureTable(),
         [gates, [normal(32, 1000) for _ in range(4)]]),
        ("JoinTable", nn.JoinTable(2), inception_3a),
        ("FlattenTable", nn.FlattenTable(),
         [normal(32, 1000), [normal(32, 1000), [normal(32, 1000)]]]),
        ("NarrowTable", nn.NarrowTable(2, 2), inception_3a),
        ("SelectTable", nn.SelectTable(2), rcnn_out),
        ("CSubTable", nn.CSubTable(), maps),
        ("CMulTable", nn.CMulTable(), maps),
        ("CDivTable", nn.CDivTable(), [maps[0], divisor]),
        ("CMaxTable", nn.CMaxTable(), maps),
        ("CMinTable", nn.CMinTable(), maps),
        ("Echo", nn.Echo(), normal(32, 1000)),
        ("Copy", nn.Copy(), normal(32, 1000)),
        ("Contiguous", nn.Contiguous(), normal(32, 1000)),
        ("Bottle", nn.Bottle(nn.Linear(512, 1000)), normal(32, 16, 512)),
        ("InferReshape", nn.InferReshape([0, -1]), normal(32, 512, 7, 7)),
        ("Select", nn.Select(2, -1), normal(32, 16, 512)),
        ("Narrow", nn.Narrow(2, 65, 128), normal(32, 256, 28, 28)),
        ("Squeeze", nn.Squeeze(), normal(32, 1024, 1, 1)),
        ("Unsqueeze", nn.Unsqueeze(2), normal(32, 1000)),
        ("Transpose", nn.Transpose([(2, 3)]), normal(32, 16, 512)),
        ("Replicate", nn.Replicate(16, 1, 1), normal(32, 512)),
        ("SpatialZeroPadding", nn.SpatialZeroPadding(1),
         normal(32, 64, 56, 56)),
        ("Index", nn.Index(1), [normal(1000, 512),
                                rng.randint(1, 1001, 256).astype(np.int64)]),
        ("MaskedSelect", nn.MaskedSelect(),
         [normal(32, 1000), (rng.rand(32, 1000) > 0.5).astype(np.uint8)]),
        ("Max", nn.Max(2), normal(128, 1000)),
        ("Min", nn.Min(2), normal(128, 1000)),
        ("Mean", nn.Mean(2), normal(32, 16, 512)),
        ("Sum", nn.Sum(2), normal(32, 16, 512)),
        ("Cosine", nn.Cosine(512, 100), normal(32, 512)),
        ("Euclidean", nn.Euclidean(512, 100), normal(32, 512)),
        ("CosineDistance", nn.CosineDistance(), siamese),
        ("DotProduct", nn.DotProduct(), siamese),
        ("PairwiseDistance", nn.PairwiseDistance(), siamese),
        ("MM", nn.MM(trans_b=True), [normal(64, 128, 64),
                                     normal(64, 128, 64)]),
        ("MV", nn.MV(), [normal(32, 1000, 512), normal(32, 512)]),
        ("L1Penalty", nn.L1Penalty(1e-4).training_(), normal(32, 4096)),
    ]
    for i, (_, m, _) in enumerate(layers):
        m.reset(SEED + 97 + i)
    return layers


def _flat(tree):
    from bigdl_tpu_torch.core.module import tree_leaves
    return list(tree_leaves(tree))


def held_within(what, got, want, rtol):
    """max |got - want| over the leaves (card against CPU), of want's
    largest magnitude; fails over ``rtol`` or on a non-finite or misshapen
    result."""
    import torch
    got, want = _flat(got), _flat(want)
    if len(got) != len(want):
        fail(f"{what}: {len(got)} results, want {len(want)}")
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.detach().cpu().double(), b.detach().double()
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            fail(f"{what}: shape {tuple(a.shape)} (want {tuple(b.shape)}) "
                 "or non-finite values")
        scale = max(b.abs().max().item(), 1e-30)
        worst = max(worst, (a - b).abs().max().item() / scale)
    if not worst <= rtol:
        fail(f"{what}: card vs CPU {worst:.3g} of the largest value (limit "
             f"{rtol})")
    return worst


def criterion_layer_sweep(device):
    """Phase 3r-c: each of the 24 criterions' ``forward`` and ``backward``
    (:func:`sweep_criterions`), and each table, shape and distance layer's
    forward and input gradient (of the sum of its output times a seeded
    tensor; :func:`sweep_layers`), on the card against the CPU on the same
    inputs, within SWEEP_RTOL of each result's largest value; fails on the
    first miss.  Returns {name: worst error}."""
    import torch
    from bigdl_tpu_torch.core.module import tree_map
    cpu = torch.device("cpu")

    def on(dev, tree):
        return tree_map(lambda v: torch.from_numpy(np.asarray(v)).to(dev),
                        tree)

    out = {}
    for name, crit, x, t in sweep_criterions():
        res = []
        for dev in (device, cpu):
            c = crit.clone_criterion()
            loss = c.forward(on(dev, x), None if t is None else on(dev, t))
            grad = c.backward(on(dev, x), None if t is None else on(dev, t))
            res.append((loss, grad))
        (la, ga), (lb, gb) = res
        out[name] = max(
            held_within(f"sweep {name} forward", [la], [lb], SWEEP_RTOL),
            held_within(f"sweep {name} backward", ga, gb, SWEEP_RTOL))
        log(f"sweep {name} (forward and backward, card vs CPU): "
            f"{out[name]:.3g} of the largest value")
    for name, layer, x in sweep_layers():
        res = []
        for dev, m in ((device, copy.deepcopy(layer).to(device)),
                       (cpu, layer)):
            xs = on(dev, x)
            leaves = [v.requires_grad_(True) for v in _flat(xs)
                      if v.is_floating_point()]
            y = m(xs)
            r = [torch.from_numpy(np.random.RandomState(SEED + 98 + i)
                                  .standard_normal(tuple(v.shape))
                                  .astype(np.float32)).to(dev)
                 for i, v in enumerate(_flat(y))]
            g = torch.autograd.grad(
                sum((v * w).sum() for v, w in zip(_flat(y), r)), leaves,
                allow_unused=True)
            res.append((y, [torch.zeros_like(v) if d is None else d
                            for v, d in zip(leaves, g)]))
        (ya, ga), (yb, gb) = res
        out[name] = max(
            held_within(f"sweep {name} forward", ya, yb, SWEEP_RTOL),
            held_within(f"sweep {name} input gradient", ga, gb, SWEEP_RTOL))
        log(f"sweep {name} (forward and input gradient, card vs CPU): "
            f"{out[name]:.3g} of the largest value")
    return out


# -- phase 3s: the text classifier, SimpleRNN and this slice's layers --------

# BigDL's TextClassifier (bigdl_tpu/example/textclassification.py) at its
# defaults but -e TEXT_EPOCHS, on a staged stand-in for 20 Newsgroups and
# GloVe (neither is in the repo): TEXT_CLASSES folders of TEXT_DOCS seeded
# documents of TEXT_WORDS words (Zipf-drawn over TEXT_TYPES types, a
# TEXT_OWN_SHARE of them from the class's own TEXT_OWN words) and seeded
# 100-d vectors for all but every 20th type.  The recipe learns from this
# corpus only at a high share of class words (at 0.25 the loss stays at
# ln 20 after Adagrad's first step), so the run must end above
# TEXT_MIN_TOP1, twice chance.  cuDNN's sums move runs apart: at -e 2 the
# last Top-1 spread 0.078-0.246 over 9 whole runs on the card; 12 runs of
# this phase at -e 3 ended at 0.133-0.438, one under twice the gate, at
# -e 4 at 0.289-0.875 (--repeat-3s-a 12 3 4), so the run takes 4 epochs
# of the reference's 20
TEXT_CLASSES, TEXT_DOCS, TEXT_TYPES, TEXT_OWN = 20, 64, 24000, 10
TEXT_WORDS, TEXT_OWN_SHARE, TEXT_MIN_TOP1 = (150, 1400), 0.5, 0.1
TEXT_BATCH, TEXT_SEQ, TEXT_EMBED, TEXT_EPOCHS = 128, 1000, 100, 4
TEXT_LOSS_RTOL = 1e-5          # the first step's loss, card vs CPU
# its three SpatialMaxPooling layers at batch 128 (K1, K3): one-row planes,
# 1x5/5 over 996 columns (5 does not divide them) and 195, then 1x35/35
TEXT_POOLS = [
    (f"textclassifier/pool{i + 1} 1x{k}_s{k}", (TEXT_BATCH, 128, 1, w), 1, k,
     1, k, 0, 0, False)
    for i, (w, k) in enumerate(((996, 5), (195, 5), (35, 35)))]
# models/rnn.py train_main at its defaults (vocab 4000, hidden 40, bptt 4,
# batch 8, SGD 0.1) but -e RNN_EPOCHS, on RNN_LINES written lines of
# RNN_WORDS Zipf-drawn words over RNN_TYPES types (the dictionary fills and
# discards); test_main grows RNN_TEST sentences by RNN_GROW words
RNN_LINES, RNN_WORDS, RNN_TYPES, RNN_EPOCHS = 1200, (6, 36), 20000, 2
RNN_TEST, RNN_GROW = 3, 8
RNN_LOSS_RTOL = 1e-5           # the first step's loss, card vs CPU
# phase 3s-c: card vs CPU, of each result's largest magnitude
SLICE_RTOL = 1e-5              # forward
SLICE_GRAD_RTOL = 1e-4         # input and parameter gradients (long sums)
SLICE_QUANT_RTOL = 1e-4        # quantized log-probs (K13's f32 sums)


def stage_news(folder):
    """The staged text classifier folder (``TEXT_*``): ``20_newsgroup/
    <group>/<n>`` and ``glove.6B/glove.6B.100d.txt``."""
    rng = np.random.RandomState(SEED + 500)
    p = 1.0 / np.arange(1, TEXT_TYPES + 1) ** 1.1
    p /= p.sum()
    for c in range(TEXT_CLASSES):
        cdir = os.path.join(folder, "20_newsgroup", f"group.{c:02d}")
        os.makedirs(cdir)
        for d in range(TEXT_DOCS):
            n = rng.randint(*TEXT_WORDS)
            words = [f"w{i}" for i in rng.choice(TEXT_TYPES, n, p=p)]
            own = np.flatnonzero(rng.rand(n) < TEXT_OWN_SHARE)
            for i, k in zip(own, rng.randint(0, TEXT_OWN, len(own))):
                words[i] = f"c{c}k{k}"
            lines = [" ".join(words[i:i + 12]) for i in range(0, n, 12)]
            with open(os.path.join(cdir, str(50000 + 100 * c + d)),
                      "w") as f:
                f.write(f"Subject: group {c} note {d}\n\n" +
                        ".\n".join(lines) + ".\n")
    types = [f"w{i}" for i in range(TEXT_TYPES)] + \
        [f"c{c}k{k}" for c in range(TEXT_CLASSES) for k in range(TEXT_OWN)]
    vecs = rng.standard_normal((len(types), TEXT_EMBED)) * 0.4
    os.makedirs(os.path.join(folder, "glove.6B"))
    with open(os.path.join(folder, "glove.6B",
                           f"glove.6B.{TEXT_EMBED}d.txt"), "w") as f:
        for i, (w, v) in enumerate(zip(types, vecs)):
            if i % 20 != 19:
                f.write(w + " " + " ".join(f"{x:.5f}" for x in v) + "\n")


def text_first_loss_cpu(train, classes):
    """The text classifier's first step's loss on the CPU: ``build_model``'s
    own seeded weights on the first batch ``main`` trains on (its split's
    first TEXT_BATCH documents, in order), float32."""
    import torch
    from bigdl_tpu_torch.example import textclassification as tc
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    x = np.stack([s.feature for s in train[:TEXT_BATCH]])
    y = np.stack([s.label for s in train[:TEXT_BATCH]])
    model = tc.build_model(classes, TEXT_EMBED, TEXT_SEQ)
    with torch.no_grad():
        return ClassNLLCriterion()(model(torch.from_numpy(x)),
                                   torch.from_numpy(y)).item()


def text_classifier(device, card):
    """Phase 3s-a: ``example/textclassification.py`` ``main`` at its
    defaults but ``-e TEXT_EPOCHS`` on a folder staged under ``build/`` and
    removed after: finite losses, the last epoch's mean below the
    first's, 3 K1 + 3 K3 a step and 3 K1 a validation forward and no other
    kernel, the last Top-1 above TEXT_MIN_TOP1, the first loss within
    TEXT_LOSS_RTOL of a CPU forward of the same weights on the same batch;
    step ms, records/s, peak
    allocated memory and a profile of 3 more steps.  Returns (report,
    launches by path)."""
    import shutil
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.example import textclassification as tc
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adagrad, Optimizer, Trigger
    from bigdl_tpu_torch.utils.table import T
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_news")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    try:
        t0 = time.perf_counter()
        stage_news(folder)
        stage_s = time.perf_counter() - t0
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
        with LogArgs("bigdl_tpu_torch.optim", "Epoch ") as steps, \
                LogArgs("bigdl_tpu_torch.optim", "%s is %r") as vals:
            ops.reset_launches()             # the path starts here
            t0 = time.perf_counter()
            model = tc.main(["--baseDir", folder, "-e", str(TEXT_EPOCHS)],
                            device=device)
            wall = time.perf_counter() - t0
            launches = launches_now()        # and ends here
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        samples, classes = tc.load_samples(folder, TEXT_SEQ, 20000,
                                           TEXT_EMBED)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    train, val = tc.split_samples(samples, 0.8)
    cpu_loss = text_first_loss_cpu(train, classes)
    n, n_val = len(steps), len(vals)
    expect_launches("text classifier", launches,
                    {"max_pool2d": 3 * n + 3 * n_val * (
                        len(val) // TEXT_BATCH),
                     "max_pool2d_bwd": 3 * n})
    losses = [a[3] for a in steps]
    epochs = [[a[3] for a in steps if a[0] == e]
              for e in range(1, TEXT_EPOCHS + 1)]
    top1 = [v[1].result()[0] for v in vals]
    if n_val != TEXT_EPOCHS or not all(math.isfinite(v) for v in losses) \
            or not np.mean(epochs[-1]) < np.mean(epochs[0]) \
            or not top1[-1] > TEXT_MIN_TOP1:
        fail(f"text classifier: losses by epoch {epochs}, Top-1 {top1} "
             f"(want the last above {TEXT_MIN_TOP1})")
    rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    if not rel <= TEXT_LOSS_RTOL:
        fail(f"text classifier: first loss {losses[0]} on the card, "
             f"{cpu_loss} on the CPU (relative {rel:.3g}, limit "
             f"{TEXT_LOSS_RTOL})")
    ms = [1e3 * TEXT_BATCH / a[4] for a in steps]
    step_ms = statistics.median(ms[1:])
    opt = Optimizer(model, DataSet.array(train) >> SampleToBatch(
        TEXT_BATCH, drop_last=True), ClassNLLCriterion(),
        Trigger.max_iteration(3), device=device)
    opt.set_optim_method(Adagrad())
    opt.set_config(T(learningRate=0.01, learningRateDecay=0.0002))
    prof = device_profile(opt.optimize, 3)
    report = {"steps": n, "losses": losses,
              "epoch_mean_loss": [float(np.mean(e)) for e in epochs],
              "cpu_first_loss": cpu_loss, "first_loss_rel": rel,
              "top1": top1, "step_ms": ms, "step_ms_median": step_ms,
              "records_per_s": TEXT_BATCH / step_ms * 1e3, "wall_s": wall,
              "stage_s": stage_s, "peak_allocated_gib": peak,
              "busy_share": prof["device_ms"] / step_ms, "profile": prof,
              "launches": {k: v for k, v in launches.items() if v}}
    log(f"[{card}] text classifier (main at its defaults, -e "
        f"{TEXT_EPOCHS}: {TEXT_CLASSES} x {TEXT_DOCS} staged documents, "
        f"seqLen {TEXT_SEQ}, embed {TEXT_EMBED}, batch {TEXT_BATCH}, f32): "
        f"{n} steps, epoch mean loss {report['epoch_mean_loss']}, Top-1 "
        f"{top1}; first loss {losses[0]:.7f} vs CPU {cpu_loss:.7f} "
        f"(relative {rel:.3g}, limit {TEXT_LOSS_RTOL}); step {step_ms:.3f} "
        f"ms (median after the first), {report['records_per_s']:.1f} "
        f"records/s; device {prof['device_ms']:.3f} ms a step, busy share "
        f"{report['busy_share']:.3f}; peak allocated {peak:.2f} GiB; "
        f"launches {report['launches']}; staging {stage_s:.1f} s, main "
        f"{wall:.1f} s; top (ms): " + json.dumps(prof["top"][:6]))
    return report, {"text_classifier": launches}


def write_rnn_corpus(folder):
    """RNN_LINES lines of RNN_WORDS Zipf-drawn words (exponent 1.1) over
    RNN_TYPES types, and a ``test.txt`` of the first 5 words of RNN_TEST
    of them."""
    rng = np.random.RandomState(SEED + 510)
    p = 1.0 / np.arange(1, RNN_TYPES + 1) ** 1.1
    p /= p.sum()
    lines = [" ".join(f"w{i}" for i in rng.choice(
        RNN_TYPES, rng.randint(*RNN_WORDS), p=p)) for _ in range(RNN_LINES)]
    with open(os.path.join(folder, "input.txt"), "w") as f:
        f.write(".\n".join(lines) + ".\n")
    with open(os.path.join(folder, "test.txt"), "w") as f:
        f.write("\n".join(" ".join(line.split()[:5])
                          for line in lines[:RNN_TEST]) + "\n")


def simple_rnn(device, card):
    """Phase 3s-b: ``models/rnn.py`` ``train_main`` at its defaults but ``-e
    RNN_EPOCHS --checkpoint`` on a corpus written under ``build/`` (removed
    after), the split seeded: finite losses and validation losses, no
    kernel launched, the first loss within RNN_LOSS_RTOL of a CPU forward
    of the same weights on the same batch; then ``test_main`` on the last
    snapshot grows each test sentence by RNN_GROW words; a profile of 3
    steps at the same widths.  Returns (report, launches by path)."""
    import shutil
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.dataset import (DataSet, LabeledSentenceToSample,
                                         SampleToBatch, load_in_data)
    from bigdl_tpu_torch.models import rnn
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.utils.random_generator import RNG
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_rnn")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    ck = os.path.join(folder, "ck")
    crit = TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)
    try:
        write_rnn_corpus(folder)
        RNG().set_seed(SEED + 511)
        with LogArgs("bigdl_tpu_torch.optim", "Epoch ") as steps, \
                LogArgs("bigdl_tpu_torch.optim", "%s is %r") as vals:
            ops.reset_launches()             # the path starts here
            t0 = time.perf_counter()
            rnn.train_main(["-f", folder, "-e", str(RNN_EPOCHS),
                            "--checkpoint", ck], device=device)
            wall = time.perf_counter() - t0
            launches = launches_now()        # and ends here
        snap = max((f for f in os.listdir(ck) if f.startswith("model.")),
                   key=lambda f: int(f.split(".")[1]))
        ops.reset_launches()
        t0 = time.perf_counter()
        grown = rnn.test_main(["-f", folder, "--model",
                               os.path.join(ck, snap), "--words",
                               str(RNN_GROW)], device=device)
        test_s = time.perf_counter() - t0
        test_launches = launches_now()
        # the split and first batch train_main took, again, on the CPU
        RNG().set_seed(SEED + 511)
        train, _, train_max, _ = load_in_data(folder, 4001)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    to_batch = LabeledSentenceToSample(4001, train_max, train_max) >> \
        SampleToBatch(8, drop_last=True)
    batch = next(iter(to_batch(train[:8])))
    with torch.no_grad():
        cpu_loss = crit(rnn.SimpleRNN(4001, 40, 4001, 4)(
            torch.from_numpy(batch.data)),
            torch.from_numpy(batch.labels)).item()
    expect_launches("SimpleRNN train_main", launches, {})
    expect_launches("SimpleRNN test_main", test_launches, {})
    losses = [a[3] for a in steps]
    val = [v[1].result()[0] for v in vals]
    if len(vals) != RNN_EPOCHS or not all(
            math.isfinite(x) for x in losses + val):
        fail(f"SimpleRNN: losses {losses}, validation {val}")
    rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    if not rel <= RNN_LOSS_RTOL:
        fail(f"SimpleRNN: first loss {losses[0]} on the card, {cpu_loss} on "
             f"the CPU (relative {rel:.3g}, limit {RNN_LOSS_RTOL})")
    test_words = [len(s.split()) for s in grown]
    if len(grown) != RNN_TEST or test_words != [5 + RNN_GROW] * RNN_TEST:
        fail(f"SimpleRNN test_main: {grown}")
    ms = [1e3 * 8 / a[4] for a in steps]
    step_ms = statistics.median(ms[1:])
    opt = Optimizer(rnn.SimpleRNN(4001, 40, 4001, 4),
                    DataSet.array(train) >> to_batch, crit,
                    Trigger.max_iteration(3), device=device)
    opt.set_optim_method(SGD(learning_rate=0.1))
    prof = device_profile(opt.optimize, 3)
    report = {"steps": len(steps), "losses": losses,
              "validation_loss": val, "cpu_first_loss": cpu_loss,
              "first_loss_rel": rel, "train_max": train_max,
              "step_ms_median": step_ms, "records_per_s": 8 / step_ms * 1e3,
              "busy_share": prof["device_ms"] / step_ms, "profile": prof,
              "wall_s": wall, "test_main_s": test_s, "grown": grown}
    log(f"[{card}] SimpleRNN train_main (defaults, -e {RNN_EPOCHS}, "
        f"{RNN_LINES} lines, T {train_max}): {len(steps)} steps, loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}, validation {val}; first loss "
        f"vs CPU relative {rel:.3g} (limit {RNN_LOSS_RTOL}); step "
        f"{step_ms:.3f} ms (median after the first), "
        f"{report['records_per_s']:.1f} records/s; device "
        f"{prof['device_ms']:.3f} ms a step, busy share "
        f"{report['busy_share']:.3f}; main {wall:.1f} s; test_main "
        f"({RNN_GROW} words x {RNN_TEST}) {test_s:.2f} s; top (ms): "
        + json.dumps(prof["top"][:6]))
    return report, {"simple_rnn": launches, "simple_rnn_test": test_launches}


def slice_layers(small=False):
    """(name, layer, input) of this slice's layers at shapes users meet
    them (``small``: a cut of each for the card tests), f32, seeded."""
    import bigdl_tpu_torch.nn as nn
    from bigdl_tpu_torch.nn.normalization import _gaussian_kernel_2d
    rng = np.random.RandomState(SEED + 520)
    s = 4 if small else 1

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def ids(n, *shape):
        return rng.randint(1, n + 1, shape).astype(np.float32)

    b, t, d = 32 // s, 50 // s, 128 // s
    gauss = _gaussian_kernel_2d(7)
    planes = (128 // s, 16, 32 // s, 32 // s)
    layers = [
        ("SpatialShareConvolution", nn.SpatialShareConvolution(
            64 // s, 64 // s, 3, 3, 1, 1, 1, 1),
         normal(32 // s, 64 // s, 56 // s, 56 // s)),
        ("SpatialDilatedConvolution", nn.SpatialDilatedConvolution(
            512 // s, 512 // s, 3, 3, 1, 1, 2, 2, 2, 2),
         normal(16 // s, 512 // s, 28 // s, 28 // s)),
        ("SpatialFullConvolution", nn.SpatialFullConvolution(
            512 // s, 256 // s, 4, 4, 2, 2, 1, 1),
         normal(64 // s, 512 // s, 8, 8)),
        ("SpatialConvolutionMap", nn.SpatialConvolutionMap(
            nn.SpatialConvolutionMap.full(16, 32), 5, 5), normal(*planes)),
        ("LookupTable", nn.LookupTable(20000 // s, 100, max_norm=12.0),
         ids(20000 // s, 128 // s, 1000 // s)),
        ("Normalize", nn.Normalize(2.0), normal(128 // s, 4096 // s)),
        ("SpatialSubtractiveNormalization",
         nn.SpatialSubtractiveNormalization(16, gauss), normal(*planes)),
        ("SpatialDivisiveNormalization",
         nn.SpatialDivisiveNormalization(16, gauss), normal(*planes)),
        ("SpatialContrastiveNormalization",
         nn.SpatialContrastiveNormalization(16, gauss), normal(*planes)),
        ("Cell (LSTMCell, one step)", nn.LSTMCell(d, d),
         [normal(b, d), [normal(b, d), normal(b, d)]]),
        ("Recurrent(RnnCell), bptt 4", nn.Recurrent(d, 4).add(
            nn.RnnCell(d, d)), normal(b, t, d)),
        ("Recurrent(LSTMCell)", nn.Recurrent(d).add(nn.LSTMCell(d, d)),
         normal(b, t, d)),
        ("Recurrent(GRUCell)", nn.Recurrent(d).add(nn.GRUCell(d, d)),
         normal(b, t, d)),
        ("TimeDistributed(Linear)", nn.TimeDistributed(
            nn.Linear(40, 4001 // s)), normal(8, t, 40)),
    ]
    for i, (_, m, _) in enumerate(layers):
        m.reset(SEED + 521 + i)
    return layers


def slice_models(small=False):
    """(name, packed model, input, launches a forward on the card) of the
    slice's three models under ``quantize_model(..., "w8")``: the text
    classifier (its 3 convs on the fused int8 conv and Linear(128, 100): 4
    K13, and 3 K1), ``SimpleRNN(4001)`` (its output Linear: 1 K13) and
    ``TextClassifierRNN(20000)`` (the packed table gathered; Linear(128,
    20) under the packing size: no launch)."""
    from bigdl_tpu_torch.example import textclassification as tc
    from bigdl_tpu_torch.models import rnn
    from bigdl_tpu_torch.ops import quant
    rng = np.random.RandomState(SEED + 540)
    s = 4 if small else 1
    seq = 200 if small else TEXT_SEQ
    onehot = np.zeros((8, 40 // s, 4001), np.float32)
    for i, row in enumerate(rng.randint(0, 4001, onehot.shape[:2])):
        onehot[i, np.arange(len(row)), row] = 1.0
    models = [
        ("text classifier", tc.build_model(20, TEXT_EMBED, seq),
         (rng.standard_normal((32 // s, TEXT_EMBED, seq)) * 0.4)
         .astype(np.float32), {"max_pool2d": 3, "w8_matmul": 4}),
        ("SimpleRNN(4001)", rnn.SimpleRNN(4001, 40, 4001, 4), onehot,
         {"w8_matmul": 1}),
        ("TextClassifierRNN(20000)", rnn.TextClassifierRNN(20000),
         rng.randint(1, 20001, (32 // s, 200 // s)).astype(np.float32), {}),
    ]
    return [(name, quant.quantize_model(m.reset(SEED + 541 + i), "w8"), x,
             want) for i, (name, m, x, want) in enumerate(models)]


def slice_grads(model, xs, dev, seed):
    """``model`` on the numpy tree ``xs`` on ``dev``: its output, and the
    gradients of the sum of the output times a seeded tensor with respect
    to every floating input (not a table's indices) and every parameter."""
    import torch
    from bigdl_tpu_torch.core.module import tree_map
    from bigdl_tpu_torch.nn import LookupTable
    x = tree_map(lambda v: torch.from_numpy(np.asarray(v)).to(dev), xs)
    leaves = [] if isinstance(model, LookupTable) else \
        [v.requires_grad_(True) for v in _flat(x)]
    params = list(model.parameters())
    y = model(x)
    r = [torch.from_numpy(np.random.RandomState(seed + i).standard_normal(
        tuple(v.shape)).astype(np.float32)).to(dev)
        for i, v in enumerate(_flat(y))]
    g = torch.autograd.grad(sum((v * w).sum() for v, w in zip(_flat(y), r)),
                            leaves + params, allow_unused=True)
    return y, [torch.zeros_like(v) if d is None else d
               for v, d in zip(leaves + params, g)]


def slice_layer_sweep(device, card):
    """Phase 3s-c: each of this slice's layers (:func:`slice_layers`) at
    users' shapes, its forward and the gradients of the sum of its output
    times a seeded tensor with respect to its input and its parameters,
    card vs CPU on the same weights (SLICE_RTOL, SLICE_GRAD_RTOL of each
    result's largest magnitude); then the three models of
    :func:`slice_models` under ``quantize_model("w8")``, card vs CPU on the
    same packed copy (SLICE_QUANT_RTOL), each forward's launches counted.
    Returns ({name: worst errors}, launches by path)."""
    import torch
    from bigdl_tpu_torch import ops
    cpu = torch.device("cpu")
    out = {}
    for i, (name, layer, x) in enumerate(slice_layers()):
        ya, ga = slice_grads(copy.deepcopy(layer).to(device), x, device,
                             SEED + 530 + i)
        yb, gb = slice_grads(layer, x, cpu, SEED + 530 + i)
        out[name] = {"forward": held_within(f"3s-c {name} forward", ya, yb,
                                            SLICE_RTOL),
                     "gradients": held_within(f"3s-c {name} gradients", ga,
                                              gb, SLICE_GRAD_RTOL)}
        log(f"3s-c {name} (card vs CPU): forward {out[name]['forward']:.3g}"
            f", gradients {out[name]['gradients']:.3g} of the largest value "
            f"(limits {SLICE_RTOL}, {SLICE_GRAD_RTOL})")
    by_path = {}
    for name, qm, x, want in slice_models():
        qc = copy.deepcopy(qm).to(device)
        with torch.inference_mode():
            ops.reset_launches()             # the path starts here
            ya = qc(torch.from_numpy(x).to(device))
            torch.cuda.synchronize()
            launches = launches_now()        # and ends here
            yb = qm(torch.from_numpy(x))
        by_path[f"w8 {name}"] = launches
        expect_launches(f"3s-c w8 {name}", launches, want)
        out[f"w8 {name}"] = {"forward": held_within(
            f"3s-c w8 {name}", ya, yb, SLICE_QUANT_RTOL)}
        log(f"3s-c w8 {name} (card vs CPU, the same packed copy): forward "
            f"{out[f'w8 {name}']['forward']:.3g} of the largest value (limit "
            f"{SLICE_QUANT_RTOL}); launches a forward "
            + json.dumps({k: v for k, v in launches.items() if v}))
    log(f"[{card}] 3s-c: {len(out)} layers and packed models held card vs "
        "CPU")
    return out, by_path


# -- phase 3t: the model loaders and the two image mains ---------------------

# ModelValidator (example/loadmodel.py) and ImagePredictor
# (example/imageclassification.py) at batch LOAD_BATCH, f32, on PNG files
# written here with the port's encoder (zlib and struct, no PIL): a val/
# tree of LOAD_CLASSES folders of LOAD_PER_CLASS files at LOAD_SIZES in
# turn (all but 256 x 256 resized on the host), their rows through the
# five PNG filters, and LOAD_FLAT flat files for the ImagePredictor.
# AlexNet's mean file is per pixel at 256 x 256, which the reference's
# pipeline subtracts before its crop, so 3t-b's tree holds LOAD_SQUARE
# images only.  Weights are each model's own seeded init, carried through
# a caffemodel (V2 records under the model's names), a .t7 or Module.save.
LOAD_CLASSES, LOAD_PER_CLASS, LOAD_BATCH, LOAD_FLAT = 4, 16, 32, 32
LOAD_SIZES = ((256, 341), (341, 256), (300, 300), (256, 256))
LOAD_SQUARE = ((300, 300), (256, 256))
LOAD_CPU_ROWS = 2              # rows of each model held against the CPU
LOAD_LOGIT_RTOL = 1e-5         # card vs CPU log-probs, of the largest
# 3t-e: the top-5 classes are compared where every gap between the top 6
# CPU log-probs exceeds this (card and CPU differ by about 1e-6), and at
# least half the images must qualify
LOAD_MARGIN = 1e-4
# the classifier's bias is raised by this for the classes of the staged
# folders (labels 1-4), so they lead every image's top 5 and the image's
# content picks its top 1: Top-1 and Top-5 then count something
LOAD_FAVOUR = 4.0


def write_pngs(folder, n, sizes, seed):
    """``n`` smooth seeded RGB images of ``sizes`` in turn, as PNG files
    whose rows cycle through the five filters."""
    from bigdl_tpu_torch.dataset import png
    rng = np.random.RandomState(seed)
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:h, 0:w]
        f = rng.uniform(0.01, 0.08, 3)
        img = np.stack([127 + 110 * np.sin(f[c] * (xx + (c + 1) * yy) + i)
                        for c in range(3)], axis=2)
        img += rng.uniform(-12, 12, img.shape)
        with open(os.path.join(folder, f"{i:03d}.png"), "wb") as fh:
            fh.write(png.encode_png(np.clip(img, 0, 255).astype(np.uint8),
                                    [0, 1, 2, 3, 4]))


def stage_val(folder, sizes, seed):
    for c in range(LOAD_CLASSES):
        write_pngs(os.path.join(folder, "val", f"n{c:08d}"), LOAD_PER_CLASS,
                   sizes, seed + c)


def favour_staged_classes(model, classifier):
    """Raise ``classifier``'s bias by LOAD_FAVOUR for classes 1 to
    LOAD_CLASSES; returns ``model``."""
    import torch
    from bigdl_tpu_torch.core.module import get_named_modules
    with torch.no_grad():
        get_named_modules(model)[classifier].bias[:LOAD_CLASSES] += \
            LOAD_FAVOUR
    return model


def caffe_layers(model):
    """The model's own weights as caffe layers (V2 records) under its
    module names."""
    from bigdl_tpu_torch.core.module import Container, get_named_modules
    layers = []
    for name, m in get_named_modules(model).items():
        if isinstance(m, Container) or getattr(m, "weight", None) is None:
            continue
        blobs = [m.weight.detach().numpy().copy()]
        if m.bias is not None:
            blobs.append(m.bias.detach().numpy().copy())
        layers.append({"name": name, "blobs": blobs, "type":
                       "Convolution" if m.weight.dim() == 4
                       else "InnerProduct"})
    return layers


def check_blobs(what, model, layers):
    """Every weighted parameter on the card, f32, equal to its blob bit
    for bit."""
    import torch
    from bigdl_tpu_torch.core.module import get_named_modules
    named = get_named_modules(model)
    for layer in layers:
        m = named[layer["name"]]
        for p, blob in zip((m.weight, m.bias), layer["blobs"]):
            if p.device.type != "cuda" or p.dtype != torch.float32:
                fail(f"{what}: {layer['name']} on {p.device} in {p.dtype}")
            if not torch.equal(p.detach().cpu(), torch.from_numpy(blob)):
                fail(f"{what}: {layer['name']} differs from its blob")
    return len(layers)


def run_validator(what, argv, device, counts, n_images):
    """``loadmodel.main(argv)`` on ``device`` with every count set to 0
    just before and read just after.  The model it loads is kept (its
    ``load_model`` wrapped), and so are its batches, with the seconds its
    host pipeline spent making them and, of those, decoding and resizing
    (the dataset's iterator and ``LocalImgReader._read`` timed).  Fails
    unless ``n_images`` were counted and each forward launched ``counts``
    and nothing else.  Returns (results, model, load seconds, wall
    seconds, launches, (host seconds, batches, decode seconds))."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.dataset.dataset import TransformedDataSet
    from bigdl_tpu_torch.dataset.image import LocalImgReader
    from bigdl_tpu_torch.example import loadmodel as lm
    kept = {"host_s": 0.0, "decode_s": 0.0, "batches": []}
    load_model, data, read = (lm.load_model, TransformedDataSet.data,
                              LocalImgReader._read)

    def keep(*args, **kwargs):
        t0 = time.perf_counter()
        kept["model"] = load_model(*args, **kwargs)
        torch.cuda.synchronize(device)
        kept["load_s"] = time.perf_counter() - t0
        return kept["model"]

    def timed_data(self, train):
        batches = data(self, train)
        while True:
            t0 = time.perf_counter()
            b = next(batches, None)
            kept["host_s"] += time.perf_counter() - t0
            if b is None:
                return
            kept["batches"].append(b)
            yield b

    def timed_read(self, path):
        t0 = time.perf_counter()
        out = read(self, path)
        kept["decode_s"] += time.perf_counter() - t0
        return out
    lm.load_model, TransformedDataSet.data = keep, timed_data
    LocalImgReader._read = timed_read
    try:
        ops.reset_launches()             # the path starts here
        t0 = time.perf_counter()
        results = lm.main(argv + ["-b", str(LOAD_BATCH)], device=device)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches = launches_now()        # and ends here
    finally:
        lm.load_model, TransformedDataSet.data = load_model, data
        LocalImgReader._read = read
    batches = -(-n_images // LOAD_BATCH)
    expect_launches(what, launches,
                    {k: v * batches for k, v in counts.items()})
    if [r.count for r in results] != [n_images, n_images]:
        fail(f"{what}: counted {[r.count for r in results]}, want "
             f"{n_images} images")
    return (results, kept["model"], kept["load_s"], wall, launches,
            (kept["host_s"], kept["batches"], kept["decode_s"]))


def forward_times(model, device, host):
    """The validator's path in parts: its host pipeline's seconds (from
    ``run_validator``), then the same batches' upload and forward on the
    card (CUDA-synchronized, after one warm pass), and the forwards'
    device time."""
    import torch
    host_s, batches, decode_s = host

    def forwards():
        with torch.inference_mode():
            for b in batches:
                model(torch.from_numpy(b.data).to(device))
        torch.cuda.synchronize(device)
    forwards()
    t0 = time.perf_counter()
    forwards()
    fwd_s = time.perf_counter() - t0
    prof = device_profile(forwards, len(batches))
    return {"host_pipeline_s": host_s, "decode_resize_s": decode_s,
            "decode_resize_ms_per_image": 1e3 * decode_s / sum(
                b.size() for b in batches),
            "upload_forward_s": fwd_s,
            "device_ms_per_batch": prof["device_ms"],
            "batches": len(batches), "top": prof["top"][:5]}


def held_rows(what, model, cpu_model, host, device):
    """LOAD_CPU_ROWS rows of the first of ``host``'s batches through the
    card model and a CPU copy: the largest difference of the log-probs, of their largest
    magnitude, within LOAD_LOGIT_RTOL."""
    import torch
    x = torch.from_numpy(host[1][0].data[:LOAD_CPU_ROWS])
    with torch.inference_mode():
        got = model(x.to(device)).cpu()
        want = cpu_model.evaluate()(x)
    if tuple(got.shape) != (LOAD_CPU_ROWS, CLASSES):
        fail(f"{what}: log-probs of shape {tuple(got.shape)}")
    return held_within(what, got, want, LOAD_LOGIT_RTOL)


def validator_report(card, what, results, load_s, wall, parts, n,
                     launches, extra):
    validate_s = wall - load_s
    r = {"images": n, "top1": results[0].result()[0],
         "top5": results[1].result()[0], "load_s": load_s,
         "validate_s": validate_s, "images_per_s": n / validate_s,
         "host_share": parts["host_pipeline_s"] / validate_s,
         "forward_share": parts["upload_forward_s"] / validate_s,
         "busy_share": parts["device_ms_per_batch"] * parts["batches"]
         / 1e3 / validate_s,
         "launches": {k: v for k, v in launches.items() if v}}
    r.update(parts)
    r.update(extra)
    log(f"[{card}] {what}: {n} images, Top-1 {r['top1']:.4f}, Top-5 "
        f"{r['top5']:.4f}; load {load_s:.3f} s, validation {validate_s:.3f}"
        f" s ({r['images_per_s']:.1f} images/s); host pipeline "
        f"{parts['host_pipeline_s']:.3f} s (share {r['host_share']:.3f}; "
        f"decode and resize {parts['decode_resize_s']:.3f} s, "
        f"{parts['decode_resize_ms_per_image']:.2f} ms an image), "
        f"upload + forward {parts['upload_forward_s']:.4f} s (share "
        f"{r['forward_share']:.4f}), device "
        f"{parts['device_ms_per_batch']:.3f} ms a batch of {LOAD_BATCH} "
        f"(busy share {r['busy_share']:.4f}); launches {r['launches']}; "
        + json.dumps(extra))
    return r


def image_predictor(device, card, flat, alex_path, cpu):
    """Phase 3t-e: ``imageclassification.main --modelType caffe --topN 5``
    on the flat folder, counted from 0; its classes against the CPU
    model's on the same pipeline.  Returns (report, launches)."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.dataset import (BGRImgCropper, BGRImgNormalizer,
                                         LocalImgReader)
    from bigdl_tpu_torch.example import imageclassification as ic
    ops.reset_launches()                 # the path starts here
    t0 = time.perf_counter()
    classes = ic.main(["-f", flat, "--modelType", "caffe", "--modelPath",
                       alex_path, "--topN", "5"], device=device)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = launches_now()            # and ends here
    expect_launches("3t-e", launches,
                    {"max_pool2d": 3 * -(-LOAD_FLAT // LOAD_BATCH),
                     "cross_map_lrn": 2 * -(-LOAD_FLAT // LOAD_BATCH)})
    files = sorted(os.listdir(flat))
    reader = LocalImgReader(256)
    crop = BGRImgCropper(227, 227, center=True)
    norm = BGRImgNormalizer((123, 117, 104), (1, 1, 1))
    imgs = list(norm(crop(reader((os.path.join(flat, f), 0.0)
                                 for f in files))))
    with torch.inference_mode():
        lp = cpu.evaluate()(torch.from_numpy(np.stack(
            [i.data.transpose(2, 0, 1) for i in imgs])))
    top6 = lp.topk(6, dim=1)
    gaps = (top6.values[:, :-1] - top6.values[:, 1:]).min(dim=1).values
    firm = [i for i in range(len(files)) if gaps[i] > LOAD_MARGIN]
    want = (top6.indices[:, :5] + 1).tolist()
    if [os.path.basename(f) for f, _ in classes] != files:
        fail(f"3t-e: classified {[f for f, _ in classes]}")
    bad = [files[i] for i in firm if classes[i][1] != want[i]]
    if bad or len(firm) < LOAD_FLAT // 2:
        fail(f"3t-e: top-5 differs from the CPU's for {bad}; {len(firm)} of "
             f"{LOAD_FLAT} images have top-6 gaps over {LOAD_MARGIN}")
    report = {"images": LOAD_FLAT, "wall_s": wall,
              "images_per_s": LOAD_FLAT / wall, "compared": len(firm),
              "min_gap": float(gaps.min()),
              "launches": {k: v for k, v in launches.items() if v}}
    log(f"[{card}] 3t-e imageclassification --modelType caffe --topN 5 "
        f"({LOAD_FLAT} files, AlexNet(1000), f32): {wall:.3f} s with the "
        f"model's load ({LOAD_FLAT / wall:.1f} images/s); top-5 equal to the "
        f"CPU's on the {len(firm)} images whose top-6 gaps exceed "
        f"{LOAD_MARGIN} (smallest gap {float(gaps.min()):.3g}); launches "
        f"{report['launches']}")
    return report, launches


def loaders_and_mains(device, card):
    """Phase 3t: (a) ``loadmodel.main -m inception -t caffe`` with
    ``Inception_v1(1000)``'s seeded weights in a caffemodel (V2, its
    GoogLeNet names, match_all); (d) ``-t bigdl``: (a)'s card model
    through ``Module.save`` and ``nn.load``, Top-1 and Top-5 equal to
    (a)'s; (b) ``-m alexnet -t caffe --meanFile`` with ``AlexNet(1000)``
    (grouped convs) and a 256 x 256 x 3 mean file ``File.save`` wrote; (e)
    ``imageclassification.main`` with (b)'s caffemodel
    (``image_predictor``); (c) ``-m inception -t torch`` with
    ``AlexNet_OWT(1000)`` written by ``save_torch`` and read by
    ``nn.load_torch``.  Each validator run on the card: every image
    counted, 13 K1 + 2 K2 (Inception-v1), 3 K1 + 2 K2 (AlexNet) or 3 K1
    (AlexNet-OWT) a forward and nothing else, the caffemodels' blobs on the
    card bit for bit, LOAD_CPU_ROWS rows within LOAD_LOGIT_RTOL of a CPU
    copy (the saved module for (c)); the host pipeline, the forwards and
    their device time apart.  Files are staged under ``build/`` and
    removed after.  Returns (report, launches by path)."""
    import shutil
    import torch
    from bigdl_tpu_torch.example import loadmodel as lm
    from bigdl_tpu_torch.models import AlexNet, AlexNet_OWT, Inception_v1
    from bigdl_tpu_torch.utils.caffe_loader import encode_caffemodel
    from bigdl_tpu_torch.utils.file import File
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_images")
    shutil.rmtree(root, ignore_errors=True)
    mixed, square = os.path.join(root, "mixed"), os.path.join(root, "square")
    flat = os.path.join(root, "flat")
    n = LOAD_CLASSES * LOAD_PER_CLASS
    report, paths = {}, {}
    try:
        t0 = time.perf_counter()
        stage_val(mixed, LOAD_SIZES, SEED + 600)
        stage_val(square, LOAD_SQUARE, SEED + 610)
        write_pngs(flat, LOAD_FLAT, LOAD_SIZES, SEED + 620)
        report["stage_s"] = time.perf_counter() - t0
        log(f"[{card}] 3t staging: {2 * n + LOAD_FLAT} PNG files written in "
            f"{report['stage_s']:.2f} s")

        # (a) Inception-v1 from a caffemodel
        inc_layers = caffe_layers(favour_staged_classes(
            Inception_v1(CLASSES).reset(SEED + 30), "loss3/classifier"))
        inc_path = os.path.join(root, "googlenet.caffemodel")
        with open(inc_path, "wb") as f:
            f.write(encode_caffemodel(inc_layers))
        inc_counts = {"max_pool2d": 13, "cross_map_lrn": 2}
        argv = ["-f", mixed, "-m", "inception", "-t", "caffe",
                "--caffeDefPath", os.path.join(root, "deploy.prototxt"),
                "--modelPath", inc_path]
        res_a, model_a, load_s, wall, paths["load_inception_caffe"], host = \
            run_validator("3t-a", argv, device, inc_counts, n)
        blobs = check_blobs("3t-a", model_a, inc_layers)
        parts = forward_times(model_a, device, host)
        cpu = lm.load_model("caffe", inc_path, None, "cpu",
                            lambda: Inception_v1(CLASSES))
        err = held_rows("3t-a", model_a, cpu, host, device)
        report["a_inception_caffe"] = validator_report(
            card, "3t-a loadmodel -m inception -t caffe (Inception_v1(1000),"
            " f32)", res_a, load_s, wall, parts, n,
            paths["load_inception_caffe"],
            {"caffemodel_bytes": os.path.getsize(inc_path),
             "blobs_equal": blobs, "card_vs_cpu": err})

        # (d) the same card model through Module.save and nn.load
        bigdl_path = os.path.join(root, "inception.bigdl")
        t0 = time.perf_counter()
        model_a.save(bigdl_path)
        save_s = time.perf_counter() - t0
        del model_a, cpu
        argv = ["-f", mixed, "-m", "inception", "-t", "bigdl",
                "--modelPath", bigdl_path]
        res_d, model_d, load_s, wall, paths["load_inception_bigdl"], _ = \
            run_validator("3t-d", argv, device, inc_counts, n)
        if [(r.correct, r.count) for r in res_d] != \
                [(r.correct, r.count) for r in res_a]:
            fail(f"3t-d: -t bigdl {res_d}, -t caffe {res_a}")
        if any(p.device.type != "cuda" for p in model_d.parameters()):
            fail("3t-d: nn.load left a parameter off the card")
        del model_d
        report["d_inception_bigdl"] = {
            "top1": res_d[0].result()[0], "top5": res_d[1].result()[0],
            "save_s": save_s, "load_s": load_s, "validate_s": wall - load_s,
            "file_bytes": os.path.getsize(bigdl_path),
            "launches": {k: v for k, v in
                         paths["load_inception_bigdl"].items() if v}}
        log(f"[{card}] 3t-d loadmodel -m inception -t bigdl: Module.save "
            f"{save_s:.3f} s ({report['d_inception_bigdl']['file_bytes']} "
            f"B), nn.load {load_s:.3f} s, validation {wall - load_s:.3f} s; "
            f"Top-1 and Top-5 equal to 3t-a's ({res_d[0]}, {res_d[1]})")

        # (b) AlexNet from a caffemodel, with the mean file
        alex_layers = caffe_layers(favour_staged_classes(
            AlexNet(CLASSES).reset(SEED + 31), "fc8"))
        alex_path = os.path.join(root, "alexnet.caffemodel")
        with open(alex_path, "wb") as f:
            f.write(encode_caffemodel(alex_layers))
        mean_path = os.path.join(root, "mean")
        File.save(np.random.RandomState(SEED + 32).uniform(
            100, 130, (256, 256, 3)).astype(np.float32), mean_path)
        argv = ["-f", square, "-m", "alexnet", "-t", "caffe",
                "--modelPath", alex_path, "--meanFile", mean_path]
        res_b, model_b, load_s, wall, paths["load_alexnet_caffe"], host = \
            run_validator("3t-b", argv, device,
                          {"max_pool2d": 3, "cross_map_lrn": 2}, n)
        blobs = check_blobs("3t-b", model_b, alex_layers)
        del alex_layers
        parts = forward_times(model_b, device, host)
        cpu = lm.load_model("caffe", alex_path, None, "cpu",
                            lambda: AlexNet(CLASSES))
        err = held_rows("3t-b", model_b, cpu, host, device)
        del model_b
        report["b_alexnet_caffe"] = validator_report(
            card, "3t-b loadmodel -m alexnet -t caffe --meanFile "
            "(AlexNet(1000), grouped convs, f32)", res_b, load_s, wall,
            parts, n, paths["load_alexnet_caffe"],
            {"caffemodel_bytes": os.path.getsize(alex_path),
             "blobs_equal": blobs, "card_vs_cpu": err})

        # (e) ImagePredictor with (b)'s caffemodel
        report["e_imageclassification"], paths["imageclassification"] = \
            image_predictor(device, card, flat, alex_path, cpu)
        del cpu

        # (c) AlexNet-OWT through save_torch and nn.load_torch
        owt = favour_staged_classes(AlexNet_OWT(CLASSES).reset(SEED + 33),
                                    "fc8").evaluate()
        t7_path = os.path.join(root, "alexnet_owt.t7")
        t0 = time.perf_counter()
        owt.save_torch(t7_path)
        write_s = time.perf_counter() - t0
        argv = ["-f", mixed, "-m", "inception", "-t", "torch",
                "--modelPath", t7_path]
        res_c, model_c, load_s, wall, paths["load_owt_torch"], host = \
            run_validator("3t-c", argv, device, {"max_pool2d": 3}, n)
        if any(p.device.type != "cuda" or p.dtype != torch.float32
               for p in model_c.parameters()):
            fail("3t-c: nn.load_torch left a parameter off the card or "
                 "out of f32")
        parts = forward_times(model_c, device, host)
        err = held_rows("3t-c", model_c, owt, host, device)
        report["c_owt_torch"] = validator_report(
            card, "3t-c loadmodel -m inception -t torch (AlexNet_OWT(1000),"
            " f32)", res_c, load_s, wall, parts, n, paths["load_owt_torch"],
            {"t7_bytes": os.path.getsize(t7_path), "t7_write_s": write_s,
             "t7_read_s": load_s, "card_vs_saved_module": err})
        del model_c, owt
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return report, paths


# -- phase 3u: record-file ImageNet training and the conv nets' mains ---------

# 3u-a: the generator over a staged PNG tree (4 classes, mixed sizes)
GEN_CLASSES, GEN_TRAIN, GEN_VAL = 4, 6, 3       # PNG files a class
GEN_SIZES = ((256, 341), (341, 256), (300, 300), (288, 320))
GEN_BLOCK = 5                                   # records a file
# 3u-b: the record folder train_main reads (256-short-side BGR images,
# labels 1-1000), its run and its checks
SEQ_TRAIN, SEQ_VAL, SEQ_BLOCK = 320, 128, 64    # 5 train files, 2 val
SEQ_EPOCHS = 3                                  # 10 steps an epoch: 30
SEQ_CPU_BATCH, SEQ_CPU_ITERS = 4, 2             # card vs CPU, bf16
SEQ_PROFILE_STEPS = 3
# the resumed run restarts its crop and flip draws (fresh transformers, as
# a fresh process of the reference's has): the same records in the same
# order, other crops of them, so its losses are held to this share of the
# uninterrupted run's, per step
SEQ_RESUME_RTOL = 0.05
PREFETCH_BATCHES = 6                            # compared, > the depth 2
UPLOAD_REPS = 20
# 3u-d: the other mains' data, cut from 60 000/10 000 (MNIST) and
# 50 000/10 000 (CIFAR-10)
MAIN_MNIST = (6000, 1000)
MAIN_CIFAR = (1000, 1000)                       # a data batch (x5), test
MAIN_LOSS_RTOL = 1e-4                           # first loss, card vs CPU
# LeNet-5's two 2x2/2 pools at its batch of 128, VggForCifar10's five
# ceil-mode 2x2/2 pools at its batch of 112
LENET_POOLS = [
    ("lenet/pool1 2x2_s2", (128, 6, 24, 24), 2, 2, 2, 2, 0, 0, False),
    ("lenet/pool2 2x2_s2", (128, 12, 8, 8), 2, 2, 2, 2, 0, 0, False)]
CIFAR_VGG_POOLS = [
    (f"vgg_cifar/pool{i + 1} 2x2_s2 ceil", (112, c, hw, hw), 2, 2, 2, 2, 0,
     0, True)
    for i, (c, hw) in enumerate(((64, 32), (128, 16), (256, 8), (512, 4),
                                 (512, 2)))]
# 3u-e and 3u-f
INGEST_ARGS = ["-n", "1024", "-e", "2"]
LBFGS_ROWS, LBFGS_DIM, LBFGS_ITERS = 4096, 64, 20
OPTIMIZE_STEPS = 20
LBFGS_RTOL = 1e-4              # card vs CPU losses (line search, f32 sums)
OPTIMIZE_RTOL = 1e-5           # card vs CPU losses of SGD/Adam/Adagrad


def quiet_step_logs():
    """The mains' stdout handler (``utils/log.py``) raised to WARNING, so
    their per-step lines stay out of the run's output; the trainer's
    records still reach ``LogArgs``.  Returns a restore function."""
    import logging
    from bigdl_tpu_torch.utils.log import init_logging
    init_logging()
    handlers = logging.getLogger("bigdl_tpu_torch").handlers
    levels = [h.level for h in handlers]
    for h in handlers:
        h.setLevel(logging.WARNING)

    def restore():
        for h, lv in zip(handlers, levels):
            h.setLevel(lv)
    return restore


class StepCapture:
    """Wraps ``LocalOptimizer``: keeps every trainer built in the block
    (``.trainers``), the first step's batch, criterion and a host copy of
    the model as the step found it (``.first``), and the host seconds each
    step waited in ``next(data_iter)`` (``.waits``, the dataset's iterator
    timed)."""

    def __init__(self):
        self.trainers, self.first, self.waits = [], None, []

    def __enter__(self):
        from bigdl_tpu_torch import optim
        from bigdl_tpu_torch.dataset.dataset import TransformedDataSet
        from bigdl_tpu_torch.optim import local_optimizer as lo
        self._saved = (optim.Optimizer, lo.LocalOptimizer._step,
                       TransformedDataSet.data)
        make, step, data = self._saved
        outer = self

        def capture(*args, **kwargs):
            opt = make(*args, **kwargs)
            outer.trainers.append(opt)
            return opt

        def first_step(opt, params, x, y, *args, **kwargs):
            if outer.first is None:
                outer.first = {"data": x.detach().cpu().clone(),
                               "labels": y.detach().cpu().clone(),
                               "model": copy.deepcopy(opt.model).cpu(),
                               "criterion": opt.criterion}
            return step(opt, params, x, y, *args, **kwargs)

        def timed(ds, train):
            it = data(ds, train)
            if not train:
                yield from it
                return
            while True:
                t0 = time.perf_counter()
                b = next(it, None)
                outer.waits.append(time.perf_counter() - t0)
                if b is None:
                    return
                yield b
        optim.Optimizer = capture
        lo.LocalOptimizer._step = first_step
        TransformedDataSet.data = timed
        return self

    def __exit__(self, *exc):
        from bigdl_tpu_torch import optim
        from bigdl_tpu_torch.dataset.dataset import TransformedDataSet
        from bigdl_tpu_torch.optim import local_optimizer as lo
        (optim.Optimizer, lo.LocalOptimizer._step,
         TransformedDataSet.data) = self._saved


def step_report(opt, waits, batch):
    """Per-step numbers of a trainer's run: the median step (the wait in
    ``next(data_iter)`` plus the trainer's upload-to-loss time) after the
    first, the median upload-to-loss time alone, images/s at the step, and
    the share of the steps' time spent waiting for the batch."""
    durs = [r["dur_s"] for r in opt.step_records]
    waits = waits[:len(durs)]
    steps = [w + d for w, d in zip(waits, durs)]
    ms = 1e3 * statistics.median(steps[1:] or steps)
    return {"steps": len(durs), "step_ms": ms,
            "train_ms": 1e3 * statistics.median(durs[1:] or durs),
            "images_per_s": batch / ms * 1e3,
            "data_wait_share": sum(waits[1:]) / max(sum(steps[1:]), 1e-12),
            "first_step_ms": 1e3 * steps[0]}


def write_records(folder, n, seed, block):
    """``n`` seeded 256-short-side BGR images (the long side 256, 288, 320
    or 341 in turn, landscape and portrait alternating), labels drawn
    from 1-1000, written by ``BGRImgToLocalSeqFile`` in files of
    ``block`` (``bench_ingest.write_seq_records``)."""
    from bigdl_tpu_torch.dataset.bench_ingest import write_seq_records
    return write_seq_records(folder, n, block, seed=seed, classes=CLASSES)


def seqfile_generator(root, card):
    """Phase 3u-a: ``seqfile.main`` (-p 2, -b GEN_BLOCK) over a staged PNG
    tree (GEN_CLASSES classes, train and val, mixed sizes); ``check_file``
    on every file written; the records rewritten as Hadoop SequenceFiles
    read back through ``LocalSeqFileToBytes`` as the same images."""
    from bigdl_tpu_torch.dataset import (LocalSeqFileToBytes,
                                         SeqBytesToBGRImg)
    from bigdl_tpu_torch.dataset import hadoop_seqfile, seqfile
    tree, out = os.path.join(root, "png"), os.path.join(root, "gen")
    t0 = time.perf_counter()
    for split, per in (("train", GEN_TRAIN), ("val", GEN_VAL)):
        for c in range(GEN_CLASSES):
            write_pngs(os.path.join(tree, split, f"n{c:08d}"), per,
                       GEN_SIZES, SEED + 700 + 10 * c + (split == "val"))
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    files = seqfile.main(["-f", tree, "-o", out, "-p", "2", "-b",
                          str(GEN_BLOCK)])
    gen_s = time.perf_counter() - t0
    n = GEN_CLASSES * (GEN_TRAIN + GEN_VAL)
    checks = [seqfile.check_file(f) for f in files]
    if sum(c["records"] for c in checks) != n or any(
            c["decoded_through_pipeline"] != min(4, c["records"])
            for c in checks):
        fail(f"3u-a: check_file over the generator's files: {checks}")
    hadoop = os.path.join(root, "hadoop")
    os.makedirs(hadoop)
    for i, f in enumerate(files):
        hadoop_seqfile.write_hadoop_seq_file(
            os.path.join(hadoop, f"h{i:03d}.seq"), seqfile.read_seq_file(f))
    pipe = LocalSeqFileToBytes() >> SeqBytesToBGRImg()
    got = list(pipe(seqfile.seq_file_paths(hadoop)))
    want = list(pipe(files))
    if len(got) != n or any(not np.array_equal(g.data, w.data) or
                            g.label != w.label for g, w in zip(got, want)):
        fail("3u-a: the Hadoop SequenceFiles read back other images")
    shapes = sorted({g.data.shape[:2] for g in got})
    labels = sorted({g.label for g in got})
    report = {"png_files": n, "record_files": len(files),
              "stage_s": stage_s, "generate_s": gen_s,
              "generate_ms_per_image": 1e3 * gen_s / n,
              "shapes": [list(s) for s in shapes], "labels": labels}
    log(f"[{card}] 3u-a seqfile generator (-p 2 -b {GEN_BLOCK}): {n} PNG "
        f"files of {GEN_CLASSES} classes -> {len(files)} record files in "
        f"{gen_s:.3f} s ({report['generate_ms_per_image']:.1f} ms an image;"
        f" staging {stage_s:.2f} s); check_file passes on each; the Hadoop "
        f"copies read back the same {n} images; shapes {shapes}, labels "
        f"{labels}")
    return report


def pipeline_stages(folder, n):
    """The training pipeline of ``_imagenet_set`` a stage at a time over
    the first ``n`` training records, each stage's output kept in a list:
    host ms an image of each stage (read, decode, crop, flip, normalize,
    the 4-thread pack)."""
    from bigdl_tpu_torch.dataset import (BGRImgCropper, BGRImgNormalizer,
                                         HFlip, LocalSeqFileToBytes,
                                         SeqBytesToBGRImg)
    from bigdl_tpu_torch.dataset.prefetch import MTLabeledBGRImgToBatch
    from bigdl_tpu_torch.dataset.seqfile import seq_file_paths
    t0 = time.perf_counter()
    records = list(LocalSeqFileToBytes()(seq_file_paths(
        os.path.join(folder, "train"))))
    out = {"read": 1e3 * (time.perf_counter() - t0) / len(records)}
    items = records[:n]
    for name, t in (("decode", SeqBytesToBGRImg()),
                    ("crop", BGRImgCropper(IMAGE, IMAGE)),
                    ("flip", HFlip(0.5)),
                    ("normalize", BGRImgNormalizer((0.485, 0.456, 0.406),
                                                   (0.229, 0.224, 0.225))),
                    ("pack", MTLabeledBGRImgToBatch(IMAGE, IMAGE, BATCH))):
        t0 = time.perf_counter()
        items = list(t(items))
        out[name] = 1e3 * (time.perf_counter() - t0) / n
    return out


def imagenet_launches(steps, val_forwards):
    return {"max_pool2d": 13 * (steps + val_forwards),
            "cross_map_lrn": 2 * (steps + val_forwards),
            "max_pool2d_bwd": 13 * steps, "lrn_bwd": 2 * steps}


def inception_cpu_check(folder, device):
    """Phase 3u-b's card vs CPU: ``train_main -b SEQ_CPU_BATCH -i
    SEQ_CPU_ITERS`` on the card and on the CPU from the same weights on
    the same batches, dropout 0 (the card's and the CPU's generators draw
    other masks).  bf16 rule, as ``cnn_bf16_vs_cpu``'s: each loss within
    the CPU's own bf16 error on the first (its bf16 loss against its f32
    forward of the same batch), and never below 2 bfloat16 steps of the
    loss (the log-probs round to bf16, in steps)."""
    import torch
    from bigdl_tpu_torch.models import Inception_v1
    from bigdl_tpu_torch.models import inception
    argv = ["-f", folder, "-b", str(SEQ_CPU_BATCH), "-i",
            str(SEQ_CPU_ITERS)]
    inception.Inception_v1 = lambda n: Inception_v1(n, dropout=0.0)
    losses, firsts = [], []
    try:
        for dev in (device, torch.device("cpu")):
            with StepCapture() as cap:
                inception.train_main(argv, device=dev)
            losses.append([r["loss"] for r in cap.trainers[0].step_records])
            firsts.append(cap.first)
    finally:
        inception.Inception_v1 = Inception_v1
    first = firsts[1]
    with torch.inference_mode():
        f32 = float(first["criterion"](first["model"].training_()(
            first["data"]), first["labels"]))
    floor = abs(losses[1][0] - f32)
    limits = [max(floor, 2 * bf16_step(abs(v))) for v in losses[1]]
    diffs = [abs(a - b) for a, b in zip(*losses)]
    if len(diffs) != SEQ_CPU_ITERS or any(
            not d <= lim for d, lim in zip(diffs, limits)):
        fail(f"3u-b: card vs CPU losses {losses[0]} vs {losses[1]}, limits "
             f"{limits} (CPU f32 first loss {f32})")
    same_batch = bool(torch.equal(firsts[0]["data"], firsts[1]["data"]))
    if not same_batch:
        fail("3u-b: the card's and the CPU's first batches differ")
    return {"losses_card": losses[0], "losses_cpu": losses[1],
            "cpu_f32_first_loss": f32, "limits": limits, "diffs": diffs}


def record_file_training(root, card, device):
    """Phase 3u-b: ``inception.train_main -b 32 -e SEQ_EPOCHS
    --checkpoint`` on a record folder written by ``BGRImgToLocalSeqFile``
    (SEQ_TRAIN training records in files of SEQ_BLOCK, SEQ_VAL validation
    records); counts from 0 over the run: 13 K1 + 13 K3 + 2 K2 + 2 K4 a
    step, 13 K1 + 2 K2 a validation forward.  Then ``test_main --model``
    on its last snapshot against ``LocalValidator`` over the same set with
    the in-memory model (equal Top-1 and Top-5); the pipeline's host time
    by stage (``pipeline_stages``); 3 more steps under torch.profiler;
    card vs CPU (``inception_cpu_check``); the resume from the first
    epoch's snapshot.  Returns (report, launches by path,
    the folder)."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.models import inception
    from bigdl_tpu_torch.optim import (LocalValidator, Top1Accuracy,
                                       Top5Accuracy, Trigger)
    folder = os.path.join(root, "imagenet")
    t0 = time.perf_counter()
    train_files = write_records(os.path.join(folder, "train"), SEQ_TRAIN,
                                SEED + 720, SEQ_BLOCK)
    write_records(os.path.join(folder, "val"), SEQ_VAL, SEED + 721,
                  SEQ_BLOCK)
    write_s = time.perf_counter() - t0
    ck = os.path.join(root, "inception_ck")
    steps = SEQ_EPOCHS * -(-SEQ_TRAIN // BATCH)
    val_fwd = SEQ_EPOCHS * -(-SEQ_VAL // BATCH)
    paths = {}
    with StepCapture() as cap:
        ops.reset_launches()                 # the path starts here
        t0 = time.perf_counter()
        model = inception.train_main(
            ["-f", folder, "-b", str(BATCH), "-e", str(SEQ_EPOCHS),
             "--checkpoint", ck], device=device)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        paths["imagenet_train_main"] = launches_now()   # and ends here
    opt = cap.trainers[0]
    losses = [r["loss"] for r in opt.step_records]
    expect_launches("3u-b train_main", paths["imagenet_train_main"],
                    imagenet_launches(steps, val_fwd))
    if len(losses) != steps or not np.isfinite(losses).all() or \
            opt.state.get("skippedSteps"):
        fail(f"3u-b: {len(losses)} losses (want {steps}), finite "
             f"{bool(np.isfinite(losses).all())}, skipped "
             f"{opt.state.get('skippedSteps')}")
    if opt.optim_method.schedule.max_iteration != steps:
        fail(f"3u-b: Poly horizon {opt.optim_method.schedule.max_iteration},"
             f" want {steps} (records, not files)")
    run = step_report(opt, cap.waits, BATCH)
    run["pipeline_ms_per_image"] = pipeline_stages(folder, 4 * BATCH)
    per_step = {k: v / steps for k, v in imagenet_launches(steps, 0).items()}

    # test_main on the last snapshot against the in-memory model
    snap = os.path.join(ck, f"model.{steps}")
    ops.reset_launches()
    results = inception.test_main(["-f", folder, "--model", snap],
                                  device=device)
    paths["imagenet_test_main"] = launches_now()
    expect_launches("3u-b test_main", paths["imagenet_test_main"],
                    {k: v for k, v in imagenet_launches(
                        0, -(-SEQ_VAL // BATCH)).items() if v})
    memory = LocalValidator(model, inception._imagenet_set(
        folder, BATCH, train=False), device=device).test(
            [Top1Accuracy(), Top5Accuracy()])
    if results != memory or results[0].count != SEQ_VAL:
        fail(f"3u-b: test_main {results} against LocalValidator {memory}")

    # 3 more steps of the same trainer and pipeline, profiled
    opt.set_end_when(Trigger.max_iteration(steps + SEQ_PROFILE_STEPS))
    prof = device_profile(opt.optimize, SEQ_PROFILE_STEPS)
    prof["busy_share"] = prof["device_ms"] / run["step_ms"]
    del opt, cap

    cpu = inception_cpu_check(folder, device)

    # resume: the first epoch's snapshot pair, continued to the end
    epoch = steps // SEQ_EPOCHS
    with StepCapture() as cap:
        inception.train_main(
            ["-f", folder, "-b", str(BATCH), "-e", str(SEQ_EPOCHS),
             "--model", os.path.join(ck, f"model.{epoch}"), "--state",
             os.path.join(ck, f"state.{epoch}")], device=device)
    resumed = [r["loss"] for r in cap.trainers[0].step_records]
    rel = [abs(a - b) / abs(b) for a, b in zip(resumed, losses[epoch:])]
    if len(resumed) != steps - epoch or max(rel) > SEQ_RESUME_RTOL:
        fail(f"3u-b: resumed losses {resumed} against {losses[epoch:]} "
             f"(rtol {SEQ_RESUME_RTOL})")
    del cap
    report = {"records": {"train": SEQ_TRAIN, "val": SEQ_VAL,
                          "train_files": len(train_files)},
              "write_s": write_s, "wall_s": wall, "losses": losses,
              "top1": results[0].result()[0], "top5": results[1].result()[0],
              "launches_per_step": per_step, "profile": prof,
              "card_vs_cpu": cpu, "resumed_losses": resumed,
              "resumed_worst_rel": max(rel)}
    report.update(run)
    log(f"[{card}] 3u-b inception.train_main -b {BATCH} -e {SEQ_EPOCHS} "
        f"(bf16, {SEQ_TRAIN} records in {len(train_files)} files, "
        f"{SEQ_VAL} to validate): {steps} steps in {wall:.2f} s with "
        f"{SEQ_EPOCHS} validations; step {run['step_ms']:.2f} ms (median "
        f"after the first; first {run['first_step_ms']:.1f} ms; upload to "
        f"loss {run['train_ms']:.2f} ms), {run['images_per_s']:.1f} "
        f"images/s, next(data_iter) {run['data_wait_share']:.3f} of the "
        f"step; the pipeline's stages, host ms an image: "
        + json.dumps({k: round(v, 3) for k, v in
                      run["pipeline_ms_per_image"].items()})
        + "; launches a step "
        f"{per_step}; losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"test_main Top-1/Top-5 {results[0]!r} / {results[1]!r}, equal to "
        f"LocalValidator's on the in-memory model")
    log(f"[{card}] 3u-b profile ({SEQ_PROFILE_STEPS} steps): device "
        f"{prof['device_ms']:.3f} ms a step ({prof['htod_ms']:.3f} of it "
        f"host-to-device copies), busy share {prof['busy_share']:.3f} of "
        f"the {run['step_ms']:.2f} ms step; top kernels (ms a step): "
        + json.dumps(prof["top"]))
    log(f"[{card}] 3u-b card vs CPU (train_main -b {SEQ_CPU_BATCH} -i "
        f"{SEQ_CPU_ITERS}, bf16, dropout 0): {cpu['losses_card']} vs "
        f"{cpu['losses_cpu']}, |d| {cpu['diffs']}, limits {cpu['limits']} "
        f"(the CPU's f32 first loss {cpu['cpu_f32_first_loss']:.6f}); "
        f"resumed from model.{epoch}/state.{epoch}: {len(resumed)} steps, "
        f"worst {max(rel):.4f} of the uninterrupted losses (limit "
        f"{SEQ_RESUME_RTOL}: other crops of the same records)")
    return report, paths, folder


def prefetch_path(folder, card, device, base):
    """Phase 3u-c: ``PrefetchToDevice`` after ``_imagenet_set``: its first
    PREFETCH_BATCHES batches equal the host pipeline's bit for bit (f32,
    and bf16 where cast on the host); ``train_main -e 1`` with it appended
    to the training set takes (b)'s first epoch's losses (the first bit
    for bit, the rest within 2 bfloat16 steps: cuDNN's weight gradients
    may sum in another order); its step beside (b)'s; one batch's upload
    from pageable memory against a pinned buffer."""
    import itertools
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.dataset.prefetch import PrefetchToDevice
    from bigdl_tpu_torch.models import inception
    host = list(itertools.islice(inception._imagenet_set(
        folder, BATCH, True).data(True), PREFETCH_BATCHES))
    for dtype in (None, torch.bfloat16):
        pipe = inception._imagenet_set(folder, BATCH, True) >> \
            PrefetchToDevice(dtype=dtype, device=device)
        got = list(itertools.islice(pipe.data(True), PREFETCH_BATCHES))
        for g, h in zip(got, host):
            want = torch.from_numpy(h.data)
            if dtype is not None:
                want = want.to(dtype)
            if g.data.device.type != device.type or not torch.equal(
                    g.data.cpu(), want) or not torch.equal(
                        g.labels.cpu(), torch.from_numpy(h.labels)):
                fail(f"3u-c: a prefetched batch ({dtype}) differs from the "
                     "host's")
        del got, pipe
    make = inception._imagenet_set

    def with_prefetch(folder, batch, train, **kw):
        ds = make(folder, batch, train, **kw)
        return ds >> PrefetchToDevice(device=device) if train else ds
    inception._imagenet_set = with_prefetch
    try:
        with StepCapture() as cap:
            ops.reset_launches()
            inception.train_main(["-f", folder, "-b", str(BATCH), "-e", "1"],
                                 device=device)
            launches = launches_now()
    finally:
        inception._imagenet_set = make
    opt = cap.trainers[0]
    losses = [r["loss"] for r in opt.step_records]
    want = base["losses"][:len(losses)]
    n = -(-SEQ_TRAIN // BATCH)
    expect_launches("3u-c", launches,
                    imagenet_launches(n, -(-SEQ_VAL // BATCH)))
    if len(losses) != n or losses[0] != want[0] or any(
            abs(a - b) > 2 * bf16_step(abs(b)) for a, b in zip(losses, want)):
        fail(f"3u-c: losses with PrefetchToDevice {losses} against {want}")
    run = step_report(opt, cap.waits, BATCH)
    del opt, cap

    batch = host[0].data
    pageable = lambda: torch.from_numpy(batch).to(device)  # noqa: E731
    pinned = torch.from_numpy(batch).pin_memory()
    pinned_copy = lambda: pinned.to(device, non_blocking=True)  # noqa: E731
    up = {"pageable_ms": median_ms(pageable, device, reps=UPLOAD_REPS),
          "pinned_ms": median_ms(pinned_copy, device, reps=UPLOAD_REPS),
          "bytes": batch.nbytes}
    report = {"batches_equal": PREFETCH_BATCHES, "losses": losses,
              "upload": up, "launches": {k: v for k, v in launches.items()
                                         if v}}
    report.update(run)
    log(f"[{card}] 3u-c PrefetchToDevice: {PREFETCH_BATCHES} batches equal "
        f"to the host's bit for bit (f32 and bf16); train_main -e 1 with it: "
        f"{len(losses)} losses as 3u-b's first epoch (the first bit for "
        f"bit); step {run['step_ms']:.2f} ms ({run['images_per_s']:.1f} "
        f"images/s, next(data_iter) {run['data_wait_share']:.3f} of the "
        f"step, upload to loss {run['train_ms']:.2f} ms) against 3u-b's "
        f"{base['step_ms']:.2f} ms ({base['train_ms']:.2f}); a batch's upload "
        f"({batch.nbytes / 1e6:.1f} MB) {up['pageable_ms']:.3f} ms pageable, "
        f"{up['pinned_ms']:.3f} ms pinned ({batch.nbytes / up['pinned_ms'] / 1e6:.2f} GB/s)")
    return report, launches


def write_main_data(root):
    """MNIST idx files and CIFAR-10 binaries of seeded images, MAIN_MNIST
    and MAIN_CIFAR records (``write_mnist``, ``write_cifar10_batch``)."""
    from bigdl_tpu_torch.dataset import write_cifar10_batch, write_mnist
    rng = np.random.RandomState(SEED + 730)
    mnist, cifar = os.path.join(root, "mnist"), os.path.join(root, "cifar")
    os.makedirs(mnist)
    os.makedirs(cifar)
    for prefix, n in zip(("train", "t10k"), MAIN_MNIST):
        labels = rng.randint(0, 10, n)
        imgs = rng.randint(0, 200, (n, 28, 28)) + 5 * labels[:, None, None]
        write_mnist(os.path.join(mnist, f"{prefix}-images-idx3-ubyte"),
                    os.path.join(mnist, f"{prefix}-labels-idx1-ubyte"),
                    imgs.astype(np.uint8), labels)
    for i in range(6):
        name = f"data_batch_{i + 1}.bin" if i < 5 else "test_batch.bin"
        n = MAIN_CIFAR[0] if i < 5 else MAIN_CIFAR[1]
        write_cifar10_batch(os.path.join(cifar, name),
                            rng.randint(0, 256, (n, 3, 32, 32)),
                            rng.randint(0, 10, n))
    return mnist, cifar


def main_first_loss_vs_cpu(what, first, card_loss, device):
    """The first step's loss of a main on the card against the same batch
    through a CPU copy of the weights the step found (training mode).  A
    model with dropout is held with dropout off on both sides (the card's
    and the CPU's generators draw other masks)."""
    import torch
    from bigdl_tpu_torch.nn import Dropout
    cpu_model = first["model"].training_()
    dropout = [m for m in cpu_model.modules() if isinstance(m, Dropout)]
    with torch.no_grad():
        if dropout:
            for m in dropout:
                m.p = 0.0
            card_model = copy.deepcopy(cpu_model).to(device)
            card_loss = float(first["criterion"](
                card_model(first["data"].to(device)),
                first["labels"].to(device)))
        cpu_loss = float(first["criterion"](cpu_model(first["data"]),
                                            first["labels"]))
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    if not rel <= MAIN_LOSS_RTOL:
        fail(f"{what}: first loss card {card_loss} vs CPU {cpu_loss}")
    return {"card": card_loss, "cpu": cpu_loss, "rel": rel,
            "dropout_off": bool(dropout)}


def other_mains(root, card, device):
    """Phase 3u-d: LeNet-5, ResNet-20, VggForCifar10 and the autoencoder
    through their mains at the reference's defaults, one epoch of the cut
    data, each counted from 0 (K1/K3: 2 a LeNet forward, 5 a VGG one;
    none for ResNet-20 and the autoencoder), its first loss against the
    CPU, then each ``test_main`` on its snapshot.  Returns (report,
    launches by path)."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.models import autoencoder, lenet, resnet, vgg
    mnist, cifar = write_main_data(root)
    n_train, n_test = MAIN_MNIST
    c_train, c_test = 5 * MAIN_CIFAR[0], MAIN_CIFAR[1]
    mains = [  # (key, module, data, argv, batch, train n, test n, pools)
        ("lenet", lenet, mnist, ["-b", "128", "-e", "1"], 128, n_train,
         n_test, 2),
        ("resnet20", resnet, cifar, ["--nepochs", "1"], 128, c_train,
         c_test, 0),
        ("vgg_cifar", vgg, cifar, ["-b", "112", "-e", "1"], 112, c_train,
         c_test, 5),
        ("autoencoder", autoencoder, mnist, ["-b", "150", "-e", "1"], 150,
         n_train, 0, 0)]
    report, paths = {}, {}
    for key, mod, data, argv, batch, n, n_val, pools in mains:
        ck = os.path.join(root, f"{key}_ck")
        steps, val_fwd = -(-n // batch), -(-n_val // batch)
        with StepCapture() as cap:
            ops.reset_launches()             # the path starts here
            t0 = time.perf_counter()
            mod.train_main(["-f", data, "--checkpoint", ck] + argv,
                           device=device)
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            paths[f"{key}_train_main"] = launches_now()   # and ends here
        opt = cap.trainers[0]
        losses = [r["loss"] for r in opt.step_records]
        expect_launches(f"3u-d {key} train_main", paths[f"{key}_train_main"],
                        {"max_pool2d": pools * (steps + val_fwd),
                         "max_pool2d_bwd": pools * steps})
        if len(losses) != steps or not np.isfinite(losses).all():
            fail(f"3u-d {key}: {len(losses)} losses (want {steps}), finite "
                 f"{bool(np.isfinite(losses).all())}")
        r = step_report(opt, cap.waits, batch)
        r.update(wall_s=wall, first_loss=losses[0], last_loss=losses[-1],
                 card_vs_cpu=main_first_loss_vs_cpu(
                     f"3u-d {key}", cap.first, losses[0], device))
        del opt, cap
        if n_val:
            ops.reset_launches()
            res = mod.test_main(["-f", data, "--model",
                                 os.path.join(ck, f"model.{steps}"), "-b",
                                 str(batch)], device=device)
            paths[f"{key}_test_main"] = launches_now()
            expect_launches(f"3u-d {key} test_main",
                            paths[f"{key}_test_main"],
                            {"max_pool2d": pools * val_fwd})
            if res[0].count != n_val:
                fail(f"3u-d {key} test_main counted {res[0].count}")
            r["test_top1"] = res[0].result()[0]
        report[key] = r
        log(f"[{card}] 3u-d {key} train_main {' '.join(argv)} (f32, {n} "
            f"records): {steps} steps in {wall:.2f} s, step "
            f"{r['step_ms']:.2f} ms ({r['images_per_s']:.1f} images/s, "
            f"next(data_iter) {r['data_wait_share']:.3f} of the step), loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; first loss card vs CPU "
            f"{r['card_vs_cpu']['rel']:.3g} (limit {MAIN_LOSS_RTOL}"
            f"{', dropout off' if r['card_vs_cpu']['dropout_off'] else ''})"
            + (f"; test_main Top-1 {r['test_top1']:.4f}" if n_val else "")
            + f"; launches {({k: v for k, v in paths[f'{key}_train_main'].items() if v})}")
    return report, paths


def ingest_harness(card, device, root):
    """Phase 3u-e: ``perf ingest -n 1024 -e 2`` at -w 1 and -w 4 on the
    card machine's host: images/s of each pass."""
    from bigdl_tpu_torch.models import perf
    out = {}
    for w in (1, 4):
        with LogArgs("bigdl_tpu_torch.models.perf", "epoch ") as args:
            ips = perf.main(["ingest"] + INGEST_ARGS + [
                "-w", str(w), "--workDir", os.path.join(root, "ingest")],
                device=device)
        out[f"w{w}"] = {"images_per_s": ips,
                        "passes": [a[3] for a in args]}
    log(f"[{card}] 3u-e perf ingest {' '.join(INGEST_ARGS)} (256² records, "
        f"224 crops, batch 256; {os.cpu_count()} host cores): -w 1 "
        f"{out['w1']['images_per_s']:.1f} images/s (passes "
        f"{[round(v, 1) for v in out['w1']['passes']]}), -w 4 "
        f"{out['w4']['images_per_s']:.1f} (passes "
        f"{[round(v, 1) for v in out['w4']['passes']]})")
    return out


def logistic_problem(device):
    """A seeded logistic regression of LBFGS_ROWS rows on ``device``
    (``rng``'s draws on the host, so both devices get the same problem):
    ``(feval, x0)`` for ``optimize``."""
    import torch
    rng = np.random.RandomState(SEED + 740)
    x = torch.from_numpy(rng.standard_normal(
        (LBFGS_ROWS, LBFGS_DIM)).astype(np.float32)).to(device)
    w_true = torch.from_numpy(rng.standard_normal(LBFGS_DIM)
                              .astype(np.float32)).to(device)
    # a tenth of the labels flipped: no separating plane, so the loss has
    # a finite minimum
    flip = torch.from_numpy(rng.rand(LBFGS_ROWS) < 0.1).to(device)
    y = ((x @ w_true > 0) ^ flip).float()

    def feval(p):
        q = {k: v.detach().requires_grad_() for k, v in p.items()}
        z = x @ q["w"] + q["b"]
        loss = (torch.nn.functional.softplus(z) - y * z).mean()
        gw, gb = torch.autograd.grad(loss, [q["w"], q["b"]])
        return float(loss.detach()), {"w": gw, "b": gb}
    return feval, {"w": torch.zeros(LBFGS_DIM, device=device),
                   "b": torch.zeros((), device=device)}


def optimize_methods(card, device):
    """Phase 3u-f: ``LBFGS.optimize`` (strong-Wolfe line search) on the
    card-resident logistic regression, then OPTIMIZE_STEPS of
    ``SGD``/``Adam``/``Adagrad.optimize`` on it; each run's losses against
    the same on the CPU."""
    import torch
    from bigdl_tpu_torch.optim import LBFGS, SGD, Adagrad, Adam
    from bigdl_tpu_torch.utils.table import T
    methods = {
        "lbfgs": lambda: LBFGS(max_iter=LBFGS_ITERS, line_search=True),
        "sgd": lambda: SGD(learning_rate=0.5, momentum=0.9),
        "adam": lambda: Adam(learning_rate=0.05),
        "adagrad": lambda: Adagrad(learning_rate=0.5)}
    out = {}
    for name, make in methods.items():
        runs = []
        for dev in (device, torch.device("cpu")):
            feval, x = logistic_problem(dev)
            t0 = time.perf_counter()
            if name == "lbfgs":
                x, losses = make().optimize(feval, x)
            else:
                m, state, losses = make(), T(), []
                for _ in range(OPTIMIZE_STEPS):
                    x, ls = m.optimize(feval, x, state=state)
                    losses += ls
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                if x["w"].device.type != "cuda":
                    fail(f"3u-f {name}: x left the card")
            runs.append((losses, time.perf_counter() - t0))
        (card_l, card_s), (cpu_l, _) = runs
        tol = LBFGS_RTOL if name == "lbfgs" else OPTIMIZE_RTOL
        if len(card_l) != len(cpu_l) or not np.allclose(card_l, cpu_l,
                                                        rtol=tol, atol=0):
            fail(f"3u-f {name}: card losses {card_l} vs CPU {cpu_l} "
                 f"(rtol {tol})")
        if not card_l[-1] < card_l[0]:
            fail(f"3u-f {name}: the loss did not fall: {card_l}")
        out[name] = {"losses": card_l, "seconds": card_s,
                     "worst_rel": max(abs(a - b) / abs(b)
                                      for a, b in zip(card_l, cpu_l))}
    log(f"[{card}] 3u-f optimize on a {LBFGS_ROWS} x {LBFGS_DIM} logistic "
        "regression on the card: " + "; ".join(
            f"{k} {v['losses'][0]:.4f} -> {v['losses'][-1]:.4f} in "
            f"{len(v['losses'])} losses, {v['seconds']:.3f} s, card vs CPU "
            f"{v['worst_rel']:.3g}" for k, v in out.items()))
    return out


def record_file_mains(device, card):
    """Phase 3u: (a) the seqfile generator and containers; (b) Inception-v1
    trained from record files by ``inception.train_main``, then
    ``test_main``; (c) ``PrefetchToDevice``; (d) the LeNet-5, ResNet-20,
    VggForCifar10 and autoencoder mains; (e) ``perf ingest``; (f)
    ``optimize``.  Files are staged under ``build/`` and removed after.
    Returns (report, launches by path)."""
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_records")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    restore = quiet_step_logs()
    report, paths = {}, {}
    try:
        report["a_generator"] = seqfile_generator(root, card)
        report["b_train_main"], more, folder = record_file_training(
            root, card, device)
        paths.update(more)
        report["c_prefetch"], paths["imagenet_prefetch"] = prefetch_path(
            folder, card, device, report["b_train_main"])
        report["d_mains"], more = other_mains(root, card, device)
        paths.update(more)
        report["e_ingest"] = ingest_harness(card, device, root)
        report["f_optimize"] = optimize_methods(card, device)
    finally:
        restore()
        shutil.rmtree(root, ignore_errors=True)
    return report, paths


# -- phase 3v: the native host helpers and the sharded multi-process feed ----

SHARD_WORKERS = 4
SHARD_STEPS = 30                      # 3 epochs of 3u's 320 records
SHARD_PROFILE_STEPS = 3
SHARD_DET_BATCHES = 4                 # compared at workers 0 and 4
CURVE_WORKERS = (0, 1, 2, 4)
CURVE_RECORDS, CURVE_BLOCK = 640, 16  # bench_ingest's seqfile recipe
KILL_LIMIT_S = 90.0                   # the kill drill ends typed within
DRILL_STEPS = 3
HELPER_REPS = 5
# the figures PERF.md section 5 records for these paths before the native
# helpers (H100 80GB HBM3, 700 W): 3u-b's and 3u-c's step, the inline
# stages (host ms an image) and perf ingest's images/s
EARLIER = {"step_ms": (134.2, 166.9), "prefetch_step_ms": (110.8, 124.1),
        "stages": {"normalize": 1.063, "decode": 0.334, "pack": 0.296,
                   "flip": 0.264, "read": 0.181, "crop": 0.010},
        "perf_ingest": {"w1": (668, 899), "w4": (994, 1235)},
        # 3u-d's mains, ms a step over three earlier runs (numpy's loops)
        "mains_step_ms": {"lenet": (6.2, 7.0), "resnet20": (43.7, 56.0),
                          "vgg_cifar": (32.9, 43.0),
                          "autoencoder": (4.0, 6.1)}}
NORM_MEAN, NORM_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def per_image_ms(fn, images, reps=HELPER_REPS):
    """Host ms an image of ``fn`` over ``images`` (the median of ``reps``
    passes)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for x in images:
            fn(x)
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times) / len(images)


def native_helpers(card, folder):
    """Phase 3v-a: build the host library, hold each helper bit-equal to its
    numpy plain version at the ImageNet path's shapes and at the CIFAR
    mains' 32x32, and time both (the planar-bytes loop beside numpy's
    decode, which ``BytesToBGRImg`` keeps), hold the
    native record scan against the Python reader on the records, and read
    the JPEG fixtures where the library has libjpeg."""
    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.dataset import LocalImgReader
    from bigdl_tpu_torch.dataset import seqfile
    t0 = time.perf_counter()
    path = native.library_path()
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 740)
    # the ImageNet path's 224x224 images and the CIFAR mains' 32x32 ones
    # (under native.MIN_VALUES: the transformers take numpy's loop there)
    sizes = {"": (IMAGE, 256, 341), "_cifar": (32, 32, 32)}
    u8 = [rng.randint(0, 256, (256, 341, 3), dtype=np.uint8)
          for _ in range(8)]
    mean, std = np.float32(NORM_MEAN), np.float32(NORM_STD)
    out = {}
    for tag, (side, rows, cols) in sizes.items():
        imgs = [rng.rand(side, side, 3).astype(np.float32) * 255
                for _ in range(BATCH)]
        raws = [rng.randint(0, 256, 3 * rows * cols, dtype=np.uint8)
                for _ in range(8)]
        if native.pays(imgs[0]) != (tag == ""):
            fail(f"3v-a: native.pays gives {native.pays(imgs[0])} at "
                 f"{side}x{side}")
        batch = [np.empty((BATCH, 3, side, side), np.float32)
                 for _ in (0, 1)]

        def decode_c(b, rows=rows, cols=cols):
            # the library's planar-bytes loop, which BytesToBGRImg does
            # not call: numpy's decode beats it (timed here beside it)
            y = np.empty((rows, cols, 3), np.float32)
            native.lib().bn_bytes_chw_to_hwc(b, 3, rows, cols, 255.0, y)
            return y

        def decode_numpy(b, rows=rows, cols=cols):
            return b.reshape(3, rows, cols).transpose(1, 2, 0).astype(
                np.float32) / 255.0

        cases = {   # name: (native, plain, inputs)
            "normalize": (lambda x: native.normalize(x, mean, std),
                          lambda x: native.normalize_plain(x, mean, std),
                          imgs),
            "hflip": (native.hflip, native.hflip_plain, imgs),
            "bytes_chw_to_hwc": (decode_c, decode_numpy, raws),
            "pack_chw": (lambda ix: native.pack_chw(ix[1], batch[0][ix[0]]),
                         lambda ix: native.pack_chw_plain(ix[1],
                                                          batch[1][ix[0]]),
                         list(enumerate(imgs))),
        }
        if tag == "":
            cases["u8rgb_resize_bgr"] = (
                lambda x: native.u8rgb_resize_bgr(x, 224, 298, 255.0),
                lambda x: native.u8rgb_resize_bgr_plain(x, 224, 298, 255.0),
                u8)
        for name, (fast, plain, xs) in cases.items():
            for x in xs:
                if not np.array_equal(fast(x), plain(x)):
                    fail(f"3v-a: native {name}{tag} differs from its plain "
                         "version")
            if name == "pack_chw" and not np.array_equal(batch[0], batch[1]):
                fail(f"3v-a: native pack_chw{tag} differs from its plain "
                     "version")
            out[name + tag] = {"ms": per_image_ms(fast, xs),
                               "plain_ms": per_image_ms(plain, xs)}
    files = seqfile.seq_file_paths(os.path.join(folder, "train"))
    for f in files:
        fast = list(seqfile.read_seq_file(f))
        if fast != list(seqfile.read_seq_file(f, native=False)) or \
                seqfile.count_records(f) != len(fast):
            fail(f"3v-a: the native scan of {f} differs from the Python "
                 "reader")
    out["read_seq_file"] = {
        "ms": 1e3 * min(timed(lambda: [list(seqfile.read_seq_file(f))
                                       for f in files])
                        for _ in range(3)) / SEQ_TRAIN,
        "plain_ms": 1e3 * min(timed(lambda: [list(seqfile.read_seq_file(
            f, native=False)) for f in files]) for _ in range(3))
        / SEQ_TRAIN}
    jpegs = []
    if native.has_jpeg():
        fixtures = sorted(glob.glob(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests", "data",
            "torch_port", "*.jpg")))
        reader = LocalImgReader(scale_to=128, normalize=255.0)
        for f in fixtures:
            got = list(reader([(f, 1.0)]))[0].data
            if not np.isfinite(got).all() or got.ndim != 3 or \
                    min(got.shape[:2]) != 128:
                fail(f"3v-a: LocalImgReader read {f} as {got.shape}")
            if "png_named" not in f:
                with open(f, "rb") as fh:
                    rgb, (h, w) = native.jpeg_decode(
                        fh.read(), min_short=128, with_orig_dims=True)
                nh, nw = reader._short_edge_dims(h, w, 128)
                if not np.array_equal(got, native.u8rgb_resize_bgr_plain(
                        rgb, nh, nw, 255.0)):
                    fail(f"3v-a: the fused resize of {f} differs from its "
                         "plain version")
            jpegs.append([os.path.basename(f), list(got.shape)])
        if len(jpegs) != 5:
            fail(f"3v-a: {len(jpegs)} JPEG fixtures, want 5")
    report = {"library": str(path), "has_jpeg": native.has_jpeg(),
              "build_s": build_s, "helpers": out, "jpeg_fixtures": jpegs}
    log(f"[{card}] 3v-a native host library {path} (has_jpeg "
        f"{native.has_jpeg()}, built or found in {build_s:.2f} s): every "
        "helper bit-equal to its plain version; host ms an image, native / "
        "numpy: " + json.dumps({k: [round(v["ms"], 4), round(v["plain_ms"],
                                                             4)]
                                for k, v in out.items()})
        + f"; the inline stages before (ms an image): {EARLIER['stages']}; the "
        f"native scan equals the Python reader on {len(files)} files; JPEG "
        f"fixtures read: {jpegs or 'none (no libjpeg)'}")
    return report


def timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def native_branch_figures(card, record_report):
    """Phase 3v-b: 3u-b's and 3u-c's figures, now on the native branches,
    and 3u-d's mains' steps, beside the earlier ones (``EARLIER``)."""
    b, c = record_report["b_train_main"], record_report["c_prefetch"]
    mains = {k: v["step_ms"] for k, v in record_report["d_mains"].items()}
    out = {"d_mains_step_ms": mains,
           "b": {k: b[k] for k in ("step_ms", "train_ms", "images_per_s",
                                    "data_wait_share",
                                    "pipeline_ms_per_image")},
           "c": {k: c[k] for k in ("step_ms", "train_ms", "images_per_s",
                                   "data_wait_share")}}
    out["b"]["busy_share"] = b["profile"]["busy_share"]
    out["earlier"] = EARLIER
    log(f"[{card}] 3v-b on the native branches: 3u-b step "
        f"{b['step_ms']:.2f} ms ({b['images_per_s']:.1f} images/s, "
        f"next(data_iter) {b['data_wait_share']:.3f}, busy "
        f"{b['profile']['busy_share']:.3f}, upload to loss "
        f"{b['train_ms']:.2f} ms) against the earlier {EARLIER['step_ms']} ms; "
        f"3u-c step {c['step_ms']:.2f} ms (next {c['data_wait_share']:.3f}, "
        f"upload to loss {c['train_ms']:.2f}) against the earlier "
        f"{EARLIER['prefetch_step_ms']} ms; stages, host ms an image: "
        + json.dumps({k: round(v, 3) for k, v in
                      b["pipeline_ms_per_image"].items()})
        + f" against the earlier {EARLIER['stages']}; 3u-d's mains, ms a "
        "step: " + json.dumps({k: round(v, 2) for k, v in mains.items()})
        + f" against the earlier {EARLIER['mains_step_ms']}")
    return out


def sharded_set(folder, device, workers, staging=True):
    """3u's training recipe on the sharded feed: the record files, decode
    in the workers, crop, flip and normalize reseeded per chunk, packed in
    the workers, staged to ``device`` in bf16."""
    from bigdl_tpu_torch.dataset import (BGRImgCropper, BGRImgNormalizer,
                                         BGRImgToBatch, HFlip,
                                         ShardedDataSet)
    return ShardedDataSet.from_seq_folder(
        os.path.join(folder, "train"),
        augment=(BGRImgCropper(IMAGE, IMAGE) >> HFlip(0.5)
                 >> BGRImgNormalizer(NORM_MEAN, NORM_STD)),
        batcher=BGRImgToBatch(BATCH), pack_in_workers=True,
        staging=staging, staging_dtype="bf16", device=device,
        workers=workers, seed=SEED + 1)


def recipe_trainer(ds, device, steps):
    """``inception.train_main``'s recipe over ``ds``: Inception-v1 (1000
    classes, seeded), ClassNLL, SGD 0.01 / momentum 0.9 / weight decay
    2e-4 under Poly(0.5) over ``steps``, bf16 mixed precision."""
    from bigdl_tpu_torch.models import Inception_v1
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Poly, Trigger
    opt = LocalOptimizer(Inception_v1(CLASSES).reset(SEED),
                         ClassNLLCriterion(), ds,
                         Trigger.max_iteration(steps), device=device)
    opt.set_optim_method(SGD(learning_rate=0.01, weight_decay=0.0002,
                             momentum=0.9, dampening=0.0,
                             learning_rate_schedule=Poly(0.5, steps)))
    opt.set_mixed_precision(True)
    return opt


def waits_of(ds, keep=0):
    """Times each ``next()`` on ``ds``'s training stream (``.waits``) and
    keeps card copies of its first ``keep`` batches (``.kept``)."""
    data = ds.data
    ds.waits, ds.kept = [], []

    def timed_data(train):
        it = data(train)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            ds.waits.append(time.perf_counter() - t0)
            if b is None:
                return
            if len(ds.kept) < keep:
                ds.kept.append((b.data.clone(), b.labels.clone()))
            yield b
    ds.data = timed_data
    return ds


def sharded_training(card, device, folder):
    """Phase 3v-c: Inception-v1 by ``LocalOptimizer`` over
    ``ShardedDataSet.from_seq_folder(workers=4, staging=True)``, 30 steps;
    its launches, step, images/s, wait share, busy share (3 more steps
    profiled) and the bf16 upload; then the determinism contract on the
    card: the first batches and the first loss at workers 0 and 4."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.core.device import synchronize
    from bigdl_tpu_torch.optim import Trigger
    ds = waits_of(sharded_set(folder, device, SHARD_WORKERS),
                  keep=SHARD_DET_BATCHES)
    opt = recipe_trainer(ds, device, SHARD_STEPS)
    ops.reset_launches()                     # the path starts here
    t0 = time.perf_counter()
    opt.optimize()
    synchronize(device)
    wall = time.perf_counter() - t0
    launches = launches_now()                # and ends here
    expect_launches("3v-c", launches, imagenet_launches(SHARD_STEPS, 0))
    losses = [r["loss"] for r in opt.step_records]
    if len(losses) != SHARD_STEPS or not np.isfinite(losses).all():
        fail(f"3v-c: losses {losses}")
    if ds._pool is not None:
        fail("3v-c: the run left its ingest pool open")
    run = step_report(opt, ds.waits, BATCH)
    stats = dict(ds.stats)
    opt.set_end_when(Trigger.max_iteration(SHARD_STEPS +
                                           SHARD_PROFILE_STEPS))
    prof = device_profile(opt.optimize, SHARD_PROFILE_STEPS)
    prof["busy_share"] = prof["device_ms"] / run["step_ms"]
    kept = ds.kept

    # the determinism contract: workers 0 against workers 4
    ds0 = waits_of(sharded_set(folder, device, 0), keep=SHARD_DET_BATCHES)
    opt0 = recipe_trainer(ds0, device, SHARD_DET_BATCHES)
    opt0.optimize()
    same = len(ds0.kept) == len(kept) == SHARD_DET_BATCHES and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(kept, ds0.kept))
    first0 = opt0.step_records[0]["loss"]
    if not same or first0 != losses[0]:
        fail(f"3v-c: workers 0 and {SHARD_WORKERS} differ (batches equal "
             f"{same}; first losses {first0} / {losses[0]})")
    x = kept[0][0].cpu().pin_memory()
    upload_ms = median_ms(lambda: x.to(device, non_blocking=True), device,
                          reps=UPLOAD_REPS)
    report = {"workers": SHARD_WORKERS, "wall_s": wall, "losses": losses,
              "launches_per_step": {k: v / SHARD_STEPS
                                    for k, v in launches.items() if v},
              "profile": prof, "parent": stats, "upload_bf16_ms": upload_ms,
              "upload_bytes": x.numel() * x.element_size(),
              "determinism": {"batches_equal": SHARD_DET_BATCHES,
                              "first_loss": first0}}
    report.update(run)
    del opt, opt0
    log(f"[{card}] 3v-c Inception-v1 over ShardedDataSet(workers "
        f"{SHARD_WORKERS}, staging bf16), {SHARD_STEPS} steps in "
        f"{wall:.2f} s: step {run['step_ms']:.2f} ms (median after the "
        f"first; first {run['first_step_ms']:.1f} ms; upload to loss "
        f"{run['train_ms']:.2f} ms), {run['images_per_s']:.1f} images/s, "
        f"next(data_iter) {run['data_wait_share']:.3f} of the step, busy "
        f"{prof['busy_share']:.3f} ({prof['device_ms']:.3f} ms of device "
        f"time a step, {prof['htod_ms']:.3f} of it copies to the card); a "
        f"staged bf16 batch's upload {upload_ms:.3f} ms "
        f"({report['upload_bytes'] / 1e6:.1f} MB); launches a step "
        f"{report['launches_per_step']}; the parent packed "
        f"{stats['pack_s']:.3f} s and waited {stats['wait_s']:.3f} s over "
        f"{stats['batches']} batches; the first {SHARD_DET_BATCHES} batches "
        f"and the first loss ({first0:.6f}) equal at workers 0 and "
        f"{SHARD_WORKERS}; against the earlier {EARLIER['step_ms']} ms inline and "
        f"{EARLIER['prefetch_step_ms']} ms with PrefetchToDevice")
    return report, launches


def ingest_curve(card, device, root, perf_ingest):
    """Phase 3v-d: ``bench_ingest``'s curve (the seqfile recipe, staged to
    the card in bf16) at workers 0, 1, 2 and 4, records/s beside the
    host's cores and 3u-e's ``perf ingest``."""
    from bigdl_tpu_torch.dataset import bench_ingest
    items = bench_ingest.write_seq_records(os.path.join(root, "curve"),
                                           CURVE_RECORDS, CURVE_BLOCK,
                                           seed=SEED + 741)
    curve = {}
    for w in CURVE_WORKERS:
        curve[str(w)] = bench_ingest.measure_workers(
            items, w, BATCH, 1, True, None, "bf16", recipe="seqfile",
            device=device)
        if not curve[str(w)] > 0:
            fail(f"3v-d: {curve[str(w)]} records/s at workers {w}")
    report = {"records": CURVE_RECORDS, "files": len(items),
              "host_cores": os.cpu_count(), "records_per_s": curve,
              "perf_ingest": {k: v["images_per_s"]
                              for k, v in perf_ingest.items()}}
    log(f"[{card}] 3v-d bench_ingest seqfile recipe ({CURVE_RECORDS} records "
        f"in {len(items)} files, batch {BATCH}, staged bf16 to the card; "
        f"{os.cpu_count()} host cores): records/s by workers "
        + json.dumps({k: round(v, 1) for k, v in curve.items()})
        + f"; 3u-e perf ingest {report['perf_ingest']} images/s (earlier: "
        f"{EARLIER['perf_ingest']})")
    return report


def fault_drills(card, device, folder):
    """Phase 3v-e: ``ingest.worker.kill`` under 3v-c's trainer must end in
    ``IngestWorkerDied`` within KILL_LIMIT_S; a run of 3u-b's pipeline
    with ``PrefetchToDevice``, armed with ``io.read*1`` and
    ``prefetch.put*1`` (``OSError``), must complete with both retries
    counted."""
    from bigdl_tpu_torch.dataset import IngestWorkerDied
    from bigdl_tpu_torch.dataset.prefetch import PrefetchToDevice
    from bigdl_tpu_torch.models import inception
    from bigdl_tpu_torch.resilience import RETRIES, FaultInjector
    FaultInjector.clear()                   # the parent stays unarmed
    os.environ["BIGDL_TPU_FAULTS"] = "ingest.worker.kill@2"
    ds = sharded_set(folder, device, SHARD_WORKERS)
    opt = recipe_trainer(ds, device, SHARD_STEPS)
    t0 = time.perf_counter()
    died = None
    try:
        opt.optimize()
    except IngestWorkerDied as e:
        died = e
    finally:
        del os.environ["BIGDL_TPU_FAULTS"]
        ds.close(wait=False)
    kill_s = time.perf_counter() - t0
    if died is None or kill_s > KILL_LIMIT_S:
        fail(f"3v-e: the kill drill ended with {died!r} after {kill_s:.1f} "
             f"s (want IngestWorkerDied within {KILL_LIMIT_S} s)")
    steps_before = len(opt.step_records)

    before = dict(RETRIES)
    inj = FaultInjector().add("io.read", count=1, exc=OSError) \
        .add("prefetch.put", count=1, exc=OSError)
    FaultInjector.install(inj)
    try:
        train = inception._imagenet_set(folder, BATCH, True) >> \
            PrefetchToDevice(device=device)
        drill = recipe_trainer(train, device, DRILL_STEPS)
        drill.optimize()
    finally:
        FaultInjector.clear()
    retried = {k: v - before.get(k, 0) for k, v in RETRIES.items()
               if v != before.get(k, 0)}
    losses = [r["loss"] for r in drill.step_records]
    if sorted(inj.fired) != ["io.read", "prefetch.put"] or \
            retried.get("prefetch.device_put") != 1 or \
            sum(v for k, v in retried.items()
                if k.startswith("seqfile open")) != 1 or \
            len(losses) != DRILL_STEPS or not np.isfinite(losses).all():
        fail(f"3v-e: the retry drill fired {inj.fired}, retried {retried}, "
             f"losses {losses}")
    report = {"kill": {"error": type(died).__name__, "seconds": kill_s,
                       "steps_before": steps_before,
                       "limit_s": KILL_LIMIT_S},
              "retry": {"fired": inj.fired, "retried": retried,
                        "losses": losses}}
    log(f"[{card}] 3v-e fault drills: ingest.worker.kill@2 under the "
        f"trainer ended in {type(died).__name__} after {kill_s:.2f} s "
        f"({steps_before} steps trained; limit {KILL_LIMIT_S} s); io.read*1 "
        f"and prefetch.put*1 (OSError) fired, retried {retried}, and the "
        f"run completed its {DRILL_STEPS} steps")
    return report


def sharded_feed(device, card, record_report):
    """Phase 3v: (a) the native helpers; (b) 3u's figures on them; (c) the
    sharded trainer; (d) the ingest curve; (e) the fault drills.  The
    records are written under ``build/``, removed on a failure and kept
    for phase 3w, which removes them.  Returns (report, launches by path,
    the records' folder)."""
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_sharded")
    shutil.rmtree(root, ignore_errors=True)
    folder = os.path.join(root, "imagenet")
    write_records(os.path.join(folder, "train"), SEQ_TRAIN, SEED + 720,
                  SEQ_BLOCK)                 # 3u-b's training records
    restore = quiet_step_logs()
    report = {}
    try:
        report["a_native"] = native_helpers(card, folder)
        report["b_native_branches"] = native_branch_figures(card,
                                                            record_report)
        report["c_sharded"], launches = sharded_training(card, device,
                                                         folder)
        report["d_curve"] = ingest_curve(card, device, root,
                                         record_report["e_ingest"])
        report["e_drills"] = fault_drills(card, device, folder)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    finally:
        restore()
    return report, {"imagenet_sharded": launches}, folder


# -- phase 3w: the run ledger, summaries, watchdog, trace and live metrics ----

OBS_STEPS = 20                   # 3w-a: Inception-v1 steps with the ledger
OBS_VAL_AT = 10                  # its one validation, after this step
OBS_HBM_EVERY = 4                # BIGDL_TPU_HBM_EVERY for the phase
OBS_COST_STEPS = 20              # 3w-b: steps a run, ledger off / on
OBS_WATCHDOG_S, OBS_HANG_S, OBS_HANG_STEP = 2.0, 6.0, 2   # 3w-c
OBS_HANG_LIMIT_S = 10.0          # WatchdogTimeout within this of the hang
OBS_SHARD_WORKERS, OBS_SHARD_STEPS = 2, 6                 # 3w-d
OBS_BENCH_RECORDS = 64           # 3w-d: bench_ingest's attribution pass
OBS_REQUESTS = 64                # 3w-e: InferenceServer requests
OBS_LM_REQUESTS = 8              # 3w-e: ContinuousGenerator requests
OBS_TENANT = "chip-smoke"


def read_tfevents(path):
    """(step, tag, value) of every scalar in a TFRecord-framed tfevents
    file (each frame: length, masked crc, an Event message, masked crc;
    Event field 2 the step, field 5 a Summary whose field 1 holds a
    Value: tag 1, simple_value 2)."""
    import struct

    def fields(buf):
        i = 0
        while i < len(buf):
            key, i = varint(buf, i)
            num, wire = key >> 3, key & 7
            if wire == 0:
                val, i = varint(buf, i)
            elif wire == 1:
                val, i = buf[i:i + 8], i + 8
            elif wire == 5:
                val, i = buf[i:i + 4], i + 4
            else:
                n, i = varint(buf, i)
                val, i = buf[i:i + n], i + n
            yield num, val

    def varint(buf, i):
        out = shift = 0
        while True:
            b = buf[i]
            i += 1
            out |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return out, i

    data = open(path, "rb").read()
    out, off = [], 0
    while off < len(data):
        (n,) = struct.unpack("<Q", data[off:off + 8])
        event = dict(fields(data[off + 12:off + 12 + n]))
        off += 16 + n
        if 5 not in event:
            continue
        value = dict(fields(dict(fields(event[5]))[1]))
        out.append((event.get(2, 0), value[1].decode(),
                    struct.unpack("<f", value[2])[0]))
    return out


def strict_lines(run_dir):
    """Every ledger line of ``run_dir``, parsed as strict JSON (NaN and
    Infinity spellings fail)."""
    recs = []
    for path in sorted(glob.glob(os.path.join(run_dir, "events-*.jsonl"))):
        with open(path) as f:
            for line in f:
                recs.append(json.loads(line, parse_constant=lambda c: fail(
                    f"3w: non-strict JSON constant {c} in {path}")))
    return recs


def obs_cli(what, *argv):
    """``python -m bigdl_tpu_torch.cli <argv>`` in a subprocess from the
    checkout's root; fails unless it exits with 0.  Returns its seconds
    and the last line it printed."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "bigdl_tpu_torch.cli",
                          *argv], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"3w-{what}: cli {argv[0]} exited {res.returncode}: "
             f"{res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    return time.perf_counter() - t0, lines[-1] if lines else ""


class _HangingNLL:
    """ClassNLL that sleeps ``OBS_HANG_S`` in its call at step
    ``OBS_HANG_STEP`` (a hung step for the watchdog)."""

    def __init__(self):
        from bigdl_tpu_torch.nn import ClassNLLCriterion
        self.inner = ClassNLLCriterion()
        self.calls = 0

    def __call__(self, y, labels):
        if self.calls == OBS_HANG_STEP:
            time.sleep(OBS_HANG_S)
        self.calls += 1
        return self.inner(y, labels)


def obs_trainer(card, device, root):
    """3w-a: Inception-v1 (bf16, batch 32) trained OBS_STEPS steps with the
    ledger on, a TrainSummary of every tag every step, a ValidationSummary
    of one validation after step OBS_VAL_AT, ``set_step_timeout(120)``,
    memory samples every OBS_HBM_EVERY steps and the cost record; returns
    (report, launches)."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.core.device import synchronize
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.models import Inception_v1
    from bigdl_tpu_torch.observability import (TrainSummary,
                                               ValidationSummary)
    from bigdl_tpu_torch.observability import ledger as run_ledger
    from bigdl_tpu_torch.observability.report import (build_report,
                                                      load_ledger)
    from bigdl_tpu_torch.optim import Top1Accuracy
    model = Inception_v1(CLASSES, dropout=0.4).reset(SEED)
    opt = make_trainer(model, make_samples(TRAIN_SAMPLES, SEED + 100), BATCH,
                       OBS_STEPS, True, device)
    opt.set_validation(lambda state: state["neval"] == OBS_VAL_AT,
                       DataSet.array(make_samples(VAL_SAMPLES, SEED + 200))
                       >> SampleToBatch(BATCH), [Top1Accuracy()])
    tb = os.path.join(root, "tb")
    ts, vs = TrainSummary(tb, "inception"), ValidationSummary(tb, "inception")
    opt.set_train_summary(ts).set_val_summary(vs).set_step_timeout(120)
    run_dir = os.path.join(root, "a_run")
    run_ledger.set_run_dir(run_dir)
    synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()                 # the path starts here
    t0 = time.perf_counter()
    try:
        opt.optimize()
        synchronize(device)
    finally:
        run_ledger.set_run_dir(None)
    wall = time.perf_counter() - t0
    launches = launches_now()            # and ends here
    peak = torch.cuda.max_memory_allocated(device)
    ts.close()
    vs.close()
    val_fwd = VAL_SAMPLES // BATCH
    expect_launches("3w-a", launches, imagenet_launches(OBS_STEPS, val_fwd))
    recs = strict_lines(run_dir)
    steps = [r for r in recs if r["type"] == "step"]
    losses = [r["loss"] for r in steps]
    if len(steps) != OBS_STEPS or [r["step"] for r in steps] != \
            list(range(OBS_STEPS)) or None in losses:
        fail(f"3w-a: {len(steps)} step records, losses {losses}")
    if losses != [r["loss"] for r in opt.step_records]:
        fail("3w-a: the ledger's losses differ from the trainer's")
    (tf_path,) = glob.glob(os.path.join(tb, "inception", "train",
                                        "events.out.tfevents.*"))
    tf_loss = [(s, v) for s, tag, v in read_tfevents(tf_path)
               if tag == "Loss"]
    want = [(r["step"], float(np.float32(r["loss"]))) for r in steps]
    if tf_loss != want:
        fail(f"3w-a: tfevents Loss scalars {tf_loss} differ from the step "
             f"records' {want}")
    (vf_path,) = glob.glob(os.path.join(tb, "inception", "validation",
                                        "events.out.tfevents.*"))
    val = read_tfevents(vf_path)
    if [s for s, _, _ in val] != [OBS_VAL_AT] or "Top1" not in val[0][1]:
        fail(f"3w-a: validation scalars {val}")
    rep = build_report(load_ledger(run_dir, strict=True)[0])
    params = sum(p.numel() * p.element_size()
                 for p in opt.model.parameters())
    hbm = rep["hbm"] or {}
    if hbm.get("samples") != OBS_STEPS // OBS_HBM_EVERY or \
            not params <= hbm.get("peak_bytes", -1) <= peak:
        fail(f"3w-a: mem.hbm {hbm}: want {OBS_STEPS // OBS_HBM_EVERY} "
             f"samples, a peak between the parameters' {params} B and "
             f"max_memory_allocated {peak} B")
    cost = rep["costs"].get("train.step")
    if not cost or cost["flops"] <= 0:
        fail(f"3w-a: no cost.analysis record of the step: {rep['costs']}")
    if rep["steps"]["count"] != OBS_STEPS or rep["coverage"] is None:
        fail(f"3w-a: report steps {rep['steps']}, coverage "
             f"{rep['coverage']}")
    census = {}
    for r in recs:
        key = r["type"] if r["type"] != "span" else "span " + r["name"]
        census[key] = census.get(key, 0) + 1
    rr_s, rr_last = obs_cli("a", "run-report", run_dir)
    te_s, te_last = obs_cli("a", "trace-export", run_dir)
    report = {"wall_s": wall, "steps": OBS_STEPS,
              "step_ms": 1e3 * statistics.median(
                  r["dur_s"] for r in steps[1:]),
              "first_step_ms": 1e3 * steps[0]["dur_s"],
              "coverage": rep["coverage"],
              "phases_s": {k: v["total_s"]
                           for k, v in rep["phases"].items()},
              "hbm_peak_bytes": hbm["peak_bytes"],
              "max_memory_allocated": peak, "param_bytes": params,
              "cost_flops": cost["flops"], "census": census,
              "run_report_s": rr_s, "trace_export_s": te_s,
              "trace_export": te_last,
              "launches_per_step": {k: v / OBS_STEPS
                                    for k, v in launches.items() if v}}
    log(f"[{card}] 3w-a Inception-v1 (bf16, batch {BATCH}) with the ledger "
        f"on, {OBS_STEPS} steps in {wall:.2f} s: step "
        f"{report['step_ms']:.2f} ms (median after the first; first "
        f"{report['first_step_ms']:.1f} ms, its ATen FLOPs counted: "
        f"{cost['flops'] / 1e12:.3f} TFLOP), coverage "
        f"{rep['coverage']:.3f}, {len(recs)} records {census}; mem.hbm "
        f"peak {hbm['peak_bytes'] / 1e9:.3f} GB (parameters "
        f"{params / 1e6:.1f} MB, max_memory_allocated {peak / 1e9:.3f} "
        f"GB); tfevents Loss = the step records' losses; run-report "
        f"{rr_s:.2f} s and trace-export {te_s:.2f} s in subprocesses "
        f"({te_last}); launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return report, launches, opt


def obs_ledger_cost(card, device, root, opt):
    """3w-b: the ledger's cost a step: OBS_COST_STEPS more steps of 3w-a's
    trainer (no summary, no validation) with the ledger off, on, on, off;
    ms a step (median after each run's first).  Printed, not gated."""
    from bigdl_tpu_torch.observability import ledger as run_ledger
    from bigdl_tpu_torch.optim import Trigger
    opt.set_train_summary(None).set_val_summary(None)
    opt.validation_trigger = None
    runs = []
    for i, on in enumerate((False, True, True, False)):
        done = opt.state["neval"]
        opt.set_end_when(Trigger.max_iteration(done + OBS_COST_STEPS))
        if on:
            run_ledger.set_run_dir(os.path.join(root, f"b_run{i}"))
        try:
            opt.optimize()
        finally:
            run_ledger.set_run_dir(None)
        durs = [r["dur_s"] for r in opt.step_records[done + 1:]]
        runs.append((on, 1e3 * statistics.median(durs)))
    off = [ms for on, ms in runs if not on]
    on_ = [ms for on, ms in runs if on]
    report = {"order": ["off", "on", "on", "off"],
              "step_ms": [ms for _, ms in runs],
              "off_ms": statistics.mean(off), "on_ms": statistics.mean(on_)}
    report["cost_ms"] = report["on_ms"] - report["off_ms"]
    log(f"[{card}] 3w-b the ledger's cost a step (Inception-v1 bf16, batch "
        f"{BATCH}, {OBS_COST_STEPS} steps a run, median after the first): "
        f"off/on/on/off {[round(ms, 3) for _, ms in runs]} ms; on "
        f"{report['on_ms']:.3f} - off {report['off_ms']:.3f} = "
        f"{report['cost_ms']:+.3f} ms a step")
    return report


def obs_watchdog(card, device, root, model):
    """3w-c: ``set_step_timeout(OBS_WATCHDOG_S)`` over a criterion that
    sleeps OBS_HANG_S at step OBS_HANG_STEP: the run ends in
    ``WatchdogTimeout`` within OBS_HANG_LIMIT_S of the hang, with its
    ledger record and a stack dump on stderr.  ``model`` is 3w-a's, warm,
    so no step but the hung one comes near the timeout."""
    import tempfile
    from bigdl_tpu_torch.dataset import DataSet, SampleToBatch
    from bigdl_tpu_torch.observability import ledger as run_ledger
    from bigdl_tpu_torch.optim import LocalOptimizer, Trigger
    from bigdl_tpu_torch.resilience import WatchdogTimeout
    opt = LocalOptimizer(model, _HangingNLL(),
                         DataSet.array(make_samples(BATCH * 4, SEED + 400))
                         >> SampleToBatch(BATCH),
                         Trigger.max_iteration(OBS_HANG_STEP + 2),
                         device=device)
    opt.set_mixed_precision(True).set_step_timeout(OBS_WATCHDOG_S)
    run_dir = os.path.join(root, "c_run")
    run_ledger.set_run_dir(run_dir)
    err = tempfile.TemporaryFile()
    sys.stderr.flush()
    saved = os.dup(2)
    os.dup2(err.fileno(), 2)             # the stack dump goes to fd 2
    raised, hang_t0 = None, None
    try:
        t0 = time.perf_counter()
        try:
            opt.optimize()
        except WatchdogTimeout as e:
            raised = e
        ended = time.perf_counter()
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)
        run_ledger.set_run_dir(None)
    err.seek(0)
    dump = err.read().decode(errors="replace")
    err.close()
    recs = strict_lines(run_dir)
    steps = [r for r in recs if r["type"] == "span"
             and r["name"] == "train.step"]
    fired = [r for r in recs if r.get("kind") == "watchdog.timeout"]
    if raised is None:
        fail("3w-c: the hung step ended without WatchdogTimeout")
    hang_t0 = steps[-1]["mono"] if steps else None
    took = fired[0]["mono"] - hang_t0 if fired and hang_t0 else None
    elapsed = ended - t0
    if len(fired) != 1 or fired[0]["label"] != f"train step {OBS_HANG_STEP}" \
            or fired[0]["timeout_s"] != OBS_WATCHDOG_S:
        fail(f"3w-c: watchdog ledger records {fired}")
    if len(steps) != OBS_HANG_STEP + 1 or not steps[-1].get("error"):
        fail(f"3w-c: train.step spans {steps}")
    hang_s = steps[-1]["dur_s"]
    if hang_s > OBS_HANG_LIMIT_S:
        fail(f"3w-c: the hung step ended after {hang_s:.2f} s (limit "
             f"{OBS_HANG_LIMIT_S} s)")
    if "most recent call first" not in dump or \
            "chip_smoke.py" not in dump:
        fail(f"3w-c: no stack dump on stderr: {dump[-2000:]}")
    sys.stderr.write(dump[-4000:])
    report = {"timeout_s": OBS_WATCHDOG_S, "hang_s": OBS_HANG_S,
              "step_span_s": hang_s, "run_s": elapsed,
              "fired_after_s": took, "error": type(raised).__name__,
              "span_error": steps[-1]["error"],
              "stack_dump_lines": len(dump.splitlines())}
    log(f"[{card}] 3w-c watchdog: set_step_timeout({OBS_WATCHDOG_S:g}) over "
        f"a criterion sleeping {OBS_HANG_S:g} s at step {OBS_HANG_STEP}: "
        f"{type(raised).__name__} after the step's {hang_s:.2f} s (limit "
        f"{OBS_HANG_LIMIT_S:g} s; the record {took:.2f} s into it), span "
        f"error {steps[-1]['error']}, the stack dump "
        f"{report['stack_dump_lines']} lines on stderr")
    return report


def obs_trace(card, device, folder, root):
    """3w-d: 3v's records through ``ShardedDataSet(workers=2)`` for
    OBS_SHARD_STEPS steps with the ledger on, then ``trace-export``: the
    trace's span rows cover the trainer and every worker pid the pool's own
    census shows served a chunk, every worker's chunk span links back to
    the trainer, the report names a bound stage; then ``bench_ingest
    --run-dir`` and its attribution pass.  Returns (report, launches)."""
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.core.device import synchronize
    from bigdl_tpu_torch.dataset import bench_ingest
    from bigdl_tpu_torch.observability import ledger as run_ledger
    from bigdl_tpu_torch.observability.report import (build_report,
                                                      load_ledger)
    run_dir = os.path.join(root, "d_run")
    # host batches: the trainer's thread pulls the pool under data.next, so
    # every chunk links back to the span that asked for it (a staging
    # ring's stager thread would pull it outside any span)
    ds = sharded_set(folder, device, OBS_SHARD_WORKERS, staging=False)
    opt = recipe_trainer(ds, device, OBS_SHARD_STEPS)
    run_ledger.set_run_dir(run_dir)
    ops.reset_launches()                 # the path starts here
    t0 = time.perf_counter()
    try:
        opt.optimize()
        synchronize(device)
    finally:
        run_ledger.set_run_dir(None)
    wall = time.perf_counter() - t0
    launches = launches_now()            # and ends here
    expect_launches("3w-d", launches, imagenet_launches(OBS_SHARD_STEPS, 0))
    me = os.getpid()
    served = {p for p, n in ds.stats["chunks_by_pid"].items() if n}
    records, _ = load_ledger(run_dir, strict=True)
    spans = {(r["_pid"], r["span"]): r for r in records
             if r["type"] == "span"}
    chunk_spans = [r for r in records if r["type"] == "span"
                   and r["_pid"] != me and "parent" not in r]
    unlinked = [r for r in chunk_spans if r.get("link_pid") != me
                or (me, r.get("link")) not in spans]
    if not served or me in served or unlinked or not chunk_spans:
        fail(f"3w-d: served pids {served}, {len(chunk_spans)} worker chunk "
             f"spans, unlinked {unlinked[:3]}")
    out = os.path.join(run_dir, "trace.json")
    te_s, te_last = obs_cli("d", "trace-export", run_dir, "--out", out)
    payload = json.load(open(out))
    span_pids = {e["pid"] for e in payload["traceEvents"]
                 if e.get("ph") == "X"}
    st = payload["otherData"]["stitch"]
    if not {me} | served <= span_pids or \
            st["resolved_edges"] != st["link_edges"] or \
            len(payload["otherData"]["trace_ids"]) != 1:
        fail(f"3w-d: trace span pids {span_pids} (trainer {me}, served "
             f"{served}), stitch {st}")
    rep = build_report(records)
    ingest = rep["ingest"] or {}
    if ingest.get("bound_stage") not in (ingest.get("stages") or {}):
        fail(f"3w-d: the report names no bound stage: {ingest}")
    bench_dir = os.path.join(root, "d_bench")
    t1 = time.perf_counter()
    art = bench_ingest.main(["--recipe", "seqfile", "--workers-list", "0",
                             "--records", str(OBS_BENCH_RECORDS),
                             "--batch-size", str(BATCH), "--chunk", "16",
                             "--run-dir", bench_dir,
                             "--device", device.type])
    bench_s = time.perf_counter() - t1
    stages = set(art["stage_attribution"])
    if art["bound_stage"] not in stages or not {
            "ingest.decode", "ingest.augment", "ingest.pack",
            "ingest.stage", "ingest.h2d"} <= stages:
        fail(f"3w-d: bench_ingest's attribution {art['stage_attribution']}"
             f", bound {art['bound_stage']}")
    report = {"wall_s": wall, "served_chunks_by_pid": {
        str(p): n for p, n in ds.stats["chunks_by_pid"].items()},
        "stitch": st, "trace_events": len(payload["traceEvents"]),
        "trace_export_s": te_s, "bound_stage": ingest["bound_stage"],
        "stages": {k: v["capacity_records_per_s"]
                   for k, v in ingest["stages"].items()},
        "step_ms": 1e3 * statistics.median(
            r["dur_s"] for r in opt.step_records[1:]),
        "first_step_ms": 1e3 * opt.step_records[0]["dur_s"],
        "bench_ingest": {"s": bench_s,
                         "imgs_per_s": art["worker_scaling_imgs_per_sec"],
                         "bound_stage": art["bound_stage"],
                         "stages": art["stage_attribution"]}}
    log(f"[{card}] 3w-d ShardedDataSet(workers {OBS_SHARD_WORKERS}) with the "
        f"ledger on, {OBS_SHARD_STEPS} steps in {wall:.2f} s (the first "
        f"{report['first_step_ms']:.0f} ms, the pool's start in it; then "
        f"{report['step_ms']:.1f} ms a step): chunks by pid "
        f"{report['served_chunks_by_pid']}, {len(chunk_spans)} worker chunk "
        f"spans all linked; trace-export {te_s:.2f} s, "
        f"{len(payload['traceEvents'])} events, stitch {st}; bound stage "
        f"{ingest['bound_stage']} of {report['stages']} records/s; "
        f"bench_ingest --run-dir ({OBS_BENCH_RECORDS} records, workers 0) "
        f"{bench_s:.2f} s: bound {art['bound_stage']}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return report, launches


def obs_serving(card, device, root, lm_run):
    """3w-e: Inception-v1 (f32, K1 and K2) behind ``InferenceServer(
    metrics_port=0)`` for OBS_REQUESTS requests, the scraped ``/metrics``
    counter and the report's count both OBS_REQUESTS; then 3g's bf16 LM
    behind ``ContinuousGenerator(ledger_tags=, budgeter=)`` for
    OBS_LM_REQUESTS requests on K12: every record tagged, the memory
    census an exact replay of the budgeter's own.  Returns (report,
    server launches, generator launches)."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.api import DLClassifier
    from bigdl_tpu_torch.observability import live
    from bigdl_tpu_torch.observability import ledger as run_ledger
    from bigdl_tpu_torch.observability.report import (build_report,
                                                      load_ledger)
    from bigdl_tpu_torch.serving import ContinuousGenerator, InferenceServer
    from bigdl_tpu_torch.serving.scheduler.membudget import MemoryBudgeter
    run_dir = os.path.join(root, "e_run")
    run_ledger.set_run_dir(run_dir)
    try:
        clf = DLClassifier(build_model(), (BATCH, 3, IMAGE, IMAGE),
                           device=device)
        server = InferenceServer(clf, batch_buckets=BUCKETS, metrics_port=0,
                                 device=device)
        try:
            ops.reset_launches()         # the server's path starts here
            t0 = time.perf_counter()
            preds = server.predict(make_rows(OBS_REQUESTS, SEED + 500))
            wall = time.perf_counter() - t0
            launches = launches_now()    # and ends here
            stats = server.stats()
            scraped = live.scrape(server.metrics_url)
        finally:
            if not server.drain(timeout=120):
                fail("3w-e: the server did not drain")
        forwards = sum(v["batches"] for v in stats["buckets"].values())
        expect_launches("3w-e server", launches, {
            "max_pool2d": 13 * forwards, "cross_map_lrn": 2 * forwards})
        line = f"bigdl_tpu_serve_completed_total {float(OBS_REQUESTS)}"
        if scraped is None or line not in scraped.splitlines() or \
                len(preds) != OBS_REQUESTS:
            fail(f"3w-e: /metrics lacks {line!r}: {scraped}")

        model, prompts, budgets, kw = lm_run
        bud = MemoryBudgeter()
        gen = ContinuousGenerator(model, cache_dtype=torch.bfloat16,
                                  budgeter=bud,
                                  ledger_tags={"tenant": OBS_TENANT}, **kw)
        ops.reset_launches()             # the generator's path starts here
        run = drive_continuous(gen, prompts[:OBS_LM_REQUESTS],
                               budgets[:OBS_LM_REQUESTS])
        gen.drain()
        glaunches = launches_now()       # and ends here
        gst = gen.stats()
        snap = bud.snapshot()["tenants"][OBS_TENANT]
        run_ledger.flush()
    finally:
        run_ledger.set_run_dir(None)
    prefills = gst["counters"]["serve.gen.prefills"]
    steps = gst["counters"]["serve.gen.steps"]
    expect_launches("3w-e generator", glaunches,
                    {"paged_attention": LM_LAYERS * (prefills + steps)})
    for out, n in zip(run["outputs"], budgets):
        if out.shape != (n,) or out.min() < 1 or out.max() > LM_VOCAB:
            fail(f"3w-e: generator ids {out.shape} for max_new {n}")
    records, _ = load_ledger(run_dir, strict=True)
    rep = build_report(records)
    if rep["serving"]["requests"].get("ok") != OBS_REQUESTS + \
            OBS_LM_REQUESTS:
        fail(f"3w-e: the report's requests {rep['serving']['requests']}, "
             f"want {OBS_REQUESTS} + {OBS_LM_REQUESTS} ok")
    gen_kinds = ("serve.slots", "serve.pages", "serve.cache", "mem.budget")
    untagged = [r for r in records if r["type"] in gen_kinds
                and r.get("tenant") != OBS_TENANT]
    served = [r for r in records if r["type"] == "serve.request"]
    if untagged or sum(r.get("tenant") == OBS_TENANT
                       for r in served) != OBS_LM_REQUESTS:
        fail(f"3w-e: {len(untagged)} generator records without the tenant "
             f"tag, {len(served)} serve.request records")
    mem = (rep["memory"] or {}).get("tenants", {}).get(OBS_TENANT)
    if not mem or any(mem["charged"].get(c, 0) != v
                      for c, v in snap["charged"].items()) or \
            snap["charged"]["kv_pages"] != 0:
        fail(f"3w-e: the memory census {mem} is no replay of the "
             f"budgeter's {snap}")
    report = {"requests": OBS_REQUESTS, "wall_s": wall,
              "forwards": forwards, "metrics_line": line,
              "lm_requests": OBS_LM_REQUESTS, "lm": {
                  k: run[k] for k in ("wall_s", "new_tokens_per_s",
                                      "latency_p50_ms", "latency_max_ms")},
              "memory_census": mem, "prefills": prefills,
              "decode_steps": steps, "records": len(records)}
    log(f"[{card}] 3w-e InferenceServer (f32, buckets {BUCKETS}, "
        f"metrics_port=0): {OBS_REQUESTS} requests in {wall:.2f} s over "
        f"{forwards} forwards, /metrics '{line}'; ContinuousGenerator "
        f"(bf16, ledger_tags tenant {OBS_TENANT!r}, a MemoryBudgeter): "
        f"{OBS_LM_REQUESTS} requests, {prefills} prefills and {steps} decode "
        f"steps, {run['new_tokens_per_s']:.1f} new tokens/s; report "
        f"requests {rep['serving']['requests']}; memory census "
        f"{mem['charged']} equal to the budgeter's; launches "
        f"{ {k: v for k, v in launches.items() if v} } and "
        f"{ {k: v for k, v in glaunches.items() if v} }")
    return report, launches, glaunches


def observability(device, card, folder, lm_run):
    """Phase 3w: (a) the ledger over Inception-v1 training; (b) its cost a
    step; (c) the step watchdog; (d) the trace across processes on 3v's
    records (removed after) and ``bench_ingest --run-dir``; (e) serving
    with live /metrics, and the continuous LM with ledger tags.  The
    ledger is on only inside each part, under ``build/``.  Returns
    (report, image-path launches, LM launches)."""
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_obs")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    saved = {k: os.environ.get(k) for k in ("BIGDL_TPU_HBM_EVERY",
                                            "BIGDL_TPU_COSTS")}
    os.environ["BIGDL_TPU_HBM_EVERY"] = str(OBS_HBM_EVERY)
    os.environ.pop("BIGDL_TPU_COSTS", None)
    restore = quiet_step_logs()
    report = {}
    try:
        report["a_trainer"], la, opt = obs_trainer(card, device, root)
        report["b_ledger_cost"] = obs_ledger_cost(card, device, root, opt)
        report["c_watchdog"] = obs_watchdog(card, device, root, opt.model)
        del opt
        report["d_trace"], ld = obs_trace(card, device, folder, root)
        report["e_serving"], le, lg = obs_serving(card, device, root, lm_run)
    finally:
        restore()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(os.path.dirname(folder), ignore_errors=True)
    return report, {"observability_train": la,
                    "observability_sharded": ld,
                    "observability_serve": le}, {"observability_lm": lg}


# -- phase 3x: the trainer's and serving's fault sites, drill and benches -----

FAULT_RESUME_STEPS, FAULT_PREEMPT_AT = 4, 2      # 3x-a: train.step@2 of 4
FAULT_RESUME_ATOL = 1e-5     # resumed vs uninterrupted weights, max |dw|
FAULT_LOSS_RTOL = 1e-5       # and their losses at the resumed steps
FAULT_THRESHOLD = 2          # 3x-b: the breaker's threshold
FAULT_ROWS = 32              # 3x-b: rows a phase


def fault_trainer(card, device, root):
    """3x-a: Inception-v1 (f32, batch 32) under the trainer's sites: a
    one-step run with ``grad.nan@0`` keeps every weight bit for bit, sets
    ``skippedSteps`` to 1 and still launches 13/13/2/2; a 3-step run with
    ``grad.nan@1`` trains steps 0 and 2; ``train.step@2`` with File
    snapshots every step and ``auto_resume`` raises ``InjectedFault`` after
    step 2's snapshot, the relaunch in this process resumes at ``neval`` 2
    and ends at 4 within FAULT_RESUME_ATOL of an uninterrupted 4-step run.
    Returns (report, launches)."""
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.models import Inception_v1
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.resilience import FaultInjector, InjectedFault
    samples = make_samples(2 * BATCH, SEED + 700)

    def trainer(steps):
        model = Inception_v1(CLASSES, dropout=0.4).reset(SEED)
        return make_trainer(model, samples, BATCH, steps, False, device)

    def weights(opt):
        # host copies: the model moves to the card inside optimize()
        return [p.detach().to("cpu", copy=True)
                for p in opt.model.param_leaves()]

    launches = {}
    t0 = time.perf_counter()
    # (i) the poisoned step alone
    opt = trainer(1)
    before = weights(opt)
    FaultInjector.install(FaultInjector().add("grad.nan", step=0))
    ops.reset_launches()                 # the poisoned step starts here
    try:
        opt.optimize()
    finally:
        FaultInjector.clear()
    launches["nan"] = launches_now()     # and ends here
    expect_launches("3x-a poisoned step", launches["nan"],
                    imagenet_launches(1, 0))
    same = all(torch.equal(a, b) for a, b in zip(before, weights(opt)))
    if not same or opt.state.get("skippedSteps") != 1 or \
            not math.isnan(opt.step_records[0]["loss"]):
        fail(f"3x-a: grad.nan@0 left weights bit-unchanged {same}, "
             f"skippedSteps {opt.state.get('skippedSteps')}, loss "
             f"{opt.step_records[0]['loss']}")
    # (ii) a poisoned step between two healthy ones
    opt = trainer(3)
    before = weights(opt)
    FaultInjector.install(FaultInjector().add("grad.nan", step=1))
    ops.reset_launches()
    try:
        opt.optimize()
    finally:
        FaultInjector.clear()
    launches["nan_mid"] = launches_now()
    expect_launches("3x-a grad.nan@1", launches["nan_mid"],
                    imagenet_launches(3, 0))
    losses_mid = [r["loss"] for r in opt.step_records]
    moved = any(not torch.equal(a, b) for a, b in zip(before, weights(opt)))
    if opt.state.get("skippedSteps") != 1 or not moved or \
            not (math.isfinite(losses_mid[0]) and math.isnan(losses_mid[1])
                 and math.isfinite(losses_mid[2])):
        fail(f"3x-a: grad.nan@1 losses {losses_mid}, skippedSteps "
             f"{opt.state.get('skippedSteps')}, weights moved {moved}")
    # (iii) a preemption after step 2's snapshot, and the relaunch
    path = os.path.join(root, "a_snapshots")
    opt = trainer(FAULT_RESUME_STEPS)
    opt.set_checkpoint(path, Trigger.several_iteration(1), auto_resume=True)
    FaultInjector.install(FaultInjector().add("train.step",
                                              step=FAULT_PREEMPT_AT))
    ops.reset_launches()
    try:
        opt.optimize()
        fail("3x-a: train.step@2 did not raise")
    except InjectedFault:
        pass
    finally:
        FaultInjector.clear()
    launches["preempted"] = launches_now()
    expect_launches("3x-a preempted run", launches["preempted"],
                    imagenet_launches(FAULT_PREEMPT_AT, 0))
    if opt.state["neval"] != FAULT_PREEMPT_AT or sorted(os.listdir(path)) != \
            ["model.1", "model.2", "state.1", "state.2"]:
        fail(f"3x-a: preempted at neval {opt.state['neval']}, snapshots "
             f"{sorted(os.listdir(path))}")
    resumed = trainer(FAULT_RESUME_STEPS)
    resumed.set_checkpoint(path, Trigger.several_iteration(1),
                           auto_resume=True)
    ops.reset_launches()
    resumed.optimize()
    launches["resumed"] = launches_now()
    expect_launches("3x-a resumed run", launches["resumed"],
                    imagenet_launches(FAULT_RESUME_STEPS - FAULT_PREEMPT_AT,
                                      0))
    steps_run = [r["step"] for r in resumed.step_records]
    if steps_run != list(range(FAULT_PREEMPT_AT, FAULT_RESUME_STEPS)) or \
            resumed.state["neval"] != FAULT_RESUME_STEPS:
        fail(f"3x-a: the relaunch ran steps {steps_run}, ended at neval "
             f"{resumed.state['neval']}")
    whole = trainer(FAULT_RESUME_STEPS)
    ops.reset_launches()
    whole.optimize()
    launches["uninterrupted"] = launches_now()
    dw = max((a - b).abs().max().item()
             for a, b in zip(weights(resumed), weights(whole)))
    bit_equal = all(torch.equal(a, b)
                    for a, b in zip(weights(resumed), weights(whole)))
    la = [r["loss"] for r in resumed.step_records]
    lb = [r["loss"] for r in whole.step_records][FAULT_PREEMPT_AT:]
    if dw > FAULT_RESUME_ATOL or not np.allclose(la, lb,
                                                 rtol=FAULT_LOSS_RTOL,
                                                 atol=0.0):
        fail(f"3x-a: resumed vs uninterrupted max |dw| {dw} (limit "
             f"{FAULT_RESUME_ATOL}), losses {la} vs {lb}")
    wall = time.perf_counter() - t0
    log(f"[{card}] 3x-a trainer sites (Inception-v1 f32, batch {BATCH}): "
        f"grad.nan@0 alone: weights bit-unchanged, skippedSteps 1, launches "
        f"{ {k: v for k, v in launches['nan'].items() if v} }; grad.nan@1 "
        f"of 3: losses {losses_mid}; train.step@{FAULT_PREEMPT_AT} of "
        f"{FAULT_RESUME_STEPS} with snapshots every step: InjectedFault at "
        f"neval {FAULT_PREEMPT_AT}, the relaunch ran steps {steps_run}; "
        f"resumed vs uninterrupted: max |dw| {dw:.3g} (limit "
        f"{FAULT_RESUME_ATOL}), bit-equal {bit_equal}, losses {la} vs {lb}; "
        f"{wall:.1f} s")
    return {"losses_nan_mid": losses_mid, "resumed_losses": la,
            "uninterrupted_losses": lb, "max_abs_dw": dw,
            "bit_equal": bit_equal, "wall_s": wall}, launches


def settle(server, timeout=10.0):
    """Wait until no pool worker has a batch in flight (a worker drops its
    count after the futures resolve; the least-loaded tie-break needs it)."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if all(w["pending"] == 0
               for w in server.stats()["workers"].values()):
            return
        time.sleep(0.001)
    fail("3x-b: a pool worker kept a batch in flight")


def fault_serving(card, device, root):
    """3x-b: Inception-v1 (f32) behind ``InferenceServer(num_workers=2,
    forward_retries=2)`` with the bucket ladder: ``serve.forward*2=OSError``
    retried away (two ``retry`` events, the unfaulted answers);
    ``serve.worker0.forward`` armed FAULT_THRESHOLD times opens worker 0's
    breaker while worker 1 answers every later request as the unfaulted
    forward; ``serve.pack`` fails one batch with ``PackFailedError`` and
    leaves every breaker as it was; drain loses no accepted request; 13 K1
    + 2 K2 a forward that ran.  Returns (report, launches)."""
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.api import DLClassifier
    from bigdl_tpu_torch.observability import ledger as run_ledger
    from bigdl_tpu_torch.observability.report import load_ledger
    from bigdl_tpu_torch.resilience import FaultInjector
    from bigdl_tpu_torch.serving import (ForwardFailedError, InferenceServer,
                                         PackFailedError)
    rows = make_rows(3 * FAULT_ROWS, SEED + 800)
    clf = DLClassifier(build_model(), (BATCH, 3, IMAGE, IMAGE), device=device)
    want = [int(v) for v in clf.predict(rows)]      # the unfaulted answers
    run_dir = os.path.join(root, "b_run")
    run_ledger.set_run_dir(run_dir)
    accepted = []
    t0 = time.perf_counter()
    try:
        # a wave of 8 forms one batch within max_delay_s
        server = InferenceServer(clf, num_workers=2, forward_retries=2,
                                 retry_backoff_s=0.001, max_delay_s=0.05,
                                 batch_buckets=BUCKETS,
                                 breaker_threshold=FAULT_THRESHOLD,
                                 breaker_reset_s=600.0, device=device)
        try:
            ops.reset_launches()         # the server's path starts here
            FaultInjector.install(FaultInjector.from_env(
                "serve.forward*2=OSError"))
            futs = [server.submit(r) for r in rows[:FAULT_ROWS]]
            accepted += futs
            got_retry = [f.result(timeout=120) for f in futs]
            fired_retry = list(FaultInjector.active().fired)
            settle(server)
            FaultInjector.install(FaultInjector().add(
                "serve.worker0.forward", count=FAULT_THRESHOLD))
            failed = 0
            for i in range(FAULT_THRESHOLD):     # one wave a batch, to w0
                futs = [server.submit(r) for r in rows[8 * i:8 * i + 8]]
                accepted += futs
                failed += sum(isinstance(f.exception(timeout=120),
                                         ForwardFailedError) for f in futs)
                settle(server)
            st = server.stats()["workers"]
            breakers = (st[0]["breaker"], st[1]["breaker"])
            later = rows[FAULT_ROWS:2 * FAULT_ROWS]
            futs = [server.submit(r) for r in later]
            accepted += futs
            got_w1 = [f.result(timeout=120) for f in futs]
            settle(server)
            FaultInjector.install(FaultInjector().add("serve.pack", count=1))
            futs = [server.submit(r) for r in rows[2 * FAULT_ROWS:
                                                   2 * FAULT_ROWS + 8]]
            accepted += futs
            packed = sum(isinstance(f.exception(timeout=120),
                                    PackFailedError) for f in futs)
            settle(server)
            FaultInjector.clear()
            tail = rows[2 * FAULT_ROWS + 8:]
            futs = [server.submit(r) for r in tail]
            accepted += futs
            got_tail = [f.result(timeout=120) for f in futs]
            st_after = server.stats()
        finally:
            FaultInjector.clear()
            drained = server.drain(timeout=120)
        launches = launches_now()        # and ends here
        run_ledger.flush()
    finally:
        run_ledger.set_run_dir(None)
    wall = time.perf_counter() - t0
    records, _ = load_ledger(run_dir, strict=True)
    retries = [r for r in records if r.get("kind") == "retry"]
    if got_retry != want[:FAULT_ROWS] or len(retries) != 2 or \
            fired_retry != ["serve.forward"] * 2 or \
            any(r["label"] != "serve.forward" for r in retries):
        fail(f"3x-b: serve.forward*2=OSError: answers equal "
             f"{got_retry == want[:FAULT_ROWS]}, fired {fired_retry}, "
             f"retry events {retries}")
    if failed != 8 * FAULT_THRESHOLD or breakers != ("open", "closed") or \
            got_w1 != want[FAULT_ROWS:2 * FAULT_ROWS]:
        fail(f"3x-b: worker 0 faulted {failed} requests, breakers "
             f"{breakers}, worker 1's answers equal "
             f"{got_w1 == want[FAULT_ROWS:2 * FAULT_ROWS]}")
    workers_after = st_after["workers"]
    if packed != 8 or (workers_after[0]["breaker"],
                       workers_after[1]["breaker"]) != ("open", "closed") \
            or got_tail != want[2 * FAULT_ROWS + 8:]:
        fail(f"3x-b: serve.pack failed {packed} of 8, breakers "
             f"{workers_after}, tail answers equal "
             f"{got_tail == want[2 * FAULT_ROWS + 8:]}")
    if not drained or not all(f.done() for f in accepted):
        fail(f"3x-b: drain {drained}, "
             f"{sum(not f.done() for f in accepted)} requests lost")
    forwards = sum(v["batches"] for v in st_after["buckets"].values())
    expect_launches("3x-b server", launches, {
        "max_pool2d": 13 * forwards, "cross_map_lrn": 2 * forwards})
    report = {"requests": len(accepted), "forwards": forwards,
              "retry_events": len(retries), "worker0_failed": failed,
              "pack_failed": packed, "wall_s": wall,
              "worker_batches": {w: v["batches"]
                                 for w, v in workers_after.items()}}
    log(f"[{card}] 3x-b InferenceServer (Inception-v1 f32, 2 workers, "
        f"forward_retries 2, buckets {BUCKETS}): serve.forward*2=OSError "
        f"retried away ({len(retries)} retry events, {FAULT_ROWS} answers "
        f"equal to the unfaulted forward); serve.worker0.forward x"
        f"{FAULT_THRESHOLD}: {failed} requests failed typed, breakers "
        f"{breakers}, worker 1 answered {len(later)} later requests "
        f"equal; serve.pack: {packed} of 8 PackFailedError, breakers "
        f"unchanged; drain lost 0 of {len(accepted)}; {forwards} forwards, "
        f"launches { {k: v for k, v in launches.items() if v} }, worker "
        f"batches {report['worker_batches']}; {wall:.1f} s")
    return report, launches


def drill_census(rep):
    """The serving and fleet census of ``tests/test_serving.py``'s drill
    test; returns the checks that failed."""
    s = rep["serving"] or {}
    fl = (rep.get("fleet") or {}).get("tenants", {})
    req, shed = s.get("requests", {}), s.get("shed", {})
    br, ws = s.get("breaker", {}), s.get("workers", {})
    checks = {
        "ok": req.get("ok", 0) > 0,
        "forward_failed": req.get("forward_failed", 0) > 0,
        "pack_failed": req.get("pack_failed", 0) > 0,
        "expired": req.get("expired", 0) > 0,
        "shed breaker_open": shed.get("breaker_open", 0) > 0,
        "shed deadline_unmeetable": shed.get("deadline_unmeetable", 0) > 0,
        "closed->open 2": br.get("closed->open") == 2,
        "open->half_open 1": br.get("open->half_open") == 1,
        "half_open->closed 1": br.get("half_open->closed") == 1,
        "batches": s.get("batches", {}).get("count", 0) > 0,
        "latency": s.get("latency", {}).get("p50_s", 0) > 0,
        "workers 0, 1": {0, 1} <= set(ws),
        "worker 0 failed": ws.get(0, {}).get("failed", 0) > 0,
        "worker 1 clean": ws.get(1, {}).get("failed", 1) == 0
        and ws.get(1, {}).get("ok", 0) > 0,
        "two buckets": len(s.get("buckets", {})) == 2,
        "fleet tenants": {"flood", "steady"} <= set(fl),
        "flood queue_full": fl.get("flood", {}).get("sheds", {}).get(
            "queue_full", 0) > 0,
        "steady unshed": not fl.get("steady", {"sheds": 1})["sheds"],
        "steady ok": fl.get("steady", {}).get("requests", {}).get("ok", 0)
        > 0,
        "fleet reaps": (rep.get("fleet") or {}).get("reaps", 0) >= 1,
    }
    return [k for k, ok in checks.items() if not ok]


def fault_drill(card, root):
    """3x-c: ``cli serve-drill`` at its defaults (phases 1-12, on the card)
    exits 0, and ``run-report`` on its run directory gives the serving and
    fleet census of ``tests/test_serving.py``'s drill test.  Returns
    (report, launches)."""
    import io
    from contextlib import redirect_stdout
    from bigdl_tpu_torch import cli, ops
    from bigdl_tpu_torch.observability import ledger as run_ledger
    from bigdl_tpu_torch.observability.report import (build_report,
                                                      load_ledger)
    run_dir = os.path.join(root, "c_drill")
    out = io.StringIO()
    t0 = time.perf_counter()
    ops.reset_launches()                 # the drill's path starts here
    try:
        with redirect_stdout(out):
            rc = cli.main(["serve-drill", "--run-dir", run_dir])
    finally:
        run_ledger.set_run_dir(None)
    launches = launches_now()            # and ends here
    wall = time.perf_counter() - t0
    text = out.getvalue()
    if rc != 0:
        fail(f"3x-c: serve-drill exited {rc}: {text[-3000:]}")
    records, bad = load_ledger(run_dir, strict=True)
    rep = build_report(records)
    missing = drill_census(rep)
    if bad or missing or launches["paged_attention"] == 0:
        fail(f"3x-c: run-report census misses {missing} ({bad} bad lines), "
             f"K12 launches {launches['paged_attention']}")
    checks = sum(line.startswith("  [ok]") for line in text.splitlines())
    s = rep["serving"]
    log(f"[{card}] 3x-c serve-drill (phases 1-12 on the card): exit 0, "
        f"{checks} checks ok in {wall:.1f} s; run-report requests "
        f"{s['requests']}, sheds {s['shed']}, breaker {s['breaker']}, "
        f"workers {s['workers']}; phase 11's launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return {"checks_ok": checks, "wall_s": wall,
            "requests": s["requests"], "shed": s["shed"],
            "breaker": s["breaker"]}, launches


def fault_bench_serve(card, root):
    """3x-d: ``cli bench-serve`` at its defaults (48 requests up to 48 new
    tokens, the reference's full run) with ``--out`` under ``build/``: every
    ablation's outputs equal the row-slot run's (the bench raises
    otherwise), the live scrape answered.  Logs each mode's tokens/s and
    p95, the prefix hit rate, the draft's accept rate and each mode's K12
    and K13 launches.  Returns (report, launches)."""
    import io
    from contextlib import redirect_stdout
    from bigdl_tpu_torch import cli, ops
    path = os.path.join(root, "d_serve.json")
    out = io.StringIO()
    t0 = time.perf_counter()
    ops.reset_launches()                 # the bench's path starts here
    with redirect_stdout(out):
        rc = cli.main(["bench-serve", "--out", path])
    launches = launches_now()            # and ends here
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"3x-d: bench-serve exited {rc}: {out.getvalue()[-3000:]}")
    with open(path) as f:
        rep = json.load(f)
    modes = dict(rep["modes"], **rep["ablations"])
    if not rep["acceptance"]["outputs_bit_equal_across_variants"] or \
            launches["paged_attention"] == 0 or launches["w8_matmul"] == 0:
        fail(f"3x-d: acceptance {rep['acceptance']}, launches {launches}")
    per_mode = {name: {k: m["kernel_launches"].get(k, 0)
                       for k in ("paged_attention", "w8_matmul",
                                 "attention_fwd")}
                for name, m in modes.items()}
    acc = rep["acceptance"]
    log(f"[{card}] 3x-d bench-serve (defaults: {rep['meta']['requests']} "
        f"requests, prompt {rep['meta']['prompt_len']}, "
        f"{rep['modes']['static']['useful_tokens']} useful tokens, "
        f"{rep['meta']['model']}): every ablation equal to row-slot; "
        + "; ".join(f"{n} {m['tokens_per_s']:.1f} tok/s p95 "
                    f"{m['latency_p95_s'] * 1e3:.1f} ms launches "
                    f"{per_mode[n]}" for n, m in modes.items())
        + f"; prefix hit rate {acc['prefix_hit_rate']:.3f}, draft accept "
        f"rate {acc['draft_accept_rate']:.3f}, best {acc['best_ablation']} "
        f"{acc['best_vs_row_slot_tokens_per_s']:.3f}x row-slot; "
        f"{wall:.1f} s")
    return {"modes": {n: {k: m[k] for k in ("tokens_per_s", "latency_p95_s",
                                            "kernel_launches")}
                      for n, m in modes.items()},
            "acceptance": acc, "wall_s": wall}, launches


def fault_bench_infer(card):
    """3x-e: ``cli bench-infer`` without ``--smoke`` (tlm-2L128d,
    tlm-8L512d at vocab 32000, embed 512, 8 layers, seq 512, batch 8, and
    LeNet-5 at batch 512): the accuracy gate passes (exit 0); logs int8
    tokens/s and images/s beside bf16, the resident-bytes ratio, the
    quality deltas and the launches of one int8 forward (K8 and K13).
    Returns (report, launches)."""
    import io
    from contextlib import redirect_stdout
    from bigdl_tpu_torch import cli, ops
    out = io.StringIO()
    t0 = time.perf_counter()
    ops.reset_launches()                 # the bench's path starts here
    with redirect_stdout(out):
        rc = cli.main(["bench-infer"])
    launches = launches_now()            # and ends here
    wall = time.perf_counter() - t0
    text = out.getvalue()
    if rc != 0:
        fail(f"3x-e: bench-infer exited {rc}: {text[-3000:]}")
    rows = [json.loads(line) for line in text.splitlines()
            if line.startswith('{"config"')]
    lm = {r["config"]: r for r in rows if "int8_tokens_per_sec" in r}
    img = [r for r in rows if "int8_imgs_per_sec" in r]
    big = lm.get("tlm-8L512d", {}).get("int8_kernel_launches", {})
    if set(lm) != {"tlm-2L128d", "tlm-8L512d"} or len(img) != 1 or \
            big.get("attention_fwd") != 8 or not big.get("w8_matmul") or \
            not img[0]["int8_kernel_launches"].get("w8_matmul"):
        fail(f"3x-e: rows {list(lm)} + {len(img)} image, tlm-8L512d int8 "
             f"launches {big}")
    for r in rows:
        rate = "tokens_per_sec" if "int8_tokens_per_sec" in r else \
            "imgs_per_sec"
        log(f"[{card}] 3x-e bench-infer {r['config']}: int8 "
            f"{r['int8_' + rate]} vs bf16 {r['bf16_' + rate]} "
            f"{rate.replace('_per_sec', '/s')} ({r['speedup_int8_vs_bf16']}x)"
            f", resident {r['resident_param_bytes']['ratio_int8_vs_bf16']} of "
            f"bf16, quality {r['quality_vs_bf16']}, one int8 forward's "
            f"launches {r['int8_kernel_launches']}")
    log(f"[{card}] 3x-e bench-infer: gate passed, {wall:.1f} s")
    return {"rows": rows, "wall_s": wall}, launches


def faults_and_benches(device, card):
    """Phase 3x: (a) the trainer's sites; (b) serving's sites; (c)
    ``serve-drill``; (d) ``bench-serve``; (e) ``bench-infer``.  Files go
    under ``build/``, removed after.  Returns (report, image-path
    launches, LM launches)."""
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_faults")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    restore = quiet_step_logs()
    report = {}
    t0 = time.perf_counter()
    try:
        report["a_trainer"], la = fault_trainer(card, device, root)
        report["b_serving"], lb = fault_serving(card, device, root)
        report["c_drill"], lc = fault_drill(card, root)
        report["d_bench_serve"], ld = fault_bench_serve(card, root)
        report["e_bench_infer"], le = fault_bench_infer(card)
    finally:
        restore()
        shutil.rmtree(root, ignore_errors=True)
    report["wall_s"] = time.perf_counter() - t0
    image = {f"faults_train_{k}": v for k, v in la.items()}
    image["faults_serve"] = lb
    return report, image, {"faults_drill": lc, "faults_bench_serve": ld,
                           "faults_bench_infer": le}


# -- phase 3y: the multi-tenant serving fleet ---------------------------------

# three tenants behind one FleetServer: Inception-v1 f32 ("vision", 1-3
# workers), its w8 copy in f32 activations ("vision-w8", one worker) and
# 3g's LM under w8a8 ("chat", its own generator), on FLEET_ROWS distinct
# images and FLEET_CHAT distinct prompts (plus FLEET_CAL to calibrate on)
FLEET_ROWS, FLEET_CHAT, FLEET_CAL = 64, 16, 4
FLEET_CHAT_LEN, FLEET_CHAT_NEW = (64, 448), (16, 24, 32)
FLEET_DDL_S = 2.0            # the classify tenants' interactive deadline
FLEET_SLO = 0.9              # their SLO target, and chat's ok share in 3y-c
FLEET_QUEUE = 128            # vision's queue: the flood sheds past it
FLEET_FLOOD_X, FLEET_FLOOD_S = 3.0, 2.0   # 3y-c: vision's flood over one
FLEET_W8_WAVES = 20          # worker's rows/s; vision-w8's waves of 8 beside
FLEET_BURST_X = 4.0          # 3y-d: the burst over one worker's rows/s
FLEET_BURST_S = 1.5
FLEET_SETTLE_S = 20.0        # the longest wait for vision to shrink to 1
FLEET_AUTOSCALE = dict(interval_s=0.05, burn_hi=1.0, burn_lo=0.2,
                       backlog_hi=1.5, backlog_lo=0.5, grow_after=2,
                       shrink_after=6, cooldown_s=0.3)
# each forward's launches: Inception-v1 f32 13 K1 + 2 K2; its w8 copy the
# same and 56 K13; the w8a8 LM 48 K14 + 1 K13 (the head) + 8 K12 a prefill
# and a decode step (phase 3p's LM_RUNG_LAUNCHES)
FLEET_PER = {"vision": {"max_pool2d": 13, "cross_map_lrn": 2},
             "vision-w8": {"max_pool2d": 13, "cross_map_lrn": 2,
                           "w8_matmul": 56},
             "chat": dict(LM_RUNG_LAUNCHES["w8a8"], paged_attention=8)}


def fleet_chat_traffic():
    """FLEET_CHAT distinct prompts with their budgets, and FLEET_CAL
    calibration prompts of CG_BUCKETS[0] tokens."""
    rng = np.random.RandomState(SEED + 900)
    prompts = [rng.randint(1, LM_VOCAB + 1,
                           rng.randint(*FLEET_CHAT_LEN)).astype(np.int32)
               for _ in range(FLEET_CHAT)]
    budgets = [int(rng.choice(FLEET_CHAT_NEW)) for _ in prompts]
    cal = [p.astype(np.int32) for p in
           lm_ids((FLEET_CAL, CG_BUCKETS[0]), SEED + 901)]
    return prompts, budgets, cal


def fleet_outcomes(futs, timeout=300.0):
    """{"ok" or the exception's type name: count}; a future still pending
    after ``timeout`` counts as "Pending" (a lost request)."""
    from concurrent.futures import TimeoutError as FutureTimeout
    out = {}
    end = time.monotonic() + timeout
    for f in futs:
        try:
            exc = f.exception(timeout=max(0.0, end - time.monotonic()))
            key = "ok" if exc is None else type(exc).__name__
        except FutureTimeout:
            key = "Pending"
        out[key] = out.get(key, 0) + 1
    return out


def fleet_timed(fut, t0, into):
    """Stamp ``fut``'s resolution, seconds after ``t0``, into ``into``."""
    fut.add_done_callback(lambda _f: into.append(time.monotonic() - t0))
    return fut


def fleet_references(device, clfs, lm, prompts, budgets, cal, rows):
    """The single-tenant answers: an ``InferenceServer`` of each classifier
    over ``rows`` and a ``ContinuousGenerator`` of the same rung and
    calibration over every chat prompt."""
    from bigdl_tpu_torch.serving import ContinuousGenerator, InferenceServer
    want = {}
    for name, clf in clfs.items():
        with InferenceServer(clf, batch_buckets=BUCKETS,
                             device=device) as single:
            want[name] = [f.result(timeout=300)
                          for f in [single.submit(r) for r in rows]]
    with ContinuousGenerator(lm, quantize="w8a8", calibration_prompts=cal,
                             num_slots=CG_SLOTS, page_size=CG_PAGE,
                             seq_buckets=CG_BUCKETS, device=device) as gen:
        futs = [gen.submit(p, n) for p, n in zip(prompts, budgets)]
        want["chat"] = [f.result(timeout=600).tolist() for f in futs]
    return want


def fleet_specs(clfs, lm, cal, name=None):
    """The three tenants' specs (only ``name``'s when given); ``vision-w8``
    builds its classifier from ``vision``'s model, packed by the fleet."""
    from bigdl_tpu_torch.serving.fleet import TenantSpec
    ddl = {"interactive": FLEET_DDL_S, "batch": None}
    specs = {
        "vision": TenantSpec(
            "vision", classifier=clfs["vision"], weight=3,
            batch_buckets=BUCKETS, priority_classes=("interactive", "batch"),
            deadline_classes=ddl, slo_target=FLEET_SLO, slo_window=512,
            min_workers=1, max_workers=3, queue_capacity=FLEET_QUEUE),
        "vision-w8": TenantSpec(
            "vision-w8", model=clfs["vision"].model,
            batch_shape=(BATCH, 3, IMAGE, IMAGE), quantize="w8", weight=1,
            batch_buckets=BUCKETS, priority_classes=("interactive",
                                                     "batch"),
            deadline_classes=ddl, slo_target=FLEET_SLO, min_workers=1,
            max_workers=1,
            queue_capacity=4 * FLEET_ROWS),
        "chat": TenantSpec(
            "chat", model=lm, kind="generate", quantize="w8a8",
            calibration_prompts=cal,
            generator_kwargs=dict(num_slots=CG_SLOTS, page_size=CG_PAGE,
                                  seq_buckets=CG_BUCKETS)),
    }
    return specs[name] if name else list(specs.values())


def fleet_tenant_line(wall, futs_done):
    """rows (or requests) a second over ``wall``, p50 and max latency."""
    lat = sorted(futs_done)
    n = len(lat)
    return {"requests": n, "per_s": n / wall if wall > 0 else 0.0,
            "p50_ms": 1e3 * lat[(n - 1) // 2] if n else 0.0,
            "max_ms": 1e3 * lat[-1] if n else 0.0}


def fleet_serving(device, card):
    """Phase 3y: (a) one ``FleetServer`` with a ``MemoryBudgeter`` serves
    ``vision``, ``vision-w8`` and ``chat``: every answer equal to a
    single-tenant server's, each tenant's ``params`` charge equal to its
    tree's bytes; (b) ``vision-w8`` deregistered under traffic with zero
    lost, a submit then raises ``UnknownTenantError``, registered again it
    answers equal and its charge returns; (c) ``vision`` flooded past its
    queue while one of its workers (with a batch waiting in its inbox) is
    killed: every shed ``QueueFullError`` on ``vision``, ``chat`` and
    ``vision-w8`` shed nothing and keep their SLO, the worker reaped and
    its batches salvaged, every answer equal, none lost or answered twice;
    (d) a ``vision`` burst at FLEET_BURST_X times one worker's rows/s grows
    its allocation; (e) ``serve-drill`` (phases 1-12), ``serve-drill
    --fleet-smoke`` and ``bench-serve --fleet`` exit 0 in subprocesses.
    Launches exact over (a)-(d): FLEET_PER a forward, a prefill or a
    step.  Files go under ``build/``, removed after.  Returns (report,
    launches)."""
    import shutil
    import threading
    import torch
    from bigdl_tpu_torch import ops
    from bigdl_tpu_torch.api import DLClassifier
    from bigdl_tpu_torch.observability import ledger as run_ledger
    from bigdl_tpu_torch.observability.report import (build_report,
                                                      load_ledger)
    from bigdl_tpu_torch.ops.quant import param_bytes_by_dtype
    from bigdl_tpu_torch.serving import (MemoryBudgeter, QueueFullError,
                                         ShedError, UnknownTenantError)
    from bigdl_tpu_torch.serving.fleet import FleetServer
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke_fleet")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cuda = device.type == "cuda"
    rows = make_rows(FLEET_ROWS, SEED + 910)
    prompts, budgets, cal = fleet_chat_traffic()
    model = build_model()
    clfs = {"vision": DLClassifier(model, (BATCH, 3, IMAGE, IMAGE),
                                   device=device),
            "vision-w8": DLClassifier(model, (BATCH, 3, IMAGE, IMAGE),
                                      quantize="w8", device=device)}
    lm = lm_model()
    report = {}
    t_phase = time.perf_counter()
    want = fleet_references(device, clfs, lm, prompts, budgets, cal, rows)
    report["references_s"] = time.perf_counter() - t_phase
    # every classifier forward from here on, the fleet's warmups included,
    # counted by tenant: the packed copy's are vision-w8's
    forwards = {name: 0 for name in clfs}
    count_lock = threading.Lock()
    real_run = DLClassifier._run

    def counted(self, x):
        with count_lock:
            forwards["vision" if self.qmodel is None else "vision-w8"] += 1
        return real_run(self, x)
    DLClassifier._run = counted
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    budgeter = MemoryBudgeter()
    run_ledger.set_run_dir(os.path.join(root, "abc_run"))
    fleet = None
    try:
        t0 = time.perf_counter()
        fleet = FleetServer(fleet_specs(clfs, lm, cal), max_workers=5,
                            autoscale=True,
                            autoscaler_kwargs=FLEET_AUTOSCALE,
                            budgeter=budgeter, device=device)
        report["build_s"] = time.perf_counter() - t0
        chat = fleet.registry.get("chat").generator
        chat0 = dict(chat.stats()["counters"])
        ops.reset_launches()             # the fleet's path starts here
        forwards.update({name: 0 for name in clfs})
        # -- (a) the three tenants at once
        trees = {"vision": clfs["vision"].model,
                 "vision-w8": fleet.registry.get("vision-w8").classifier.qmodel,
                 "chat": chat.model}
        params = {n: budgeter.charged(n, "params") for n in trees}
        tree_bytes = {n: int(sum(param_bytes_by_dtype(m).values()))
                      for n, m in trees.items()}
        if params != tree_bytes:
            fail(f"3y-a: params charged {params}, the trees hold "
                 f"{tree_bytes}")
        done = {n: [] for n in ("vision", "vision-w8", "chat")}
        n_ok = {n: 0 for n in done}      # answered ok, for the census
        t0 = time.monotonic()
        cls = dict(priority_class="interactive", deadline_class="interactive")
        fa = {n: [fleet_timed(fleet.submit(n, r, **cls), t0, done[n])
                  for r in rows] for n in clfs}
        fa["chat"] = [fleet_timed(fleet.submit("chat", p, max_new=b), t0,
                                  done["chat"])
                      for p, b in zip(prompts[:8], budgets[:8])]
        # -- (b) vision-w8 out and back in while the others run
        charged_w8 = {c: budgeter.charged("vision-w8", c)
                      for c in ("params", "rung_executables")}
        drained = fleet.deregister("vision-w8", timeout=300)
        w8_a = [f.result(timeout=0) for f in fa["vision-w8"]]
        try:
            fleet.submit("vision-w8", rows[0], **cls)
            unknown = None
        except UnknownTenantError as e:
            unknown = type(e).__name__
        got = {n: [f.result(timeout=300) for f in fa[n]]
               for n in ("vision", "chat")}
        wall_a = time.monotonic() - t0
        got["chat"] = [o.tolist() for o in got["chat"]]
        a_lines = {n: fleet_tenant_line(wall_a, done[n]) for n in done}
        fleet.register(fleet_specs(clfs, lm, cal, "vision-w8"))
        charged_again = {c: budgeter.charged("vision-w8", c)
                         for c in ("params", "rung_executables")}
        w8_b = [f.result(timeout=300) for f in
                [fleet.submit("vision-w8", r, **cls) for r in rows]]
        if got["vision"] != want["vision"] or w8_a != want["vision-w8"] or \
                got["chat"] != want["chat"][:8]:
            fail(f"3y-a: answers equal to the single-tenant servers: vision "
                 f"{got['vision'] == want['vision']}, vision-w8 "
                 f"{w8_a == want['vision-w8']}, chat "
                 f"{got['chat'] == want['chat'][:8]}")
        if not drained or unknown != "UnknownTenantError" or \
                w8_b != want["vision-w8"] or charged_again != charged_w8:
            fail(f"3y-b: deregister drained {drained}, a later submit "
                 f"raised {unknown}, answers after re-registering equal "
                 f"{w8_b == want['vision-w8']}, charge {charged_w8} -> "
                 f"{charged_again}")
        n_ok["vision"] += len(rows)
        n_ok["vision-w8"] += 2 * len(rows)
        n_ok["chat"] += 8
        one_worker = BATCH / fleet.registry.get("vision").runner.floor_s(
            BATCH)
        # the device's busy share over one more mixed wave, profiled
        busy = None
        if cuda:
            t0 = time.monotonic()
            prof = {}

            def wave():
                fs = [fleet.submit(n, r, **cls) for r in rows for n in clfs]
                fs += [fleet.submit("chat", p, max_new=b) for p, b in
                       zip(prompts[12:], budgets[12:])]
                outs = [f.result(timeout=300) for f in fs]
                prof["wall"] = time.monotonic() - t0
                return outs
            kernels = _profiled(wave)
            busy = sum(us for us, _ in kernels.values()) / 1e6 / prof["wall"]
            n_ok = {n: v + (len(rows) if n != "chat" else 4)
                    for n, v in n_ok.items()}
        # -- (c) the flood and the kill
        vision = fleet.registry.get("vision")
        flood_futs, flood_sheds, killed = [], {}, {}
        flood_rate = FLEET_FLOOD_X * one_worker

        def kill_busy():
            # a worker with a batch waiting in its inbox behind the one it
            # runs, once the autoscaler gave vision a second worker
            with fleet._pool_lock:
                busy_w = [w for w in vision.workers if w.pending >= 2]
            if len(vision.workers) >= 2 and busy_w:
                killed["wid"] = busy_w[0].wid
                busy_w[0].kill()

        def flood():
            t_start, carry, i = time.monotonic(), 0.0, 0
            while time.monotonic() - t_start < FLEET_FLOOD_S:
                t_tick = time.monotonic()
                carry += flood_rate * 0.02
                for _ in range(int(carry)):
                    if not killed and \
                            t_tick - t_start > FLEET_FLOOD_S / 4:
                        kill_busy()
                    try:
                        flood_futs.append((i % FLEET_ROWS, fleet.submit(
                            "vision", rows[i % FLEET_ROWS], **cls)))
                    except ShedError as e:
                        k = type(e).__name__
                        flood_sheds[k] = flood_sheds.get(k, 0) + 1
                    i += 1
                carry -= int(carry)
                time.sleep(max(0.0, 0.02 - (time.monotonic() - t_tick)))
        th = threading.Thread(target=flood)
        t0 = time.monotonic()
        th.start()
        chat_c = [(i, fleet.submit("chat", prompts[i], max_new=budgets[i]))
                  for i in range(8, 12)]
        w8_c, w8_sheds = [], 0
        for k in range(FLEET_W8_WAVES):
            for j in range(8):
                i = (8 * k + j) % FLEET_ROWS
                try:
                    w8_c.append((i, fleet.submit("vision-w8", rows[i],
                                                 **cls)))
                except ShedError:
                    w8_sheds += 1
            time.sleep(FLEET_FLOOD_S / FLEET_W8_WAVES)
        th.join()
        oc = {n: fleet_outcomes([f for _, f in fs]) for n, fs in
              (("vision", flood_futs), ("vision-w8", w8_c),
               ("chat", chat_c))}
        wall_c = time.monotonic() - t0
        wrong = sum(f.result() != want["vision"][i] for i, f in flood_futs
                    if f.exception() is None)
        wrong += sum(f.result() != want["vision-w8"][i] for i, f in w8_c
                     if f.exception() is None)
        wrong += sum(f.result().tolist() != want["chat"][i]
                     for i, f in chat_c if f.exception() is None)
        end = time.monotonic() + 10.0
        while time.monotonic() < end and \
                not fleet.metrics.snapshot()[0].get("fleet.reaped", (0,))[0]:
            time.sleep(0.01)
        local = fleet.metrics.snapshot()[0]
        reaped = int(local.get("fleet.reaped", (0,))[0])
        salvaged = int(local.get("fleet.salvaged", (0,))[0])
        vc = fleet.stats()["tenants"]["vision"]["counters"]
        w8_hit = oc["vision-w8"].get("ok", 0) / max(1, len(w8_c))
        chat_ok = oc["chat"].get("ok", 0) / max(1, len(chat_c))
        if set(flood_sheds) != {"QueueFullError"} or \
                int(vc.get("serve.shed.queue_full", 0)) != \
                flood_sheds["QueueFullError"] or w8_sheds or \
                w8_hit < FLEET_SLO or chat_ok < FLEET_SLO or \
                "wid" not in killed or reaped < 1 or salvaged < 1 or wrong \
                or set(oc["vision"]) - {"ok", "DeadlineExceededError"} or \
                int(vc.get("serve.cancelled", 0)) or \
                int(vc.get("serve.completed", 0)) != \
                n_ok["vision"] + oc["vision"].get("ok", 0):
            fail(f"3y-c: flood sheds {flood_sheds} (vision's counter "
                 f"{vc.get('serve.shed.queue_full')}), outcomes {oc}, "
                 f"vision-w8 sheds {w8_sheds}, hit rates {w8_hit} / "
                 f"{chat_ok}, killed {killed}, reaped {reaped}, salvaged "
                 f"{salvaged}, wrong answers {wrong}, vision counters {vc}")
        for n in n_ok:
            n_ok[n] += oc[n].get("ok", 0)
        c_report = {"flood": len(flood_futs), "sheds": flood_sheds,
                    "flood_rows_per_s": flood_rate,
                    "outcomes": oc, "killed": killed["wid"],
                    "reaped": reaped, "salvaged": salvaged,
                    "vision_w8_hit_rate": w8_hit, "chat_ok_share": chat_ok,
                    "wall_s": wall_c}
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 \
            if cuda else None
        run_ledger.flush()
        # -- (d) the autoscaler under a burst
        run_ledger.set_run_dir(os.path.join(root, "d_run"))
        t_settle = time.monotonic()
        while len(vision.workers) > 1 and \
                time.monotonic() - t_settle < FLEET_SETTLE_S:
            time.sleep(0.05)
        settle_s = time.monotonic() - t_settle
        # past the last shrink's cooldown, so the burst meets a scaler
        # free to act
        time.sleep(FLEET_AUTOSCALE["cooldown_s"]
                   + 2 * FLEET_AUTOSCALE["interval_s"])
        start_alloc = len(vision.workers)
        ups = []
        real_up = fleet.scale_up

        def scale_up(t, reason="", **info):
            # recorded when asked for: the worker's warmup can end after
            # the burst
            up = {"tenant": t.name, "t0": time.monotonic(), "ok": None}
            ups.append(up)
            up["ok"] = real_up(t, reason, **info)
            return up["ok"]
        fleet.scale_up = scale_up
        rate = FLEET_BURST_X * one_worker
        ws0 = fleet.worker_seconds()
        burst_futs, burst_sheds, carry, i = [], 0, 0.0, 0
        t0 = time.monotonic()
        peak_alloc = start_alloc
        while time.monotonic() - t0 < FLEET_BURST_S:
            t_tick = time.monotonic()
            carry += rate * 0.02
            for _ in range(int(carry)):
                try:
                    burst_futs.append(fleet.submit(
                        "vision", rows[i % FLEET_ROWS], **cls))
                except ShedError:
                    burst_sheds += 1
                i += 1
            carry -= int(carry)
            peak_alloc = max(peak_alloc, len(vision.workers))
            time.sleep(max(0.0, 0.02 - (time.monotonic() - t_tick)))
        t_burst = time.monotonic()
        end = t_burst + 30.0
        while any(u["ok"] is None for u in ups) and time.monotonic() < end:
            time.sleep(0.01)
        grows = [u for u in ups if u["tenant"] == "vision" and u["ok"]
                 and t0 <= u["t0"] <= t_burst]
        d_oc = fleet_outcomes(burst_futs)
        t_shrink = time.monotonic()
        while len(vision.workers) > 1 and \
                time.monotonic() - t_shrink < FLEET_SETTLE_S:
            time.sleep(0.05)
        shrink_s = time.monotonic() - t_shrink
        ws = fleet.worker_seconds() - ws0
        if not grows:
            fail(f"3y-d: no grow of vision during a {FLEET_BURST_S} s burst "
                 f"at {rate:.0f} rows/s ({FLEET_BURST_X}x one worker's "
                 f"{one_worker:.0f}); allocation {start_alloc} at its start")
        chat_n = {k: chat.stats()["counters"].get(k, 0) - chat0.get(k, 0)
                  for k in ("serve.gen.prefills", "serve.gen.steps")}
        drained_all = fleet.drain(timeout=300)
        fleet = None
        launches = launches_now()            # and ends here
        run_ledger.flush()
    finally:
        if fleet is not None:
            fleet.drain(timeout=60)
        run_ledger.set_run_dir(None)
        DLClassifier._run = real_run
    lm_steps = chat_n["serve.gen.prefills"] + chat_n["serve.gen.steps"]
    want_l = {}
    for name, n in (("vision", forwards["vision"]),
                    ("vision-w8", forwards["vision-w8"]),
                    ("chat", lm_steps)):
        for k, v in FLEET_PER[name].items():
            want_l[k] = want_l.get(k, 0) + v * n
    expect_launches("3y fleet", launches, want_l)
    if not drained_all:
        fail("3y: the fleet's drain did not join")
    # the run report's census of (a)-(c) against the futures
    records, bad = load_ledger(os.path.join(root, "abc_run"), strict=True)
    census = build_report(records)["fleet"]["tenants"]
    d_records, _ = load_ledger(os.path.join(root, "d_run"), strict=True)
    scale_events = [{k: r.get(k) for k in ("tenant", "direction", "workers",
                                           "reason", "prewarm_s")}
                    for r in d_records if r.get("kind") == "fleet.scale"]
    got_census = {n: census.get(n, {}).get("requests", {}).get("ok", 0)
                  for n in n_ok}
    if bad or got_census != n_ok or census["vision"]["sheds"] != \
            {"queue_full": flood_sheds["QueueFullError"]} or \
            census["vision-w8"]["sheds"] != {"unknown_tenant": 1} or \
            census["chat"]["sheds"] or \
            census["vision"]["reaped"] < 1 or \
            census["vision-w8"]["registered"] != 2:
        fail(f"3y-f: run-report census {census} ({bad} bad lines), ok by "
             f"tenant from the futures {n_ok}")
    report.update(a={"lines": a_lines, "wall_s": wall_a,
                     "params_charged": params, "busy_share": busy,
                     "one_worker_rows_per_s": one_worker},
                  b={"drained": drained, "unknown": unknown,
                     "charge": charged_again},
                  c=c_report,
                  d={"rate": rate, "start_workers": start_alloc,
                     "peak_workers": peak_alloc, "grows": len(grows),
                     "outcomes": d_oc, "sheds": burst_sheds,
                     "settle_s": settle_s, "shrink_s": shrink_s,
                     "worker_seconds": ws, "scale_events": scale_events},
                  census={n: {k: census[n][k] for k in (
                      "requests", "sheds", "dispatches", "scale_up",
                      "scale_down", "reaped", "registered",
                      "deregistered")} for n in census},
                  forwards=dict(forwards), lm_prefills_and_steps=lm_steps,
                  peak_allocated_gib=peak)
    for n, ln in a_lines.items():
        log(f"[{card}] 3y-a {n}: {ln['requests']} "
            f"{'requests' if n == 'chat' else 'rows'} in {wall_a:.2f} s "
            f"({ln['per_s']:.1f}/s), latency p50 {ln['p50_ms']:.1f} ms, max "
            f"{ln['max_ms']:.1f} ms")
    log(f"[{card}] 3y-a answers equal to single-tenant servers ({FLEET_ROWS} "
        f"rows x 2 classifiers, {FLEET_CHAT} chat prompts); params charged "
        f"{params} = the trees' bytes; one vision worker "
        f"{one_worker:.1f} rows/s (bucket {BATCH}); device busy share "
        f"{busy if busy is None else round(busy, 4)} over a profiled mixed "
        f"wave; peak allocated {peak if peak is None else round(peak, 2)} "
        "GiB")
    log(f"[{card}] 3y-b vision-w8 deregistered under traffic (drained "
        f"{drained}, 0 lost), then {unknown}; registered again: answers "
        f"equal, charge {charged_w8} -> {charged_again}")
    log(f"[{card}] 3y-c flood of {len(flood_futs) + sum(flood_sheds.values())}"
        f" vision rows at {flood_rate:.0f}/s over {FLEET_FLOOD_S} s: sheds "
        f"{flood_sheds}, worker {killed['wid']} killed with a batch waiting, "
        f"reaped {reaped}, salvaged {salvaged} batch(es); outcomes {oc}; "
        f"vision-w8 hit rate {w8_hit:.3f}, chat ok {chat_ok:.3f} (SLO "
        f"{FLEET_SLO}); {wall_c:.2f} s")
    log(f"[{card}] 3y-d burst {rate:.0f} rows/s ({FLEET_BURST_X}x one "
        f"worker) for {FLEET_BURST_S} s from {start_alloc} worker(s) "
        f"(settled in {settle_s:.2f} s): {len(grows)} grow(s), peak "
        f"{peak_alloc}, outcomes {d_oc}, {burst_sheds} sheds; back to 1 in "
        f"{shrink_s:.2f} s; {ws:.2f} worker-seconds; fleet.scale events "
        + json.dumps(scale_events))
    log(f"[{card}] 3y-f run-report census (a)-(c): " + json.dumps(
        report["census"]))
    log(f"[{card}] 3y launches { {k: v for k, v in launches.items() if v} } "
        f"for forwards "
        f"{forwards} and {lm_steps} chat prefills and steps")
    report["e"] = fleet_cli(card, root, device)
    shutil.rmtree(root, ignore_errors=True)
    report["wall_s"] = time.perf_counter() - t_phase
    return report, launches


def fleet_cli(card, root, device):
    """3y-e: ``cli serve-drill`` at its defaults (phases 1-12) with a run
    directory, ``cli serve-drill --fleet-smoke`` and ``cli bench-serve
    --fleet --out`` at its full-run defaults, each in a subprocess that
    must exit 0.  The two drills run at once (their forwards are sleeps
    around small models); the bench, whose gates are timed, runs alone
    after them.  The drill's census carries ``flood`` and ``steady``, its
    queue_full sheds on ``flood`` only and a reap."""
    from bigdl_tpu_torch.observability.report import (build_report,
                                                      load_ledger)
    here = os.path.dirname(os.path.abspath(__file__))
    run_dir = os.path.join(root, "e_drill")
    out = os.path.join(root, "e_fleet.json")
    report = {}

    def run_at_once(jobs):
        procs = {}
        for key, args in jobs:
            if device.type != "cuda":        # the cli defaults to the card
                args = args + ["--device", device.type]
            log_path = os.path.join(root, f"e_{key}.log")
            with open(log_path, "w") as f:
                procs[key] = (args, log_path, time.perf_counter(),
                              subprocess.Popen(
                                  [sys.executable, "-m",
                                   "bigdl_tpu_torch.cli"] + args,
                                  cwd=here, stdout=f,
                                  stderr=subprocess.STDOUT, text=True))
        ended = {}
        end = time.perf_counter() + 600
        while len(ended) < len(procs) and time.perf_counter() < end:
            for key, (_, _, _, proc) in procs.items():
                if key not in ended and proc.poll() is not None:
                    ended[key] = time.perf_counter()
            time.sleep(0.1)
        for key, (args, log_path, t0, proc) in procs.items():
            if key not in ended:
                proc.kill()
            rc = proc.wait()
            with open(log_path) as f:
                text = f.read()
            report[key] = {"rc": rc, "wall_s": ended.get(key, end) - t0,
                           "checks_ok": sum(line.startswith("  [ok]")
                                            for line in text.splitlines())}
            if rc != 0:
                for p in procs.values():
                    if p[3].poll() is None:
                        p[3].kill()
                fail(f"3y-e: cli {' '.join(args)} exited {rc}: "
                     f"{text[-4000:]}")

    run_at_once([("drill", ["serve-drill", "--run-dir", run_dir]),
                 ("fleet_smoke", ["serve-drill", "--fleet-smoke"])])
    run_at_once([("bench_fleet", ["bench-serve", "--fleet", "--out", out])])
    records, bad = load_ledger(run_dir, strict=True)
    fleet = build_report(records)["fleet"] or {"tenants": {}}
    t = fleet["tenants"]
    if bad or not {"flood", "steady"} <= set(t) or \
            not t["flood"]["sheds"].get("queue_full", 0) or \
            t["steady"]["sheds"] or not t["steady"]["requests"].get("ok") or \
            fleet.get("reaps", 0) < 1:
        fail(f"3y-e: serve-drill's fleet census {fleet}")
    with open(out) as f:
        bench = json.load(f)
    acc = bench["acceptance"]
    slo = bench["meta"]["slo_target"]
    # each timed gate's margin: the bound less the reading (ratio) or the
    # reading less the bound (hit rates, with the misses out of the count)
    victim = bench["noisy_neighbor"]["victim"]
    margins = {"worker_seconds_ratio": 0.8 - acc["worker_seconds_ratio"],
               "victim_hit_rate": (acc["victim_hit_rate"] - slo,
                                   victim["expired"] + victim["failed"],
                                   victim["ok"] + victim["expired"]
                                   + victim["failed"]),
               **{f"hit_rate.{n}": (r["hit_rate"] - slo,
                                    r["requests"] - r["ok"], r["requests"])
                  for n, r in bench["autoscaled"]["tenants"].items()}}
    report["drill_census"] = {n: {"requests": t[n]["requests"],
                                  "sheds": t[n]["sheds"]} for n in t}
    report["bench_fleet"].update(acceptance=acc, margins=margins)
    log(f"[{card}] 3y-e: serve-drill (phases 1-12) exit 0 in "
        f"{report['drill']['wall_s']:.1f} s ({report['drill']['checks_ok']} "
        f"checks), fleet census {report['drill_census']}, reaps "
        f"{fleet['reaps']}; --fleet-smoke exit 0 in "
        f"{report['fleet_smoke']['wall_s']:.1f} s (the two at once); "
        f"bench-serve --fleet alone, exit 0 in "
        f"{report['bench_fleet']['wall_s']:.1f} s: autoscaled / static "
        f"worker-seconds {acc['worker_seconds_ratio']!r} (gate < 0.8), "
        f"victim hit rate {acc['victim_hit_rate']!r} (SLO {slo}), SLO "
        f"{acc['slo_met_autoscaled']}, equal to single-tenant "
        f"{acc['outputs_bit_equal_to_single_tenant']}; margins {margins}")
    return report


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


def time_pool_layers(device, dtype, backward, plain=True, library=True,
                     layers=POOLS, with_idx=None):
    """K1 or (``backward``) K3 at each pool layer of ``layers`` (those of
    Inception-v1 at batch 32 by default):
    per layer its CUDA-event median (L2 flushed) and torch.profiler device
    time, its bytes bound, the plain version's time and the library call's
    (events and device time; ``plain`` and ``library`` False leave those
    out).  K1 writes its index where ``with_idx`` says, by default in
    bfloat16, as training calls it, and not in float32, as serving does;
    the library calls are ``F.max_pool2d`` (with indices where K1 writes
    them) and ATen's ``max_pool2d_with_indices_backward``."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import (max_pool2d, max_pool2d_bwd,
                                     max_pool2d_bwd_plain, max_pool2d_plain)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    if with_idx is None:
        with_idx = dtype == torch.bfloat16
    size = torch.empty((), dtype=dtype).element_size()
    rows = []
    for name, shape, kh, kw, sh, sw, ph, pw, ceil in layers:
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        geom = (kh, kw, sh, sw, ph, pw, ceil)
        _, idx = max_pool2d(x, *geom, return_indices=True)
        y64, idx64 = F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw),
                                  ceil_mode=ceil, return_indices=True)
        if y64.shape != idx.shape:
            fail(f"F.max_pool2d gives {tuple(y64.shape)} windows, the port "
                 f"{tuple(idx.shape)}: no library yardstick")
        if backward:
            dy = torch.randn(tuple(idx.shape), generator=gen,
                             device=device).to(dtype)
            nbytes = (size + 1) * idx.numel() + size * x.numel()
            kern = lambda: max_pool2d_bwd(dy, idx, geom, shape[2], shape[3])
            ref = lambda: max_pool2d_bwd_plain(dy, idx, geom, shape[2],
                                               shape[3])
            lib = lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                dy, x, [kh, kw], [sh, sw], [ph, pw], [1, 1], ceil, idx64)
        else:
            nbytes = size * (x.numel() + idx.numel()) + \
                (idx.numel() if with_idx else 0)
            kern = lambda: max_pool2d(x, *geom, return_indices=with_idx)
            ref = lambda: max_pool2d_plain(x, *geom)
            lib = lambda: F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw),
                                       ceil_mode=ceil,
                                       return_indices=with_idx)
        nops = idx.numel() * kh * kw
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS)
        rows.append({
            "layer": name, "shape": list(shape),
            "ms": median_ms(kern, device, flush=flush),
            "device_ms": device_ms(
                kern, flush, bound_ms=bound,
                what=f"{'K3' if backward else 'K1'} at {name}"),
            "bound_ms": bound,
            "plain_ms": median_ms(ref, device, flush=flush) if plain
            else None,
            "library_ms": median_ms(lib, device, flush=flush) if library
            else None,
            "library_device_ms": device_ms(lib, flush) if library
            else None})
    return rows


def pool_sums(rows):
    """A kernel's entry from :func:`time_pool_layers`' (or
    :func:`time_lrn_layers`') rows: each time summed over the layers (None
    where a layer's was not measured), and the rows themselves."""
    out = {"bound_by": "bytes", "per_layer": rows}
    for key in ("ms", "device_ms", "bound_ms", "plain_ms", "library_ms",
                "library_device_ms"):
        vals = [r[key] for r in rows]
        out[key] = None if None in vals else sum(vals)
    return out


def log_pool_times(card, what, t, layers="pools"):
    """Phase 4's K1-K4 lines: per pool (or LRN) layer, then summed."""
    for r in t["per_layer"]:
        log(f"[{card}] {what} {r['layer']} {tuple(r['shape'])}: "
            f"{r['ms']:.4f} ms, device {fmt_ms(r['device_ms'])}, bound "
            f"{r['bound_ms']:.4f} ms (bytes), plain {fmt_ms(r['plain_ms'])}"
            f", library {r['library_ms']:.4f} ms, device "
            f"{fmt_ms(r['library_device_ms'])}")
    log(f"[{card}] {what}, summed over the {len(t['per_layer'])} {layers}: "
        f"{t['ms']:.4f} ms, device {fmt_ms(t['device_ms'])}, bound "
        f"{t['bound_ms']:.4f} ms (bytes), plain {fmt_ms(t['plain_ms'])}, "
        f"library {t['library_ms']:.4f} ms, device "
        f"{fmt_ms(t['library_device_ms'])}")


def time_lrn_layers(device, dtype, backward, with_scale=False, plain=True,
                    library=True, layers=LRNS):
    """K2 or (``backward``) K4 at each LRN layer of ``layers`` (those of
    Inception-v1 at batch 32 by default):
    per layer its CUDA-event median (L2 flushed) and torch.profiler device
    time, its bound, the plain version's time and the library call's
    (events and device time; ``plain`` and ``library`` False leave those
    out).  K2 writes its scale with ``with_scale``, as training calls it,
    and not without, as serving does; the library calls are
    ``F.local_response_norm`` and, for K4, autograd's backward of it."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import (cross_map_lrn, lrn_bwd, lrn_bwd_plain,
                                     lrn_plain)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    size_of = torch.empty((), dtype=dtype).element_size()
    rows = []
    for name, shape, size, alpha, beta, k in layers:
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        if backward:
            dy = torch.randn(shape, generator=gen, device=device).to(dtype)
            _, scale = cross_map_lrn(x, size, alpha, beta, k,
                                     return_scale=True)
            xr = x.clone().requires_grad_()
            yr = F.local_response_norm(xr, size, alpha, beta, k)
            nbytes, nops = 4 * size_of * x.numel(), x.numel() * (6 * size + 8)
            kern = lambda: lrn_bwd(x, scale, dy, size, alpha, beta)
            ref = lambda: lrn_bwd_plain(x, scale, dy, size, alpha, beta)
            lib = lambda: torch.autograd.grad(yr, xr, dy, retain_graph=True)
        else:
            nbytes = (2 + with_scale) * size_of * x.numel()
            nops = x.numel() * (2 * size + 6)
            kern = lambda: cross_map_lrn(x, size, alpha, beta, k,
                                         return_scale=with_scale)
            ref = lambda: lrn_plain(x, size, alpha, beta, k)
            lib = lambda: F.local_response_norm(x, size, alpha, beta, k)
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, nops / F32_FLOPS)
        rows.append({
            "layer": name, "shape": list(shape),
            "ms": median_ms(kern, device, flush=flush),
            "device_ms": device_ms(
                kern, flush, bound_ms=bound,
                what=f"{'K4' if backward else 'K2'} at {name}"),
            "bound_ms": bound,
            "plain_ms": median_ms(ref, device, flush=flush) if plain
            else None,
            "library_ms": median_ms(lib, device, flush=flush) if library
            else None,
            "library_device_ms": device_ms(lib, flush) if library
            else None})
    return rows


def time_kernels(device):
    """Per kernel, summed over one batch-32 f32 serving forward's calls:
    median kernel time, torch.profiler device time, bound, plain version,
    library call; per layer too (:func:`time_pool_layers`,
    :func:`time_lrn_layers`)."""
    import torch
    return {"max_pool2d_fwd": pool_sums(
                time_pool_layers(device, torch.float32, False)),
            "lrn_fwd": pool_sums(
                time_lrn_layers(device, torch.float32, False))}


def time_train_kernels(device):
    """Per kernel, summed over one training step's calls at batch 32 in
    bf16: K1 with the index write and K3, K2 with the scale write and K4;
    median kernel time, torch.profiler device time, bound, plain version,
    library call, per layer too."""
    import torch
    bf16 = torch.bfloat16
    return {
        "max_pool2d_fwd": pool_sums(time_pool_layers(device, bf16, False)),
        "max_pool2d_bwd": pool_sums(time_pool_layers(device, bf16, True)),
        "lrn_fwd": pool_sums(time_lrn_layers(device, bf16, False,
                                             with_scale=True)),
        "lrn_bwd": pool_sums(time_lrn_layers(device, bf16, True))}


# phase 4's K1-K4 at the harness's shapes: what each timing stands for
def time_rcnn_pools(device, card):
    """K1 (f32 with its index, as training calls it) and K3 at the Fast
    R-CNN trunk's four pools (RCNN_POOLS: batch 2 on 600x800 input) per
    layer and summed, by CUDA events and device time (L2 flushed), beside
    their bounds, plain versions and ATen's calls; logs each launch's
    instantiation and plan."""
    import torch
    f32 = torch.float32
    out = {"max_pool2d_fwd": pool_sums(time_pool_layers(
               device, f32, False, layers=RCNN_POOLS, with_idx=True)),
           "max_pool2d_bwd": pool_sums(time_pool_layers(
               device, f32, True, layers=RCNN_POOLS))}
    for name, t in out.items():
        log_pool_times(card, f"{name} (f32, the Fast R-CNN trunk, batch "
                       f"{RCNN_IMAGES} on {RCNN_H}x{RCNN_W})", t)
    for layer, shape, *geom in RCNN_POOLS:
        for kernel, backward in (("K1", False), ("K3", True)):
            variant, plan, mode = pool_take(shape, tuple(geom), f32,
                                            backward)
            log(f"{kernel} plan at {layer} {shape}: {variant}, {mode}, "
                f"{fmt_plan(plan)}")
    return out


def time_text_pools(device, card):
    """K1 (f32 with its index, as training calls it) and K3 at the text
    classifier's three pools (TEXT_POOLS: batch 128, one-row planes) per
    layer and summed, by CUDA events and device time (L2 flushed), beside
    their bounds, plain versions and ATen's calls; logs each launch's
    instantiation and plan."""
    import torch
    f32 = torch.float32
    out = {"max_pool2d_fwd": pool_sums(time_pool_layers(
               device, f32, False, layers=TEXT_POOLS, with_idx=True)),
           "max_pool2d_bwd": pool_sums(time_pool_layers(
               device, f32, True, layers=TEXT_POOLS))}
    for name, t in out.items():
        log_pool_times(card, f"{name} (f32, the text classifier, batch "
                       f"{TEXT_BATCH})", t)
    for layer, shape, *geom in TEXT_POOLS:
        for kernel, backward in (("K1", False), ("K3", True)):
            variant, plan, mode = pool_take(shape, tuple(geom), f32,
                                            backward)
            log(f"{kernel} plan at {layer} {shape}: {variant}, {mode}, "
                f"{fmt_plan(plan)}")
    return out


def time_main_pools(device, card):
    """K1 (f32 with its index, as the mains train) and K3 at LeNet-5's two
    pools (batch 128) and VggForCifar10's five (batch 112) per layer and
    summed, the way ``time_text_pools`` times the text classifier's."""
    import torch
    f32 = torch.float32
    out = {}
    for key, what, layers in (
            ("lenet_f32", "LeNet-5, batch 128", LENET_POOLS),
            ("vgg_cifar_f32", "VggForCifar10, batch 112", CIFAR_VGG_POOLS)):
        out[key] = {"max_pool2d_fwd": pool_sums(time_pool_layers(
                        device, f32, False, layers=layers, with_idx=True)),
                    "max_pool2d_bwd": pool_sums(time_pool_layers(
                        device, f32, True, layers=layers))}
        for name, t in out[key].items():
            log_pool_times(card, f"{name} (f32, {what})", t)
        for layer, shape, *geom in layers:
            for kernel, backward in (("K1", False), ("K3", True)):
                variant, plan, mode = pool_take(shape, tuple(geom), f32,
                                                backward)
                log(f"{kernel} plan at {layer} {shape}: {variant}, {mode}, "
                    f"{fmt_plan(plan)}")
    return out


HARNESS_TIMES = {
    "max_pool2d_fwd": "f32 with its index, perf local",
    "max_pool2d_fwd_infer": "bf16, no index, perf infer",
    "max_pool2d_bwd": "f32, perf local",
    "lrn_fwd": "f32 with its scale, perf local",
    "lrn_fwd_infer": "bf16, no scale, perf infer",
    "lrn_bwd": "f32, perf local"}


def time_harness_kernels(device):
    """K1-K4 at the shapes of the perf harness's paths at batch 128: K1
    and K3 at VGG's five 2x2/2 pools (224 to 14-pixel planes) and
    AlexNet's three 3x3/2 pools, K2 and K4 at AlexNet's two LRNs (odd
    planes, one pixel a thread), each in float32 as ``perf local`` calls
    it (K1 with its index, K2 with its scale) and K1/K2 also in bfloat16
    as ``perf infer`` calls them; per layer and summed, by CUDA events and
    torch.profiler device time, beside bound, plain version and the
    library call."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}
    for key, layers in (("vgg", VGG_POOLS), ("alexnet", ALEXNET_POOLS[:3])):
        out[key] = {
            "max_pool2d_fwd": pool_sums(time_pool_layers(
                device, f32, False, layers=layers, with_idx=True)),
            "max_pool2d_fwd_infer": pool_sums(time_pool_layers(
                device, bf16, False, layers=layers, with_idx=False)),
            "max_pool2d_bwd": pool_sums(time_pool_layers(
                device, f32, True, layers=layers))}
    out["alexnet"].update({
        "lrn_fwd": pool_sums(time_lrn_layers(
            device, f32, False, with_scale=True, layers=ALEXNET_LRNS)),
        "lrn_fwd_infer": pool_sums(time_lrn_layers(
            device, bf16, False, layers=ALEXNET_LRNS)),
        "lrn_bwd": pool_sums(time_lrn_layers(
            device, f32, True, layers=ALEXNET_LRNS))})
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


def _profiled(run):
    """Device time in us and launch count by kernel (and copy) name of
    ``run()`` under torch.profiler: ``{name: (us, count)}``."""
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
        was = out.get(evt.key, (0.0, 0))
        out[evt.key] = (was[0] + us, was[1] + evt.count)
    return out


def _profiled_us(run):
    """Device time in us by kernel (and copy) name of ``run()`` under
    torch.profiler."""
    return {name: us for name, (us, _) in _profiled(run).items()}


DEVICE_WINDOWS = 6     # profiled windows device_ms may take for one reading
# untimed flushes and a pause before and after each profiled window: late in
# a long run the profiler loses the first launches of a window
PAD_FLUSHES, PAD_S = 16, 0.005


def device_ms(fn, flush, reps=TIMING_REPS, bound_ms=None, what=None):
    """Device time of one ``fn()`` in ms from torch.profiler: every kernel
    it launches, summed, over ``reps`` calls each after an L2 flush (the
    flush's own kernels left out).  The profiler now and then misses a
    kernel, which only lowers a sum, so a window counts only where it
    recorded ``reps`` times the launches of one call alone, and, with
    ``bound_ms``, only where its time is not under that bound; the larger
    of the first two windows that count, of up to DEVICE_WINDOWS.  None
    (not measured) where no window counts; windows dropped are logged with
    their launch counts and times, under ``what``.  Each window runs
    between PAD_FLUSHES untimed flushes and PAD_S pauses."""
    import torch
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

    def padded(body):
        for _ in range(PAD_FLUSHES):
            flush.zero_()
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        body()
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        for _ in range(PAD_FLUSHES):
            flush.zero_()

    def window(body):
        """(us, launches) of the kernels ``body()`` launched."""
        kept = [v for name, v in _profiled(lambda: padded(body)).items()
                if not flush_kernel(name)]
        return sum(us for us, _ in kept), sum(n for _, n in kept)

    per_call = window(fn)[1]
    good, dropped = [], []
    for _ in range(DEVICE_WINDOWS):
        us, n = window(run)
        if n > per_call * reps and n % reps == 0:
            per_call = n // reps    # the lone call's window missed some
        ms = us / 1e3 / reps
        if per_call and n == per_call * reps and \
                (bound_ms is None or ms >= bound_ms):
            good.append(ms)
            if len(good) == 2:
                break
        else:
            dropped.append(f"{n} of {per_call * reps} launches, "
                           f"{ms:.4f} ms")
    if dropped:
        log(f"device_ms{' of ' + what if what else ''}: {len(dropped)} "
            f"profiled window(s) dropped "
            f"({'; '.join(dropped)}"
            + (f"; bound {bound_ms:.4f} ms" if bound_ms is not None else "")
            + ")" + ("" if good else ": device time not measured"))
    return max(good) if good else None


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
    K13 e4m3, K15 and K14 (both buckets; K13 e4m3 and K15 also f32 at batch
    32) at the classifier, the one product each of those rungs runs.  A
    name ending in ``_f32`` is its wrapper in float32."""
    cases = {}
    for b, ps in prods.items():
        for layer, kind, m, k, n, _ in ps:
            names = ["w8_matmul"] + (["w8_matmul_f32"] if b == BATCH else [])
            if kind == "linear":
                names += ["f8_matmul", "w4_matmul", "a8_matmul"] + \
                    (["f8_matmul_f32", "w4_matmul_f32"] if b == BATCH
                     else [])
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


def quant_plan(name, dtype, m, k, n):
    """The plan a wrapper's kernel takes at (M, K, N) in ``dtype`` (where
    the package plans it), as a dict."""
    import torch
    from bigdl_tpu_torch.ops import quant
    if name == "a8_matmul":
        planner = getattr(quant, "a8_plan", None)
        return None if planner is None else planner(m, k, n)._asdict()
    planner = getattr(quant, "bf16_plan" if dtype == torch.bfloat16 else
                      "f32_plan", None)
    return None if planner is None else planner(
        m, k, n, nibbles=name.startswith("w4_matmul"))._asdict()


def time_product(name, dtype, m, k, n, gen, flush, device, plain=True):
    """One packed product through the wrapper ``name`` at (M, K, N) in
    ``dtype``, seeded x and weight: the kernel's CUDA-event median (L2
    flushed between calls), its device time from torch.profiler, its
    wrapper's host time, the plain version's time (when ``plain``), and
    ``F.linear`` on the widened weight (K14: ``torch._int_mm`` + scale,
    None where its shape rules refuse) by both clocks, beside the bound and
    the kernel's plan."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import quant
    bf16 = torch.bfloat16
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
        pl = lambda: quant.int8_a8_matmul_plain(xq, qt["q8"], s, dtype)
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
            pl = lambda: quant.int4_matmul_plain(x, qt["q4"], qt["scale"], k)
        else:
            q = qt["q8" if mode == "w8" else "f8"]
            fn = quant.w8_matmul if mode == "w8" else quant.f8_matmul
            kern = lambda: fn(x, q, qt["scale"])
            pl = lambda: quant.int8_matmul_plain(x, q, qt["scale"])
        lib = lambda: F.linear(x, wide)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2 * m * n * k / peak
    r = {"M": m, "K": k, "N": n, "dtype": str(dtype).replace("torch.", ""),
         "ms": median_ms(kern, device, flush=flush),
         "device_ms": device_ms(kern, flush,
                                bound_ms=max(bytes_ms, ops_ms)),
         "host_ms": host_ms(kern),
         "plain_ms": median_ms(pl, device, flush=flush) if plain else None,
         "library_ms": None if lib is None else
         median_ms(lib, device, flush=flush),
         "library_device_ms": None if lib is None else device_ms(lib, flush),
         "bytes_ms": bytes_ms, "ops_ms": ops_ms,
         "bound_ms": max(bytes_ms, ops_ms)}
    r["plan"] = quant_plan(name, dtype, m, k, n)
    return r


def lm_step_products(pool_dtype="bfloat16"):
    """(K, N, calls, x dtype) of the packed products of one LM decode step:
    q/k/v, out, fc1 and fc2 of every block, and the tied head.  The packed
    gather widens to f32, so every product takes f32 x but the out
    projection, whose x is the attention output in the pool's dtype (as in
    the reference, ``nn/attention.py`` ``apply_decode_pages``)."""
    e, f32 = LM_EMBED, "float32"
    return [(e, e, 3 * LM_LAYERS, f32), (e, e, LM_LAYERS, pool_dtype),
            (e, 4 * e, LM_LAYERS, f32), (4 * e, e, LM_LAYERS, f32),
            (e, LM_VOCAB, 1, f32)]


def time_lm_quant(device):
    """Each rung's kernels summed over one decode step's 49 packed products
    at M = CG_SLOTS in the path's dtypes (:func:`lm_step_products`: f32,
    the out projection bf16 over phase 3p's bf16 pool), per product as
    :func:`time_product` times it (w8a8: K14 at the 48 calibrated
    products, K13 at the head).  Returns ``{rung: sums with "products"}``
    and ``{wrapper: its sums over the step}`` for the kernels line."""
    import torch
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    wrappers = {"w8": "w8_matmul", "w8a8": "a8_matmul", "w4": "w4_matmul",
                "f8": "f8_matmul"}
    rungs, by_wrapper = {}, {}
    for mode, wrapper in wrappers.items():
        rows = []
        for k, n, calls, dtype in lm_step_products():
            name = "w8_matmul" if mode == "w8a8" and n == LM_VOCAB else \
                wrapper
            r = time_product(name, getattr(torch, dtype), CG_SLOTS, k, n,
                             gen, flush, device)
            r.update(name=name, calls=calls)
            rows.append(r)
        rungs[mode] = dict(_quant_sums(rows), products=rows)
        by_wrapper[wrapper] = dict(_quant_sums(
            [r for r in rows if r["name"] == wrapper]), M=CG_SLOTS,
            products=rows)
    return rungs, by_wrapper


def time_quant_kernels(device, prods):
    """K13-K15 per distinct product of the quantized forward (``prods``:
    :func:`quant_products` per bucket, QUANT_CASES' wrappers): per product
    the kernel's CUDA-event median (L2 flushed between calls), its device
    time from torch.profiler, its wrapper's host time, the plain version's
    time (batch 32), and ``F.linear`` on the widened weight (K14:
    ``torch._int_mm`` + scale) by both clocks, beside the bound; the
    kernel's plan where the package has one.  Returns ``(sums, rows)``:
    per wrapper (``<wrapper>_f32`` in f32) the batch-32 sums over the
    forward's calls with ``"buckets"`` ({bucket: sums}) and ``"stages"``
    ({bucket: {stage: sums}}), and the per-product rows."""
    import torch
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    rows = []
    for (name, b, stage, (m, k, n)), c in sorted(quant_cases(prods).items()):
        dtype = torch.float32 if name.endswith("_f32") else torch.bfloat16
        r = time_product(name.replace("_f32", ""), dtype, m, k, n, gen,
                         flush, device, plain=b == BATCH)
        r.update(name=name, bucket=b, stage=stage, calls=c)
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
            if name in ("w8_matmul", "w8_matmul_f32"):
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
            "device_ms": device_ms(kern, flush,
                                   bound_ms=max(bytes_ms, ops_ms)),
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
    FLASH_PATH and FLASH_TIMED (each in its dtype): median kernel time with
    the L2 flushed,
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
    for i, case in enumerate(FLASH_PATH + FLASH_TIMED):
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
    """(bytes, FLOPs) a K12 call needs: the K/V of the keys visible through
    each distinct page table read once per KV head (a verify pass's rows
    share their slot's table), q, the output, the table and the positions
    once; 4·D FLOPs per visible (query, key) pair and head."""
    import torch
    h, d = q.shape[1], q.shape[3]
    hkv, ps = k.shape[1], k.shape[2]
    length = pages.shape[1] * ps
    seen = (positions.long() + 1).clamp(max=length)
    tables, which = torch.unique(pages, dim=0, return_inverse=True)
    keys = torch.zeros(tables.shape[0], dtype=torch.long,
                       device=seen.device).scatter_reduce(
        0, which, seen.amax(dim=1), "amax")
    nbytes = (int(keys.sum()) * hkv * d * 2 * k.element_size() +
              q.numel() * q.element_size() + q.numel() * k.element_size() +
              4 * (pages.numel() + positions.numel()))
    return nbytes, 4 * d * h * int(seen.sum())


def paged_blocks(plan, case, pos):
    """(blocks, blocks that hold visible keys) of K12's grid under ``plan``
    for a case and its positions (B, S): a split holds visible keys when
    its first key lies at or before the last key any row of its tile
    sees."""
    b, h, hkv, s = case[1:5]
    ps = case[6]
    g, per = h // hkv, plan.rows_per_block
    keys = plan.pages_per_split * ps
    live = 0
    for row in range(b):
        for t in range(plan.row_tiles):
            packed = range(t * per, min((t + 1) * per, g * s))
            top = max(int(pos[row, r % s]) for r in packed)
            live += hkv * sum(1 for j in range(plan.splits)
                              if j * keys <= top)
    return b * hkv * plan.row_tiles * plan.splits, live


def time_paged(device):
    """K12 per call at the path's decode shape (the page split), its two
    prefill shapes and a session's next-turn prefill from a mid-page start
    (the tensor-core path) and the speculative verify shape (CG_SLOTS x
    (SPEC_K + 1) rows), bf16: median
    kernel time with
    the L2 flushed by CUDA events and torch.profiler's device time (K12's
    kernels: the split and its combine), its plan and the blocks that hold
    visible keys, its bound, the plain version (which gathers the view)
    and SDPA on the pre-gathered view with the boolean mask (the gather
    excluded from its time) by both clocks."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import attention as attn
    flush = torch.empty(64 << 20, dtype=torch.int32, device=device)
    bf16 = torch.bfloat16
    out = {}
    vcase, vops = paged_verify_operands(bf16, bf16, device, SEED + 91)
    for key, case, ops in (
            ("decode", paged_decode_case(), None),
            ("prefill_512", PAGED_RAGGED[0], None),
            ("prefill_128", PAGED_RAGGED[1], None),
            ("continuation", PAGED_SESSION, None),
            ("verify", vcase, vops)):
        q, k, v, pages, pos, scale = ops or paged_operands(
            case, bf16, bf16, device, SEED + 90)
        b, h, s, d = q.shape
        ps, lp = k.shape[2], pages.shape[1]
        plan = attn.paged_plan(case[1], *case[2:8], bf16, bf16)
        blocks, live = paged_blocks(plan, case, pos.cpu())
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
        kern = lambda: attn.paged_attention(q, k, v, pages, pos, scale)
        lib = lambda: F.scaled_dot_product_attention(q, kk, vv,
                                                     attn_mask=mask,
                                                     scale=scale)
        out[key] = {
            "case": case[0], "shape": [b, h, k.shape[1], s, d, ps, lp],
            "dtype": "bfloat16", "plan": plan._asdict(), "blocks": blocks,
            "blocks_with_visible_keys": live,
            "ms": median_ms(kern, device, flush=flush),
            "device_ms": device_ms(kern, flush,
                                   bound_ms=max(bytes_ms, ops_ms)),
            "plain_ms": median_ms(lambda: attn.paged_attention_plain(
                q, k, v, pages, pos, scale), device, reps=5, flush=flush),
            "library_ms": median_ms(lib, device, flush=flush),
            "library_device_ms": device_ms(lib, flush),
            "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        del q, k, v, kk, vv
    return out


def time_park_resume(device):
    """A park and a resume of one session of SESS_PARK_PAGES private pages
    at 3q's widths (LM_LAYERS layers' bf16 K and V pools of SESS_PAGES
    pages), as ``ContinuousGenerator`` runs them: median of TIMING_REPS by
    CUDA events around the device gather and the D2H copy
    (``gather_pages``), and around the H2D copy and the in-place write
    (``scatter_pages``), each call whole by the host's clock; the copies'
    GB/s beside the host link's rate."""
    import torch
    from bigdl_tpu_torch.serving.scheduler.continuous import (gather_pages,
                                                              scatter_pages)
    g = torch.Generator(device=device).manual_seed(SEED + 150)
    shape = (SESS_PAGES + 1, LM_HEADS, CG_PAGE, LM_EMBED // LM_HEADS)
    with torch.inference_mode():
        # init_paged_cache's pools, trash page last
        cache = [{side: torch.randn(shape, generator=g, device=device)
                  .to(torch.bfloat16) for side in ("k", "v")}
                 for _ in range(LM_LAYERS)]
        ids = np.random.RandomState(SEED + 150).permutation(
            SESS_PAGES)[:SESS_PARK_PAGES].tolist()
        idx = torch.tensor(ids, device=device)
        nbytes = SESS_PARK_PAGES * sum(c[side][0].numel() * 2 for c in cache
                                       for side in ("k", "v"))
        stages = {k: [] for k in ("gather", "d2h", "h2d", "write", "park",
                                  "resume")}
        for _ in range(TIMING_REPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            dev = [{side: c[side][idx] for side in ("k", "v")}
                   for c in cache]
            ev[1].record()
            host = [{side: d[side].cpu() for side in ("k", "v")}
                    for d in dev]
            ev[2].record()
            torch.cuda.synchronize()
            stages["gather"].append(ev[0].elapsed_time(ev[1]))
            stages["d2h"].append(ev[1].elapsed_time(ev[2]))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            up = [{side: h[side].to(device) for side in ("k", "v")}
                  for h in host]
            ev[1].record()
            for c, u in zip(cache, up):
                for side in ("k", "v"):
                    c[side].index_copy_(0, idx, u[side])
            ev[2].record()
            torch.cuda.synchronize()
            stages["h2d"].append(ev[0].elapsed_time(ev[1]))
            stages["write"].append(ev[1].elapsed_time(ev[2]))
            t0 = time.perf_counter()
            payload = gather_pages(cache, ids)
            stages["park"].append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            scatter_pages(cache, ids, payload)
            torch.cuda.synchronize()
            stages["resume"].append(1e3 * (time.perf_counter() - t0))
        if not all(torch.equal(p[side], h[side]) for p, h in
                   zip(payload, host) for side in ("k", "v")):
            fail("gather_pages differs from the timed gather and copy")
    del cache
    out = {k: statistics.median(v) for k, v in stages.items()}
    link_ms = 1e3 * nbytes / HOST_LINK_BYTES_PER_S
    out.update(pages=SESS_PARK_PAGES, bytes=nbytes, link_bound_ms=link_ms,
               d2h_gb_s=nbytes / out["d2h"] / 1e6,
               h2d_gb_s=nbytes / out["h2d"] / 1e6,
               host_link_gb_s=HOST_LINK_BYTES_PER_S / 1e9)
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
                              1, PAGED_KERNELS)
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


# the f32 K13's kernels by name (csrc/quant_matmul.cu): the FFMA kernel
# and a split's second pass
F32_K13_KERNELS = {"f32_mm": "f32_mm<", "splitk_finish": "splitk_finish<"}


def time_quantized_f32(card, clf, device, groups=None):
    """Phase 4's default f32 ``w8`` forward: per bucket its median time
    (as a worker runs it) and a profiler breakdown of its device time, with
    the K13 kernels' share (``groups``, F32_K13_KERNELS by default)."""
    fwd_ms = time_forwards(clf, device)
    out = {"forward_ms": fwd_ms}
    for b in BUCKETS:
        p = profile_forward(clf, device, b, groups=groups or F32_K13_KERNELS)
        p["busy_share"] = p["device_ms"] / fwd_ms[b]
        k13 = sum(p["groups"].values())
        log(f"[{card}] w8 f32 forward bucket {b}: {fwd_ms[b]:.3f} ms median "
            f"of {TIMING_REPS} ({b / fwd_ms[b] * 1e3:.1f} images/s); device "
            f"{p['device_ms']:.3f} ms per forward ({k13:.3f} of it in K13 "
            f"and its split passes), busy share {p['busy_share']:.3f}; top "
            "kernels and copies (ms per forward): " + json.dumps(p["top"]))
        out[f"profile_bucket_{b}"] = p
    return out


def profile_forward(clf, device, bucket, reps=3, groups=None):
    """Device time by kernel of one bucket forward as a worker runs it,
    over ``reps`` forwards after :func:`time_forwards` warmed it
    (:func:`device_profile`'s ``groups``)."""
    x = clf._pack(make_rows(bucket, SEED + 7), size=bucket)

    def run():
        for _ in range(reps):
            clf._run(x).cpu()
    return device_profile(run, reps, groups)


# K12's kernels by name (csrc/paged_attention.cu): each path's, and the
# page split's second pass
PAGED_KERNELS = {"tensor_core": "paged_tc<", "split": "paged_split<",
                 "combine": "paged_combine<"}
# phase 3p's profiles: the quantized products (f32, and K14), K12, and the
# library's products (the bf16 target's projections under speculation)
QUANT_LM_KERNELS = dict(PAGED_KERNELS, f32_mm="f32_mm<",
                        splitk_finish="splitk_finish<", a8_wgmma="a8_wgmma",
                        library_gemm=("gemm", "Gemm", "cutlass", "xmma"))


def device_profile(fn, n, groups=None):
    """``torch.profiler`` over ``fn()``, which runs ``n`` steps or forwards:
    the summed kernel and copy time per step, the kernels that take the
    most of it, and per label of ``groups`` the time of the kernels whose
    name holds its substring (or one of its tuple of substrings).  The profiler slows the host, so the busy
    share is taken against an unprofiled time by the caller."""
    kernels = {name: us / 1e3 / n for name, us in _profiled_us(fn).items()
               if us > 0}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    out = {"device_ms": sum(kernels.values()),
           "htod_ms": sum(ms for name, ms in kernels.items()
                          if name.startswith("Memcpy HtoD")),
           "top": [[name[:90], ms] for name, ms in top]}
    if groups:
        out["groups"] = {label: sum(
            ms for name, ms in kernels.items()
            if any(p in name for p in ((part,) if isinstance(part, str)
                                       else part)))
            for label, part in groups.items()}
    return out


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
    clock = PhaseClock()
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.load()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc "
        f"{' '.join(_build.ARCH)}, {len(_build.sources())} sources)")
    clock.stamp("1 (build)")

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
    # and at the packed LM's (phase 3p): decode, verify and prefill rows
    lm_shapes = [(m, k, n) for m in LM_QUANT_MS for k, n in LM_QUANT_KN]
    path_shapes = {name: shapes + lm_shapes
                   for name, shapes in path_shapes.items()}
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
    clock.stamp("2-2g (kernels against their plain versions)")
    # phase 3, 3b, 3c and 3d: each path's launches counted from 0
    report, serve_launches = serve(device)
    train_report, train_launches = train(device)
    train_report["card_vs_cpu"] = train_vs_cpu(device)
    qreport, quant_launches, qclf = serve_quantized(device)
    qreport["f32"], more, qclf_f32 = serve_quantized_f32(device)
    quant_launches.update(more)
    for mode, r in qreport["rungs"].items():
        log(f"[{card}] rung {mode} (bf16 activations, batch {BATCH}): top-1 "
            "agreement with the bf16 forward "
            f"{r['top1_agreement_vs_bf16']:.4f}, mean |dlogp| "
            f"{r['mean_abs_dlogp_vs_bf16']:.5f}, resident "
            f"{r['resident_ratio_vs_bf16']:.4f} of the bf16 tree (budget "
            f"{r['budget']['max_resident_ratio_vs_bf16']}), bytes "
            f"{r['bytes_by_dtype']}")
    clock.stamp("3-3d (Inception-v1 serving, training, quantized)")
    lm_report, lm_launches, score_model, long_model = lm_scoring(device)
    lm_report["head_dim_256"], more = lm_head_dim_256(device)
    lm_launches.update(more)
    gen_report, gen_launches, gen_model, prompt = lm_generation(device)
    lm_launches.update(gen_launches)
    clock.stamp("3e-3f (LM scoring and generation)")
    cg_report, cg_launches, cg_run = continuous_serving(device)
    lm_launches.update(cg_launches)
    clock.stamp("3g (continuous serving)")
    # phase 3p: the LM quantized behind the generator, and speculating
    qcg_report, more = quantized_continuous(device, cg_run[0], card)
    lm_launches.update(more)
    spec_report, more = speculative_continuous(device, cg_run[0], card)
    lm_launches.update(more)
    clock.stamp("3p (quantized and speculative serving)")
    # phase 3q: multi-turn sessions, parking and the memory budget
    sess_report, more = session_serving(device, cg_run[0], card)
    lm_launches.update(more)
    clock.stamp("3q (sessions)")
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
    clock.stamp("3h (long-context training)")
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
    clock.stamp("3i-3j (train_main, snapshots and resume)")
    # phase 3k: the codec on the long-context model's gradients
    codec_report, lm_launches["codec"] = codec_chain(device)
    log(f"[{card}] train_main (f32, {' '.join(TM_FLAGS)}): "
        f"{len(tm_report['losses'])} steps, losses {tm_report['losses']}, "
        f"validation loss {tm_report['validation_loss']:.4f}, step "
        f"{tm_report['step_ms_median_after_first']:.1f} ms (median after the "
        f"first; {tm_report['step_ms'][0]:.1f} ms the first), launches "
        f"{tm_report['launches']}")
    clock.stamp("3k (the codec on a gradient)")
    # phase 3l, 3m and 3n: ResNet-50, Inception-v2, the CIFAR-10 ResNet
    cnn = {"resnet50": cnn_path(device, "ResNet-50", resnet50, resnet_recipe,
                                TRAIN_STEPS, 1, N_ROWS, WAVES),
           "inception_v2": cnn_path(device, "Inception-v2", inception_v2,
                                    inception_recipe, V2_STEPS, 5, 8,
                                    CNN_WAVES)}
    cifar_report, cifar_launches = cifar_path(device)
    cnn_launches = {f"{key}_{p}": v for key, (_, _, by) in cnn.items()
                    for p, v in by.items()}
    cnn_launches["cifar_resnet20_train"] = cifar_launches
    clock.stamp("3l-3n (ResNet-50, Inception-v2, CIFAR ResNet-20)")
    # phase 3o: the perf harness, local and infer, each model at batch 128
    harness_report, harness_launches = perf_harness(device, card)
    cnn_launches.update(harness_launches)
    log("perf harness: " + json.dumps(harness_report))
    clock.stamp("3o (the perf harness)")
    # phase 3r: the autoencoder's MSE recipe, a Fast R-CNN head on VGG-16,
    # and the criterions and table, shape and distance layers card vs CPU
    ae_report, cnn_launches["autoencoder"] = autoencoder_recipe(device, card)
    rcnn_report, more = fast_rcnn_head(device, card)
    cnn_launches.update(more)
    sweep_errs = criterion_layer_sweep(device)
    log("autoencoder recipe: " + json.dumps(ae_report))
    log("Fast R-CNN head: " + json.dumps(rcnn_report))
    log(f"sweep: {len(sweep_errs)} criterions and layers held, worst "
        f"{max(sweep_errs.values()):.3g} of the largest value (limit "
        f"{SWEEP_RTOL})")
    clock.stamp("3r (criterions and detection)")
    # phase 3s: the text classifier, SimpleRNN's mains, and this slice's
    # layers and packed models card vs CPU
    text_report, more = text_classifier(device, card)
    cnn_launches.update(more)
    rnn_report, more = simple_rnn(device, card)
    cnn_launches.update(more)
    slice_errs, more = slice_layer_sweep(device, card)
    cnn_launches.update(more)
    log("text classifier: " + json.dumps(text_report))
    log("SimpleRNN: " + json.dumps(rnn_report))
    log("slice layers and packed models: " + json.dumps(slice_errs))
    clock.stamp("3s (text and recurrent)")
    # phase 3t: the model loaders and the two image mains
    load_report, more = loaders_and_mains(device, card)
    cnn_launches.update(more)
    log("loaders and image mains: " + json.dumps(load_report))
    clock.stamp("3t (loaders and image mains)")
    # phase 3u: record-file training and the conv nets' mains
    record_report, more = record_file_mains(device, card)
    cnn_launches.update(more)
    log("record-file training and mains: " + json.dumps(record_report))
    clock.stamp("3u (record-file training and the mains)")
    # phase 3v: the native host helpers and the sharded feed
    sharded_report, more, shard_folder = sharded_feed(device, card,
                                                      record_report)
    cnn_launches.update(more)
    log("native helpers and the sharded feed: " + json.dumps(sharded_report))
    clock.stamp("3v (native helpers and the sharded feed)")
    # phase 3w: the run ledger and what reads it, on the paths above
    obs_report, more, obs_lm = observability(device, card, shard_folder,
                                             cg_run)
    cnn_launches.update(more)
    lm_launches.update(obs_lm)
    log("run ledger and observability: " + json.dumps(obs_report))
    clock.stamp("3w (the run ledger, watchdog, trace and live metrics)")
    # phase 3x: the trainer's and serving's fault sites, the drill, benches
    fault_report, more, fault_lm = faults_and_benches(device, card)
    cnn_launches.update(more)
    lm_launches.update(fault_lm)
    log("fault sites, serve-drill, bench-serve and bench-infer: "
        + json.dumps(fault_report))
    clock.stamp("3x (fault sites, serve-drill, bench-serve, bench-infer)")
    # phase 3y: the multi-tenant fleet, its drill phase and its bench
    fleet_report, cnn_launches["fleet"] = fleet_serving(device, card)
    log("multi-tenant fleet: " + json.dumps(fleet_report))
    clock.stamp("3y (the multi-tenant fleet)")
    # phase 4
    main_pool_times = time_main_pools(device, card)
    text_times = time_text_pools(device, card)
    rcnn_times = time_rcnn_pools(device, card)
    harness_times = time_harness_kernels(device)
    for key, tt in harness_times.items():
        for kname, t in tt.items():
            log_pool_times(card, f"{key} {kname} ({HARNESS_TIMES[kname]}, "
                           f"batch {HARNESS_BATCH})", t,
                           "LRN layers" if kname.startswith("lrn")
                           else "pools")
    cnn_times = {
        key: time_cnn(card, device, what, (cnn[key][0], cnn[key][1], build,
                                           recipe), pools)
        for key, what, build, recipe, pools in (
            ("resnet50", "ResNet-50", resnet50, resnet_recipe, RESNET_POOLS),
            ("inception_v2", "Inception-v2", inception_v2, inception_recipe,
             V2_POOLS))}
    for key in cnn:
        log(f"{key} serving: " + json.dumps(cnn[key][0]))
        log(f"{key} training: " + json.dumps(cnn[key][1]))
    log(f"[{card}] CIFAR-10 ResNet-20 train step (f32, batch {CIFAR_BATCH}, "
        f"median after the first of {CIFAR_STEPS}): "
        f"{cifar_report['step_ms']:.3f} ms "
        f"({cifar_report['images_per_s']:.1f} images/s)")
    log("cifar_resnet20 training: " + json.dumps(cifar_report))
    clock.stamp("4 (pools at the text, Fast R-CNN, harness and CNN shapes)")
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
    qreport["f32"].update(time_quantized_f32(card, qclf_f32, device))
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
    clock.stamp("4 (K1-K4, forwards, quantized products, train steps)")
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
    clock.stamp("4 (attention and LM)")
    paged_times = time_paged(device)
    for key, t in paged_times.items():
        pl = t["plan"]
        log(f"[{card}] paged_attention at {t['case']} {t['shape']} (bf16, "
            f"per call, {pl['path']} path: {pl['rows_per_block']} packed "
            f"rows a block, {pl['row_tiles']} row tiles, {pl['splits']} "
            f"splits of {pl['pages_per_split']} pages; {t['blocks']} blocks, "
            f"{t['blocks_with_visible_keys']} with visible keys): "
            f"{t['ms']:.4f} ms, device {fmt_ms(t['device_ms'])}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; bytes "
            f"{t['bytes_ms']:.4f}, operations {t['ops_ms']:.4f}), plain "
            f"{t['plain_ms']:.3f} ms, SDPA on the pre-gathered view "
            f"{t['library_ms']:.4f} ms, device "
            f"{fmt_ms(t['library_device_ms'])}")
    if paged_times["decode"]["blocks_with_visible_keys"] < \
            torch.cuda.get_device_properties(0).multi_processor_count:
        fail("paged_attention's plan at the decode shape puts fewer blocks "
             "with visible keys than the card has SMs")
    park = time_park_resume(device)
    sess_report["park_resume"] = park
    log(f"[{card}] park and resume of a {park['pages']}-page session "
        f"({park['bytes']} B over {LM_LAYERS} layers' bf16 K and V, "
        f"median of {TIMING_REPS}): gather {park['gather']:.4f} ms, D2H "
        f"copy {park['d2h']:.4f} ms ({park['d2h_gb_s']:.2f} GB/s), H2D copy "
        f"{park['h2d']:.4f} ms ({park['h2d_gb_s']:.2f} GB/s), in-place "
        f"write {park['write']:.4f} ms; the host link "
        f"{park['host_link_gb_s']:.0f} GB/s a direction bounds each copy at "
        f"{park['link_bound_ms']:.4f} ms; a park whole "
        f"{park['park']:.4f} ms, a resume whole {park['resume']:.4f} ms "
        "(host clock)")
    log("sessions: " + json.dumps(sess_report))
    clock.stamp("4 (paged attention, park and resume)")
    cg_prof, cg_static = time_continuous(*cg_run, device)
    cg_prof["busy_share"] = cg_prof["device_ms"] / (1e3 * cg_report["wall_s"])
    cg_report.update(profile=cg_prof, static_waves=cg_static)
    k12 = cg_prof["groups"]
    log(f"[{card}] continuous serving, K12's device time over the profiled "
        f"run: {sum(k12.values()):.3f} ms (tensor-core path "
        f"{k12['tensor_core']:.3f}, page split {k12['split']:.3f}, its "
        f"combine {k12['combine']:.3f}) of {cg_prof['device_ms']:.3f} ms")
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
    clock.stamp("4 (continuous serving)")
    lm_quant_rungs, lm_quant_times = time_lm_quant(device)
    for mode, t in lm_quant_rungs.items():
        log(f"[{card}] {mode} kernels over one LM decode step ({t['calls']} "
            f"products at M {CG_SLOTS}, float32): events {t['ms']:.4f} ms, "
            f"device {fmt_ms(t['device_ms'])}, wrapper host "
            f"{t['host_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}; bytes {t['bytes_ms']:.4f}, operations "
            f"{t['ops_ms']:.4f}), plain {fmt_ms(t['plain_ms'])}, library "
            f"(F.linear on the widened weight"
            f"{'; torch._int_mm + scale at K14' if mode == 'w8a8' else ''}) "
            f"events {fmt_ms(t['library_ms'])}, device "
            f"{fmt_ms(t['library_device_ms'])}")
    qcg_report["decode_step_kernels"] = lm_quant_rungs
    log("quantized continuous serving: " + json.dumps(qcg_report))
    log("speculative continuous serving: " + json.dumps(spec_report))
    clock.stamp("4 (the packed LM's decode step)")
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
    clock.stamp("4 (flash attention)")
    codec_times = time_codec(device)
    for name, t in codec_times.items():
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"[{card}] {name} at {CODEC_N} elements (per call): "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes), plain "
            f"{t['plain_ms']:.4f} ms, library {lib} ms")
    codec_report["kernel_times"] = codec_times
    log("fp16 codec: " + json.dumps(codec_report))
    log("transformer LM training: " + json.dumps(long_report))
    log_pool_times(card, "max_pool2d_fwd (f32, no index, serving)",
                   times["max_pool2d_fwd"])
    log_pool_times(card, "max_pool2d_fwd (bf16 with index, training)",
                   train_times["max_pool2d_fwd"])
    log_pool_times(card, "max_pool2d_bwd (bf16, training)",
                   train_times["max_pool2d_bwd"])
    log_pool_times(card, "lrn_fwd (f32, no scale, serving)",
                   times["lrn_fwd"], "LRN layers")
    log_pool_times(card, "lrn_fwd (bf16 with scale, training)",
                   train_times["lrn_fwd"], "LRN layers")
    log_pool_times(card, "lrn_bwd (bf16, training)", train_times["lrn_bwd"],
                   "LRN layers")
    for where, tt in (("serving shapes, f32", times),
                      ("training shapes, bf16", train_times)):
        for name, t in tt.items():
            log(f"[{card}] {name} ({where}, per step): {t['ms']:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
                f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.4f} ms")
    clock.stamp("4 (codec and the pool and LRN logs)")
    kernels = []
    for k in KERNELS:
        name, wrapper = k["name"], k["wrapper"]
        by_path = {"serve": serve_launches[wrapper],
                   "train": train_launches[wrapper]}
        by_path.update({p: v[wrapper] for p, v in quant_launches.items()})
        by_path.update({p: v[wrapper] for p, v in lm_launches.items()})
        by_path.update({p: v[wrapper] for p, v in cnn_launches.items()})
        entry = {"name": name, "route": k["route"], "source": k["source"],
                 "replaces": k["replaces"],
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": errs[name], "match": misses[name] == 0,
                 "cases": cases[name], "mismatches": misses[name]}
        if name in times:        # forward kernels: serving shapes, f32
            entry.update({key: times[name][key] for key in TIME_KEYS})
            if "device_ms" in times[name]:
                entry.update({key: times[name][key] for key in (
                    "device_ms", "library_device_ms", "per_layer")})
            entry["train"] = dict(train_times[name], dtype="bfloat16")
            for key, (cnn_fwd, cnn_train) in cnn_times.items():
                if name in cnn_fwd:     # K1 at ResNet-50's, Inception-v2's
                    entry[key] = {"serve_f32": cnn_fwd[name],
                                  "train_bf16": cnn_train[name]}
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
            first = flash_times[FLASH_PATH[0][0]]
            entry.update({k2: first[wrapper][k2] for k2 in TIME_KEYS})
            entry["shape"], entry["dtype"] = first["shape"], first["dtype"]
            for c in FLASH_PATH[1:] + FLASH_TIMED:
                t = flash_times[c[0]]
                entry[c[0]] = dict(t[wrapper], shape=t["shape"],
                                   dtype=t["dtype"])
        elif wrapper == "paged_attention":
            # per call at the continuous path's decode shape (the page
            # split), bf16; the prefill shapes (the tensor-core path) beside
            entry.update({k2: paged_times["decode"][k2] for k2 in TIME_KEYS +
                          ("device_ms", "library_device_ms")})
            entry["shape"] = paged_times["decode"]["shape"]
            entry["paths"] = {
                "split": {"decode": paged_times["decode"],
                          "verify": paged_times["verify"]},
                "tensor_core": {k2: paged_times[k2]
                                for k2 in ("prefill_512", "prefill_128",
                                           "continuation")}}
            entry["continuous_device_ms"] = cg_prof["groups"]
        elif name in codec_times:    # per call at CODEC_N elements
            entry.update({k2: codec_times[name][k2] for k2 in TIME_KEYS})
            entry["elements"] = CODEC_N
        elif name in qtimes:     # quantized: one batch-32 forward, bf16
            entry.update({key: qtimes[name][key] for key in TIME_KEYS +
                          ("device_ms", "library_device_ms", "host_ms",
                           "stages")})
            entry["calls_per_forward"] = qtimes[name]["calls"]
            if name + "_f32" in qtimes:
                entry["f32"] = {key: v for key, v in
                                qtimes[name + "_f32"].items()
                                if key != "stages"}
            if name == "a8_matmul":
                entry["buckets"] = qtimes[name]["buckets"]
            # the packed LM's decode step, f32 at M 8 (phase 3p's path)
            entry["lm_decode_step"] = lm_quant_times[wrapper]
        else:
            entry.update({key: train_times[name][key] for key in TIME_KEYS})
            if "device_ms" in train_times[name]:
                entry.update({key: train_times[name][key] for key in (
                    "device_ms", "library_device_ms", "per_layer")})
            if name == "max_pool2d_bwd":
                for key, (_, cnn_train) in cnn_times.items():
                    entry[key] = {"train_bf16": cnn_train[name]}
        if name in rcnn_times:   # K1 and K3 at the Fast R-CNN trunk's pools
            entry["fast_rcnn_f32"] = rcnn_times[name]
        if name in text_times:   # and at the text classifier's
            entry["text_classifier_f32"] = text_times[name]
        for key, tt in main_pool_times.items():   # LeNet's, VGG-CIFAR's
            if name in tt:
                entry[key] = tt[name]
        harness = {key: {kname: tt[kname] for kname in tt
                         if kname.startswith(name)}
                   for key, tt in harness_times.items()}
        if any(harness.values()):
            entry["harness"] = {k2: v for k2, v in harness.items() if v}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0



def repeat_text_phase(argv) -> int:
    """``python3 chip_smoke.py --repeat-3s-a RUNS E [E ...]``: phase 3s-a
    alone (its gates included), RUNS times at each ``-e E``, logging every
    run's Top-1 after each epoch (None where a gate failed) and the least
    last Top-1.  cuDNN's sums move the runs apart, so ``TEXT_EPOCHS`` is
    judged on 10 or more of them."""
    import torch
    if not torch.cuda.is_available() or len(argv) < 2:
        print(repeat_text_phase.__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bigdl_tpu_torch.ops import _build
    global TEXT_EPOCHS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    _build.load()
    runs = int(argv[0])
    for epochs in [int(a) for a in argv[1:]]:
        TEXT_EPOCHS = epochs
        last = []
        for r in range(runs):
            t0 = time.perf_counter()
            try:
                top1 = text_classifier(device, card)[0]["top1"]
            except SystemExit:           # a gate failed; the phase said why
                top1 = [None]
            last.append(top1[-1])
            log(f"[{card}] 3s-a at -e {epochs}, run {r}: Top-1 by epoch "
                f"{top1} ({time.perf_counter() - t0:.1f} s)")
        held = [v for v in last if v is not None]
        log(f"[{card}] 3s-a at -e {epochs}: {len(last)} runs, last Top-1 "
            f"{last}, least {min(held) if held else None}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--repeat-3s-a"]:
        sys.exit(repeat_text_phase(sys.argv[2:]))
    sys.exit(main())
