"""Continuous batching for TransformerLM generation
(``bigdl_tpu/serving/scheduler/continuous.py``).

``TransformerLM.generate`` runs a batch to completion: every short request
pads the batch until the longest finishes.  Here KV-cache capacity is the
admission unit instead.  Requests are admitted into free slots between
decode chunks and evicted when they finish, so a slot never idles behind
a longer neighbour.

* **Block-paged KV** (``paged=True``, the default): the cache is a pool of
  ``page_size``-token pages behind a :class:`~.paging.PageAllocator`, and a
  slot owns a row of a host page table, so capacity is tokens held, not
  ``num_slots x max_len`` rows.  A request that can never fit the pool
  sheds typed (``SlotCapacityError``) at ``submit()``; one that cannot fit
  yet is held back and placed when pages free up (FIFO).
* **Prefix cache** (``prefix_cache``, on under paging by default): the full
  pages of a prompt are published read-only under a chained content hash
  (:class:`~.paging.PrefixCache`); a later request with the same head
  attaches them and prefills only its suffix.  Its writes start at the end
  of the shared head, in its own pages: copy-on-write by construction.
* **The read path**: ``paged_kernel`` (default: on for a CUDA device)
  runs every decode step through ``TransformerLM.decode_pages``, whose
  attention is K12 (``ops/attention.py`` ``paged_attention``);
  ``paged_kernel=False`` gathers each row's pages into a contiguous view
  once per chunk, runs the chunk's steps through ``decode_slots`` and
  scatters the touched pages back (the reference's CPU default).  Prefill
  goes through ``decode_pages`` either way.  ``paged=False`` keeps one
  cache row per slot.

A chunk is ``steps_per_sync`` decode steps over all slots, a Python loop on
the device with one host sync at its end (the reference's ``lax.scan``);
the page table is uploaded once per chunk.  One worker thread owns the
pool, the page table and the device work; ``submit`` runs on the caller's
thread and only touches the admission queue.  The pool is written in
place, so a failed prefill or chunk fails every live request typed and
rebuilds the pool and the prefix cache.  Right-padded prefill is safe:
garbage K/V past a prompt's real length is hidden by the validity mask
(``l <= pos``) and overwritten the step it would become visible.

* **Quantized serving** (``quantize=``): prefill and decode run a private
  packed copy of the model (``quant.quantize_model(..., extra_keys=
  ("tok",))``: the projections on K13, K14 or K15 by rung, the tied table
  gathered packed); ``"w8a8"`` first runs ``calibration_prompts`` through
  the fp model once to fix the activation scales.  The caller's model keeps
  its fp weights.
* **Speculative decoding** (``draft_model=``, greedy only, paged only): a
  round is ``spec_k + 1`` greedy draft steps through the draft's own row
  cache (the extra step writes the last proposal's K/V, so a full-accept
  round leaves no hole), then one target verify pass through
  ``decode_pages`` with every slot expanded into ``spec_k + 1`` rows at
  S = 1 (its page table repeated, positions ``pos + i``), then the host's
  accept walk: the matched prefix plus the target's own next token, the
  limit and ``eos_id`` replayed token by token.  The output is the target's
  greedy path.  A rejected proposal's K/V lie past the accepted frontier,
  hidden until the round that overwrites them.

Left for later slices: sessions (``session``/``park``/``close_session``),
the memory ``budgeter`` and ``ledger_tags``.
"""

from __future__ import annotations

import collections
import itertools
import logging
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.ops import quant
from bigdl_tpu_torch.serving.counters import Counters, percentile
from bigdl_tpu_torch.serving.errors import (DrainingError, InvalidRequestError,
                                            QueueFullError,
                                            SlotCapacityError)
from bigdl_tpu_torch.serving.queue import AdmissionQueue
from bigdl_tpu_torch.serving.scheduler.buckets import BucketLadder
from bigdl_tpu_torch.serving.scheduler.paging import (PageAllocator,
                                                      PrefixCache)

logger = logging.getLogger("bigdl_tpu_torch.serving")

_rids = itertools.count(1)
# request latencies kept for stats() percentiles
_LATENCY_WINDOW = 4096


class GenRequest:
    """One admitted generation request: a 1-based prompt, a token budget
    and a future resolving to the generated 1-based ids (``np.ndarray``,
    ``max_new`` long, shorter only at ``eos_id``)."""

    __slots__ = ("rid", "prompt", "max_new", "future", "deadline",
                 "t_submit", "slot", "tokens", "counted")

    def __init__(self, prompt: np.ndarray, max_new: int):
        self.rid = next(_rids)
        self.prompt = prompt
        self.max_new = int(max_new)
        self.future: Future = Future()
        self.deadline = None            # AdmissionQueue's contract
        self.t_submit = time.monotonic()
        self.slot: Optional[int] = None
        self.tokens: List[int] = []
        self.counted = False            # prefix census counted once, even
                                        # when held back and placed again


class SlotManager:
    """KV-cache slots as the admission unit, and the eager capacity check
    that keeps a request that can never fit out of the decode loop.  Under
    paging ``pool_tokens`` adds the page pool's bound."""

    def __init__(self, num_slots: int, max_len: int, max_prompt: int,
                 pool_tokens: Optional[int] = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.max_prompt = int(max_prompt)
        self.pool_tokens = None if pool_tokens is None else int(pool_tokens)
        self._free = list(range(num_slots - 1, -1, -1))  # pop(): slot 0

    def check(self, prompt_len: int, max_new: int) -> None:
        """Typed shed for a request that can never fit."""
        if prompt_len + max_new > self.max_len:
            raise SlotCapacityError(
                f"prompt {prompt_len} + max_new {max_new} exceeds the "
                f"KV-cache capacity {self.max_len}: admitting it would "
                "overrun the cache — shed eagerly instead")
        if prompt_len > self.max_prompt:
            raise SlotCapacityError(
                f"prompt {prompt_len} exceeds the largest prefill bucket "
                f"{self.max_prompt}")
        if self.pool_tokens is not None \
                and prompt_len + max_new - 1 > self.pool_tokens:
            raise SlotCapacityError(
                f"prompt {prompt_len} + max_new {max_new} needs "
                f"{prompt_len + max_new - 1} cache tokens but the page pool "
                f"holds {self.pool_tokens} in total")

    def alloc(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        self._free.append(slot)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.num_slots - len(self._free)


class ContinuousGenerator:
    """Continuous-batching front for ``TransformerLM`` generation on
    ``device`` (CUDA by default; the model moves there, and a CUDA device
    without CUDA raises).

    ``submit(prompt, max_new)`` raises a typed shed (``QueueFullError``,
    ``DrainingError``, ``SlotCapacityError``, ``InvalidRequestError``) or
    returns a future of the generated 1-based ids.  Greedy by default;
    ``temperature > 0`` samples from ``generator``, a ``torch.Generator``
    on ``device`` (JAX's key stream cannot be matched: sampled outputs
    agree with the reference only in distribution).  ``warmup`` runs every
    prefill rung and one decode chunk against an all-trash page table in
    the worker thread before the first request, so the kernel build and
    each rung's first run land in no request's latency.  Use as a context
    manager or call :meth:`drain`.

    ``quantize``: ``"w8"``/``"int8"``, ``"w8a8"`` (with
    ``calibration_prompts``, a few token-id prompts), ``"w4"``/``"int4"``
    or ``"f8"``/``"fp8"`` serves a packed copy (module doc); the rung is
    ``self.quantize``.  ``draft_model``/``draft_quantize``/``spec_k`` arm
    speculative decoding: the draft shares the target's vocab,
    ``draft_quantize="w8"`` packs it int8, and a round proposes ``spec_k``
    tokens; ``stats()["spec"]`` counts what was proposed and accepted.
    """

    def __init__(self, model, *, num_slots: int = 4,
                 max_len: Optional[int] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 steps_per_sync: int = 4, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None, queue_capacity: int = 256,
                 cache_dtype=None, warmup: bool = True, paged: bool = True,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 paged_kernel: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 quantize: Optional[str] = None, calibration_prompts=None,
                 draft_model=None, draft_quantize: Optional[str] = None,
                 spec_k: int = 4, device="cuda"):
        qmode = quant.normalize_mode(quantize)
        if qmode is not None and qmode not in quant.MODES:
            raise ValueError(
                f"unsupported quantize mode {quantize!r} for generation: use "
                "'w8'/'int8', 'w8a8', 'w4'/'int4' or 'f8'/'fp8'")
        prompts = list(calibration_prompts or ())
        if qmode == "w8a8" and not prompts:
            raise ValueError(
                "quantize='w8a8' needs calibration_prompts: a few token-id "
                "prompts run through the fp model once to fix the per-tensor "
                "activation scales (weight-only quantization is 'w8')")
        self.spec_k = int(spec_k)
        dmode = self._check_draft(model, draft_model, draft_quantize, paged,
                                  paged_kernel, temperature)
        self.device = resolve_device(device)
        model.to(self.device)    # outside inference mode, as generate()
        model.evaluate()
        if qmode is not None:
            calib = quant.calibrate(model, [
                np.asarray(p, np.int64).reshape(1, -1) for p in prompts]) \
                if qmode == "w8a8" else None
            model = quant.quantize_model(model, qmode, calib=calib,
                                         extra_keys=("tok",))
        self.quantize = qmode
        self.model = model
        self._draft = None
        if draft_model is not None:
            draft_model.to(self.device)
            self._draft = draft_model.evaluate()
            if dmode is not None:
                self._draft = quant.quantize_model(self._draft, dmode,
                                                   extra_keys=("tok",))
        self.max_len = int(max_len or model.max_len)
        if model.position == "learned" and self.max_len > model.max_len:
            raise ValueError(
                f"cache length {self.max_len} exceeds the learned-position "
                f"table length {model.max_len}")
        self.seq_ladder = BucketLadder(
            seq_buckets if seq_buckets is not None else [self.max_len],
            name="seq")
        if self.seq_ladder.max > self.max_len:
            raise ValueError(f"largest seq bucket {self.seq_ladder.max} "
                             f"exceeds the cache length {self.max_len}")
        self.steps_per_sync = int(steps_per_sync)
        if self.steps_per_sync < 1:
            raise ValueError("steps_per_sync must be >= 1")
        self.temperature = float(temperature)
        if self.temperature > 0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs a generator")
        self._gen = generator
        self.eos_id = eos_id
        self._cache_dtype = cache_dtype or torch.float32

        self._paged = bool(paged)
        n = int(num_slots)
        if self._paged:
            ps = int(page_size)
            self._lp = -(-self.max_len // ps)         # page-table width
            self._alloc = PageAllocator(
                n * self._lp if num_pages is None else int(num_pages), ps)
            if prefix_cache is None:
                prefix_cache = True
            self._prefix = PrefixCache(ps) if prefix_cache else None
            self._page_table = np.full((n, self._lp), self._alloc.trash,
                                       np.int32)
            self._slot_priv: List[List[int]] = [[] for _ in range(n)]
            self._slot_keys: List[List[str]] = [[] for _ in range(n)]
            self._slot_shared = [0] * n      # shared-prefix tokens per slot
            pool_tokens = self._alloc.capacity_tokens
        else:
            if prefix_cache:
                raise ValueError("prefix_cache requires paged=True (shared "
                                 "pages need the page table)")
            self._alloc = self._prefix = None
            pool_tokens = None
        if paged_kernel and not self._paged:
            raise ValueError("paged_kernel requires paged=True (the kernel "
                             "reads through the page table)")
        if paged_kernel is None:
            paged_kernel = self._paged and self.device.type == "cuda"
        self._paged_kernel = bool(paged_kernel)
        self._pending: Optional[GenRequest] = None
        self.slots = SlotManager(n, self.max_len, self.seq_ladder.max,
                                 pool_tokens=pool_tokens)

        self.metrics = Counters()
        self._closed = False
        self.queue = AdmissionQueue(queue_capacity)
        # per-slot host state, owned by the worker thread
        self._requests: List[Optional[GenRequest]] = [None] * n
        self._tokens = np.ones(n, np.int64)
        self._pos = np.zeros(n, np.int64)
        self._active = np.zeros(n, bool)
        self._limit = np.zeros(n, np.int64)
        self._cache = None                   # built by the worker thread
        self._dcache = None                  # the draft's, likewise
        self._page_bytes = 0
        self._chunks = 0
        self._emitted = 0
        self._completed = 0
        self._occupancy_sum = 0.0
        self._token_occupancy_sum = 0.0
        self._lat_lock = threading.Lock()
        self._latencies: collections.deque = \
            collections.deque(maxlen=_LATENCY_WINDOW)

        self._ready = threading.Event()
        self._startup_error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, args=(warmup,),
                                        name="bigdl-tpu-torch-generate",
                                        daemon=True)
        self._worker.start()
        self._ready.wait()
        if self._startup_error is not None:
            self._worker.join()
            raise self._startup_error

    def _check_draft(self, model, draft, draft_quantize, paged,
                     paged_kernel, temperature):
        """The reference's ``ValueError``s for speculative decoding; returns
        the draft's rung (None or ``"w8"``)."""
        if draft is None:
            return None
        if not paged:
            raise ValueError("speculative decoding requires paged=True (the "
                             "verify pass runs through decode_pages)")
        if paged_kernel is False:
            raise ValueError("speculative decoding reads through the paged "
                             "kernel: its verify pass runs decode_pages, so "
                             "paged_kernel=False cannot hold")
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if temperature > 0:
            raise ValueError("speculative decoding is greedy-only: the accept "
                             "rule compares draft proposals against the "
                             "target model's argmax path")
        if getattr(draft, "vocab_size", None) != model.vocab_size:
            raise ValueError(
                f"draft vocab {getattr(draft, 'vocab_size', '?')} != target "
                f"vocab {model.vocab_size}: proposals would not be "
                "comparable")
        dmode = quant.normalize_mode(draft_quantize)
        if dmode not in (None, "w8"):
            raise ValueError(f"unsupported draft_quantize "
                             f"{draft_quantize!r}: use 'w8'")
        return dmode

    # -- the worker thread ---------------------------------------------------

    def _run(self, warmup: bool) -> None:
        try:
            with torch.inference_mode():
                self._cache = self._new_cache()
                if self._paged:
                    self._page_bytes = sum(
                        c[side][0].numel() * c[side].element_size()
                        for c in self._cache for side in ("k", "v"))
                if warmup:
                    self._warmup()
        except BaseException as e:           # surfaced by the constructor
            self._startup_error = e
            self._ready.set()
            return
        self._ready.set()
        with torch.inference_mode():
            self._loop()

    def _new_cache(self):
        """A zeroed pool (or row cache) and, when speculating, the draft's
        zeroed row cache of ``num_slots x max_len``."""
        if self._draft is not None:
            self._dcache = self._draft.init_cache(
                self.slots.num_slots, self.max_len, self._cache_dtype)
        if self._paged:
            return self.model.init_paged_cache(
                self._alloc.num_pages, self._alloc.page_size,
                self._cache_dtype)
        return self.model.init_cache(self.slots.num_slots, self.max_len,
                                     self._cache_dtype)

    def _warmup(self) -> None:
        """Every prefill rung (the draft's too) and one decode chunk or
        speculative round, before the first request.  Paged warmup runs
        against an all-trash table, so its writes land on the trash page
        only; row warmup (and the draft's) writes slot 0, whose next prefill
        zeroes it."""
        trash_row = (np.full(self._lp, self._alloc.trash, np.int32)
                     if self._paged else None)
        for b in self.seq_ladder:
            dummy = np.ones((1, b), np.int64)
            if self._paged:
                self._prefill_pages(dummy, 1, trash_row, 0)
            else:
                self._prefill_row(dummy, 1, 0)
            if self._draft is not None:
                self._row_prefill(self._draft, self._dcache, dummy, 0)
        if self._draft is not None:
            self._run_round()
        else:
            self._run_chunk()

    def _loop(self) -> None:
        while True:
            try:
                self._admit()
                if self.slots.active_count == 0:
                    if self._pending is not None:
                        # all idle: only the prefix cache holds pages, and
                        # a forced placement evicts it or sheds
                        req, self._pending = self._pending, None
                        self._place(req, force=True)
                        continue
                    req = self.queue.take(timeout=None)
                    if req is None:              # closed and empty
                        break
                    self._place(req)
                    continue
                if self._draft is not None:
                    self._spec_chunk()
                else:
                    self._plain_chunk()
            except BaseException:                # the worker must not die
                logger.exception("continuous generator: unexpected error")
                self._fail_all_and_recover()

    def _fail_all_and_recover(self) -> None:
        """Fail every live slot typed, then rebuild the pool (and the
        draft's cache): a failed call may have left it half written, so the
        prefix cache's pages go with it."""
        for j, r in enumerate(self._requests):
            if r is not None:
                self._evict(j, "failed")
        self._active[:] = False
        self._cache = self._new_cache()
        if self._prefix is not None:
            self._prefix.evict_for(self._alloc.num_pages, self._alloc)

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "ContinuousGenerator":
        return self

    def __exit__(self, *exc) -> None:
        self.drain()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, finish every admitted request (queued ones are
        still prefilled and decoded) and join the worker.  Idempotent."""
        self._closed = True
        self.queue.close()
        self._worker.join(timeout)
        return not self._worker.is_alive()

    close = drain

    # -- admission -----------------------------------------------------------

    def _shed(self, exc) -> None:
        self.metrics.incr(f"serve.shed.{exc.reason}")
        raise exc

    def submit(self, prompt, max_new: int) -> Future:
        """Admit one request or raise a typed shed synchronously."""
        if self._closed:
            self._shed(DrainingError("generator is draining"))
        p = np.asarray(prompt).reshape(-1)
        if p.size < 1:
            self._shed(InvalidRequestError("empty prompt"))
        if not np.issubdtype(p.dtype, np.integer) or p.min() < 1 or \
                p.max() > self.model.vocab_size:
            self._shed(InvalidRequestError(
                f"prompt ids must be integers in [1, "
                f"{self.model.vocab_size}]"))
        if max_new < 1:
            self._shed(InvalidRequestError(
                f"max_new must be >= 1, got {max_new}"))
        try:
            self.slots.check(p.size, max_new)
        except SlotCapacityError as e:
            self._shed(e)
        req = GenRequest(p.astype(np.int64), max_new)
        try:
            self.queue.offer(req)
        except (QueueFullError, DrainingError) as e:
            self._shed(e)
        self.metrics.incr("serve.gen.submitted")
        return req.future

    def generate(self, prompts, max_new: int) -> List[np.ndarray]:
        """Submit every prompt and wait for the outputs in order."""
        futs = [self.submit(p, max_new) for p in prompts]
        return [f.result() for f in futs]

    def _admit(self) -> None:
        """Fill free slots from the queue; a held-back request goes first,
        so admission stays FIFO under page pressure."""
        while self.slots.free_count > 0:
            if self._pending is not None:
                req, self._pending = self._pending, None
            else:
                req = self.queue.take(timeout=0.0)
                if req is None:
                    return
            if not self._place(req):
                return                   # held back again

    def _make_room(self, pages_needed: int) -> None:
        """Evict unreferenced prefix pages until ``pages_needed`` are free
        or nothing is evictable (the caller holds back or sheds)."""
        need = pages_needed - self._alloc.free_count
        if need > 0 and self._prefix is not None:
            self._prefix.evict_for(need, self._alloc)

    # -- placement -----------------------------------------------------------

    def _place(self, req: GenRequest, force: bool = False) -> bool:
        """Place an admitted request into a free slot.  False when the pool
        cannot fit it now (held back in ``self._pending``); True when it
        was placed, failed typed or cancelled.  ``force`` sheds instead of
        holding back, so an idle loop cannot wedge."""
        if not self._paged:
            self._place_row(req)
            return True
        alloc, prefix = self._alloc, self._prefix
        tp = int(req.prompt.size)
        ps = alloc.page_size
        pages_total = alloc.pages_for(tp + req.max_new - 1)
        # full pages only, and never the last prompt token: its logits seed
        # generation, so at least that one is prefilled
        keys: List[str] = []
        depth, shared = 0, []
        if prefix is not None:
            keys = prefix.chain_keys(req.prompt)[:(tp - 1) // ps]
            census = (prefix.lookup_pages, prefix.hit_pages)
            depth, shared = prefix.lookup(keys)
            if req.counted:                  # a held-back retry
                prefix.lookup_pages, prefix.hit_pages = census
            req.counted = True
        # pin the chain before any eviction, so the pressure below cannot
        # reclaim the pages this request is about to read
        slot_keys = list(keys[:depth])
        if slot_keys:
            prefix.acquire(slot_keys)
        priv_needed = pages_total - depth
        if alloc.free_count < priv_needed:
            self._make_room(priv_needed)
        priv = alloc.alloc(priv_needed)
        if priv is None:
            if slot_keys:
                prefix.release(slot_keys)
            if not force:
                self._pending = req
                return False
            self._fail_typed(req, SlotCapacityError(
                f"page pool exhausted: request needs {priv_needed} pages, "
                f"{alloc.free_count} free and nothing evictable"))
            return True
        if not req.future.set_running_or_notify_cancel():
            alloc.free(priv)
            if slot_keys:
                prefix.release(slot_keys)
            self.metrics.incr("serve.gen.cancelled")
            return True
        slot = self.slots.alloc()
        assert slot is not None, "placed with no free slot"
        # the slot's table row: shared prefix pages, its private pages,
        # trash beyond its allocation
        table_row = np.full(self._lp, alloc.trash, np.int32)
        table_row[:depth] = shared
        table_row[depth:pages_total] = priv
        start = depth * ps
        ts = tp - start
        bucket = self.seq_ladder.pick(ts)
        padded = np.ones((1, bucket), np.int64)
        padded[0, :ts] = req.prompt[start:]
        try:
            first = self._prefill_pages(padded, ts, table_row, start)
            if self._draft is not None:
                # the draft ingests the whole prompt, prefix hit or not:
                # its row cache shares nothing
                full = np.ones((1, self.seq_ladder.pick(tp)), np.int64)
                full[0, :tp] = req.prompt
                self._row_prefill(self._draft, self._dcache, full, slot)
        except Exception as e:
            self._release_partial(slot, priv, slot_keys)
            self._prefill_failed(req, e)
            return True
        # publish the prompt's freshly prefilled full pages: ownership
        # passes to the prefix cache, the slot stays attached as a reader
        if prefix is not None:
            if len(keys) > depth:
                prefix.insert(keys, table_row[:len(keys)].tolist(), depth)
                prefix.acquire(keys[depth:])
                published = set(table_row[depth:len(keys)].tolist())
                priv = [p for p in priv if p not in published]
                slot_keys = list(keys)
            self.metrics.incr("serve.gen.prefix.lookup_pages", len(keys))
            self.metrics.incr("serve.gen.prefix.hit_pages", depth)
        self._page_table[slot] = table_row
        self._slot_priv[slot] = priv
        self._slot_keys[slot] = slot_keys
        self._slot_shared[slot] = len(slot_keys) * ps
        self._commit_placed(req, slot, tp, first, bucket)
        return True

    def _place_row(self, req: GenRequest) -> None:
        """Row-slot placement (``paged=False``)."""
        if not req.future.set_running_or_notify_cancel():
            self.metrics.incr("serve.gen.cancelled")
            return
        slot = self.slots.alloc()
        assert slot is not None, "placed with no free slot"
        tp = int(req.prompt.size)
        bucket = self.seq_ladder.pick(tp)
        padded = np.ones((1, bucket), np.int64)
        padded[0, :tp] = req.prompt
        try:
            first = self._prefill_row(padded, tp, slot)
        except Exception as e:
            self.slots.release(slot)
            self._prefill_failed(req, e)
            return
        self._commit_placed(req, slot, tp, first, bucket)

    def _pick(self, logp):
        """The next 1-based ids from log-probs (B, vocab)."""
        if self.temperature <= 0:
            return logp.argmax(dim=-1) + 1
        probs = torch.softmax(logp.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0] + 1

    def _prefill_pages(self, padded, ts: int, table_row, start: int) -> int:
        """Prefill the prompt suffix ``padded`` (1, bucket), ``ts`` tokens
        real, at positions from ``start`` through the slot's table row;
        returns the first generated id."""
        dev = self.device
        lp = self.model.decode_pages(
            torch.from_numpy(padded).to(dev), self._cache,
            torch.from_numpy(table_row[None]).to(dev),
            torch.tensor([start], device=dev),
            torch.ones(1, dtype=torch.bool, device=dev))
        return int(self._pick(lp[:, ts - 1])[0])

    def _prefill_row(self, padded, tp: int, slot: int) -> int:
        """Prefill into the zeroed cache row of ``slot``."""
        lp = self._row_prefill(self.model, self._cache, padded, slot)
        return int(self._pick(lp[:, tp - 1])[0])

    def _row_prefill(self, model, cache, padded, slot: int):
        """``model.decode`` of ``padded`` (1, bucket) from position 0 into
        row ``slot`` of a row cache, zeroed first (a local one-row prefill
        copied into the row, as the reference's); returns the log-probs."""
        rows = [{side: c[side][slot:slot + 1] for side in ("k", "v")}
                for c in cache]
        for r in rows:
            r["k"].zero_()
            r["v"].zero_()
        return model.decode(torch.from_numpy(padded).to(self.device), rows,
                            0)

    def _commit_placed(self, req: GenRequest, slot: int, tp: int,
                       first: int, bucket: int) -> None:
        req.slot = slot
        req.tokens = [first]
        self._requests[slot] = req
        self._tokens[slot] = first
        self._pos[slot] = tp
        self._limit[slot] = tp + req.max_new - 1
        self._active[slot] = True
        self.metrics.incr("serve.gen.prefills")
        self.metrics.incr(f"serve.gen.bucket.{bucket}")
        self._emitted += 1
        if req.max_new == 1 or (self.eos_id is not None
                                and first == self.eos_id):
            self._evict(slot, "ok")

    def _release_partial(self, slot: int, priv: List[int],
                         slot_keys: List[str]) -> None:
        """Undo a placement that failed before its commit: the slot, its
        fresh private pages and its prefix references all go back."""
        self.slots.release(slot)
        if priv:
            self._alloc.free(priv)
        if slot_keys:
            self._prefix.release(slot_keys)

    def _fail_typed(self, req: GenRequest, exc: Exception) -> None:
        self.metrics.incr(f"serve.shed.{getattr(exc, 'reason', 'error')}")
        try:
            req.future.set_exception(exc)
        except Exception:                # the client cancelled
            pass

    def _prefill_failed(self, req: GenRequest, e: Exception) -> None:
        """A failed prefill may have written the pool half way: fail the
        live requests typed and rebuild it, then fail this request."""
        self._fail_all_and_recover()
        self.metrics.incr("serve.gen.failed")
        try:
            req.future.set_exception(RuntimeError(
                f"prefill failed: {type(e).__name__}: {e}"))
        except Exception:                # the client cancelled
            pass

    # -- decode --------------------------------------------------------------

    def _run_chunk(self):
        """One chunk of ``steps_per_sync`` decode steps over every slot,
        from the host mirrors; returns (tok, pos, active, toks (steps, B),
        emitted (steps, B)) on the host after one sync."""
        dev = self.device
        tok, pos, active, limit = (torch.from_numpy(a).to(dev) for a in (
            self._tokens, self._pos, self._active, self._limit))
        model = self.model
        if not self._paged:
            out = self._steps(lambda t, p, a: model.decode_slots(
                t, self._cache, p, a), tok, pos, active, limit)
        elif self._paged_kernel:
            table = torch.from_numpy(self._page_table).to(dev)
            out = self._steps(lambda t, p, a: model.decode_pages(
                t, self._cache, table, p, a), tok, pos, active, limit)
        else:
            out = self._hoisted_chunk(tok, pos, active, limit)
        n = tok.shape[0]
        host = torch.cat([out[0], out[1], out[2].long(),
                          out[3].reshape(-1),
                          out[4].long().reshape(-1)]).cpu().numpy()
        steps = self.steps_per_sync
        return (host[:n], host[n:2 * n], host[2 * n:3 * n].astype(bool),
                host[3 * n:3 * n + steps * n].reshape(steps, n),
                host[3 * n + steps * n:].reshape(steps, n).astype(bool))

    def _steps(self, decode, tok, pos, active, limit):
        """``steps_per_sync`` greedy or sampled steps on the device: a slot
        emits while active and stops at its limit or at ``eos_id``."""
        toks, emitted = [], []
        for _ in range(self.steps_per_sync):
            lp = decode(tok[:, None], pos, active)
            tok = torch.where(active, self._pick(lp[:, -1]), tok)
            pos = torch.where(active, pos + 1, pos)
            emitted.append(active)
            active = active & (pos < limit)
            if self.eos_id is not None:
                active = active & (tok != self.eos_id)
            toks.append(tok)
        return tok, pos, active, torch.stack(toks), torch.stack(emitted)

    def _hoisted_chunk(self, tok, pos, active, limit):
        """``paged_kernel=False``: each layer's pages gathered into a
        contiguous per-slot view once (trash positions zeroed), the steps
        run through ``decode_slots``, and the pages the chunk wrote
        (positions ``[pos, pos + steps)``, at most ``touch_n`` logical
        pages a row) scattered back; inactive rows and pages past the
        table go to the trash page.  Shared prefix pages lie below every
        reader's first write, so they are never written back."""
        dev = self.device
        table = torch.from_numpy(self._page_table).to(dev).long()
        b, lp_w = table.shape
        psz, trash = self._alloc.page_size, self._alloc.trash
        tmask = (table == trash).repeat_interleave(psz, dim=1)[
            :, None, :, None]
        touch_n = (self.steps_per_sync - 1) // psz + 2
        touch = (pos // psz)[:, None] + torch.arange(touch_n, device=dev)
        tclip = touch.clamp(0, lp_w - 1)
        phys = torch.gather(table, 1, tclip)
        phys = torch.where((touch >= lp_w) | ~active[:, None], trash, phys)

        def to_view(pool):
            hkv, hd = pool.shape[1], pool.shape[3]
            v = pool[table].transpose(1, 2).reshape(b, hkv, lp_w * psz, hd)
            return torch.where(tmask, 0, v)

        def to_pool(pool, view):
            hkv, hd = pool.shape[1], pool.shape[3]
            idx = tclip[:, None, :, None, None].expand(b, hkv, touch_n, psz,
                                                       hd)
            sel = torch.gather(view.reshape(b, hkv, lp_w, psz, hd), 2, idx)
            pool[phys.reshape(-1)] = sel.transpose(1, 2).reshape(
                b * touch_n, hkv, psz, hd)

        views = [{side: to_view(c[side]) for side in ("k", "v")}
                 for c in self._cache]
        out = self._steps(lambda t, p, a: self.model.decode_slots(
            t, views, p, a), tok, pos, active, limit)
        for c, v in zip(self._cache, views):
            for side in ("k", "v"):
                to_pool(c[side], v[side])
        return out

    def _run_round(self):
        """The device part of one speculative round from the host mirrors:
        ``spec_k + 1`` greedy draft steps (each write gated on ``active &
        pos < max_len``), then the target's verify pass over ``num_slots x
        (spec_k + 1)`` rows at S = 1.  Returns (drafts (B, k), the
        target's picks (B, k + 1)) on the host after one sync."""
        dev, k = self.device, self.spec_k
        cur, pos, active = (torch.from_numpy(a).to(dev) for a in (
            self._tokens, self._pos, self._active))
        tok, p, proposals = cur, pos, []
        for _ in range(k + 1):
            lp = self._draft.decode_slots(tok[:, None], self._dcache, p,
                                          active & (p < self.max_len))
            tok = torch.where(active, lp[:, -1].argmax(dim=-1) + 1, tok)
            p = p + 1
            proposals.append(tok)
        drafts = torch.stack(proposals[:k], dim=1)
        b = cur.shape[0]
        table = torch.from_numpy(self._page_table).to(dev)
        lp = self.model.decode_pages(
            torch.cat([cur[:, None], drafts], dim=1).reshape(b * (k + 1), 1),
            self._cache, table.repeat_interleave(k + 1, dim=0),
            (pos[:, None] + torch.arange(k + 1, device=dev)).reshape(-1),
            active.repeat_interleave(k + 1))
        greedy = lp[:, 0].argmax(dim=-1) + 1
        host = torch.cat([drafts.reshape(-1), greedy]).cpu().numpy()
        return host[:b * k].reshape(b, k), host[b * k:].reshape(b, k + 1)

    def _spec_chunk(self) -> None:
        """One speculative round: the host accepts each slot's matched
        prefix of proposals plus the target's next token (its correction,
        or a bonus token when all matched), replaying the limit and
        ``eos_id`` rule token by token."""
        n_active = int(self._active.sum())
        drafts, greedy = self._run_round()
        k = self.spec_k
        chunk_tokens = proposed = accepted = 0
        for j, req in enumerate(self._requests):
            if req is None or not self._active[j]:
                continue
            n = 0
            while n < k and drafts[j, n] == greedy[j, n]:
                n += 1
            proposed += k
            accepted += n
            for i in range(n + 1):
                t = int(greedy[j, i])
                req.tokens.append(t)
                self._tokens[j] = t
                self._pos[j] += 1
                chunk_tokens += 1
                if self._pos[j] >= self._limit[j] or \
                        (self.eos_id is not None and t == self.eos_id):
                    self._evict(j, "ok")
                    break
        self.metrics.incr("serve.gen.spec.proposed", proposed)
        self.metrics.incr("serve.gen.spec.accepted", accepted)
        self._account_chunk(n_active, chunk_tokens, 1)

    def _plain_chunk(self) -> None:
        n_active = int(self._active.sum())
        tok, pos, active, toks, emitted = self._run_chunk()
        self._tokens, self._pos = tok, pos
        self._account_chunk(n_active, int(emitted.sum()),
                            self.steps_per_sync)
        for j, req in enumerate(self._requests):
            if req is None:
                continue
            req.tokens.extend(int(t) for t in toks[emitted[:, j], j])
            if active[j]:
                self._active[j] = True
            else:
                self._evict(j, "ok")

    def _account_chunk(self, n_active: int, chunk_tokens: int,
                       steps: int) -> None:
        self._emitted += chunk_tokens
        self._chunks += 1
        self._occupancy_sum += n_active / self.slots.num_slots
        self.metrics.incr("serve.gen.steps", steps)
        if self._paged:
            # tokens held, each shared page once: every slot's private
            # positions plus the prefix cache's pages
            held = sum(int(self._pos[j]) - self._slot_shared[j]
                       for j, r in enumerate(self._requests)
                       if r is not None)
            if self._prefix is not None:
                held += self._prefix.held_pages * self._alloc.page_size
            self._token_occupancy_sum += held / self._alloc.capacity_tokens

    def _evict(self, slot: int, status: str) -> None:
        """Finish the request in ``slot`` and free the slot: private pages
        go back to the allocator, shared prefix pages lose one reader."""
        req = self._requests[slot]
        self._requests[slot] = None
        self._active[slot] = False
        self.slots.release(slot)
        if self._paged:
            if self._slot_keys[slot]:
                self._prefix.release(self._slot_keys[slot])
            if self._slot_priv[slot]:
                self._alloc.free(self._slot_priv[slot])
            self._slot_keys[slot] = []
            self._slot_priv[slot] = []
            self._slot_shared[slot] = 0
            self._page_table[slot, :] = self._alloc.trash
        if status == "ok":
            try:
                req.future.set_result(
                    np.asarray(req.tokens[:req.max_new], np.int64))
            except Exception:            # the client cancelled
                pass
            with self._lat_lock:
                self._latencies.append(time.monotonic() - req.t_submit)
            self._completed += 1
            self.metrics.incr("serve.gen.completed")
            self.metrics.incr("serve.gen.tokens",
                              min(len(req.tokens), req.max_new))
        else:
            try:
                req.future.set_exception(RuntimeError(
                    "generation failed (see the server log)"))
            except Exception:
                pass
            self.metrics.incr("serve.gen.failed")

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._lat_lock:
            lats = sorted(self._latencies)
        chunks = self._chunks
        counters = self.metrics.snapshot()
        out = {
            "counters": counters,
            "queue_depth": self.queue.depth,
            "slots": self.slots.num_slots,
            "active": int(self._active.sum()),
            "chunks": chunks,
            "completed": self._completed,
            "tokens": self._emitted,
            "mean_occupancy": self._occupancy_sum / chunks if chunks else 0.0,
            "latency_p50_s": percentile(lats, 50),
            "latency_p99_s": percentile(lats, 99),
            "latency_max_s": lats[-1] if lats else 0.0,
            "paged": self._paged,
            "paged_kernel": self._paged_kernel,
        }
        if self._paged:
            out["pages"] = {
                "page_size": self._alloc.page_size,
                "total": self._alloc.num_pages,
                "free": self._alloc.free_count,
                "capacity_tokens": self._alloc.capacity_tokens,
                "page_bytes": self._page_bytes,
                "pool_bytes": self._alloc.num_pages * self._page_bytes,
                "mean_token_occupancy": (self._token_occupancy_sum / chunks
                                         if chunks else 0.0),
            }
            out["prefix"] = (self._prefix.stats()
                             if self._prefix is not None else None)
        if self._draft is not None:
            proposed = counters.get("serve.gen.spec.proposed", 0)
            accepted = counters.get("serve.gen.spec.accepted", 0)
            out["spec"] = {"k": self.spec_k, "proposed": proposed,
                           "accepted": accepted,
                           "accept_rate": (accepted / proposed if proposed
                                           else 0.0)}
        return out
