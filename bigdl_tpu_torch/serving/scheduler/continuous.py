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
place, so a failed prefill or chunk fails every live request typed,
closes every session and rebuilds the pool and the prefix cache.
Right-padded prefill is safe:
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

* **Sessions** (``submit(..., session=)``, :meth:`~ContinuousGenerator.
  park`, :meth:`~ContinuousGenerator.close_session`; paged only, no draft):
  a finished turn keeps its KV up to ``kv_pos`` (the last emitted token's
  K/V is never written, so ``kv_pos == len(history) - 1``), frees the
  tail pages its ``max_new`` headroom took, and its prefix pins pass to the
  session; the next turn prefills only ``history[kv_pos:] + prompt`` from
  ``start = kv_pos``.  Parking gathers an idle session's private pages on
  the device, copies each layer's K and V to host RAM in one synchronous
  copy (:class:`~.paging.HostOffloadTier`) and frees their ids; a resume
  writes them into fresh ids in place, so a resumed session equals one
  that never parked.  Shared prefix pages are never parked: a neighbour
  may be reading them.
* **Memory budget** (``budgeter=``, ``budget_tenant=``): every page the
  generator allocates is charged to a :class:`~.membudget.MemoryBudgeter`
  (``kv_pages``; published pages move to ``prefix_pages``, parked ones to
  ``host_offload``).  A request whose worst-case pages exceed the tenant's
  whole budget sheds ``MemoryBudgetError`` at ``submit()``; placement under
  page or byte pressure runs the ladder (the budgeter's reclaimers,
  prefix-cache leaves, then idle resident sessions, least recently used
  first) and holds back what still does not fit.

Run ledger (``bigdl_tpu_torch.observability``): the worker writes
``run.start``/``run.end``, ``serve.warmup``/``serve.prefill``/
``serve.decode`` spans, ``serve.request``, ``serve.cache``,
``serve.slots``, ``serve.spec`` and ``serve.shed`` records, the session
lifecycle's ``mem.offload`` records and, through the budgeter,
``mem.budget``; ``ledger_tags`` (``{"tenant": name}`` for a fleet's
tenant) is merged into every one of them.  ``serve.decode`` closes after
the chunk's tokens reach the host, so on the card it spans the chunk's
device time.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.core.device import resolve_device
from bigdl_tpu_torch.observability import ledger as run_ledger
from bigdl_tpu_torch.observability import tracer
from bigdl_tpu_torch.observability.report import _percentile
from bigdl_tpu_torch.ops import quant
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.serving.errors import (DrainingError, InvalidRequestError,
                                            MemoryBudgetError,
                                            QueueFullError,
                                            SlotCapacityError)
from bigdl_tpu_torch.serving.queue import AdmissionQueue
from bigdl_tpu_torch.serving.scheduler.buckets import BucketLadder
from bigdl_tpu_torch.serving.scheduler.paging import (HostOffloadTier,
                                                      PageAllocator,
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
                 "t_submit", "slot", "tokens", "counted", "session")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 session: Optional[str] = None):
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
        self.session = session          # multi-turn session id


class Session:
    """One multi-turn session: the KV of its earlier turns stays between
    turns, so a continuing turn prefills only ``tokens[kv_pos:]`` and its
    new prompt, from ``start = kv_pos``.

    States: ``new`` (no KV yet), ``active`` (a turn holds a slot),
    ``resident`` (idle, private pages on the device), ``parked`` (idle,
    private pages in the host tier, their ids freed).  The session keeps
    its prefix-chain pins in every state.  ``row`` is the page-table prefix
    for positions ``[0, kv_pos)``, shared head first; ``pages`` its private
    tail, what a park moves and a close frees.  The scheduler thread
    mutates it; ``submit`` reads ``tokens`` and flips ``busy`` under the
    generator's lock."""

    __slots__ = ("sid", "tokens", "kv_pos", "row", "pages", "keys",
                 "state", "busy", "last_used")

    def __init__(self, sid: str):
        self.sid = sid
        self.tokens: List[int] = []     # the whole history, 1-based
        self.kv_pos = 0                 # cache positions held
        self.row = np.zeros(0, np.int32)  # page ids of [0, kv_pos)
        self.pages: List[int] = []      # private page ids on the device
        self.keys: List[str] = []       # pinned prefix-chain keys
        self.state = "new"
        self.busy = False               # a turn is queued or decoding
        self.last_used = time.monotonic()


class _Control:
    """A park or close command for the scheduler thread.  It rides the
    admission queue (FIFO with the requests, and it wakes an idle worker),
    so the one thread that owns the page table runs it; ``deadline``,
    ``priority`` and ``t_submit`` are the queue's duck fields."""

    __slots__ = ("op", "sid", "future", "deadline", "priority",
                 "t_submit")

    def __init__(self, op: str, sid: str):
        self.op = op
        self.sid = sid
        self.future: Future = Future()
        self.deadline = None
        self.priority = 0
        self.t_submit = time.monotonic()


def gather_pages(cache, ids: Sequence[int]):
    """Host copies of pages ``ids`` of every layer's K and V pool: one
    gather on the device, then one synchronous copy of it (the ids may be
    handed out again as soon as this returns)."""
    idx = torch.tensor(list(ids), dtype=torch.long,
                       device=cache[0]["k"].device)
    return [{side: c[side][idx].cpu() for side in ("k", "v")}
            for c in cache]


def scatter_pages(cache, ids: Sequence[int], payload) -> None:
    """Write :func:`gather_pages`' ``payload`` into pages ``ids`` of every
    layer's pools, in place (the pools stay the tensors the kernels read)."""
    idx = torch.tensor(list(ids), dtype=torch.long,
                       device=cache[0]["k"].device)
    for c, pl in zip(cache, payload):
        for side in ("k", "v"):
            c[side].index_copy_(0, idx, pl[side].to(c[side].device))


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

    ``budgeter``/``budget_tenant`` charge every page to a
    :class:`~.membudget.MemoryBudgeter` under the tenant name
    ``budget_tenant`` (default: the ``ledger_tags`` tenant, else
    ``"default"``); ``submit(..., session=)`` names a multi-turn session
    (module doc).

    ``ledger_tags``: extra fields merged into every ledger record this
    generator writes (``run.start``/``run.end``, ``serve.request``,
    ``serve.shed``, ``serve.slots``, ``mem.offload``, ...), so a run
    directory holding several tenants stays attributable per tenant.
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
                 spec_k: int = 4, budgeter=None,
                 budget_tenant: Optional[str] = None,
                 ledger_tags: Optional[dict] = None, device="cuda"):
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
        self._tags = dict(ledger_tags or {})
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
            quant.emit_param_bytes(model, kind="ContinuousGenerator",
                                   mode=qmode, **self._tags)
        self.quantize = qmode
        self.model = model
        self._draft = None
        if draft_model is not None:
            draft_model.to(self.device)
            self._draft = draft_model.evaluate()
            if dmode is not None:
                self._draft = quant.quantize_model(self._draft, dmode,
                                                   extra_keys=("tok",))
                quant.emit_param_bytes(self._draft,
                                       kind="ContinuousGenerator.draft",
                                       mode="w8")
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
            self._offload = HostOffloadTier()
            pool_tokens = self._alloc.capacity_tokens
        else:
            if prefix_cache:
                raise ValueError("prefix_cache requires paged=True (shared "
                                 "pages need the page table)")
            self._alloc = self._prefix = self._offload = None
            pool_tokens = None
        self._sessions: "dict[str, Session]" = {}
        self._lock = threading.Lock()        # guards _sessions and busy
        # the pool itself is not charged: budgets size what is used, and
        # parking exists so that use can exceed the pool
        self._budget = budgeter
        self._bt = budget_tenant or self._tags.get("tenant", "default")
        if paged_kernel and not self._paged:
            raise ValueError("paged_kernel requires paged=True (the kernel "
                             "reads through the page table)")
        if paged_kernel is None:
            paged_kernel = self._paged and self.device.type == "cuda"
        self._paged_kernel = bool(paged_kernel)
        self._pending: Optional[GenRequest] = None
        self.slots = SlotManager(n, self.max_len, self.seq_ladder.max,
                                 pool_tokens=pool_tokens)

        self.metrics = Metrics()
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
        with tracer.span("serve.warmup", buckets=list(self.seq_ladder),
                         slots=self.slots.num_slots, paged=self._paged):
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
        if run_ledger.enabled():
            run_ledger.emit("run.start", kind="ContinuousGenerator",
                            pid=os.getpid(),
                            thread=threading.get_ident(),
                            trace=run_ledger.trace_id(),
                            slots=self.slots.num_slots,
                            max_len=self.max_len,
                            seq_buckets=list(self.seq_ladder),
                            steps_per_sync=self.steps_per_sync,
                            quantize=self.quantize,
                            paged=self._paged,
                            paged_kernel=self._paged_kernel,
                            page_size=(self._alloc.page_size
                                       if self._paged else None),
                            num_pages=(self._alloc.num_pages
                                       if self._paged else None),
                            prefix_cache=self._prefix is not None,
                            speculative=self._draft is not None,
                            spec_k=(self.spec_k if self._draft is not None
                                    else None),
                            **self._tags)
        t0 = time.monotonic()
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
                    if isinstance(req, _Control):
                        self._control(req)
                        continue
                    self._place(req)
                    continue
                if self._draft is not None:
                    self._spec_chunk()
                else:
                    self._plain_chunk()
            except BaseException:                # the worker must not die
                logger.exception("continuous generator: unexpected error")
                self._fail_all_and_recover()
        self._run_end(time.monotonic() - t0)

    def _fail_all_and_recover(self) -> None:
        """Fail every live slot typed, then rebuild the pool (and the
        draft's cache): a failed call may have left it half written, so
        every retained session (parked ones too: their shared heads are
        gone) and the prefix cache's pages go with it, their bytes
        discharged, so the budgeter stays exact through the crash."""
        for j, r in enumerate(self._requests):
            if r is not None:
                self._evict(j, "failed")
        self._active[:] = False
        self._cache = self._new_cache()
        if self._paged:
            with self._lock:
                sessions = list(self._sessions.values())
            for sess in sessions:
                self._destroy_session(sess)
        if self._prefix is not None:
            freed = self._prefix.evict_for(self._alloc.num_pages, self._alloc)
            self._budget_sub("prefix_pages", freed * self._page_bytes)

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
        joined = not self._worker.is_alive()
        run_ledger.flush()
        return joined

    close = drain

    # -- admission -----------------------------------------------------------

    def _shed(self, exc) -> None:
        """Every synchronous rejection feeds the shed census: a
        per-reason counter and a ledger event."""
        self.metrics.incr(f"serve.shed.{exc.reason}")
        run_ledger.emit("event", kind="serve.shed", reason=exc.reason,
                        **self._tags)
        raise exc

    # -- the memory budget: no-ops without a budgeter ------------------------

    def _budget_add(self, cls: str, nbytes: int, **detail) -> None:
        if self._budget is not None and nbytes:
            self._budget.charge(self._bt, cls, nbytes, **detail)

    def _budget_sub(self, cls: str, nbytes: int, **detail) -> None:
        if self._budget is not None and nbytes:
            self._budget.discharge(self._bt, cls, nbytes, **detail)

    def _budget_move(self, src: str, dst: str, nbytes: int,
                     **detail) -> None:
        if self._budget is not None and nbytes:
            self._budget.transfer(self._bt, src, dst, nbytes, **detail)

    def _require_budget(self, tokens: int, what: str) -> None:
        """Shed ``MemoryBudgetError`` when the pages of ``tokens`` cache
        positions exceed the tenant's whole budget."""
        if self._budget is None:
            return
        try:
            self._budget.require_possible(
                self._bt, self._alloc.pages_for(tokens) * self._page_bytes,
                what=what)
        except MemoryBudgetError as e:
            self._shed(e)

    def submit(self, prompt, max_new: int, *,
               session: Optional[str] = None) -> Future:
        """Admit one request or raise a typed shed synchronously.

        ``session`` names a multi-turn session: ``prompt`` is the new
        turn's tokens only, the generator prepends the history, and the
        turn's KV is kept when it finishes (a parked session resumes
        transparently).  One outstanding turn per session."""
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
        if session is not None:
            return self._submit_session(p.astype(np.int64), int(max_new),
                                        str(session))
        try:
            self.slots.check(p.size, max_new)
        except SlotCapacityError as e:
            self._shed(e)
        if self._paged:
            self._require_budget(p.size + max_new - 1, "request")
        req = GenRequest(p.astype(np.int64), max_new)
        try:
            self.queue.offer(req)
        except (QueueFullError, DrainingError) as e:
            self._shed(e)
        self.metrics.incr("serve.gen.submitted")
        return req.future

    def _submit_session(self, p: np.ndarray, max_new: int,
                        sid: str) -> Future:
        """The session half of :meth:`submit`: take the session's turn
        latch, build the whole prompt (history and new tokens) and run the
        capacity and budget checks on it."""
        if not self._paged:
            self._shed(InvalidRequestError(
                "sessions require paged=True (KV retention is a page-list "
                "swap)"))
        if self._draft is not None:
            self._shed(InvalidRequestError(
                "sessions are not supported with speculative decoding (the "
                "draft's row cache has no park/resume path)"))
        with self._lock:
            sess = self._sessions.get(sid)
            created = sess is None
            if created:
                sess = Session(sid)
                self._sessions[sid] = sess
            busy = sess.busy
            if not busy:
                sess.busy = True
                history = list(sess.tokens)
                kv_pos = sess.kv_pos
        if busy:
            self._shed(InvalidRequestError(
                f"session {sid!r} already has an outstanding turn (one turn "
                "at a time per session)"))
        # the latch is ours: a shed below releases it, and drops a session
        # that never held KV
        try:
            full = (np.concatenate([np.asarray(history, np.int64), p])
                    if history else p)
            total = int(full.size) + max_new
            ts = int(full.size) - kv_pos         # the prefill suffix
            try:
                if total > self.max_len:
                    raise SlotCapacityError(
                        f"session {sid!r}: history+prompt {full.size} + "
                        f"max_new {max_new} exceeds the KV-cache capacity "
                        f"{self.max_len}")
                if ts > self.slots.max_prompt:
                    raise SlotCapacityError(
                        f"session {sid!r}: turn suffix {ts} exceeds the "
                        f"largest prefill bucket {self.slots.max_prompt}")
                if total - 1 > self.slots.pool_tokens:
                    raise SlotCapacityError(
                        f"session {sid!r} needs {total - 1} cache tokens at "
                        "once but the page pool holds "
                        f"{self.slots.pool_tokens} in total")
            except SlotCapacityError as e:
                self._shed(e)
            self._require_budget(total - 1, f"session:{sid}")
            req = GenRequest(full, max_new, session=sid)
            try:
                self.queue.offer(req)
            except (QueueFullError, DrainingError) as e:
                self._shed(e)
        except BaseException:
            with self._lock:
                if self._sessions.get(sid) is sess:
                    sess.busy = False
                    if created and sess.state == "new":
                        del self._sessions[sid]
            raise
        self.metrics.incr("serve.gen.submitted")
        return req.future

    # -- session lifecycle ---------------------------------------------------

    def _command(self, op: str, sid) -> Future:
        cmd = _Control(op, str(sid))
        try:
            self.queue.offer(cmd)
        except (QueueFullError, DrainingError) as e:
            self._shed(e)
        return cmd.future

    def park(self, sid: str) -> Future:
        """Ask the scheduler to park session ``sid`` in host RAM; resolves
        True when parked, False when it was busy, unknown or parked
        already.  The command rides the admission queue, so the thread that
        owns the page table runs it: a park racing a live turn lands after
        the turn retires, or not at all.  Pressure parks idle sessions by
        itself; this is the client's explicit form."""
        return self._command("park", sid)

    def close_session(self, sid: str) -> Future:
        """Release session ``sid``'s KV (device pages or parked copy) and
        its prefix pins; resolves True when closed, False when unknown or
        mid-turn."""
        return self._command("close", sid)

    def session_info(self, sid: str) -> Optional[dict]:
        """A snapshot of one session (None when unknown)."""
        with self._lock:
            sess = self._sessions.get(str(sid))
            if sess is None:
                return None
            return {"sid": sess.sid, "state": sess.state,
                    "busy": sess.busy, "kv_pos": sess.kv_pos,
                    "tokens": len(sess.tokens),
                    "private_pages": len(sess.pages),
                    "shared_pages": len(sess.keys)}

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
                if isinstance(req, _Control):
                    self._control(req)
                    continue
            if not self._place(req):
                return                   # held back again

    # -- park and resume (the scheduler thread only) -------------------------

    def _control(self, cmd: _Control) -> None:
        """Run a park or close command on the scheduler thread."""
        try:
            if cmd.op == "park":
                out = self._park_session(cmd.sid)
            elif cmd.op == "close":
                out = self._close_session(cmd.sid)
            else:
                raise ValueError(f"unknown control op {cmd.op!r}")
            cmd.future.set_result(out)
        except Exception as e:
            try:
                cmd.future.set_exception(e)
            except Exception:            # the client cancelled
                pass

    def _park_session(self, sid: str) -> bool:
        sess = self._sessions.get(sid)
        if sess is None or sess.state != "resident" or sess.busy:
            return False             # mid-turn, unknown or parked already
        self._park(sess, reason="request")
        return True

    def _park(self, sess: Session, reason: str) -> None:
        """Copy the session's private pages to the host tier and free their
        ids; its shared prefix pages stay pinned on the device."""
        ids = sess.pages
        nbytes = len(ids) * self._page_bytes
        payload = gather_pages(self._cache, ids) if ids else []
        self._offload.park(sess.sid, payload, nbytes)
        if ids:
            self._alloc.free(ids)
        self._budget_move("kv_pages", "host_offload", nbytes,
                          sid=sess.sid)
        sess.pages = []
        sess.state = "parked"
        self.metrics.incr("serve.gen.parks")
        run_ledger.emit("mem.offload", action="park", sid=sess.sid,
                        pages=len(ids), bytes=nbytes, reason=reason,
                        kv_pos=sess.kv_pos, **self._tags)

    def _resume_into(self, sess: Session, ids: List[int]) -> None:
        """Write the parked pages into the fresh ``ids`` and re-point the
        session's row at them: contents copied verbatim, addressed through
        the table, so the session equals one that never parked."""
        payload = self._offload.resume(sess.sid)
        nbytes = len(ids) * self._page_bytes
        if ids:
            scatter_pages(self._cache, ids, payload)
        self._budget_move("host_offload", "kv_pages", nbytes,
                          sid=sess.sid)
        row = np.array(sess.row)
        row[len(sess.keys):] = ids
        sess.row = row
        sess.pages = list(ids)
        sess.state = "resident"
        sess.last_used = time.monotonic()
        self.metrics.incr("serve.gen.resumes")
        run_ledger.emit("mem.offload", action="resume", sid=sess.sid,
                        pages=len(ids), bytes=nbytes,
                        kv_pos=sess.kv_pos, **self._tags)

    def _close_session(self, sid: str) -> bool:
        sess = self._sessions.get(sid)
        if sess is None or sess.busy or sess.state == "active":
            return False
        self._destroy_session(sess)
        return True

    def _destroy_session(self, sess: Session) -> None:
        """Free what a session that holds no slot keeps: its device pages
        or parked copy, and its prefix pins.  A slot-bound session is torn
        down by :meth:`_evict`, which owns its pages then."""
        with self._lock:
            self._sessions.pop(sess.sid, None)
        if sess.state == "parked":
            self._budget_sub("host_offload", self._offload.drop(sess.sid),
                             sid=sess.sid)
        elif sess.pages:
            self._alloc.free(sess.pages)
            self._budget_sub("kv_pages", len(sess.pages) * self._page_bytes,
                             sid=sess.sid)
        if sess.keys and self._prefix is not None:
            self._prefix.release(sess.keys)
        run_ledger.emit("mem.offload", action="close", sid=sess.sid,
                        kv_pos=sess.kv_pos, **self._tags)
        sess.pages, sess.keys = [], []
        sess.state, sess.busy = "closed", False

    def _session_abort(self, req: GenRequest) -> None:
        """A turn died before retention (shed, cancel, failure): release
        the session's latch and drop a session that never held KV."""
        if req.session is None or not self._paged:
            return
        with self._lock:
            sess = self._sessions.get(req.session)
            if sess is None:
                return
            sess.busy = False
            if sess.state == "new" and not sess.tokens:
                del self._sessions[req.session]

    def _make_room(self, pages_needed: int,
                   protect: Optional[Session] = None) -> None:
        """The degradation ladder, in order: the budgeter's reclaimers
        (byte pressure only), prefix-cache leaves, then parking resident
        sessions, least recently used first (``protect``, the session being
        placed, is exempt).  It runs until ``pages_needed`` fit the free
        list and the tenant's headroom, or it is dry: the caller holds back
        or sheds."""
        alloc, prefix, pb = self._alloc, self._prefix, self._page_bytes

        def page_deficit() -> int:
            return pages_needed - alloc.free_count

        def byte_deficit() -> int:
            head = (None if self._budget is None
                    else self._budget.headroom(self._bt))
            return 0 if head is None else pages_needed * pb - int(head)

        if byte_deficit() > 0:
            self._budget.reclaim(self._bt, byte_deficit())
        need = page_deficit()
        if pb and byte_deficit() > 0:
            need = max(need, -(-byte_deficit() // pb))
        if need > 0 and prefix is not None:
            freed = prefix.evict_for(need, alloc)
            if freed:
                self._budget_sub("prefix_pages", freed * pb)
                run_ledger.emit("serve.cache", event="evict",
                                pages=freed, **self._tags)
        while page_deficit() > 0 or byte_deficit() > 0:
            # any resident session may go, one whose next turn is queued
            # too (its KV sits idle; placement resumes it), so a burst of
            # continuations cannot wedge the pool; only slot-bound ones stay
            with self._lock:
                idle = [s for s in self._sessions.values()
                        if s.state == "resident" and s is not protect]
            if not idle:
                break
            self._park(min(idle, key=lambda s: s.last_used),
                       reason="pressure")

    def _budgeted(self) -> bool:
        return self._budget is not None and \
            self._budget.headroom(self._bt) is not None

    def _starved(self, pages: int) -> bool:
        """``pages`` more device pages exceed the tenant's headroom."""
        if self._budget is None:
            return False
        head = self._budget.headroom(self._bt)
        return head is not None and pages * self._page_bytes > head

    def _shed_starved(self, req: GenRequest, pages: int, what: str) -> None:
        """Fail a byte-starved request typed when the generator is idle
        (holding it back could wedge the loop)."""
        exc: Exception
        try:
            self._budget.admit(self._bt, pages * self._page_bytes,
                               what=what, reclaim=False)
            exc = MemoryBudgetError("byte-starved at placement (budget "
                                    "headroom vanished under the check)")
        except MemoryBudgetError as e:
            exc = e
        self._session_abort(req)
        self._fail_typed(req, exc)

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
        sess: Optional[Session] = None
        if req.session is not None:
            sess = self._sessions.get(req.session)
            if sess is not None and sess.state in ("resident", "parked"):
                return self._place_continuation(req, sess, force)
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
        if alloc.free_count < priv_needed or self._budgeted():
            self._make_room(priv_needed, protect=sess)
        starved = self._starved(priv_needed)
        priv = None if starved else alloc.alloc(priv_needed)
        if priv is None:
            if slot_keys:
                prefix.release(slot_keys)
            if not force:
                self._pending = req
                return False
            if starved:
                self._shed_starved(req, priv_needed, f"rid:{req.rid}")
                return True
            self._session_abort(req)
            self._fail_typed(req, SlotCapacityError(
                f"page pool exhausted: request needs {priv_needed} pages, "
                f"{alloc.free_count} free and nothing evictable"))
            return True
        if not req.future.set_running_or_notify_cancel():
            alloc.free(priv)
            if slot_keys:
                prefix.release(slot_keys)
            self._session_abort(req)
            self.metrics.incr("serve.gen.cancelled")
            run_ledger.emit("serve.request", rid=req.rid,
                            status="cancelled",
                            dur_s=time.monotonic() - req.t_submit,
                            **self._tags)
            return True
        slot = self.slots.alloc()
        assert slot is not None, "placed with no free slot"
        self._budget_add("kv_pages", len(priv) * self._page_bytes,
                         rid=req.rid)
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
            with tracer.span("serve.prefill", slot=slot, bucket=bucket,
                             tp=tp, shared_tokens=start, rid=req.rid):
                first = self._prefill_pages(padded, ts, table_row, start)
                if self._draft is not None:
                    # the draft ingests the whole prompt, prefix hit or
                    # not: its row cache shares nothing
                    full = np.ones((1, self.seq_ladder.pick(tp)),
                                   np.int64)
                    full[0, :tp] = req.prompt
                    self._row_prefill(self._draft, self._dcache, full,
                                      slot)
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
                # the published pages' bytes follow their ownership, so
                # evict_for discharges exactly what it frees
                self._budget_move("kv_pages", "prefix_pages",
                                  len(published) * self._page_bytes)
            self.metrics.set("serve.prefix hit rate",
                             prefix.stats()["hit_rate"], unit="scalar")
            run_ledger.emit("serve.cache", event="admit", rid=req.rid,
                            lookup_pages=len(keys), hit_pages=depth,
                            shared_tokens=start,
                            inserted=max(0, len(keys) - depth),
                            **self._tags)
            self.metrics.incr("serve.gen.prefix.lookup_pages", len(keys))
            self.metrics.incr("serve.gen.prefix.hit_pages", depth)
        self._page_table[slot] = table_row
        self._slot_priv[slot] = priv
        self._slot_keys[slot] = slot_keys
        self._slot_shared[slot] = len(slot_keys) * ps
        if sess is not None:
            sess.state = "active"
            sess.last_used = time.monotonic()
        self._commit_placed(req, slot, tp, first, bucket)
        return True

    def _place_continuation(self, req: GenRequest, sess: Session,
                            force: bool) -> bool:
        """Place a session's next turn: its retained KV (resident, or
        parked and resumed first) is extended in place and only the suffix
        past ``kv_pos`` is prefilled, from ``start = kv_pos``.  The page
        holding ``kv_pos`` lies past the shared full pages, so it is the
        session's own: the extension never writes a page another reader
        holds."""
        alloc, pb = self._alloc, self._page_bytes
        tp = int(req.prompt.size)
        start = sess.kv_pos
        pages_total = alloc.pages_for(tp + req.max_new - 1)
        row_len = len(sess.row)
        new_needed = max(0, pages_total - row_len)
        resume_pages = (row_len - len(sess.keys)
                        if sess.state == "parked" else 0)
        pool_need = new_needed + resume_pages
        if alloc.free_count < pool_need or self._budgeted():
            self._make_room(pool_need, protect=sess)
        # a resume moves bytes from host_offload to kv_pages: only the new
        # pages are fresh device bytes
        starved = self._starved(new_needed)
        got = None if starved else alloc.alloc(pool_need)
        if got is None:
            if not force:
                self._pending = req
                return False
            if starved:
                self._shed_starved(req, new_needed, f"session:{sess.sid}")
                return True
            self._session_abort(req)
            self._fail_typed(req, SlotCapacityError(
                f"page pool exhausted: continuation needs {pool_need} "
                f"pages, {alloc.free_count} free and nothing evictable"))
            return True
        if not req.future.set_running_or_notify_cancel():
            alloc.free(got)
            self._session_abort(req)
            self.metrics.incr("serve.gen.cancelled")
            run_ledger.emit("serve.request", rid=req.rid,
                            status="cancelled",
                            dur_s=time.monotonic() - req.t_submit,
                            **self._tags)
            return True
        resumed, new_priv = got[:resume_pages], got[resume_pages:]
        if sess.state == "parked":
            try:
                self._resume_into(sess, resumed)
            except Exception as e:
                alloc.free(got)
                if sess.sid not in self._offload:
                    # the payload was taken before the copy failed
                    self._budget_sub("host_offload", resume_pages * pb,
                                     sid=sess.sid)
                self._destroy_session(sess)
                self._prefill_failed(req, e)
                return True
        self._budget_add("kv_pages", len(new_priv) * pb, rid=req.rid,
                         sid=sess.sid)
        slot = self.slots.alloc()
        assert slot is not None, "placed with no free slot"
        table_row = np.full(self._lp, alloc.trash, np.int32)
        table_row[:row_len] = sess.row
        table_row[row_len:pages_total] = new_priv
        ts = tp - start
        bucket = self.seq_ladder.pick(ts)
        padded = np.ones((1, bucket), np.int64)
        padded[0, :ts] = req.prompt[start:]
        try:
            with tracer.span("serve.prefill", slot=slot, bucket=bucket,
                             tp=tp, shared_tokens=start,
                             rid=req.rid, sid=sess.sid):
                first = self._prefill_pages(padded, ts, table_row, start)
        except Exception as e:
            self.slots.release(slot)
            if new_priv:
                alloc.free(new_priv)
            self._budget_sub("kv_pages", len(new_priv) * pb)
            self._destroy_session(sess)
            self._prefill_failed(req, e)
            return True
        self._page_table[slot] = table_row
        self._slot_priv[slot] = list(sess.pages) + list(new_priv)
        self._slot_keys[slot] = list(sess.keys)
        self._slot_shared[slot] = len(sess.keys) * alloc.page_size
        sess.state = "active"
        sess.last_used = time.monotonic()
        self.metrics.incr("serve.gen.continuations")
        self._commit_placed(req, slot, tp, first, bucket)
        return True

    def _place_row(self, req: GenRequest) -> None:
        """Row-slot placement (``paged=False``)."""
        if not req.future.set_running_or_notify_cancel():
            self.metrics.incr("serve.gen.cancelled")
            run_ledger.emit("serve.request", rid=req.rid,
                            status="cancelled",
                            dur_s=time.monotonic() - req.t_submit,
                            **self._tags)
            return
        slot = self.slots.alloc()
        assert slot is not None, "placed with no free slot"
        tp = int(req.prompt.size)
        bucket = self.seq_ladder.pick(tp)
        padded = np.ones((1, bucket), np.int64)
        padded[0, :tp] = req.prompt
        try:
            with tracer.span("serve.prefill", slot=slot, bucket=bucket,
                             tp=tp, rid=req.rid):
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
            self._budget_sub("kv_pages", len(priv) * self._page_bytes)
        if slot_keys:
            self._prefix.release(slot_keys)

    def _fail_typed(self, req: GenRequest, exc: Exception) -> None:
        self.metrics.incr(f"serve.shed.{getattr(exc, 'reason', 'error')}")
        run_ledger.emit("event", kind="serve.shed",
                        reason=getattr(exc, "reason", "error"),
                        **self._tags)
        try:
            req.future.set_exception(exc)
        except Exception:                # the client cancelled
            pass
        run_ledger.emit("serve.request", rid=req.rid, status="failed",
                        tokens=0, dur_s=time.monotonic() - req.t_submit,
                        **self._tags)

    def _prefill_failed(self, req: GenRequest, e: Exception) -> None:
        """A failed prefill may have written the pool half way: fail the
        live requests typed and rebuild it, then fail this request."""
        self._fail_all_and_recover()
        self._session_abort(req)
        self.metrics.incr("serve.gen.failed")
        try:
            req.future.set_exception(RuntimeError(
                f"prefill failed: {type(e).__name__}: {e}"))
        except Exception:                # the client cancelled
            pass
        run_ledger.emit("serve.request", rid=req.rid,
                        status="failed", tokens=0,
                        dur_s=time.monotonic() - req.t_submit,
                        **self._tags)

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
        k = self.spec_k
        with tracer.span("serve.decode", chunk=self._chunks,
                         active=n_active, steps=1, spec_k=k):
            drafts, greedy = self._run_round()
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
        total = self.metrics.get("serve.gen.spec.proposed")
        self.metrics.set("serve.draft accept rate",
                         self.metrics.get("serve.gen.spec.accepted") / total
                         if total else 0.0, unit="scalar")
        run_ledger.emit("serve.spec", chunk=self._chunks,
                        proposed=proposed, accepted=accepted,
                        emitted=chunk_tokens, **self._tags)
        self._account_chunk(n_active, chunk_tokens, 1)

    def _plain_chunk(self) -> None:
        n_active = int(self._active.sum())
        with tracer.span("serve.decode", chunk=self._chunks,
                         active=n_active, steps=self.steps_per_sync):
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
        occ = n_active / self.slots.num_slots
        self._emitted += chunk_tokens
        self._chunks += 1
        self._occupancy_sum += occ
        self.metrics.incr("serve.gen.steps", steps)
        self.metrics.set("serve.slot occupancy", occ, unit="scalar")
        run_ledger.emit("serve.slots", chunk=self._chunks,
                        active=n_active, slots=self.slots.num_slots,
                        occupancy=occ, tokens=chunk_tokens,
                        **self._tags)
        if self._paged:
            # tokens held, each shared page once: every slot's private
            # positions, the prefix cache's pages and the private positions
            # of idle resident sessions
            ps = self._alloc.page_size
            held = sum(int(self._pos[j]) - self._slot_shared[j]
                       for j, r in enumerate(self._requests)
                       if r is not None)
            if self._prefix is not None:
                held += self._prefix.held_pages * ps
            with self._lock:
                held += sum(s.kv_pos - len(s.keys) * ps
                            for s in self._sessions.values()
                            if s.state == "resident")
            cap = self._alloc.capacity_tokens
            tocc = held / cap
            self._token_occupancy_sum += tocc
            self.metrics.set("serve.token occupancy", tocc, unit="scalar")
            run_ledger.emit(
                "serve.pages", chunk=self._chunks, tokens_held=held,
                capacity_tokens=cap, token_occupancy=tocc,
                pages_used=self._alloc.used_count,
                pages_total=self._alloc.num_pages,
                prefix_pages=(self._prefix.held_pages
                              if self._prefix is not None else 0),
                **self._tags)

    def _evict(self, slot: int, status: str) -> None:
        """Finish the request in ``slot`` and free the slot: private pages
        go back to the allocator, shared prefix pages lose one reader.  A
        session's finished turn keeps its KV instead (module doc); a failed
        one tears the session down."""
        req = self._requests[slot]
        self._requests[slot] = None
        self._active[slot] = False
        self.slots.release(slot)
        if self._paged:
            sess = (self._sessions.get(req.session)
                    if req.session is not None else None)
            if sess is not None and status == "ok":
                self._retain(sess, req, slot)
            else:
                if self._slot_keys[slot]:
                    self._prefix.release(self._slot_keys[slot])
                if self._slot_priv[slot]:
                    self._alloc.free(self._slot_priv[slot])
                    self._budget_sub(
                        "kv_pages",
                        len(self._slot_priv[slot]) * self._page_bytes)
                if sess is not None:
                    # the KV past kv_pos is lost with the turn
                    with self._lock:
                        self._sessions.pop(sess.sid, None)
                        sess.busy = False
                    sess.pages, sess.keys = [], []
                    sess.state = "closed"
            self._slot_keys[slot] = []
            self._slot_priv[slot] = []
            self._slot_shared[slot] = 0
            self._page_table[slot, :] = self._alloc.trash
        dur = time.monotonic() - req.t_submit
        if status == "ok":
            try:
                req.future.set_result(
                    np.asarray(req.tokens[:req.max_new], np.int64))
            except Exception:            # the client cancelled
                status = "cancelled"
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
                status = "cancelled"
            self.metrics.incr("serve.gen.failed")
        run_ledger.emit("serve.request", rid=req.rid, status=status,
                        dur_s=dur, tokens=len(req.tokens), slot=slot,
                        **self._tags)

    def _run_end(self, wall_s: float) -> None:
        led = run_ledger.get_ledger()
        if led is None:
            return
        proposed = self._counter("serve.gen.spec.proposed")
        run_ledger.emit(
            "run.end", kind="ContinuousGenerator", pid=os.getpid(),
            wall_s=wall_s, chunks=self._chunks,
            completed=self._completed, tokens=self._emitted,
            mean_occupancy=(self._occupancy_sum / self._chunks
                            if self._chunks else 0.0),
            mean_token_occupancy=(
                self._token_occupancy_sum / self._chunks
                if self._paged and self._chunks else None),
            prefix_hit_rate=(self._prefix.stats()["hit_rate"]
                             if self._prefix is not None else None),
            draft_accept_rate=(
                self._counter("serve.gen.spec.accepted") / proposed
                if proposed else None),
            **self._tags)
        from bigdl_tpu_torch.observability.prometheus import \
            write_prometheus
        write_prometheus(self.metrics,
                         os.path.join(
                             led.dir,
                             f"metrics-generate-{os.getpid()}.prom"))
        led.flush()

    def _counter(self, name: str) -> int:
        try:
            return int(self.metrics.get(name))
        except KeyError:
            return 0

    def _retain(self, sess: Session, req: GenRequest, slot: int) -> None:
        """Keep a finished turn's KV for the session: positions ``[0,
        kv_pos)`` (the last token's K/V was never written), the tail pages
        freed, the slot's prefix pins passed to the session."""
        kv_pos = int(self._pos[slot])
        keep_n = self._alloc.pages_for(kv_pos)
        priv = self._slot_priv[slot]
        cut = keep_n - len(self._slot_keys[slot])
        if priv[cut:]:
            self._alloc.free(priv[cut:])
            self._budget_sub("kv_pages", len(priv[cut:]) * self._page_bytes)
        sess.tokens = req.prompt.tolist() + list(req.tokens)
        sess.kv_pos = kv_pos
        sess.row = np.array(self._page_table[slot][:keep_n])
        sess.pages = priv[:cut]
        sess.keys = list(self._slot_keys[slot])
        sess.state = "resident"
        sess.last_used = time.monotonic()
        with self._lock:
            sess.busy = False

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._lat_lock:
            lats = sorted(self._latencies)
        chunks = self._chunks
        local, _, units = self.metrics.snapshot()
        # the event counters (the gauges are the .prom dump's)
        counters = {n: int(v) for n, (v, _p) in local.items()
                    if units.get(n) == "count"}
        out = {
            "counters": counters,
            "queue_depth": self.queue.depth,
            "slots": self.slots.num_slots,
            "active": int(self._active.sum()),
            "chunks": chunks,
            "completed": self._completed,
            "tokens": self._emitted,
            "mean_occupancy": self._occupancy_sum / chunks if chunks else 0.0,
            "latency_p50_s": _percentile(lats, 50),
            "latency_p99_s": _percentile(lats, 99),
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
            with self._lock:
                sessions = list(self._sessions.values())
            kv = {state: [s.kv_pos for s in sessions if s.state == state]
                  for state in ("active", "resident", "parked")}
            out["sessions"] = {
                "open": len(sessions),
                "active": len(kv["active"]),
                "resident": len(kv["resident"]),
                "parked": len(kv["parked"]),
                "device_tokens": sum(kv["active"]) + sum(kv["resident"]),
                "parked_tokens": sum(kv["parked"]),
                "total_tokens": sum(s.kv_pos for s in sessions),
            }
            out["offload"] = self._offload.stats()
            if self._budget is not None:
                out["budget"] = self._budget.snapshot()["tenants"].get(
                    self._bt)
        if self._draft is not None:
            proposed = counters.get("serve.gen.spec.proposed", 0)
            accepted = counters.get("serve.gen.spec.accepted", 0)
            out["spec"] = {"k": self.spec_k, "proposed": proposed,
                           "accepted": accepted,
                           "accept_rate": (accepted / proposed if proposed
                                           else 0.0)}
        return out
