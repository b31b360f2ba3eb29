"""Block-paged KV-cache bookkeeping: free-list pages and prefix sharing
(``bigdl_tpu/serving/scheduler/paging.py``, host-only copy).

* :class:`PageAllocator` — a free list over ``num_pages`` fixed-size cache
  pages.  A slot owns a page list instead of a cache row, so capacity is
  tokens actually held.  Allocation is all-or-nothing, and a double free
  raises: a page returned twice could be handed to two slots at once.
* :class:`PrefixCache` — refcounted, read-only shared pages keyed by a
  chained content hash of page-aligned token prefixes.  Two prompts that
  share their first ``k * page_size`` tokens share the physical K/V pages
  of them; a reader's continuation diverges into its own private pages
  (copy-on-write by construction), and the shared pages return to the
  allocator only when no reader holds them and pressure evicts them
  (:meth:`PrefixCache.evict_for`, leaf first, least recently used first).

Host bookkeeping for the scheduler's one worker thread: no locks, no
tensors.  The device half is ``nn/attention.py`` ``apply_decode_pages``.
The reference's ``HostOffloadTier`` comes with the sessions slice.
"""

from __future__ import annotations

import hashlib
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PageAllocator:
    """Free-list allocator over ``num_pages`` fixed-size cache pages.

    Page ids are ``0 .. num_pages-1``; id ``num_pages`` is the trash page,
    the extra pool page every unallocated page-table slot points at, so a
    write past a slot's allocation (or by an inactive row) lands where no
    one reads.  It is never allocated.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free = list(range(num_pages - 1, -1, -1))  # pop(): lowest id
        self._live = [False] * num_pages

    @property
    def trash(self) -> int:
        return self.num_pages

    @property
    def capacity_tokens(self) -> int:
        return self.num_pages * self.page_size

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` cache positions (at least 1)."""
        return max(1, -(-int(tokens) // self.page_size))

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages all-or-nothing; None when the free list is
        short (the caller evicts prefix pages, holds back or sheds)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._live[p] = True
        return out

    def free(self, pages: Sequence[int]) -> None:
        """Return pages to the free list; a double free raises."""
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page id {p} out of range "
                                 f"[0, {self.num_pages})")
            if not self._live[p]:
                raise ValueError(
                    f"double free of page {p}: it is already on the free "
                    "list and may have been handed to a live slot")
            self._live[p] = False
            self._free.append(p)


class _PrefixEntry:
    """One shared page at one chain depth; ``key`` is the chained content
    hash of the page-aligned prefix that ends with this page."""

    __slots__ = ("key", "page", "parent", "children", "refs", "tick")

    def __init__(self, key: str, page: int, parent: Optional[str]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = 0
        self.refs = 0
        self.tick = 0


class PrefixCache:
    """Content-hash prefix cache: chain-keyed, refcounted, read-only.

    Page ``i`` of a prompt has the key ``sha1(key_{i-1} || tokens[i*ps :
    (i+1)*ps])``, so two prompts share page ``i`` iff their first
    ``(i+1)*ps`` tokens are equal.  Only full pages are shared: a reader
    would extend a partial page in place.  A reader ``acquire()``s its
    chain and ``release()``s it at evict; unreferenced entries stay cached
    for the next hit until :meth:`evict_for` reclaims them.
    """

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._entries: Dict[str, _PrefixEntry] = {}
        self._tick = itertools.count(1)
        self.lookup_pages = 0
        self.hit_pages = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def held_pages(self) -> int:
        return len(self._entries)

    def chain_keys(self, prompt) -> List[str]:
        """The chained content-hash key of every full page of ``prompt``."""
        ps = self.page_size
        toks = np.asarray(prompt, np.int32).reshape(-1)
        keys: List[str] = []
        parent = b""
        for i in range(len(toks) // ps):
            h = hashlib.sha1(parent + toks[i * ps:(i + 1) * ps].tobytes())
            keys.append(h.hexdigest())
            parent = keys[-1].encode("ascii")
        return keys

    def lookup(self, keys: Sequence[str]) -> Tuple[int, List[int]]:
        """The longest cached chain prefix of ``keys``: (depth, page ids).
        Counts toward the hit-rate census."""
        depth, pages = 0, []
        for k in keys:
            e = self._entries.get(k)
            if e is None:
                break
            pages.append(e.page)
            depth += 1
        self.lookup_pages += len(keys)
        self.hit_pages += depth
        return depth, pages

    def acquire(self, keys: Sequence[str]) -> None:
        """Attach a reader to every entry of the chain (refcount + 1)."""
        tick = next(self._tick)
        for k in keys:
            e = self._entries[k]
            e.refs += 1
            e.tick = tick

    def release(self, keys: Sequence[str]) -> None:
        """Detach a reader (refcount - 1); the pages stay cached."""
        for k in keys:
            e = self._entries.get(k)
            if e is None:            # evicted wholesale: nothing held
                continue
            if e.refs <= 0:
                raise ValueError(f"release of prefix page {e.page} with no "
                                 "readers (refcount underflow)")
            e.refs -= 1

    def insert(self, keys: Sequence[str], pages: Sequence[int],
               depth_known: int) -> None:
        """Publish a prompt's freshly prefilled full pages: entries
        ``[0, depth_known)`` exist already; ``pages[i]`` for ``i >=
        depth_known`` pass from the inserting slot to the cache (the slot
        reads them on, after ``acquire()``, but no longer frees them)."""
        for i in range(depth_known, len(keys)):
            if keys[i] in self._entries:
                raise ValueError(f"prefix entry at depth {i} already "
                                 "cached — lookup/insert raced")
            parent = keys[i - 1] if i > 0 else None
            self._entries[keys[i]] = _PrefixEntry(keys[i], pages[i], parent)
            if parent is not None:
                self._entries[parent].children += 1
            self.inserted_pages += 1

    def evict_for(self, n: int, allocator: PageAllocator) -> int:
        """Reclaim up to ``n`` pages from unreferenced leaf entries, least
        recently used first, into ``allocator``; evicting a leaf can make
        its parent one, so the scan repeats.  Returns the pages freed."""
        freed = 0
        while freed < n:
            leaves = [e for e in self._entries.values()
                      if e.refs == 0 and e.children == 0]
            if not leaves:
                break
            leaves.sort(key=lambda e: e.tick)
            for e in leaves:
                del self._entries[e.key]
                if e.parent is not None and e.parent in self._entries:
                    self._entries[e.parent].children -= 1
                allocator.free([e.page])
                self.evicted_pages += 1
                freed += 1
                if freed >= n:
                    break
        return freed

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "lookup_pages": self.lookup_pages,
            "hit_pages": self.hit_pages,
            "hit_rate": (self.hit_pages / self.lookup_pages
                         if self.lookup_pages else 0.0),
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
        }
