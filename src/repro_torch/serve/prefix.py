"""Prefix cache over the paged KV pool: copy-on-write page sharing
(DESIGN.md §11).

Requests repeating the same prompt prefix (system prompts, few-shot
headers) each pay a full chunked prefill into private pages today, when
the page pool + host page table make read-only sharing nearly free — the
serving analogue of the paper's co-resident jobs sharing node-local data
instead of carrying private copies.

The cache is a host-side map from *page-aligned token prefixes* to pool
pages.  Keys are hash-chained per page::

    key_i = blake2b(key_{i-1} || tokens[i*ps : (i+1)*ps])

so a key identifies the page's tokens AND everything before them — two
prompts share page ``i`` only if they agree on the whole prefix through
it, which is exactly when the page's K/V (a per-position pure function of
the tokens) is identical.  ``lookup`` walks the chain and returns the
longest cached run; a broken link ends the chain (a deeper entry can
never be reached without its parent, which is why eviction goes
deepest-first).

Reference discipline: every entry holds ONE :class:`PageAllocator`
reference of its own (taken at ``insert`` via ``share``), on top of
whatever slot references exist — so a cached page of a retired request
stays resident for future hits, and a hit maps new slots onto it with
further ``share`` calls.  ``evict_for`` drops only entries whose page has
refcount 1 (cache-only — no slot still reads it); ``flush`` drops
everything, releasing the cache's refs (pages shared with live slots
stay outstanding under the slots' refs).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterator

import numpy as np

__all__ = ["PrefixCache"]

_SEED = b"repro/prefix/v1"


@dataclasses.dataclass
class _Entry:
    page: int                       # pool page holding this prefix page's KV
    depth: int                      # 1-based chain position (eviction order)
    last_use: int                   # cache tick of the last lookup/insert


class PrefixCache:
    """Hash-chained map from page-aligned prompt prefixes to pool pages."""

    def __init__(self, page_size: int, *, admit_after: int = 1):
        if page_size <= 0:
            raise ValueError(f"page_size {page_size} must be positive")
        if admit_after < 1:
            raise ValueError(f"admit_after {admit_after} must be >= 1")
        self.page_size = page_size
        self.admit_after = admit_after
        self._entries: dict[bytes, _Entry] = {}
        self._seen: dict[bytes, int] = {}   # host-side sight counts, no refs
        self._tick = 0
        self.n_inserted = 0
        self.n_evicted = 0
        self.n_insert_deferred = 0

    def __len__(self) -> int:
        return len(self._entries)

    def pages(self) -> set[int]:
        """Pool pages the cache currently holds a reference on (invariant
        checks: outstanding == slot-mapped ∪ cache-held)."""
        return {e.page for e in self._entries.values()}

    def _keys(self, tokens) -> Iterator[bytes]:
        toks = np.asarray(tokens, np.int32).reshape(-1)
        h = _SEED
        for i in range(len(toks) // self.page_size):
            page = toks[i * self.page_size:(i + 1) * self.page_size]
            h = hashlib.blake2b(h + page.tobytes(), digest_size=16).digest()
            yield h

    def lookup(self, tokens) -> list[int]:
        """Longest cached page chain covering a prefix of ``tokens`` (pool
        page ids, chain order).  The caller decides how much of it is
        *usable* (the scheduler floors to a chunk boundary for bit-exact
        final-chunk logits) and takes its own ``share`` refs."""
        self._tick += 1
        chain: list[int] = []
        for key in self._keys(tokens):
            e = self._entries.get(key)
            if e is None:
                break
            e.last_use = self._tick
            chain.append(e.page)
        return chain

    def insert(self, tokens, page_ids, allocator) -> int:
        """Cache every full page of ``tokens`` through the owning slot's
        ``page_ids``; each NEW entry takes one allocator reference (the
        cache's own hold).  An existing key keeps its original page — a
        racing duplicate prefill does not steal the chain (both pages hold
        identical K/V; the earlier one already serves hits).

        With ``admit_after=k`` a new key is only admitted on its k-th
        sighting; earlier sightings just bump a host-side count (no
        allocator references taken, ``n_insert_deferred`` incremented).
        Once one key in a walk is deferred, every deeper key is deferred
        too — an entry must never exist without its parent, or lookup
        could hand out an unreachable chain after the parent is admitted
        later with a DIFFERENT page.  Returns the number of entries
        added."""
        self._tick += 1
        added = 0
        chain_broken = False
        for i, key in enumerate(self._keys(tokens)):
            if i >= len(page_ids):
                break
            e = self._entries.get(key)
            if e is not None:
                e.last_use = self._tick
                continue
            n_seen = self._seen.get(key, 0) + 1
            if chain_broken or n_seen < self.admit_after:
                self._seen[key] = n_seen
                self.n_insert_deferred += 1
                chain_broken = True
                continue
            self._seen.pop(key, None)
            allocator.share([page_ids[i]])
            self._entries[key] = _Entry(page=int(page_ids[i]), depth=i + 1,
                                        last_use=self._tick)
            added += 1
        self.n_inserted += added
        return added

    def evict_for(self, allocator, n_free_target: int) -> int:
        """Evict cache-only entries (page refcount 1 — no slot maps it)
        until the allocator has ``n_free_target`` free pages, deepest-first
        then least-recently-used.  Deepest-first can never orphan a child
        behind an evicted parent, so every surviving entry stays reachable
        through ``lookup``.  Returns the number of pages freed."""
        if allocator.n_free >= n_free_target:
            return 0
        cands = [(key, e) for key, e in self._entries.items()
                 if allocator.refcount(e.page) == 1]
        cands.sort(key=lambda kv: (-kv[1].depth, kv[1].last_use))
        freed = 0
        for key, e in cands:
            if allocator.n_free >= n_free_target:
                break
            del self._entries[key]
            allocator.free([e.page])
            freed += 1
        self.n_evicted += freed
        return freed

    def flush(self, allocator) -> int:
        """Drop every entry, releasing the cache's references.  A page still
        mapped by a live slot stays outstanding under the slot's refs; a
        cache-only page returns to the free list.  Returns the number of
        entries dropped."""
        n = len(self._entries)
        for e in self._entries.values():
            allocator.free([e.page])
        self._entries.clear()
        self._seen.clear()
        return n
