"""Host-side prefix cache: tokenized prompt prefix -> resident KV pages
(port of paddle_tpu/serving/prefix_cache.py, pure Python and numpy).

Identical prompt prefixes (a shared system prompt in front of many users'
turns) should occupy the page pool once.  This module is host bookkeeping
over the device-resident pool of serving/kv_cache.py: it never touches a
tensor and is owned by the engine's decode thread, so it needs no lock.

Sharing is full-page-only: a prompt of length L can share at most
``floor((L - 1) / page_size)`` pages (the -1 leaves at least one suffix
token, so admission always has a position to compute logits at, and the
page boundary means the first page a slot writes is always its own:
shared pages are strictly read-only).  On a miss the admitting request
registers one entry per prefix page count (keys are the raw token bytes
of each full-page prefix), so a later request sharing ANY page-aligned
prefix hits, however the two prompts' lengths differ.

Lifetime is a refcount per page: a page is referenced by every cache
entry that contains it plus every active slot pinned to it.  LRU eviction
(bounded entry count, or pool pressure) and slot release decrement;
pages that reach zero are handed back to the engine, which returns them
to the device free stack (kv_cache.reclaim_pages).
"""
from __future__ import annotations

import collections

__all__ = ["PrefixCache"]


class PrefixCache:
    """Refcounted read-only shared KV pages keyed by prompt prefix."""

    def __init__(self, page_size: int, capacity: int = 1024):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.page_size = int(page_size)
        self.capacity = int(capacity)
        self._entries = collections.OrderedDict()  # key -> tuple(page ids)
        self._rc: dict[int, int] = {}              # page id -> refcount

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def resident_pages(self) -> int:
        """Pages held resident by entries and/or slot pins: the scheduler
        subtracts these from the allocatable pool."""
        return len(self._rc)

    def shareable_pages(self, prompt_len: int) -> int:
        """Most pages of an L-token prompt that may ever be shared."""
        return max(0, (int(prompt_len) - 1) // self.page_size)

    # -- lookup / registration (engine decode thread only) -----------------
    def _key(self, prompt, n_pages: int) -> bytes:
        return prompt[:n_pages * self.page_size].tobytes()

    def lookup(self, prompt):
        """Longest cached page-aligned prefix of ``prompt`` (np.int32
        1-D): (n_shared_pages, page_ids tuple), (0, ()) on a miss.
        LRU-touches the hit entry; the caller pins the returned pages
        before any device work.  Side-effect-free on a miss: the engine
        probes the backlog head every loop iteration while it waits for
        pages, so hits and misses are counted at admission."""
        for j in range(self.shareable_pages(len(prompt)), 0, -1):
            pages = self._entries.get(self._key(prompt, j))
            if pages is not None:
                self._entries.move_to_end(self._key(prompt, j))
                return j, pages
        return 0, ()

    def register(self, prompt, row, j_hit: int, j_reg: int):
        """Register entries for every unshared full-page prefix of an
        admitted prompt: prefix page counts ``j_hit+1 .. j_reg`` map to
        ``row[:j]`` (the slot's page-table row on the host).  Returns the
        pages that LRU eviction dropped to refcount zero, for the caller
        to reclaim on the device."""
        reclaim = []
        for j in range(j_hit + 1, j_reg + 1):
            key = self._key(prompt, j)
            if key in self._entries:
                continue
            pages = tuple(int(p) for p in row[:j])
            self._entries[key] = pages
            for p in pages:
                self._rc[p] = self._rc.get(p, 0) + 1
            while len(self._entries) > self.capacity:
                _, old = self._entries.popitem(last=False)
                reclaim.extend(self._unref(old))
        return reclaim

    def evict_idle(self, n_pages: int):
        """Pool-pressure eviction: pop LRU entries until at least
        ``n_pages`` pages have dropped to refcount zero, or the cache is
        empty.  Returns the freed page ids for device reclaim.  Entries
        whose pages active slots still pin free nothing when popped (the
        slot's unpin returns them later): under pressure future sharing
        is given up before a queued request starves."""
        reclaim = []
        while self._entries and len(reclaim) < n_pages:
            _, old = self._entries.popitem(last=False)
            reclaim.extend(self._unref(old))
        return reclaim

    # -- per-slot pinning --------------------------------------------------
    def pin(self, pages):
        """A slot started reading ``pages`` (its shared prefix and any
        pages it just registered): hold them resident until unpin."""
        for p in pages:
            p = int(p)
            self._rc[p] = self._rc.get(p, 0) + 1

    def unpin(self, pages):
        """The slot retired: drop its holds.  Returns the pages whose
        refcount reached zero (their entries were evicted meanwhile)."""
        return self._unref(int(p) for p in pages)

    def _unref(self, pages):
        freed = []
        for p in pages:
            p = int(p)
            n = self._rc.get(p, 0) - 1
            if n <= 0:
                self._rc.pop(p, None)
                freed.append(p)
            else:
                self._rc[p] = n
        return freed
