"""Iteration-level slot + page scheduler for continuous-batching
generation (port of paddle_tpu/serving/scheduler.py).

Host-side bookkeeping only: which decode lane holds which request, which
lanes are free, which occupied lanes must be swept (cancellation,
deadline), and whether the page pool can absorb a request's worst case.
Admission reserves ``ceil((prompt + max_new) / page_size)`` pages minus
the shared prefix pages it maps; pages the prefix cache holds resident
are not promised to anyone.  The reservation keeps the device's
``free_count`` from ever dropping below what decode's tail-page
allocation needs.
"""
from __future__ import annotations

import time


class SlotScheduler:
    """Fixed-capacity slot + page table: ``admit`` at iteration
    boundaries, ``retire`` on EOS/length, ``sweep`` for mid-decode
    preemption."""

    def __init__(self, max_slots: int, num_pages: int | None = None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = int(max_slots)
        # LIFO free list: hot slots are reused first
        self._free = list(range(self.max_slots - 1, -1, -1))
        self._occupants: dict[int, object] = {}   # slot -> request
        self.num_pages = None if num_pages is None else int(num_pages)
        self._reserved: dict[int, int] = {}       # slot -> pages reserved
        self._shared_resident = 0                 # prefix-cache pages

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def occupied(self) -> dict:
        return self._occupants

    def has_free(self) -> bool:
        return bool(self._free)

    @property
    def pages_reserved(self) -> int:
        return sum(self._reserved.values())

    @property
    def pages_available(self) -> int:
        """Pages the pool can still promise to a new admission: total
        minus active worst-case reservations minus prefix-cache residents
        (conservative: a slot's own registered pages may be counted in
        both, never in neither)."""
        if self.num_pages is None:
            return 1 << 30
        return self.num_pages - self.pages_reserved - self._shared_resident

    def set_shared_resident(self, n_pages: int):
        """Pages the prefix cache holds (refcount > 0): the engine
        refreshes this after register, unpin and eviction."""
        self._shared_resident = int(n_pages)

    def can_admit(self, n_pages: int) -> bool:
        """True when a free slot exists AND the pool can reserve the
        request's worst-case ``n_pages``."""
        return bool(self._free) and n_pages <= self.pages_available

    def admit(self, request, n_pages: int = 0) -> int:
        """Claim a free slot for ``request`` and reserve its worst-case
        page demand (the engine checks ``can_admit`` first)."""
        slot = self._free.pop()
        self._occupants[slot] = request
        self._reserved[slot] = int(n_pages)
        return slot

    def retire(self, slot: int):
        """Release ``slot`` and its page reservation; returns its
        request."""
        req = self._occupants.pop(slot)
        self._free.append(slot)
        self._reserved.pop(slot, None)
        return req

    def prefilling(self) -> int:
        """Occupied lanes still in a chunked prefill (their request's
        ``prefilling`` is true): they hold a slot and their worst-case
        reservation but are not yet armed for decode."""
        return sum(1 for req in self._occupants.values()
                   if getattr(req, "prefilling", False))

    def sweep(self, now=None):
        """Occupied lanes whose request is cancelled or past deadline:
        [(slot, request, reason)].  A lane in a chunked prefill is swept
        like an armed one: its chunk pages are private (at or above its
        ``pinned`` register), so the engine's release returns them all."""
        now = time.monotonic() if now is None else now
        out = []
        for slot, req in self._occupants.items():
            if getattr(req, "cancelled", False):
                out.append((slot, req, "cancelled"))
            elif getattr(req, "deadline", None) is not None \
                    and now > req.deadline:
                out.append((slot, req, "deadline_expired"))
        return out
