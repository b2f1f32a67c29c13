"""Device-resident PAGED KV cache for continuous-batching decode (port of
paddle_tpu/serving/kv_cache.py).

The engine's mutable decode state is one dict of fixed-shape tensors on
its device: a page pool ``[layers, num_pages, page_size, nh, hd]`` for K
and one for V, an int32 page table ``[max_slots, pages_per_slot]`` (-1 =
unmapped), a free-list register (``free_stack`` + 0-d ``free_count``) and
the per-slot lane registers; with a speculative draft model, a second
pair of pools ``dkp``/``dvp`` for the draft's K/V, addressed through the
same page table.  Where the reference donates the state to
each jitted transition and gets a functionally updated copy back, the
port allocates these tensors ONCE (``make_state`` at the engine's
``start()``) and every transition below updates them IN PLACE — an
out-of-place pool update would copy the whole pool every layer of every
step.

Page allocation stays on the device, as in the reference, without host
syncs: admission maps ``ceil(len / page_size)`` pages off the free stack,
decode pops a tail page the step a lane's write position crosses a page
boundary, and retirement pushes a lane's PRIVATE pages back.  Pages at
table index below a lane's ``pinned`` register are SHARED prefix-cache
pages (serving/prefix_cache.py): the device never frees them; the host
returns them through :func:`reclaim_pages` once their refcount drops to
zero.  The host admits only requests whose worst case is reserved
(serving/scheduler.py), so the stack never underflows.

The tensors of the state are never rebound: the engine's decode step is
one captured CUDA graph that reads and writes them at fixed addresses.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CacheGeometry:
    """Static shape of the decode state.  ``num_pages`` 0 sizes the pool
    dense-equivalently at ``max_slots * pages_per_slot``."""
    num_layers: int
    max_slots: int
    max_seq_len: int       # S_max: prompt + generated tokens per slot
    num_heads: int
    head_dim: int
    vocab_size: int
    page_size: int = 16
    num_pages: int = 0
    dtype: torch.dtype = torch.float32
    # speculative decode: the draft model's KV lives in a parallel pool
    # addressed through the SAME page table (one allocation decision
    # covers both models); 0 layers = no draft pool in the state
    draft_layers: int = 0
    draft_num_heads: int = 0
    draft_head_dim: int = 0

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages == 0:
            object.__setattr__(self, "num_pages",
                               self.max_slots * self.pages_per_slot)
        if self.num_pages < 1:
            raise ValueError(
                f"num_pages must be >= 1, got {self.num_pages}")

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_seq_len // self.page_size)

    @property
    def pool_shape(self):
        return (self.num_layers, self.num_pages, self.page_size,
                self.num_heads, self.head_dim)

    @property
    def draft_pool_shape(self):
        return (self.draft_layers, self.num_pages, self.page_size,
                self.draft_num_heads, self.draft_head_dim)

    def page_bytes(self) -> int:
        """Bytes one page costs across K+V and all layers, the draft
        pool's included."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        per_tok = (self.num_layers * self.num_heads * self.head_dim
                   + self.draft_layers * self.draft_num_heads
                   * self.draft_head_dim)
        return 2 * self.page_size * per_tok * itemsize

    def kv_bytes(self) -> int:
        return self.num_pages * self.page_bytes()

    def pages_for(self, n_tokens: int) -> int:
        """Pages an ``n_tokens``-long sequence occupies."""
        return -(-int(n_tokens) // self.page_size)


def make_state(geom: CacheGeometry, device) -> dict:
    """Fresh all-pages-free decode state on ``device``.

    Keys: ``kp``/``vp`` the pools; ``ptab`` the page table;
    ``free_stack``/``free_count`` the free list (free page ids at
    ``free_stack[:free_count]``, popped from the top); per-slot lanes
    ``tok`` (pending token, written at ``pos`` next step), ``pos``,
    ``active``, ``pinned`` (table indices below it are shared prefix
    pages the device must not free) and the sampling registers
    ``do_sample``/``temp``/``top_k``/``eos``/``stop_pos`` (a lane retires
    when its next write position would reach ``stop_pos``, or on eos).
    With ``draft_layers``, ``dkp``/``dvp`` the draft model's pools, at the
    same page ids as ``kp``/``vp``: one page-table row addresses both
    models' cache for a lane.  Per-slot random generators live with the
    engine, on the host side of the device."""
    S, dev = geom.max_slots, torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    state = {
        "kp": torch.zeros(geom.pool_shape, dtype=geom.dtype, device=dev),
        "vp": torch.zeros(geom.pool_shape, dtype=geom.dtype, device=dev),
        "ptab": torch.full((S, geom.pages_per_slot), -1, **i32),
        "free_stack": torch.arange(geom.num_pages, **i32),
        "free_count": torch.tensor(geom.num_pages, **i32),
        "pinned": torch.zeros((S,), **i32),
        "tok": torch.zeros((S,), **i32),
        "pos": torch.zeros((S,), **i32),
        "active": torch.zeros((S,), dtype=torch.bool, device=dev),
        "do_sample": torch.zeros((S,), dtype=torch.bool, device=dev),
        "temp": torch.ones((S,), dtype=torch.float32, device=dev),
        "top_k": torch.zeros((S,), **i32),
        "eos": torch.full((S,), geom.vocab_size, **i32),   # V = never
        "stop_pos": torch.zeros((S,), **i32),
    }
    if geom.draft_layers:
        for key in ("dkp", "dvp"):
            state[key] = torch.zeros(geom.draft_pool_shape, dtype=geom.dtype,
                                     device=dev)
    return state


# -- free-list register ops (no host sync) ------------------------------------

def take_pages(free_stack, free_count, need):
    """Pop one page per True entry of ``need`` off the free stack.
    Returns (pages int32, free_count') — entries with need False get -1.
    The stack itself is untouched (entries above free_count are stale);
    indices are clipped so an entry that needs no page never reads out of
    bounds."""
    need = need.bool()
    ranks = torch.cumsum(need.long(), 0) - 1
    idx = (free_count.long() - 1 - ranks).clamp(0, free_stack.shape[0] - 1)
    pages = torch.where(need, free_stack[idx], -1)
    return pages, (free_count - need.sum()).to(torch.int32)


def push_pages(free_stack, free_count, pages):
    """Push the valid (>= 0) entries of ``pages`` onto the free stack.
    Returns (free_stack', free_count').  The reference drops invalid
    entries through an out-of-bounds sentinel; here they land on one
    sink entry past the end of a scratch copy, which is cut off."""
    n = free_stack.shape[0]
    valid = pages >= 0
    ranks = torch.cumsum(valid.long(), 0) - 1
    idx = torch.where(valid, free_count.long() + ranks, n).clamp(0, n)
    out = torch.cat([free_stack, free_stack.new_zeros(1)])
    out.scatter_(0, idx, pages.to(free_stack.dtype))
    return out[:n], (free_count + valid.sum()).to(torch.int32)


# -- transitions (in place) ---------------------------------------------------

def write_prompt(state, slot: int, k_new, v_new, length: int,
                 shared_ids=None, shared_n: int = 0, dk_new=None,
                 dv_new=None):
    """Map and fill one admitted request's pages.

    ``k_new``/``v_new`` ``[layers, Sb, nh, hd]`` hold the prefill K/V of
    absolute positions ``[shared_n * page_size, shared_n * page_size +
    Sb)``: the whole prompt's bucket on a prefix miss, the suffix's (or a
    prefill chunk's) on a hit.  Table columns ``[0, shared_n)`` of the
    slot's row come from ``shared_ids`` (an int32 ``[pages_per_slot]``
    tensor on the state's device: already resident pages, mapped and not
    written); columns ``[shared_n, ceil(length / page_size))`` are popped
    off the free stack and written page by page.  ``slot``, ``length``
    and ``shared_n`` are host ints, so the number of pages written is
    known without a device sync.  ``dk_new``/``dv_new`` (speculative
    engines): the draft model's K/V of the same positions, written into
    ``dkp``/``dvp`` at the same page ids.  Returns the row (a device
    tensor)."""
    kp, vp, ptab = state["kp"], state["vp"], state["ptab"]
    ps = kp.shape[2]
    pps = ptab.shape[1]
    Sb = k_new.shape[1]
    length, shared_n = int(length), int(shared_n)
    n_total = -(-length // ps)
    if not shared_n * ps < length <= shared_n * ps + Sb or n_total > pps:
        raise ValueError(f"write_prompt: length {length} does not fit "
                         f"{shared_n} shared pages of {ps}, a {Sb}-token "
                         f"bucket and {pps} pages")
    j = torch.arange(pps, device=ptab.device)
    need = (j >= shared_n) & (j < n_total)
    pages, free_count = take_pages(state["free_stack"], state["free_count"],
                                   need)
    row = pages if shared_n == 0 else torch.where(j < shared_n, shared_ids,
                                                  pages)
    n_priv = n_total - shared_n
    idx = row[shared_n:n_total].long()
    pairs = [(kp, k_new), (vp, v_new)]
    if dk_new is not None:
        pairs += [(state["dkp"], dk_new), (state["dvp"], dv_new)]
    for pool, new in pairs:
        pad = new.new_zeros((new.shape[0], n_priv * ps) + new.shape[2:])
        m = min(Sb, n_priv * ps)
        pad[:, :m] = new[:, :m]
        pool[:, idx] = pad.reshape(
            (new.shape[0], n_priv, ps) + new.shape[2:]).to(pool.dtype)
    ptab[slot] = row
    state["free_count"].copy_(free_count)
    return row


def admit_slot(state, slot: int, tok, length: int, do_sample: bool,
               temp: float, top_k: int, stop_pos: int, eos: int,
               pinned: int = 0):
    """Arm lane ``slot``: pending token ``tok`` (the first generated
    token, a 0-d device tensor) will be written at position ``length`` on
    the next decode step; table indices below ``pinned`` are shared
    prefix pages the device never frees."""
    state["tok"][slot] = tok
    state["pos"][slot] = int(length)
    state["active"][slot] = True
    state["pinned"][slot] = int(pinned)
    state["do_sample"][slot] = bool(do_sample)
    state["temp"][slot] = float(temp)
    state["top_k"][slot] = int(top_k)
    state["stop_pos"][slot] = int(stop_pos)
    state["eos"][slot] = int(eos)


def release_slots(state, mask):
    """Deactivate the lanes of bool ``mask`` [max_slots] (retire, cancel,
    deadline) and push their PRIVATE pages (table index >= the lane's
    ``pinned`` register) back onto the free stack; shared prefix pages
    stay resident for the prefix cache, which returns them through
    :func:`reclaim_pages` when their refcount reaches zero."""
    ptab = state["ptab"]
    col = torch.arange(ptab.shape[1], device=ptab.device)[None, :]
    freeable = mask[:, None] & (ptab >= 0) \
        & (col >= state["pinned"][:, None])
    free_stack, free_count = push_pages(
        state["free_stack"], state["free_count"],
        torch.where(freeable, ptab, -1).reshape(-1))
    state["free_stack"].copy_(free_stack)
    state["free_count"].copy_(free_count)
    ptab.masked_fill_(mask[:, None], -1)
    state["active"].logical_and_(~mask)


def reclaim_pages(state, pages):
    """Return evicted prefix-cache pages (an int32 tensor, -1-padded) to
    the free stack: the host calls this once a shared page's refcount
    reaches zero (its entry evicted and no slot still reading it)."""
    free_stack, free_count = push_pages(state["free_stack"],
                                        state["free_count"], pages)
    state["free_stack"].copy_(free_stack)
    state["free_count"].copy_(free_count)
