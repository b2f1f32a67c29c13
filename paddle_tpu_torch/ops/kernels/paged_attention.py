"""Ragged paged decode attention: CUDA kernels, plain version, count.

Replaces paddle_tpu/ops/pallas/paged_attention.py ``_kernel`` (via
``paged_decode_attention``).  Bound by bytes: each live K/V element is
read once for two flops.  csrc/paged_attention.cu holds two kernels; its
C entry picks one from the head dim and the alignment alone
(:func:`variant_launches` reports which): the ``split`` kernel
(flash-decoding: one block per (chunk of a lane's tokens, head, lane),
16-byte loads of a whole chunk in flight, the chunks of a lane merged in
chunk order by the last block to finish, in the same launch), taken when
q's rows, the pools and the output lie on 16-byte boundaries and hd is a
multiple of one 16-byte vector (every path of the models); and the
``lane`` kernel (one block per (head, lane), four warps walking the
tokens with an online softmax) for any other operand.  Both load their
own page-table row and ``pos``, skip unmapped (-1), out-of-pool and
past-``pos`` pages, and write 0 (never NaN) for a lane with no live
token.  Any page size; head dim up to 128.  They only read the pool.
There is no backward: on a CUDA tensor the wrapper raises when asked for
a gradient rather than hand out a tensor with no graph.

The wrapper allocates the split kernel's float32 partials with
``torch.empty`` each call and keeps its int32 arrival counters, zeroed
once, per device: the kernel leaves them 0, so launches on one device
must follow each other in stream order (as every path of the port does).

A CPU tensor takes :func:`paged_decode_attention_plain`; a CUDA tensor
launches a kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

MAX_HEAD_DIM = 128
_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong) \
    + (ctypes.c_void_p,) * 6 + (ctypes.c_longlong, ctypes.c_void_p,
                                ctypes.c_longlong) \
    + (ctypes.c_int,) * 7 + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
_SCRATCH_ARGTYPES = (ctypes.c_int,) * 5
_arrivals = {}      # device index -> int32 arrival counters, all 0


def _arrival_counters(device, n):
    """At least ``n`` zeroed int32 counters on ``device``, allocated once
    (the kernel sets each back to 0 after it merges)."""
    buf = _arrivals.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _arrivals[device.index] = buf
    return buf


def paged_decode_attention_plain(q, k_pages, v_pages, rows, pos, seq_cap):
    """The same function as the kernel in float32 over a dense gather of
    each lane's first ceil(seq_cap / page_size) table columns: tokens
    count when their page is mapped and their index is <= pos."""
    slots, nh, hd = q.shape
    num_pages, ps = k_pages.shape[0], k_pages.shape[1]
    walked = -(-int(seq_cap) // ps)
    r = rows[:, :walked].long()
    mapped = ((r >= 0) & (r < num_pages)).repeat_interleave(ps, dim=1)
    g = r.clamp(0, num_pages - 1)
    kg = k_pages[g].reshape(slots, walked * ps, nh, hd).float()
    vg = v_pages[g].reshape(slots, walked * ps, nh, hd).float()
    tok = torch.arange(walked * ps, device=q.device)
    valid = mapped & (tok[None, :] <= pos.long()[:, None])
    s = torch.einsum("bnd,bsnd->bns", q.float(), kg) / math.sqrt(hd)
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bns,bsnd->bnd", p, vg)
    out = out / torch.where(l > 0, l, torch.ones_like(l))
    return out.to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, rows, pos, seq_cap):
    """q [slots, nh, hd] (unit stride over hd); k_pages/v_pages
    [num_pages, page_size, nh, hd]; rows [slots, pages_per_slot] int32
    (-1 = unmapped); pos [slots] int32 inclusive extent; seq_cap the
    static extent (ceil(seq_cap / page_size) columns are walked).
    Returns [slots, nh, hd] in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, rows, pos,
                                            seq_cap)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_decode_attention: no kernel for device "
                           f"{q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pages, v_pages)):
        raise RuntimeError("paged_decode_attention has no backward kernel "
                           "(it serves decode): call it under "
                           "torch.no_grad()")
    slots, nh, hd = q.shape
    num_pages, ps = k_pages.shape[0], k_pages.shape[1]
    pps = rows.shape[1]
    walked = -(-int(seq_cap) // ps)
    if walked > pps:
        raise ValueError(f"paged_decode_attention: seq_cap {seq_cap} needs "
                         f"{walked} pages > table width {pps}")
    if hd > MAX_HEAD_DIM or q.stride(2) != 1:
        raise ValueError(f"paged_decode_attention: head dim {hd} must be "
                         f"<= {MAX_HEAD_DIM} with unit stride")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.shape != (num_pages, ps, nh, hd) or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be a "
                             f"contiguous [{num_pages}, {ps}, {nh}, {hd}] "
                             f"{q.dtype} tensor on {q.device}")
    for name, t, shape in (("rows", rows, (slots, pps)),
                           ("pos", pos, (slots,))):
        if t.shape != shape or t.dtype != torch.int32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be a "
                             f"contiguous int32 {list(shape)} tensor on "
                             f"{q.device}")
    out = torch.empty((slots, nh, hd), dtype=q.dtype, device=q.device)
    code = build.dtype_code(q)
    n_part = build.bind("paged_attention", "ptt_paged_decode_scratch_floats",
                        _SCRATCH_ARGTYPES, ctypes.c_longlong)(
        slots, nh, hd, walked * ps, code)
    part = torch.empty(max(n_part, 1), dtype=torch.float32, device=q.device)
    arrivals = _arrival_counters(q.device, slots * nh)
    fn = build.bind("paged_attention", "ptt_paged_decode_attention",
                    _ARGTYPES)
    err = fn(q.data_ptr(), q.stride(0), q.stride(1), k_pages.data_ptr(),
             v_pages.data_ptr(), rows.data_ptr(), pos.data_ptr(),
             out.data_ptr(), part.data_ptr(), n_part, arrivals.data_ptr(),
             arrivals.numel(), slots, num_pages, ps, nh, hd, pps, walked,
             1.0 / math.sqrt(hd), code, build.stream_of(q))
    build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# the C entry chooses between the block-per-(head, lane) kernel (index 0)
# and the split kernel (index 1): name -> (library, counting symbol)
VARIANTS = ("lane", "split")
VARIANT_COUNTERS = {"paged_decode_attention": (
    "paged_attention", "ptt_paged_decode_variant_launches")}


def variant_launches():
    """{"paged_decode_attention": {"lane": n, "split": n}}: how many
    launches took each kernel since the library was loaded, as the C entry
    counted them (builds the library if it is not built yet)."""
    return build.variant_counts(VARIANT_COUNTERS, VARIANTS)
