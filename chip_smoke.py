#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero (no phase is caught and
passed over):

1. device       — the card's name and power limit; no CUDA device ->
                  exit 2.
2. build        — nvcc builds every kernel of the serving and training
                  paths from paddle_tpu_torch/csrc into
                  build/paddle_tpu_torch/.
3. kernels      — each hand-written kernel against its plain PyTorch
                  version on the card, at the serving and training paths'
                  shapes, in float32 and bfloat16, with kernel / plain /
                  library times.
4. logits       — full-width GPT-2-small (GPTConfig() defaults) in float32:
                  a 64-token slot_prefill and 8 slot_decode_paged steps on
                  the card against the same on the CPU (plain versions).
5. serving      — the same model in bfloat16 behind GenerationEngine: 16
                  requests in one wave, greedy and sampled alternating;
                  every serving kernel's launch count must be > 0; then
                  4 requests with every decode step under
                  torch.cuda.set_sync_debug_mode("warn"): one sync a
                  step, the token fetch, or the run fails.
6. train-parity — full-width float32, B = 2, S = 128: loss(ids) and every
                  parameter's gradient on the card against the CPU's.
7. train        — full-width bfloat16, B = 8, S = 1024: 10 dygraph AdamW
                  steps on one batch (the loss must fall; step time,
                  tokens/s, MFU), a profiled window, then Model.fit steps;
                  every training kernel's launch count must be > 0.
8. gpt-labels   — the same model's forward(ids, labels) (the softmax
                  cross-entropy kernels on logits[:, :-1]) against
                  loss(ids), and one backward.
9. bert-parity  — full-width BERT-base (BertConfig() defaults, dropout 0)
                  in float32, B = 2, S = 128: loss() and every gradient,
                  and the masked forward's logits, on the card against the
                  CPU's.
10. bert-train  — full-width bfloat16, B = 32, S = 128: 10 dygraph AdamW
                  steps of loss() (the loss must fall; step time,
                  samples/s, tokens/s, MFU), a profiled window.
11. bert-fit    — 3 Model.fit steps on padded batches with their
                  [B, 1, 1, S] attention mask and a loss on the logits
                  through F.cross_entropy; the masked attention kernels
                  and both cross-entropy kernels must launch.

Phase 3 also holds the softmax cross-entropy kernels (BERT's MLM and NSP
shapes and GPT's) and the non-causal and masked forms of the attention
kernels (BERT's shape and S = 77) against their plain versions, paged
decode at the serving table's shape and a serving wave's, and times the
bias-GeLU Function's db reduction against the one it replaced.  Six C
entries choose between two kernels (`VARIANTS`): the attention forward,
dq and dk/dv a tensor-core kernel (bf16 on 16-byte boundaries) or a
CUDA-core one (`mma` / `simt`); LayerNorm a warp-per-row vector kernel or
a block per row (`warp` / `block`); paged decode the split
(flash-decoding) kernel or a block per (head, lane) (`split` / `lane`);
the bias-GeLU backward a 16-byte vector kernel or a scalar loop (`vec` /
`scalar`).  Every `[kernels]` line of theirs names the variant the launch
took, both are held against the plain version (the slower ones on
operands one element off a 16-byte boundary), and a phase of the serving
or training paths fails if one of its launches took the slower kernel.

The line before the last is the per-kernel JSON record; the last line is
the result JSON.  Float32 phases run with TF32 off for matmuls and cuDNN.
"""
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

F32_TOL = 2e-5       # x max(1, max|ref|): float32 summation-order noise
BF16_TOL = 2 ** -6   # x max(1, max|ref|): two bf16 ulps at the top binade
LOGITS_REL_TOL = 1e-3  # max|dlogits| / max|ref| over 12 layers, float32
GRAD_REL_TOL = 1e-3    # max|dgrad| / max|ref| per parameter, float32
HBM_BYTES_PER_S = 3.35e12
# what torch.cuda.set_sync_debug_mode("warn") says at a synchronizing call
# (its first use also warns that the mode is a prototype: not a sync)
SYNC_WARNING = "called a synchronizing CUDA operation"
PEAK_BF16_TENSOR = 989e12   # dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12            # float32 CUDA-core FLOP/s

REPLACES = {
    "layer_norm": ("paddle_tpu_torch/csrc/layer_norm.cu",
                   "paddle_tpu/ops/pallas/layer_norm.py:21"),
    "bias_gelu": ("paddle_tpu_torch/csrc/bias_gelu.cu",
                  "paddle_tpu/ops/pallas/bias_gelu.py:41"),
    "flash_attention": ("paddle_tpu_torch/csrc/flash_attention.cu",
                        "paddle_tpu/ops/pallas/flash_attention.py:82"),
    "paged_decode_attention": ("paddle_tpu_torch/csrc/paged_attention.cu",
                               "paddle_tpu/ops/pallas/paged_attention.py:44"),
    "bias_gelu_bwd": ("paddle_tpu_torch/csrc/bias_gelu.cu",
                      "paddle_tpu/ops/pallas/bias_gelu.py:46"),
    "flash_attention_dq": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                           "paddle_tpu/ops/pallas/flash_attention.py:186"),
    "flash_attention_dkv": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                            "paddle_tpu/ops/pallas/flash_attention.py:223"),
    "softmax_xent": ("paddle_tpu_torch/csrc/softmax_xent.cu",
                     "paddle_tpu/ops/pallas/softmax_xent.py:36"),
    "softmax_xent_bwd": ("paddle_tpu_torch/csrc/softmax_xent.cu",
                         "paddle_tpu/ops/pallas/softmax_xent.py:71"),
}
SERVING_KERNELS = ("layer_norm", "bias_gelu", "flash_attention",
                   "paged_decode_attention")
TRAINING_KERNELS = ("layer_norm", "bias_gelu", "flash_attention",
                    "bias_gelu_bwd", "flash_attention_dq",
                    "flash_attention_dkv")
XENT_KERNELS = ("softmax_xent", "softmax_xent_bwd")
BERT_KERNELS = TRAINING_KERNELS + XENT_KERNELS
ATTENTION_KERNELS = ("flash_attention", "flash_attention_dq",
                     "flash_attention_dkv")
# every C entry that chooses between two hand-written kernels: (the kernel
# for any other operand, the kernel every launch of a path must take) —
# the three attention kernels' tensor-core kernel for aligned bf16 beside
# the CUDA-core one, and the 16-byte vector kernels of LayerNorm, paged
# decode and the bias-GeLU backward beside their scalar ones
MMA_KERNELS = ("flash_attention", "flash_attention_dq", "flash_attention_dkv")
VECTOR_KERNELS = ("layer_norm", "paged_decode_attention", "bias_gelu_bwd")
VARIANTS = {**{n: ("simt", "mma") for n in MMA_KERNELS},
            "layer_norm": ("block", "warp"),
            "paged_decode_attention": ("lane", "split"),
            "bias_gelu_bwd": ("scalar", "vec")}
FAST_VARIANT = {n: fast for n, (_, fast) in VARIANTS.items()}
# the kernels with a variant that each path launches
SERVING_FAST = ("flash_attention", "layer_norm", "paged_decode_attention")
TRAINING_FAST = MMA_KERNELS + ("layer_norm", "bias_gelu_bwd")


def log(msg):
    print(msg, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def _events_ms(torch, run, n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_ms(torch, fn, iters=20, reps=5):
    """(device ms, eager ms) of one call.  Device: ``iters`` calls
    captured in one CUDA graph and replayed ``reps`` times between CUDA
    events, so the host's launch cost is out of the number.  Eager: the
    same calls issued back to back from Python, which for kernels of a
    few microseconds measures the host's launch rate.  Inputs stay warm
    in L2 in both, as on the serving path."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()

    def replay():
        for _ in range(reps):
            graph.replay()

    replay()
    torch.cuda.synchronize()
    device = _events_ms(torch, replay, reps * iters)

    def eager():
        for _ in range(iters * reps):
            fn()

    return device, _events_ms(torch, eager, reps * iters)


def mfu_text(flops, step_s):
    """The MFU of a step and its terms, the peak printed as the divisor
    it is (989e12 prints as 9.89e+14)."""
    return (f"MFU {flops / step_s / PEAK_BF16_TENSOR:.4f} ({flops:.4e} "
            f"flops/step / {step_s * 1e3:.3f} ms / {PEAK_BF16_TENSOR:.3g} "
            f"FLOP/s)")


def bound_ms(n_bytes, n_flops, peak):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def variant_taken(before, after, name):
    """Which kernel of entry ``name`` the launches between two
    ``variant_launches()`` readings took: its variant's name (a name of
    ``VARIANTS``), "mixed" or "none"."""
    took = [v for v in after[name] if after[name][v] > before[name][v]]
    return took[0] if len(took) == 1 else ("mixed" if took else "none")


def require_fast_variants(K, before, what, kernels):
    """Fail if a launch of a path since the reading ``before`` took the
    slower kernel of its entry (an attention kernel on the CUDA cores in
    bf16, LayerNorm's block per row, paged decode's block per (head,
    lane), the scalar bias-GeLU backward), or if one of ``kernels`` took
    no launch of its fast kernel at all.  Returns the fast launches."""
    after = K.variant_launches()
    took = {}
    for name, counts in after.items():
        fast = FAST_VARIANT[name]
        took[name] = counts[fast] - before[name][fast]
        slow = {v: n - before[name][v] for v, n in counts.items()
                if v != fast}
        if any(slow.values()) or (name in kernels and took[name] <= 0):
            fail(f"{what}: {name} took {slow} and the {fast} kernel "
                 f"{took[name]} times")
    return took


def compare(torch, name, kernel_fn, plain_fn, library_fn, dtype, n_bytes,
            n_flops, peak, variant=None):
    """Run kernel and plain version on the same inputs, check, time.  A
    function may return one tensor or a tuple (dk, dv).  ``variant``:
    (entry, the variant its launch must take)."""
    if variant is not None:
        import paddle_tpu_torch.ops.kernels as KV
        before = KV.variant_launches()
    outs, refs = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if variant is not None:
        took = variant_taken(before, KV.variant_launches(), variant[0])
        if took != variant[1]:
            fail(f"{name}: the launch took the {took} kernel, not "
                 f"{variant[1]}")
        name = f"{name} [{took}]"
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    err = max((o.float() - r.float()).abs().max().item()
              for o, r in zip(outs, refs))
    scale = max(1.0, max(r.float().abs().max().item() for r in refs))
    tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) * scale
    if not math.isfinite(err) or err > tol:
        fail(f"{name}: max|kernel - plain| {err:.3e} > tol {tol:.3e}")
    rec = {"max_abs_err": err, "tol": tol}
    eager = {}
    for key, fn in (("ms", kernel_fn), ("plain_ms", plain_fn),
                    ("library_ms", library_fn)):
        rec[key], eager[key] = (time_ms(torch, fn) if fn is not None
                                else (None, None))
    rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, n_flops, peak)
    rec["tflops"] = n_flops / rec["ms"] / 1e9
    rec["variant"] = variant[1] if variant is not None else None
    log(f"[kernels] {name}: max_abs_err={err:.3e} tol={tol:.3e} | device "
        f"ms: kernel={rec['ms']} ({rec['tflops']:.2f} TFLOP/s) "
        f"plain={rec['plain_ms']} "
        f"library={rec['library_ms']} bound={rec['bound_ms']} "
        f"({rec['bound_by']}) | eager ms: kernel={eager['ms']} "
        f"plain={eager['plain_ms']} library={eager['library_ms']}")
    return rec


def kernel_phase(torch, K):
    """Every forward kernel against its plain version, at the serving
    path's shapes and the training path's (8192 rows; B = 8, S = 1024);
    returns the record of each kernel at its main serving-path case
    (bfloat16)."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        isz = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16_TENSOR

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device=dev) * scale
                    ).to(dtype)

        for R in (8, 128, 8192):      # decode, prefill, training rows
            N = 768
            x, w, b = rnd(R, N), 1 + rnd(N, scale=0.1), rnd(N, scale=0.1)
            main_case = dtype == torch.bfloat16 and R == 8
            rec = compare(
                torch, f"layer_norm {tag} R={R} N={N}",
                lambda: K.layer_norm.layer_norm(x, w, b, 1e-5),
                lambda: K.layer_norm.layer_norm_plain(x, w, b, 1e-5),
                lambda: F.layer_norm(x, (N,), w, b, 1e-5), dtype,
                (2 * R * N + 2 * N) * isz, 8 * R * N, PEAK_F32,
                variant=("layer_norm", "warp"))
            if main_case:
                main["layer_norm"] = rec
        for R in (8, 128, 8192):
            Fd = 3072
            x, b = rnd(R, Fd), rnd(Fd, scale=0.1)
            rec = compare(
                torch, f"bias_gelu {tag} R={R} F={Fd}",
                lambda: K.bias_gelu.bias_gelu(x, b),
                lambda: K.bias_gelu.bias_gelu_plain(x, b),
                lambda: F.gelu(x + b), dtype,
                (2 * R * Fd + Fd) * isz, 5 * R * Fd, PEAK_F32)
            if dtype == torch.bfloat16 and R == 8:
                main["bias_gelu"] = rec
        H, D = 12, 64
        for B, S in ((1, 64), (1, 128), (8, 1024)):   # prefill; training
            qkv = rnd(B, S, 3, H, D)              # the fused projection
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            pairs = B * H * S * (S + 1) // 2
            rec = compare(
                torch, f"flash_attention {tag} B={B} S={S} H={H} D={D}",
                lambda: K.flash_attention.flash_attention(q, k, v)[0],
                lambda: K.flash_attention.flash_attention_plain(q, k, v)[0],
                lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True), dtype,
                4 * B * S * H * D * isz + B * H * S * 4, 4 * D * pairs, peak,
                variant=("flash_attention", variant_of(dtype)))
            if dtype == torch.bfloat16 and B == 1 and S == 128:
                main["flash_attention"] = rec
        # the serving table's shape (one lane at 512 tokens, six short,
        # one inactive) and a serving wave's (8 lanes at 20-176 tokens)
        for case, lane_pos in (
                ("table", (511, 15, 16, 100, 255, 37, 480, -1)),
                ("wave", (20, 176, 57, 131, 88, 160, 35, 113))):
            rec = paged_case(torch, K, g, dtype, case, lane_pos, ps=16,
                             hd=64)
            if dtype == torch.bfloat16 and case == "table":
                main["paged_decode_attention"] = rec
    torch.cuda.synchronize()
    return main


def paged_case(torch, K, g, dtype, case, lane_pos, ps, hd, nh=12,
               pps=32, variant="split", q_offset=None):
    """paged_decode_attention against its plain version: lanes with the
    inclusive extents ``lane_pos`` (-1: an inactive lane with an all -1
    row, pos 0) over page tables scattered through the pool, the live
    tokens' K/V the bound's bytes.  q is the slice of a fused qkv, as the
    model gives it, or with ``q_offset`` a view that many elements into
    its buffer."""
    PA = K.paged_attention
    dev = "cuda"
    slots = len(lane_pos)
    num_pages = slots * pps
    isz = torch.empty((), dtype=dtype).element_size()
    pos = torch.tensor([max(p, 0) for p in lane_pos], dtype=torch.int32,
                       device=dev)
    perm = torch.randperm(num_pages, generator=g, device=dev)
    rows = torch.full((slots, pps), -1, dtype=torch.int32, device=dev)
    live = 0
    for lane, p in enumerate(lane_pos):
        if p < 0:
            continue
        n = p // ps + 1
        rows[lane, :n] = perm[lane * pps:lane * pps + n].to(torch.int32)
        live += p + 1
    kp = torch.randn(num_pages, ps, nh, hd, generator=g, device=dev).to(dtype)
    vp = torch.randn(num_pages, ps, nh, hd, generator=g, device=dev).to(dtype)
    if q_offset is None:
        q = torch.randn(slots, 1, 3, nh, hd, generator=g,
                        device=dev).to(dtype)[:, 0, 0]
    else:
        n = slots * nh * hd
        q = torch.randn(n + 8, generator=g, device=dev).to(dtype)[
            q_offset:q_offset + n].view(slots, nh, hd)
    tag = "f32" if dtype == torch.float32 else "bf16"
    return compare(
        torch, f"paged_decode_attention {tag} {case} slots={slots} nh={nh} "
        f"hd={hd} page={ps} pps={pps} pos={list(lane_pos)}",
        lambda: PA.paged_decode_attention(q, kp, vp, rows, pos, pps * ps),
        lambda: PA.paged_decode_attention_plain(q, kp, vp, rows, pos,
                                                pps * ps),
        None, dtype,
        2 * live * nh * hd * isz + 2 * slots * nh * hd * isz
        + slots * (pps + 1) * 4, 4 * live * nh * hd,
        PEAK_F32 if dtype == torch.float32 else PEAK_BF16_TENSOR,
        variant=("paged_decode_attention", variant))


def variant_of(dtype):
    """The attention kernel an aligned operand of ``dtype`` must take."""
    return "simt" if dtype.itemsize == 4 else "mma"


def unaligned_phase(torch, K):
    """bf16 operands one element off a 16-byte boundary: attention (B = 1,
    S = 128, H = 12, D = 64, causal) must take the CUDA-core forward, dq
    and dk/dv, LayerNorm (R = 8192, N = 768) its block-per-row kernel, the
    bias-GeLU backward (R = 8192, F = 3072, and F = 3071 aligned) its
    scalar kernel and paged decode (the table's shape) its block per
    (head, lane); all agree with the plain versions like any other
    case."""
    F = torch.nn.functional
    KF = K.flash_attention
    g = torch.Generator(device="cuda").manual_seed(9)
    B, S, H, D = 1, 128, 12, 64
    n = B * S * H * D
    q, k, v, do = (torch.randn(n + 8, generator=g, device="cuda").to(
        torch.bfloat16)[1:n + 1].view(B, S, H, D) for _ in range(4))
    grads = torch.empty(2, n + 8, dtype=torch.bfloat16, device="cuda")
    out = tuple(t[1:n + 1].view(B, S, H, D) for t in grads)
    o, lse = KF.flash_attention(q, k, v)
    delta = KF.flash_attention_delta(o, do)
    pairs = B * H * S * (S + 1) // 2
    shape = f"bf16 unaligned B={B} S={S} H={H} D={D}"
    compare(torch, f"flash_attention {shape}",
            lambda: KF.flash_attention(q, k, v)[0],
            lambda: KF.flash_attention_plain(q, k, v)[0], None,
            torch.bfloat16, 4 * n * 2 + B * H * S * 4, 4 * D * pairs,
            PEAK_BF16_TENSOR, variant=("flash_attention", "simt"))
    compare(torch, f"flash_attention_dq {shape}",
            lambda: KF.flash_attention_dq(q, k, v, do, lse, delta,
                                          out=out[0]),
            lambda: KF.flash_attention_dq_plain(q, k, v, do, lse, delta),
            None, torch.bfloat16, 5 * n * 2 + 2 * B * H * S * 4,
            6 * D * pairs, PEAK_BF16_TENSOR,
            variant=("flash_attention_dq", "simt"))
    compare(torch, f"flash_attention_dkv {shape}",
            lambda: KF.flash_attention_dkv(q, k, v, do, lse, delta, out=out),
            lambda: KF.flash_attention_dkv_plain(q, k, v, do, lse, delta),
            None, torch.bfloat16, 6 * n * 2 + 2 * B * H * S * 4,
            8 * D * pairs, PEAK_BF16_TENSOR,
            variant=("flash_attention_dkv", "simt"))
    R, N = 8192, 768
    x = torch.randn(R * N + 8, generator=g, device="cuda").to(
        torch.bfloat16)[1:R * N + 1].view(R, N)
    w = (1 + 0.1 * torch.randn(N, generator=g, device="cuda")).bfloat16()
    b = (0.1 * torch.randn(N, generator=g, device="cuda")).bfloat16()
    compare(torch, f"layer_norm bf16 unaligned R={R} N={N}",
            lambda: K.layer_norm.layer_norm(x, w, b, 1e-5),
            lambda: K.layer_norm.layer_norm_plain(x, w, b, 1e-5),
            lambda: F.layer_norm(x, (N,), w, b, 1e-5), torch.bfloat16,
            (2 * R * N + 2 * N) * 2, 8 * R * N, PEAK_F32,
            variant=("layer_norm", "block"))
    # the bias-GeLU backward: an unaligned x and a width that is not a
    # multiple of 8 take the scalar kernel
    R, Fd = 8192, 3072
    x = torch.randn(R * Fd + 8, generator=g, device="cuda").to(
        torch.bfloat16)[1:R * Fd + 1].view(R, Fd)
    b = (0.5 * torch.randn(Fd, generator=g, device="cuda")).bfloat16()
    dy = torch.randn(R, Fd, generator=g, device="cuda").bfloat16()
    for shape, (xs, bs, dys) in (
            (f"unaligned R={R} F={Fd}", (x, b, dy)),
            (f"R={R} F={Fd - 1}", (x[:, 1:].contiguous(), b[1:].contiguous(),
                                   dy[:, 1:].contiguous()))):
        compare(torch, f"bias_gelu_bwd bf16 {shape}",
                lambda: K.bias_gelu.bias_gelu_bwd(xs, bs, dys),
                lambda: K.bias_gelu.bias_gelu_bwd_plain(xs, bs, dys),
                lambda: torch.ops.aten.gelu_backward(dys, xs + bs),
                torch.bfloat16, (3 * xs.numel() + xs.shape[1]) * 2,
                12 * xs.numel(), PEAK_F32, variant=("bias_gelu_bwd",
                                                    "scalar"))
    # paged decode: q one element off a 16-byte boundary takes the block
    # per (head, lane)
    paged_case(torch, K, g, torch.bfloat16, "unaligned q",
               (511, 15, 16, 100, 255, 37, 480, -1), ps=16, hd=64,
               variant="lane", q_offset=1)


def sdpa_backward(torch, q, k, v, do):
    """The library yardstick for the attention backward: one call of
    PyTorch's flash-attention backward
    (aten._scaled_dot_product_flash_attention_backward), which computes dq,
    dk and dv together, on the same inputs in its [B, H, S, D] layout,
    from its own forward's output and logsumexp.  bfloat16 only."""
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    out, lse, cq, ck, mq, mk, seed_t, offset_t = \
        torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True)[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, True, seed_t,
        offset_t)


def backward_kernel_phase(torch, K):
    """The training path's backward kernels against their plain versions
    at its shapes (bias+GeLU over the FFN's [B*S, 4H]; attention at
    H = 12, D = 64 and B = 1, S = 128; B = 8, S = 128, 1024); returns the
    record of each kernel at its main case (bfloat16, S = 1024)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    main = {}
    KF = K.flash_attention
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        isz = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16_TENSOR

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device="cuda") * scale
                    ).to(dtype)

        for R, Fd in ((8192, 3072), (4096, 3072), (37, 3072)):
            # GPT's FFN rows, BERT's, and a ragged band of rows
            x, b, dy = rnd(R, Fd, scale=2.0), rnd(Fd, scale=0.5), rnd(R, Fd)
            rec = compare(
                torch, f"bias_gelu_bwd {tag} R={R} F={Fd}",
                lambda: K.bias_gelu.bias_gelu_bwd(x, b, dy),
                lambda: K.bias_gelu.bias_gelu_bwd_plain(x, b, dy),
                lambda: torch.ops.aten.gelu_backward(dy, x + b), dtype,
                (3 * R * Fd + Fd) * isz, 12 * R * Fd, PEAK_F32,
                variant=("bias_gelu_bwd", "vec"))
            if dtype == torch.bfloat16 and R == 8192:
                main["bias_gelu_bwd"] = rec
                db_timing(torch, K, x, b, dy)
        H, D = 12, 64
        for B, S in ((1, 128), (8, 128), (8, 1024)):
            q, k, v = rnd(B, S, 3, H, D).unbind(2)   # the fused projection
            o, lse = KF.flash_attention(q, k, v)
            do = rnd(B, S, H, D)
            delta = KF.flash_attention_delta(o, do)
            lib = sdpa_backward(torch, q, k, v, do) \
                if dtype == torch.bfloat16 else None
            pairs = B * H * S * (S + 1) // 2
            one = B * S * H * D * isz                 # one [B, S, H, D]
            stats = 2 * B * H * S * 4                 # lse and delta
            shape = f"B={B} S={S} H={H} D={D}"
            rec_q = compare(
                torch, f"flash_attention_dq {tag} {shape}",
                lambda: KF.flash_attention_dq(q, k, v, do, lse, delta),
                lambda: KF.flash_attention_dq_plain(q, k, v, do, lse, delta),
                lib, dtype, 5 * one + stats, 6 * D * pairs, peak,
                variant=("flash_attention_dq", variant_of(dtype)))
            rec_kv = compare(
                torch, f"flash_attention_dkv {tag} {shape}",
                lambda: KF.flash_attention_dkv(q, k, v, do, lse, delta),
                lambda: KF.flash_attention_dkv_plain(q, k, v, do, lse,
                                                     delta),
                lib, dtype, 6 * one + stats, 8 * D * pairs, peak,
                variant=("flash_attention_dkv", variant_of(dtype)))
            if dtype == torch.bfloat16 and S == 1024:
                main["flash_attention_dq"] = rec_q
                main["flash_attention_dkv"] = rec_kv
    torch.cuda.synchronize()
    return main


def db_timing(torch, K, x, b, dy):
    """The bias gradient of the bias-GeLU Function at the GPT shape, device
    ms: the reduction it takes now (float32 accumulation over dx as it
    lies) against the one it took before (a float32 copy of dx, summed);
    the two must agree."""
    dx = K.bias_gelu.bias_gelu_bwd(x, b, dy)
    F = dx.shape[-1]
    before = lambda: dx.float().reshape(-1, F).sum(0)   # noqa: E731
    now = lambda: K.bias_gelu.bias_gelu_db(dx)          # noqa: E731
    err = (now() - before()).abs().max().item()
    # two float32 sums of the same 8192 terms in any order: held against
    # the sum of the terms' magnitudes
    tol = F32_TOL * max(1.0, dx.float().abs().sum(0).max().item())
    if not err <= tol:
        fail(f"bias_gelu db: |now - before| {err:.3e} > {tol:.3e}")
    t_now, t_before = time_ms(torch, now)[0], time_ms(torch, before)[0]
    log(f"[kernels] bias_gelu db bf16 R={dx.shape[0]} F={F}: device ms "
        f"float32-accumulated sum={t_now} (before: float32 copy + sum "
        f"{t_before}); |diff| {err:.3e}; bound "
        f"{(dx.numel() * 2 + F * 4) / HBM_BYTES_PER_S * 1e3}")


def decode_run(torch, model, prompt, n_steps, feed=None):
    """slot_prefill of ``prompt`` then ``n_steps`` slot_decode_paged steps
    of lane 0 (lane 1 inactive) on the model's device.  Tokens fed after
    the prefill come from ``feed`` (teacher forcing) or greedy argmax.
    Returns (list of logits [V] as float32 CPU tensors, fed tokens)."""
    from paddle_tpu_torch.serving import kv_cache as kc

    cfg, dev = model.cfg, model.device
    L = len(prompt)
    geom = kc.CacheGeometry(
        num_layers=cfg.num_layers, max_slots=2, max_seq_len=L + n_steps + 1,
        num_heads=cfg.num_heads, head_dim=cfg.hidden_size // cfg.num_heads,
        vocab_size=cfg.vocab_size, page_size=16, dtype=model.dtype)
    st = kc.make_state(geom, dev)
    ids = torch.tensor([prompt], dtype=torch.long, device=dev)
    k, v, logits = model.slot_prefill(ids, L)
    kc.write_prompt(st, 0, k, v, L)
    out = [logits.float().cpu()]
    toks = []
    lane = torch.arange(2, device=dev)
    for i in range(n_steps):
        tok = int(feed[i]) if feed is not None else int(out[-1].argmax())
        toks.append(tok)
        st["tok"][0] = tok
        st["pos"][0] = L + i
        st["active"][0] = True
        pidx = (st["pos"] // 16).long()
        cur = st["ptab"][lane, pidx]
        need = st["active"] & (cur < 0)
        pages, fc = kc.take_pages(st["free_stack"], st["free_count"], need)
        st["ptab"][lane, pidx] = torch.where(need, pages, cur)
        st["free_count"].copy_(fc)
        lg, _, _ = model.slot_decode_paged(st["tok"], st["pos"], st["active"],
                                           st["kp"], st["vp"], st["ptab"],
                                           geom.max_seq_len)
        out.append(lg[0].float().cpu())
    return out, toks


def logits_phase(torch, model_gpu, model_cpu):
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, model_gpu.cfg.vocab_size, 64).tolist()
    t0 = time.perf_counter()
    ref, toks = decode_run(torch, model_cpu, prompt, 8)
    t1 = time.perf_counter()
    got, _ = decode_run(torch, model_gpu, prompt, 8, feed=toks)
    torch.cuda.synchronize()
    worst = 0.0
    for i, (a, r) in enumerate(zip(got, ref)):
        if a.shape != r.shape or not torch.isfinite(a).all():
            fail(f"logits step {i}: shape {tuple(a.shape)} or non-finite")
        rel = ((a - r).abs().max() / r.abs().max()).item()
        worst = max(worst, rel)
    if worst > LOGITS_REL_TOL:
        fail(f"full-width f32 logits: max|d|/max|ref| {worst:.3e} > "
             f"{LOGITS_REL_TOL}")
    log(f"[logits] full-width f32 prefill(64) + 8 paged decode steps: "
        f"max|dlogits|/max|ref| = {worst:.3e} (tol {LOGITS_REL_TOL}); "
        f"cpu reference {t1 - t0:.1f}s; greedy argmax agrees at "
        f"{sum(int(a.argmax()) == int(r.argmax()) for a, r in zip(got, ref))}"
        f"/{len(ref)} positions")


def profile_window(torch, run):
    """run() under torch.profiler: (wall ms, device busy ms, kernel
    launches, the ten kernels that take the most device time, then the
    device-to-host copies' ms and count).  Busy = the sum of kernel times
    over the window (one stream, so kernels do not overlap); None when
    the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.self_device_time_total / 1e3, e.key, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(t for t, _, _ in kernels)
    if busy_ms == 0:
        return wall_ms, None, 0, ""
    kernels.sort(reverse=True)
    top = "; ".join(f"{name[:60]} {t:.3f} ms x{n}"
                    for t, name, n in kernels[:10])
    copies = [(t, n) for t, name, n in kernels
              if name.startswith("Memcpy DtoH")]
    top += (f"; device-to-host copies {sum(t for t, _ in copies):.3f} ms "
            f"x{sum(n for _, n in copies)}")
    return wall_ms, busy_ms, sum(n for _, _, n in kernels), top


def profile_wave(torch, eng, prompts):
    """Where a serving wave's time goes: a second wave of greedy requests
    (16 new tokens each) under torch.profiler."""
    def wave():
        for h in [eng.submit(p, 16) for p in prompts]:
            h.result(600)

    wall_ms, busy_ms, launches, top = profile_window(torch, wave)
    if busy_ms is None:
        log("[profile] no device time in the trace: busy share not measured")
        return
    log(f"[profile] {len(prompts)} greedy requests x 16 tokens: wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.2f}%), {launches} kernel launches; "
        f"top: {top}")


def sync_check(torch, eng, prompts):
    """Every ``GenerationEngine.step()`` of a few requests (greedy and
    sampled alternating) under ``torch.cuda.set_sync_debug_mode("warn")``:
    a step makes exactly one synchronizing call, its copy of the tokens
    to the host in serving/generation.py; any other sync fails the run.
    Returns the summary for the serving line."""
    import warnings

    step, seen = eng.step, []

    def checked_step():                 # runs on the decode thread
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        seen.append([(os.path.basename(w.filename), w.lineno)
                     for w in caught
                     if str(w.message).startswith(SYNC_WARNING)])
        return out

    eng.step = checked_step
    try:
        handles = [eng.submit(p, 8, **(dict(do_sample=True, temperature=0.8,
                                            top_k=8, seed=i) if i % 2
                                       else {}))
                   for i, p in enumerate(prompts)]
        for h in handles:
            h.result(600)
    finally:
        del eng.step
    where = {loc for syncs in seen for loc in syncs}
    if not seen or any(len(syncs) != 1 for syncs in seen) \
            or {f for f, _ in where} != {"generation.py"}:
        fail(f"decode steps made other syncs than the token fetch: {seen}")
    return (f"{len(seen)} decode steps under sync debug mode: one sync "
            f"each, at {sorted(where)} (the token fetch)")


def serving_phase(torch, K, model, card):
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(model, max_slots=8, max_seq_len=512,
                           prompt_buckets="64,128", page_size=16,
                           num_pages=0, device="cuda").start()
    try:
        rng = np.random.RandomState(2)
        lens = rng.randint(20, 129, 16)
        prompts = [rng.randint(0, model.cfg.vocab_size, n).tolist()
                   for n in lens]
        K.reset_launch_counts()
        variants = K.variant_launches()
        t0 = time.perf_counter()
        handles = []
        for i, p in enumerate(prompts):
            kw = (dict(do_sample=True, temperature=0.8, top_k=8, seed=i)
                  if i % 2 else {})
            handles.append(eng.submit(p, 48, **kw))
        outs = [h.result(600) for h in handles]
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        fast = require_fast_variants(K, variants, "serving", SERVING_FAST)
        snap = eng.metrics.snapshot()
        for i, o in enumerate(outs):
            if len(o) != 48 or min(o) < 0 or max(o) >= model.cfg.vocab_size:
                fail(f"request {i}: {len(o)} tokens, range "
                     f"[{min(o)}, {max(o)}]")
        for name in SERVING_KERNELS:
            if counts[name] <= 0:
                fail(f"kernel {name} was not launched on the serving path")
        if eng.free_count != eng.geometry.num_pages:
            fail(f"free_count {eng.free_count} != num_pages "
                 f"{eng.geometry.num_pages} after the wave")
        alone = eng.generate(prompts[0], 48, timeout=600)
        if alone != outs[0]:
            fail("greedy request re-run alone gave different tokens")
        if eng.free_count != eng.geometry.num_pages:
            fail("free_count did not return to num_pages")
        syncs = sync_check(torch, eng, prompts[:4])
        profile_wave(torch, eng, prompts[:8])
        total = sum(len(o) for o in outs)
        log(f"[serving] 16 requests (prompts 20-128, 48 new tokens, "
            f"greedy/sampled alternating) on {card}: "
            f"{total} tokens in {wall:.3f}s = {total / wall:.1f} tokens/s; "
            f"TTFT p50 {snap['ttft_p50_ms']:.3f} ms; inter-token p50 "
            f"{snap['inter_token_p50_ms']:.3f} ms; launches {counts}; "
            f"tensor-core and vector-kernel launches {fast}; "
            f"greedy re-run alone identical; free_count back to "
            f"{eng.geometry.num_pages}; {syncs}")
        return counts
    finally:
        eng.stop()


def train_parity_phase(torch, K, cfg):
    """loss(ids) and every parameter's gradient of the full-width float32
    model, B = 2, S = 128, on the card (kernels) against the CPU (plain
    versions), from the same seeded weights and ids."""
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTForCausalLM

    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 128)))
    res = {}
    for device in ("cpu", "cuda"):
        seed(0)
        model = GPTForCausalLM(cfg, device=device).train()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss = model.loss(ids.to(device))
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            counts = K.launch_counts()
        res[device] = (loss.item(), {n: p.grad for n, p in
                                     model.named_parameters()},
                       time.perf_counter() - t0)
        del model, loss
    (loss_g, grads_g, t_g), (loss_c, grads_c, t_c) = res["cuda"], res["cpu"]
    for name in TRAINING_KERNELS:
        if counts[name] <= 0:
            fail(f"train-parity: kernel {name} was not launched")
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    worst, worst_name = 0.0, None
    for name, ref in grads_c.items():
        got = grads_g[name]
        if got is None or not torch.isfinite(got).all():
            fail(f"train-parity: {name} has no finite gradient on the card")
        rel = ((got.cpu() - ref).abs().max()
               / ref.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    if loss_rel > GRAD_REL_TOL or worst > GRAD_REL_TOL:
        fail(f"train-parity: loss rel {loss_rel:.3e}, worst gradient "
             f"{worst_name} rel {worst:.3e} > {GRAD_REL_TOL}")
    log(f"[train-parity] full-width f32 B=2 S=128 loss {loss_g:.6f} (cpu "
        f"{loss_c:.6f}, rel {loss_rel:.3e}); {len(grads_c)} parameters, "
        f"every gradient finite on the card; worst max|dgrad|/max|ref| "
        f"{worst:.3e} ({worst_name}; tol {GRAD_REL_TOL}); card "
        f"{t_g:.2f}s, cpu {t_c:.2f}s; launches {counts}")


def lm_loss(logits, labels):
    """Next-token cross entropy on the logits, in float32 (the user loss
    of bench.py's GPT Model.fit configuration)."""
    logp = logits[:, :-1].float().log_softmax(-1)
    return -logp.gather(-1, labels[:, 1:, None])[..., 0].mean()


def train_phase(torch, K, cfg, card):
    """Full-width bfloat16 GPT-2-small, B = 8, S = 1024: 10 dygraph AdamW
    steps on one fixed batch (the loop of bench.py's GPT training body),
    a profiled window of 2 more, then 3 Model.fit steps.  Returns the
    launch counts of the 10 dygraph steps."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTForCausalLM

    B, S, steps = 8, 1024, 10
    seed(0)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16).train()
    n_params = sum(p.numel() for p in model.parameters())
    rs = np.random.RandomState(4)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S))).cuda()
    opt = ptt.optimizer.AdamW(learning_rate=2e-4, weight_decay=0.01,
                              parameters=model.parameters())

    def step():
        loss = model.loss(ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    variants = K.variant_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = K.launch_counts()
    fast = require_fast_variants(K, variants, "train", TRAINING_FAST)
    losses = torch.stack(losses).float().cpu().tolist()
    for name in TRAINING_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the training path")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"training loss did not fall: {losses}")
    p50 = float(np.median(times))
    tokens = B * S
    # bench.py's model-FLOPs convention: 6*N*tokens + attention
    flops = 6.0 * n_params * tokens \
        + cfg.num_layers * 12 * S * S * cfg.hidden_size * B
    per_step = {n: counts[n] / steps for n in TRAINING_KERNELS}
    log(f"[train] bf16 full width B={B} S={S}, {n_params} parameters, "
        f"AdamW(2e-4, wd 0.01) on {card}: losses {losses}; step ms "
        f"{[round(t * 1e3, 3) for t in times]}; p50 {p50 * 1e3:.3f} ms; "
        f"{tokens / p50:.1f} tokens/s; {mfu_text(flops, p50)}; peak memory "
        f"{peak_text(torch, start)}; launches "
        f"per step {per_step}; tensor-core and vector-kernel launches {fast}")

    profile_steps(torch, "train-profile", step)

    data = torch.from_numpy(rs.randint(0, cfg.vocab_size, (3 * B, S)))
    api = ptt.Model(model).prepare(opt, lm_loss)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    hist = api.fit(ptt.io.TensorDataset([data, data]), batch_size=B,
                   epochs=1, shuffle=False, verbose=0, log_freq=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = K.launch_counts()
    require_fast_variants(K, variants, "train and Model.fit", TRAINING_FAST)
    if len(hist["step_loss"]) != 3 or not all(
            math.isfinite(x) for x in hist["step_loss"]):
        fail(f"Model.fit: step losses {hist['step_loss']}")
    for name in TRAINING_KERNELS:
        if fit_counts[name] <= 0:
            fail(f"kernel {name} was not launched on the Model.fit path")
    log(f"[fit] Model.fit 3 steps of B={B} S={S} with a loss on the "
        f"logits: step losses {hist['step_loss']}; {fit_s:.3f}s; launches "
        f"{fit_counts}")
    return counts


def xent_kernel_phase(torch, K):
    """softmax_xent forward and backward against their plain versions at
    the three shapes of the paths: BERT-base's MLM head (B = 32, S = 128,
    V = 30522, 15 % of the tokens labelled), its NSP head (N = 32, V = 2)
    and GPT forward(ids, labels) (the strided view logits[:, :-1] of
    [8, 1024, 50304], a few ignored rows); float32 and bfloat16.  An
    ignored row's gradient must be exactly 0.  Returns the records of the
    bf16 MLM case."""
    F = torch.nn.functional
    SX = K.softmax_xent
    g = torch.Generator(device="cuda").manual_seed(5)
    main = {}
    cases = (("mlm", (32, 128, 30522), 0.15, False),
             ("nsp", (32, 2), 1.0, False),
             ("gpt", (8, 1024, 50304), 0.99, True))
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        isz = torch.empty((), dtype=dtype).element_size()
        for name, shape, frac, strided in cases:
            V = shape[-1]
            full = (2 * torch.randn(*shape, generator=g, device="cuda")
                    ).to(dtype)
            z = full[:, :-1] if strided else full
            lead = tuple(z.shape[:-1])
            keep = torch.rand(lead, generator=g, device="cuda") < frac
            lab = torch.where(keep, torch.randint(
                0, V, lead, generator=g, device="cuda"), -100)
            flat = lab.reshape(-1).contiguous()
            n, n_valid = flat.numel(), int(keep.sum())
            gr = torch.randn(n, generator=g, device="cuda")
            loss, lse = SX.softmax_xent_fwd(z, flat)
            dz = SX.softmax_xent_bwd(z, flat, lse, gr)
            torch.cuda.synchronize()
            if not torch.all(dz.reshape(n, V)[~keep.reshape(-1)] == 0):
                fail(f"softmax_xent_bwd {tag} {name}: an ignored row's "
                     "gradient is not exactly 0")
            logp = torch.log_softmax(z.reshape(n, V), -1)
            zero = torch.zeros((), dtype=dtype, device="cuda")
            gd = gr.to(dtype)
            # the library takes [N, V] rows: a view of BERT's logits, a
            # copy of GPT's strided logits[:, :-1] (timed with the call)
            desc = f"{tag} {name} N={n} V={V}" + (
                " (strided rows)" if strided else "")
            rec_f = compare(
                torch, f"softmax_xent {desc}",
                lambda: SX.softmax_xent_fwd(z, flat),
                lambda: SX.softmax_xent_plain(z, flat),
                lambda: F.cross_entropy(z.reshape(n, V), flat,
                                        reduction="none"), dtype,
                n * V * isz + 16 * n, 4 * n * V, PEAK_F32)
            rec_b = compare(
                torch, f"softmax_xent_bwd {desc}",
                lambda: SX.softmax_xent_bwd(z, flat, lse, gr),
                lambda: SX.softmax_xent_bwd_plain(z, flat, lse, gr),
                lambda: torch.ops.aten._log_softmax_backward_data(
                    torch.ops.aten.nll_loss_backward(
                        gd, logp, flat, None, 0, -100, zero), logp, 1,
                    dtype), dtype,
                (n_valid + n) * V * isz + 16 * n, 4 * n_valid * V, PEAK_F32)
            if dtype == torch.bfloat16 and name == "mlm":
                main["softmax_xent"], main["softmax_xent_bwd"] = rec_f, rec_b
            del full, z, dz, logp
    torch.cuda.synchronize()
    return main


def sdpa_masked_backward(torch, q, k, v, do, bias):
    """The library yardstick for the masked attention backward: one call
    of PyTorch's memory-efficient attention backward, on the same inputs
    in its [B, H, S, D] layout, with the bias as it takes it (in q's
    dtype, its rows padded to a multiple of 16), from its own forward."""
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    B, H, S, _ = qt.shape
    sp = -(-S // 16) * 16
    lib_bias = torch.zeros(B, H, S, sp, dtype=q.dtype,
                           device=q.device)[..., :S]
    lib_bias.copy_(bias)
    out, lse, seed_t, offset_t = \
        torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, lib_bias, True, 0.0, False)
    return lambda: \
        torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            dot, qt, kt, vt, lib_bias, out, lse, seed_t, offset_t, 0.0,
            [True, True, True, False], False)


def masked_attention_phase(torch, K):
    """The non-causal and masked forms of the three attention kernels
    against their plain versions: BERT-base's shape (B = 32, S = 128,
    H = 12, D = 64), non-causal without a mask and with its [B, 1, 1, S]
    bool padding mask (seeded lengths 64-128), and B = 4, S = 77 causal
    with an additive [B, 1, S, S] mask; float32 and bfloat16.  The library
    yardstick is scaled_dot_product_attention with the same mask,
    forward, and its memory-efficient backward (bf16).  Returns the
    records of the bf16 padding-mask case."""
    F = torch.nn.functional
    KF = K.flash_attention
    g = torch.Generator(device="cuda").manual_seed(6)
    H, D = 12, 64
    main = {}
    forms = (("non-causal", 32, 128, False, None),
             ("bool-padding", 32, 128, False, "bool"),
             ("causal+additive", 4, 77, True, "additive"))
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        isz = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16_TENSOR
        for form, B, S, causal, kind in forms:
            qkv = torch.randn(B, S, 3, H, D, generator=g,
                              device="cuda").to(dtype)
            q, k, v = qkv.unbind(2)
            do = torch.randn(B, S, H, D, generator=g,
                             device="cuda").to(dtype)
            mask, pairs, bias_bytes = None, B * H * S * S, 0
            if kind == "bool":
                lens = torch.randint(64, S + 1, (B,), generator=g,
                                     device="cuda")
                mask = (torch.arange(S, device="cuda")[None, :]
                        < lens[:, None])[:, None, None, :]
                pairs, bias_bytes = H * S * int(lens.sum()), B * S * 4
            elif kind == "additive":
                mask = torch.randn(B, 1, S, S, generator=g, device="cuda")
                pairs, bias_bytes = B * H * S * (S + 1) // 2, B * S * S * 4
            bias = None if mask is None else KF.fold_mask(mask, B, H, S, S)
            # the library's additive mask: the same bias in q's dtype, the
            # causal part as -inf (SDPA refuses a mask with is_causal)
            lib_mask = None if bias is None else bias.to(dtype)
            if causal:
                upper = torch.ones(S, S, dtype=torch.bool,
                                   device="cuda").triu(1)
                lib_mask = lib_mask.masked_fill(upper, float("-inf"))
            o, lse = KF.flash_attention(q, k, v, causal, bias)
            delta = KF.flash_attention_delta(o, do)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_bwd = None if dtype == torch.float32 else \
                sdpa_masked_backward(
                    torch, q, k, v, do,
                    torch.zeros(B, H, S, S, device="cuda")
                    if lib_mask is None else lib_mask)
            one = B * S * H * D * isz
            stats = 2 * B * H * S * 4
            desc = f"{tag} {form} B={B} S={S} H={H} D={D}"
            fkw = dict(causal=causal, bias=bias)
            rec = {"flash_attention": compare(
                torch, f"flash_attention {desc}",
                lambda: KF.flash_attention(q, k, v, **fkw)[0],
                lambda: KF.flash_attention_plain(q, k, v, **fkw)[0],
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=lib_mask), dtype,
                4 * one + B * H * S * 4 + bias_bytes, 4 * D * pairs, peak,
                variant=("flash_attention", variant_of(dtype)))}
            rec["flash_attention_dq"] = compare(
                torch, f"flash_attention_dq {desc}",
                lambda: KF.flash_attention_dq(q, k, v, do, lse, delta, **fkw),
                lambda: KF.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                                    **fkw),
                lib_bwd, dtype, 5 * one + stats + bias_bytes, 6 * D * pairs,
                peak, variant=("flash_attention_dq", variant_of(dtype)))
            rec["flash_attention_dkv"] = compare(
                torch, f"flash_attention_dkv {desc}",
                lambda: KF.flash_attention_dkv(q, k, v, do, lse, delta,
                                               **fkw),
                lambda: KF.flash_attention_dkv_plain(q, k, v, do, lse,
                                                     delta, **fkw),
                lib_bwd, dtype, 6 * one + stats + bias_bytes, 8 * D * pairs,
                peak, variant=("flash_attention_dkv", variant_of(dtype)))
            if dtype == torch.bfloat16 and form == "bool-padding":
                main = rec
    torch.cuda.synchronize()
    return main


def profile_steps(torch, tag, step):
    """Two more steps under torch.profiler: wall, busy share, launches
    and the largest device entries."""
    def two_steps():
        step()
        step()

    wall_ms, busy_ms, launches, top = profile_window(torch, two_steps)
    if busy_ms is None:
        log(f"[{tag}] no device time in the trace: busy share not measured")
    else:
        log(f"[{tag}] 2 steps: wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.2f}%), {launches} "
            f"kernel launches; top: {top}")


def gpt_labels_phase(torch, K, cfg):
    """Full-width bfloat16 GPT-2-small, B = 8, S = 1024: forward(ids,
    labels) — the softmax cross-entropy kernels on the strided view
    logits[:, :-1] — against loss(ids) (the float32 fused LM-head loss),
    and one backward through the kernels."""
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTForCausalLM

    seed(0)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16).train()
    ids = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, (8, 1024))).cuda()
    K.reset_launch_counts()
    variants = K.variant_launches()
    t0 = time.perf_counter()
    logits, loss = model(ids, labels=ids)
    loss.backward()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    require_fast_variants(K, variants, "gpt-labels", TRAINING_FAST)
    with torch.no_grad():
        ref = model.loss(ids).item()
    got = loss.item()
    tol = BF16_TOL * max(1.0, abs(ref))
    grads_ok = all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())
    for name in TRAINING_KERNELS + XENT_KERNELS:
        if counts[name] <= 0:
            fail(f"gpt-labels: kernel {name} was not launched")
    if not math.isfinite(got) or abs(got - ref) > tol or not grads_ok:
        fail(f"gpt-labels: forward(ids, labels) loss {got} vs loss(ids) "
             f"{ref} (tol {tol:.3e}), finite gradients {grads_ok}")
    log(f"[gpt-labels] bf16 full width B=8 S=1024: forward(ids, labels) "
        f"loss {got:.5f} vs loss(ids) {ref:.5f} (|d| {abs(got - ref):.3e}, "
        f"tol {tol:.3e} = 2^-6 x max(1, |ref|): bf16 logits against the "
        f"float32 fused head); logits {tuple(logits.shape)} "
        f"{logits.dtype}; forward + backward {secs:.3f}s; every gradient "
        f"finite; launches {counts}")


def bert_batch(torch, rs, cfg, B, S):
    """Seeded BERT pretraining inputs: ids, two segments, about 15 % of
    the tokens carrying an MLM label (the rest -100), NSP labels."""
    ids = rs.randint(0, cfg.vocab_size, (B, S))
    cut = rs.randint(S // 4, 3 * S // 4, (B, 1))
    tt = (np.arange(S)[None, :] >= cut).astype(np.int64)
    mlm = np.where(rs.rand(B, S) < 0.15,
                   rs.randint(0, cfg.vocab_size, (B, S)), -100)
    nsp = rs.randint(0, 2, (B,))
    return [torch.from_numpy(a) for a in (ids, tt, mlm, nsp)]


def padding_mask(torch, rs, B, S):
    """[B, 1, 1, S] bool key-padding mask (True = attend) from seeded
    lengths 64..S, and the lengths."""
    lens = rs.randint(64, S + 1, B)
    mask = torch.from_numpy(np.arange(S)[None, :] < lens[:, None])
    return mask[:, None, None, :], lens


def bert_parity_phase(torch, K):
    """Full-width float32 BertForPretraining (BertConfig() defaults,
    dropout 0), B = 2, S = 128: loss() and every parameter's gradient,
    and the masked forward's MLM and NSP logits, on the card (kernels)
    against the CPU (plain versions), from the same seeded weights."""
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    cfg = BertConfig(dropout=0.0)
    rs = np.random.RandomState(6)
    ids, tt, mlm, nsp = bert_batch(torch, rs, cfg, 2, 128)
    mask, lens = padding_mask(torch, rs, 2, 128)
    res = {}
    for device in ("cpu", "cuda"):
        seed(0)
        model = BertForPretraining(cfg, device=device).train()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss = model.loss(ids.to(device), mlm.to(device), nsp.to(device),
                          tt.to(device))
        loss.backward()
        with torch.no_grad():
            logits = model(ids.to(device), tt.to(device), mask.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
            counts = K.launch_counts()
        res[device] = (loss.item(), {n: p.grad for n, p in
                                     model.named_parameters()},
                       [x.float().cpu() for x in logits],
                       time.perf_counter() - t0)
        del model, loss
    (loss_g, grads_g, lg_g, t_g), (loss_c, grads_c, lg_c, t_c) = \
        res["cuda"], res["cpu"]
    for name in BERT_KERNELS:
        if counts[name] <= 0:
            fail(f"bert-parity: kernel {name} was not launched")
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    worst, worst_name = 0.0, None
    for name, ref in grads_c.items():
        got = grads_g[name]
        if got is None or not torch.isfinite(got).all():
            fail(f"bert-parity: {name} has no finite gradient on the card")
        # the key projection's bias has an exactly-zero gradient (softmax
        # is shift-invariant over a query's keys): both sides give
        # rounding noise, held against the scale of the same layer's
        # query-bias gradient instead of its own
        scale = grads_c[name.replace("k_proj.bias", "q_proj.bias")]
        rel = ((got.cpu() - ref).abs().max()
               / scale.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    logit_rel = max(((a - r).abs().max() / r.abs().max()).item()
                    for a, r in zip(lg_g, lg_c))
    if loss_rel > GRAD_REL_TOL or worst > GRAD_REL_TOL \
            or not logit_rel <= LOGITS_REL_TOL:
        fail(f"bert-parity: loss rel {loss_rel:.3e}, worst gradient "
             f"{worst_name} rel {worst:.3e}, masked logits rel "
             f"{logit_rel:.3e} (tol {GRAD_REL_TOL})")
    log(f"[bert-parity] full-width f32 BERT-base B=2 S=128: loss() "
        f"{loss_g:.6f} (cpu {loss_c:.6f}, rel {loss_rel:.3e}); "
        f"{len(grads_c)} parameters, every gradient finite on the card; "
        f"worst max|dgrad|/max|ref| {worst:.3e} ({worst_name}; tol "
        f"{GRAD_REL_TOL}; k_proj.bias against its layer's q_proj.bias "
        f"scale); masked forward (lengths {lens.tolist()}) "
        f"max|dlogits|/max|ref| {logit_rel:.3e} (tol {LOGITS_REL_TOL}); "
        f"card {t_g:.2f}s, cpu {t_c:.2f}s; launches {counts}")


def bert_fit_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels):
    """BertForPretraining.loss() on the logits, through F.cross_entropy:
    the MLM loss summed over the labelled tokens over their count, plus
    the mean NSP loss."""
    from paddle_tpu_torch.nn import functional as PF

    mlm = PF.cross_entropy(mlm_logits, mlm_labels, reduction="none")
    denom = (mlm_labels != -100).float().sum().clamp(min=1.0)
    return mlm.sum() / denom + PF.cross_entropy(nsp_logits, nsp_labels)


def bert_train_phase(torch, K, card):
    """Full-width bfloat16 BERT-base, B = 32, S = 128 (bench.py's BERT
    shape): 10 dygraph steps of loss() and AdamW(1e-4, wd 0.01) on one
    seeded batch, a profiled window of 2 more, then 3 Model.fit steps on
    padded batches with their attention mask.  Returns the launch counts
    of the 10 dygraph steps."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    B, S, steps = 32, 128, 10
    cfg = BertConfig(dropout=0.0)
    seed(0)
    model = BertForPretraining(cfg, device="cuda",
                               dtype=torch.bfloat16).train()
    n_params = sum(p.numel() for p in model.parameters())
    rs = np.random.RandomState(7)
    ids, tt, mlm, nsp = (t.cuda() for t in bert_batch(torch, rs, cfg, B, S))
    opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              parameters=model.parameters())

    def step():
        loss = model.loss(ids, mlm, nsp, tt)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    variants = K.variant_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = K.launch_counts()
    fast = require_fast_variants(K, variants, "bert-train", TRAINING_FAST)
    losses = torch.stack(losses).float().cpu().tolist()
    for name in BERT_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the BERT training path")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"BERT training loss did not fall: {losses}")
    p50 = float(np.median(times))
    tokens = B * S
    # bench.py's encoder model-FLOPs convention (bench.py:795)
    flops = 6.0 * n_params * tokens \
        + cfg.num_layers * 12 * S * S * cfg.hidden_size * B
    per_step = {n: counts[n] / steps for n in BERT_KERNELS}
    log(f"[bert-train] bf16 BERT-base B={B} S={S}, {n_params} parameters, "
        f"AdamW(1e-4, wd 0.01) on {card}: losses {losses}; step ms "
        f"{[round(t * 1e3, 3) for t in times]}; p50 {p50 * 1e3:.3f} ms; "
        f"{B / p50:.1f} samples/s; {tokens / p50:.1f} tokens/s; "
        f"{mfu_text(flops, p50)}; peak memory "
        f"{peak_text(torch, start)}; launches "
        f"per step {per_step}; tensor-core and vector-kernel launches {fast}")
    profile_steps(torch, "bert-profile", step)

    data = bert_batch(torch, rs, cfg, 3 * B, S)
    mask, lens = padding_mask(torch, rs, 3 * B, S)
    api = ptt.Model(model, labels=["mlm_labels", "nsp_labels"]).prepare(
        opt, bert_fit_loss)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    hist = api.fit(ptt.io.TensorDataset([data[0], data[1], mask, data[2],
                                         data[3]]),
                   batch_size=B, epochs=1, shuffle=False, verbose=0,
                   log_freq=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = K.launch_counts()
    require_fast_variants(K, variants, "bert-train and Model.fit",
                          TRAINING_FAST)
    if len(hist["step_loss"]) != 3 or not all(
            math.isfinite(x) for x in hist["step_loss"]):
        fail(f"BERT Model.fit: step losses {hist['step_loss']}")
    for name in BERT_KERNELS:
        if fit_counts[name] <= 0:
            fail(f"kernel {name} was not launched on the BERT Model.fit "
                 "path")
    log(f"[bert-fit] Model.fit 3 steps of B={B} S={S}, inputs [ids, "
        f"token_type_ids, [B, 1, 1, S] bool mask] (lengths "
        f"{int(lens.min())}-{int(lens.max())}, mean {lens.mean():.1f}), "
        f"labels [mlm, nsp], loss on the logits through F.cross_entropy: "
        f"step losses {hist['step_loss']}; {fit_s:.3f}s; every attention "
        f"launch took the mask; launches {fit_counts}")
    return counts


def peak_text(torch, start):
    """The peak memory since the last reset, and its part above the
    ``start`` the phase found allocated."""
    peak = torch.cuda.max_memory_allocated()
    return (f"{peak / 2 ** 30:.2f} GiB ({(peak - start) / 2 ** 30:.3f} "
            f"above the phase's start)")


def release(torch, phase):
    """Free what the finished phases left before ``phase``, so its peak
    memory is its own: objects in reference cycles (a finished request's
    handle and the request refer to each other, and the request to its
    engine and KV pool) wait for the cyclic collector, whose timing
    depends on how many objects the run made."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[memory] before {phase}: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated")


def sass_phase(paths):
    """The machine code of the two attention libraries must hold
    tensor-core opcodes (HMMA) and asynchronous copies (LDGSTS):
    counted with cuobjdump where the toolkit has it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("[build] no cuobjdump: SASS not checked")
        return
    for name in ("flash_attention", "flash_attention_bwd"):
        sass = subprocess.run([tool, "-sass", str(paths[name])], check=True,
                              capture_output=True, text=True).stdout
        hmma, ldgsts = sass.count("HMMA."), sass.count("LDGSTS")
        if hmma == 0 or ldgsts == 0:
            fail(f"{name}: {hmma} HMMA and {ldgsts} LDGSTS opcodes in the "
                 "SASS: the tensor-core kernel is not there")
        log(f"[build] {name}: SASS holds {hmma} HMMA (tensor-core) and "
            f"{ldgsts} LDGSTS (cp.async) opcodes")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch.ops.kernels as K
        from paddle_tpu_torch.framework.random import seed
        from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                             load_numpy_state)
        from paddle_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"[build] {len(paths)} kernel libraries ready in "
        f"{time.perf_counter() - t0:.1f}s (nvcc {build.last_build_seconds:.1f}s)")
    spills = []
    for name, path in paths.items():
        log_path = path.with_suffix(".log")
        if not log_path.exists():
            continue
        entry = ""
        for line in log_path.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:       # a mangled name: keep the kernel and its parameters
                k = re.search(r"\d([a-z][a-z_]*_kernel)(I\w*?E)?E?v",
                              m.group(1))
                entry = "".join(filter(None, k.groups())) if k \
                    else m.group(1)
            if "registers" in line or "spill" in line:
                if "spill" in line and " 0 bytes spill stores" not in line:
                    spills.append(f"{entry}: {line.strip()}")
                log(f"[build] {name} {entry}: {line.strip()}")
    if spills:
        fail(f"ptxas reports register spills: {spills}")
    sass_phase(paths)

    main_cases = kernel_phase(torch, K)
    main_cases.update(backward_kernel_phase(torch, K))
    main_cases.update(xent_kernel_phase(torch, K))
    bert_attention = masked_attention_phase(torch, K)
    unaligned_phase(torch, K)

    cfg = GPTConfig(dropout=0.0, attn_dropout=0.0)
    seed(0)
    model = GPTForCausalLM(cfg, device="cuda")
    model.eval()
    model_cpu = GPTForCausalLM(cfg, device="cpu")
    load_numpy_state(model_cpu, {k: v.cpu().numpy()
                                 for k, v in model.state_dict().items()})
    model_cpu.eval()
    logits_phase(torch, model, model_cpu)
    del model_cpu

    model.to(dtype=torch.bfloat16)
    serve_counts = serving_phase(torch, K, model, card)
    torch.cuda.synchronize()
    del model
    release(torch, "GPT training")

    train_parity_phase(torch, K, cfg)
    train_counts = train_phase(torch, K, cfg, card)
    gpt_labels_phase(torch, K, cfg)
    torch.cuda.synchronize()
    release(torch, "BERT")

    bert_parity_phase(torch, K)
    release(torch, "BERT training")
    bert_counts = bert_train_phase(torch, K, card)
    torch.cuda.synchronize()

    kernels = []
    for name, rec in main_cases.items():
        source, replaces = REPLACES[name]
        # each kernel's launches on its own path: serving for the forward
        # kernels of slice 1, the 10 GPT training steps for the backward
        # ones, the 10 BERT training steps for the cross-entropy kernels
        counts = serve_counts if name in SERVING_KERNELS else (
            bert_counts if name in XENT_KERNELS else train_counts)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
        if name in FAST_VARIANT:
            entry["variant"] = rec["variant"]
        if name in MMA_KERNELS:
            entry["tflops"] = rec["tflops"]
        if name in ATTENTION_KERNELS:
            # every form held against its plain version in this run; the
            # main numbers stay the GPT paths' causal case, and the BERT
            # path's padding-mask case stands beside them with its launches
            b = bert_attention[name]
            entry["forms"] = ["causal", "non-causal", "bool-padding",
                              "causal+additive"]
            entry["bert_padding_mask"] = {
                "launches": bert_counts[name], "ms": b["ms"],
                "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": b["library_ms"],
                "max_abs_err": b["max_abs_err"]}
        kernels.append(entry)
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
