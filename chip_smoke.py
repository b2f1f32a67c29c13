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
                  every serving kernel's launch count must be > 0.
6. train-parity — full-width float32, B = 2, S = 128: loss(ids) and every
                  parameter's gradient on the card against the CPU's.
7. train        — full-width bfloat16, B = 8, S = 1024: 10 dygraph AdamW
                  steps on one batch (the loss must fall; step time,
                  tokens/s, MFU), a profiled window, then Model.fit steps;
                  every training kernel's launch count must be > 0.

The line before the last is the per-kernel JSON record; the last line is
the result JSON.  Float32 phases run with TF32 off for matmuls and cuDNN.
"""
import json
import math
import subprocess
import sys
import time

import numpy as np

F32_TOL = 2e-5       # x max(1, max|ref|): float32 summation-order noise
BF16_TOL = 2 ** -6   # x max(1, max|ref|): two bf16 ulps at the top binade
LOGITS_REL_TOL = 1e-3  # max|dlogits| / max|ref| over 12 layers, float32
GRAD_REL_TOL = 1e-3    # max|dgrad| / max|ref| per parameter, float32
HBM_BYTES_PER_S = 3.35e12
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
}
SERVING_KERNELS = ("layer_norm", "bias_gelu", "flash_attention",
                   "paged_decode_attention")
TRAINING_KERNELS = ("layer_norm", "bias_gelu", "flash_attention",
                    "bias_gelu_bwd", "flash_attention_dq",
                    "flash_attention_dkv")


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


def bound_ms(n_bytes, n_flops, peak):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def compare(torch, name, kernel_fn, plain_fn, library_fn, dtype, n_bytes,
            n_flops, peak):
    """Run kernel and plain version on the same inputs, check, time.  A
    function may return one tensor or a tuple (dk, dv)."""
    outs, refs = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
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
    log(f"[kernels] {name}: max_abs_err={err:.3e} tol={tol:.3e} | device "
        f"ms: kernel={rec['ms']} plain={rec['plain_ms']} "
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
                (2 * R * N + 2 * N) * isz, 8 * R * N, PEAK_F32)
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
                4 * B * S * H * D * isz + B * H * S * 4, 4 * D * pairs, peak)
            if dtype == torch.bfloat16 and B == 1 and S == 128:
                main["flash_attention"] = rec
        slots, nh, hd, ps, pps = 8, 12, 64, 16, 32
        num_pages = slots * pps
        pos = torch.tensor([511, 15, 16, 100, 255, 37, 480, 0],
                           dtype=torch.int32, device=dev)
        perm = torch.randperm(num_pages, generator=g, device=dev)
        rows = torch.full((slots, pps), -1, dtype=torch.int32, device=dev)
        live = 0
        for lane in range(slots - 1):             # the last lane: inactive
            n = int(pos[lane]) // ps + 1
            rows[lane, :n] = perm[lane * pps:lane * pps + n].to(torch.int32)
            live += int(pos[lane]) + 1
        kp, vp = rnd(num_pages, ps, nh, hd), rnd(num_pages, ps, nh, hd)
        q = rnd(slots, 1, 3, nh, hd)[:, 0, 0]
        rec = compare(
            torch, f"paged_decode_attention {tag} slots={slots} nh={nh} "
            f"hd={hd} page={ps} pps={pps}",
            lambda: K.paged_attention.paged_decode_attention(
                q, kp, vp, rows, pos, pps * ps),
            lambda: K.paged_attention.paged_decode_attention_plain(
                q, kp, vp, rows, pos, pps * ps),
            None, dtype,
            2 * live * nh * hd * isz + 2 * slots * nh * hd * isz
            + slots * (pps + 1) * 4, 4 * live * nh * hd, peak)
        if dtype == torch.bfloat16:
            main["paged_decode_attention"] = rec
    torch.cuda.synchronize()
    return main


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
    B = 8, H = 12, D = 64 and S = 128, 1024); returns the record of each
    kernel at its main case (bfloat16, S = 1024)."""
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

        R, Fd = 8192, 3072
        x, b, dy = rnd(R, Fd, scale=2.0), rnd(Fd, scale=0.5), rnd(R, Fd)
        rec = compare(
            torch, f"bias_gelu_bwd {tag} R={R} F={Fd}",
            lambda: K.bias_gelu.bias_gelu_bwd(x, b, dy),
            lambda: K.bias_gelu.bias_gelu_bwd_plain(x, b, dy),
            lambda: torch.ops.aten.gelu_backward(dy, x + b), dtype,
            (3 * R * Fd + Fd) * isz, 12 * R * Fd, PEAK_F32)
        if dtype == torch.bfloat16:
            main["bias_gelu_bwd"] = rec
        B, H, D = 8, 12, 64
        for S in (128, 1024):
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
                lib, dtype, 5 * one + stats, 6 * D * pairs, peak)
            rec_kv = compare(
                torch, f"flash_attention_dkv {tag} {shape}",
                lambda: KF.flash_attention_dkv(q, k, v, do, lse, delta),
                lambda: KF.flash_attention_dkv_plain(q, k, v, do, lse,
                                                     delta),
                lib, dtype, 6 * one + stats, 8 * D * pairs, peak)
            if dtype == torch.bfloat16 and S == 1024:
                main["flash_attention_dq"] = rec_q
                main["flash_attention_dkv"] = rec_kv
    torch.cuda.synchronize()
    return main


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
    launches, the ten kernels that take the most device time).  Busy =
    the sum of kernel times over the window (one stream, so kernels do
    not overlap); None when the trace holds no device time."""
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
        t0 = time.perf_counter()
        handles = []
        for i, p in enumerate(prompts):
            kw = (dict(do_sample=True, temperature=0.8, top_k=8, seed=i)
                  if i % 2 else {})
            handles.append(eng.submit(p, 48, **kw))
        outs = [h.result(600) for h in handles]
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
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
        profile_wave(torch, eng, prompts[:8])
        total = sum(len(o) for o in outs)
        log(f"[serving] 16 requests (prompts 20-128, 48 new tokens, "
            f"greedy/sampled alternating) on {card}: "
            f"{total} tokens in {wall:.3f}s = {total / wall:.1f} tokens/s; "
            f"TTFT p50 {snap['ttft_p50_ms']:.3f} ms; inter-token p50 "
            f"{snap['inter_token_p50_ms']:.3f} ms; launches {counts}; "
            f"greedy re-run alone identical; free_count back to "
            f"{eng.geometry.num_pages}")
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
    K.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = K.launch_counts()
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
        f"{tokens / p50:.1f} tokens/s; MFU {flops / p50 / PEAK_BF16_TENSOR:.4f}"
        f" ({flops:.4e} flops/step / {PEAK_BF16_TENSOR:.0e}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
        f"per step {per_step}")

    def two_steps():
        step()
        step()

    wall_ms, busy_ms, launches, top = profile_window(torch, two_steps)
    if busy_ms is None:
        log("[train-profile] no device time in the trace: busy share not "
            "measured")
    else:
        log(f"[train-profile] 2 steps: wall {wall_ms:.3f} ms, device busy "
            f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.2f}%), {launches} "
            f"kernel launches; top: {top}")

    data = torch.from_numpy(rs.randint(0, cfg.vocab_size, (3 * B, S)))
    api = ptt.Model(model).prepare(opt, lm_loss)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    hist = api.fit(ptt.io.TensorDataset([data, data]), batch_size=B,
                   epochs=1, shuffle=False, verbose=0, log_freq=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = K.launch_counts()
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
    for name, path in paths.items():
        log_path = path.with_suffix(".log")
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")

    main_cases = kernel_phase(torch, K)
    main_cases.update(backward_kernel_phase(torch, K))

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
    torch.cuda.empty_cache()

    train_parity_phase(torch, K, cfg)
    train_counts = train_phase(torch, K, cfg, card)
    torch.cuda.synchronize()

    kernels = []
    for name, rec in main_cases.items():
        source, replaces = REPLACES[name]
        # each kernel's launches on its own path: serving for the forward
        # kernels of slice 1, the 10 training steps for the backward ones
        counts = serve_counts if name in SERVING_KERNELS else train_counts
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
