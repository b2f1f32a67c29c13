"""The port's CUDA kernels on the card, at shapes the serving and training
paths do not reach: odd row counts and widths, S = 1, head dims 16-128,
page sizes 1 and 5, unmapped and out-of-pool page ids, an inactive lane,
odd vocab sizes, strided logits, every mask form of attention, causal or
not.  Each kernel, forward and backward, and each of the two kernels an
entry chooses between (by dtype and 16-byte alignment), is held against
its plain PyTorch version on the same inputs; paged decode's split kernel
is bitwise reproducible and independent of its batch mates; a decode step
of the engine syncs once, to fetch its tokens; a tiny GPT's and a tiny
BERT's loss and gradients on the card are held against the CPU's; the
whole-tree optimizer kernel gives bitwise the per-parameter loop's
parameters and moments and makes no host sync; the serving engine's
decode step, captured once as a CUDA graph at ``start()``, gives the
eager step's tokens bitwise through hits, chunks, both sampling modes, a
mid-decode admission and a cancel, is never captured again, leaves the
idle state as it was, and a replayed step syncs once; ``Model.fit``'s
resume from a checkpoint (after a SIGTERM, and into graphs already
captured) is bitwise the unbroken run at dropout 0.1; ``generate``'s
decode step, captured once a key, gives the eager step's tokens bitwise
(greedy, sampled, beam, eos), a later call of a key makes no host sync,
the capture counts its kernels and a replayed call's trace shows their
fast variants, and HF interop onto a card model keeps the parameters'
device and dtype; a capture survives dead graphs held in reference
cycles with the collector run inside it (ops/capture.py); the serving
engine's speculative step, one graph, gives the eager step's tokens
bitwise, a replayed step syncs once, and ``slot_verify_paged`` on the
card matches its CPU run; a serving fleet of replica processes on the
card survives a SIGKILL mid-stream, the engine's chaos seam adds no sync
to a replayed step, and a replica whose capture fails exits non-zero.
Needs a CUDA device (skips elsewhere); on the
card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance, relative to max(1, max|ref|): float32 2e-5 (summation order),
bfloat16 2**-6 (two ulps at the top binade: both sides accumulate in
float32 and round once at the end; the tensor-core attention kernels also
round p and ds to bf16 before the second product, as the reference does,
which stays well inside it).
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.ops.kernels import (bias_gelu, flash_attention,
                                          layer_norm, paged_attention)
from paddle_tpu_torch.ops.kernels import optimizer as multi_tensor

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]
# what torch.cuda.set_sync_debug_mode("warn") says at a synchronizing call
SYNC_WARNING = "called a synchronizing CUDA operation"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _check(out, ref, dtype):
    torch.cuda.synchronize()
    scale = max(1.0, ref.float().abs().max().item())
    tol = (2e-5 if dtype == torch.float32 else 2 ** -6) * scale
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,n", [(1, 7), (3, 768), (8, 768), (1000, 768),
                                    (5, 100), (4, 776), (2, 2048),
                                    (5, 8192)])
@pytest.mark.parametrize("offset", [0, 1])
def test_layer_norm_kernel(dev, dtype, rows, n, offset):
    """y, and the mean and rstd the training path saves, against the plain
    version: widths on both sides of the vector kernel's limits (a multiple
    of 16 bytes, at most 256 vectors, partly filled lanes), the serving
    path's R = 8, and x a view one element off a 16-byte boundary
    (``offset`` 1).  The C entry takes the warp-per-row vector kernel
    exactly where the width and alignment allow, else the block-per-row
    kernel."""
    g = torch.Generator(device=dev).manual_seed(rows + n)
    buf = (torch.randn(rows * n + 8, generator=g, device=dev) * 3 + 1).to(
        dtype)
    x = buf[offset:offset + rows * n].view(rows, n)
    w = (1 + 0.1 * torch.randn(n, generator=g, device=dev)).to(dtype)
    b = (0.1 * torch.randn(n, generator=g, device=dev)).to(dtype)
    variants = layer_norm.variant_launches()["layer_norm"]
    before = layer_norm.layer_norm.launches
    out = layer_norm.layer_norm(x, w, b)
    assert layer_norm.layer_norm.launches == before + 1
    _check(out, layer_norm.layer_norm_plain(x, w, b), dtype)
    y, mean, rstd = layer_norm._forward(x, w, b, 1e-5, stats=True)
    ref_y, ref_mean, ref_rstd = layer_norm._plain_with_stats(x, w, b, 1e-5)
    _check(y, ref_y, dtype)
    _check(mean, ref_mean, torch.float32)
    _check(rstd, ref_rstd, torch.float32)
    per = 16 // x.element_size()          # elements in a 16-byte vector
    vector = offset == 0 and n % per == 0 and n <= 256 * per
    after = layer_norm.variant_launches()["layer_norm"]
    taken = "warp" if vector else "block"
    other = "block" if vector else "warp"
    assert after[taken] - variants[taken] == 2
    assert after[other] == variants[other]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,n", [(1, 5), (3, 3072), (257, 3072)])
def test_bias_gelu_kernel(dev, dtype, rows, n):
    g = torch.Generator(device=dev).manual_seed(rows + n)
    x = (2 * torch.randn(rows, n, generator=g, device=dev)).to(dtype)
    b = (0.5 * torch.randn(n, generator=g, device=dev)).to(dtype)
    _check(bias_gelu.bias_gelu(x, b), bias_gelu.bias_gelu_plain(x, b),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,D", [(1, 64), (7, 16), (65, 64), (200, 128),
                                 (130, 32)])
def test_flash_attention_kernel(dev, dtype, S, D):
    g = torch.Generator(device=dev).manual_seed(S * D)
    qkv = torch.randn(2, S, 3, 3, D, generator=g, device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, lse = flash_attention.flash_attention(q, k, v)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v)
    _check(out, ref, dtype)
    _check(lse, ref_lse, torch.float32 if dtype == torch.float32 else dtype)


def test_flash_attention_rejects_unsupported_head_dim(dev):
    x = torch.zeros(1, 4, 2, 24, device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(x, x, x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps,hd", [(1, 64), (5, 12), (16, 128)])
def test_paged_decode_kernel(dev, dtype, ps, hd):
    g = torch.Generator(device=dev).manual_seed(ps * hd)
    slots, nh, pps, num_pages = 6, 3, 6, 24
    pos = torch.tensor([0, ps - 1, ps, 3 * ps + 1, pps * ps - 1, 2],
                       dtype=torch.int32, device=dev)
    rows = torch.full((slots, pps), -1, dtype=torch.int32, device=dev)
    perm = torch.randperm(num_pages, generator=g, device=dev).to(torch.int32)
    for lane in range(slots - 1):            # the last lane: inactive
        n = int(pos[lane]) // ps + 1
        rows[lane, :n] = perm[(lane * 4) % (num_pages - n):][:n]
    rows[3, 1] = num_pages + 7               # out of the pool: skipped
    q = torch.randn(slots, 1, 3, nh, hd, generator=g,
                    device=dev).to(dtype)[:, 0, 0]
    kp = torch.randn(num_pages, ps, nh, hd, generator=g,
                     device=dev).to(dtype)
    vp = torch.randn(num_pages, ps, nh, hd, generator=g,
                     device=dev).to(dtype)
    out = paged_attention.paged_decode_attention(q, kp, vp, rows, pos,
                                                 pps * ps)
    ref = paged_attention.paged_decode_attention_plain(q, kp, vp, rows, pos,
                                                       pps * ps)
    _check(out, ref, dtype)
    assert torch.all(out[-1] == 0)


def _paged_inputs(dev, dtype, lane_pos, ps, hd, nh, pps, offset=0,
                  seed=0):
    """Lanes with inclusive extents ``lane_pos`` (-1: inactive, an all -1
    row at pos 0) over page tables scattered through the pool; q a [slots,
    nh, hd] view starting ``offset`` elements into its buffer."""
    g = torch.Generator(device=dev).manual_seed(seed)
    slots = len(lane_pos)
    num_pages = slots * pps
    pos = torch.tensor([max(p, 0) for p in lane_pos], dtype=torch.int32,
                       device=dev)
    perm = torch.randperm(num_pages, generator=g, device=dev).to(torch.int32)
    rows = torch.full((slots, pps), -1, dtype=torch.int32, device=dev)
    for lane, p in enumerate(lane_pos):
        if p >= 0:
            n = p // ps + 1
            rows[lane, :n] = perm[lane * pps:lane * pps + n]
    n = slots * nh * hd
    q = torch.randn(n + 8, generator=g, device=dev).to(dtype)[
        offset:offset + n].view(slots, nh, hd)
    kp = torch.randn(num_pages, ps, nh, hd, generator=g, device=dev).to(dtype)
    vp = torch.randn(num_pages, ps, nh, hd, generator=g, device=dev).to(dtype)
    return q, kp, vp, rows, pos


def _paged_variant_check(dev, inputs, seq_cap, dtype, variant):
    """The kernel against the plain version, through the variant named;
    the split kernel's arrival counters are all back to 0 afterwards."""
    before = paged_attention.variant_launches()["paged_decode_attention"]
    out = paged_attention.paged_decode_attention(*inputs, seq_cap)
    ref = paged_attention.paged_decode_attention_plain(*inputs, seq_cap)
    _check(out, ref, dtype)
    after = paged_attention.variant_launches()["paged_decode_attention"]
    other = "lane" if variant == "split" else "split"
    assert after[variant] == before[variant] + 1
    assert after[other] == before[other]
    assert not paged_attention._arrivals[inputs[0].device.index].any()
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps", [1, 8, 16, 32])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("variant", ["split", "lane"])
def test_paged_decode_variants(dev, dtype, ps, hd, variant):
    """Both kernels against the plain version over lanes of very different
    lengths (256 tokens beside 4, an inactive lane, one ending at a page
    boundary): the split kernel on aligned operands, the block per (head,
    lane) on a q one element off a 16-byte boundary."""
    pps = -(-256 // ps)
    inputs = _paged_inputs(dev, dtype, (255, 3, -1, 63, 127, 0, 200), ps,
                           hd, nh=3, pps=pps,
                           offset=0 if variant == "split" else 1,
                           seed=ps * hd)
    out = _paged_variant_check(dev, inputs, pps * ps, dtype, variant)
    assert torch.all(out[2] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lane_pos", [
    (511, 15, 16, 100, 255, 37, 480, -1),       # the serving table's shape
    (20, 176, 57, 131, 88, 160, 35, 113),       # a serving wave's
])
@pytest.mark.parametrize("variant", ["split", "lane"])
def test_paged_decode_serving_shapes(dev, dtype, lane_pos, variant):
    inputs = _paged_inputs(dev, dtype, lane_pos, 16, 64, nh=12, pps=32,
                           offset=0 if variant == "split" else 1, seed=7)
    _paged_variant_check(dev, inputs, 512, dtype, variant)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_split_is_bitwise_reproducible(dev, dtype):
    """The split kernel merges a lane's chunks in chunk order: two calls
    give bitwise the same output, and each lane's output alone (a batch of
    one) is bitwise its output beside its batch mates."""
    q, kp, vp, rows, pos = _paged_inputs(
        dev, dtype, (511, 15, 16, 100, 255, 37, 480, -1), 16, 64, nh=12,
        pps=32, seed=3)
    first = paged_attention.paged_decode_attention(q, kp, vp, rows, pos, 512)
    again = paged_attention.paged_decode_attention(q, kp, vp, rows, pos, 512)
    assert torch.equal(first, again)
    for lane in range(q.shape[0]):
        alone = paged_attention.paged_decode_attention(
            q[lane:lane + 1], kp, vp, rows[lane:lane + 1],
            pos[lane:lane + 1], 512)
        assert torch.equal(alone[0], first[lane]), lane


def test_engine_greedy_tokens_match_cpu_engine(dev):
    """A tiny float32 model served on the card gives the CPU engine's
    greedy tokens (kernels on one side, plain versions on the other)."""
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = GPTConfig(vocab_size=211, hidden_size=64, num_layers=2,
                    num_heads=4, max_position_embeddings=64, dropout=0.0,
                    attn_dropout=0.0)
    prompts = [np.random.RandomState(i).randint(0, 211, n).tolist()
               for i, n in enumerate((3, 7, 12, 16))]
    outs = {}
    for device in ("cpu", dev):
        seed(0)
        model = GPTForCausalLM(cfg, device=device).eval()
        with GenerationEngine(model, max_slots=3, max_seq_len=40,
                              prompt_buckets="8,16", device=device) as eng:
            hs = [eng.submit(p, 12) for p in prompts]
            outs[str(device)] = [h.result(120) for h in hs]
            assert eng.free_count == eng.geometry.num_pages
    assert outs["cpu"] == outs[str(dev)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 8, 37, 128, 8192])
@pytest.mark.parametrize("n,offset", [(3072, 0), (3072, 1), (3071, 0),
                                      (24, 0), (12, 0)])
def test_bias_gelu_fwd_variants(dev, dtype, rows, n, offset):
    """The forward takes the 16-byte vector kernel exactly where F is a
    multiple of one vector and x, b, y lie on 16-byte boundaries (GPT's
    F = 3072 at a decode step's R = 8, a prefill's 128, training's 8192,
    and ragged row counts), else the scalar loop (x a view one element
    off a boundary, F = 3071, F = 12 in bf16); both against the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(rows + n + offset)
    x = (2 * torch.randn(rows * n + 8, generator=g, device=dev)).to(dtype)[
        offset:offset + rows * n].view(rows, n)
    b = (0.5 * torch.randn(n, generator=g, device=dev)).to(dtype)
    before = bias_gelu.variant_launches()["bias_gelu"]
    out = bias_gelu.bias_gelu(x, b)
    _check(out, bias_gelu.bias_gelu_plain(x, b), dtype)
    per = 16 // x.element_size()
    taken = "vec" if offset == 0 and n % per == 0 else "scalar"
    other = "scalar" if taken == "vec" else "vec"
    after = bias_gelu.variant_launches()["bias_gelu"]
    assert after[taken] == before[taken] + 1
    assert after[other] == before[other]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,n", [(1, 5), (3, 3072), (257, 3072)])
def test_bias_gelu_bwd_kernel(dev, dtype, rows, n):
    g = torch.Generator(device=dev).manual_seed(rows * n)
    x = (2 * torch.randn(rows, n, generator=g, device=dev)).to(dtype)
    b = (0.5 * torch.randn(n, generator=g, device=dev)).to(dtype)
    dy = torch.randn(rows, n, generator=g, device=dev).to(dtype)
    before = bias_gelu.bias_gelu_bwd.launches
    out = bias_gelu.bias_gelu_bwd(x, b, dy)
    assert bias_gelu.bias_gelu_bwd.launches == before + 1
    _check(out, bias_gelu.bias_gelu_bwd_plain(x, b, dy), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,n,offset", [(8192, 3072, 0), (37, 3072, 0),
                                           (3, 24, 0), (1, 4, 0),
                                           (5, 3071, 0), (64, 3072, 1),
                                           (9, 12, 0)])
def test_bias_gelu_bwd_variants(dev, dtype, rows, n, offset):
    """The backward takes the 16-byte vector kernel exactly where F is a
    multiple of one vector and x, b, dy, dx lie on 16-byte boundaries (GPT's
    F = 3072, a ragged row count, narrow widths), else the scalar loop
    (F = 3071, x a view one element off a boundary, F = 12 in bf16); both
    against the plain version."""
    g = torch.Generator(device=dev).manual_seed(rows + n + offset)
    x = (2 * torch.randn(rows * n + 8, generator=g, device=dev)).to(dtype)[
        offset:offset + rows * n].view(rows, n)
    b = (0.5 * torch.randn(n, generator=g, device=dev)).to(dtype)
    dy = torch.randn(rows, n, generator=g, device=dev).to(dtype)
    before = bias_gelu.variant_launches()["bias_gelu_bwd"]
    out = bias_gelu.bias_gelu_bwd(x, b, dy)
    _check(out, bias_gelu.bias_gelu_bwd_plain(x, b, dy), dtype)
    per = 16 // x.element_size()
    taken = "vec" if offset == 0 and n % per == 0 else "scalar"
    other = "scalar" if taken == "vec" else "vec"
    after = bias_gelu.variant_launches()["bias_gelu_bwd"]
    assert after[taken] == before[taken] + 1
    assert after[other] == before[other]


def test_bias_gelu_db_matches_the_float32_copy_sum(dev):
    """db through the Function on the card: the float32-accumulated sum of
    bf16 dx equals the float32 copy's sum within float32 reordering."""
    g = torch.Generator(device=dev).manual_seed(12)
    dx = torch.randn(8192, 3072, generator=g, device=dev).bfloat16()
    got = bias_gelu.bias_gelu_db(dx)
    ref = dx.float().sum(0)
    assert got.dtype == torch.float32
    tol = 2e-5 * dx.float().abs().sum(0).max().item()
    assert (got - ref).abs().max().item() <= tol


def test_engine_decode_step_syncs_only_to_fetch_tokens(dev):
    """Every GenerationEngine.step() of a greedy and a sampled request
    under torch.cuda.set_sync_debug_mode("warn") makes exactly one
    synchronizing call, its copy of the tokens to the host: the noise
    draw and the replay of the captured step make none."""
    import warnings

    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = GPTConfig(vocab_size=211, hidden_size=64, num_layers=2,
                    num_heads=4, max_position_embeddings=64, dropout=0.0,
                    attn_dropout=0.0)
    seed(0)
    model = GPTForCausalLM(cfg, device=dev).eval()
    seen = []
    with GenerationEngine(model, max_slots=3, max_seq_len=40,
                          prompt_buckets="8,16", device=dev) as eng:
        step = eng.step

        def checked_step():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = step()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            seen.append([w.filename for w in caught
                         if str(w.message).startswith(SYNC_WARNING)])
            return out

        eng.step = checked_step
        hs = [eng.submit([3, 4, 5], 10),
              eng.submit(list(range(9)), 10, do_sample=True,
                         temperature=0.8, top_k=5, seed=1)]
        for h in hs:
            h.result(120)
        assert eng.capture_count == 1 and eng.replays == len(seen)
    assert seen
    for files in seen:
        assert len(files) == 1 and files[0].endswith("generation.py"), seen


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,D", [(1, 64), (7, 16), (65, 64), (200, 128),
                                 (130, 32)])
def test_flash_attention_bwd_kernels(dev, dtype, S, D):
    """dq and dk/dv kernels against their plain versions, reading the
    slices of one fused qkv and writing into one packed gradient."""
    g = torch.Generator(device=dev).manual_seed(S + D)
    qkv = torch.randn(2, S, 3, 3, D, generator=g, device=dev).to(dtype)
    q, k, v = qkv.unbind(2)
    o, lse = flash_attention.flash_attention(q, k, v)
    do = torch.randn(o.shape, generator=g, device=dev).to(dtype)
    delta = flash_attention.flash_attention_delta(o, do)
    grad = torch.empty_like(qkv)
    dq = flash_attention.flash_attention_dq(q, k, v, do, lse, delta,
                                            out=grad[:, :, 0])
    dk, dv = flash_attention.flash_attention_dkv(q, k, v, do, lse, delta,
                                                 out=grad.unbind(2)[1:])
    assert dq.data_ptr() == grad[:, :, 0].data_ptr()
    _check(dq, flash_attention.flash_attention_dq_plain(q, k, v, do, lse,
                                                        delta), dtype)
    ref_k, ref_v = flash_attention.flash_attention_dkv_plain(q, k, v, do,
                                                             lse, delta)
    _check(dk, ref_k, dtype)
    _check(dv, ref_v, dtype)
    _check(grad[:, :, 2], ref_v, dtype)


def test_flash_attention_bwd_is_deterministic(dev):
    """No atomics: the same inputs give bitwise the same gradient."""
    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn(2, 300, 3, 4, 64, generator=g, device=dev,
                      requires_grad=True)
    do = torch.randn(2, 300, 4, 64, generator=g, device=dev)
    grads = [torch.autograd.grad(fused.packed_causal_attention(qkv), qkv,
                                 do)[0] for _ in range(2)]
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_functions_match_cpu(dev, dtype):
    """LN (kernel forward with saved statistics, plain backward), bias+GeLU
    and packed causal attention through autograd on the card, against the
    same Functions on the CPU (plain versions), from the same inputs."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 37, 64).astype(np.float32)
    w = (1 + 0.1 * rs.randn(64)).astype(np.float32)
    b = (0.1 * rs.randn(64)).astype(np.float32)
    qkv = rs.randn(2, 37, 3, 4, 16).astype(np.float32)
    grads = {}
    for device in ("cpu", dev):
        t = [torch.tensor(a, device=device, dtype=dtype, requires_grad=True)
             for a in (x, w, b, qkv)]
        y = fused.layer_norm(t[0], t[1], t[2])
        y = fused.bias_gelu(y, t[2])
        att = fused.packed_causal_attention(t[3])
        loss = y.float().square().sum() + att.float().square().sum()
        loss.backward()
        grads[str(device)] = [a.grad.float().cpu() for a in t]
    for got, ref in zip(grads[str(dev)], grads["cpu"]):
        scale = max(1.0, ref.abs().max().item())
        tol = (2e-5 if dtype == torch.float32 else 2 ** -5) * scale
        assert (got - ref).abs().max().item() <= tol


def test_tiny_gpt_gradients_match_cpu(dev):
    """The slice-1 fault: on the card the kernels' outputs had no autograd
    graph, so a loss's backward gave no gradient below the first kernel.
    Every parameter of a tiny float32 GPT now gets the CPU's gradient."""
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=211, hidden_size=64, num_layers=2,
                    num_heads=4, max_position_embeddings=64, dropout=0.0,
                    attn_dropout=0.0)
    ids = np.random.RandomState(5).randint(0, 211, (2, 33))
    result = {}
    for device in ("cpu", dev):
        seed(0)
        model = GPTForCausalLM(cfg, device=device).train()
        loss = model.loss(torch.tensor(ids, device=device))
        loss.backward()
        result[str(device)] = (loss.item(), {
            n: p.grad for n, p in model.named_parameters()})
    loss_gpu, grads_gpu = result[str(dev)]
    loss_cpu, grads_cpu = result["cpu"]
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    assert set(grads_gpu) == set(grads_cpu)
    for name, ref in grads_cpu.items():
        got = grads_gpu[name]
        assert got is not None, f"{name} got no gradient on the card"
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-6,
                                   msg=name)


def test_fused_linear_cross_entropy_matches_cpu(dev):
    rs = np.random.RandomState(6)
    h = rs.randn(37, 48).astype(np.float32)
    w = (0.2 * rs.randn(48, 301)).astype(np.float32)
    labels = rs.randint(0, 301, 37)
    res = {}
    for device in ("cpu", dev):
        th = torch.tensor(h, device=device, requires_grad=True)
        tw = torch.tensor(w, device=device, requires_grad=True)
        loss = fused.fused_linear_cross_entropy(
            th, tw, torch.tensor(labels, device=device), chunk_size=128)
        loss.sum().backward()
        res[str(device)] = [t.detach().cpu() for t in (loss, th.grad,
                                                       tw.grad)]
    for got, ref in zip(res[str(dev)], res["cpu"]):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_paged_decode_attention_raises_when_asked_for_a_gradient(dev):
    q = torch.randn(2, 2, 16, device=dev, requires_grad=True)
    pool = torch.randn(4, 4, 2, 16, device=dev)
    rows = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32, device=dev)
    pos = torch.tensor([5, 2], dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        paged_attention.paged_decode_attention(q, pool, pool, rows, pos, 8)
    with torch.no_grad():
        out = paged_attention.paged_decode_attention(q, pool, pool, rows,
                                                     pos, 8)
    assert out.shape == (2, 2, 16)


# ---------------------------------------------------------------------------
# softmax cross entropy, and the non-causal and masked forms of attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,v", [(1, 2), (32, 2), (37, 1000), (129, 30522),
                                 (5, 50304), (3, 2047)])
def test_softmax_xent_kernels(dev, dtype, n, v):
    """Forward (loss, lse) and backward against the plain versions, odd N
    and V; ignored rows give loss 0 and a gradient of exactly 0."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    g = torch.Generator(device=dev).manual_seed(n + v)
    z = (3 * torch.randn(n, v, generator=g, device=dev)).to(dtype)
    lab = torch.randint(0, v, (n,), generator=g, device=dev)
    lab[::4] = -100
    gr = torch.randn(n, generator=g, device=dev)
    before = (sx.softmax_xent_fwd.launches, sx.softmax_xent_bwd.launches)
    loss, lse = sx.softmax_xent_fwd(z, lab)
    dz = sx.softmax_xent_bwd(z, lab, lse, gr)
    assert (sx.softmax_xent_fwd.launches, sx.softmax_xent_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    ref_loss, ref_lse = sx.softmax_xent_plain(z, lab)
    _check(loss, ref_loss, torch.float32 if dtype == torch.float32 else dtype)
    _check(lse, ref_lse, torch.float32 if dtype == torch.float32 else dtype)
    _check(dz, sx.softmax_xent_bwd_plain(z, lab, ref_lse, gr), dtype)
    assert dz.dtype == dtype and dz.shape == z.shape
    assert torch.all(loss[::4] == 0) and torch.all(dz[::4] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_softmax_xent_reads_strided_rows(dev, dtype):
    """logits[:, :-1] of a [B, S, V] tensor, read in place, through the
    autograd Function: the gradient of the last position is exactly 0."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as sx

    g = torch.Generator(device=dev).manual_seed(9)
    logits = torch.randn(3, 17, 301, generator=g, device=dev).to(dtype)
    labels = torch.randint(0, 301, (3, 17), generator=g, device=dev)
    res = {}
    for device in ("cpu", dev):
        t = logits.to(device).requires_grad_()
        loss = sx.softmax_xent(t[:, :-1], labels.to(device)[:, 1:])
        loss.float().sum().backward()
        res[str(device)] = (loss.detach().cpu(), t.grad.cpu())
    for got, ref in zip(res[str(dev)], res["cpu"]):
        _check(got.to(dev), ref.to(dev), dtype)
    assert torch.all(res[str(dev)][1][:, -1] == 0)


def _mask(kind, B, H, S, g, dev, causal):
    """bool padding [B, 1, 1, S] (key 0 always visible; non-causal: one
    batch row padded everywhere), additive [B, 1, S, S], per-head
    [B, H, S, S], 2-D [S, S] — folded as the model folds them."""
    if kind is None:
        return None
    if kind == "bool":
        lens = torch.randint(1, S + 1, (B,), generator=g, device=dev)
        m = torch.arange(S, device=dev)[None, :] < lens[:, None]
        if not causal and B > 1:
            m[1] = False                 # every row of batch 1 sees nothing
        m = m[:, None, None, :]
    elif kind == "additive":
        m = torch.randn(B, 1, S, S, generator=g, device=dev)
    elif kind == "per_head":
        m = torch.randn(B, H, S, S, generator=g, device=dev)
    else:
        m = torch.randn(S, S, generator=g, device=dev)
    return flash_attention.fold_mask(m, B, H, S, S)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", [None, "bool", "additive", "per_head",
                                  "2d"])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 64, 65, 77, 127, 128,
                               129, 130, 1000])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_attention_masked_kernels(dev, dtype, causal, kind, S, D):
    """Forward, dq and dk/dv in the non-causal and masked forms against the
    plain versions, reading the slices of one fused qkv: sequence lengths
    on both sides of every tile edge (16, 64, 128), every head dim.  The
    bf16 cases take the tensor-core kernels, the float32 ones the
    CUDA-core kernels."""
    g = torch.Generator(device=dev).manual_seed(S + D)
    B, H = 2, 3
    qkv = torch.randn(B, S, 3, H, D, generator=g, device=dev).to(dtype)
    q, k, v = qkv.unbind(2)
    bias = _mask(kind, B, H, S, g, dev, causal)
    form = dict(causal=causal, bias=bias)
    out, lse = flash_attention.flash_attention(q, k, v, **form)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, **form)
    _check(out, ref, dtype)
    _check(lse, ref_lse, torch.float32 if dtype == torch.float32 else dtype)
    do = torch.randn(out.shape, generator=g, device=dev).to(dtype)
    delta = flash_attention.flash_attention_delta(out, do)
    dq = flash_attention.flash_attention_dq(q, k, v, do, lse, delta, **form)
    dk, dv = flash_attention.flash_attention_dkv(q, k, v, do, lse, delta,
                                                 **form)
    _check(dq, flash_attention.flash_attention_dq_plain(
        q, k, v, do, lse, delta, **form), dtype)
    ref_k, ref_v = flash_attention.flash_attention_dkv_plain(
        q, k, v, do, lse, delta, **form)
    _check(dk, ref_k, dtype)
    _check(dv, ref_v, dtype)


def _variant_delta(before):
    after = flash_attention.variant_launches()
    return {k: {v: after[k][v] - before[k][v] for v in ("simt", "mma")}
            for k in after}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bf16_variant_follows_alignment(dev, aligned,
                                                        causal):
    """bf16 operands on 16-byte boundaries take the tensor-core kernels;
    the same values one element off them take the CUDA-core kernels.  Both
    match the plain versions, and dq and dk/dv are bitwise equal over two
    runs."""
    g = torch.Generator(device=dev).manual_seed(11)
    B, S, H, D = 2, 200, 3, 64
    n = B * S * H * D
    off = 0 if aligned else 1
    bufs = [torch.randn(n + 8, generator=g, device=dev).bfloat16()
            for _ in range(4)]
    q, k, v, do = (t[off:off + n].view(B, S, H, D) for t in bufs)
    assert (q.data_ptr() % 16 == 0) == aligned
    mask = torch.randn(B, 1, S, S, generator=g, device=dev)
    form = dict(causal=causal, bias=flash_attention.fold_mask(mask, B, H, S,
                                                              S))
    before = flash_attention.variant_launches()
    out, lse = flash_attention.flash_attention(q, k, v, **form)
    delta = flash_attention.flash_attention_delta(out, do)
    grads = torch.empty(2, 3, n + 8, dtype=torch.bfloat16, device=dev)
    runs = [flash_attention.flash_attention_dkv(
        q, k, v, do, lse, delta,
        out=tuple(t[off:off + n].view(B, S, H, D) for t in grads[i, :2]),
        **form) for i in range(2)]
    dqs = [flash_attention.flash_attention_dq(
        q, k, v, do, lse, delta, out=grads[i, 2, off:off + n].view(
            B, S, H, D), **form) for i in range(2)]
    taken = "mma" if aligned else "simt"
    other = "simt" if aligned else "mma"
    got = _variant_delta(before)
    assert got["flash_attention"] == {taken: 1, other: 0}
    assert got["flash_attention_dq"] == {taken: 2, other: 0}
    assert got["flash_attention_dkv"] == {taken: 2, other: 0}
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, **form)
    _check(out, ref, torch.bfloat16)
    _check(lse, ref_lse, torch.bfloat16)
    ref_k, ref_v = flash_attention.flash_attention_dkv_plain(
        q, k, v, do, lse, delta, **form)
    _check(runs[0][0], ref_k, torch.bfloat16)
    _check(runs[0][1], ref_v, torch.bfloat16)
    _check(dqs[0], flash_attention.flash_attention_dq_plain(
        q, k, v, do, lse, delta, **form), torch.bfloat16)
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(dqs[0], dqs[1])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [1, 200, 1024])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_attention_dq_mma_kernel(dev, causal, S, D):
    """The tensor-core dq kernel (bf16, the slices of one fused qkv, dq
    written into the packed gradient) against the plain version at every
    head dim, S = 1, S = 200 (not a multiple of any tile) and S = 1024;
    every launch takes ``mma``."""
    g = torch.Generator(device=dev).manual_seed(S * D + causal)
    B, H = 2, 3
    qkv = torch.randn(B, S, 3, H, D, generator=g, device=dev).bfloat16()
    q, k, v = qkv.unbind(2)
    o, lse = flash_attention.flash_attention(q, k, v, causal)
    do = torch.randn(o.shape, generator=g, device=dev).bfloat16()
    delta = flash_attention.flash_attention_delta(o, do)
    grad = torch.empty_like(qkv)
    before = flash_attention.variant_launches()
    dq = flash_attention.flash_attention_dq(q, k, v, do, lse, delta,
                                            out=grad[:, :, 0], causal=causal)
    assert _variant_delta(before)["flash_attention_dq"] == {"mma": 1,
                                                            "simt": 0}
    _check(dq, flash_attention.flash_attention_dq_plain(
        q, k, v, do, lse, delta, causal), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fill", [-1e30, float("-inf")])
@pytest.mark.parametrize("S", [40, 130])
def test_flash_attention_rows_masked_everywhere(dev, dtype, fill, S):
    """A query row whose every key is masked: by -1e30 it stays the uniform
    average of V (the dot is absorbed in float32), by -inf it gives 0 and
    lse 0, and a dq row of 0; neither puts a NaN into the output or the
    gradients.  bf16 runs the tensor-core kernels, float32 the CUDA-core
    ones."""
    g = torch.Generator(device=dev).manual_seed(S)
    B, H, D = 2, 3, 32
    qkv = torch.randn(B, S, 3, H, D, generator=g, device=dev).to(dtype)
    q, k, v = qkv.unbind(2)
    mask = torch.randn(B, 1, S, S, generator=g, device=dev)
    mask[0, 0, 3] = fill
    mask[1, 0, S - 1] = fill
    mask[1, 0, :, 5] = fill          # and one key no query sees
    bias = flash_attention.fold_mask(mask, B, H, S, S)
    out, lse = flash_attention.flash_attention(q, k, v, False, bias)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, False,
                                                         bias)
    assert torch.isfinite(out.float()).all()
    _check(out, ref, dtype)
    if fill == float("-inf"):
        assert torch.all(out[0, 3] == 0) and torch.all(lse[:H, 3] == 0)
    else:
        _check(out[0, 3], v[0].float().mean(0), dtype)
    do = torch.randn(out.shape, generator=g, device=dev).to(dtype)
    delta = flash_attention.flash_attention_delta(out, do)
    before = flash_attention.variant_launches()
    dq = flash_attention.flash_attention_dq(q, k, v, do, lse, delta,
                                            causal=False, bias=bias)
    dk, dv = flash_attention.flash_attention_dkv(q, k, v, do, lse, delta,
                                                 causal=False, bias=bias)
    taken = "mma" if dtype == torch.bfloat16 else "simt"
    got = _variant_delta(before)
    assert got["flash_attention_dq"][taken] == 1
    assert got["flash_attention_dkv"][taken] == 1
    if fill == float("-inf"):
        assert torch.all(dq[0, 3] == 0)
    ref_k, ref_v = flash_attention.flash_attention_dkv_plain(
        q, k, v, do, lse, delta, False, bias)
    for got, want in ((dq, flash_attention.flash_attention_dq_plain(
            q, k, v, do, lse, delta, False, bias)), (dk, ref_k),
            (dv, ref_v)):
        assert torch.isfinite(got.float()).all()
        _check(got, want, dtype)


def test_masked_attention_bwd_is_deterministic(dev):
    """No atomics in the masked, non-causal form either: bitwise equal
    gradients from two runs."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(4, 128, 12, 64, generator=g, device=dev,
                           requires_grad=True) for _ in range(3))
    mask = torch.arange(128, device=dev)[None, :] < torch.tensor(
        [128, 64, 100, 77], device=dev)[:, None]
    do = torch.randn(4, 128, 12, 64, generator=g, device=dev)
    grads = [torch.autograd.grad(fused.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None, None, :]), (q, k, v), do)
        for _ in range(2)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_tiny_bert_gradients_match_cpu(dev):
    """A tiny float32 BertForPretraining: loss() and every parameter's
    gradient, and the masked forward's logits, on the card against the
    CPU (kernels on one side, plain versions on the other)."""
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    cfg = BertConfig(vocab_size=211, hidden_size=64, num_layers=2,
                     num_heads=4, intermediate_size=128,
                     max_position_embeddings=64, dropout=0.0)
    rs = np.random.RandomState(5)
    ids = torch.from_numpy(rs.randint(0, 211, (2, 33)))
    tt = torch.from_numpy(rs.randint(0, 2, (2, 33)))
    mlm = torch.from_numpy(np.where(rs.rand(2, 33) < 0.3,
                                    rs.randint(0, 211, (2, 33)), -100))
    nsp = torch.from_numpy(rs.randint(0, 2, (2,)))
    mask = (torch.arange(33)[None, :] < torch.tensor([33, 20])[:, None])
    result = {}
    for device in ("cpu", dev):
        seed(0)
        model = BertForPretraining(cfg, device=device).train()
        loss = model.loss(*(t.to(device) for t in (ids, mlm, nsp, tt)))
        loss.backward()
        with torch.no_grad():
            logits = model(ids.to(device), tt.to(device),
                           mask.to(device)[:, None, None, :])
        result[str(device)] = (loss.item(), {
            n: p.grad for n, p in model.named_parameters()},
            [x.cpu() for x in logits])
    loss_gpu, grads_gpu, logits_gpu = result[str(dev)]
    loss_cpu, grads_cpu, logits_cpu = result["cpu"]
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    assert set(grads_gpu) == set(grads_cpu)
    for name, ref in grads_cpu.items():
        got = grads_gpu[name]
        assert got is not None, f"{name} got no gradient on the card"
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-6,
                                   msg=name)
    for got, ref in zip(logits_gpu, logits_cpu):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the whole-tree optimizer update: bitwise the per-parameter loop
# ---------------------------------------------------------------------------
OPTIMIZERS = {
    "sgd": lambda ps, lr, clip: ptt.optimizer.SGD(
        learning_rate=lr, parameters=ps, weight_decay=0.01, grad_clip=clip),
    "momentum": lambda ps, lr, clip: ptt.optimizer.Momentum(
        learning_rate=lr, momentum=0.9, parameters=ps, grad_clip=clip),
    "nesterov": lambda ps, lr, clip: ptt.optimizer.Momentum(
        learning_rate=lr, momentum=0.9, use_nesterov=True, parameters=ps,
        grad_clip=clip),
    "adam": lambda ps, lr, clip: ptt.optimizer.Adam(
        learning_rate=lr, parameters=ps, weight_decay=0.01, grad_clip=clip),
    "adamw": lambda ps, lr, clip: ptt.optimizer.AdamW(
        learning_rate=lr, parameters=ps, weight_decay=0.05, grad_clip=clip),
}
# a GPT-like spread of sizes: a large embedding, matrices, biases, one
# element, a view one element off a 16-byte boundary (element loop)
OPT_SHAPES = [(3000, 77), (128, 384), (384,), (1,), (5, 3), (70000,)]


def _opt_params(dev, dtype, unaligned=False):
    g = torch.Generator(device=dev).manual_seed(21)
    out = [torch.randn(*s, generator=g, device=dev).to(dtype)
           for s in OPT_SHAPES]
    if unaligned:
        buf = torch.randn(4 * 385 + 1, generator=g, device=dev).to(dtype)
        out.append(buf[1:].view(4, 385))
    return [torch.nn.Parameter(t) for t in out]


def _opt_run(dev, kind, dtype, plain, steps=3, unaligned=False,
             resume_at=None):
    """``steps`` updates through step() (kernel) or step_plain() (the
    loop) from seeded values: a parameter without a gradient, a global
    norm clip, an lr that changes every step, and optionally a resume
    through set_state_dict after step ``resume_at``."""
    params = _opt_params(dev, dtype, unaligned)
    sched = ptt.optimizer.lr.StepDecay(0.01, step_size=1, gamma=0.8)
    opt = OPTIMIZERS[kind](params, sched, tnn.ClipGradByGlobalNorm(5.0))
    g = torch.Generator(device=dev).manual_seed(22)
    for i in range(steps):
        for j, p in enumerate(params):
            p.grad = None if j == 3 else torch.randn(
                *p.shape, generator=g, device=dev).to(dtype)
        opt.step_plain() if plain else opt.step()
        opt.clear_grad()
        sched.step()
        if resume_at == i:
            state = opt.state_dict()
            sched = ptt.optimizer.lr.StepDecay(0.01, step_size=1, gamma=0.8)
            opt = OPTIMIZERS[kind](params, sched,
                                   tnn.ClipGradByGlobalNorm(5.0))
            opt.set_state_dict(state)
    torch.cuda.synchronize()
    slots = [[v.clone() for v in opt._slots.get(id(p), {}).values()]
             for p in params]
    return params, slots


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
@pytest.mark.parametrize("case", ["plain", "unaligned", "resume"])
def test_multi_tensor_step_is_bitwise_the_loop(dev, kind, dtype, case):
    """After 3 steps the kernel's parameters and moments equal the
    per-parameter loop's bit for bit; one launch a step, and the loop
    runs on no CUDA tensor."""
    kw = dict(unaligned=case == "unaligned",
              resume_at=1 if case == "resume" else None)
    ptt.optimizer.Optimizer.plain_cuda_updates = 0
    before = multi_tensor.multi_tensor_step.launches
    got, got_slots = _opt_run(dev, kind, dtype, plain=False, **kw)
    assert multi_tensor.multi_tensor_step.launches == before + 3
    assert ptt.optimizer.Optimizer.plain_cuda_updates == 0
    want, want_slots = _opt_run(dev, kind, dtype, plain=True, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (i, (a.float() - b.float()).abs().max())
    for i, (a, b) in enumerate(zip(got_slots, want_slots)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y), (i, (x - y).abs().max())


def test_multi_tensor_step_splits_a_large_tree(dev):
    """More tensors than one launch takes: two launches, bitwise the
    loop."""
    n = multi_tensor.MAX_TENSORS + 88
    runs = []
    for plain in (False, True):
        g = torch.Generator(device=dev).manual_seed(23)
        ps = [torch.nn.Parameter(torch.randn(
            1 + i % 37, generator=torch.Generator(device=dev).manual_seed(i),
            device=dev)) for i in range(n)]
        opt = ptt.optimizer.AdamW(learning_rate=0.01, parameters=ps)
        for p in ps:
            p.grad = torch.randn(*p.shape, generator=g, device=dev)
        before = multi_tensor.multi_tensor_step.launches
        opt.step_plain() if plain else opt.step()
        if not plain:
            assert multi_tensor.multi_tensor_step.launches == before + 2
        runs.append(ps)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_multi_tensor_step_makes_no_host_sync(dev):
    """opt.step() with a global-norm clip and a scheduled lr runs under
    torch.cuda.set_sync_debug_mode("error"): any sync raises."""
    params = _opt_params(dev, torch.bfloat16)
    opt = OPTIMIZERS["adamw"](params, ptt.optimizer.lr.StepDecay(
        0.01, step_size=1), tnn.ClipGradByGlobalNorm(1.0))
    for step in range(2):
        for p in params:
            p.grad = torch.ones_like(p)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_multi_tensor_state_dict_is_a_snapshot_on_the_card(dev):
    """The kernel updates the moments in place; a state_dict() taken
    before a step keeps what it had."""
    params = _opt_params(dev, torch.float32)
    opt = OPTIMIZERS["adam"](params, 0.01, None)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    saved = opt.state_dict()
    frozen = {k: v.clone() for k, v in saved.items()
              if isinstance(v, torch.Tensor)}
    opt.step()
    for k, v in frozen.items():
        assert torch.equal(saved[k], v), k


def test_multi_tensor_step_refuses_float16(dev):
    """float64 has no kernel and is refused before any launch; float16,
    refused until the AMP slice, now launches (bitwise the loop:
    test_multi_tensor_step_float16_is_the_loop)."""
    p = torch.nn.Parameter(torch.zeros(8, device=dev, dtype=torch.float64))
    p.grad = torch.ones_like(p)
    with pytest.raises(TypeError, match="float64"):
        ptt.optimizer.SGD(learning_rate=0.1, parameters=[p]).step()
    h = torch.nn.Parameter(torch.zeros(8, device=dev, dtype=torch.float16))
    h.grad = torch.ones_like(h)
    before = multi_tensor.multi_tensor_step.launches
    ptt.optimizer.SGD(learning_rate=0.1, parameters=[h]).step()
    assert multi_tensor.multi_tensor_step.launches == before + 1


def test_multi_tensor_step_refuses_shared_memory(dev):
    """A parameter listed twice would be updated by racing blocks of one
    launch: refused before any launch."""
    p = torch.nn.Parameter(torch.zeros(8, device=dev))
    p.grad = torch.ones_like(p)
    before = multi_tensor.multi_tensor_step.launches
    with pytest.raises(ValueError, match="share memory"):
        ptt.optimizer.AdamW(learning_rate=0.1, parameters=[p, p]).step()
    assert multi_tensor.multi_tensor_step.launches == before


# ---------------------------------------------------------------------------
# attention dropout inside the three attention kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,S", [(2, 3, 77), (1, 2, 1024), (4, 12, 128)])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_mask_entry_matches_plain(dev, B, H, S, p):
    """The keep mask written by the kernels' own device function
    (``ptt_flash_dropout_mask``) is bitwise the plain version's."""
    seed = 0x123456789ABCDEF0 + S
    got = flash_attention.dropout_keep(seed, B, H, S, p, dev)
    assert torch.equal(got, flash_attention.dropout_keep_plain(
        seed, B, H, S, p, dev))


def _views(g, dev, dtype, shape, offset, scale=1.0):
    """Seeded [B, S, H, D] operands, ``offset`` elements into their
    buffers (1: off every 16-byte boundary)."""
    n = int(np.prod(shape))
    return [(scale * torch.randn(n + 8, generator=g, device=dev)).to(dtype)[
        offset:offset + n].view(shape) for _ in range(4)]


# (dtype, offset, the kernel the C entries must take)
DROPOUT_VARIANTS = [(torch.bfloat16, 0, "mma"), (torch.bfloat16, 1, "simt"),
                    (torch.float32, 0, "simt")]


@pytest.mark.parametrize("dtype,offset,variant", DROPOUT_VARIANTS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_dropout_forward_applies_the_mask(dev, dtype, offset, variant,
                                          causal, D):
    """V's row t is the one-hot e_t (S = D), so O's non-zero pattern is the
    set of kept visible (query, key) pairs: it must equal the plain mask
    exactly, on the tensor-core and the CUDA-core kernel."""
    g = torch.Generator(device=dev).manual_seed(D + causal)
    B, S, H = 2, D, 3
    q, k, _, _ = _views(g, dev, dtype, (B, S, H, D), offset, scale=0.3)
    v = torch.zeros(B * S * H * D + 8, dtype=dtype, device=dev)[
        offset:offset + B * S * H * D].view(B, S, H, D)
    v.copy_(torch.eye(S, dtype=dtype, device=dev)[None, :, None, :].expand(
        B, S, H, D))
    before = flash_attention.variant_launches()
    out, _ = flash_attention.flash_attention(q, k, v, causal, dropout_p=0.3,
                                             seed=99 + D)
    assert _variant_delta(before)["flash_attention"][variant] == 1
    keep = flash_attention.dropout_keep_plain(99 + D, B, H, S, 0.3, dev)
    if causal:
        keep &= torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    assert torch.equal(out.permute(0, 2, 1, 3) != 0, keep)


@pytest.mark.parametrize("dtype,offset,variant", DROPOUT_VARIANTS)
@pytest.mark.parametrize("kind", ["causal", "bool"])
# every head dim; (B, H) = (4, 12) at S = 100 and 200 gives the tensor-core
# kernels their 32- and 64-row tiles, the others their 16-row ones
@pytest.mark.parametrize("B,H,S,D", [(2, 3, 33, 16), (2, 3, 130, 32),
                                     (2, 3, 200, 64), (4, 12, 100, 64),
                                     (4, 12, 200, 64), (2, 3, 77, 128)])
def test_dropout_kernels_match_plain(dev, dtype, offset, variant, kind, B,
                                     H, S, D):
    """Forward (O and the LSE before dropout), dq and dk/dv with p = 0.1
    against the plain versions with the same seed, causal and with a
    [B, 1, 1, S] padding mask; each takes its kernel."""
    g = torch.Generator(device=dev).manual_seed(S * D)
    q, k, v, do = _views(g, dev, dtype, (B, S, H, D), offset)
    bias = None
    if kind == "bool":
        lens = torch.tensor([S, max(1, S // 2)] * (B // 2), device=dev)
        bias = flash_attention.fold_mask(
            (torch.arange(S, device=dev) < lens[:, None])[:, None, None],
            B, H, S, S)
    form = dict(causal=kind == "causal", bias=bias, dropout_p=0.1,
                seed=7 * S + D)
    before = flash_attention.variant_launches()
    out, lse = flash_attention.flash_attention(q, k, v, **form)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, **form)
    _check(out, ref, dtype)
    _check(lse, ref_lse, torch.float32 if dtype == torch.float32 else dtype)
    delta = flash_attention.flash_attention_delta(out, do)
    dq = flash_attention.flash_attention_dq(q, k, v, do, lse, delta, **form)
    dk, dv = flash_attention.flash_attention_dkv(q, k, v, do, lse, delta,
                                                 **form)
    _check(dq, flash_attention.flash_attention_dq_plain(
        q, k, v, do, lse, delta, **form), dtype)
    ref_k, ref_v = flash_attention.flash_attention_dkv_plain(
        q, k, v, do, lse, delta, **form)
    _check(dk, ref_k, dtype)
    _check(dv, ref_v, dtype)
    took = _variant_delta(before)
    assert all(took[name][variant] == 1 for name in took), took


@pytest.mark.parametrize("dtype,offset,variant", DROPOUT_VARIANTS)
def test_dropout_zero_is_the_kernel_without_it(dev, dtype, offset, variant):
    """p = 0 with any seed launches the kernels without dropout: O, LSE,
    dq, dk and dv bitwise those of a call that names no dropout."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = _views(g, dev, dtype, (2, 130, 3, 64), offset)
    runs = []
    for kw in ({}, dict(dropout_p=0.0, seed=12345)):
        out, lse = flash_attention.flash_attention(q, k, v, **kw)
        delta = flash_attention.flash_attention_delta(out, do)
        runs.append((out, lse,
                     flash_attention.flash_attention_dq(q, k, v, do, lse,
                                                        delta, **kw),
                     *flash_attention.flash_attention_dkv(q, k, v, do, lse,
                                                          delta, **kw)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dropout_through_autograd_matches_cpu(dev, dtype):
    """Training-mode attention with dropout through the autograd Functions
    (packed causal and masked non-causal): the card's output and gradients
    against the CPU's (plain versions) from the same framework seed, which
    draws the same mask seeds on both; the backward draws the forward's
    mask again."""
    rs = np.random.RandomState(8)
    qkv = rs.randn(2, 37, 3, 4, 16).astype(np.float32)
    mask = rs.rand(2, 1, 1, 37) > 0.2
    mask[..., 0] = True
    res = {}
    for device in ("cpu", dev):
        ptt.seed(11)
        t = torch.tensor(qkv, device=device, dtype=dtype, requires_grad=True)
        a = fused.packed_causal_attention(t, dropout_p=0.1, training=True)
        b = fused.scaled_dot_product_attention(
            *t.unbind(2), attn_mask=torch.tensor(mask, device=device),
            dropout_p=0.2, training=True)
        (a.float().square().sum() + b.float().square().sum()).backward()
        res[str(device)] = [x.detach().float().cpu() for x in (a, b, t.grad)]
    for got, ref in zip(res[str(dev)], res["cpu"]):
        scale = max(1.0, ref.abs().max().item())
        tol = (2e-5 if dtype == torch.float32 else 2 ** -5) * scale
        assert (got - ref).abs().max().item() <= tol


SERVE_CFG = dict(vocab_size=211, hidden_size=64, num_layers=2, num_heads=4,
                 max_position_embeddings=128, dropout=0.0, attn_dropout=0.0)
SERVE_ENGINE = dict(max_slots=4, max_seq_len=96, prompt_buckets="16,48",
                    page_size=8, prefill_chunk=16)


def _serving_model(dev, dtype=torch.float32):
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    seed(0)
    return GPTForCausalLM(GPTConfig(**SERVE_CFG), device=dev,
                          dtype=dtype).eval()


def _mixed_wave(eng):
    """Prefix hits, chunked prefills (a miss and a sampled one), both
    sampling modes, both buckets, a mid-decode admission and a cancel, in
    an order that gives every request the same path on every run.
    Returns the tokens of the requests that ran to their end."""
    rs = np.random.RandomState(7)
    shared = rs.randint(0, 211, 24).tolist()           # 3 pages of 8
    a = eng.submit(shared + [1, 2, 3, 4, 5, 6], 10)    # chunked miss
    assert a.next_token(timeout=120) is not None       # registered
    hs = {"b": eng.submit(shared + [9, 8, 7, 6, 5], 10),        # hit
          "c": eng.submit(shared + rs.randint(0, 211, 9).tolist(), 10,
                          do_sample=True, temperature=0.8, top_k=5,
                          seed=1),                               # hit
          "d": eng.submit(rs.randint(0, 211, 44).tolist(), 8,
                          do_sample=True, temperature=0.9, top_k=0,
                          seed=2)}                               # chunked
    doomed = eng.submit(rs.randint(0, 211, 10).tolist(), 30)
    assert hs["b"].next_token(timeout=120) is not None
    hs["e"] = eng.submit(rs.randint(0, 211, 12).tolist(), 12,
                         do_sample=True, temperature=0.8, top_k=8, seed=3)
    assert doomed.next_token(timeout=120) is not None
    doomed.cancel()
    out = {k: h.result(120) for k, h in hs.items()}
    out["a"] = a.result(120)
    assert doomed.done and doomed.error is None
    return out


def _idle(eng, timeout=60):
    import time

    t0 = time.monotonic()
    while eng._sched.occupied or eng._backlog or not eng._queue.empty():
        assert time.monotonic() - t0 < timeout
        time.sleep(0.005)


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_graph_step_is_bitwise_the_eager_step(dev, dtype):
    """The captured decode step against ``_step_eager`` swapped in, on
    the same model: greedy and sampled tokens bitwise equal; the graph is
    captured once at start() and only replayed after, through admissions
    in both buckets, hits, chunks and both sampling modes."""
    from paddle_tpu_torch.serving import GenerationEngine

    model = _serving_model(dev, dtype)
    outs = {}
    for form in ("graph", "eager"):
        with GenerationEngine(model, device=dev, **SERVE_ENGINE) as eng:
            assert eng.capture_count == 1
            if form == "eager":
                eng.step = eng._step_eager
            outs[form] = _mixed_wave(eng)
            _idle(eng)
            snap = eng.metrics.snapshot()
            assert snap["prefix_cache_hits"] >= 2
            assert snap["prefill_chunks"] >= 5
            assert eng.free_count + eng.resident_pages \
                == eng.geometry.num_pages
            assert eng.capture_count == 1
            assert (eng.replays > 0) == (form == "graph")
            assert eng.graph_launches["paged_decode_attention"] == 2
            assert eng.graph_launches["layer_norm"] == 5
            assert eng.graph_launches["bias_gelu"] == 2
            assert sum(eng.graph_variants["paged_decode_attention"]
                       .values()) == 2
    assert outs["graph"] == outs["eager"]


def test_engine_capture_leaves_the_idle_state_unchanged(dev):
    """The warm-up step and the capture run on the all-inactive state:
    after start() every tensor of the state (pools, page table, free
    list, lane registers) is bitwise a fresh one."""
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.serving import kv_cache

    model = _serving_model(dev, torch.bfloat16)
    with GenerationEngine(model, device=dev, **SERVE_ENGINE) as eng:
        fresh = kv_cache.make_state(eng.geometry, dev)
        assert set(eng._state) == set(fresh)
        for key, t in fresh.items():
            assert torch.equal(eng._state[key], t), key
        assert eng.capture_count == 1 and eng.replays == 0


# ---------------------------------------------------------------------------
# the training engine's captured step: Model.fit through one CUDA graph per
# batch signature, with the dropout counter and the optimizer's scalars
# read from device memory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 5, -7])
def test_dropout_mask_entry_reads_the_step_from_the_card(dev, step):
    """The kernels' mask in the engine's seed form (a key and a device
    counter, Philox's fourth counter word) is bitwise the plain
    version's; counter 0 is the int seed's mask."""
    from paddle_tpu_torch.framework.random import StepSeed

    key = 0x0F0E0D0C0B0A0908
    seed = StepSeed(key, torch.tensor([step], dtype=torch.int32,
                                      device=dev))
    got = flash_attention.dropout_keep(seed, 2, 3, 77, 0.1, dev)
    assert torch.equal(got, flash_attention.dropout_keep_plain(
        seed, 2, 3, 77, 0.1, dev))
    same = torch.equal(got, flash_attention.dropout_keep(key, 2, 3, 77, 0.1,
                                                          dev))
    assert same == (step == 0)


def _dropout_calls(q, k, v, do, seed):
    form = dict(causal=True, dropout_p=0.1, seed=seed)
    out, lse = flash_attention.flash_attention(q, k, v, **form)
    delta = flash_attention.flash_attention_delta(out, do)
    return (out, lse,
            flash_attention.flash_attention_dq(q, k, v, do, lse, delta,
                                               **form),
            *flash_attention.flash_attention_dkv(q, k, v, do, lse, delta,
                                                 **form))


@pytest.mark.parametrize("dtype,offset,variant", DROPOUT_VARIANTS)
def test_dropout_kernels_take_the_step_from_the_card(dev, dtype, offset,
                                                     variant):
    """Forward, dq and dk/dv with a StepSeed: at counter 0 bitwise the int
    seed's; at counter 3 within the tolerance of the plain versions (which
    draw that step's mask) and a different result; captured once in a
    CUDA graph and replayed after the counter moved to 3, bitwise the
    eager calls at 3."""
    from paddle_tpu_torch.framework.random import StepSeed

    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v, do = _views(g, dev, dtype, (2, 130, 3, 64), offset)
    key = 0x5EED0FD809
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    seed = StepSeed(key, counter)
    at0 = _dropout_calls(q, k, v, do, seed)
    assert all(torch.equal(a, b) for a, b in
               zip(at0, _dropout_calls(q, k, v, do, key)))
    counter.fill_(3)
    before = flash_attention.variant_launches()
    at3 = _dropout_calls(q, k, v, do, seed)
    assert all(n[variant] == 1 for n in _variant_delta(before).values())
    assert not torch.equal(at3[0], at0[0])
    form = dict(causal=True, dropout_p=0.1, seed=seed)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, **form)
    _check(at3[0], ref, dtype)
    delta = flash_attention.flash_attention_delta(at3[0], do)
    _check(at3[2], flash_attention.flash_attention_dq_plain(
        q, k, v, do, at3[1], delta, **form), dtype)
    ref_k, ref_v = flash_attention.flash_attention_dkv_plain(
        q, k, v, do, at3[1], delta, **form)
    _check(at3[3], ref_k, dtype)
    _check(at3[4], ref_v, dtype)
    counter.fill_(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _dropout_calls(q, k, v, do, seed)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = _dropout_calls(q, k, v, do, seed)
    counter.fill_(3)
    graph.replay()
    assert all(torch.equal(a, b) for a, b in zip(static, at3))


def test_multi_tensor_step_reads_its_scalars_when_it_runs(dev):
    """One AdamW launch captured in a CUDA graph over a scalars tensor
    that the host rewrites before each replay, with the lr and the step
    changing every time: bitwise the per-parameter loop at those lrs and
    steps, parameters and moments."""
    hyper = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.05)
    g = torch.Generator(device=dev).manual_seed(41)
    shapes = [(300, 77), (128,), (5, 3)]
    params = [torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
              for s in shapes]
    grads = [(1e-2 * torch.randn(*s, generator=g, device=dev)).to(
        torch.bfloat16) for s in shapes]
    slots = [[torch.zeros(s, device=dev), torch.zeros(s, device=dev)]
             for s in shapes]
    twins = [p.clone() for p in params]
    twin_slots = [[t.clone() for t in ss] for ss in slots]
    scalars = multi_tensor.make_scalars(dev)
    graph = torch.cuda.CUDAGraph()
    before = multi_tensor.multi_tensor_step.launches
    with torch.cuda.graph(graph):
        multi_tensor.multi_tensor_step("adamw", params, grads, slots, None,
                                       None, hyper, scalars)
    assert multi_tensor.multi_tensor_step.launches == before + 1
    for t, lr in ((1, 0.01), (2, 0.004), (3, 0.02)):
        multi_tensor.write_scalars(scalars, "adamw", lr, t, hyper)
        graph.replay()
        multi_tensor.multi_tensor_step_plain("adamw", twins, grads,
                                             twin_slots, lr, t, hyper)
    torch.cuda.synchronize()
    for a, b in zip(params, twins):
        assert torch.equal(a, b), (a.float() - b.float()).abs().max()
    for a, b in zip(slots, twin_slots):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _train_gpt(dev, dtype, dropout, seed=3):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    ptt.seed(seed)
    return GPTForCausalLM(GPTConfig(
        vocab_size=96, hidden_size=64, num_layers=2, num_heads=2,
        max_position_embeddings=64, dropout=dropout, attn_dropout=dropout),
        device=dev, dtype=dtype)


def _lm_loss(logits, labels):
    logp = logits[:, :-1].float().log_softmax(-1)
    return -logp.gather(-1, labels[:, 1:, None])[..., 0].mean()


def _train_api(net, form, lr=0.01, loss=_lm_loss, labels=None):
    """A Model over ``net`` whose engine takes the graph path ("graph") or
    ``_step_eager`` ("eager")."""
    from paddle_tpu_torch.hapi.engine import TrainEngine

    model = ptt.Model(net, labels=labels).prepare(
        ptt.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                            parameters=net.parameters()), loss)
    engine = model._engine = TrainEngine(model)
    if form == "eager":
        engine.step = engine._step_eager
    return model, engine


def _params(net):
    return [p.detach().clone() for p in net.parameters()]


def _bert_data(n=16, S=32):
    """Padded BERT batches: ids, token types, a [n, 1, 1, S] bool mask,
    MLM labels (~15 %, else -100) and NSP labels."""
    rs = np.random.RandomState(9)
    lens = rs.randint(S // 2, S + 1, n)
    data = [rs.randint(0, 120, (n, S)), rs.randint(0, 2, (n, S)),
            (np.arange(S)[None] < lens[:, None])[:, None, None, :],
            np.where(rs.rand(n, S) < 0.15, rs.randint(0, 120, (n, S)), -100),
            rs.randint(0, 2, n)]
    return [torch.from_numpy(a) for a in data]


def _bert_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels):
    from paddle_tpu_torch.nn import functional as PF

    mlm = PF.cross_entropy(mlm_logits, mlm_labels, reduction="none")
    denom = (mlm_labels != -100).float().sum().clamp(min=1.0)
    return mlm.sum() / denom + PF.cross_entropy(nsp_logits, nsp_labels)


def _tiny_bert(dev, dtype=torch.bfloat16):
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    ptt.seed(4)
    return BertForPretraining(BertConfig(
        vocab_size=120, hidden_size=64, num_layers=2, num_heads=2,
        intermediate_size=128), device=dev, dtype=dtype)


def test_fit_after_a_kept_dygraph_loss(dev):
    """A dygraph step whose loss (and so its autograd graph, holding the
    parameters' AccumulateGrad nodes, made on the default stream) is kept
    alive, then Model.fit on the same network: no warning at all (autograd
    warns when an AccumulateGrad node of another stream takes a gradient;
    the engine gives the warm-up and the capture fresh nodes), and a later
    fit of replayed steps makes no host sync but its drain."""
    import os
    import warnings

    net = _train_gpt(dev, torch.bfloat16, 0.1)
    opt = ptt.optimizer.AdamW(learning_rate=0.01, parameters=net.parameters())
    data = torch.from_numpy(np.random.RandomState(12).randint(0, 96,
                                                              (24, 32)))
    first_batch = data[:4].to(dev)
    kept = _lm_loss(net(first_batch), first_batch)
    kept.backward()
    opt.step()
    opt.clear_grad()
    model = ptt.Model(net).prepare(opt, _lm_loss)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        first = model.fit(ptt.io.TensorDataset([data[:12], data[:12]]),
                          batch_size=4, shuffle=False, verbose=0,
                          log_freq=0)["step_loss"]
    engine = model._engine
    assert engine.captures == 1 and engine.replays == 2
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            second = model.fit(ptt.io.TensorDataset([data[12:], data[12:]]),
                               batch_size=4, shuffle=False, verbose=0,
                               log_freq=0)["step_loss"]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [os.path.basename(w.filename) for w in caught
             if str(w.message).startswith(SYNC_WARNING)]
    assert syncs == ["engine.py"] and engine.replays == 5
    assert not any("AccumulateGrad" in str(w.message) for w in caught)
    assert kept.grad_fn is not None
    assert all(np.isfinite(first + second)) and len(second) == 3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_train_graph_is_bitwise_the_eager_step(dev, dtype, dropout):
    """Model.fit over 6 batches through the captured step and through
    ``_step_eager`` from one seed: losses and parameters bitwise equal;
    one capture holding every training kernel (one optimizer launch),
    five replays."""
    data = torch.from_numpy(np.random.RandomState(6).randint(0, 96,
                                                             (24, 32)))
    runs = {}
    for form in ("graph", "eager"):
        net = _train_gpt(dev, dtype, dropout)
        model, engine = _train_api(net, form)
        hist = model.fit(ptt.io.TensorDataset([data, data]), batch_size=4,
                         shuffle=False, verbose=0, log_freq=2)
        runs[form] = (hist["step_loss"], _params(net))
        if form == "graph":
            assert engine.captures == 1 and engine.replays == 5
            (launches,) = engine.graph_launches.values()
            assert launches["multi_tensor_step"] == 1
            for name in ("layer_norm", "bias_gelu", "bias_gelu_bwd",
                         "flash_attention", "flash_attention_dq",
                         "flash_attention_dkv"):
                assert launches[name] > 0, name
        else:
            assert engine.captures == engine.replays == 0
    losses, params = runs["graph"]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses == runs["eager"][0]
    assert all(torch.equal(a, b) for a, b in zip(params, runs["eager"][1]))


def test_train_graph_takes_a_scheduled_lr(dev):
    """A StepDecay stepped twice in the middle of the run, after the
    capture: the replays take each new lr (bitwise the eager steps), and
    differ from a run at the first lr throughout."""
    ids = [torch.from_numpy(np.random.RandomState(i).randint(0, 96, (4, 32)))
           for i in range(6)]
    runs = []
    for form, gamma in (("graph", 0.5), ("eager", 0.5), ("graph", 1.0)):
        net = _train_gpt(dev, torch.float32, 0.1)
        sched = ptt.optimizer.lr.StepDecay(0.01, step_size=1, gamma=gamma)
        model, engine = _train_api(net, form, lr=sched)
        engine.begin()
        for i, x in enumerate(ids):
            engine.step([x], [x])
            if i in (1, 3):
                sched.step()
        runs.append((engine.drain(), _params(net)))
        assert engine.replays == (5 if form == "graph" else 0)
    (g_loss, g_par), (e_loss, e_par), (c_loss, c_par) = runs
    assert g_loss == e_loss
    assert all(torch.equal(a, b) for a, b in zip(g_par, e_par))
    assert g_loss[:3] == c_loss[:3] and g_loss[3:] != c_loss[3:]
    assert not all(torch.equal(a, b) for a, b in zip(g_par, c_par))


def test_train_graph_short_last_batch_is_a_second_capture(dev):
    """22 samples in batches of 4 over 2 epochs: the short last batch
    gets its own graph, captured at its first step and replayed in the
    second epoch; losses bitwise the eager steps'."""
    data = torch.from_numpy(np.random.RandomState(7).randint(0, 96,
                                                             (22, 32)))
    runs = []
    for form in ("graph", "eager"):
        net = _train_gpt(dev, torch.bfloat16, 0.1)
        model, engine = _train_api(net, form)
        hist = model.fit(ptt.io.TensorDataset([data, data]), batch_size=4,
                         epochs=2, shuffle=False, verbose=0)
        runs.append(hist["step_loss"])
        if form == "graph":
            assert engine.captures == 2 and engine.replays == 10
            assert len(engine.graph_launches) == 2
    assert len(runs[0]) == 12 and runs[0] == runs[1]


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_graph_after_a_loaded_optimizer_state(dev, dtype):
    """fit 3 steps, save the optimizer's state, fit 2 more, load the saved
    state (fresh slot tensors: the old ones are freed) and fit 3 again:
    the graph captured over the old slots is dropped and the step is
    captured anew, so the replays update the loaded moments; losses and
    parameters bitwise ``_step_eager`` doing the same."""
    data = torch.from_numpy(np.random.RandomState(8).randint(0, 96,
                                                             (32, 32)))
    runs = []
    for form in ("graph", "eager"):
        net = _train_gpt(dev, dtype, 0.1)
        model, engine = _train_api(net, form)
        opt = model._optimizer

        def fit(lo, hi):
            part = data[lo * 4:hi * 4]
            return model.fit(ptt.io.TensorDataset([part, part]),
                             batch_size=4, shuffle=False,
                             verbose=0)["step_loss"]

        losses = fit(0, 3)
        saved = opt.state_dict()
        losses += fit(3, 5)
        opt.set_state_dict(saved)
        # a tensor that may take the freed slots' memory
        junk = [torch.full_like(v, 7.0) for v in saved.values()
                if isinstance(v, torch.Tensor)]
        losses += fit(5, 8)
        del junk
        runs.append((losses, _params(net)))
        if form == "graph":
            assert engine.captures == 2 and engine.replays == 6
    (losses, params), (eager_losses, eager_params) = runs
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses == eager_losses
    assert all(torch.equal(a, b) for a, b in zip(params, eager_params))


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_graph_after_a_callback_replaced_the_state(dev, dtype):
    """A user callback replaces, between two steps of one fit, a
    parameter's tensor (clipped ``p.data``) and later the optimizer's
    slots (``set_state_dict``), then fills new tensors that may take the
    freed memory: fit drops the graph before the next step and captures
    anew, so the replays update the new tensors; losses and parameters
    bitwise ``_step_eager`` with the same callback."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Replacer(Callback):
        def __init__(self, net, opt):
            super().__init__()
            self.net, self.opt, self.junk = net, opt, []

        def on_train_batch_end(self, step, logs=None):
            if step == 0:
                self.saved = self.opt.state_dict()
            elif step == 2:
                p = self.net.parameters()[0]
                p.data = p.data.clamp(-0.05, 0.05)
            elif step == 4:
                self.opt.set_state_dict(self.saved)
            else:
                return
            self.junk += [torch.full_like(p, 7.0)
                          for p in self.net.parameters()]

    data = torch.from_numpy(np.random.RandomState(16).randint(0, 96,
                                                              (32, 32)))
    runs = []
    for form in ("graph", "eager"):
        net = _train_gpt(dev, dtype, 0.1)
        model, engine = _train_api(net, form)
        hist = model.fit(ptt.io.TensorDataset([data, data]), batch_size=4,
                         shuffle=False, verbose=0,
                         callbacks=[Replacer(net, model._optimizer)])
        runs.append((hist["step_loss"], _params(net)))
        if form == "graph":
            assert engine.captures == 3 and engine.replays == 5
    (losses, params), (eager_losses, eager_params) = runs
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses == eager_losses
    assert all(torch.equal(a, b) for a, b in zip(params, eager_params))


def test_train_graph_replay_syncs_only_to_drain(dev):
    """Replayed steps under torch.cuda.set_sync_debug_mode("warn") make no
    host sync; the drain makes one (in hapi/engine.py)."""
    import os
    import warnings

    net = _train_gpt(dev, torch.bfloat16, 0.1)
    model, engine = _train_api(net, "graph")
    engine.begin()
    ids = [torch.from_numpy(np.random.RandomState(i).randint(0, 96, (4, 32)))
           for i in range(6)]
    for x in ids[:2]:
        engine.step([x], [x])
    engine.drain()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for x in ids[2:]:
                engine.step([x], [x])
            steps = [w for w in caught
                     if str(w.message).startswith(SYNC_WARNING)]
            losses = engine.drain()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [os.path.basename(w.filename) for w in caught
             if str(w.message).startswith(SYNC_WARNING)]
    assert steps == [] and engine.replays == 5
    assert syncs == ["engine.py"] and len(losses) == 4


def test_train_graph_bert_masked_is_bitwise_the_eager_step(dev):
    """A tiny BERT at its default dropout 0.1, bf16, on padded batches
    with a [B, 1, 1, S] bool mask and the MLM and NSP losses through
    F.cross_entropy (both softmax cross-entropy kernels): graph and eager
    steps bitwise equal over 4 steps."""
    data = _bert_data()
    runs = []
    for form in ("graph", "eager"):
        net = _tiny_bert(dev)
        model, engine = _train_api(net, form, lr=1e-3, loss=_bert_loss,
                                   labels=["mlm", "nsp"])
        hist = model.fit(ptt.io.TensorDataset(data), batch_size=4,
                         shuffle=False, verbose=0)
        runs.append((hist["step_loss"], _params(net)))
        if form == "graph":
            (launches,) = engine.graph_launches.values()
            assert launches["softmax_xent"] == 2
            assert launches["softmax_xent_bwd"] == 2
            assert launches["flash_attention"] == 2
    assert len(runs[0][0]) == 4 and runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def _eval_model(net, form, metrics=(), loss=_lm_loss, labels=None):
    """A Model over ``net`` whose eval engine replays graphs ("graph") or
    whose evaluation runs the eager ``_eval`` ("eager")."""
    model = ptt.Model(net, labels=labels).prepare(
        ptt.optimizer.AdamW(learning_rate=0.01,
                            parameters=net.parameters()), loss,
        metrics=list(metrics))
    if form == "eager":
        model._eval_begin()._replaying = False
    return model


@pytest.mark.parametrize("kind", ["gpt-f32", "gpt-bf16", "bert-bf16"])
def test_eval_graph_is_bitwise_the_eager_eval(dev, kind):
    """evaluate and predict through the eval graphs against the eager
    ``_eval``, at the networks' default dropout (off in eval): losses,
    metric and outputs bitwise equal; one capture per signature (the
    short last batch and predict's label-free step get their own), the
    rest replays, with no dropout key drawn; the eval graph holds the
    forward kernels (masked attention and both cross-entropy forwards for
    BERT)."""
    from paddle_tpu_torch.framework import random as port_random

    if kind == "bert-bf16":
        data = _bert_data(n=22)
        n_in = len(data)            # predict splits the labels off
        make = lambda: _tiny_bert(dev)          # noqa: E731
        kw = dict(loss=_bert_loss, labels=["mlm", "nsp"])

        class Metric(ptt.metric.Accuracy):
            def compute(self, mlm_logits, nsp_logits, mlm, nsp):
                return super().compute(nsp_logits, nsp)
    else:
        ids = torch.from_numpy(np.random.RandomState(13).randint(
            0, 96, (22, 32)))
        data, n_in, kw, Metric = [ids, ids], 1, {}, ptt.metric.Accuracy
        dtype = torch.float32 if kind == "gpt-f32" else torch.bfloat16
        make = lambda: _train_gpt(dev, dtype, 0.1)   # noqa: E731
    runs = []
    for form in ("graph", "eager"):
        model = _eval_model(make(), form, [Metric()], **kw)
        draws = port_random._generator.get_state()
        res = model.evaluate(ptt.io.TensorDataset(data), batch_size=4,
                             verbose=0)
        outs = model.predict(ptt.io.TensorDataset(data[:n_in]),
                             batch_size=4)
        assert torch.equal(port_random._generator.get_state(), draws)
        runs.append((res, outs))
        engine = model._eval_engine
        if form == "graph":
            assert engine.captures == 4 and engine.replays == 8
            launches = engine.graph_launches
            assert len(launches) == 4
            for got in launches.values():
                for name in ("layer_norm", "bias_gelu", "flash_attention"):
                    assert got[name] > 0, (name, got)
                assert "flash_attention_dq" not in got
            if kind == "bert-bf16":
                assert max(g.get("softmax_xent", 0)
                           for g in launches.values()) == 2
        else:
            assert engine.captures == engine.replays == 0
    (res, outs), (e_res, e_outs) = runs
    assert res == e_res
    flat = [t for o in outs for t in (o if isinstance(o, tuple) else (o,))]
    e_flat = [t for o in e_outs for t in (o if isinstance(o, tuple)
                                          else (o,))]
    assert len(flat) == len(e_flat) > 0
    assert all(torch.equal(a, b) for a, b in zip(flat, e_flat))


def test_predict_returns_copies_a_later_replay_leaves_alone(dev):
    net = _train_gpt(dev, torch.bfloat16, 0.1)
    model = _eval_model(net, "graph")
    ids = [torch.from_numpy(np.random.RandomState(i).randint(0, 96, (4, 32)))
           for i in range(3)]
    model.predict_batch([ids[0]])                      # the capture
    out = model.predict_batch([ids[1]])               # a replay
    held = out.clone()
    again = model.predict_batch([ids[2]])             # the next replay
    g = next(iter(model._eval_engine._graphs.values()))
    assert model._eval_engine.replays == 2
    assert out is not g.outs and again is not g.outs
    assert torch.equal(out, held) and not torch.equal(out, again)
    outs, loss = model.eval_batch([ids[1]], [ids[1]])
    assert torch.equal(outs, held) and np.isfinite(loss)


def test_load_in_place_keeps_the_graphs(dev, tmp_path):
    """fit (train graph captured), evaluate (eval graph captured), save,
    fit on, load the saved files: they are copied into the parameters and
    slots where they lie, so the next fit and evaluate replay the graphs
    they had, and the losses are bitwise those of the eager steps doing
    the same.  A load that replaces the slot tensors
    (``Optimizer.set_state_dict``) makes the next fit capture again."""
    data = torch.from_numpy(np.random.RandomState(14).randint(0, 96,
                                                              (24, 32)))
    ds = [ptt.io.TensorDataset([data[i:i + 8], data[i:i + 8]])
          for i in (0, 8, 16)]
    runs = []
    for form in ("graph", "eager"):
        net = _train_gpt(dev, torch.bfloat16, 0.1)
        model, engine = _train_api(net, form)
        if form == "eager":
            model._eval_begin()._replaying = False
        path = str(tmp_path / form)

        def fit(d):
            return model.fit(d, batch_size=4, shuffle=False,
                             verbose=0)["step_loss"]

        losses = fit(ds[0]) + [model.evaluate(ds[2], batch_size=4,
                                              verbose=0)["loss"]]
        model.save(path)
        losses += fit(ds[1])
        model.load(path)
        losses += fit(ds[1]) + [model.evaluate(ds[2], batch_size=4,
                                               verbose=0)["loss"]]
        if form == "graph":
            assert engine.captures == 1 and engine.replays == 5
            assert model._eval_engine.captures == 1
            assert model._eval_engine.replays == 3
        model._optimizer.set_state_dict(model._optimizer.state_dict())
        losses += fit(ds[1])
        if form == "graph":
            assert engine.captures == 2
        runs.append((losses, _params(net)))
    (losses, params), (e_losses, e_params) = runs
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert losses == e_losses
    assert all(torch.equal(a, b) for a, b in zip(params, e_params))


@pytest.mark.parametrize("metric", [False, True])
def test_fit_syncs_only_to_drain(dev, metric):
    """Replayed Model.fit steps under torch.cuda.set_sync_debug_mode:
    without a metric (or a callback of the user's) only the drains sync,
    at log_freq steps and the epoch's end; with a metric each step makes
    one copy, its loss and the metric's compute values together (as the
    reference syncs every step then), and nothing else does."""
    import os
    import warnings

    net = _train_gpt(dev, torch.bfloat16, 0.1)
    model = ptt.Model(net).prepare(
        ptt.optimizer.AdamW(learning_rate=0.01, parameters=net.parameters()),
        _lm_loss, metrics=[ptt.metric.Accuracy()] if metric else None)
    data = torch.from_numpy(np.random.RandomState(15).randint(0, 96,
                                                              (28, 32)))
    model.fit(ptt.io.TensorDataset([data[:4], data[:4]]), batch_size=4,
              verbose=0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            hist = model.fit(ptt.io.TensorDataset([data[4:], data[4:]]),
                             batch_size=4, shuffle=False, verbose=0,
                             log_freq=4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [os.path.basename(w.filename) for w in caught
             if str(w.message).startswith(SYNC_WARNING)]
    assert model._engine.captures == 1 and model._engine.replays == 6
    assert syncs == ["engine.py"] * (6 if metric else 3)
    assert len(hist["step_loss"]) == 6 and all(np.isfinite(hist["loss"]))


# -- the cross form (S_q != S_k): the encoder-decoder's cross-attention and
# a cached decode step
CROSS_VARIANTS = [(torch.bfloat16, 0, "mma"), (torch.bfloat16, 1, "simt"),
                  (torch.float32, 0, "simt")]


def _cross_views(g, dev, dtype, B, S, H, D, offset, n):
    return [torch.randn(B * S * H * D + 8, generator=g, device=dev).to(
        dtype)[offset:offset + B * S * H * D].view(B, S, H, D)
        for _ in range(n)]


@pytest.mark.parametrize("dtype,offset,variant", CROSS_VARIANTS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("S_q", [1, 9, 64, 100])
@pytest.mark.parametrize("S_k", [5, 72, 128, 200])
def test_flash_attention_cross_kernels(dev, dtype, offset, variant, causal,
                                       kind, p, S_q, S_k):
    """Forward (O and LSE), dq and dk/dv with S_q queries over S_k keys
    against the plain versions, causal top-left or not, with a bool
    [B, 1, 1, S_k] padding mask (key 0 always visible) or a full additive
    [B, H, S_q, S_k] one, p = 0 and 0.1; each launch takes its kernel.
    (B, H) = (12, 12) at S_q >= 64 gives the tensor-core kernels their
    64- and 128-row query tiles and 64-key dk/dv tiles, (2, 3) their
    16-row ones; causal with S_q < S_k leaves keys no query sees, whose dk
    and dv must be written as zeros."""
    B, H, D = (12, 12, 64) if S_q >= 64 else (2, 3, 64)
    g = torch.Generator(device=dev).manual_seed(S_q * 1000 + S_k)
    q, do = _cross_views(g, dev, dtype, B, S_q, H, D, offset, 2)
    k, v = _cross_views(g, dev, dtype, B, S_k, H, D, offset, 2)
    if kind == "bool":
        lens = torch.randint(1, S_k + 1, (B,), generator=g, device=dev)
        m = (torch.arange(S_k, device=dev)[None, :] < lens[:, None])
        m = m[:, None, None, :]
    else:
        m = torch.randn(B, H, S_q, S_k, generator=g, device=dev)
    bias = flash_attention.fold_mask(m, B, H, S_q, S_k)
    form = dict(causal=causal, bias=bias, dropout_p=p, seed=S_q + 7 * S_k)
    before = flash_attention.variant_launches()
    out, lse = flash_attention.flash_attention(q, k, v, **form)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, **form)
    assert out.shape == (B, S_q, H, D) and lse.shape == (B * H, S_q)
    _check(out, ref, dtype)
    _check(lse, ref_lse, torch.float32 if dtype == torch.float32 else dtype)
    delta = flash_attention.flash_attention_delta(out, do)
    dk_out = [torch.full_like(k, float("nan")) for _ in range(2)]
    dq = flash_attention.flash_attention_dq(q, k, v, do, lse, delta, **form)
    dk, dv = flash_attention.flash_attention_dkv(q, k, v, do, lse, delta,
                                                 out=dk_out, **form)
    _check(dq, flash_attention.flash_attention_dq_plain(
        q, k, v, do, lse, delta, **form), dtype)
    ref_k, ref_v = flash_attention.flash_attention_dkv_plain(
        q, k, v, do, lse, delta, **form)
    _check(dk, ref_k, dtype)
    _check(dv, ref_v, dtype)
    if causal and S_q < S_k:
        assert torch.all(dk[:, S_q:] == 0) and torch.all(dv[:, S_q:] == 0)
    took = _variant_delta(before)
    assert all(took[name][variant] == 1 for name in took), took


@pytest.mark.parametrize("S_q,S_k", [(64, 72), (1, 72), (100, 5),
                                     (9, 200)])
def test_dropout_mask_entry_matches_plain_cross(dev, S_q, S_k):
    """The keep mask over [B, H, S_q, S_k] written by the kernels' own
    device function is bitwise the plain version's, and the top-left
    corner of the square mask (no draw depends on either length)."""
    seed, B, H, p = 0xFACE + S_k, 3, 8, 0.1
    got = flash_attention.dropout_keep(seed, B, H, S_q, p, dev, S_k=S_k)
    assert got.shape == (B, H, S_q, S_k)
    assert torch.equal(got, flash_attention.dropout_keep_plain(
        seed, B, H, S_q, p, dev, S_k=S_k))
    n = max(S_q, S_k)
    square = flash_attention.dropout_keep(seed, B, H, n, p, dev)
    assert torch.equal(got, square[:, :, :S_q, :S_k])


def _seq2seq(dev, dtype):
    """A small seq2seq model of the [seq2seq] phase's class (chip_smoke.py
    ``seq2seq_model``): vocab 96, d_model 64, 4 heads, 2 + 2 layers, FFN
    128, dropout 0.1, batches of 72 source and 64 target positions."""
    import chip_smoke

    ptt.seed(5)
    return chip_smoke, chip_smoke.seq2seq_model(
        torch, dev, dtype, vocab=96, d_model=64, nhead=4, layers=2, ffn=128)


@pytest.mark.parametrize("dtype", DTYPES)
def test_seq2seq_fit_graph_is_bitwise_the_eager_step(dev, dtype):
    """Model.fit of a small encoder-decoder Transformer (source ids and
    target input ids in, target ids as the label, dropout 0.1, Adam with
    NoamDecay) through the captured step and through ``_step_eager`` from
    one seed: losses and parameters bitwise equal over 6 steps; one
    capture holding every attention kernel in its cross form once a
    decoder layer, both cross-entropy kernels and one optimizer launch."""
    from paddle_tpu_torch.hapi.engine import TrainEngine
    from paddle_tpu_torch.ops import kernels

    runs = {}
    for form in ("graph", "eager"):
        cs, net = _seq2seq(dev, dtype)
        data = cs.s2s_batches(torch, np.random.RandomState(8), 24, vocab=96)
        sched = ptt.optimizer.lr.NoamDecay(d_model=64, warmup_steps=10)
        opt = ptt.optimizer.Adam(learning_rate=sched, beta2=0.98,
                                 epsilon=1e-9, parameters=net.parameters())
        model = ptt.Model(net, inputs=["src", "tgt_in"], labels=["tgt_out"])
        model.prepare(opt, cs.s2s_loss)
        engine = model._engine = TrainEngine(model)
        if form == "eager":
            engine.step = engine._step_eager
        kernels.reset_launch_counts()
        hist = model.fit(ptt.io.TensorDataset(data), batch_size=4,
                         shuffle=False, verbose=0, log_freq=2)
        runs[form] = (hist["step_loss"], _params(net))
        if form == "graph":
            assert engine.captures == 1 and engine.replays == 5
            (launches,) = engine.graph_launches.values()
            assert launches["multi_tensor_step"] == 1
            assert launches["softmax_xent"] == launches[
                "softmax_xent_bwd"] == 1
            for name in ("flash_attention", "flash_attention_dq",
                         "flash_attention_dkv"):
                assert launches[name] == 6, (name, launches)
            # the first step and the capture: 2 cross-form launches each
            assert flash_attention.cross_launches() == dict.fromkeys(
                ("flash_attention", "flash_attention_dq",
                 "flash_attention_dkv"), 4)
    losses, params = runs["graph"]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses == runs["eager"][0]
    assert all(torch.equal(a, b) for a, b in zip(params, runs["eager"][1]))


def test_seq2seq_cached_decoding_matches_recompute(dev):
    """Greedy decoding in float32 with the caches (one decoder step a
    token: S_q = 1 over the tokens so far and over the memory) gives the
    tokens of recomputing the whole prefix each step."""
    cs, net = _seq2seq(dev, torch.float32)
    net.eval()
    src = cs.s2s_batches(torch, np.random.RandomState(9), 3,
                         vocab=96)[0].to(dev)
    cached, logits, _ = cs.s2s_decode(torch, net, src, 12)
    again, ref, _ = cs.s2s_decode(torch, net, src, 12, cache=False)
    assert torch.equal(cached, again)
    for a, b in zip(logits, ref):
        _check(a, b, torch.float32)


# ---------------------------------------------------------------------------
# mixed precision: the float16 and mixed-dtype forms of the training
# kernels, the unscale kernel, float16 parameters in the optimizer kernel
# and Model.fit under auto_cast
# ---------------------------------------------------------------------------
# float16: eight half-ulps at the top binade (twice bf16's margin in ulps;
# the tensor-core attention kernels round p and ds to float16 before the
# second product, as the reference does)
F16_TOL = 2 ** -8
AMP_FORMS = [(torch.float16, torch.float16), (torch.float16, torch.float32),
             (torch.bfloat16, torch.float32)]   # (x's dtype, weight's)


def _amp_check(out, ref):
    torch.cuda.synchronize()
    scale = max(1.0, ref.float().abs().max().item())
    tol = (F16_TOL if out.dtype == torch.float16 else 2 ** -6) * scale
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype,wdtype", AMP_FORMS)
@pytest.mark.parametrize("rows,n", [(3, 768), (1000, 768), (5, 100),
                                    (2, 2048)])
@pytest.mark.parametrize("offset", [0, 1])
def test_amp_layer_norm_kernel(dev, dtype, wdtype, rows, n, offset):
    """LayerNorm in float16, and with a float32 weight and bias beside
    16-bit x (y in x's dtype): y, mean and rstd against the plain
    version, on both kernels (vector and block per row); the backward's
    dw and db in the weight's dtype."""
    g = torch.Generator(device=dev).manual_seed(rows + n + offset)
    buf = (torch.randn(rows * n + 8, generator=g, device=dev) * 3 + 1).to(
        dtype)
    x = buf[offset:offset + rows * n].view(rows, n)
    w = (1 + 0.1 * torch.randn(n, generator=g, device=dev)).to(wdtype)
    b = (0.1 * torch.randn(n, generator=g, device=dev)).to(wdtype)
    variants = layer_norm.variant_launches()["layer_norm"]
    y, mean, rstd = layer_norm._forward(x, w, b, 1e-5, stats=True)
    ref_y, ref_mean, ref_rstd = layer_norm._plain_with_stats(x, w, b, 1e-5)
    assert y.dtype == dtype
    _amp_check(y, ref_y)
    _check(mean, ref_mean, torch.float32)
    _check(rstd, ref_rstd, torch.float32)
    per = 16 // x.element_size()
    taken = "warp" if offset == 0 and n % per == 0 and n <= 256 * per \
        else "block"
    assert layer_norm.variant_launches()["layer_norm"][taken] \
        == variants[taken] + 1
    xg, wg, bg = (t.detach().clone().requires_grad_() for t in (x, w, b))
    layer_norm.layer_norm(xg, wg, bg).float().square().sum().backward()
    assert xg.grad.dtype == dtype and wg.grad.dtype == bg.grad.dtype \
        == wdtype


@pytest.mark.parametrize("dtype,bdtype", AMP_FORMS)
@pytest.mark.parametrize("rows,n", [(1, 5), (3, 3072), (257, 3072)])
def test_amp_bias_gelu_kernels(dev, dtype, bdtype, rows, n):
    """The bias-GeLU forward and backward in float16, and with a float32
    bias beside 16-bit x, against the plain versions; db is the float32
    row sum of dx in the bias's dtype."""
    g = torch.Generator(device=dev).manual_seed(rows + n)
    x = (2 * torch.randn(rows, n, generator=g, device=dev)).to(dtype)
    b = (0.5 * torch.randn(n, generator=g, device=dev)).to(bdtype)
    dy = torch.randn(rows, n, generator=g, device=dev).to(dtype)
    y = bias_gelu.bias_gelu(x, b)
    assert y.dtype == dtype
    _amp_check(y, bias_gelu.bias_gelu_plain(x, b))
    dx = bias_gelu.bias_gelu_bwd(x, b, dy)
    _amp_check(dx, bias_gelu.bias_gelu_bwd_plain(x, b, dy))
    xg, bg = x.clone().requires_grad_(), b.clone().requires_grad_()
    bias_gelu.bias_gelu(xg, bg).backward(dy)
    assert bg.grad.dtype == bdtype
    ref_db = bias_gelu.bias_gelu_bwd_plain(x, b, dy).float().sum(0)
    # dx rounds to x's dtype before the sum: its tolerance
    _check(bg.grad.float(), ref_db, torch.bfloat16)


@pytest.mark.parametrize("n,V", [(37, 2), (64, 30522), (5, 18000)])
def test_amp_softmax_xent_kernels(dev, n, V):
    """softmax cross entropy on float16 logits (the NSP head's V = 2 and
    ERNIE's 18,000-token vocabulary), forward and backward, against the
    plain versions; ignored rows' dz exactly 0."""
    from paddle_tpu_torch.ops.kernels import softmax_xent

    g = torch.Generator(device=dev).manual_seed(n + V)
    z = (3 * torch.randn(n, V, generator=g, device=dev)).half()
    labels = torch.randint(0, V, (n,), generator=g, device=dev)
    labels[::3] = -100
    loss, lse = softmax_xent.softmax_xent_fwd(z, labels)
    ref_loss, ref_lse = softmax_xent.softmax_xent_plain(z, labels)
    _check(loss, ref_loss, torch.float32)
    _check(lse, ref_lse, torch.float32)
    gr = torch.rand(n, generator=g, device=dev)
    dz = softmax_xent.softmax_xent_bwd(z, labels, lse, gr)
    assert dz.dtype == torch.float16
    _amp_check(dz, softmax_xent.softmax_xent_bwd_plain(z, labels, lse, gr))
    assert not dz[::3].any()


AMP_ATTENTION = [("causal", 2, 77, 77), ("mask", 3, 128, 128),
                 ("dropout", 2, 64, 64), ("cross", 3, 64, 72),
                 ("causal-cross", 2, 20, 48)]


@pytest.mark.parametrize("form,B,S_q,S_k", AMP_ATTENTION)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("offset", [0, 1])
def test_amp_flash_attention_float16(dev, form, B, S_q, S_k, D, offset):
    """The three attention kernels in float16, on the tensor cores
    (aligned) and on the CUDA cores (q, k, v one element off a 16-byte
    boundary): causal, a padding mask, dropout, and S_q != S_k, against
    the plain versions; the dropout mask is the bf16 kernels' (a pure
    function of seed and position)."""
    H = 3
    g = torch.Generator(device=dev).manual_seed(S_q * D + S_k + offset)

    def rnd(S):
        buf = torch.randn(B * S * H * D + 8, generator=g, device=dev).half()
        return buf[offset:offset + B * S * H * D].view(B, S, H, D)

    q, k, v, do = rnd(S_q), rnd(S_k), rnd(S_k), rnd(S_q)
    causal = form.startswith("causal")
    bias, p, seed = None, 0.0, 0
    if form == "mask":
        lens = torch.randint(S_k // 2, S_k + 1, (B,), generator=g,
                             device=dev)
        mask = torch.arange(S_k, device=dev)[None] < lens[:, None]
        bias = flash_attention.fold_mask(mask[:, None, None, :], B, H, S_q,
                                         S_k)
    if form == "dropout":
        p, seed = 0.1, 0xA11CE
    form_kw = dict(causal=causal, bias=bias, dropout_p=p, seed=seed)
    before = flash_attention.variant_launches()
    out, lse = flash_attention.flash_attention(q, k, v, **form_kw)
    ref, ref_lse = flash_attention.flash_attention_plain(q, k, v, **form_kw)
    assert out.dtype == torch.float16
    _amp_check(out, ref)
    _check(lse, ref_lse, torch.bfloat16)
    delta = flash_attention.flash_attention_delta(out, do)
    dq = flash_attention.flash_attention_dq(q, k, v, do, lse, delta,
                                            **form_kw)
    dk, dv = flash_attention.flash_attention_dkv(q, k, v, do, lse, delta,
                                                 **form_kw)
    _amp_check(dq, flash_attention.flash_attention_dq_plain(
        q, k, v, do, lse, delta, **form_kw))
    rk, rv = flash_attention.flash_attention_dkv_plain(
        q, k, v, do, lse, delta, **form_kw)
    _amp_check(dk, rk)
    _amp_check(dv, rv)
    taken = "mma" if offset == 0 else "simt"
    after = flash_attention.variant_launches()
    for name in ("flash_attention", "flash_attention_dq",
                 "flash_attention_dkv"):
        assert after[name][taken] == before[name][taken] + 1, name


def test_amp_dropout_mask_is_the_same_in_float16_and_bf16(dev):
    """q = 0 makes every weight 1 / S, and V = I puts weight (i, j) in
    O[i, j]: the float16 and the bf16 forward keep the same (query, key)
    pairs for one seed, the plain version's mask."""
    B, S, H, D, p, seed = 2, 64, 2, 64, 0.25, 0xD7
    q = torch.zeros(B, S, H, D, device=dev)
    v = torch.eye(S, D, device=dev)[None, :, None].expand(B, S, H, D)
    kept = []
    for dtype in (torch.float16, torch.bfloat16):
        out, _ = flash_attention.flash_attention(
            q.to(dtype), q.to(dtype), v.contiguous().to(dtype),
            causal=False, dropout_p=p, seed=seed)
        kept.append(out.float() != 0)
    assert torch.equal(kept[0], kept[1])
    keep = flash_attention.dropout_keep_plain(seed, B, H, S, p, dev)
    assert torch.equal(kept[0], keep.permute(0, 2, 1, 3))


def _amp_grads(dev, dtype, unaligned=False):
    g = torch.Generator(device=dev).manual_seed(31)
    grads = [torch.randn(*s, generator=g, device=dev).mul(1024).to(dtype)
             for s in OPT_SHAPES]
    if unaligned:
        buf = torch.randn(1001, generator=g, device=dev).to(dtype)
        grads.append(buf[1:])
    return grads


@pytest.mark.parametrize("dtype", DTYPES + [torch.float16])
@pytest.mark.parametrize("plant", ["clean", "inf", "nan"])
def test_amp_unscale_kernel_is_bitwise_the_plain_version(dev, dtype, plant):
    """check_finite_and_unscale_ over gradients of every shape of the
    optimizer tests (one unaligned), in one launch: bitwise the plain
    version, the flag set exactly when an inf or a NaN was planted."""
    from paddle_tpu_torch.ops.kernels import amp as amp_kernel

    grads = _amp_grads(dev, dtype, unaligned=True)
    if plant != "clean":
        grads[1].view(-1)[77] = float(plant)
    ref = [t.clone() for t in grads]
    inv = torch.full((1,), 2.0 ** -15, device=dev)
    found = torch.zeros(1, dtype=torch.int32, device=dev)
    ref_found = torch.zeros(1, dtype=torch.int32, device=dev)
    before = amp_kernel.check_finite_and_unscale_.launches
    amp_kernel.check_finite_and_unscale_(grads, inv, found)
    assert amp_kernel.check_finite_and_unscale_.launches == before + 1
    amp_kernel.check_finite_and_unscale_plain(ref, inv, ref_found)
    torch.cuda.synchronize()
    for a, b in zip(grads, ref):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert found.item() == ref_found.item() == (plant != "clean")


def test_amp_grad_scaler_skips_and_halves(dev):
    """GradScaler on float16 parameters: a step with an inf in a
    gradient is skipped (parameters unchanged), the scale halves every
    second bad step; a clean step updates through one optimizer launch
    and one unscale launch."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops.kernels import amp as amp_kernel

    params = [torch.nn.Parameter(t) for t in _amp_grads(dev,
                                                        torch.float16)]
    opt = ptt.optimizer.AdamW(learning_rate=1e-3, parameters=params)
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    scales = []
    for step in range(5):
        for p in params:
            p.grad = torch.ones_like(p) * 8
        if step in (1, 2):
            params[0].grad.view(-1)[3] = float("inf")
        before = [p.detach().clone() for p in params]
        launches = (multi_tensor.multi_tensor_step.launches,
                    amp_kernel.check_finite_and_unscale_.launches)
        scaler.step(opt)
        opt.clear_grad()
        skipped = step in (1, 2)
        assert all(torch.equal(a, b) for a, b in zip(params, before)) \
            == skipped
        assert multi_tensor.multi_tensor_step.launches - launches[0] \
            == (0 if skipped else 1)
        assert amp_kernel.check_finite_and_unscale_.launches \
            - launches[1] == 1
        scales.append(scaler.get_loss_scaling())
    assert scales == [2.0 ** 15, 2.0 ** 15, 2.0 ** 14, 2.0 ** 14, 2.0 ** 14]


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
@pytest.mark.parametrize("case", ["plain", "unaligned", "resume"])
def test_multi_tensor_step_float16_is_the_loop(dev, kind, case):
    """float16 parameters (AMP-O2), float32 moments: after 3 steps the
    kernel's parameters and slots equal the per-parameter loop's bit for
    bit; one launch a step."""
    kw = dict(unaligned=case == "unaligned",
              resume_at=1 if case == "resume" else None)
    before = multi_tensor.multi_tensor_step.launches
    got, got_slots = _opt_run(dev, kind, torch.float16, plain=False, **kw)
    assert multi_tensor.multi_tensor_step.launches == before + 3
    want, want_slots = _opt_run(dev, kind, torch.float16, plain=True, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.float16
        assert torch.equal(a, b), (i, (a.float() - b.float()).abs().max())
    for a, b in zip(got_slots, want_slots):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fit_amp_graph_is_bitwise_the_eager_step(dev, dtype):
    """Model.fit of a small float32 BERT under auto_cast(level="O1") in
    bf16 and float16 through the captured step and through
    ``_step_eager``: losses and parameters bitwise equal; the graph holds
    the mixed bias-GeLU and LayerNorm forms; a plain fit of the same model
    afterwards captures a graph of its own (the AMP policy is part of the
    signature)."""
    from paddle_tpu_torch import amp

    data = _bert_data(n=16)
    runs = {}
    for form in ("graph", "eager"):
        net = _tiny_bert(dev, torch.float32)
        model, engine = _train_api(net, form, loss=_bert_loss,
                                   labels=["mlm", "nsp"])
        with amp.auto_cast(level="O1", dtype=dtype):
            hist = model.fit(ptt.io.TensorDataset(data), batch_size=4,
                             shuffle=False, verbose=0, log_freq=2)
        runs[form] = (hist["step_loss"], _params(net))
        if form == "graph":
            assert engine.captures == 1 and engine.replays == 3
            (sig,) = engine.graph_launches
            assert sig[-1] == (True, dtype, "O1")
            model.fit(ptt.io.TensorDataset(data), batch_size=4,
                      shuffle=False, verbose=0)
            assert engine.captures == 2 and engine.replays == 6
            assert (False,) in {s[-1] for s in engine.graph_launches}
    losses, params = runs["graph"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses == runs["eager"][0]
    assert all(torch.equal(a, b) for a, b in zip(params, runs["eager"][1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_embedding_gradient_is_deterministic(dev, dtype):
    """A float32 or float16 table of 2, 4 and 512 rows over a 4096-token
    batch: the gradient of ``nn.functional.embedding`` is bitwise the same
    in 10 calls (PyTorch's CUDA embedding backward varied from call to
    call for float32 segment tables) and is the float32 sum of each id's
    rows, rounded once; a bf16 table takes PyTorch's backward."""
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator(device=dev).manual_seed(41)
    for rows in (2, 4, 512):
        ids = torch.randint(0, rows, (32, 128), generator=g, device=dev)
        dy = torch.randn(32, 128, 768, generator=g, device=dev).to(dtype)
        w = torch.randn(rows, 768, generator=g, device=dev).to(
            dtype).requires_grad_()
        grads = []
        for _ in range(10):
            w.grad = None
            F.embedding(ids, w).backward(dy)
            grads.append(w.grad.clone())
        assert all(torch.equal(grads[0], x) for x in grads[1:]), rows
        assert grads[0].dtype == dtype
        ref = torch.zeros(rows, 768, device=dev, dtype=torch.float64)
        ref.index_add_(0, ids.reshape(-1), dy.reshape(-1, 768).double())
        _check(grads[0].float(), ref, torch.float32 if dtype ==
               torch.float32 else dtype)
    wb = torch.randn(4, 768, device=dev).bfloat16().requires_grad_()
    F.embedding(ids.clamp(max=3), wb).backward(dy.bfloat16())
    assert wb.grad.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# float16 paged decode; the vision paths' batch norm in the
# captured train and eval steps
# ---------------------------------------------------------------------------
F16_TOL = 2 ** -8     # x max(1, max|ref|): four float16 ulps at the top


def _check_f16(out, ref):
    torch.cuda.synchronize()
    assert out.dtype == torch.float16
    tol = F16_TOL * max(1.0, ref.float().abs().max().item())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("ps,hd", [(1, 64), (8, 32), (16, 64), (32, 128),
                                   (5, 12)])
@pytest.mark.parametrize("variant", ["split", "lane"])
def test_paged_decode_float16_kernels(dev, ps, hd, variant):
    """The float16 instantiation of both kernels against the plain
    version (float32 arithmetic, float16 out), over lanes of very
    different lengths, an inactive lane and a page boundary; the split
    kernel on aligned operands (hd 12 is not a multiple of a 16-byte
    vector: the lane kernel), the lane kernel on a q one element off a
    16-byte boundary."""
    pps = -(-256 // ps)
    inputs = _paged_inputs(dev, torch.float16, (255, 3, -1, 63, 127, 0, 200),
                           ps, hd, nh=3, pps=pps,
                           offset=0 if variant == "split" else 1,
                           seed=ps * hd + 1)
    before = paged_attention.variant_launches()["paged_decode_attention"]
    out = paged_attention.paged_decode_attention(*inputs, pps * ps)
    ref = paged_attention.paged_decode_attention_plain(*inputs, pps * ps)
    _check_f16(out, ref)
    after = paged_attention.variant_launches()["paged_decode_attention"]
    took = variant if hd % 8 == 0 else "lane"
    assert after[took] == before[took] + 1
    assert torch.all(out[2] == 0)
    assert not paged_attention._arrivals[dev.index or 0].any()


@pytest.mark.parametrize("lane_pos", [
    (511, 15, 16, 100, 255, 37, 480, -1),       # the serving table's shape
    (20, 176, 57, 131, 88, 160, 35, 113),       # a serving wave's
])
def test_paged_decode_float16_serving_shapes_and_reproducibility(dev,
                                                                 lane_pos):
    """Serving's shape (8 slots, 12 x 64, page 16, 32 pages a slot) in
    float16: against the plain version, bitwise the same in two calls and
    for each lane alone, and each lane's output within F16_TOL of the bf16
    kernel's on the same values rounded to bf16 (a float16 value is not a
    bf16 one: held only loosely, at bf16's 2**-6)."""
    q, kp, vp, rows, pos = _paged_inputs(dev, torch.float16, lane_pos, 16,
                                         64, nh=12, pps=32, seed=11)
    out = paged_attention.paged_decode_attention(q, kp, vp, rows, pos, 512)
    _check_f16(out, paged_attention.paged_decode_attention_plain(
        q, kp, vp, rows, pos, 512))
    assert torch.equal(out, paged_attention.paged_decode_attention(
        q, kp, vp, rows, pos, 512))
    for lane in range(q.shape[0]):
        alone = paged_attention.paged_decode_attention(
            q[lane:lane + 1], kp, vp, rows[lane:lane + 1],
            pos[lane:lane + 1], 512)
        assert torch.equal(alone[0], out[lane]), lane
    bf = paged_attention.paged_decode_attention(
        q.bfloat16(), kp.bfloat16(), vp.bfloat16(), rows, pos, 512)
    _check(out, bf, torch.bfloat16)


def test_engine_serves_a_float16_model_through_its_graph(dev):
    """A float16 GPT behind the engine: the pool is float16, the decode
    graph holds paged decode, and its greedy and sampled tokens are
    bitwise the eager step's."""
    from paddle_tpu_torch.serving import GenerationEngine

    model = _serving_model(dev, torch.float32)
    model.astype("float16")
    outs = {}
    for form in ("graph", "eager"):
        with GenerationEngine(model, device=dev, **SERVE_ENGINE) as eng:
            assert eng._state["kp"].dtype == torch.float16
            if form == "eager":
                eng.step = eng._step_eager
            outs[form] = _mixed_wave(eng)
            _idle(eng)
            assert eng.capture_count == 1
            assert (eng.replays > 0) == (form == "graph")
            assert eng.graph_launches["paged_decode_attention"] == 2
    assert outs["graph"] == outs["eager"]


def _bn_net(dev, dtype):
    """A small BN network of the ResNet family on the card."""
    from paddle_tpu_torch.vision.models import resnet18

    ptt.seed(5)
    net = resnet18(num_classes=10, device=dev)
    net.astype(dtype)
    return net


def _bn_data(dtype, n=20):
    rs = np.random.RandomState(12)
    x = torch.from_numpy(rs.randn(n, 3, 32, 32).astype(np.float32)).to(dtype)
    return [x, torch.from_numpy(rs.randint(0, 10, n).astype(np.int64))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_fit_graph_is_bitwise_the_eager_step(dev, dtype):
    """Model.fit on resnet18 (batch norm in every block) through the
    captured step against ``_step_eager``, under cudnn.deterministic: 20
    samples in batches of 6 (three, then a short one of 2: two
    signatures, each a warm-up step, a capture and its replays), every
    loss, parameter and running statistic bitwise equal: the statistics
    moved once a step (the warm-up is a real step, the capture runs
    nothing)."""
    from paddle_tpu_torch.hapi.engine import TrainEngine

    data = _bn_data(dtype)
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for form in ("graph", "eager"):
            net = _bn_net(dev, dtype)
            model = ptt.Model(net).prepare(
                ptt.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                       parameters=net.parameters()),
                tnn.CrossEntropyLoss())
            engine = model._engine = TrainEngine(model)
            if form == "eager":
                engine.step = engine._step_eager
            hist = model.fit(ptt.io.TensorDataset(data), batch_size=6,
                             shuffle=False, verbose=0, log_freq=1)
            if form == "graph":
                assert engine.captures == 2      # batches of 6 and of 2
                assert engine.replays == 2
            runs.append((hist["step_loss"],
                         {k: v.clone() for k, v in
                          net.state_dict().items()}))
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, sg), (le, se) = runs
    assert len(lg) == 4 and lg == le
    assert np.isfinite(lg).all()
    assert sorted(sg) == sorted(se)
    for k in sg:
        assert torch.equal(sg[k], se[k]), k
    assert not torch.equal(sg["bn1._mean"], torch.zeros_like(sg["bn1._mean"]))


def test_model_load_reaches_a_captured_eval_graph(dev):
    """evaluate captures its eval graph on the first weights; Model.load
    of another checkpoint writes the parameters and the running
    statistics in place, so the next evaluate replays the same graph (no
    new capture) and gives bitwise the eager ``_eval`` of the loaded
    network."""
    import tempfile

    data = _bn_data(torch.float32, n=16)
    ds = ptt.io.TensorDataset(data)
    src = _bn_net(dev, torch.float32)
    trainer = ptt.Model(src).prepare(
        ptt.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                               parameters=src.parameters()),
        tnn.CrossEntropyLoss(), metrics=[ptt.metric.Accuracy()])
    trainer.fit(ds, batch_size=8, shuffle=False, verbose=0)
    net = _bn_net(dev, torch.float32)
    model = ptt.Model(net).prepare(
        ptt.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                               parameters=net.parameters()),
        tnn.CrossEntropyLoss(), metrics=[ptt.metric.Accuracy()])
    before = model.evaluate(ds, batch_size=8, verbose=0)
    engine = model._eval_engine
    assert engine.captures == 1
    with tempfile.TemporaryDirectory() as d:
        trainer.save(d + "/ckpt")
        model.load(d + "/ckpt")
    after = model.evaluate(ds, batch_size=8, verbose=0)
    assert model._eval_engine is engine and engine.captures == 1
    assert engine.replays >= 2
    assert after["loss"] != before["loss"]
    for k, v in src.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    eager = ptt.Model(net).prepare(loss=tnn.CrossEntropyLoss(),
                                   metrics=[ptt.metric.Accuracy()])
    eager._eval_begin()._replaying = False
    assert eager.evaluate(ds, batch_size=8, verbose=0) == after


# ---------------------------------------------------------------------------
# the rest of the optimizers: the elementwise kernel's new rules bitwise the
# loop, the norm rules (Lamb, LarsMomentum, Dpsgd) within NORM_RTOL, and
# Model.fit with gradient accumulation, graph against eager
# ---------------------------------------------------------------------------
O = ptt.optimizer
NEW_RULES = {
    "adagrad": lambda ps, lr, clip: O.Adagrad(
        lr, parameters=ps, grad_clip=clip, initial_accumulator_value=0.1),
    "adamax": lambda ps, lr, clip: O.Adamax(lr, parameters=ps,
                                            grad_clip=clip),
    "adadelta": lambda ps, lr, clip: O.Adadelta(
        lr, parameters=ps, grad_clip=clip, weight_decay=0.01),
    "rmsprop": lambda ps, lr, clip: O.RMSProp(lr, parameters=ps,
                                              grad_clip=clip),
    "rmsprop_centered": lambda ps, lr, clip: O.RMSProp(
        lr, momentum=0.9, centered=True, parameters=ps, grad_clip=clip),
    "ftrl": lambda ps, lr, clip: O.Ftrl(lr, l1=0.01, l2=0.02,
                                        parameters=ps, grad_clip=clip),
    "ftrl_square": lambda ps, lr, clip: O.Ftrl(
        lr, l1=0.01, l2=0.02, lr_power=-2.0, parameters=ps, grad_clip=clip),
    "sgd_l1": lambda ps, lr, clip: O.SGD(
        lr, parameters=ps, grad_clip=clip,
        weight_decay=ptt.regularizer.L1Decay(0.01)),
    "momentum_l2": lambda ps, lr, clip: O.Momentum(
        lr, parameters=ps, grad_clip=clip,
        weight_decay=ptt.regularizer.L2Decay(0.02)),
}
NORM_RULES = {
    "lamb": lambda ps, lr, clip: O.Lamb(lr, lamb_weight_decay=0.01,
                                        parameters=ps, grad_clip=clip),
    "lars": lambda ps, lr, clip: O.LarsMomentum(lr, parameters=ps,
                                                grad_clip=clip),
    "dpsgd": lambda ps, lr, clip: O.Dpsgd(lr, clip=1.0, batch_size=16,
                                          sigma=1.0, parameters=ps),
}


def _rule_run(dev, make, dtype, plain, unaligned=False, steps=3, lr=0.01):
    """``steps`` updates by step() or step_plain() of ``make``'s optimizer
    from seeded values (as ``_opt_run``; the lr from ``lr``, times 0.8
    each step), Dpsgd's seeds drawn from one framework seed on both
    sides."""
    ptt.seed(5)
    params = _opt_params(dev, dtype, unaligned)
    sched = ptt.optimizer.lr.StepDecay(lr, step_size=1, gamma=0.8)
    opt = make(params, sched, tnn.ClipGradByGlobalNorm(5.0))
    g = torch.Generator(device=dev).manual_seed(22)
    for i in range(steps):
        for j, p in enumerate(params):
            p.grad = None if j == 3 else torch.randn(
                *p.shape, generator=g, device=dev).to(dtype)
        opt.step_plain() if plain else opt.step()
        opt.clear_grad()
        sched.step()
    torch.cuda.synchronize()
    slots = [[v.clone() for v in opt._slots.get(id(p), {}).values()]
             for p in params]
    return params, slots


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rule", sorted(NEW_RULES))
@pytest.mark.parametrize("unaligned", [False, True])
def test_new_rules_are_bitwise_the_loop(dev, rule, dtype, unaligned):
    """Adagrad, Adamax, Adadelta (coupled decay), RMSProp (plain, centered
    with momentum), Ftrl (sqrt and square powers), L1Decay and L2Decay
    objects: after 3 steps the kernel's parameters and slots equal the
    per-parameter loop's bit for bit; one launch a step."""
    before = multi_tensor.multi_tensor_step.launches
    got, got_slots = _rule_run(dev, NEW_RULES[rule], dtype, False,
                               unaligned)
    assert multi_tensor.multi_tensor_step.launches == before + 3
    want, want_slots = _rule_run(dev, NEW_RULES[rule], dtype, True,
                                 unaligned)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (i, (a.float() - b.float()).abs().max())
    for i, (a, b) in enumerate(zip(got_slots, want_slots)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == dtype and torch.equal(x, y), i


def _rel_err(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _step_rel_err(a, b, start):
    """||a - b|| / ||b - start||: how far run a's step lies from run b's,
    relative to b's step."""
    return ((a.float() - b.float()).norm()
            / (b.float() - start.float()).norm()).item()


# the norm rules' learning rates in the test below: 3 steps move a bf16
# element several ulps (Lamb about 5 % of each tensor's norm a step, LARS
# about 1 %, Dpsgd's noise about 0.06), so the kernel's step is seen
NORM_LR = {"lamb": 0.05, "lars": 10.0, "dpsgd": 1.0}
NORM_PLANTED = 1.25     # the planted fault: a step 25 % too large


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rule", sorted(NORM_RULES))
@pytest.mark.parametrize("unaligned", [False, True])
def test_norm_rules_are_the_loop_within_tolerance(dev, rule, dtype,
                                                  unaligned):
    """Lamb, LarsMomentum and Dpsgd: two launches a step; after 3 steps
    every parameter and slot within NORM_RTOL (float32) or NORM_BF16_RTOL
    (bf16) of the loop's, relative to the tensor's largest |value| (the
    norms sum in another order; docstring of ops/kernels/optimizer.py),
    and each parameter's step (p - p0) within the same tolerance of the
    loop's step, while the loop at NORM_PLANTED times the lr lies outside
    it; a second run is bitwise the first (no atomics)."""
    tol = multi_tensor.NORM_RTOL if dtype == torch.float32 \
        else multi_tensor.NORM_BF16_RTOL
    make, lr = NORM_RULES[rule], NORM_LR[rule]
    before = multi_tensor.multi_tensor_norm_step.launches
    got, got_slots = _rule_run(dev, make, dtype, False, unaligned, lr=lr)
    assert multi_tensor.multi_tensor_norm_step.launches == before + 6
    again, again_slots = _rule_run(dev, make, dtype, False, unaligned,
                                   lr=lr)
    want, want_slots = _rule_run(dev, make, dtype, True, unaligned, lr=lr)
    planted, _ = _rule_run(dev, make, dtype, True, unaligned,
                           lr=lr * NORM_PLANTED)
    start = _opt_params(dev, dtype, unaligned)
    for i, (a, b, c) in enumerate(zip(got, again, want)):
        assert torch.equal(a, b), i
        assert _rel_err(a, c) <= tol, (i, _rel_err(a, c))
        if i == 3:      # no gradient: not moved
            assert torch.equal(a, start[i]) and torch.equal(c, start[i])
            continue
        assert _step_rel_err(a, c, start[i]) <= tol, i
        assert _step_rel_err(planted[i], c, start[i]) > tol, i
    for a, b in zip(got_slots, want_slots):
        for x, y in zip(a, b):
            assert x.dtype == dtype and _rel_err(x, y) <= tol


def test_dpsgd_noise_and_sigma_zero(dev):
    """Dpsgd's kernel noise: the plain version's numbers (within 1e-5: the
    card's log, cos and sin against the same functions in torch's kernels),
    mean and standard deviation of 2**20 draws within 5 standard errors of
    N(0, 1), the same seed the same bits; with sigma = 0 and gradients
    under the clip, bitwise plain SGD."""
    n = 1 << 20
    p = torch.nn.Parameter(torch.zeros(n, device=dev))
    p.grad = torch.zeros(n, device=dev)
    hyper = {"clip": 1.0, "sigma": 1.0, "batch_size": 1}
    scalars = multi_tensor.make_scalars(dev)
    multi_tensor.write_scalars(scalars, "dpsgd", -1.0, 1, hyper)
    runs = []
    for _ in range(2):
        with torch.no_grad():
            p.zero_()
        multi_tensor.multi_tensor_norm_step("dpsgd", [p], [p.grad], [[]],
                                            -1.0, 1, hyper, scalars, 1234)
        runs.append(p.detach().clone())
    torch.cuda.synchronize()
    z = runs[0]
    assert torch.equal(runs[0], runs[1])
    plain = multi_tensor.dpsgd_noise_plain(1234, 0, n, dev)
    assert (z - plain).abs().max().item() <= 1e-5
    se = 1 / n ** 0.5
    assert abs(z.mean().item()) < 5 * se
    assert abs(z.std().item() - 1.0) < 5 * se * 2 ** -0.5
    g = torch.Generator(device=dev).manual_seed(3)
    ps = [torch.nn.Parameter(torch.randn(4097, generator=g, device=dev))
          for _ in range(2)]
    twins = [torch.nn.Parameter(q.detach().clone()) for q in ps]
    for q, t in zip(ps, twins):
        q.grad = 1e-4 * torch.randn(4097, generator=g, device=dev)
        t.grad = q.grad.clone()
    O.Dpsgd(0.1, clip=1.0, sigma=0.0, parameters=ps).step()
    O.SGD(0.1, parameters=twins).step()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(ps, twins))


def test_dpsgd_groups_draw_distinct_noise_as_the_loop(dev):
    """Parameters in three (dtype, learning-rate ratio) groups, one kernel
    call each: every tensor draws the noise of its index across the whole
    step, as the per-parameter loop numbers them (float32 within 1e-5,
    bf16 within NORM_BF16_RTOL), and no two tensors draw the same."""
    def run(plain):
        ptt.seed(7)
        ps = [torch.nn.Parameter(torch.zeros(4097, dtype=dt, device=dev))
              for dt in (torch.float32, torch.float32, torch.bfloat16,
                         torch.float32)]
        ps[1].optimize_attr = {"learning_rate": 0.5}
        opt = O.Dpsgd(1.0, clip=1.0, batch_size=1, sigma=1.0, parameters=ps)
        for p in ps:
            p.grad = torch.zeros_like(p)
        opt.step_plain() if plain else opt.step()
        torch.cuda.synchronize()
        return [p.detach().clone() for p in ps]

    before = multi_tensor.multi_tensor_norm_step.launches
    got = run(False)
    assert multi_tensor.multi_tensor_norm_step.launches == before + 6
    want = run(True)
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype == torch.float32:
            assert (a - b).abs().max().item() <= 1e-5, i
        else:
            assert _rel_err(a, b) <= multi_tensor.NORM_BF16_RTOL, i
    noise = [got[0], got[1] / 0.5, got[2].float(), got[3]]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.allclose(noise[i], noise[j], atol=0.1), (i, j)


def _accum_fit(dev, form, k, steps=3):
    from paddle_tpu_torch.hapi.engine import TrainEngine

    net = _tiny_bert(dev)
    model = ptt.Model(net, labels=["mlm", "nsp"]).prepare(
        O.Lamb(learning_rate=0.01, lamb_weight_decay=0.01,
               parameters=net.parameters()), _bert_loss)
    engine = model._engine = TrainEngine(model)
    if form == "eager":
        engine.step = engine._step_eager
    data = _bert_data(n=8 * steps)
    hist = model.fit(ptt.io.TensorDataset(data), batch_size=8,
                     shuffle=False, verbose=0, accumulate_grad_batches=k)
    return hist["step_loss"], _params(net), engine


def test_accumulated_fit_graph_is_bitwise_the_eager_step(dev):
    """Model.fit(accumulate_grad_batches=4) of a small bf16 BERT with Lamb:
    one capture, replays after it, losses and parameters bitwise
    ``_step_eager`` (dropout 0.1: every microbatch draws its own masks)."""
    losses, params, engine = _accum_fit(dev, "graph", 4)
    eager_losses, eager_params, _ = _accum_fit(dev, "eager", 4)
    assert engine.captures == 1 and engine.replays == 2
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses == eager_losses
    assert all(torch.equal(a, b) for a, b in zip(params, eager_params))


def test_accumulated_fit_syncs_only_to_drain(dev):
    """Replayed accumulated steps under torch.cuda.set_sync_debug_mode:
    only the drains sync."""
    import os
    import warnings

    net = _tiny_bert(dev)
    model = ptt.Model(net, labels=["mlm", "nsp"]).prepare(
        O.Lamb(learning_rate=0.01, parameters=net.parameters()), _bert_loss)
    data = _bert_data(n=56)
    model.fit(ptt.io.TensorDataset([d[:8] for d in data]), batch_size=8,
              verbose=0, accum_steps=4)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.fit(ptt.io.TensorDataset([d[8:] for d in data]),
                      batch_size=8, shuffle=False, verbose=0, log_freq=4,
                      accum_steps=4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [os.path.basename(w.filename) for w in caught
             if str(w.message).startswith(SYNC_WARNING)]
    assert model._engine.captures == 1 and model._engine.replays == 6
    assert syncs == ["engine.py"] * 3


def _resume_run(dev, tmp, n_rows=32, kill_at=None, model=None, **kw):
    """A small bf16 BERT at dropout 0.1 through Model.fit's captured step
    (batches of 4, shuffle off), with ``kw`` passed to fit; ``kill_at``:
    SIGTERM to this process after that step.  Returns (model, engine,
    losses)."""
    import os
    import signal

    from paddle_tpu_torch.hapi.callbacks import Callback

    if model is None:
        model, _ = _train_api(_tiny_bert(dev), "graph", loss=_bert_loss,
                              labels=["mlm", "nsp"])
    losses = []

    class Keep(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])
            if len(losses) == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)

    data = [d[:n_rows] for d in _bert_data(n=32)]
    model.fit(ptt.io.TensorDataset(data), batch_size=4, shuffle=False,
              verbose=0, callbacks=[Keep()], **kw)
    return model, model._engine, losses


def test_fit_resume_is_bitwise_through_the_captured_step(dev, tmp_path):
    """8 steps unbroken; the same run with fault_tolerant=True, async saves
    every 2 steps and SIGTERM after step 5 exits 75 with its emergency
    generation; a new Model resumes from it: steps 6-8 (a warm-up, a
    capture, replays) give the unbroken run's losses and parameters bit
    for bit (hidden and attention dropout 0.1: the generation carries the
    CUDA generator and the attention keys)."""
    from paddle_tpu_torch.distributed.resilience import PREEMPTED_EXIT_CODE

    base, _, unbroken = _resume_run(dev, tmp_path)
    want = _params(base.network)
    ckpt = str(tmp_path)
    with pytest.raises(SystemExit) as ei:
        _resume_run(dev, tmp_path, kill_at=5, resume=ckpt,
                    checkpoint_interval=2, fault_tolerant=True)
    assert ei.value.code == PREEMPTED_EXIT_CODE
    model, engine, losses = _resume_run(dev, tmp_path, resume=ckpt,
                                        checkpoint_interval=2)
    assert engine.captures == 1
    assert losses == unbroken[5:] and len(losses) == 3
    assert all(torch.equal(a, b) for a, b in zip(_params(model.network),
                                                 want))


def test_fit_resume_lands_in_graphs_already_captured(dev, tmp_path):
    """A model that already trained 3 steps (its step captured) resumes
    from another run's generation of step 4: the restore writes into the
    tensors its graph holds, so steps 5-8 are replays of that graph (no
    new capture) and give the unbroken run's losses and parameters bit
    for bit."""
    base, _, unbroken = _resume_run(dev, tmp_path)
    want = _params(base.network)
    ckpt = str(tmp_path)
    _resume_run(dev, tmp_path, n_rows=16, resume=ckpt, checkpoint_interval=2)
    model, engine, _ = _resume_run(dev, tmp_path, n_rows=12)
    assert engine.captures == 1 and engine.replays == 2
    ptrs = [p.data_ptr() for p in model.network.parameters()]
    model, engine, losses = _resume_run(dev, tmp_path, model=model,
                                        resume=ckpt, checkpoint_interval=2)
    assert engine.captures == 1 and engine.replays == 6
    assert [p.data_ptr() for p in model.network.parameters()] == ptrs
    assert losses == unbroken[4:]
    assert all(torch.equal(a, b) for a, b in zip(_params(model.network),
                                                 want))


# -- the data pipeline on the card ------------------------------------------
class _CardCount(ptt.io.Dataset):
    """Each sample: how many CUDA devices the reading process sees.  At
    module scope: it pickles to forkserver workers."""

    def __getitem__(self, i):
        return torch.cuda.device_count()

    def __len__(self):
        return 4


class _TouchesCuda(ptt.io.Dataset):
    def __getitem__(self, i):
        return torch.zeros(1, device="cuda")

    def __len__(self):
        return 4


def test_a_worker_sees_no_card(dev):
    """(a) with the parent's CUDA context up, a forkserver worker sees no
    device (CUDA_VISIBLE_DEVICES is "" while workers start and in them)."""
    torch.zeros(1, device=dev)
    loader = ptt.io.DataLoader(_CardCount(), batch_size=2, num_workers=2,
                               timeout=60)
    assert [b.tolist() for b in loader] == [[0, 0], [0, 0]]
    assert torch.cuda.device_count() >= 1


@pytest.mark.parametrize("method", ["forkserver", "fork"])
def test_a_worker_that_reaches_cuda_fails_loudly(dev, monkeypatch, method):
    """(a) a worker's CUDA call raises in the parent, by forkserver (no
    visible device) and by fork of a process that initialised CUDA
    (torch refuses to re-initialise it), never a hang."""
    torch.zeros(1, device=dev)
    monkeypatch.setenv("PADDLE_TPU_MP_START", method)
    loader = ptt.io.DataLoader(_TouchesCuda(), batch_size=2, num_workers=1,
                               timeout=60)
    with pytest.raises(RuntimeError, match="worker 0 failed"):
        list(loader)


class _SlowNet(tnn.Layer):
    """``inner`` after a torch.cuda._sleep on the card (captured with the
    step): the card runs behind the host."""

    def __init__(self, inner, cycles):
        super().__init__()
        self.inner, self.cycles = inner, cycles

    def forward(self, x):
        if self.cycles:
            torch.cuda._sleep(self.cycles)
        return self.inner(x)


def _slow_fit(dev, cycles, workers=0):
    ptt.seed(3)
    net = _SlowNet(tnn.Linear(256, 8).to(dev), cycles)
    model = ptt.Model(net).prepare(
        ptt.optimizer.SGD(0.1, parameters=net.parameters()),
        tnn.CrossEntropyLoss())
    rs = np.random.RandomState(5)
    data = ptt.io.TensorDataset([
        torch.from_numpy(rs.randn(96, 256).astype(np.float32)),
        torch.from_numpy(rs.randint(0, 8, 96))])
    loader = ptt.io.DataLoader(data, batch_size=8, shuffle=True,
                               num_workers=workers, prefetch_factor=2,
                               timeout=60)
    return model.fit(loader, verbose=0, log_freq=0)["step_loss"], loader


@pytest.mark.parametrize("workers", [0, 2])
def test_pinned_batches_survive_a_slow_card(dev, workers):
    """(c) each step sleeps ~10 ms on the card first and nothing drains
    but the epoch's end, so the reader pins batches while copies out of
    earlier pinned batches are still queued: a pinned buffer refilled
    before its copy ran would change the losses.  They are the unslowed
    fit's, bitwise; the hook is restored after."""
    want, loader = _slow_fit(dev, 0)
    got, loader = _slow_fit(dev, 20_000_000, workers)
    assert len(got) == 12 and got == want
    assert loader.placement is None


GEN_CFG = dict(vocab_size=211, hidden_size=128, num_layers=2, num_heads=2,
               max_position_embeddings=64, dropout=0.0, attn_dropout=0.0)
GEN_MODES = {
    "greedy": dict(max_new_tokens=12),
    "sample": dict(max_new_tokens=12, do_sample=True, top_k=8,
                   temperature=0.8, seed=3),
    "beam": dict(max_new_tokens=10, num_beams=4),
    "eos": dict(max_new_tokens=12, eos_token_id=None),
}


def _gen_model(dev, dtype):
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    seed(0)
    return GPTForCausalLM(GPTConfig(**GEN_CFG), device=dev,
                          dtype=dtype).eval()


def _gen_prompt(dev, B=3, S=9):
    g = torch.Generator().manual_seed(B * S)
    return torch.randint(0, 211, (B, S), generator=g,
                         dtype=torch.int32).to(dev)


def _gen_kw(model, ids, mode):
    kw = dict(GEN_MODES[mode])
    if mode == "eos":
        # row 0's third new token: that row finishes early
        kw["eos_token_id"] = int(model.generate(ids, max_new_tokens=12)[
            0, ids.shape[1] + 2])
        model._gen_cache.clear()
    return kw


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", list(GEN_MODES))
def test_generate_graph_is_bitwise_the_eager_step(dev, dtype, mode):
    """generate's decode step, captured once a key and replayed, gives the
    eager step's tokens bitwise (the key's step swapped for
    ``_step_eager``), and a later call of the key the same again."""
    model = _gen_model(dev, dtype)
    ids = _gen_prompt(dev)
    kw = _gen_kw(model, ids, mode)
    graph = model.generate(ids, **kw)
    (run,) = model._gen_cache.values()
    assert run.graph is not None and run.replays == kw["max_new_tokens"] - 1
    run.step = run._step_eager
    try:
        eager = model.generate(ids, **kw)
    finally:
        del run.step
    assert torch.equal(graph, eager)
    assert torch.equal(model.generate(ids, **kw), graph)
    assert graph.shape == (3, 9 + kw["max_new_tokens"])
    assert graph.dtype == torch.int32 and graph.device.type == "cuda"


@pytest.mark.parametrize("mode", list(GEN_MODES))
def test_generate_second_call_makes_no_sync(dev, mode):
    """A later call of a key (the prefill, the first token, the replays,
    the beams' backtrack) makes no host sync: under
    torch.cuda.set_sync_debug_mode("error") any sync raises."""
    model = _gen_model(dev, torch.bfloat16)
    ids = _gen_prompt(dev)
    kw = _gen_kw(model, ids, mode)
    first = model.generate(ids, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = model.generate(ids, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(first, second)


def test_generate_capture_counts_its_kernels_and_replays_the_fast_ones(dev):
    """The wrappers count the kernels launched inside the capture (the
    key's ``graph_launches``: 5 LayerNorm, 2 bias-GeLU a step for 2
    layers), every one on its fast variant; in the trace of a replayed
    call each replay (the kernels carrying its ``cudaGraphLaunch``
    correlation id) holds exactly those fast kernels, LayerNorm's warp
    kernel and the vector bias-GeLU, and the eager prefill the
    tensor-core attention, no launch of a slower kernel anywhere."""
    import collections
    import re
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels

    model = _gen_model(dev, torch.bfloat16)
    ids = _gen_prompt(dev, B=2, S=16)
    before = kernels.launch_counts()
    model.generate(ids, max_new_tokens=6)
    (run,) = model._gen_cache.values()
    assert run.graph_launches == {"layer_norm": 5, "bias_gelu": 2}
    assert run.graph_variants == {"layer_norm": {"block": 0, "warp": 5},
                                  "bias_gelu": {"scalar": 0, "vec": 2}}
    after = kernels.launch_counts()
    # the prefill, the warm-up step and the capture
    assert after["layer_norm"] - before["layer_norm"] == 15
    assert after["flash_attention"] - before["flash_attention"] == 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # idle edges: a trace closed right after its last kernels can lack
        # their records (chip_smoke.trace_window)
        time.sleep(0.05)
        model.generate(ids, max_new_tokens=6)
        torch.cuda.synchronize()
        time.sleep(0.05)
    events = prof.profiler.kineto_results.events()
    replays = {e.correlation_id(): collections.Counter() for e in events
               if e.name() == "cudaGraphLaunch"}
    eager = collections.Counter()
    pattern = re.compile(r"(?<!\w)(layer_norm_warp_kernel|layer_norm_fwd_"
                         r"kernel|bias_gelu_fwd_vec_kernel|bias_gelu_fwd_"
                         r"kernel|flash_fwd_mma_kernel|flash_fwd_kernel)"
                         r"(?:<|\()")
    for e in events:
        m = pattern.search(e.name())
        if e.device_type() == DeviceType.CUDA and m:
            replays.get(e.correlation_id(), eager)[m.group(1)] += 1
    assert len(replays) == 5
    for held in replays.values():
        assert held == {"layer_norm_warp_kernel": 5,
                        "bias_gelu_fwd_vec_kernel": 2}, held
    assert eager["flash_fwd_mma_kernel"] == 2
    assert set(eager) <= {"layer_norm_warp_kernel",
                          "bias_gelu_fwd_vec_kernel",
                          "flash_fwd_mma_kernel"}, eager


def test_generate_rebuilds_a_key_after_the_parameters_moved(dev):
    """A cast replaces the parameters' storage, which a captured step
    would still read: the next call of the key captures anew, in the new
    dtype, and equals a fresh model's."""
    model = _gen_model(dev, torch.float32)
    ids = _gen_prompt(dev)
    model.generate(ids, max_new_tokens=5)
    model.to(dtype=torch.bfloat16)
    out = model.generate(ids, max_new_tokens=5)
    (run,) = model._gen_cache.values()
    assert run.caches[0][0].dtype == torch.bfloat16
    fresh = _gen_model(dev, torch.float32).to(dtype=torch.bfloat16)
    assert torch.equal(out, fresh.generate(ids, max_new_tokens=5))


@pytest.mark.parametrize("dtype", DTYPES)
def test_hf_interop_onto_a_card_model_keeps_device_and_dtype(dev, dtype):
    """load_hf_gpt2 copies a state dict (numpy, from to_hf_gpt2_state of a
    CPU model) into a card model's parameters in place: same tensors, on
    the card, in the model's dtype, equal to the source cast; the loaded
    model generates the CPU model's greedy tokens in float32."""
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.interop import (load_hf_gpt2,
                                                 to_hf_gpt2_state)

    seed(5)
    src = GPTForCausalLM(GPTConfig(**GEN_CFG), device="cpu").eval()
    model = _gen_model(dev, dtype)
    params = {n: p for n, p in model.named_parameters()}
    ptrs = {n: p.data_ptr() for n, p in params.items()}
    load_hf_gpt2(model, to_hf_gpt2_state(src))
    for (n, p), (_, s) in zip(model.named_parameters(),
                              src.named_parameters()):
        assert p is params[n] and p.data_ptr() == ptrs[n]
        assert p.device.type == "cuda" and p.dtype == dtype
        assert torch.equal(p.cpu(), s.detach().to(dtype)), n
    if dtype == torch.float32:
        ids = _gen_prompt(dev)
        got = model.generate(ids, max_new_tokens=4).cpu()
        assert torch.equal(got, src.generate(ids.cpu(), max_new_tokens=4))


# ---------------------------------------------------------------------------
# graph captures and the cyclic garbage collector (ops/capture.py), and the
# speculative step as one CUDA graph
# ---------------------------------------------------------------------------
class _CollectingGraph(torch.cuda.graph):
    """``torch.cuda.graph`` that runs the cyclic garbage collector as soon
    as its capture has begun: where the collector would fire on its own
    if an allocation count crossed its threshold there."""

    def __enter__(self):
        out = super().__enter__()
        import gc

        gc.collect()
        return out


def _greedy_tokens(eng, prompts, n=8):
    return [h.result(120) for h in [eng.submit(p, n) for p in prompts]]


def test_a_capture_survives_dead_graphs_in_reference_cycles(dev,
                                                            monkeypatch):
    """A GenerationEngine and a Model.fit engine, each holding a captured
    graph inside a reference cycle (engine -> handle -> request ->
    engine; model <-> engine), are dropped without collecting; then
    another engine's step is captured while the collector runs inside
    the capture.  The capture must succeed (the helper collects before
    its warm-up, so no dead graph is left to free there) and its replay
    be bitwise its eager step."""
    import gc

    from paddle_tpu_torch.serving import GenerationEngine

    prompts = [np.random.RandomState(i).randint(0, 211, n).tolist()
               for i, n in enumerate((5, 9, 14))]
    collecting = gc.isenabled()
    gc.disable()
    try:
        eng = GenerationEngine(_serving_model(dev), device=dev,
                               **SERVE_ENGINE).start()
        eng._kept = eng.submit(prompts[0], 4)        # engine -> handle
        assert eng._kept.result(120) and eng.capture_count == 1
        eng.stop()
        net = _train_gpt(dev, torch.float32, 0.0)
        model = ptt.Model(net).prepare(ptt.optimizer.AdamW(
            learning_rate=0.01, parameters=net.parameters()), _lm_loss)
        data = torch.from_numpy(np.random.RandomState(3).randint(
            0, 96, (8, 16)))
        model.fit(ptt.io.TensorDataset([data, data]), batch_size=4,
                  shuffle=False, verbose=0, log_freq=0)
        assert model._engine.captures == 1
        del eng, net, model, data                    # cycles, uncollected
        monkeypatch.setattr(torch.cuda, "graph", _CollectingGraph)
        fresh = GenerationEngine(_serving_model(dev), device=dev,
                                 **SERVE_ENGINE).start()
        monkeypatch.undo()
    finally:
        if collecting:
            gc.enable()
    try:
        assert fresh.capture_count == 1
        graph = _greedy_tokens(fresh, prompts)
        assert fresh.replays > 0
        fresh.step = fresh._step_eager
        assert _greedy_tokens(fresh, prompts) == graph
    finally:
        fresh.stop()


def _draft_of(model, dev, dtype, layers=1, seed=None):
    """A ``layers``-deep draft holding the target's embeddings, first
    blocks and final norm (``seed``: independently initialised instead)."""
    from paddle_tpu_torch.framework.random import seed as set_seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    set_seed(0 if seed is None else seed)
    draft = GPTForCausalLM(GPTConfig(**dict(SERVE_CFG, num_layers=layers)),
                           device=dev, dtype=dtype).eval()
    if seed is None:
        sd = model.state_dict()
        draft.set_state_dict({k: sd[k] for k in draft.state_dict()})
    return draft


SPEC_K = 3


@pytest.mark.parametrize("dtype", DTYPES)
def test_spec_graph_is_bitwise_the_eager_spec_step(dev, dtype):
    """The speculative step, captured once at start() as ONE graph (the
    draft's K + 1 paged decode calls and the target's verify), against
    ``_step_spec_eager`` swapped in: tokens bitwise equal through hits,
    chunks, both sampling modes, a mid-decode admission and a cancel; the
    graph holds the draft's paged decode K + 1 times a layer and the
    verify's LayerNorm and bias-GeLU on their fast kernels."""
    from paddle_tpu_torch.serving import GenerationEngine

    model = _serving_model(dev, dtype)
    draft = _draft_of(model, dev, dtype)
    outs = {}
    for form in ("graph", "eager"):
        with GenerationEngine(model, device=dev, draft_model=draft,
                              spec_tokens=SPEC_K, **SERVE_ENGINE) as eng:
            assert eng.capture_count == 1
            if form == "eager":
                eng.step_spec = eng._step_spec_eager
            outs[form] = _mixed_wave(eng)
            _idle(eng)
            snap = eng.metrics.snapshot()
            assert snap["spec_proposed"] > 0
            assert snap["prefix_cache_hits"] >= 2
            assert eng.free_count + eng.resident_pages \
                == eng.geometry.num_pages
            assert (eng.replays > 0) == (form == "graph")
            # the draft: 1 layer x (K + 1) calls; the verify: none
            assert eng.graph_launches["paged_decode_attention"] == SPEC_K + 1
            # draft 3 a call (2 a block + ln_f), verify 5 (2 layers)
            assert eng.graph_launches["layer_norm"] == 3 * (SPEC_K + 1) + 5
            assert eng.graph_launches["bias_gelu"] == (SPEC_K + 1) + 2
            assert "flash_attention" not in eng.graph_launches
            for name, counts in eng.graph_variants.items():
                fast = {"layer_norm": "warp", "bias_gelu": "vec",
                        "paged_decode_attention": "split"}[name]
                assert set(v for v, n in counts.items() if n) == {fast}
    assert outs["graph"] == outs["eager"]


def test_spec_step_syncs_only_to_fetch(dev):
    """Every replayed ``step_spec()`` of a second wave (greedy and
    sampled) under set_sync_debug_mode("warn") makes one synchronizing
    call: its copy of outs, emitted and finished to the host."""
    import warnings

    from paddle_tpu_torch.serving import GenerationEngine

    model = _serving_model(dev, torch.bfloat16)
    draft = _draft_of(model, dev, torch.bfloat16)
    seen = []
    with GenerationEngine(model, device=dev, draft_model=draft,
                          spec_tokens=SPEC_K, **SERVE_ENGINE) as eng:
        _greedy_tokens(eng, [[3, 4, 5], list(range(20))])   # the first wave
        step = eng.step_spec

        def checked():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = step()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            seen.append([w.filename for w in caught
                         if str(w.message).startswith(SYNC_WARNING)])
            return out

        eng.step_spec = checked
        hs = [eng.submit([3, 4, 5], 10),
              eng.submit(list(range(9)), 10, do_sample=True,
                         temperature=0.8, top_k=5, seed=1)]
        for h in hs:
            assert len(h.result(120)) == 10
        assert eng.capture_count == 1
    assert seen
    for files in seen:
        assert len(files) == 1 and files[0].endswith("generation.py"), seen


def test_slot_verify_paged_on_the_card_matches_the_cpu(dev):
    """The target's verify on the card (LayerNorm and bias-GeLU kernels at
    R = slots x C rows) against the same float32 model's plain run on the
    CPU: logits and both pools, one lane at a page boundary, one
    inactive."""
    dtype = torch.float32
    model = _serving_model(dev, dtype)
    cpu = _serving_model("cpu", dtype)
    rs = np.random.RandomState(21)
    L, pages, ps, nh, hd = 2, 24, 8, 4, 16
    kp = torch.from_numpy(rs.randn(L, pages, ps, nh, hd).astype(
        np.float32)).to(dtype)
    vp = torch.from_numpy(rs.randn(L, pages, ps, nh, hd).astype(
        np.float32)).to(dtype)
    rows = torch.full((3, 12), -1, dtype=torch.int32)
    perm = torch.from_numpy(rs.permutation(pages).astype(np.int32))
    rows[0, :3], rows[1, :5] = perm[:3], perm[3:8]
    C = SPEC_K + 1
    positions = torch.tensor([[9 + i for i in range(C)],
                              [30 + i for i in range(C)], [0] * C],
                             dtype=torch.int32)
    tokens = torch.from_numpy(rs.randint(0, 211, (3, C)).astype(np.int32))
    active = torch.tensor([True, True, False])
    res = {}
    for m, where in ((model, dev), (cpu, "cpu")):
        k, v = kp.clone().to(where), vp.clone().to(where)
        lg, _, _ = m.slot_verify_paged(
            tokens.to(where), positions.to(where), active.to(where), k, v,
            rows.to(where), 96)
        res[str(where)] = (lg.float().cpu(), k.float().cpu(), v.float().cpu())
    for got, ref in zip(res[str(dev)], res["cpu"]):
        _check(got, ref, dtype)


SERVE_BERT = dict(vocab_size=400, hidden_size=64, num_layers=2, num_heads=4,
                  intermediate_size=128, max_position_embeddings=64,
                  dropout=0.0)


def _serving_bert(dev, dtype=torch.float32):
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import BertConfig, BertModel

    seed(0)
    return BertModel(BertConfig(**SERVE_BERT), device=dev,
                     dtype=dtype).eval()


def _ids(rs, b, s):
    return rs.randint(0, SERVE_BERT["vocab_size"], (b, s)).astype(np.int64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bucket_graph_replay_is_bitwise_its_eager_forward(dev, dtype):
    """Each input signature of the Predictor is one CUDA graph: its replay
    gives the eager forward's outputs bitwise on the same padded batch, a
    second signature gets a graph of its own and a known one is never
    captured again; the capture counts the bucket's kernel launches (2
    layers: LayerNorm 5, bias-GeLU 2, flash forward 2)."""
    from paddle_tpu_torch import inference

    model = _serving_bert(dev, dtype)
    pred = inference.Predictor.from_layer(model)
    rs = np.random.RandomState(0)
    for b, s in ((1, 16), (4, 32), (1, 16)):
        ids = _ids(rs, b, s)
        got = pred.run([ids])
        with torch.no_grad():
            want = model(torch.from_numpy(ids).to(dev))
        for g, w in zip(got, want):
            w = w.float().cpu().numpy()
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    assert pred.compile_count == 2
    launches = pred.graph_launches[(((4, 32), "int64"),)]
    assert launches == {"layer_norm": 5, "bias_gelu": 2,
                        "flash_attention": 2}, launches


def test_served_rows_are_bitwise_the_direct_run_at_their_bucket(dev):
    """The adaptive batcher over the card's Predictor: every row handed
    to a future is bitwise the same row of a direct ``Predictor.run`` of
    the padded batch it was served in, and no bucket is captured after
    start()."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import ServingEngine

    class Recording:
        def __init__(self, pred):
            self.pred, self.batches = pred, []
            self.compile_count = 0

        def run(self, arrays):
            outs = self.pred.run(arrays)
            self.compile_count = self.pred.compile_count
            self.batches.append(([a.copy() for a in arrays], outs))
            return outs

    rec = Recording(inference.Predictor.from_layer(_serving_bert(dev)))
    eng = ServingEngine(rec, batch_timeout_ms=20, buckets="1,2,4x16,32",
                        input_specs=[((-1, -1), "int64")]).start()
    warmed = rec.compile_count
    assert warmed == 6
    rs = np.random.RandomState(1)
    reqs = [rs.randint(0, 400, rs.randint(5, 33)) for _ in range(11)]
    try:
        outs = [f.result(120) for f in [eng.submit([r]) for r in reqs]]
    finally:
        eng.stop()
    assert rec.compile_count == warmed
    matched = 0
    for arrays, batch in rec.batches[warmed:]:
        direct = rec.pred.run(arrays)
        for i, row in enumerate(arrays[0]):
            for r, o in zip(reqs, outs):
                if np.array_equal(row[:len(r)], r) \
                        and not row[len(r):].any():
                    np.testing.assert_array_equal(o[0],
                                                  direct[0][i, :len(r)])
                    np.testing.assert_array_equal(o[1], direct[1][i])
                    matched += 1
    assert matched == len(reqs)


def test_a_capture_survives_while_the_other_engine_replays(dev):
    """A ServingEngine captures its bucket graphs on this thread while a
    GenerationEngine's decode thread replays its step: both captures
    stand (the serving rows bitwise the eager forward, the generation
    tokens those of a run with no capture beside it)."""
    from paddle_tpu_torch.serving import GenerationEngine, ServingEngine

    gpt = _serving_model(dev)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 211, rs.randint(4, 40)).tolist()
               for _ in range(12)]
    with GenerationEngine(gpt, device=dev, **SERVE_ENGINE) as eng:
        alone = _greedy_tokens(eng, prompts, 24)
        handles = [eng.submit(p, 24) for p in prompts]
        assert handles[0].next_token(timeout=120) is not None
        bert = _serving_bert(dev)
        served = ServingEngine(bert, batch_timeout_ms=2,
                               buckets="1,2,4x16,32",
                               input_specs=[((-1, -1), "int64")]).start()
        beside = [h.result(120) for h in handles]
        assert eng.capture_count == 1
        try:
            ids = _ids(rs, 1, 32)[0]
            row = served.predict([ids], timeout=120)
        finally:
            served.stop()
    assert beside == alone
    with torch.no_grad():
        want = bert(torch.from_numpy(ids[None]).to(dev))
    np.testing.assert_array_equal(row[0], want[0][0].cpu().numpy())
    np.testing.assert_array_equal(row[1], want[1][0].cpu().numpy())


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_resumed_sampled_stream_is_bitwise_on_the_card(dev, spec):
    """submit(prompt + emitted[:n], resume_pos=n, seed=s) continues the
    uninterrupted sampled stream bitwise through the captured step (float32),
    at n = 1 and 16; a greedy one too."""
    from paddle_tpu_torch.serving import GenerationEngine

    model = _serving_model(dev)
    kw = dict(draft_model=_draft_of(model, dev, torch.float32),
              spec_tokens=SPEC_K) if spec else {}
    sample = dict(do_sample=True, temperature=0.8, top_k=5, seed=11)
    prompt = list(range(3, 12))
    with GenerationEngine(model, device=dev, **SERVE_ENGINE, **kw) as eng:
        for s in (sample, {}):
            full = eng.generate(prompt, 32, timeout=120, **s)
            for n in (1, 16):
                assert eng.generate(prompt + full[:n], 32 - n, timeout=120,
                                    resume_pos=n, **s) == full[n:]
        assert eng.capture_count == 1 and eng.replays > 0


def test_a_failing_bucket_capture_raises(dev):
    """A forward that syncs the host cannot be captured: the Predictor and
    the serving engine's warm-up raise, no eager fallback."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import ServingEngine

    class Syncs(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4, device=dev))

        def forward(self, x):
            if float(x.sum()) > 0:           # a host sync
                return x * self.w
            return x

    pred = inference.Predictor.from_layer(Syncs())
    with pytest.raises(Exception):
        pred.run([np.ones((2, 4), np.float32)])
    assert pred.compile_count == 0
    eng = ServingEngine(inference.Predictor.from_layer(Syncs()),
                        buckets="1,2", input_specs=[((-1, 4), "float32")])
    with pytest.raises(Exception):
        eng.start()


# ---------------------------------------------------------------------------
# the serving fleet: replica processes on the card
# ---------------------------------------------------------------------------
FLEET_REPLICA = ["--port", "0", "--slots", "2", "--page-size", "4",
                 "--prompt-buckets", "8,16,32", "--max-seq-len", "64",
                 "--seed", "0"]
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fleet_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_fleet_drill_with_replicas_on_the_card(dev, tmp_path):
    """The CPU drill of tests/test_torch_fleet.py with both replicas on
    the card (their decode steps captured): a stream cut by a SIGKILL after
    its 3rd token resumes on the survivor bitwise the undisturbed run, 0
    failed requests, the victim respawned (capturing again) and
    re-admitted, down_s > 0 in the replica_lost dump."""
    import json as _json
    import signal

    from paddle_tpu_torch.monitor import flightrec
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.serving.client import ServingClient
    from paddle_tpu_torch.serving.fleet import ReplicaSupervisor
    from paddle_tpu_torch.serving.router import FleetRouter
    from paddle_tpu_torch.utils.metrics import MetricsRegistry

    build.build_all()           # the replicas find the kernels built
    prompt = list(range(3, 11))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.generation",
           *FLEET_REPLICA]
    sup = ReplicaSupervisor(
        cmd, 2, env=_fleet_env(), heartbeat_timeout_s=5.0,
        respawn_backoff_s=0.2, telemetry_dir=str(tmp_path / "telemetry"),
        log_dir=str(tmp_path / "logs"), registry=MetricsRegistry()).start()
    router = None
    try:
        assert sup.wait_ready(240), "fleet bring-up timed out"
        router = FleetRouter([], coord=sup.coord.address, port=0,
                             page_size=4, probe_interval_s=0.3, dead_after=3,
                             membership_poll_s=0.05,
                             install_signal_handlers=False).start()
        c = ServingClient(router.url, timeout=120.0)
        oracle = c.generate(prompt, 12)["tokens"]
        toks, err = [], None
        for evt in c.generate_stream(prompt, 12):
            if "token" in evt:
                toks.append(evt["token"])
                if len(toks) == 3:
                    victim = max(router.replicas, key=lambda r: r.inflight)
                    os.kill(sup.procs[int(victim.name[1:])].pid,
                            signal.SIGKILL)
            if evt.get("done"):
                err = evt.get("error")
        assert err is None and toks == oracle
        snap = router.metrics.snapshot()
        assert snap["failovers"]["mid_stream"] >= 1
        assert snap["requests_failed"] == 0
        deadline = time.monotonic() + 240
        while not (sup.respawn_count >= 1 and sup.wait_ready(0.1)
                   and victim.alive):
            assert time.monotonic() < deadline
            time.sleep(0.2)
        assert c.generate(prompt, 12)["tokens"] == oracle
        (dump,) = os.listdir(tmp_path / "telemetry")
        doc = _json.loads((tmp_path / "telemetry" / dump).read_text())
        assert doc["reason"] == "replica_lost"
        assert doc["accounting"]["down_s"] > 0
    finally:
        if router is not None:
            router.shutdown()
        assert sup.shutdown()
        flightrec.reset()


def test_engine_chaos_seam_adds_no_sync_to_the_captured_step(dev):
    """With a replica dial armed for another rank, every replayed step
    still makes exactly one synchronizing call (its token fetch), and the
    tokens are those of a run with no dial."""
    import warnings

    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.utils import chaos

    cfg = GPTConfig(vocab_size=211, hidden_size=64, num_layers=2,
                    num_heads=4, max_position_embeddings=64, dropout=0.0,
                    attn_dropout=0.0)
    seed(0)
    model = GPTForCausalLM(cfg, device=dev).eval()
    prompt = [3, 4, 5, 6, 7]
    with GenerationEngine(model, max_slots=2, max_seq_len=40,
                          prompt_buckets="8,16", device=dev) as eng:
        plain = eng.generate(prompt, 10, timeout=120)
        step, seen = eng.step, []

        def checked_step():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = step()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            seen.append(sum(str(w.message).startswith(SYNC_WARNING)
                            for w in caught))
            return out

        eng.step = checked_step
        with chaos.inject(replica_kill=(99, 1), replica_slow=(99, 1, 5.0),
                          replica_partition=(99, 1)) as cfg_:
            armed = eng.generate(prompt, 10, timeout=120)
        assert not cfg_.fired and eng.capture_count == 1
    assert armed == plain
    assert seen and all(n == 1 for n in seen), seen
    assert eng._iter == eng.replays


_CAPTURE_FAILS = """
import sys
import paddle_tpu_torch.serving.generation as g
step = g.GenerationEngine._graph_step
def syncing(self):
    step(self)
    float(self._out.sum())      # a host sync: the step cannot be captured
g.GenerationEngine._graph_step = syncing
sys.exit(g.main(sys.argv[1:]))
"""


def test_a_replica_whose_capture_fails_exits_nonzero(dev):
    """No eager fallback: a replica whose decode step cannot be captured
    raises at start-up, never prints its readiness line, exits non-zero."""
    from paddle_tpu_torch.ops.kernels import build

    build.build_all()
    r = subprocess.run([sys.executable, "-c", _CAPTURE_FAILS,
                        *FLEET_REPLICA], env=_fleet_env(), cwd=_ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "listening" not in r.stdout
    assert "Traceback" in r.stderr
