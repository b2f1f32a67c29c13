"""The port's CUDA kernels on the card, at shapes the serving and training
paths do not reach: odd row counts and widths, S = 1, head dims 16-128,
page sizes 1 and 5, unmapped and out-of-pool page ids, an inactive lane,
odd vocab sizes, strided logits, every mask form of attention, causal or
not.  Each kernel, forward and backward, and each of the two kernels an
entry chooses between (by dtype and 16-byte alignment), is held against
its plain PyTorch version on the same inputs; paged decode's split kernel
is bitwise reproducible and independent of its batch mates; a decode step
of the engine syncs once, to fetch its tokens; a tiny GPT's and a tiny
BERT's loss and gradients on the card are held against the CPU's.  Needs
a CUDA device (skips elsewhere); on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance, relative to max(1, max|ref|): float32 2e-5 (summation order),
bfloat16 2**-6 (two ulps at the top binade: both sides accumulate in
float32 and round once at the end; the tensor-core attention kernels also
round p and ds to bf16 before the second product, as the reference does,
which stays well inside it).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.ops.kernels import (bias_gelu, flash_attention,
                                          layer_norm, paged_attention)

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
    synchronizing call, its copy of the tokens to the host."""
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
