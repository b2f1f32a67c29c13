"""Boundaries of the PyTorch/CUDA port.

* No module of ``paddle_tpu_torch`` (nor ``chip_smoke.py``) imports JAX,
  anything of the JAX package, ``ml_dtypes`` or ``transformers`` (the
  card's machine need not have them).  The scan is static
  (AST): the test process has jax loaded already, so ``sys.modules``
  would tell nothing.
* Entry points given ``device=None`` mean the CUDA card and raise
  ``RuntimeError`` on a host without one — never a silent CPU fallback.
* Each kernel wrapper takes the plain version for a CPU tensor (no launch
  counted) and refuses any other non-CUDA tensor.
"""
import ast
import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.framework.place import default_device, resolve_device
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     BertModel, ErnieModel, GPTConfig,
                                     GPTForCausalLM)
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.serving import GenerationEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu", "ml_dtypes", "transformers"}
TINY = GPTConfig(vocab_size=17, hidden_size=8, num_layers=1, num_heads=2,
                 max_position_embeddings=16, dropout=0.0, attn_dropout=0.0)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"generation.py", "gpt.py", "fused.py", "build.py",
            "paged_attention.py", "chip_smoke.py", "flash_attention.py",
            "lr.py", "clip.py", "model.py", "engine.py", "bert.py",
            "softmax_xent.py", "transformer.py", "container.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"paddle_tpu_torch/optimizer/__init__.py",
            "paddle_tpu_torch/io/__init__.py",
            "paddle_tpu_torch/hapi/engine.py",
            "paddle_tpu_torch/models/bert.py",
            "paddle_tpu_torch/ops/kernels/softmax_xent.py",
            "paddle_tpu_torch/nn/layer/transformer.py",
            "paddle_tpu_torch/nn/layer/container.py",
            "paddle_tpu_torch/nn/functional/__init__.py",
            "paddle_tpu_torch/serving/prefix_cache.py",
            "paddle_tpu_torch/serving/engine.py",
            "paddle_tpu_torch/serving/server.py",
            "paddle_tpu_torch/serving/client.py",
            "paddle_tpu_torch/inference/__init__.py",
            "paddle_tpu_torch/monitor/tracing.py",
            "paddle_tpu_torch/monitor/server.py",
            "paddle_tpu_torch/regularizer.py",
            "paddle_tpu_torch/optimizer/wrappers.py",
            "paddle_tpu_torch/distributed/checkpoint.py",
            "paddle_tpu_torch/distributed/resilience.py",
            "paddle_tpu_torch/utils/chaos.py",
            "paddle_tpu_torch/utils/metrics.py",
            "paddle_tpu_torch/utils/flops.py",
            "paddle_tpu_torch/hapi/model_summary.py",
            "paddle_tpu_torch/models/interop.py",
            "paddle_tpu_torch/text/__init__.py",
            "paddle_tpu_torch/nn/decode.py"} <= rel


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")


def test_default_device_raises_without_cuda():
    _no_cuda()
    with pytest.raises(RuntimeError):
        default_device()
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_model_and_engine_default_to_cuda():
    _no_cuda()
    with pytest.raises(RuntimeError):
        GPTForCausalLM(TINY)
    model = GPTForCausalLM(TINY, device="cpu")
    with pytest.raises(RuntimeError):
        GenerationEngine(model, max_seq_len=16, prompt_buckets="8")
    eng = GenerationEngine(model, max_seq_len=16, prompt_buckets="8",
                           device="cpu")
    assert eng.device == torch.device("cpu")


@pytest.mark.parametrize("cls", [BertModel, BertForPretraining, ErnieModel])
def test_bert_models_default_to_cuda(cls):
    _no_cuda()
    cfg = BertConfig(vocab_size=17, hidden_size=8, num_layers=1,
                     num_heads=2, intermediate_size=16, dropout=0.0)
    with pytest.raises(RuntimeError):
        cls(cfg)
    model = cls(cfg, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())


def _kernel_args(device):
    x = torch.randn(3, 8, device=device)
    w = torch.ones(8, device=device)
    qkv = torch.randn(1, 5, 3, 2, 16, device=device)
    pool = torch.randn(4, 4, 2, 16, device=device)
    rows = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32, device=device)
    pos = torch.tensor([5, 2], dtype=torch.int32, device=device)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    stats = torch.zeros(2, 5, device=device)       # lse / delta [B*H, S]
    labels = torch.tensor([1, -100, 7], device=device)
    row = torch.zeros(3, device=device)             # lse / g [N]
    return {
        "layer_norm": (x, w, w),
        "bias_gelu": (x, w),
        "flash_attention": (q, k, v),
        "paged_decode_attention": (qkv[0, :2, 0], pool, pool, rows, pos, 8),
        "bias_gelu_bwd": (x, w, x),
        "flash_attention_dq": (q, k, v, q, stats, stats),
        "flash_attention_dkv": (q, k, v, q, stats, stats),
        "softmax_xent": (x, labels),
        "softmax_xent_bwd": (x, labels, row, row),
        "multi_tensor_step": ("adamw", [x], [x.clone()],
                              [[torch.zeros(3, 8, device=device),
                                torch.ones(3, 8, device=device)]], 1e-3, 2,
                              {"beta1": 0.9, "beta2": 0.999,
                               "epsilon": 1e-8, "weight_decay": 0.01}),
        "multi_tensor_norm_step": ("lamb", [x], [x.clone()],
                                   [[torch.zeros(3, 8, device=device),
                                     torch.ones(3, 8, device=device)]],
                                   1e-3, 2, {"beta1": 0.9, "beta2": 0.999,
                                             "epsilon": 1e-6,
                                             "weight_decay": 0.01}),
        "check_finite_and_unscale": (
            [x.clone()], torch.full((1,), 0.5, device=device),
            torch.zeros(1, dtype=torch.int32, device=device)),
    }


@pytest.mark.parametrize("name", sorted(kernels.WRAPPERS))
def test_wrapper_takes_plain_version_for_cpu_tensors(name):
    fn = kernels.WRAPPERS[name]
    before = fn.launches
    out = fn(*_kernel_args("cpu")[name])
    assert fn.launches == before       # no kernel launched
    out = out[0] if isinstance(out, tuple) else out
    assert out.device.type == "cpu" and torch.isfinite(out).all()


@pytest.mark.parametrize("name", sorted(kernels.WRAPPERS))
def test_wrapper_refuses_non_cuda_devices(name):
    with pytest.raises(RuntimeError):
        kernels.WRAPPERS[name](*_kernel_args("meta")[name])


def _chip_smoke():
    """chip_smoke.py as a module (it imports torch only inside main)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_prints_the_peak_it_divides_by():
    """The MFU line names its divisor: 989e12 printed as 9.89e+14 (it was
    printed as 1e+15), and the ratio is flops / step / that peak."""
    smoke = _chip_smoke()
    text = smoke.mfu_text(2.0e12, 0.04)
    assert "9.89e+14" in text and "1e+15" not in text
    assert text.startswith(f"MFU {2.0e12 / 0.04 / 989e12:.4f} ")


def test_library_path_changes_when_any_header_changes(tmp_path):
    """A kernel library's file name hashes its source and every header
    beside it: an edit to a header alone, or a new header, must build a new
    library instead of loading the stale one."""
    from paddle_tpu_torch.ops.kernels import build

    (tmp_path / "a.cu").write_text('#include "one.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "one.cuh").write_text("// one\n")
    (tmp_path / "two.cuh").write_text("// two\n")
    first = {n: build.library_path(n, tmp_path) for n in "ab"}
    assert first["a"] != first["b"]
    assert first == {n: build.library_path(n, tmp_path) for n in "ab"}
    (tmp_path / "two.cuh").write_text("// two, edited\n")
    second = {n: build.library_path(n, tmp_path) for n in "ab"}
    assert second["a"] != first["a"] and second["b"] != first["b"]
    (tmp_path / "three.cuh").write_text("// three\n")
    assert build.library_path("a", tmp_path) != second["a"]
    (tmp_path / "a.cu").write_text("int a2;\n")
    third = build.library_path("a", tmp_path)
    assert third not in (first["a"], second["a"])
    assert third.parent == build.BUILD_DIR and third.suffix == ".so"


def test_every_csrc_header_is_hashed():
    """The real sources: the attention kernels include mma.cuh, so it must
    be among the hashed headers."""
    from paddle_tpu_torch.ops.kernels import build

    headers = {p.name for p in build.CSRC.glob("*.cuh")}
    assert {"common.cuh", "mma.cuh"} <= headers
    for name in build.SOURCES:
        for inc in re.findall(r'#include "(\w+\.cuh)"',
                              (build.CSRC / f"{name}.cu").read_text()):
            assert inc in headers, (name, inc)


def _variant_symbols():
    """{counting symbol: library} of every C entry in csrc/*.cu that
    counts which of its two kernels a launch took."""
    from paddle_tpu_torch.ops.kernels import build

    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for sym in re.findall(r'extern "C" long long '
                              r'(ptt_\w+_variant_launches)\(',
                              src.read_text()):
            found[sym] = src.stem
    return found


def test_every_variant_counter_is_read_and_held(monkeypatch):
    """Each ``ptt_*_variant_launches`` counter of csrc/*.cu is read by
    ``kernels.variant_launches()`` (through the attention, LayerNorm,
    paged decode and bias-GeLU modules' ``VARIANT_COUNTERS``) from its own
    library, and every kernel so counted is held by chip_smoke.py with the
    same variant names (``VARIANTS``: the slower kernel first, the one
    its 16-bit paths must take second; ``MMA_KERNELS`` take ``mma``; the
    three attention kernels alone have a third, ``tf32x3``, which their
    float32 paths must take), each named in ``TRACE_KERNELS``, so a new
    variant that no phase holds fails here.  Static: the libraries are not built;
    the reader is given zero counts."""
    from paddle_tpu_torch.ops.kernels import build

    read = {}

    def fake_counts(counters):
        for name, (_, _, variants) in counters.items():
            assert len(variants) == (3 if name.startswith("flash_attention")
                                     else 2)
        read.update({sym: (name, lib, variants)
                     for name, (lib, sym, variants) in counters.items()})
        return {name: dict.fromkeys(variants, 0)
                for name, (_, _, variants) in counters.items()}

    monkeypatch.setattr(build, "variant_counts", fake_counts)
    counts = kernels.variant_launches()
    symbols = _variant_symbols()
    assert len(symbols) >= 6
    assert set(read) == set(symbols)
    for sym, (name, lib, variants) in read.items():
        assert lib == symbols[sym], sym
        assert name in kernels.WRAPPERS, name
        assert set(counts[name]) == set(variants)
    smoke = _chip_smoke()
    names = {name for name, _, _ in read.values()}
    assert names == set(smoke.MMA_KERNELS) | set(smoke.VECTOR_KERNELS)
    assert set(smoke.FAST_VARIANT) == set(smoke.VARIANTS) == names
    assert set(smoke.SERVING_FAST) | set(smoke.TRAINING_FAST) == names
    for name, _, variants in read.values():
        assert smoke.VARIANTS[name] == tuple(variants), name
        assert smoke.FAST_VARIANT[name] == variants[1]
        assert set(smoke.TRACE_KERNELS[name]) == set(variants), name
        if name in smoke.MMA_KERNELS:
            assert variants[1] == "mma"
            assert smoke.variant_of(torch.bfloat16) == "mma"
            assert smoke.variant_of(torch.float32) == "tf32x3"
    for name in smoke.MMA_KERNELS:
        assert smoke.VARIANTS[name][2] == "tf32x3"


def test_chip_smoke_fails_a_path_that_took_a_slow_kernel():
    """``require_fast_variants`` passes a path whose every launch took the
    fast kernel and fails one where a bf16 dq launch took the CUDA-core
    kernel, LayerNorm took its block-per-row kernel, paged decode its
    block per (head, lane), the bias-GeLU backward its scalar loop, or a
    required kernel never launched."""
    smoke = _chip_smoke()
    zero = {name: dict.fromkeys(variants, 0)
            for name, variants in smoke.VARIANTS.items()}

    class K:
        after = None

        @classmethod
        def variant_launches(cls):
            return cls.after

    def run(changes, kernels=smoke.FAST_VARIANT):
        K.after = {n: dict(c) for n, c in zero.items()}
        for name, variant in changes:
            K.after[name][variant] += 1
        return smoke.require_fast_variants(K, zero, "path", kernels)

    every = [(n, fast) for n, fast in smoke.FAST_VARIANT.items()]
    assert run(every) == dict.fromkeys(smoke.FAST_VARIANT, 1)
    for bad in ([("flash_attention_dq", "simt")], [("layer_norm", "block")],
                [("paged_decode_attention", "lane")],
                [("bias_gelu_bwd", "scalar")], []):
        with pytest.raises(SystemExit):
            run(every + bad if bad else every[1:])
