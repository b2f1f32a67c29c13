"""The port's durable checkpoints and ``Model.fit`` resume against the JAX
package's, on the CPU.

- the generation layout and manifest (format, keypaths, dtype names,
  crc32 of each leaf, the framework's version, no tmp dir left);
- the corruption cascade, each case run on both packages' managers with
  the same corruption: torn write (chaos), bit flip (chaos and file
  surgery), missing manifest, missing leaf, truncated leaf, missing
  COMMIT, two bad generations, all bad (a clean fresh start), an explicit
  restore raising, the quarantine keeping the bytes — the same restored
  step, the same quarantined names and the same values;
- the errno split (ENOSPC never retried, a transient error retried once)
  and the async writer (never blocks on slow IO, newest wins, degrades
  then escalates; ``fit`` exits 91 after K failed generations, async and
  sync);
- cross-load: a generation written by either package's manager verifies
  (``verify_generation(deep=True)``) and restores in the other, float32,
  bfloat16 and int leaves equal bit for bit; ``fit`` generations too;
- resume parity: a small BERT and a small GPT (dropout 0, float32,
  weights carried over by name): the reference's ``fit(resume=)`` writes
  a generation, the port's ``fit(resume=)`` continues from it, its losses
  within rtol 1e-5 of the reference's continuation;
- the port's resume bitwise its own unbroken run (GPT at dropout 0.1, the
  random streams carried in the manifest), async and sync saves writing
  the same bytes, a resume into a model that already trained landing in
  its tensors in place;
- SIGTERM: ``fault_tolerant=True`` writes the emergency generation and
  exits 75, in process and in a subprocess.
"""
import errno
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBertForPretraining
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.utils import chaos as jchaos
from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed.resilience import (DURABILITY_EXIT_CODE,
                                                     PREEMPTED_EXIT_CODE,
                                                     is_transient_io_error,
                                                     retry_with_backoff)
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                     GPTConfig, GPTForCausalLM,
                                     load_numpy_state)
from paddle_tpu_torch.utils import chaos as tchaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_TOL = dict(rtol=1e-5, atol=1e-7)
LR, WD = 1e-3, 0.01

PKGS = {"port": (tckpt, tchaos), "reference": (jckpt, jchaos)}


# -- manager-level state -----------------------------------------------------
def _state(pkg, val):
    """A small state tree: float32 and int32 leaves, nested."""
    w = np.full((4, 4), float(val), np.float32)
    m = np.full((4, 4), float(val) * 0.5, np.float32)
    if pkg == "port":
        return {"w": torch.from_numpy(w), "opt": {"m": torch.from_numpy(m)},
                "step": torch.tensor(int(val), dtype=torch.int32)}
    return {"w": jnp.asarray(w), "opt": {"m": jnp.asarray(m)},
            "step": jnp.int32(int(val))}


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _gen(mgr, step):
    return os.path.join(mgr.directory, str(step))


def _save_gens(pkg, mgr, vals):
    for v in vals:
        assert mgr.save(int(v), _state(pkg, v), force=True)


def test_generation_layout_and_manifest(tmp_path):
    with tckpt.CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(3, _state("port", 3), force=True,
                 meta={"mesh": {"dp": 1, "devices": 1}})
        gen = _gen(mgr, 3)
        assert os.path.exists(os.path.join(gen, tckpt.COMMIT_NAME))
        man = json.load(open(os.path.join(gen, tckpt.MANIFEST_NAME)))
        assert man["format"] == "paddle_tpu.ckpt.v1" == jckpt.FORMAT_VERSION
        assert man["framework_version"] == ptt.__version__
        assert man["step"] == 3 and man["meta"]["mesh"]["dp"] == 1
        by_key = {e["key"]: e for e in man["leaves"]}
        assert list(by_key) == ["/opt/m", "/step", "/w"]   # sorted keys
        assert [e["file"] for e in man["leaves"]] == \
            ["leaves/0.bin", "leaves/1.bin", "leaves/2.bin"]
        e = by_key["/w"]
        assert e["dtype"] == "float32" and e["shape"] == [4, 4]
        raw = open(os.path.join(gen, e["file"]), "rb").read()
        assert raw == np.full((4, 4), 3.0, np.float32).tobytes()
        assert (zlib.crc32(raw) & 0xFFFFFFFF) == e["crc32"]
        assert by_key["/step"]["dtype"] == "int32"
        assert by_key["/step"]["shape"] == []
        assert not [n for n in os.listdir(mgr.directory)
                    if n.startswith(".tmp-")]
        assert mgr.manifest(99) is None


def test_save_and_restore_hold_no_reference_to_the_state(tmp_path):
    """A written snapshot and a restored tree are freed as soon as the
    caller drops them, without the cyclic collector: a whole model's host
    copy must not outlive its use (and freed page-locked blocks are what
    the next snapshot reuses)."""
    import gc
    import weakref

    with tckpt.CheckpointManager(str(tmp_path)) as mgr:
        gc.disable()
        try:
            state = _state("port", 1)
            refs = [weakref.ref(t) for t in (state["w"], state["opt"]["m"])]
            # the writer's path: the snapshot's own tensors are the leaves
            mgr.save(1, state, force=True, assume_host=True)
            del state
            assert all(r() is None for r in refs)
            _, back = mgr.restore_latest(template=_state("port", 0))
            refs = [weakref.ref(back["w"]), weakref.ref(back["opt"]["m"])]
            del back
            assert all(r() is None for r in refs)
        finally:
            gc.enable()


def test_unserialisable_meta_and_colliding_keys_are_refused(tmp_path):
    with tckpt.CheckpointManager(str(tmp_path)) as mgr:
        with pytest.raises(ValueError, match="JSON"):
            mgr.save(1, _state("port", 1), force=True,
                     meta={"bad": torch.ones(1)})
        with pytest.raises(ValueError, match="colliding"):
            mgr.save(1, {"a": {"b": torch.ones(1)}, "a/b": torch.ones(1)},
                     force=True)
        assert mgr.latest_step() is None


# -- the corruption cascade, both packages ------------------------------------
def _flip(path, at=None, mask=0x10):
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2 if at is None else at] ^= mask
    open(path, "wb").write(bytes(blob))


def _torn(pkg, mgr, ckpt, chaos):
    _save_gens(pkg, mgr, [1])
    with chaos.inject(ckpt_torn=1) as cfg:
        with pytest.raises(chaos.ChaosTorn):
            mgr.save(2, _state(pkg, 2), force=True)
    assert cfg.fired == ["torn@checkpoint.commit"]
    assert mgr.latest_step() == 1


def _bitflip_chaos(pkg, mgr, ckpt, chaos):
    _save_gens(pkg, mgr, [1])
    with chaos.inject(ckpt_bitflip=1) as cfg:
        mgr.save(2, _state(pkg, 2), force=True)
    assert cfg.fired[0].startswith("bitflip@")
    assert mgr.latest_step() == 2


def _bitflip_surgery(pkg, mgr, ckpt, chaos):
    _save_gens(pkg, mgr, [1, 2])
    _flip(os.path.join(_gen(mgr, 2), "leaves", "0.bin"))


def _missing_manifest(pkg, mgr, ckpt, chaos):
    _save_gens(pkg, mgr, [1, 2])
    os.remove(os.path.join(_gen(mgr, 2), ckpt.MANIFEST_NAME))


def _missing_leaf(pkg, mgr, ckpt, chaos):
    _save_gens(pkg, mgr, [1, 2])
    os.remove(os.path.join(_gen(mgr, 2), "leaves", "1.bin"))


def _truncated_leaf(pkg, mgr, ckpt, chaos):
    _save_gens(pkg, mgr, [1, 2])
    leaf = os.path.join(_gen(mgr, 2), "leaves", "0.bin")
    blob = open(leaf, "rb").read()
    open(leaf, "wb").write(blob[:len(blob) // 2])


def _missing_commit(pkg, mgr, ckpt, chaos):
    _save_gens(pkg, mgr, [1, 2])
    os.remove(os.path.join(_gen(mgr, 2), ckpt.COMMIT_NAME))


def _two_bad(pkg, mgr, ckpt, chaos):
    _save_gens(pkg, mgr, [1, 2, 3])
    os.remove(os.path.join(_gen(mgr, 3), ckpt.COMMIT_NAME))
    _flip(os.path.join(_gen(mgr, 2), "leaves", "0.bin"), at=0, mask=0xFF)


def _all_bad(pkg, mgr, ckpt, chaos):
    _save_gens(pkg, mgr, [1, 2])
    for s in (1, 2):
        os.remove(os.path.join(_gen(mgr, s), ckpt.COMMIT_NAME))


CASES = {"torn-write": _torn, "bitflip-chaos": _bitflip_chaos,
         "bitflip-surgery": _bitflip_surgery,
         "missing-manifest": _missing_manifest,
         "missing-leaf": _missing_leaf, "truncated-leaf": _truncated_leaf,
         "missing-commit": _missing_commit, "two-bad": _two_bad,
         "all-bad": _all_bad}


def _run_case(pkg, case, directory):
    ckpt, chaos = PKGS[pkg]
    with ckpt.CheckpointManager(directory, max_to_keep=3) as mgr:
        CASES[case](pkg, mgr, ckpt, chaos)
        step, back = mgr.restore_latest(template=_state(pkg, 0))
        names = [n for n, _ in mgr.quarantined()]
        evidence = all(os.path.isdir(p) for _, p in mgr.quarantined())
        w = None if back is None else _np(back["w"])
        after = None
        if step is None:
            # recovery, not a crash loop: a new save round-trips
            mgr.save(7, _state(pkg, 7), force=True)
            after = mgr.restore_latest(template=_state(pkg, 0))[0]
    return step, names, evidence, w, after


@pytest.mark.parametrize("case", list(CASES))
def test_corruption_cascades_as_the_references(case, tmp_path):
    got = _run_case("port", case, str(tmp_path / "port"))
    want = _run_case("reference", case, str(tmp_path / "reference"))
    assert got[0] == want[0]
    assert got[1] == want[1] and got[1]          # the same quarantine names
    assert got[2] and want[2]                    # the bytes kept
    if want[3] is None:
        assert got[3] is None and got[4] == want[4] == 7
    else:
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_array_equal(got[3], np.full((4, 4), want[0], "f"))


@pytest.mark.parametrize("pkg", list(PKGS))
def test_explicit_restore_raises_instead_of_cascading(pkg, tmp_path):
    ckpt, _ = PKGS[pkg]
    with ckpt.CheckpointManager(str(tmp_path)) as mgr:
        _save_gens(pkg, mgr, [1, 2])
        os.remove(os.path.join(_gen(mgr, 2), ckpt.COMMIT_NAME))
        with pytest.raises(ckpt.CheckpointCorruption, match="torn-write"):
            mgr.restore(2, template=_state(pkg, 0))
        assert os.path.isdir(_gen(mgr, 2))      # nothing quarantined
        assert mgr.quarantined() == []


def test_template_mismatch_propagates_and_quarantines_nothing(tmp_path):
    with tckpt.CheckpointManager(str(tmp_path)) as mgr:
        _save_gens("port", mgr, [1])
        with pytest.raises(tckpt.CheckpointTemplateMismatch):
            mgr.restore_latest(template={"absent": None})
        assert mgr.quarantined() == [] and mgr.latest_step() == 1


def test_unported_placement_and_orbax_paths_raise(tmp_path):
    with tckpt.CheckpointManager(str(tmp_path)) as mgr:
        _save_gens("port", mgr, [1])
        with pytest.raises(NotImplementedError, match="A9"):
            mgr.restore_latest(shardings={"w": None})
        os.makedirs(_gen(mgr, 5))              # a pre-manifest directory
        with pytest.raises(NotImplementedError, match="A9"):
            mgr.restore(5)
        assert mgr.restore_latest(template=_state("port", 0))[0] == 1
        assert os.path.isdir(_gen(mgr, 5))     # left in place


def test_save_and_restore_sharded_functional_api(tmp_path):
    path = tckpt.save_sharded(_state("port", 4), str(tmp_path / "one"))
    back = tckpt.restore_sharded(path)
    assert torch.equal(back["w"], torch.full((4, 4), 4.0))
    with pytest.raises(FileExistsError):
        tckpt.save_sharded(_state("port", 4), path, force=False)


# -- errno split and the async writer -----------------------------------------
def test_errno_classification():
    assert is_transient_io_error(OSError(errno.EIO, "io"))
    assert is_transient_io_error(OSError("blip, no errno"))
    assert is_transient_io_error(TimeoutError("slow"))
    assert not is_transient_io_error(OSError(errno.ENOSPC, "full"))
    assert not is_transient_io_error(OSError(errno.EROFS, "ro"))
    assert not is_transient_io_error(ValueError("not io"))


def test_save_does_not_retry_enospc(tmp_path):
    with tckpt.CheckpointManager(str(tmp_path)) as mgr:
        with tchaos.inject(ckpt_enospc=1) as cfg:
            with pytest.raises(OSError) as ei:
                mgr.save(1, _state("port", 1), force=True)
        assert ei.value.errno == errno.ENOSPC
        assert cfg.fired == ["enospc@checkpoint.save"]
        assert mgr.latest_step() is None


def test_save_retries_a_transient_error_once(tmp_path):
    with tckpt.CheckpointManager(str(tmp_path)) as mgr:
        with tchaos.inject(fail_io=1) as cfg:
            assert mgr.save(1, _state("port", 1), force=True)
        assert cfg.fired == ["io@checkpoint.save"]
        assert mgr.latest_step() == 1
        with tchaos.inject(fail_io=2):
            with pytest.raises(OSError):
                mgr.save(2, _state("port", 2), force=True)
        with tchaos.inject(fail_io=1):
            with pytest.raises(OSError):
                mgr.save(3, _state("port", 3), force=True,
                         transient_retry=False)
        assert mgr.latest_step() == 1


def test_retry_with_backoff_sleeps_and_stops_on_the_predicate():
    sleeps, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError(errno.EIO, "blip")
        return "ok"

    assert retry_with_backoff(flaky, retries=3, base_delay=0.1, jitter=0.0,
                              sleep=sleeps.append) == "ok"
    assert sleeps == [0.1, 0.2]

    def full():
        calls.append(1)
        raise OSError(errno.ENOSPC, "full")

    calls.clear()
    with pytest.raises(OSError):
        retry_with_backoff(full, retries=5,
                           should_retry=is_transient_io_error,
                           sleep=sleeps.append)
    assert len(calls) == 1


def test_async_submit_never_blocks_and_lands(tmp_path):
    with tckpt.CheckpointManager(str(tmp_path)) as mgr:
        with tchaos.inject(ckpt_slow_io=0.4):
            with tckpt.AsyncCheckpointer(mgr) as saver:
                t0 = time.monotonic()
                saver.submit(1, _state("port", 1))
                assert time.monotonic() - t0 < 0.2
                assert saver.flush(timeout=30)
        assert mgr.latest_step() == 1 and saver.saved_generations == 1


def test_async_newest_wins_depth_one(tmp_path):
    with tckpt.CheckpointManager(str(tmp_path)) as mgr:
        with tchaos.inject(ckpt_slow_io=0.3):
            with tckpt.AsyncCheckpointer(mgr) as saver:
                for v in (1, 2, 3):
                    saver.submit(v, _state("port", v))
                assert saver.flush(timeout=30)
        assert saver.dropped >= 1
        assert mgr.latest_step() == 3


def test_async_degrades_then_escalates(tmp_path):
    fatal = []
    with tckpt.CheckpointManager(str(tmp_path)) as mgr:
        saver = tckpt.AsyncCheckpointer(mgr, max_failures=2,
                                        on_fatal=fatal.append)
        host = _state("port", 1)
        with tchaos.inject(ckpt_enospc=1):
            saver.submit(1, host)
            saver.flush(timeout=30)
        assert saver.consecutive_failures == 1 and not saver.fatal
        saver.submit(2, host)
        saver.flush(timeout=30)
        assert saver.consecutive_failures == 0
        with tchaos.inject(ckpt_enospc=4):
            saver.submit(3, host)
            saver.flush(timeout=30)
            saver.submit(4, host)
            saver.flush(timeout=30)
        assert saver.fatal and fatal[0].errno == errno.ENOSPC
        assert saver.submit(5, host) is False
        saver.close()


def test_durability_metrics_and_the_histogram(tmp_path):
    """The paddle_ckpt_* series count saves, retries and quarantines; the
    port's Histogram renders what the reference's renders for the same
    observations."""
    from paddle_tpu.utils.metrics import MetricsRegistry as JRegistry
    from paddle_tpu_torch.utils.metrics import MetricsRegistry, \
        default_registry

    reg = default_registry()
    saves, retries = reg.get("paddle_ckpt_saves_total"), \
        reg.get("paddle_ckpt_retries_total")
    ok, failed, n_retries = saves.get("ok"), saves.get("failed"), \
        retries.get()
    with tckpt.CheckpointManager(str(tmp_path)) as mgr:
        with tchaos.inject(fail_io=1):
            mgr.save(1, _state("port", 1), force=True)
        with tchaos.inject(ckpt_enospc=1):
            with pytest.raises(OSError):
                mgr.save(2, _state("port", 2), force=True)
    assert (saves.get("ok"), saves.get("failed"), retries.get()) == \
        (ok + 1, failed + 1, n_retries + 1)
    assert "paddle_ckpt_save_ms_bucket" in reg.prometheus_text()
    buckets = [5, 10, 25, 50, 100]
    t = MetricsRegistry().histogram("h", "a histogram", buckets)
    j = JRegistry().histogram("h", "a histogram", buckets)
    for v in (0.5, 5, 7, 30, 99, 1e4):
        t.observe(v)
        j.observe(v)
    assert t.render() == j.render()
    r = MetricsRegistry()
    assert r.gauge("x") is r.gauge("x")       # get-or-create
    with pytest.raises(ValueError):
        r.counter("x")


# -- cross-load ---------------------------------------------------------------
_RS = np.random.RandomState(3)
_F32 = _RS.randn(5, 7).astype(np.float32)
_BF16 = _RS.randn(3, 9).astype(np.float32)
_I64 = _RS.randint(-9, 9, (6,)).astype(np.int64)


def _mixed(pkg):
    if pkg == "port":
        return {"f32": torch.from_numpy(_F32),
                "bf16": torch.from_numpy(_BF16).to(torch.bfloat16),
                "i64": torch.from_numpy(_I64),
                "nested": [torch.tensor(3, dtype=torch.int32),
                           {"h": torch.from_numpy(_F32[:2]).half()}]}
    return {"f32": jnp.asarray(_F32), "bf16": jnp.asarray(_BF16, jnp.bfloat16),
            "i64": np.asarray(_I64), "nested": [
                jnp.int32(3), {"h": jnp.asarray(_F32[:2], jnp.float16)}]}


def _as_f32(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.is_floating_point() else v.numpy()
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype.kind == "f" or \
        str(a.dtype) == "bfloat16" else a


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_generations_cross_load(writer, tmp_path):
    reader = "reference" if writer == "port" else "port"
    wck, rck = PKGS[writer][0], PKGS[reader][0]
    with wck.CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(4, _mixed(writer), force=True, meta={"note": "x"})
    gen = str(tmp_path / "4")
    man, reason = rck.verify_generation(gen, deep=True)
    assert reason is None and man["meta"]["note"] == "x"
    wman, _ = wck.verify_generation(gen, deep=True)
    assert [(e["key"], e["dtype"], e["shape"]) for e in man["leaves"]] == \
        [(e["key"], e["dtype"], e["shape"]) for e in wman["leaves"]]
    assert {e["key"]: e["dtype"] for e in man["leaves"]}["/bf16"] == \
        "bfloat16"
    with rck.CheckpointManager(str(tmp_path)) as mgr:
        step, back = mgr.restore_latest(template=_mixed(reader))
    assert step == 4
    want = _mixed(writer)
    for key in ("f32", "bf16", "i64"):
        np.testing.assert_array_equal(_as_f32(back[key]), _as_f32(want[key]),
                                      err_msg=key)
    assert int(_np(back["nested"][0])) == 3
    np.testing.assert_array_equal(_as_f32(back["nested"][1]["h"]),
                                  _as_f32(want["nested"][1]["h"]))
    if reader == "port":
        assert back["bf16"].dtype == torch.bfloat16
        assert back["nested"][1]["h"].dtype == torch.float16
        # the exact bf16 words
        assert torch.equal(back["bf16"].view(torch.int16),
                           torch.from_numpy(_BF16).to(torch.bfloat16)
                           .view(torch.int16))
    # a template-free restore rebuilds the structure
    with rck.CheckpointManager(str(tmp_path)) as mgr:
        free = mgr.restore(4)
    assert sorted(free) == ["bf16", "f32", "i64", "nested"]


# -- Model.fit resume ---------------------------------------------------------
GPT_CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
               max_position_embeddings=32, dropout=0.0, attn_dropout=0.0)
BERT_CFG = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, dropout=0.0)
GPT_ROWS = np.random.RandomState(11).randint(0, 97, (8, 12))
_BR = np.random.RandomState(12)
BERT_IDS = _BR.randint(0, 120, (8, 12))
BERT_MLM = np.where(_BR.rand(8, 12) < 0.3, _BR.randint(0, 120, (8, 12)), -100)
BERT_NSP = _BR.randint(0, 2, (8,))


def _jax_gpt_loss(logits, labels):
    lv, yv = logits.value, labels.value
    logp = jax.nn.log_softmax(lv[:, :-1].astype(jnp.float32), axis=-1)
    return -jnp.take_along_axis(logp, yv[:, 1:, None], -1)[..., 0].mean()


def _torch_gpt_loss(logits, labels):
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    return -logp.gather(-1, labels[:, 1:, None].long())[..., 0].mean()


def _jax_bert_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels):
    lm, ns = mlm_logits.value, nsp_logits.value
    yl, yn = mlm_labels.value, nsp_labels.value
    valid = yl != -100
    logp = jax.nn.log_softmax(lm.astype(jnp.float32), -1)
    nll = -jnp.take_along_axis(logp, jnp.where(valid, yl, 0)[..., None],
                               -1)[..., 0]
    mlm = jnp.where(valid, nll, 0.0).sum() / jnp.maximum(valid.sum(), 1)
    lpn = jax.nn.log_softmax(ns.astype(jnp.float32), -1)
    return mlm - jnp.take_along_axis(lpn, yn[:, None], -1)[:, 0].mean()


def _torch_bert_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels):
    valid = mlm_labels != -100
    logp = torch.log_softmax(mlm_logits.float(), -1)
    nll = -logp.gather(-1, torch.where(valid, mlm_labels, 0)[..., None]
                       .long())[..., 0]
    mlm = torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)
    lpn = torch.log_softmax(nsp_logits.float(), -1)
    return mlm - lpn.gather(-1, nsp_labels[:, None].long())[:, 0].mean()


class _Losses:
    """A callback of each package's that keeps every step's loss."""

    @staticmethod
    def make(callbacks):
        class Keep(callbacks.Callback):
            def __init__(self):
                super().__init__()
                self.losses = []

            def on_train_batch_end(self, step, logs=None):
                self.losses.append(float(logs["loss"]))

        return Keep()


def _jax_fit_model(kind, state):
    paddle.seed(0)
    if kind == "gpt":
        net = JGPTForCausalLM(JGPTConfig(**GPT_CFG))
        loss, labels = _jax_gpt_loss, None
        t = paddle.to_tensor(GPT_ROWS)
        data = paddle.io.TensorDataset([t, t])
    else:
        net = JBertForPretraining(JBertConfig(**BERT_CFG))
        loss, labels = _jax_bert_loss, ["mlm", "nsp"]
        data = paddle.io.TensorDataset([
            paddle.to_tensor(a) for a in (BERT_IDS, BERT_MLM, BERT_NSP)])
    if state is not None:
        net.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    model = paddle.Model(net, labels=labels)
    model.prepare(paddle.optimizer.AdamW(
        learning_rate=LR, weight_decay=WD, parameters=net.parameters()),
        loss)
    return model, data


def _port_fit_model(kind, state=None, dropout=0.0):
    ptt.seed(0)
    if kind == "gpt":
        net = GPTForCausalLM(GPTConfig(**{**GPT_CFG, "dropout": dropout,
                                          "attn_dropout": dropout}),
                             device="cpu")
        loss, labels = _torch_gpt_loss, None
        t = torch.from_numpy(GPT_ROWS)
        data = ptt.io.TensorDataset([t, t])
    else:
        net = BertForPretraining(BertConfig(**BERT_CFG), device="cpu")
        loss, labels = _torch_bert_loss, ["mlm", "nsp"]
        data = ptt.io.TensorDataset([
            torch.from_numpy(a) for a in (BERT_IDS, BERT_MLM, BERT_NSP)])
    if state is not None:
        load_numpy_state(net, state)
    model = ptt.Model(net, labels=labels)
    model.prepare(ptt.optimizer.AdamW(
        learning_rate=LR, weight_decay=WD, parameters=net.parameters()),
        loss)
    return model, data


def _fit(model, data, cbs_mod, epochs, **kw):
    keep = _Losses.make(cbs_mod)
    model.fit(data, batch_size=2, epochs=epochs, shuffle=False, verbose=0,
              callbacks=[keep], **kw)
    return keep.losses


def _weights(model):
    out = {}
    for k, p in model.network.named_parameters():
        v = p.detach() if isinstance(p, torch.Tensor) else p._value
        # a copy: the port's step updates its parameters in place
        out[k] = np.array(v.float() if isinstance(v, torch.Tensor) else v,
                          np.float32, copy=True)
    return out


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_port_fit_continues_a_reference_generation(kind, tmp_path):
    """The reference trains 8 steps (checkpoints at 3 and 6); its fresh
    model resumes at 6 and trains 4 more.  The port, given a copy of the
    same directory, resumes at 6: its 4 losses within rtol 1e-5 of the
    reference's continuation, and its parameters after the restore are the
    generation's, bit for bit."""
    from paddle_tpu.hapi import callbacks as jcb
    from paddle_tpu_torch.hapi import callbacks as tcb

    paddle.seed(0)
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    m, data = _jax_fit_model(kind, None)
    _fit(m, data, jcb, 2, resume=jdir, checkpoint_interval=3)
    shutil.copytree(jdir, tdir)
    with jckpt.CheckpointManager(os.path.join(jdir, "resilient")) as mgr:
        assert mgr.latest_step() == 6
    back = jckpt.restore_sharded(os.path.join(jdir, "resilient", "6"))
    m, data = _jax_fit_model(kind, None)
    want = _fit(m, data, jcb, 3, resume=jdir, checkpoint_interval=3)
    assert len(want) == 6
    tm, tdata = _port_fit_model(kind)
    restored = {}

    class Peek(tcb.Callback):
        def on_train_begin(self, logs=None):
            restored.update(_weights(self.model))

    got_cb = _Losses.make(tcb)
    tm.fit(tdata, batch_size=2, epochs=3, shuffle=False, verbose=0,
           callbacks=[Peek(), got_cb], resume=tdir, checkpoint_interval=3)
    np.testing.assert_allclose(got_cb.losses, want, **FIT_TOL)
    for k, v in restored.items():
        np.testing.assert_array_equal(v, np.asarray(back["params"][k]),
                                      err_msg=k)
    assert tm._optimizer._step_count == 12


def test_reference_fit_continues_a_port_generation(tmp_path):
    """The other way: the port trains 8 steps of the small GPT, the
    reference resumes from the port's generation at 6 (its manifest meta
    carries the port's random streams, which the reference ignores), its
    losses within rtol 1e-5 of the port's own continuation."""
    from paddle_tpu.hapi import callbacks as jcb
    from paddle_tpu_torch.hapi import callbacks as tcb

    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "ref")
    tm, data = _port_fit_model("gpt")
    _fit(tm, data, tcb, 2, resume=tdir, checkpoint_interval=3)
    shutil.copytree(tdir, jdir)
    tm, data = _port_fit_model("gpt")
    want = _fit(tm, data, tcb, 3, resume=tdir, checkpoint_interval=3)
    jm, jdata = _jax_fit_model("gpt", None)
    got = _fit(jm, jdata, jcb, 3, resume=jdir, checkpoint_interval=3)
    np.testing.assert_allclose(got, want, **FIT_TOL)


@pytest.mark.parametrize("interval", [3, None])
def test_port_resume_is_bitwise_its_unbroken_run(interval, tmp_path):
    """GPT at dropout 0.1 (hidden and attention): 12 unbroken steps, and
    8 steps then a fresh model resuming from the newest generation (step 6
    mid-epoch with ``checkpoint_interval=3``, step 8 at the epoch end
    without): the same losses and parameters, bit for bit."""
    from paddle_tpu_torch.hapi import callbacks as tcb

    m, data = _port_fit_model("gpt", dropout=0.1)
    unbroken = _fit(m, data, tcb, 3)
    ref = _weights(m)
    d = str(tmp_path)
    m, data = _port_fit_model("gpt", dropout=0.1)
    _fit(m, data, tcb, 2, resume=d, checkpoint_interval=interval)
    m, data = _port_fit_model("gpt", dropout=0.1)
    resumed = _fit(m, data, tcb, 3, resume=d, checkpoint_interval=interval)
    at = 6 if interval else 8
    assert resumed == unbroken[at:]
    got = _weights(m)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _leaf_bytes(gen):
    man = json.load(open(os.path.join(gen, "manifest.json")))
    return {e["key"]: open(os.path.join(gen, e["file"]), "rb").read()
            for e in man["leaves"]}


def test_async_and_sync_saves_write_the_same_generation(tmp_path):
    from paddle_tpu_torch.hapi import callbacks as tcb

    m, data = _port_fit_model("gpt", dropout=0.1)
    _fit(m, data, tcb, 2, resume=str(tmp_path / "async"))
    tflags.set_flags({"FLAGS_ckpt_async": False})
    try:
        m, data = _port_fit_model("gpt", dropout=0.1)
        _fit(m, data, tcb, 2, resume=str(tmp_path / "sync"))
    finally:
        tflags.set_flags({"FLAGS_ckpt_async": True})
    a = _leaf_bytes(str(tmp_path / "async" / "resilient" / "8"))
    b = _leaf_bytes(str(tmp_path / "sync" / "resilient" / "8"))
    assert list(a) == list(b) and a == b
    for sub in ("async", "sync"):
        gen = str(tmp_path / sub / "resilient" / "8")
        assert tckpt.verify_generation(gen, deep=True)[1] is None
        assert jckpt.verify_generation(gen, deep=True)[1] is None


def test_the_generations_keypaths_are_the_references(tmp_path):
    """/params/<name>, /buffers/<name>, /opt/<name>/<slot>, /meta/it,
    /meta/opt_steps: the port's fit generation holds the reference's
    keys, dtypes and shapes for the same network."""
    from paddle_tpu.hapi import callbacks as jcb
    from paddle_tpu_torch.hapi import callbacks as tcb

    m, data = _port_fit_model("bert")
    _fit(m, data, tcb, 1, resume=str(tmp_path / "p"))
    jm, jdata = _jax_fit_model("bert", None)
    _fit(jm, jdata, jcb, 1, resume=str(tmp_path / "j"))
    got = tckpt.verify_generation(str(tmp_path / "p" / "resilient" / "4"))[0]
    want = jckpt.verify_generation(str(tmp_path / "j" / "resilient" / "4"))[0]
    assert [(e["key"], e["dtype"], e["shape"]) for e in got["leaves"]] == \
        [(e["key"], e["dtype"], e["shape"]) for e in want["leaves"]]
    assert got["meta"]["mesh"]["dp"] == want["meta"]["mesh"]["dp"] == 1
    assert "torch_rng" in got["meta"]


def test_resume_into_a_trained_model_lands_in_place(tmp_path):
    """A model that already trained (its slots exist) resumes from another
    run's generation: its parameters and slots keep their tensors (a
    captured graph holds them) and hold the generation's values."""
    from paddle_tpu_torch.hapi import callbacks as tcb

    d = str(tmp_path)
    other, data = _port_fit_model("gpt")
    _fit(other, data, tcb, 1, resume=d)
    m, data = _port_fit_model("gpt")
    m.fit(data, batch_size=2, epochs=1, shuffle=False, verbose=0)
    ptrs = [p.data_ptr() for p in m.network.parameters()]
    slots = {id(p): [v.data_ptr() for v in m._optimizer._slots[id(p)]
                     .values()] for p in m.network.parameters()}
    m._engine.begin()
    start = m._ft_restore(tckpt.CheckpointManager(os.path.join(d,
                                                               "resilient")))
    assert start == 4
    assert [p.data_ptr() for p in m.network.parameters()] == ptrs
    assert {id(p): [v.data_ptr() for v in m._optimizer._slots[id(p)]
                    .values()] for p in m.network.parameters()} == slots
    want = _weights(other)
    for k, v in _weights(m).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert m._optimizer._step_count == 4


# -- preemption and durability ------------------------------------------------
def test_fit_preemption_writes_the_emergency_generation(tmp_path):
    m, data = _port_fit_model("gpt")
    with tchaos.inject(preempt_at_step=3) as cfg:
        with pytest.raises(SystemExit) as ei:
            m.fit(data, batch_size=2, epochs=4, shuffle=False, verbose=0,
                  fault_tolerant=True, resume=str(tmp_path))
    assert ei.value.code == PREEMPTED_EXIT_CODE
    assert cfg.fired == ["preempt@3"]
    with tckpt.CheckpointManager(str(tmp_path / "resilient")) as mgr:
        assert mgr.latest_step() == 3


def test_fit_requires_a_directory():
    m, data = _port_fit_model("gpt")
    with pytest.raises(ValueError, match="directory"):
        m.fit(data, batch_size=2, epochs=1, verbose=0, fault_tolerant=True)


@pytest.mark.parametrize("async_saves", [True, False])
def test_fit_escalates_after_k_failed_generations(async_saves, tmp_path):
    tflags.set_flags({"FLAGS_ckpt_async": async_saves})
    try:
        m, data = _port_fit_model("gpt")
        with tchaos.inject(ckpt_enospc=99):
            with pytest.raises(SystemExit) as ei:
                m.fit(data, batch_size=2, epochs=8, shuffle=False,
                      verbose=0, resume=str(tmp_path),
                      checkpoint_interval=1)
        assert ei.value.code == DURABILITY_EXIT_CODE
    finally:
        tflags.set_flags({"FLAGS_ckpt_async": True})


_CHILD = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn
    ptt.seed(0)
    net = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    rs = np.random.RandomState(0)
    x = rs.randn(32, 4).astype("float32")
    y = (x.sum(1) > 0).astype("int64")
    model = ptt.Model(net)
    model.prepare(ptt.optimizer.Adam(learning_rate=0.01,
                                     parameters=net.parameters()),
                  nn.CrossEntropyLoss())
    model.fit(ptt.io.TensorDataset([torch.from_numpy(x),
                                    torch.from_numpy(y)]),
              batch_size=8, epochs=4, shuffle=False, verbose=0,
              fault_tolerant=True, resume=sys.argv[1])
    print("NOT PREEMPTED")
''')


def test_sigterm_in_a_subprocess_exits_75_with_its_generation(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = {**os.environ, "PYTHONPATH": ROOT, "PADDLE_CHAOS_PREEMPT_STEP": "6"}
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == PREEMPTED_EXIT_CODE, proc.stderr[-2000:]
    assert "NOT PREEMPTED" not in proc.stdout
    gen = str(tmp_path / "resilient" / "6")
    man, reason = tckpt.verify_generation(gen, deep=True)
    assert reason is None and man["step"] == 6
    assert jckpt.verify_generation(gen, deep=True)[1] is None
    # the epoch-end generation before it is kept too
    with tckpt.CheckpointManager(str(tmp_path / "resilient")) as mgr:
        assert mgr.all_steps() == [4, 6]
