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
                  library times; then the whole-tree optimizer kernel
                  bitwise against the per-parameter loop (SGD, Momentum,
                  Nesterov, Adam, AdamW; float32 and bf16; clip, scheduled
                  lr, no-grad parameter, resume), timed over GPT-2-small's
                  parameters, and opt.step() under sync debug mode.
4. logits       — full-width GPT-2-small (GPTConfig() defaults) in float32:
                  a 64-token slot_prefill and 8 slot_decode_paged steps on
                  the card against the same on the CPU (plain versions).
   prefix-f32 / chunked — the same float32 model behind
                  GenerationEngine: 3 prefix-cache hits give the miss's
                  greedy tokens (and a prefix-free engine's); 8 prompts of
                  65-128 tokens with prefill_chunk=32 give the unchunked
                  engine's greedy tokens.
5. serving      — the same model in bfloat16 behind GenerationEngine at
                  the reference's defaults (prefix cache on), its decode
                  step captured once as a CUDA graph at start() and
                  replayed: 16 requests in one wave, greedy and sampled
                  alternating; every serving kernel's launch count (the
                  eager prefills plus the graph's launches times its
                  replays) must be > 0 and every launch in the graph on
                  its fast kernel; then 4 requests with every decode step
                  under torch.cuda.set_sync_debug_mode("warn"): one sync
                  a step, the token fetch, or the run fails.
   serving-graph — the same wave through the graph and through
                  `_step_eager`, paired (graph, eager, eager, graph):
                  tokens/s, TTFT, inter-token p50, busy share, launches
                  a decode step; greedy tokens identical.
   prefix       — 16 requests sharing a 64-token prefix: hit ratio, TTFT
                  of hits and misses; a hit's bf16 first-token logits
                  within BF16_TOL of the miss's.
6. train-parity — full-width float32, B = 2, S = 128: loss(ids) and every
                  parameter's gradient on the card against the CPU's,
                  every attention launch on its split-TF32 kernel (as
                  in 9 and 15's float32 parity).
7. train        — full-width bfloat16, B = 8, S = 1024: 10 dygraph AdamW
                  steps on one batch (the loss must fall; step time,
                  tokens/s, MFU), a profiled window, then Model.fit steps;
                  every training kernel's launch count must be > 0, and
                  every opt.step() one optimizer launch a dtype group with
                  the per-parameter loop on no CUDA tensor (also phases 10
                  and 11).
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
12. dropout-train — GPTForCausalLM(GPTConfig()) and
                  BertForPretraining(BertConfig()) at their published
                  dropout 0.1 (attention dropout inside the three
                  attention kernels), full width and depth, bf16: 10
                  dygraph AdamW steps and 3 Model.fit steps each, twice
                  from the same paddle_tpu_torch.seed: every loss finite,
                  the 10 steps falling, both runs bitwise equal, every
                  attention launch with dropout on the tensor cores; step
                  time, tokens/s and MFU beside the dropout-0 phases'.
13. train-graph — Model.fit through the training engine's captured step
                  (one CUDA graph a batch signature, replayed) against
                  `_step_eager` swapped in, paired in one run (graph,
                  eager, eager, graph): GPTConfig() at dropout 0.1 and 0,
                  BertConfig() at 0.1, full width, bf16, 12 steps + 2
                  profiled + 4 under torch.cuda.set_sync_debug_mode each;
                  fails unless the four runs' losses are bitwise equal,
                  the graph runs captured once, their replayed steps made
                  no sync but the drain, and every launch in the traces
                  took its fast kernel (with dropout exactly when p > 0)
                  with one optimizer launch a step; step p50, tokens/s,
                  MFU, busy share, launches a step.
   fit-f32      — GPTForCausalLM(GPTConfig()) in float32, its default
                  dtype, full width and depth, dropout 0.1, B = 8,
                  S = 1024, AdamW, 8 Model.fit steps through the captured
                  step + 2 profiled, twice from one seed: losses finite,
                  falling and bitwise equal, one capture, every attention
                  forward, dq and dk/dv launch on its split-TF32 kernel
                  with dropout (12 of each a captured step), one
                  optimizer launch a step; step p50, tokens/s, busy
                  share, the device ms a step of dq + dk/dv and their
                  share, MFU against the CUDA cores' float32 peak.
14. fit-api     — Model.fit's user surface on BertConfig() (bf16, B = 32,
                  S = 128, padded): a dygraph loss kept alive, then fit
                  with an NSP accuracy metric, eval data, checkpoints,
                  EarlyStopping and VisualDL, a fresh model's load and
                  predict; fails unless the eval graph is bitwise the
                  eager _eval, its traced launches equal its capture's x
                  the replays (fast kernels, no dropout), the metric equals
                  np.argsort(-pred) of the fetched logits, predict after
                  load is bitwise the trained model's and every file is
                  there; eval graph and eager ms a batch, train-graph p50
                  with and without the metric, save/load times.
15. seq2seq     — the encoder-decoder Transformer at nn.Transformer()'s
                  defaults (Transformer-base: d_model 512, 8 heads,
                  6 + 6 layers, FFN 2048, dropout 0.1, ReLU, post-LN), a
                  shared 37,000-token embedding, bf16, batches of 48
                  pairs (sources 16-72 tokens padded to 72, targets 16-64
                  padded to 64): the cross form of the three attention
                  kernels (S_q = 64 over S_k = 72, and the decode step's
                  S_q = 1) against their plain versions, and LayerNorm
                  (width 512), softmax cross-entropy (V = 37,000) and the
                  optimizer (Adam, beta2 0.98, eps 1e-9) at the path's
                  shapes; float32 loss and
                  gradients at B = 2 against the CPU's; Model.fit with
                  Adam and NoamDecay, graph, eager, eager, graph: losses
                  bitwise equal and falling, 18 attention forward launches
                  a step (6 cross), all on the tensor cores with dropout,
                  one optimizer launch a step; the eval graph bitwise the
                  eager _eval; greedy decoding with the caches equal to the
                  recompute (float32), and (bf16) every step's logits
                  within BF16_TOL of the recompute's up to the first step
                  whose tokens differ.  Step p50, tokens/s (real tokens;
                  positions/s beside it), MFU, eval and decode ms.
16. amp-kernels / amp-unscale — each float16 and mixed form (bf16 or
                  float16 x beside a float32 weight or bias) of the eight
                  training kernels at the AMP paths' shapes against its
                  plain version (F16_TOL for float16), beside the bf16
                  kernel at the same shape and the float16 library call;
                  the float16 and bf16 dropout masks equal; the unscale
                  kernel over GPT-2-small's 148 float16 gradients bitwise
                  its plain version, clean and with an inf and a NaN.
17. ernie-o2    — ERNIE pretraining (BertConfig(vocab_size=18000,
                  type_vocab_size=4), full width and depth, dropout 0.1)
                  in AMP-O2 float16: decorate, auto_cast, GradScaler(2**15),
                  AdamW, B = 32, S = 128 padded, 30 steps twice from one
                  seed: losses finite, falling over the applied steps and
                  bitwise equal in both runs, the scale by the reference's
                  rule, every kernel in its float16 form (the trace), the
                  first batch's loss within AMP_LOSS_RTOL of the port's CPU
                  run; step p50, samples/s, MFU.
18. fit-amp     — BERT-base (float32 parameters) through Model.fit under
                  auto_cast(level="O1", dtype="bfloat16"): graph and
                  eager bitwise equal, the mixed LayerNorm and bias-GeLU
                  forms, float32 MLM and bf16 NSP cross-entropy in the
                  trace, and a plain fit of the same model capturing a
                  graph of its own.
19. paged-f16   — float16 paged decode (split and lane kernels, its own
                  __half instantiation) against its plain version at the
                  serving table's shape and a wave's, timed beside the
                  bf16 kernel at the same shape; the softmax cross-entropy
                  kernels at the vision paths' shapes (ResNet-50: N = 128,
                  V = 1000, bf16; LeNet: V = 10, float32) against their
                  plain versions and F.cross_entropy.
20. fp16-serve  — GPT-2-small cast to float16 behind GenerationEngine at
                  the reference's defaults: a float16 KV pool, 16 greedy
                  requests and 4 on a shared prefix through the decode
                  graph, tokens identical to the eager decode step's and
                  to an amp.decorate(O2, float16) model's, the float16
                  instantiations in the trace.
21. lenet       — BASELINE.md config 1: LeNet (float32) on synthetic MNIST
                  through Model.fit's captured step until evaluate's
                  accuracy reaches 0.97 (at most 10 epochs); graph and
                  eager step p50; 3 steps graph bitwise eager under
                  cudnn.deterministic.
22. resnet50    — BASELINE.md config 2 on one card: resnet50 in bf16,
                  Momentum, B = 128 x 3 x 224 x 224: 20 dygraph steps
                  (falling loss), Model.fit graph and eager (step p50,
                  samples/s, MFU, one-drain throughput, busy share and
                  device ms by kernel family of 2 profiled replays,
                  launches a step, peak memory, the host's collation and
                  pinned copy of a batch), and 3 steps graph bitwise eager
                  under cudnn.deterministic, running statistics included.
23. optimizers  — each rule the optimizer kernels gained (Adagrad,
                  Adamax, Adadelta, RMSProp plain and centered, Ftrl, an
                  L1Decay SGD; Lamb, LarsMomentum and Dpsgd through the
                  two-launch norm kernels) over BERT-base's bf16 tree and
                  LeNet's float32 tree, 3 steps against the per-parameter
                  loop (the elementwise rules bitwise, the norm rules
                  within NORM_RTOL / NORM_BF16_RTOL, their steps too,
                  and a planted 25 % larger step refused), timed over the BERT
                  tree against the loop and its bound; first, the norm
                  kernels' device ms by launch (from a trace of a
                  replayed graph) beside a copy that moves the bound's
                  bytes and the two launches' floor; Dpsgd's noise
                  statistics over 2**20 elements, its repeatability and
                  sigma = 0 as SGD.
24. wrappers    — EMA and ModelAverage over BERT-base's bf16 tree in
                  dygraph against their CPU plain versions (update, apply,
                  restore); Lookahead's sync every k steps; Model.fit
                  refusing a wrapper, as the reference's does.
25. bert-lamb-accum — BertConfig() bf16 through Model.fit with Lamb and
                  accumulate_grad_batches=4 over global batches of 128:
                  one capture, one replay a step (4 microbatches of the
                  B = 32 step's kernels, the norm kernels twice), losses
                  falling and bitwise the eager step's, the drains the
                  only syncs; step p50, samples/s, MFU, busy share, peak
                  memory beside accum 1 fits at B = 32 and B = 128.
26. resnet50-lars — ResNet-50 bf16, B = 128, Model.fit with
                  LarsMomentum at the reference's defaults: the loss
                  falls, the norm kernels twice a replay, device ms a
                  step and samples/s, 3 steps graph bitwise eager under
                  cudnn.deterministic; LarsMomentum's kernel against the
                  per-parameter loop over ResNet-50's own tree, timed.
27. resume      — durable checkpoints and resume in Model.fit on
                  BertConfig() (dropout 0.1), bf16, AdamW, B = 32, S = 128
                  padded, shuffle off, the captured step: 8 steps
                  unbroken; 8 with synchronous saves every 4 steps; a
                  child process (`python3 chip_smoke.py --resume-child
                  DIR`) with fault_tolerant=True, async saves every 2
                  steps and SIGTERM after step 5, which must exit 75
                  with its emergency generation; a new Model resuming
                  from it to step 8 (an async save at the epoch's
                  end).  Fails unless the resumed losses and
                  every final parameter and slot are bitwise the unbroken
                  run's, the generation passes verify_generation(deep),
                  and the resumed run's async generation of step 8 is the
                  sync run's, byte for byte.  Generation bytes, save ms (fsyncs
                  included), the training thread's stall a save (sync
                  and async), restore_latest ms, step p50 with and
                  without interval saves.
28. io         — the host data path: ResNet-50 bf16 (config 2) through
                  Model.fit over a bank of 16 images (R50Bank, module
                  scope: it pickles to forkserver workers), shuffle on,
                  each batch pinned by fit's placement hook, a drain a
                  step, cudnn.deterministic on; the collation on the
                  training thread, on the buffered reader's thread and in
                  4 worker processes: step p50, the training thread's
                  host ms a step from the profile, device ms, the loader
                  alone, worker start-up; losses bitwise equal across the
                  three, and equal in a fit slowed on the card by
                  torch.cuda._sleep (a pinned batch refilled while its
                  copy is pending would change them); one drain an epoch
                  with the reader on and off in turns.
29. flops      — paddle_tpu_torch.flops of ResNet-50, BERT-base (B = 32,
                  S = 128) and GPT-2-small (B = 8, S = 1024) on the card
                  must equal the CPU's; a step's count beside the hand
                  counts of the MFU lines.
30. generate   — GPTForCausalLM.generate on GPT-2-small (GPTConfig(),
                  dropout 0) over a dense KV cache, its decode step one
                  CUDA graph a key: float32 greedy (B = 4, S = 64, 32 new)
                  against the CPU's and GenerationEngine's tokens up to
                  the first near tie; bf16 greedy (B = 8, S = 128, 128
                  new), top-k sampling (seeds 7 and 8), beam search (4
                  beams, B = 2, 64 new) and an eos run, each bitwise the
                  eager step's, a later call under sync debug mode
                  "error"; the trace of a replayed call (rows 1, 2 and 6
                  fast, the launches a call implies); rows 1, 2 and 6
                  against their plain versions at the path's shapes; the
                  HF GPT-2 export loaded back on the card bitwise.
31. spec       — speculative decode in GenerationEngine on GPT-2-small
                  at the serving defaults, spec_tokens 4, the speculative
                  step one CUDA graph: float32 waves through the plain
                  engine, a 2-layer draft, a self-draft and a bad draft
                  (tokens the plain engine's up to the first near tie,
                  the self-draft's accept ratio >= 0.9, the bad draft's
                  < 0.9); bf16 graph = eager bitwise, a sampled stream
                  the plain engine's up to a near tie of its draw, one
                  sync a step, a traced wave's replays at the graph's
                  launches on fast kernels; rows 1, 2 and 9 at the
                  path's shapes.
32. predict-serve — Model(BertModel(BertConfig())).serve on full-width
                  BERT-base in float32: 12 bucket graphs (1,2,4,8 x
                  32,64,128) captured by serve(), 4 ServingClient threads
                  x 8 requests of 8-128 ids; every response bitwise its
                  row of a direct Predictor.run of its padded batch at its
                  bucket, every 8th within 1e-4 of the CPU port, no capture
                  after warm-up; rows 1, 2 and 6 against their plain
                  versions at the 1 x 32 and 8 x 128 buckets, launches of a
                  replay from the capture; request p50/p99, mean batch,
                  padding waste, an 8 x 128 replay's device ms, the host's
                  JSON encode of a response.
33. http-generate — Model(GPT-2-small).serve_generate in bf16 at the
                  serving defaults: the serving wave over HTTP (8 SSE, 2
                  sampled) against the same engine in process (tokens
                  equal up to near ties; tokens/s, TTFT, inter-token),
                  /predict probes to phase 32's server beside it (bitwise),
                  streams cut after 16 tokens resumed over HTTP with
                  resume_pos 16 (plain and speculative engines), then
                  shutdown() with 4 SSE streams open: each ends with its
                  done event and the drain is clean.  Run alone after the
                  build with `python3 chip_smoke.py --serving-front-end`.
34. fleet       — two full-width float32 GPT-2-small replica processes
                  (`python -m paddle_tpu_torch.serving.generation` at
                  GPTConfig()'s widths, 8 slots, buckets 64,128, seed 0)
                  under ReplicaSupervisor, behind a FleetRouter on its
                  coordinator, the kernels built by this process first.
                  An in-process twin (the same argv through
                  build_replica): its decode replay's launches on their
                  variants, rows 1, 2, 6 and 9 against their plain
                  versions at the replica's shapes, 4 greedy probes whose
                  first 8 tokens are the CPU port's up to a near tie; each
                  replica's tokens for the probes bitwise the twin's;
                  spawn-to-registration and capture times; an affinity
                  burst (>= 7 of 8 prefix_hit on one replica, its prefix
                  cache 7/8); a wave through the router, to one replica
                  and in process (tokens/s, TTFT, inter-token); the
                  SIGKILL drill (a stream cut after its 16th token
                  resumes on the survivor: no error, 0 failed requests,
                  tokens the undisturbed run's up to a near tie; the
                  victim respawned and re-admitted, down_s > 0 in the
                  replica_lost dump, device memory before and after,
                  heartbeat gaps); both drains with 2 streams open.  Run
                  alone after the build with `python3 chip_smoke.py
                  --fleet`.

`python3 chip_smoke.py --optimizers` runs the build and the phases that
hold the optimizer kernels alone (3's optimizer part, lenet, resnet50,
optimizers, bert-lamb-accum, resnet50-lars).

The AccumulateGrad stream warning (a backward accumulating into a node of
another stream: the training engine's warm-up meeting a dygraph graph
still alive) is an error for the whole run.

Model.fit replays a captured step, whose launches the kernel wrappers do
not count (they count the first, eager step and the capture): every
Model.fit check (phases 7, 11, 12, 13 and fit-f32) reads its launches from
a profiler trace by CUDA kernel name (`TRACE_KERNELS`), with the same
expected numbers as before (one optimizer launch a step for each dtype
group).

Phase 3 also holds the softmax cross-entropy kernels (BERT's MLM and NSP
shapes and GPT's) and the non-causal and masked forms of the attention
kernels (BERT's shape and S = 77) against their plain versions, paged
decode at the serving table's shape and a serving wave's, and times the
bias-GeLU Function's db reduction against the one it replaced.  Seven C
entries choose between hand-written kernels (`VARIANTS`): the attention
forward, dq and dk/dv a tensor-core kernel (16-bit operands on 16-byte
boundaries: `mma`), a split-TF32 tensor-core kernel (float32 on 16-byte
boundaries: `tf32x3`) or a CUDA-core one (any other operand: `simt`);
LayerNorm a warp-per-row
vector kernel or a block per row (`warp` / `block`); paged decode the
split (flash-decoding) kernel or a block per (head, lane) (`split` /
`lane`); the bias-GeLU forward and backward a 16-byte vector kernel or a
scalar loop (`vec` / `scalar`).  Every `[kernels]` line of theirs names
the variant the launch took, all are held against the plain version (the
slower ones on operands one element off a 16-byte boundary), and a phase
of the serving or training paths fails if one of its launches took a
kernel other than its dtype's fast one.  Float32 attention lines print
two bounds: the CUDA cores' 67 TFLOP/s and split-TF32's 495 / 3.

Attention dropout (phase 3): the keep mask the kernels draw (Philox, one
pure function of seed, plane, query and key) is held bitwise against the
plain version's at GPT's and BERT's training shapes, with its keep rate;
a one-hot V shows that the forward applies exactly that mask on both its
kernels; forward, dq and dk/dv with p = 0.1 are held against their plain
versions at both shapes and timed against p = 0 and against SDPA with
the same dropout.

The line before the last is the per-kernel JSON record; the last line is
the result JSON.  Float32 phases run with TF32 off for matmuls and cuDNN.
"""
import gc
import json
import math
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

import numpy as np

START = time.perf_counter()   # the run's start (phases log their start)
F32_TOL = 2e-5       # x max(1, max|ref|): float32 summation-order noise
BF16_TOL = 2 ** -6   # x max(1, max|ref|): two bf16 ulps at the top binade
F16_TOL = 2 ** -8    # x max(1, max|ref|): four float16 ulps at the top binade
LOGITS_REL_TOL = 1e-3  # max|dlogits| / max|ref| over 12 layers, float32
GRAD_REL_TOL = 1e-3    # max|dgrad| / max|ref| per parameter, float32
HBM_BYTES_PER_S = 3.35e12
DROPOUT_P = 0.1             # GPTConfig()'s and BertConfig()'s dropout
DROPOUT_SEED = 0x5EED0FD809
# what torch.cuda.set_sync_debug_mode("warn") says at a synchronizing call
# (its first use also warns that the mode is a prototype: not a sync)
SYNC_WARNING = "called a synchronizing CUDA operation"
PEAK_BF16_TENSOR = 989e12   # dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12            # float32 CUDA-core FLOP/s
PEAK_TF32X3 = 495e12 / 3    # dense TF32 tensor-core FLOP/s over the three
#                             products of a split-TF32 float32 product
TRACE_EDGE_S = 0.05         # idle seconds at each edge of a traced window

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
    # apply_pytree: XLA-fused in the reference's jitted step, not a
    # pallas_call
    "multi_tensor_step": ("paddle_tpu_torch/csrc/multi_tensor_optim.cu",
                          "paddle_tpu/optimizer/__init__.py:155"),
    # the norm rules (Lamb, LarsMomentum, Dpsgd) of the same apply_pytree
    "multi_tensor_norm_step": ("paddle_tpu_torch/csrc/multi_tensor_optim.cu",
                               "paddle_tpu/optimizer/__init__.py:155"),
    # GradScaler.unscale_ and the functional check_finite_and_unscale:
    # XLA-fused in the reference, not a pallas_call
    "check_finite_and_unscale": ("paddle_tpu_torch/csrc/amp.cu",
                                 "paddle_tpu/amp/__init__.py:127"),
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
# every C entry that chooses between hand-written kernels: (the kernel for
# any other operand, the kernel every launch of a 16-bit path must take,
# the attention kernels' float32 kernel) — the three attention kernels'
# tensor-core kernel for aligned bf16 beside the CUDA-core one and their
# split-TF32 kernel for aligned float32, and the 16-byte vector kernels of
# LayerNorm, paged decode and the bias-GeLU forward and backward beside
# their scalar ones
MMA_KERNELS = ("flash_attention", "flash_attention_dq", "flash_attention_dkv")
VECTOR_KERNELS = ("layer_norm", "paged_decode_attention", "bias_gelu",
                  "bias_gelu_bwd")
VARIANTS = {**{n: ("simt", "mma", "tf32x3") for n in MMA_KERNELS},
            "layer_norm": ("block", "warp"),
            "paged_decode_attention": ("lane", "split"),
            "bias_gelu": ("scalar", "vec"),
            "bias_gelu_bwd": ("scalar", "vec")}
FAST_VARIANT = {n: names[1] for n, names in VARIANTS.items()}
# the kernels a float32 path must take: the attention kernels' split-TF32
# ones, the others' fast kernels as in 16 bits
F32_FAST = {**FAST_VARIANT, **dict.fromkeys(ATTENTION_KERNELS, "tf32x3")}
# the CUDA kernel behind each variant of the port's entries, as a profiler
# trace names it (an entry with one kernel: variant "kernel"): the launches
# of a path that replays a CUDA graph (the serving wave, Model.fit) are read
# from its trace, which shows a graph's replayed launches as well
TRACE_KERNELS = {
    "flash_attention": {"simt": "flash_fwd_kernel",
                        "mma": "flash_fwd_mma_kernel",
                        "tf32x3": "flash_fwd_tf32x3_kernel"},
    "flash_attention_dq": {"simt": "flash_dq_kernel",
                           "mma": "flash_dq_mma_kernel",
                           "tf32x3": "flash_dq_tf32x3_kernel"},
    "flash_attention_dkv": {"simt": "flash_dkv_kernel",
                            "mma": "flash_dkv_mma_kernel",
                            "tf32x3": "flash_dkv_tf32x3_kernel"},
    "layer_norm": {"block": "layer_norm_fwd_kernel",
                   "warp": "layer_norm_warp_kernel"},
    "paged_decode_attention": {"lane": "paged_decode_kernel",
                               "split": "paged_decode_split_kernel"},
    "bias_gelu": {"scalar": "bias_gelu_fwd_kernel",
                  "vec": "bias_gelu_fwd_vec_kernel"},
    "bias_gelu_bwd": {"scalar": "bias_gelu_bwd_kernel",
                      "vec": "bias_gelu_bwd_vec_kernel"},
    "softmax_xent": {"kernel": "xent_fwd_kernel"},
    "softmax_xent_bwd": {"kernel": "xent_bwd_kernel"},
    "multi_tensor_step": {"kernel": "multi_tensor_kernel"},
    "multi_tensor_norm_step": {"partials": "norm_partials_kernel",
                               "update": "norm_update_kernel"},
    "check_finite_and_unscale": {"kernel": "unscale_kernel"}}
# the kernels with a variant that each path launches
SERVING_FAST = ("flash_attention", "layer_norm", "paged_decode_attention",
                "bias_gelu")
TRAINING_FAST = MMA_KERNELS + ("layer_norm", "bias_gelu", "bias_gelu_bwd")


def log(msg):
    print(msg, flush=True)


def mark(what):
    """Log how far into the run ``what`` was reached (the serving phases'
    parts, whose depth a later phase's time is paid from)."""
    log(f"[time] {what}: {time.perf_counter() - START:.1f}s into the run")


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


def require_fast_variants(K, before, what, kernels,
                          fast_variant=FAST_VARIANT):
    """Fail if a launch of a path since the reading ``before`` took
    another kernel of its entry than ``fast_variant``'s (by default the
    16-bit paths': an attention kernel on the CUDA cores or in float32,
    LayerNorm's block per row, paged decode's block per (head, lane), the
    scalar bias-GeLU backward), or if one of ``kernels`` took no launch of
    its fast kernel at all.  Returns the fast launches."""
    after = K.variant_launches()
    took = {}
    for name, counts in after.items():
        fast = fast_variant[name]
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
    tol = {torch.float32: F32_TOL, torch.float16: F16_TOL}.get(
        dtype, BF16_TOL) * scale
    if not math.isfinite(err) or err > tol:
        fail(f"{name}: max|kernel - plain| {err:.3e} > tol {tol:.3e}")
    rec = {"max_abs_err": err, "tol": tol}
    eager = {}
    for key, fn in (("ms", kernel_fn), ("plain_ms", plain_fn),
                    ("library_ms", library_fn)):
        rec[key], eager[key] = (time_ms(torch, fn) if fn is not None
                                else (None, None))
    # float32 attention: the bound on the cores the launch took (the TF32
    # tensor cores at three products a float32 product, or the CUDA
    # cores), and the other cores' bound beside it
    other = ""
    if dtype == torch.float32 and variant is not None \
            and variant[0] in ATTENTION_KERNELS:
        peak, key, other_peak = (
            (PEAK_TF32X3, "bound_simt_ms", PEAK_F32)
            if variant[1] == "tf32x3" else
            (PEAK_F32, "bound_tf32x3_ms", PEAK_TF32X3))
        rec[key], by = bound_ms(n_bytes, n_flops, other_peak)
        other = f" {key}={rec[key]} ({by})"
    rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, n_flops, peak)
    rec["tflops"] = n_flops / rec["ms"] / 1e9
    rec["variant"] = variant[1] if variant is not None else None
    log(f"[kernels] {name}: max_abs_err={err:.3e} tol={tol:.3e} | device "
        f"ms: kernel={rec['ms']} ({rec['tflops']:.2f} TFLOP/s) "
        f"plain={rec['plain_ms']} "
        f"library={rec['library_ms']} bound={rec['bound_ms']} "
        f"({rec['bound_by']}){other} | eager ms: kernel={eager['ms']} "
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
                (2 * R * Fd + Fd) * isz, 5 * R * Fd, PEAK_F32,
                variant=("bias_gelu", "vec"))
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
    tag = {torch.float32: "f32", torch.float16: "f16"}.get(dtype, "bf16")
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
    """The kernel that an attention entry's (the forward's, dq's or
    dk/dv's) aligned operands of ``dtype`` must take: the tensor-core
    kernel in 16 bits, the split-TF32 one in float32."""
    return "tf32x3" if dtype.itemsize == 4 else "mma"



def unaligned_phase(torch, K):
    """bf16 operands one element off a 16-byte boundary: attention (B = 1,
    S = 128, H = 12, D = 64, causal) must take the CUDA-core forward, dq
    and dk/dv (and so must float32 one element off, BERT's non-causal
    B = 8, S = 128: the split-TF32 kernels need 16-byte rows),
    LayerNorm (R = 8192, N = 768) its block-per-row kernel, the
    bias-GeLU forward and backward (R = 8192, F = 3072, and F = 3071
    aligned) their scalar kernels and paged decode (the table's shape) its
    block per (head, lane); all agree with the plain versions like any
    other case."""
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
    B, S = 8, 128
    n = B * S * H * D
    q, k, v, do = (torch.randn(n + 8, generator=g, device="cuda")[
        1:n + 1].view(B, S, H, D) for _ in range(4))
    shape = f"f32 unaligned non-causal B={B} S={S} H={H} D={D}"
    pairs = B * H * S * S
    compare(torch, f"flash_attention {shape}",
            lambda: KF.flash_attention(q, k, v, causal=False)[0],
            lambda: KF.flash_attention_plain(q, k, v, causal=False)[0],
            None, torch.float32, 4 * n * 4 + B * H * S * 4, 4 * D * pairs,
            PEAK_F32, variant=("flash_attention", "simt"))
    o, lse = KF.flash_attention(q, k, v, causal=False)
    delta = KF.flash_attention_delta(o, do)
    compare(torch, f"flash_attention_dq {shape}",
            lambda: KF.flash_attention_dq(q, k, v, do, lse, delta,
                                          causal=False),
            lambda: KF.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                                causal=False),
            None, torch.float32, 5 * n * 4 + 2 * B * H * S * 4,
            6 * D * pairs, PEAK_F32, variant=("flash_attention_dq", "simt"))
    compare(torch, f"flash_attention_dkv {shape}",
            lambda: KF.flash_attention_dkv(q, k, v, do, lse, delta,
                                           causal=False),
            lambda: KF.flash_attention_dkv_plain(q, k, v, do, lse, delta,
                                                 causal=False),
            None, torch.float32, 6 * n * 4 + 2 * B * H * S * 4,
            8 * D * pairs, PEAK_F32, variant=("flash_attention_dkv", "simt"))
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
    # the bias-GeLU forward: the same unaligned x and odd width take its
    # scalar loop
    for shape, (xs, bs) in ((f"unaligned R={R} F={Fd}", (x, b)),
                            (f"R={R} F={Fd - 1}", (x[:, 1:].contiguous(),
                                                   b[1:].contiguous()))):
        compare(torch, f"bias_gelu bf16 {shape}",
                lambda: K.bias_gelu.bias_gelu(xs, bs),
                lambda: K.bias_gelu.bias_gelu_plain(xs, bs),
                lambda: F.gelu(xs + bs), torch.bfloat16,
                (2 * xs.numel() + xs.shape[1]) * 2, 5 * xs.numel(), PEAK_F32,
                variant=("bias_gelu", "scalar"))
    # paged decode: q one element off a 16-byte boundary takes the block
    # per (head, lane)
    paged_case(torch, K, g, torch.bfloat16, "unaligned q",
               (511, 15, 16, 100, 255, 37, 480, -1), ps=16, hd=64,
               variant="lane", q_offset=1)


OPT_RULES = {   # the optimizers the multi-tensor kernel computes
    "sgd": lambda opt, ps, lr, clip: opt.SGD(
        learning_rate=lr, parameters=ps, weight_decay=0.01, grad_clip=clip),
    "momentum": lambda opt, ps, lr, clip: opt.Momentum(
        learning_rate=lr, momentum=0.9, parameters=ps, grad_clip=clip),
    "nesterov": lambda opt, ps, lr, clip: opt.Momentum(
        learning_rate=lr, momentum=0.9, use_nesterov=True, parameters=ps,
        grad_clip=clip),
    "adam": lambda opt, ps, lr, clip: opt.Adam(
        learning_rate=lr, parameters=ps, weight_decay=0.01, grad_clip=clip),
    "adamw": lambda opt, ps, lr, clip: opt.AdamW(
        learning_rate=lr, parameters=ps, weight_decay=0.05, grad_clip=clip),
}


# the float32 operations an element of each rule's update
OPT_OPS_AN_ELEMENT = {"sgd": 2, "momentum": 4, "nesterov": 6, "adam": 15,
                      "adamw": 15, "adagrad": 7, "adamax": 9, "adadelta": 15,
                      "rmsprop": 10, "rmsprop_centered": 15, "ftrl": 18,
                      "lamb": 22, "lars": 10, "dpsgd": 60}


def optimizer_run(torch, kind, dtype, plain, steps=3):
    """``steps`` updates of a GPT-like spread of tensors (an embedding,
    matrices, biases, one element, one view off a 16-byte boundary) by
    step() (the kernel) or step_plain() (the per-parameter loop), from
    seeded values: one parameter without a gradient, a global-norm clip,
    an lr that changes every step and a resume through set_state_dict
    after the second step.  Returns the parameters and the slots."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn as tnn

    g = torch.Generator(device="cuda").manual_seed(31)
    params = [torch.randn(*s, generator=g, device="cuda").to(dtype)
              for s in ((3000, 77), (128, 384), (384,), (1,), (5, 3))]
    buf = torch.randn(4 * 385 + 1, generator=g, device="cuda").to(dtype)
    params = [torch.nn.Parameter(t) for t in params + [buf[1:].view(4, 385)]]

    def make():
        sched = ptt.optimizer.lr.StepDecay(0.01, step_size=1, gamma=0.8)
        return sched, OPT_RULES[kind](ptt.optimizer, params, sched,
                                      tnn.ClipGradByGlobalNorm(5.0))

    sched, opt = make()
    for i in range(steps):
        for j, p in enumerate(params):
            p.grad = None if j == 3 else torch.randn(
                *p.shape, generator=g, device="cuda").to(dtype)
        opt.step_plain() if plain else opt.step()
        opt.clear_grad()
        sched.step()
        if i == 1:                  # the scheduler's state comes along
            state = opt.state_dict()
            sched, opt = make()
            opt.set_state_dict(state)
    torch.cuda.synchronize()
    return params, [list(opt._slots.get(id(p), {}).values()) for p in params]


# the planted fault of the norm rules' check: the loop again at this many
# times the learning rate, i.e. with a trust ratio (Lamb), a local lr
# (LARS) or a step (Dpsgd) 25 % too large, which the check must refuse on
# every tensor; else the steps are too small for it to see an update
NORM_PLANTED = 1.25


def step_rel_errs(torch, got, want, start):
    """For each tensor, ||got - want|| / ||want - start|| in float32: how
    far one run's step lies from another's, relative to that step (inf
    where ``want`` did not move the tensor from ``start``)."""
    out = []
    for a, b, s in zip(got, want, start):
        step = (b.float() - s.float()).norm().item()
        diff = (a.float() - b.float()).norm().item()
        out.append(diff / step if step > 0 else math.inf)
    return out


def optimizer_tree_check(torch, model, steps=3, make=None):
    """``make(parameters)``'s optimizer (by default AdamW(2e-4, wd 0.01))
    on every parameter of ``model``: ``steps`` updates by step() (the
    kernel) on the model's parameters and by step_plain() (the
    per-parameter loop) on copies of them, from the same seeded
    gradients (Dpsgd's loop takes the kernel's noise seed).  Fails unless
    every parameter and slot is bitwise equal, or, for a rule that needs
    per-tensor norms, within the kernel's NORM_RTOL (float32) or
    NORM_BF16_RTOL (16-bit) of the tensor's largest |value| and, for each
    parameter, the kernel's step (p - p0) within the same tolerance of the
    loop's, relative to the loop's step (``step_rel_errs``), while the
    loop at NORM_PLANTED times the lr lies outside it on every parameter
    (so each step is large enough for the check to see it).  Returns the
    kernel's optimizer, the largest |difference| and, for a norm rule,
    {"step_rel_err": the largest, "planted_rel_err": the planted fault's
    smallest} (else None)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops.kernels import optimizer as KO

    if make is None:
        def make(ps):
            return ptt.optimizer.AdamW(learning_rate=2e-4,
                                       weight_decay=0.01, parameters=ps)
    params = list(model.parameters())
    twins = [torch.nn.Parameter(p.detach().clone()) for p in params]
    opt, twin_opt = make(params), make(twins)
    loops = [(twins, twin_opt)]
    norm_rule = opt._kernel_spec()[0] in KO.NORM_KINDS
    if norm_rule:
        start = [p.detach().clone() for p in params]
        planted = [torch.nn.Parameter(p.detach().clone()) for p in params]
        planted_opt = make(planted)
        planted_opt.set_lr(planted_opt.get_lr() * NORM_PLANTED)
        loops.append((planted, planted_opt))
    g = torch.Generator(device="cuda").manual_seed(32)
    for _ in range(steps):
        for p, *qs in zip(params, *(ps for ps, _ in loops)):
            p.grad = (1e-3 * torch.randn(*p.shape, generator=g,
                                         device="cuda")).to(p.dtype)
            for q in qs:
                q.grad = p.grad.clone()
        opt.step()
        for _, loop in loops:
            if isinstance(opt, ptt.optimizer.Dpsgd):
                loop._seed = opt._seed
                ptt.optimizer.Optimizer.step_plain(loop)
            else:
                loop.step_plain()
    pairs = list(zip(params, twins))
    for p, q in zip(params, twins):
        pairs += [(opt._slots[id(p)][n], twin_opt._slots[id(q)][n])
                  for n in opt._slot_names()]
    name = f"{type(opt).__name__} steps of {type(model).__name__}'s " \
        f"{len(params)} tensors"
    bad = [i for i, (a, b) in enumerate(pairs)
           if not (torch.isfinite(a).all() and torch.isfinite(b).all())]
    if bad:
        fail(f"optimizer: {type(opt).__name__} left non-finite values in "
             f"{len(bad)} parameters or slots of {type(model).__name__}")
    err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    rel_steps = None
    if norm_rule:
        tol = KO.NORM_RTOL if params[0].dtype == torch.float32 \
            else KO.NORM_BF16_RTOL
        rel = max(((a.float() - b.float()).abs().max()
                   / b.float().abs().max().clamp_min(1e-30)).item()
                  for a, b in pairs)
        if not rel <= tol:
            fail(f"optimizer: kernel and loop differ by {rel:.3e} of the "
                 f"largest |value| (tol {tol:.3e}) after {steps} {name}")
        got = step_rel_errs(torch, params, twins, start)
        plant = step_rel_errs(torch, planted, twins, start)
        worst = max(range(len(got)), key=got.__getitem__)
        if not got[worst] <= tol:
            fail(f"optimizer: the kernel's step of tensor {worst} differs "
                 f"from the loop's by {got[worst]:.3e} of the loop's step "
                 f"(tol {tol:.3e}; inf: the loop did not move it) after "
                 f"{steps} {name}")
        least = min(range(len(plant)), key=plant.__getitem__)
        if not plant[least] > tol:
            fail(f"optimizer: the loop at {NORM_PLANTED} x the lr differs "
                 f"from the loop's step of tensor {least} by only "
                 f"{plant[least]:.3e} (tol {tol:.3e}) after {steps} "
                 f"{name}: the steps are too small for the check to see "
                 "a wrong update")
        rel_steps = {"step_rel_err": got[worst],
                     "planted_rel_err": plant[least]}
        del planted, planted_opt, start
    ptt.optimizer.Optimizer.plain_cuda_updates = 0
    del twins, twin_opt, loops
    return opt, err, rel_steps


def optimizer_phase(torch, K, cfg):
    """The whole-tree optimizer kernel: bitwise against the per-parameter
    loop after 3 steps (every rule, float32 and bf16, on a small spread of
    tensors; then AdamW on the full bf16 GPT-2-small and BERT-base
    parameter trees, float32 moments); then one AdamW update of the GPT-2
    tree: the kernel's device ms against the loop's (both from a replayed
    CUDA graph) and against its bound, 22 bytes an element; and opt.step()
    under torch.cuda.set_sync_debug_mode("warn"): any sync fails.
    Returns the kernel's record."""
    import warnings

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         GPTForCausalLM)

    Opt = ptt.optimizer.Optimizer
    checked = []
    for kind in OPT_RULES:
        for dtype in (torch.float32, torch.bfloat16):
            Opt.plain_cuda_updates = 0
            before = K.optimizer.multi_tensor_step.launches
            got, got_slots = optimizer_run(torch, kind, dtype, plain=False)
            launches = K.optimizer.multi_tensor_step.launches - before
            if launches != 3 or Opt.plain_cuda_updates != 0:
                fail(f"optimizer {kind}: {launches} kernel launches for 3 "
                     f"steps, {Opt.plain_cuda_updates} loop updates")
            want, want_slots = optimizer_run(torch, kind, dtype, plain=True)
            same = all(torch.equal(a, b) for a, b in zip(got, want)) and all(
                len(a) == len(b) and all(torch.equal(x, y)
                                         for x, y in zip(a, b))
                for a, b in zip(got_slots, want_slots))
            if not same:
                worst = max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(got, want))
                fail(f"optimizer {kind} {dtype}: kernel and loop differ "
                     f"after 3 steps (max |dp| {worst:.3e})")
            checked.append(f"{kind}/{str(dtype)[6:]}")

    bert = BertForPretraining(BertConfig(dropout=0.0), device="cuda",
                              dtype=torch.bfloat16)
    bert_n = len(list(bert.parameters()))
    _, bert_err, _ = optimizer_tree_check(torch, bert)
    del bert
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)
    opt, gpt_err, _ = optimizer_tree_check(torch, model)
    params = list(model.parameters())
    rec = tree_step_record(torch, K, opt, params, 2e-4)
    n, ms, eager_ms = rec["elements"], rec["ms"], rec["eager_ms"]
    plain_ms, plain_eager = rec["plain_ms"], rec["plain_eager_ms"]
    bound, by, n_bytes = rec["bound_ms"], rec["bound_by"], rec["bytes"]
    seen = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            opt.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        seen = [(os.path.basename(w.filename), w.lineno) for w in caught
                if str(w.message).startswith(SYNC_WARNING)]
    if seen:
        fail(f"opt.step() made host syncs: {seen}")
    log(f"[optimizer] multi_tensor_step bitwise equal to the per-parameter "
        f"loop after 3 steps (clip, scheduled lr, a parameter without a "
        f"gradient, resume through set_state_dict, an unaligned view) for "
        f"{checked}; one launch a step, the loop on no CUDA tensor | "
        f"AdamW, 3 steps, bf16 parameters and float32 moments bitwise "
        f"equal to the loop over GPT-2-small's {len(params)} tensors (max "
        f"|d| {gpt_err}) and BERT-base's {bert_n} (max |d| {bert_err}) | "
        f"AdamW over GPT-2-small's {len(params)} tensors, {n} bf16 "
        f"elements, float32 moments: device ms kernel={ms} plain loop="
        f"{plain_ms} bound={bound} ({by}, {n_bytes} bytes) | eager ms "
        f"kernel={eager_ms} plain={plain_eager} | opt.step() under sync "
        f"debug mode: no sync")
    rec = {"max_abs_err": max(gpt_err, bert_err), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": None}
    del model, params, opt
    return rec


def tree_step_record(torch, K, opt, params, lr, library=None):
    """One update of the tree ``params`` in the rule of ``opt`` (slots and
    gradients in place from ``optimizer_tree_check``): the kernel's device
    ms against the loop's (both from a replayed CUDA graph) and its bound:
    each parameter and slot read and written once, each gradient read
    once (22 bytes an element for bf16 parameters and float32 moments).
    ``library(params, grads, slots, lr)``: one PyTorch call that computes
    the same function (``torch._fused_sgd_``, ``torch._fused_adam_``), timed
    on the same tensors, or None."""
    kind, hyper = opt._kernel_spec()
    hyper = opt._kernel_hyper(hyper)
    n = sum(p.numel() for p in params)
    grads = [p.grad for p in params]
    slots = [[opt._slots[id(p)][s] for s in opt._slot_names()]
             for p in params]
    KO = K.optimizer
    step = KO.multi_tensor_norm_step if kind in KO.NORM_KINDS \
        else KO.multi_tensor_step
    # the scalars are written before the timing's capture, as the training
    # engine's prologue writes them before a replay
    scalars = KO.write_scalars(KO.make_scalars("cuda"), kind, lr, 2, hyper)
    kernel = lambda: step(     # noqa: E731
        kind, params, grads, slots, lr, 2, hyper, scalars)
    plain = lambda: KO.multi_tensor_step_plain(   # noqa: E731
        kind, params, grads, slots, lr, 2, hyper)
    ms, eager_ms = time_ms(torch, kernel, iters=5, reps=3)
    plain_ms, plain_eager = time_ms(torch, plain, iters=1, reps=3)
    lib = None if library is None else library_or_none(
        torch, f"{kind} library call",
        lambda: library(params, grads, slots, lr), tag="[optimizer]")
    library_ms = None if lib is None else time_ms(torch, lib, iters=5,
                                                  reps=3)[0]
    n_bytes = tree_bytes(params, slots)
    bound, by = bound_ms(n_bytes, OPT_OPS_AN_ELEMENT[kind] * n, PEAK_F32)
    return {"kind": kind, "elements": n, "tensors": len(params), "ms": ms,
            "eager_ms": eager_ms, "plain_ms": plain_ms,
            "plain_eager_ms": plain_eager, "bound_ms": bound,
            "bound_by": by, "bytes": n_bytes, "library_ms": library_ms}


def fused_sgd(torch, momentum):
    """``torch._fused_sgd_`` as a yardstick of Momentum: v = mu v + g, p -=
    lr v, the velocity in the parameter's dtype (dampening 0)."""
    def call(params, grads, slots, lr):
        torch._fused_sgd_(params, grads, [s[0] for s in slots],
                          weight_decay=0.0, momentum=momentum, lr=lr,
                          dampening=0.0, nesterov=False, maximize=False,
                          is_first_step=False)
    return call


def fused_adam(torch, beta1=0.9, beta2=0.999, eps=1e-8):
    """``torch._fused_adam_`` as a yardstick of Adam over float32 moments
    (its bias corrections from a device step count)."""
    steps = {}

    def call(params, grads, slots, lr):
        if "t" not in steps:
            steps["t"] = [torch.full((), 2.0, device=p.device)
                          for p in params]
        torch._fused_adam_(params, grads, [s[0] for s in slots],
                           [s[1] for s in slots], [], steps["t"], lr=lr,
                           beta1=beta1, beta2=beta2, weight_decay=0.0,
                           eps=eps, amsgrad=False, maximize=False)
    return call


def sdpa_backward(torch, q, k, v, do, dropout_p=0.0):
    """The library yardstick for the attention backward: one call of
    PyTorch's flash-attention backward
    (aten._scaled_dot_product_flash_attention_backward), which computes dq,
    dk and dv together, on the same inputs in its [B, H, S, D] layout,
    from its own forward's output and logsumexp (and dropout's seed and
    offset).  bfloat16 only."""
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    out, lse, cq, ck, mq, mk, seed_t, offset_t = \
        torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, dropout_p, True)[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, out, lse, cq, ck, mq, mk, dropout_p, True, seed_t,
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
                if dtype == torch.bfloat16 else \
                sdpa_masked_backward(torch, q, k, v, do, None, causal=True)
            pairs = B * H * S * (S + 1) // 2
            one = B * S * H * D * isz                 # one [B, S, H, D]
            stats = 2 * B * H * S * 4                 # lse and delta
            shape = f"B={B} S={S} H={H} D={D}"
            rec_q = compare(
                torch, f"flash_attention_dq {tag} {shape}",
                lambda: KF.flash_attention_dq(q, k, v, do, lse, delta),
                lambda: KF.flash_attention_dq_plain(q, k, v, do, lse, delta),
                lib, dtype, 5 * one + stats, 6 * D * pairs, peak,
                variant=("flash_attention_dq",
                         variant_of(dtype)))
            rec_kv = compare(
                torch, f"flash_attention_dkv {tag} {shape}",
                lambda: KF.flash_attention_dkv(q, k, v, do, lse, delta),
                lambda: KF.flash_attention_dkv_plain(q, k, v, do, lse,
                                                     delta),
                lib, dtype, 6 * one + stats, 8 * D * pairs, peak,
                variant=("flash_attention_dkv",
                         variant_of(dtype)))
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


def decode_run(torch, model, prompt, n_steps, feed=None, verify=False):
    """slot_prefill of ``prompt`` then ``n_steps`` slot_decode_paged steps
    of lane 0 (lane 1 inactive) on the model's device (``verify``:
    slot_verify_paged steps of one candidate, the speculative step's first
    position).  Tokens fed after the prefill come from ``feed`` (teacher
    forcing) or greedy argmax.  Returns (list of logits [V] as float32 CPU
    tensors, fed tokens)."""
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
        if verify:
            lg, _, _ = model.slot_verify_paged(
                st["tok"][:, None], st["pos"][:, None], st["active"],
                st["kp"], st["vp"], st["ptab"], geom.max_seq_len)
            lg = lg[:, 0]
        else:
            lg, _, _ = model.slot_decode_paged(
                st["tok"], st["pos"], st["active"], st["kp"], st["vp"],
                st["ptab"], geom.max_seq_len)
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


def trace_window(torch, run, cpu=None, replays=None):
    """run() under torch.profiler: (run's result, wall ms, the trace's
    device events as (ms, name, count)).  ``cpu``: a list that receives
    the host events as (self ms, name, count).  ``replays``: a dict that
    receives the port's launches by CUDA graph replay
    (:func:`replay_launches`).  The card is idle for
    TRACE_EDGE_S at both edges of the window (outside the wall ms): a
    trace closed right after its last kernels can lack their records
    (tools/trace_edge_probe.py: on an H100 80GB HBM3 at 700 W, the last
    two replays of 1 of 14 plain windows of a generate call; none of 14
    windows with idle edges)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_EDGE_S)
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(TRACE_EDGE_S)
    if replays is not None:
        replays.update(replay_launches(prof.profiler.kineto_results.events()))
    events = prof.key_averages()
    if cpu is not None:
        cpu.extend((e.self_cpu_time_total / 1e3, e.key, e.count)
                   for e in events if e.device_type == DeviceType.CPU)
    return out, wall_ms, [(e.self_device_time_total / 1e3, e.key, e.count)
                          for e in events
                          if e.device_type == DeviceType.CUDA
                          and e.self_device_time_total > 0]


def replay_launches(events):
    """The launches of the port's entries (``TRACE_KERNELS``, any variant)
    in a trace's kineto events, by the ``cudaGraphLaunch`` whose
    correlation id a kernel carries: {"per_replay": {entry: [launches in
    each replay, in launch order]}, "outside": {entry: launches outside
    any replay}, "device": [(device events, their summed device ms) of
    each replay]}."""
    from torch.autograd import DeviceType

    entry = {k: n for n, variants in TRACE_KERNELS.items()
             for k in variants.values()}
    pattern = re.compile(r"(?<!\w)(" + "|".join(entry) + r")(?:<|\()")
    graphs = sorted((e.start_ns(), e.correlation_id()) for e in events
                    if e.name() == "cudaGraphLaunch")
    index = {c: i for i, (_, c) in enumerate(graphs)}
    per = {n: [0] * len(graphs) for n in TRACE_KERNELS}
    outside = dict.fromkeys(TRACE_KERNELS, 0)
    device = [[0, 0.0] for _ in graphs]
    for e in events:
        if e.device_type() == DeviceType.CUDA \
                and e.correlation_id() in index:
            d = device[index[e.correlation_id()]]
            d[0] += 1
            d[1] += e.duration_ns() / 1e6
        m = e.device_type() == DeviceType.CUDA and pattern.search(e.name())
        if m:
            name = entry[m.group(1)]
            i = index.get(e.correlation_id())
            if i is None:
                outside[name] += 1
            else:
                per[name][i] += 1
    return {"per_replay": per, "outside": outside,
            "device": [tuple(d) for d in device]}


def traced_launches(kernels, dropped=None):
    """{entry: {variant: launches}} of the port's entries in a trace's
    device events, matched by CUDA kernel name.  ``dropped``: a dict that
    receives, for each attention entry, its launches of the dropout
    instantiation (the kernels' last template argument, kDropout, true)."""
    out = {n: dict.fromkeys(v, 0) for n, v in TRACE_KERNELS.items()}
    for _, key, count in kernels:
        for name, per in TRACE_KERNELS.items():
            for variant, kernel in per.items():
                m = re.search(rf"(?<!\w){kernel}(?:<([^()]*)>|\()", key)
                if not m:
                    continue
                out[name][variant] += count
                if dropped is not None and name in ATTENTION_KERNELS:
                    args = (m.group(1) or "").split(",")
                    dropped[name] = dropped.get(name, 0) + count * (
                        args[-1].strip() == "true")
    return out


def require_traced(kernels, what, expected, dropout=None,
                   fast_variant=FAST_VARIANT):
    """A training window's launches read from its trace (``kernels``, as
    trace_window returns them): fails unless each entry of ``expected``
    launched, no launch took another kernel of its entry than
    ``fast_variant``'s (the 16-bit paths' fast kernels by default) and,
    with ``dropout`` True (False), every attention launch took the dropout
    (the p = 0) instantiation.  Returns ({entry: launches}, {entry: fast
    launches})."""
    dropped = {}
    traced = traced_launches(kernels, dropped)
    counts, fast = {}, {}
    for name, per in traced.items():
        counts[name] = sum(per.values())
        if name in fast_variant:
            slow = {v: n for v, n in per.items()
                    if v != fast_variant[name] and n}
            if slow:
                fail(f"{what}: the trace shows {name} launches of another "
                     f"kernel than {fast_variant[name]}: {per}")
            fast[name] = per[fast_variant[name]]
    for name in expected:
        if counts[name] <= 0:
            fail(f"{what}: the trace holds no launch of {name}")
    if dropout is not None:
        for name in ATTENTION_KERNELS:
            want = counts[name] if dropout else 0
            if dropped.get(name, 0) != want:
                fail(f"{what}: {dropped.get(name, 0)} of the {counts[name]} "
                     f"{name} launches in the trace took the dropout "
                     f"kernel, not {want}")
    return counts, fast


def profile_window(torch, run):
    """run() under torch.profiler: (wall ms, device busy ms, kernel
    launches, the ten kernels that take the most device time, then the
    device-to-host copies' ms and count).  Busy = the sum of kernel times
    over the window (one stream, so kernels do not overlap); None when
    the trace holds no device time."""
    _, wall_ms, kernels = trace_window(torch, run)
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


def profile_wave(torch, eng, prompts, tag="[profile]"):
    """Where a serving wave's time goes: a wave of greedy requests (16 new
    tokens each) under torch.profiler.  Returns (wall ms, busy ms or
    None)."""
    def wave():
        for h in [eng.submit(p, 16) for p in prompts]:
            h.result(600)

    wall_ms, busy_ms, launches, top = profile_window(torch, wave)
    if busy_ms is None:
        log(f"{tag} no device time in the trace: busy share not measured")
        return wall_ms, None
    log(f"{tag} {len(prompts)} greedy requests x 16 tokens: wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.2f}%), {launches} device launches; "
        f"top: {top}")
    return wall_ms, busy_ms


def sync_check(torch, eng, prompts, step_name="step"):
    """Every ``GenerationEngine.step()`` (``step_name``: or its
    ``step_spec()``) of a few requests (greedy and sampled alternating)
    under ``torch.cuda.set_sync_debug_mode("warn")``: a step (the noise
    draw, the graph's replay and the fetch) makes exactly one
    synchronizing call, its copy of the tokens to the host in
    serving/generation.py; any other sync fails the run.  Returns the
    summary for the serving line."""
    import warnings

    step, seen = getattr(eng, step_name), []

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

    setattr(eng, step_name, checked_step)
    try:
        handles = [eng.submit(p, 8, **(dict(do_sample=True, temperature=0.8,
                                            top_k=8, seed=i) if i % 2
                                       else {}))
                   for i, p in enumerate(prompts)]
        for h in handles:
            h.result(600)
    finally:
        delattr(eng, step_name)
    where = {loc for syncs in seen for loc in syncs}
    if not seen or any(len(syncs) != 1 for syncs in seen) \
            or {f for f, _ in where} != {"generation.py"}:
        fail(f"decode steps made other syncs than the token fetch: {seen}")
    return (f"{len(seen)} decode steps under sync debug mode: one sync "
            f"each, at {sorted(where)} (the token fetch)")


def graph_check(eng, what):
    """The captured decode step: captured once, holding paged decode, and
    every launch in it on its entry's fast kernel.  Returns the fast
    launches of one replay."""
    if eng.capture_count != 1:
        fail(f"{what}: the decode step was captured {eng.capture_count} "
             "times")
    if eng.graph_launches.get("paged_decode_attention", 0) <= 0:
        fail(f"{what}: the decode graph holds no paged_decode_attention "
             f"launch: {eng.graph_launches}")
    fast = {}
    for name, counts in eng.graph_variants.items():
        slow = {v: n for v, n in counts.items()
                if v != FAST_VARIANT[name] and n}
        if slow:
            fail(f"{what}: launches in the decode graph took the slower "
                 f"kernel of {name}: {counts}")
        fast[name] = counts[FAST_VARIANT[name]]
    return fast


def serve_wave(eng, prompts, new_tokens, sampled=True):
    """Submit every prompt at once (greedy and sampled alternating) and
    wait for all: (outputs, wall seconds)."""
    t0 = time.perf_counter()
    handles = []
    for i, p in enumerate(prompts):
        kw = (dict(do_sample=True, temperature=0.8, top_k=8, seed=i)
              if sampled and i % 2 else {})
        handles.append(eng.submit(p, new_tokens, **kw))
    outs = [h.result(600) for h in handles]
    return outs, time.perf_counter() - t0


def pages_accounted(eng, what):
    """Idle: every page is on the free list or held by the prefix
    cache."""
    t0 = time.monotonic()
    while eng._sched.occupied or eng._backlog:
        if time.monotonic() - t0 > 60:
            fail(f"{what}: the engine did not go idle")
        time.sleep(0.01)
    free, resident = eng.free_count, eng.resident_pages
    if free + resident != eng.geometry.num_pages:
        fail(f"{what}: free_count {free} + resident_pages {resident} != "
             f"num_pages {eng.geometry.num_pages}")
    return f"free_count {free} + resident_pages {resident} == num_pages"


SERVING_ENGINE = dict(max_slots=8, max_seq_len=512, prompt_buckets="64,128",
                      page_size=16, num_pages=0)


def serving_phase(torch, K, model, card):
    """The reference's default engine (prefix cache on) on full-width
    bf16 GPT-2-small, decode steps replayed from the captured graph."""
    from paddle_tpu_torch.serving import GenerationEngine

    eng = GenerationEngine(model, device=model.device,
                           **SERVING_ENGINE).start()
    try:
        graph_check(eng, "serving")
        prompts = wave_prompts(model.cfg.vocab_size, 2)

        def wave():
            out = serve_wave(eng, prompts, 48)
            wait_idle(eng)
            return out

        K.reset_launch_counts()
        variants = K.variant_launches()
        replays0 = eng.replays
        (outs, wall), _, kernels = trace_window(torch, wave)
        mark("serving: the traced wave")
        replays = eng.replays - replays0
        # the wrappers count the eager launches (prefills); a replay
        # counts nothing, so the path's launches are the trace's, which
        # must be the eager ones plus the graph's once per replay
        eager = K.launch_counts()
        fast = require_fast_variants(
            K, variants, "serving prefill",
            tuple(n for n in SERVING_FAST if n != "paged_decode_attention"))
        traced = traced_launches(kernels)
        counts = dict(eager)
        for name in SERVING_KERNELS:
            per = traced[name]
            counts[name] = sum(per.values())
            want = eager[name] + eng.graph_launches.get(name, 0) * replays
            if counts[name] != want:
                fail(f"serving: the trace holds {counts[name]} launches of "
                     f"{name}, not {eager[name]} eager + "
                     f"{eng.graph_launches.get(name, 0)} x {replays} "
                     f"replays = {want}")
            slow = {v: n for v, n in per.items()
                    if v != FAST_VARIANT[name] and n}
            if slow:
                fail(f"serving: the trace shows {name} launches of its "
                     f"slower kernel: {per}")
            fast[name] = per[FAST_VARIANT[name]]
        snap = eng.metrics.snapshot()
        for i, o in enumerate(outs):
            if len(o) != 48 or min(o) < 0 or max(o) >= model.cfg.vocab_size:
                fail(f"request {i}: {len(o)} tokens, range "
                     f"[{min(o)}, {max(o)}]")
        for name in SERVING_KERNELS:
            if counts[name] <= 0:
                fail(f"kernel {name} was not launched on the serving path")
        accounted = pages_accounted(eng, "serving wave")
        # the wave's first request (greedy, a miss) alone on an engine
        # without the prefix cache, so it takes the wave's path again
        solo = GenerationEngine(model, device=model.device,
                                prefix_cache=False, **SERVING_ENGINE).start()
        try:
            alone = solo.generate(prompts[0], 48, timeout=600)
        finally:
            solo.stop()
        if alone != outs[0]:
            fail("greedy request re-run alone gave different tokens")
        mark("serving: the solo re-run")
        syncs = sync_check(torch, eng, prompts[:4])
        mark("serving: the sync check")
        profile_wave(torch, eng, prompts[:8])
        mark("serving: the profiled wave")
        total = sum(len(o) for o in outs)
        log(f"[serving] 16 requests (prompts 20-128, 48 new tokens, "
            f"greedy/sampled alternating, prefix cache on) on {card}, "
            f"under the profiler: "
            f"{total} tokens in {wall:.3f}s = {total / wall:.1f} tokens/s; "
            f"TTFT p50 {snap['ttft_p50_ms']:.3f} ms; inter-token p50 "
            f"{snap['inter_token_p50_ms']:.3f} ms; decode graph captured "
            f"{eng.capture_count}x, {replays} replays of "
            f"{eng.graph_launches} launches (variants "
            f"{eng.graph_variants}); launches in the trace {counts} (eager "
            f"ones {eager}); tensor-core and vector-kernel launches {fast}; "
            f"greedy re-run alone (no prefix cache) identical; {accounted}; "
            f"{syncs}")
        return counts
    finally:
        eng.stop()


def wait_idle(eng, timeout=60):
    """Until the engine's decode loop is idle.  The loop sets its idle
    event only on a pass that finds no work, and after the last request it
    blocks for the next one first (as the reference's does), so wake it:
    without the wake the wait ran out its whole timeout."""
    eng._wake()
    if not eng._idle.wait(timeout):
        fail(f"the serving engine did not go idle in {timeout}s")


def step_launches(torch, eng, form, n=20):
    """Device launches and busy ms of one idle decode step (the
    all-inactive state, which a step leaves as it was), by the profiler:
    ``form`` "graph" replays the captured step, "eager" issues it op by
    op."""
    run = eng.step if form == "graph" else eng._step_eager
    wait_idle(eng)
    wall_ms, busy_ms, launches, _ = profile_window(
        torch, lambda: [run() for _ in range(n)])
    return launches / n, (busy_ms / n if busy_ms is not None else None)


def wave_prompts(vocab, seed, n=16):
    """``n`` prompts of 20-128 random tokens (the serving wave's), drawn
    from ``seed``: a fresh seed gives prompts no page of which is in the
    prefix cache yet."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, k).tolist()
            for k in rng.randint(20, 129, n)]


def serving_graph_phase(torch, model, card):
    """The decode step replayed from its graph against the same engine
    with ``_step_eager`` swapped in, paired in this run (graph, eager,
    eager, graph), every wave on fresh prompts (all prefix-cache misses,
    as in the serving wave) and the same prompts for both forms: the
    serving wave's tokens/s, TTFT and inter-token p50 (a fresh metrics
    window each), a profiled wave's busy share, and the device launches
    of one decode step."""
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.serving.metrics import GenerationMetrics

    V = model.cfg.vocab_size
    engines = {}
    for form in ("graph", "eager"):
        eng = GenerationEngine(model, device=model.device,
                               **SERVING_ENGINE).start()
        if form == "eager":
            eng.step = eng._step_eager
        serve_wave(eng, wave_prompts(V, 10, 8), 8)      # warm-up
        engines[form] = eng
    try:
        rows, tokens = [], {"graph": [], "eager": []}
        for form in ("graph", "eager", "eager", "graph"):
            eng, rep = engines[form], len(tokens[form])
            eng.metrics = GenerationMetrics(
                max_slots=eng.max_slots, num_pages=eng.geometry.num_pages)
            outs, wall = serve_wave(eng, wave_prompts(V, 20 + rep), 48)
            tokens[form].append(outs)
            snap = eng.metrics.snapshot()
            if snap["prefix_cache_hits"]:
                fail(f"serving-graph {form}: a fresh prompt hit")
            pages_accounted(eng, f"serving-graph {form}")
            wall_p, busy = profile_wave(torch, eng,
                                        wave_prompts(V, 30 + rep, 8),
                                        tag=f"[serving-graph-profile] "
                                            f"{form}")
            mark(f"serving-graph {form}: the wave and its profile")
            per_step, step_busy = step_launches(torch, eng, form)
            mark(f"serving-graph {form}: the idle steps' profile")
            total = sum(len(o) for o in outs)
            rows.append(
                f"{form}: {total / wall:.1f} tokens/s ({total} in "
                f"{wall:.3f}s), TTFT p50 {snap['ttft_p50_ms']:.3f} ms, "
                f"inter-token p50 {snap['inter_token_p50_ms']:.3f} ms, "
                f"profiled wave busy "
                + (f"{busy:.3f} of {wall_p:.3f} ms "
                   f"({100 * busy / wall_p:.2f}%)" if busy is not None
                   else "not measured")
                + f", {per_step:.1f} launches an idle decode step ("
                + (f"{step_busy:.4f} device ms" if step_busy is not None
                   else "device ms not measured") + ")")
        # one model, the same prompts, one seed a sampled request: the
        # graph's tokens are bitwise the eager step's, greedy (even
        # requests) and sampled (odd)
        for rep in range(2):
            a, b = tokens["graph"][rep], tokens["eager"][rep]
            diff = [i for i in range(len(a)) if a[i] != b[i]]
            if diff:
                fail(f"serving-graph: requests {diff} of wave {rep} differ "
                     "between the graph and the eager step")
        if engines["eager"].replays or engines["graph"].capture_count != 1:
            fail("serving-graph: the eager engine replayed or the graph "
                 "engine captured again")
        log(f"[serving-graph] 16 requests (prompts 20-128, 48 new tokens, "
            f"greedy/sampled alternating) on {card}, paired in this run: "
            + "; ".join(rows)
            + "; greedy and sampled tokens of graph and eager identical")
    finally:
        for eng in engines.values():
            eng.stop()


def prefix_phase(torch, model, card):
    """The prefix cache at the reference's defaults: 16 requests whose
    prompts share a 64-token prefix (4 pages of 16) followed by 20-64
    distinct tokens, 48 new tokens each; then TTFT of 8 hits and 8
    misses, one request at a time (a fresh metrics window each); then the
    first-token logits of a hit
    (``slot_prefill_prefix`` over the miss's prefix K/V) against the
    miss's ``slot_prefill``, within BF16_TOL."""
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.serving.metrics import GenerationMetrics

    V = model.cfg.vocab_size
    rng = np.random.RandomState(5)
    shared = rng.randint(0, V, 64).tolist()
    prompts = [shared + rng.randint(0, V, n).tolist()
               for n in rng.randint(20, 65, 16)]
    eng = GenerationEngine(model, device=model.device,
                           **SERVING_ENGINE).start()
    try:
        graph_check(eng, "prefix")
        outs, wall = serve_wave(eng, prompts, 48)
        snap = eng.metrics.snapshot()
        if snap["prefix_cache_hits"] != 15 or snap["prefix_cache_misses"] \
                != 1:
            fail(f"prefix wave: {snap['prefix_cache_hits']} hits, "
                 f"{snap['prefix_cache_misses']} misses (expected 15, 1)")
        if any(len(o) != 48 for o in outs):
            fail("prefix wave: a request did not give 48 tokens")
        ttft = {}
        for kind in ("miss", "hit"):
            ms = []
            for _ in range(8):
                head = shared if kind == "hit" else \
                    rng.randint(0, V, 64).tolist()
                eng.metrics = GenerationMetrics(
                    max_slots=eng.max_slots,
                    num_pages=eng.geometry.num_pages)
                eng.generate(head + rng.randint(0, V, 40).tolist(), 8,
                             timeout=600)
                one = eng.metrics.snapshot()
                if bool(one["prefix_cache_hits"]) != (kind == "hit"):
                    fail(f"prefix TTFT: a {kind} request counted "
                         f"{one['prefix_cache_hits']} hits")
                ms.append(one["ttft_p50_ms"])
            ttft[kind] = float(np.median(ms))
        accounted = pages_accounted(eng, "prefix wave")
        mark("prefix: the wave and the TTFT requests")
    finally:
        eng.stop()
    # first-token logits of a hit against the miss's, bf16
    p = prompts[0]
    L = len(p)
    ids = torch.zeros((1, 128), dtype=torch.long, device=model.device)
    ids[0, :L] = torch.tensor(p)
    k, v, ref = model.slot_prefill(ids, L)
    suf = torch.zeros((1, 64), dtype=torch.long, device=model.device)
    suf[0, :L - 64] = torch.tensor(p[64:])
    _, _, got = model.slot_prefill_prefix(suf, k[:, :64], v[:, :64], 64, L)
    err = (got.float() - ref.float()).abs().max().item()
    tol = BF16_TOL * max(1.0, ref.float().abs().max().item())
    if not math.isfinite(err) or err > tol:
        fail(f"prefix: first-token logits of a hit differ from the miss's "
             f"by {err:.3e} > {tol:.3e}")
    log(f"[prefix] 16 requests sharing a 64-token prefix (+20-64 tokens, "
        f"48 new) on {card}: hit ratio {snap['prefix_cache_hit_ratio']:.4f}"
        f" ({snap['prefix_cache_hits']} hits, "
        f"{snap['prefix_cache_misses']} miss), "
        f"{sum(map(len, outs)) / wall:.1f} tokens/s, wave TTFT p50 "
        f"{snap['ttft_p50_ms']:.3f} ms; one at a time (104 prompt tokens):"
        f" TTFT p50 hit {ttft['hit']:.3f} ms, miss {ttft['miss']:.3f} ms; "
        f"bf16 first-token logits hit vs miss max|d| {err:.3e} (tol "
        f"{tol:.3e}); {accounted}")


def f32_prefix_chunk_phase(torch, model, card):
    """Full-width float32 (summation order is the only difference, so
    greedy tokens are comparable): a prefix hit's greedy tokens equal
    the miss's, and chunked prefill (prompts of 65-128 tokens,
    prefill_chunk=32, buckets 32, 64 and 128) gives the unchunked
    engine's greedy tokens."""
    from paddle_tpu_torch.serving import GenerationEngine

    V = model.cfg.vocab_size
    rng = np.random.RandomState(6)
    kw = dict(max_slots=8, max_seq_len=256, page_size=16, device=model.device)
    eng = GenerationEngine(model, prompt_buckets="64,128", **kw).start()
    try:
        shared = rng.randint(0, V, 64).tolist()
        tails = [rng.randint(0, V, n).tolist() for n in (20, 40, 64)]
        miss = [eng.generate(shared + tails[0], 48, timeout=600)]
        hits = [eng.generate(shared + t, 48, timeout=600) for t in tails]
        snap = eng.metrics.snapshot()
        if snap["prefix_cache_hits"] != 3:
            fail(f"f32 prefix: {snap['prefix_cache_hits']} hits, not 3")
        ref = GenerationEngine(model, prompt_buckets="64,128",
                               prefix_cache=False, **kw).start()
        try:
            cold = [ref.generate(shared + t, 48, timeout=600)
                    for t in tails]
        finally:
            ref.stop()
        if hits[0] != miss[0] or hits != cold:
            fail("f32 prefix: a hit's greedy tokens differ from the miss's")
    finally:
        eng.stop()
    prompts = [rng.randint(0, V, n).tolist()
               for n in rng.randint(65, 129, 8)]
    outs, walls, chunks = {}, {}, 0
    for form, chunk in (("chunked", 32), ("unchunked", 0)):
        e = GenerationEngine(model, prompt_buckets="32,64,128",
                             prefill_chunk=chunk, **kw).start()
        try:
            outs[form], walls[form] = serve_wave(e, prompts, 24,
                                                 sampled=False)
            if form == "chunked":
                chunks = e.metrics.snapshot()["prefill_chunks"]
                graph_check(e, "chunked")
        finally:
            e.stop()
    if outs["chunked"] != outs["unchunked"]:
        fail("chunked prefill: greedy tokens differ from the unchunked "
             "engine's")
    if chunks < sum(-(-len(p) // 32) for p in prompts):
        fail(f"chunked prefill ran {chunks} chunks")
    log(f"[prefix-f32] full-width float32 on {card}: 3 hits on a 64-token "
        f"prefix (+20/40/64 tokens, 48 greedy tokens) identical to the "
        f"miss and to a prefix-free engine")
    log(f"[chunked] full-width float32 on {card}: 8 prompts of "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, 24 "
        f"greedy tokens each, prefill_chunk=32, buckets 32/64/128: "
        f"{chunks} chunks, tokens identical to the unchunked engine's; "
        f"wave {walls['chunked']:.3f}s chunked, {walls['unchunked']:.3f}s "
        f"unchunked")


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
        before = K.variant_launches() if device == "cuda" else None
        t0 = time.perf_counter()
        loss = model.loss(ids.to(device))
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            counts = K.launch_counts()
            f32 = require_fast_variants(K, before, "train-parity",
                                        ATTENTION_KERNELS, F32_FAST)
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
        f"{t_g:.2f}s, cpu {t_c:.2f}s; launches {counts}; of them on the "
        f"float32 kernels (attention tf32x3) {f32}")


def require_optimizer_kernel(counts, opt, steps, what):
    """Every ``opt.step()`` of ``steps`` made one kernel launch for each
    (device, dtype) group of its parameters and left the per-parameter
    loop idle on CUDA tensors; returns the line's text."""
    from paddle_tpu_torch.optimizer import Optimizer

    groups = len({(p.device, p.dtype) for p in opt._parameter_list})
    got = counts["multi_tensor_step"]
    if got != steps * groups or Optimizer.plain_cuda_updates != 0:
        fail(f"{what}: {got} optimizer kernel launches in {steps} steps of "
             f"{groups} dtype group(s); the per-parameter loop updated "
             f"{Optimizer.plain_cuda_updates} CUDA parameters")
    return (f"optimizer kernel {got / steps:g} launch(es) a step "
            f"({groups} dtype group(s)), per-parameter loop on 0 CUDA "
            f"tensors")


def losses_vs(losses, first, last):
    """Fails unless a trajectory's first and last losses are those PERF.md
    records for this seed, to their printed 5 decimals (the update is
    bitwise the per-parameter loop's, so they do not move)."""
    got = (f"{losses[0]:.5f}", f"{losses[-1]:.5f}")
    if got != (first, last):
        fail(f"losses first/last {got[0]}/{got[1]}, PERF.md records "
             f"{first}/{last} for this seed")
    return f"first/last {got[0]}/{got[1]} equal to PERF.md's"


def lm_loss(logits, labels):
    """Next-token cross entropy on the logits, in float32 (the user loss
    of bench.py's GPT Model.fit configuration)."""
    logp = logits[:, :-1].float().log_softmax(-1)
    return -logp.gather(-1, labels[:, 1:, None])[..., 0].mean()


def train_phase(torch, K, cfg, card):
    """Full-width bfloat16 GPT-2-small, B = 8, S = 1024: 10 dygraph AdamW
    steps on one fixed batch (the loop of bench.py's GPT training body),
    a profiled window of 2 more, then 3 Model.fit steps.  Returns the
    launch counts of the 10 dygraph steps and (p50 s, model flops, tokens)
    of a step."""
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
    ptt.optimizer.Optimizer.plain_cuda_updates = 0
    variants = K.variant_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = K.launch_counts()
    fast = require_fast_variants(K, variants, "train", TRAINING_FAST)
    opt_text = require_optimizer_kernel(counts, opt, steps, "train")
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
        f"per step {per_step}; tensor-core and vector-kernel launches "
        f"{fast}; {opt_text}; losses "
        f"{losses_vs(losses, '10.98327', '8.48247')}")

    profile_steps(torch, "train-profile", step)

    data = torch.from_numpy(rs.randint(0, cfg.vocab_size, (3 * B, S)))
    api = ptt.Model(model).prepare(opt, lm_loss)
    # Model.fit replays a captured step, which the wrappers do not count:
    # its launches are read from its trace
    hist, fit_ms, kernels = trace_window(torch, lambda: api.fit(
        ptt.io.TensorDataset([data, data]), batch_size=B, epochs=1,
        shuffle=False, verbose=0, log_freq=1))
    fit_counts, _ = require_traced(kernels, "Model.fit", TRAINING_KERNELS,
                                   dropout=False)
    fit_opt = require_optimizer_kernel(fit_counts, opt, 3,
                                       "Model.fit")
    if len(hist["step_loss"]) != 3 or not all(
            math.isfinite(x) for x in hist["step_loss"]):
        fail(f"Model.fit: step losses {hist['step_loss']}")
    log(f"[fit] Model.fit 3 steps of B={B} S={S} with a loss on the "
        f"logits (1 eager, the capture, 2 replays): step losses "
        f"{hist['step_loss']}; {fit_ms / 1e3:.3f}s under the profiler; "
        f"launches in the trace {fit_counts}; {fit_opt}")
    return counts, (p50, flops, tokens)


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


def sdpa_masked_backward(torch, q, k, v, do, bias, dropout_p=0.0,
                         causal=False):
    """The library yardstick for the masked attention backward (and, in
    float32, for every form: the flash backward takes 16-bit operands
    only): one call of PyTorch's memory-efficient attention backward, on
    the same inputs in its [B, H, S, D] layout, with the bias as it takes
    it (in q's dtype, its key rows padded to a multiple of 16; None: no
    bias), ``causal`` its own causal form, from its own forward (with
    ``dropout_p``, its own dropout)."""
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    B, H, S_q, _ = qt.shape
    S_k = kt.shape[2]
    lib_bias = None
    if bias is not None:
        sp = -(-S_k // 16) * 16
        lib_bias = torch.zeros(B, H, S_q, sp, dtype=q.dtype,
                               device=q.device)[..., :S_k]
        lib_bias.copy_(bias)
    out, lse, seed_t, offset_t = \
        torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, lib_bias, True, dropout_p, causal)
    # with dropout, the backward reads the forward's Philox seed and offset
    # from host tensors when it runs eagerly and from device memory while a
    # CUDA graph captures it (time_ms does both)
    rng = {False: (seed_t, offset_t),
           True: (seed_t.cuda(), offset_t.cuda())}
    return lambda: \
        torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            dot, qt, kt, vt, lib_bias, out, lse,
            *rng[torch.cuda.is_current_stream_capturing()], dropout_p,
            [True, True, True, False], causal)


def masked_attention_phase(torch, K):
    """The non-causal and masked forms of the three attention kernels
    against their plain versions: BERT-base's shape (B = 32, S = 128,
    H = 12, D = 64), non-causal without a mask and with its [B, 1, 1, S]
    bool padding mask (seeded lengths 64-128), and B = 4, S = 77 causal
    with an additive [B, 1, S, S] mask; float32 and bfloat16.  The library
    yardstick is scaled_dot_product_attention with the same mask,
    forward, and its memory-efficient backward (both dtypes).  Returns the
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
            lib_bwd = sdpa_masked_backward(torch, q, k, v, do, lib_mask)
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
                peak, variant=("flash_attention_dq",
                               variant_of(dtype)))
            rec["flash_attention_dkv"] = compare(
                torch, f"flash_attention_dkv {desc}",
                lambda: KF.flash_attention_dkv(q, k, v, do, lse, delta,
                                               **fkw),
                lambda: KF.flash_attention_dkv_plain(q, k, v, do, lse,
                                                     delta, **fkw),
                lib_bwd, dtype, 6 * one + stats + bias_bytes, 8 * D * pairs,
                peak, variant=("flash_attention_dkv",
                               variant_of(dtype)))
            if dtype == torch.bfloat16 and form == "bool-padding":
                main = rec
            if dtype == torch.float32 and form == "non-causal":
                names = sdpa_kernel_names(
                    torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
                log(f"[kernels] SDPA float32 {form} B={B} S={S}: {names}")
                # the float32 backward's yardstick, by name
                names = sdpa_kernel_names(torch, lib_bwd)
                log(f"[kernels] memory-efficient attention backward float32 "
                    f"{form} B={B} S={S}: {names}")
    torch.cuda.synchronize()
    return main


def sdpa_kernel_names(torch, fn):
    """The device kernels one call of ``fn`` launches (from a profile),
    and the GEMM operator that the installed memory-efficient attention
    header names for float on sm_80 and later."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    header = (pathlib.Path(torch.__file__).parent / "include/ATen/native/"
              "transformers/cuda/mem_eff_attention/gemm_kernel_utils.h")
    m = header.exists() and re.search(
        r"struct DefaultGemmType<\s*ArchTag,\s*float,.*?"
        r"using Operator = ([\w:]+);", header.read_text(), re.S)
    return (f"kernels {names}; {header.name} DefaultGemmType<ArchTag, "
            f"float> Operator = {m.group(1) if m else 'not found'}")


def dropout_mask_phase(torch, K):
    """Attention dropout's keep mask: the kernels' own device function
    (through its test entry) bitwise against dropout_keep_plain at GPT's
    and BERT's training shapes, its keep rate within 4 sigma of 1 - p;
    then the forward applies exactly that mask on each of its kernels: with
    V's row t the one-hot e_t (S = D = 64), O's non-zero pattern is the
    set of kept (query, key) pairs."""
    KF = K.flash_attention
    p, H = DROPOUT_P, 12
    for what, B, S in (("GPT", 8, 1024), ("BERT", 32, 128)):
        got = KF.dropout_keep(DROPOUT_SEED, B, H, S, p, "cuda")
        want = KF.dropout_keep_plain(DROPOUT_SEED, B, H, S, p, "cuda")
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"dropout mask {what}: the kernels' mask differs from "
                 f"dropout_keep_plain at {int((got != want).sum())} of "
                 f"{got.numel()} pairs")
        n = got.numel()
        rate = int(got.sum()) / n
        sigma = math.sqrt(p * (1 - p) / n)
        if abs(rate - (1 - p)) > 4 * sigma:
            fail(f"dropout mask {what}: keep rate {rate} is "
                 f"{abs(rate - (1 - p)) / sigma:.2f} sigma from {1 - p}")
        log(f"[dropout-mask] {what} B={B} H={H} S={S} p={p} seed="
            f"{DROPOUT_SEED:#x}: the kernels' mask bitwise equal to "
            f"dropout_keep_plain over {n} pairs; keep rate {rate:.7f} "
            f"(1 - p = {1 - p}, {abs(rate - (1 - p)) / sigma:.2f} sigma); "
            f"effective p {KF.dropout_threshold(p) / 65536}")
        del got, want
    B, S, H, D = 2, 64, 12, 64
    n = B * S * H * D
    g = torch.Generator(device="cuda").manual_seed(12)
    keep = KF.dropout_keep_plain(DROPOUT_SEED, B, H, S, p, "cuda")
    for dtype, offset, variant in ((torch.bfloat16, 0, "mma"),
                                   (torch.bfloat16, 1, "simt"),
                                   (torch.float32, 0, "tf32x3"),
                                   (torch.float32, 1, "simt")):
        q, k, v = ((0.3 * torch.randn(n + 8, generator=g, device="cuda")).to(
            dtype)[offset:offset + n].view(B, S, H, D) for _ in range(3))
        v.copy_(torch.eye(S, dtype=dtype, device="cuda")[None, :, None, :]
                .expand(B, S, H, D))
        before = K.variant_launches()
        out, _ = KF.flash_attention(q, k, v, causal=False, dropout_p=p,
                                    seed=DROPOUT_SEED)
        torch.cuda.synchronize()
        took = variant_taken(before, K.variant_launches(), "flash_attention")
        if took != variant:
            fail(f"dropout one-hot V {dtype} offset {offset}: the launch "
                 f"took the {took} kernel, not {variant}")
        kept = out.permute(0, 2, 1, 3) != 0
        if not torch.equal(kept, keep):
            fail(f"dropout one-hot V [{took}] {dtype}: O's non-zero pattern "
                 f"differs from the plain mask at "
                 f"{int((kept != keep).sum())} pairs")
        log(f"[dropout-mask] one-hot V, B={B} S={S} H={H} D={D}, "
            f"{str(dtype)[6:]} offset {offset} [{took}]: O's non-zero "
            f"pattern equals the plain mask at all {keep.numel()} pairs "
            f"({int(keep.sum())} kept)")


def dropout_kernel_phase(torch, K):
    """Forward, dq and dk/dv with dropout p = 0.1 against their plain
    versions with the same seed, bf16 on the tensor-core kernels, at GPT's
    causal training shape (B = 8, S = 1024) and BERT's padding-mask one
    (B = 32, S = 128, seeded lengths 64-128): device ms at p = 0.1 beside
    the same kernel at p = 0, and scaled_dot_product_attention with the
    same dropout (forward; its flash / memory-efficient backward) as the
    library yardstick.  The bound is the p = 0 one: the same products and
    bytes.  Returns {kernel: {"gpt_causal": rec, "bert_padding_mask":
    rec}}."""
    F = torch.nn.functional
    KF = K.flash_attention
    g = torch.Generator(device="cuda").manual_seed(13)
    H, D, p = 12, 64, DROPOUT_P
    recs = {name: {} for name in ATTENTION_KERNELS}
    for form, B, S in (("gpt_causal", 8, 1024),
                       ("bert_padding_mask", 32, 128)):
        q, k, v = torch.randn(B, S, 3, H, D, generator=g,
                              device="cuda").bfloat16().unbind(2)
        do = torch.randn(B, S, H, D, generator=g, device="cuda").bfloat16()
        causal = form == "gpt_causal"
        bias, lib_mask, bias_bytes = None, None, 0
        pairs = B * H * S * (S + 1) // 2
        if not causal:
            lens = torch.randint(64, S + 1, (B,), generator=g, device="cuda")
            bias = KF.fold_mask((torch.arange(S, device="cuda")[None, :]
                                 < lens[:, None])[:, None, None, :],
                                B, H, S, S)
            lib_mask = bias.to(torch.bfloat16)
            pairs, bias_bytes = H * S * int(lens.sum()), B * S * 4
        plain_kw = dict(causal=causal, bias=bias)
        kw = dict(plain_kw, dropout_p=p, seed=DROPOUT_SEED)
        o, lse = KF.flash_attention(q, k, v, **kw)
        delta = KF.flash_attention_delta(o, do)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_bwd = sdpa_backward(torch, q, k, v, do, p) if causal else \
            sdpa_masked_backward(torch, q, k, v, do, bias, p)
        one, stats = B * S * H * D * 2, 2 * B * H * S * 4
        desc = f"bf16 {form} dropout p={p} B={B} S={S} H={H} D={D}"
        calls = {
            "flash_attention": (
                lambda **a: KF.flash_attention(q, k, v, **a)[0],
                lambda: KF.flash_attention_plain(q, k, v, **kw)[0],
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=lib_mask, dropout_p=p,
                    is_causal=causal),
                4 * one + B * H * S * 4, 4 * D * pairs),
            "flash_attention_dq": (
                lambda **a: KF.flash_attention_dq(q, k, v, do, lse, delta,
                                                  **a),
                lambda: KF.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                                    **kw),
                lib_bwd, 5 * one + stats, 6 * D * pairs),
            "flash_attention_dkv": (
                lambda **a: KF.flash_attention_dkv(q, k, v, do, lse, delta,
                                                   **a),
                lambda: KF.flash_attention_dkv_plain(q, k, v, do, lse,
                                                     delta, **kw),
                lib_bwd, 6 * one + stats, 8 * D * pairs)}
        for name, (kernel, plain, lib, n_bytes, flops) in calls.items():
            rec = compare(torch, f"{name} {desc}", lambda: kernel(**kw),
                          plain, lib, torch.bfloat16, n_bytes + bias_bytes,
                          flops, PEAK_BF16_TENSOR, variant=(name, "mma"))
            rec["ms_p0"] = time_ms(torch, lambda: kernel(**plain_kw))[0]
            log(f"[kernels] {name} {desc}: device ms with dropout "
                f"{rec['ms']} against p=0 {rec['ms_p0']} (x"
                f"{rec['ms'] / rec['ms_p0']:.3f}); SDPA with dropout "
                f"{rec['library_ms']}; bound {rec['bound_ms']} "
                f"({rec['bound_by']})")
            recs[name][form] = rec
        del q, k, v, do, o, lse, delta
    torch.cuda.synchronize()
    return recs


def dropout_train_run(torch, K, tag, model, batches, fit_data, fit_batch,
                      fit_loss, lr, labels=None):
    """10 dygraph AdamW(lr, wd 0.01) steps of ``model`` (its loss from
    ``batches()``), a profiled window of 2 more (``[tag]`` line), then 3
    Model.fit steps over the tensors ``fit_data`` in batches of
    ``fit_batch`` with ``fit_loss``.  Returns (10 losses, step seconds,
    fit step losses, dygraph launch counts, dropout launch counts,
    fast-kernel launches, optimizer text)."""
    import paddle_tpu_torch as ptt

    opt = ptt.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                              parameters=model.parameters())
    KF = K.flash_attention
    K.reset_launch_counts()
    ptt.optimizer.Optimizer.plain_cuda_updates = 0
    variants = K.variant_launches()
    def step():
        loss = batches()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    losses, times = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts, dropped = K.launch_counts(), KF.dropout_launches()
    fast = require_fast_variants(K, variants, "dropout-train", TRAINING_FAST)
    opt_text = require_optimizer_kernel(counts, opt, 10, "dropout-train")
    profile_steps(torch, tag, step)
    api = ptt.Model(model, labels=labels).prepare(opt, fit_loss)
    hist, _, kernels = trace_window(torch, lambda: api.fit(
        ptt.io.TensorDataset(fit_data), batch_size=fit_batch, epochs=1,
        shuffle=False, verbose=0, log_freq=1))
    # the trace's attention launches all took the dropout kernels
    fit_counts, _ = require_traced(kernels, "dropout Model.fit",
                                   ATTENTION_KERNELS, dropout=True)
    require_optimizer_kernel(fit_counts, opt, 3, "dropout Model.fit")
    for name in ATTENTION_KERNELS:
        if dropped[name] != counts[name]:
            fail(f"dropout-train: {name} made {dropped[name]} of its "
                 f"{counts[name]} launches with dropout")
    return (torch.stack(losses).float().cpu().tolist(), times,
            hist["step_loss"], counts, dropped, fast, opt_text)


def dropout_train_phase(torch, K, card, dropout0):
    """GPT-2-small and BERT-base at their published configs (GPTConfig(),
    BertConfig(): attention and hidden dropout 0.1), full width and depth,
    bf16: GPT on the train phase's batch (B = 8, S = 1024), BERT on
    padded batches with their [B, 1, 1, S] bool mask (B = 32, S = 128),
    each 10 dygraph steps and 3 Model.fit steps, twice from the same
    paddle_tpu_torch.seed.  Fails unless every loss is finite, the 10
    steps fall, the two runs agree bitwise and every attention launch of
    the path took the dropout kernels (tensor cores); each run also
    profiles 2 steps.  ``dropout0``: the
    dropout-0 phases' (p50 s, flops a step, tokens a step) for the line.
    Returns {model: dropout launch counts of the 10 steps}."""
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         GPTConfig, GPTForCausalLM)

    out = {}
    for name in ("gpt", "bert"):
        runs = []
        for _ in range(2):
            release(torch, f"dropout-train {name}")
            seed(0)
            if name == "gpt":
                cfg = GPTConfig()
                B, S, lr = 8, 1024, 2e-4
                model = GPTForCausalLM(cfg, device="cuda",
                                       dtype=torch.bfloat16).train()
                rs = np.random.RandomState(4)
                ids = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                                  (B, S))).cuda()
                data = torch.from_numpy(rs.randint(0, cfg.vocab_size,
                                                   (3 * B, S)))
                run = dropout_train_run(
                    torch, K, "dropout-gpt-profile", model,
                    lambda: model.loss(ids), [data, data], B, lm_loss, lr)
            else:
                cfg = BertConfig()
                B, S, lr = 32, 128, 1e-4
                model = BertForPretraining(cfg, device="cuda",
                                           dtype=torch.bfloat16).train()
                rs = np.random.RandomState(7)
                ids, tt, mlm, nsp = (t.cuda() for t in
                                     bert_batch(torch, rs, cfg, B, S))
                mask = padding_mask(torch, rs, B, S)[0].cuda()
                data = bert_batch(torch, rs, cfg, 3 * B, S)
                fit_mask = padding_mask(torch, rs, 3 * B, S)[0]
                run = dropout_train_run(
                    torch, K, "dropout-bert-profile", model,
                    lambda: bert_fit_loss(*model(ids, tt, mask), mlm, nsp),
                    [data[0], data[1], fit_mask, data[2], data[3]], B,
                    bert_fit_loss, lr, labels=["mlm_labels", "nsp_labels"])
            n_params = sum(p.numel() for p in model.parameters())
            runs.append(run)
            del model
        (losses, times, fit_losses, counts, dropped, fast, opt_text), \
            second = runs
        every = losses + list(fit_losses)
        if not all(math.isfinite(x) for x in every) \
                or losses[-1] >= losses[0]:
            fail(f"dropout-train {name}: losses {losses}, Model.fit "
                 f"{fit_losses}")
        if every != second[0] + list(second[2]):
            fail(f"dropout-train {name}: two runs from one seed differ: "
                 f"{every} / {second[0] + list(second[2])}")
        p50 = float(np.median(times))
        p50_0, flops, tokens = dropout0[name]
        log(f"[dropout-train] {name} bf16 default config (dropout "
            f"{cfg.dropout}, attention dropout "
            f"{getattr(cfg, 'attn_dropout', cfg.dropout)}) B={B} S={S}, "
            f"{n_params} parameters, AdamW({lr}, wd 0.01) on {card}: "
            f"losses {losses}; Model.fit step losses {list(fit_losses)}; "
            f"second run from the same seed bitwise equal; step ms "
            f"{[round(t * 1e3, 3) for t in times]}; p50 {p50 * 1e3:.3f} ms "
            f"(dropout 0: {p50_0 * 1e3:.3f}); {tokens / p50:.1f} tokens/s "
            f"(dropout 0: {tokens / p50_0:.1f}); {mfu_text(flops, p50)} "
            f"(dropout 0: {flops / p50_0 / PEAK_BF16_TENSOR:.4f}); "
            f"attention launches with dropout per step "
            f"{ {n: c / 10 for n, c in dropped.items()} }; tensor-core and "
            f"vector-kernel launches {fast}; {opt_text}")
        out[name] = dropped
    return out


TRAIN_GRAPH_STEPS = 12


def train_graph_run(torch, name, dropout, form):
    """One run of the training engine at a default config from seed 0,
    full width and depth, bf16: ``TRAIN_GRAPH_STEPS`` Model.fit steps (log
    every step, so each step's time ends at its drain) through the
    captured step (``form`` "graph") or through ``_step_eager`` swapped
    in ("eager"), then 2 more under the profiler and (graph) 4 more under
    torch.cuda.set_sync_debug_mode("warn") with one drain at the end (the
    graph's replays must make no other sync).
    GPT: GPTConfig() with hidden and attention dropout ``dropout``, B = 8,
    S = 1024, its fused LM-head loss computed in the network (``loss``);
    BERT: BertConfig(), B = 32, S = 128, padded batches with their bool
    mask, the MLM and NSP losses through F.cross_entropy.  Returns a
    dict of what the phase checks and prints."""
    import warnings

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.hapi.engine import TrainEngine
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         GPTConfig, GPTForCausalLM)

    n = TRAIN_GRAPH_STEPS + 6
    seed(0)
    if name == "gpt":
        cfg = GPTConfig(dropout=dropout, attn_dropout=dropout)
        B, S, lr = 8, 1024, 2e-4
        model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)

        class LMLoss(torch.nn.Module):      # the network computes its loss
            def __init__(self):
                super().__init__()
                self.model = model

            def forward(self, ids):
                return self.model.loss(ids)

        net, labels, loss = LMLoss(), None, (lambda x: x)
        rs = np.random.RandomState(4)
        data = [torch.from_numpy(rs.randint(0, cfg.vocab_size, (n * B, S)))]
    else:
        cfg = BertConfig()
        B, S, lr = 32, 128, 1e-4
        model = net = BertForPretraining(cfg, device="cuda",
                                         dtype=torch.bfloat16)
        labels, loss = ["mlm_labels", "nsp_labels"], bert_fit_loss
        rs = np.random.RandomState(7)
        ids, tt, mlm, nsp = bert_batch(torch, rs, cfg, n * B, S)
        data = [ids, tt, padding_mask(torch, rs, n * B, S)[0], mlm, nsp]
    n_params = sum(p.numel() for p in model.parameters())
    opt = ptt.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                              parameters=model.parameters())
    api = ptt.Model(net, labels=labels).prepare(opt, loss)
    engine = api._engine = TrainEngine(api)
    if form == "eager":
        engine.step = engine._step_eager
    # the host's time in each step() call and (graph) in each replay
    # call, cudaGraphLaunch, without the profiler
    step, capture, step_ms, replay_ms = engine.step, engine._capture, [], []

    def timed(fn, into):
        def run(*args):
            t = time.perf_counter()
            out = fn(*args)
            into.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    def timed_capture(*args):
        g = capture(*args)
        g.replay = timed(g.replay, replay_ms)
        return g

    engine.step, engine._capture = timed(step, step_ms), timed_capture
    drain, stamps = engine.drain, []

    def stamped():
        out = drain()
        stamps.append(time.perf_counter())
        return out

    engine.drain = stamped

    def fit(lo, hi, log_freq):
        return api.fit(ptt.io.TensorDataset([t[lo * B:hi * B] for t in data]),
                       batch_size=B, shuffle=False, verbose=0,
                       log_freq=log_freq)["step_loss"]

    t0 = time.perf_counter()
    losses = fit(0, TRAIN_GRAPH_STEPS, 1)
    times = np.diff([t0] + stamps[:TRAIN_GRAPH_STEPS]) * 1e3
    # unprofiled host ms a step after the first (graph: all replays)
    host_step = float(np.median(step_ms[1:TRAIN_GRAPH_STEPS]))
    host_replay = float(np.median(replay_ms[:TRAIN_GRAPH_STEPS - 1])) \
        if replay_ms else None
    host = []
    losses2, wall_ms, kernels = trace_window(
        torch, lambda: fit(TRAIN_GRAPH_STEPS, TRAIN_GRAPH_STEPS + 2, 1),
        cpu=host)
    host.sort(reverse=True)
    # the host's share of a step that no profiler event holds: the
    # DataLoader's indexing and collation of one batch
    t1 = time.perf_counter()
    for _ in ptt.io.DataLoader(ptt.io.TensorDataset([t[:4 * B] for t in data]),
                               batch_size=B):
        pass
    collate_ms = (time.perf_counter() - t1) * 1e3 / 4
    expected = TRAINING_KERNELS + (XENT_KERNELS if name == "bert" else ())
    counts, fast = require_traced(kernels, f"train-graph {name} {form}",
                                  expected, dropout=dropout > 0)
    opt_text = require_optimizer_kernel(counts, opt, 2,
                                        f"train-graph {name} {form}")
    # device events of the window, kernels and copies (as profile_window
    # counts them)
    busy = sum(t for t, _, _ in kernels)
    launches = sum(c for _, _, c in kernels)
    copies = {key: c for _, key, c in kernels if key.startswith("Mem")}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            losses2 += fit(TRAIN_GRAPH_STEPS + 2, n, 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [(os.path.basename(w.filename), w.lineno) for w in caught
             if str(w.message).startswith(SYNC_WARNING)]
    graph_launches = list(engine.graph_launches.values())
    if form == "graph":
        if len(syncs) != 1 or syncs[0][0] != "engine.py":
            fail(f"train-graph {name}: 4 replayed steps and one drain made "
                 f"the syncs {syncs}, not the drain's one")
        if engine.captures != 1 or engine.replays != n - 1:
            fail(f"train-graph {name}: {engine.captures} captures and "
                 f"{engine.replays} replays in {n} steps of one signature")
        # the 2 profiled steps are replays: each entry's launches in the
        # trace are its launches at the capture x 2, less what the trace
        # drops at the window's start (never a whole step's)
        for key in expected + ("multi_tensor_step",):
            c = graph_launches[0].get(key, 0)
            if not c <= counts[key] <= 2 * c:
                fail(f"train-graph {name}: {counts[key]} {key} launches in "
                     f"the trace of 2 replays, {c} at the capture")
    every = losses + losses2
    if not all(math.isfinite(x) for x in every):
        fail(f"train-graph {name} {form}: losses {every}")
    tokens = B * S
    flops = 6.0 * n_params * tokens \
        + cfg.num_layers * 12 * S * S * cfg.hidden_size * B
    out = dict(losses=every, times=times, p50=float(np.median(times[1:])),
               tokens=tokens, flops=flops, busy=busy, wall=wall_ms,
               launches=launches / 2, counts={k: v / 2 for k, v in
                                              counts.items() if v},
               copies=copies, host=host[:8], collate_ms=collate_ms,
               fast=fast, opt_text=opt_text,
               syncs=syncs, host_step=host_step, host_replay=host_replay,
               captures=engine.captures, graph_launches=graph_launches,
               n_params=n_params, B=B, S=S)
    del engine, api, opt, net, model, data
    return out


FIT_F32_STEPS = 8       # unprofiled Model.fit steps a run of [fit-f32]


def fit_f32_run(torch):
    """One run of Model.fit's captured step on GPTForCausalLM(GPTConfig())
    in float32, its default dtype, at full width and depth with the
    published dropout 0.1 (hidden and attention), B = 8, S = 1024, AdamW,
    from paddle_tpu_torch.seed(0): ``FIT_F32_STEPS`` steps with a drain
    each (each step's time ends at its loss), then 2 under the profiler.
    Returns what the phase checks and prints."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.hapi.engine import TrainEngine
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    n = FIT_F32_STEPS + 2
    seed(0)
    cfg = GPTConfig()
    B, S = 8, 1024
    model = GPTForCausalLM(cfg, device="cuda")
    if {p.dtype for p in model.parameters()} != {torch.float32}:
        fail("fit-f32: GPTForCausalLM(GPTConfig()) is not float32")

    class LMLoss(torch.nn.Module):      # the network computes its loss
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, ids):
            return self.model.loss(ids)

    rs = np.random.RandomState(4)
    data = torch.from_numpy(rs.randint(0, cfg.vocab_size, (n * B, S)))
    n_params = sum(p.numel() for p in model.parameters())
    opt = ptt.optimizer.AdamW(learning_rate=2e-4, weight_decay=0.01,
                              parameters=model.parameters())
    api = ptt.Model(LMLoss()).prepare(opt, lambda x: x)
    engine = api._engine = TrainEngine(api)
    drain, stamps = engine.drain, []

    def stamped():
        out = drain()
        stamps.append(time.perf_counter())
        return out

    engine.drain = stamped

    def fit(lo, hi):
        return api.fit(ptt.io.TensorDataset([data[lo * B:hi * B]]),
                       batch_size=B, shuffle=False, verbose=0,
                       log_freq=1)["step_loss"]

    t0 = time.perf_counter()
    losses = fit(0, FIT_F32_STEPS)
    times = np.diff([t0] + stamps[:FIT_F32_STEPS]) * 1e3
    losses2, wall_ms, kernels = trace_window(
        torch, lambda: fit(FIT_F32_STEPS, n))
    counts, _ = require_traced(kernels, "fit-f32", TRAINING_KERNELS,
                               dropout=True, fast_variant=F32_FAST)
    opt_text = require_optimizer_kernel(counts, opt, 2, "fit-f32")
    # each attention kernel's device ms a step: its mean launch in the
    # trace times its launches at the capture (the trace may drop a launch
    # at the window's start, never a whole step's)
    graph_launches = list(engine.graph_launches.values())
    by_name = {}
    for name in ATTENTION_KERNELS:
        kernel = TRACE_KERNELS[name]["tf32x3"]
        hits = [(ms, c) for ms, key, c in kernels
                if re.search(rf"(?<!\w){kernel}(?:<|\()", key)]
        ms, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
        by_name[name] = ms / max(n, 1) * graph_launches[0].get(name, 0)
    out = dict(losses=losses + losses2, times=times,
               p50=float(np.median(times[1:])), wall=wall_ms,
               busy=sum(ms for ms, _, _ in kernels),
               traced={k: counts[k] for k in ATTENTION_KERNELS},
               graph_launches=graph_launches,
               captures=engine.captures, replays=engine.replays,
               device_ms=by_name, opt_text=opt_text, n_params=n_params,
               tokens=B * S, layers=cfg.num_layers,
               flops=6.0 * n_params * B * S
               + cfg.num_layers * 12 * S * S * cfg.hidden_size * B)
    del engine, api, opt, model, data
    return out


def fit_f32_phase(torch, K, card):
    """[fit-f32]: GPT-2-small trained in float32 (its default dtype)
    through Model.fit's captured step at full width and depth with dropout
    0.1, B = 8, S = 1024, twice from one seed (``fit_f32_run``).  Fails
    unless the losses are finite, falling and bitwise equal in both runs,
    each run captured its step once and replayed it, every attention
    forward, dq and dk/dv launch in the trace took the split-TF32 kernel
    with dropout, 12 of each a captured step (the trace of 2 replays holds
    12 to 24: it may drop a launch at its start), and the optimizer
    launched once a step.  Prints step p50, tokens/s, the busy share, the
    device ms a step of dq + dk/dv (each kernel's mean launch in the trace
    times its 12) and their share of the step, and MFU against the CUDA
    cores' float32 peak (the step's GEMMs run there: TF32 is off)."""
    runs = []
    for i in range(2):
        release(torch, f"fit-f32 run {i + 1}")
        K.reset_launch_counts()
        runs.append(fit_f32_run(torch))
    r = runs[0]
    if r["losses"] != runs[1]["losses"]:
        fail(f"fit-f32: the second run's losses {runs[1]['losses']} differ "
             f"from the first's {r['losses']}")
    if not all(math.isfinite(x) for x in r["losses"]) \
            or not r["losses"][-1] < r["losses"][0]:
        fail(f"fit-f32: losses {r['losses']} are not finite and falling")
    n = FIT_F32_STEPS + 2
    for run in runs:
        if run["captures"] != 1 or run["replays"] != n - 1:
            fail(f"fit-f32: {run['captures']} captures and "
                 f"{run['replays']} replays in {n} steps of one signature")
        # the 2 profiled steps are replays: each kernel's launches in the
        # trace are its launches at the capture x 2, less what the trace
        # drops at the window's start (never a whole step's)
        at_capture = run["graph_launches"][0]
        for name in ATTENTION_KERNELS:
            c = at_capture.get(name)
            if c != r["layers"] or not c <= run["traced"][name] <= 2 * c:
                fail(f"fit-f32: {name} launched {c} times in the captured "
                     f"step (not {r['layers']}) or {run['traced'][name]} "
                     f"in the trace of 2 replays")
    p50 = r["p50"]
    step_device = r["busy"] / 2
    bwd = r["device_ms"]["flash_attention_dq"] \
        + r["device_ms"]["flash_attention_dkv"]
    log(f"[fit-f32] GPT-2-small float32 (GPTConfig(), dropout 0.1) B=8 "
        f"S=1024, {r['n_params']} parameters, Model.fit's captured step on "
        f"{card}: losses bitwise equal in 2 runs from seed 0, falling: "
        f"{r['losses']}; captures 1, replays {r['replays']}; step ms "
        f"{np.round(r['times'], 3).tolist()} p50 {p50:.3f} ms, "
        f"{r['tokens'] / p50 * 1e3:.1f} tokens/s, MFU "
        f"{r['flops'] / (p50 / 1e3) / PEAK_F32:.4f} against the CUDA cores' "
        f"float32 peak ({r['flops']:.4e} flops/step / {p50:.3f} ms / "
        f"{PEAK_F32:.3g} FLOP/s); 2 profiled steps: busy {r['busy']:.3f} of "
        f"{r['wall']:.3f} ms ({100 * r['busy'] / r['wall']:.2f}%); device ms "
        f"a step: {step_device:.3f}, of it dq "
        f"{r['device_ms']['flash_attention_dq']:.3f} + dk/dv "
        f"{r['device_ms']['flash_attention_dkv']:.3f} = {bwd:.3f} "
        f"({100 * bwd / step_device:.2f}% of the device ms, "
        f"{100 * bwd / p50:.2f}% of p50), forward "
        f"{r['device_ms']['flash_attention']:.3f}; launches on tf32x3 with "
        f"dropout: {r['layers']} of each a captured step, in the trace of "
        f"2 replays {r['traced']}; {r['opt_text']}")
    return r


def train_graph_phase(torch, K, card):
    """The training engine's captured step against its eager step, at
    full width and depth, bf16: GPTConfig() at its dropout 0.1 and at 0,
    BertConfig() at its 0.1, each run four times from one seed in the
    order graph, eager, eager, graph (``train_graph_run``).  Fails unless
    the losses of all four runs are bitwise equal, the graph runs captured
    once (one signature), made no host sync in replayed steps but the
    drain's, and every launch in the traces took its fast kernel (and the
    dropout kernels exactly when dropout > 0), with one optimizer launch a
    step.  Prints step p50 (each step's wall time up to its loss's
    drain), tokens/s, MFU, the busy share and launches a step of the 2
    profiled steps, the host's unprofiled ms in step() and in the graph's
    replay call, and p50 less the device ms a step (the unprofiled idle).
    Returns {model: each entry's launches a step in the trace of the first
    graph run's 2 profiled replays} of the default configs."""
    out = {}
    for name, dropout in (("gpt", DROPOUT_P), ("gpt", 0.0),
                          ("bert", DROPOUT_P)):
        runs = []
        for form in ("graph", "eager", "eager", "graph"):
            release(torch, f"train-graph {name} {dropout} {form}")
            K.reset_launch_counts()
            runs.append(train_graph_run(torch, name, dropout, form))
            if any(K.launch_counts()[k] <= 0 for k in TRAINING_KERNELS):
                fail(f"train-graph {name}: a training kernel's wrapper was "
                     f"never called: {K.launch_counts()}")
        first = runs[0]["losses"]
        for r, form in zip(runs[1:], ("eager", "eager", "graph")):
            if r["losses"] != first:
                fail(f"train-graph {name} dropout {dropout}: the {form} "
                     f"run's losses {r['losses']} differ from the first "
                     f"graph run's {first}")
        r0 = runs[0]
        text = []
        for i, (r, form) in enumerate(zip(runs, ("graph", "eager", "eager",
                                                 "graph"))):
            busy = (f"{r['busy']:.3f} of {r['wall']:.3f} ms "
                    f"({100 * r['busy'] / r['wall']:.2f}%)")
            replay = "" if r["host_replay"] is None else \
                f", in the replay call {r['host_replay']:.3f}"
            host = (f"unprofiled host ms a step: in step() "
                    f"{r['host_step']:.3f}{replay}; p50 less device ms a "
                    f"step {r['p50'] - r['busy'] / 2:.3f}")
            text.append(
                f"{form} run {i + 1}: step ms {np.round(r['times'], 3).tolist()}"
                f" p50 {r['p50']:.3f} ms, {r['tokens'] / r['p50'] * 1e3:.1f} "
                f"tokens/s, {mfu_text(r['flops'], r['p50'] / 1e3)}; 2 "
                f"profiled steps: busy {busy}, {r['launches']:g} kernel "
                f"launches a step, copies {r['copies']}; {host}; DataLoader "
                f"{r['collate_ms']:.3f} ms a batch; host self ms: "
                + ", ".join(f"{key} {ms:.3f} x{n}"
                            for ms, key, n in r["host"]))
        g = runs[0]
        log(f"[train-graph] {name} bf16 default config"
            f"{'' if dropout else ' at dropout 0'} (dropout {dropout}) "
            f"B={g['B']} S={g['S']}, {g['n_params']} parameters, Model.fit "
            f"on {card}: losses bitwise equal in the 4 runs (graph, eager, "
            f"eager, graph): {first}; captures {g['captures']} (one "
            f"signature), graph launches {g['graph_launches']}; replayed "
            f"steps under sync debug: one sync, the drain at {g['syncs']} "
            f"(eager steps: {runs[1]['syncs']}); "
            f"trace launches a step {g['counts']}, fast kernels {g['fast']};"
            f" {g['opt_text']} | " + " | ".join(text))
        if dropout:
            out[name] = r0["counts"]
    return out


FIT_API_STEPS = 8      # steps an epoch of [fit-api]
FIT_API_EVAL = 4       # eval batches
EVAL_KERNELS = ("layer_norm", "bias_gelu", "flash_attention", "softmax_xent")
# what autograd says when an AccumulateGrad node of another stream takes a
# gradient (the graph warm-up's hazard); main() makes it an error
ACCUMULATE_WARNING = "The AccumulateGrad node's stream does not match"


def fit_api_phase(torch, K, card):
    """Model.fit's user surface on full-width BERT-base (BertConfig(),
    bf16, dropout 0.1, B = 32, S = 128, padded batches with their
    [B, 1, 1, S] mask): a dygraph step whose loss stays alive, then
    Model(net, labels=["mlm_labels", "nsp_labels"]).prepare(AdamW, loss,
    metrics=[NSP accuracy]).fit(2 epochs x FIT_API_STEPS, eval_data of
    FIT_API_EVAL batches, eval_freq=1, save_dir, save_freq=1, callbacks
    [EarlyStopping(monitor="eval_loss"), VisualDL]), then a fresh model's
    load(final) and predict.  Fails unless: the eval graph's losses and
    logits are bitwise the eager _eval's; its launches in a profiler
    trace of FIT_API_EVAL replays equal graph_launches x replays, every
    one on its fast kernel and without dropout; the NSP accuracy of fit's
    epoch logs equals one recomputed from the fetched logits with
    np.argsort(-pred); predict after load is bitwise the trained model's
    and the loaded slots and step count are the trained ones; the
    .pdparams/.pdopt files exist for each epoch and final and
    scalars.jsonl has a line a step.  Prints the eval graph's p50 a batch
    against the eager _eval's, the train graph's p50 a step with the
    metric (and its per-step fetch) against a run without metric or user
    callback (log_freq=1, as [train-graph]), save and load times and file
    sizes, and the eval graph's first capture.  Returns each kernel
    wrapper's launches in fit (counted from just before it: the train
    step's warm-up and capture, the eval step's first batch and capture;
    a replay runs no wrapper) and the eval graph's launches a replay."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.hapi.callbacks import (Callback, EarlyStopping,
                                                 VisualDL)
    from paddle_tpu_torch.hapi.engine import EvalEngine, TrainEngine
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    cfg = BertConfig()
    B, S, n = 32, 128, FIT_API_STEPS
    rs = np.random.RandomState(17)
    rows = (n + FIT_API_EVAL) * B
    ids, tt, mlm, nsp = bert_batch(torch, rs, cfg, rows, S)
    data = [ids, tt, padding_mask(torch, rs, rows, S)[0], mlm, nsp]
    train = ptt.io.TensorDataset([t[:n * B] for t in data])
    evals = [t[n * B:] for t in data]
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "fit-api")
    shutil.rmtree(root, ignore_errors=True)

    class NspAccuracy(ptt.metric.Accuracy):
        """Accuracy of the NSP head (the model's second output)."""

        def compute(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels):
            return super().compute(nsp_logits, nsp_labels)

    class Record(Callback):
        """The time at each train batch's end and the epoch logs."""

        def __init__(self):
            super().__init__()
            self.stamps, self.epochs = [], []

        def on_epoch_begin(self, epoch, logs=None):
            self.stamps.append([])

        def on_train_batch_end(self, step, logs=None):
            self.stamps[-1].append(time.perf_counter())

        def on_epoch_end(self, epoch, logs=None):
            self.epochs.append(dict(logs))

    def model_of(net, metrics):
        opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                  parameters=net.parameters())
        return ptt.Model(net, labels=["mlm_labels", "nsp_labels"]).prepare(
            opt, bert_fit_loss, metrics=metrics)

    seed(0)
    net = BertForPretraining(cfg, device="cuda", dtype=torch.bfloat16)
    api = model_of(net, [NspAccuracy(name="nsp_acc")])
    # the C2 hazard: an earlier dygraph step's loss, kept alive, holds the
    # parameters' AccumulateGrad nodes of the default stream
    dev_batch = [t[:B].cuda() for t in data]
    kept = bert_fit_loss(*net(*dev_batch[:3]), *dev_batch[3:])
    kept.backward()
    api._optimizer.clear_grad()
    engine = api._engine = TrainEngine(api)
    nsp_seen = []                      # (NSP logits, labels) of each step
    step = engine.step

    def recording(inputs, labels):
        outs = step(inputs, labels)
        nsp_seen.append((outs[1].detach().clone(), labels[1]))
        return outs

    engine.step = recording
    evaluator = api._eval_engine = EvalEngine(api)
    capture, first = evaluator._capture, evaluator._first_step
    eval_first = {}

    def timed(fn, key):
        def run(*args):
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            # the first signature's (fit's evaluation), not predict's
            eval_first.setdefault(key, (time.perf_counter() - t) * 1e3)
            return out
        return run

    evaluator._capture = timed(capture, "capture")
    evaluator._first_step = timed(first, "first")
    rec = Record()
    K.reset_launch_counts()         # fit's own launches, from here
    t0 = time.perf_counter()
    hist = api.fit(train, eval_data=ptt.io.TensorDataset(evals),
                   batch_size=B, epochs=2, eval_freq=1, log_freq=4,
                   save_dir=os.path.join(root, "ckpt"), save_freq=1,
                   verbose=0, callbacks=[EarlyStopping(monitor="eval_loss"),
                                         VisualDL(os.path.join(root, "vdl")),
                                         rec])
    fit_s = time.perf_counter() - t0
    fit_counts = K.launch_counts()
    for name in BERT_KERNELS + ("multi_tensor_step",):
        if fit_counts[name] <= 0:
            fail(f"fit-api: {name} was never launched: {fit_counts}")
    engine.step = step
    del kept
    losses = hist["step_loss"] + hist["eval_loss"]
    if len(hist["step_loss"]) != 2 * n or not all(map(math.isfinite,
                                                       losses)):
        fail(f"fit-api: fit's losses {hist}")
    if engine.captures != 1 or evaluator.captures != 1:
        fail(f"fit-api: {engine.captures} train and {evaluator.captures} "
             "eval captures, not one each")
    # the metric: fit's epoch values against np.argsort(-pred)
    preds = [(p.float().cpu().numpy(), y.numpy()) for p, y in nsp_seen]
    for e, logs in enumerate(rec.epochs):
        part = preds[e * n:(e + 1) * n]
        right = sum(int((np.argsort(-p, axis=-1)[:, 0] == y).sum())
                    for p, y in part)
        want = right / sum(len(y) for _, y in part)
        if logs["nsp_acc"] != want:
            fail(f"fit-api: epoch {e} NSP accuracy {logs['nsp_acc']} from "
                 f"fit's logs, {want} from the fetched logits")
    step_ms = [1e3 * b for ep in rec.stamps for b in np.diff(ep)]
    # the eval graph against the eager _eval, on the trained weights
    batches = [[t[i * B:(i + 1) * B] for t in evals]
               for i in range(FIT_API_EVAL)]
    evaluator.begin()
    g_out = [tuple(t.clone() for t in evaluator.step(b[:3], b[3:]))
             for b in batches]
    g_loss = evaluator.drain()
    e_out, e_loss = [], []
    for b in batches:
        outs, loss = api._eval(b[:3], b[3:])
        e_out.append(outs)
        e_loss.append(loss.float())
    e_loss = torch.stack(e_loss).cpu().tolist()
    if g_loss != e_loss or not all(torch.equal(a, b) for g, e in zip(
            g_out, e_out) for a, b in zip(g, e)):
        fail(f"fit-api: eval graph losses {g_loss} against eager {e_loss}, "
             "or their logits, differ")
    # its launches, read from a trace of FIT_API_EVAL replays
    (sig, per_replay), = evaluator.graph_launches.items()

    def replays():
        warm = torch.zeros(1, device="cuda")
        for _ in range(200):        # the trace's start, before the replays
            warm.add_(1)
        for b in batches:
            evaluator.step(b[:3], b[3:])
        return evaluator.drain()

    evaluator.begin()
    _, _, kernels = trace_window(torch, replays)
    counts, fast = require_traced(kernels, "fit-api eval graph",
                                  EVAL_KERNELS, dropout=False)
    want = {k: c * FIT_API_EVAL for k, c in per_replay.items()}
    got = {k: c for k, c in counts.items() if c}
    if got != want:
        fail(f"fit-api: the eval graph's trace holds {got} launches, "
             f"graph_launches x {FIT_API_EVAL} replays is {want}")

    def p50_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            for b in batches:
                t = time.perf_counter()
                fn(b)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    evaluator.begin()
    graph_ms = p50_ms(lambda b: evaluator.step(b[:3], b[3:]))
    eager_ms = p50_ms(lambda b: api._eval(b[:3], b[3:]))
    evaluator.drain()
    # files, then save / load / predict
    files = {}
    for tag in ("0", "1", "final"):
        for ext in (".pdparams", ".pdopt"):
            path = os.path.join(root, "ckpt", tag + ext)
            if not os.path.exists(path):
                fail(f"fit-api: {path} was not written")
            files[tag + ext] = os.path.getsize(path)
    with open(os.path.join(root, "vdl", "scalars.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    if len(lines) != 2 * n or any("nsp_acc" not in x for x in lines):
        fail(f"fit-api: scalars.jsonl holds {len(lines)} lines, not one a "
             f"step ({2 * n}) with the metric")
    t = time.perf_counter()
    api.save(os.path.join(root, "timed"))
    save_s = time.perf_counter() - t
    seed(1)
    fresh = model_of(BertForPretraining(cfg, device="cuda",
                                        dtype=torch.bfloat16),
                     [NspAccuracy(name="nsp_acc")])
    torch.cuda.synchronize()
    t = time.perf_counter()
    fresh.load(os.path.join(root, "ckpt", "final"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    pred_data = ptt.io.TensorDataset(evals)
    mine = api.predict(pred_data, batch_size=B)
    theirs = fresh.predict(pred_data, batch_size=B)
    opt, fopt = api._optimizer, fresh._optimizer
    slots_same = fopt._step_count == opt._step_count and all(
        torch.equal(fopt._slots[id(q)][k], v)
        for p, q in zip(net.parameters(), fresh.network.parameters())
        for k, v in opt._slots[id(p)].items())
    if len(mine) != FIT_API_EVAL or not slots_same or not all(
            torch.equal(a, b) for m, t_ in zip(mine, theirs)
            for a, b in zip(m, t_)):
        fail("fit-api: predict after load differs from the trained "
             "model's, or the loaded slots or step count do")
    del fresh, mine, theirs, g_out, e_out
    # the train graph a step without the metric and user callbacks (the
    # trained network, a fresh optimizer and engine)
    plain = model_of(net, None)
    plain_engine = plain._engine = TrainEngine(plain)
    drain, stamps = plain_engine.drain, []

    def stamped():
        out = drain()
        stamps.append(time.perf_counter())
        return out

    plain_engine.drain = stamped
    plain.fit(train, batch_size=B, shuffle=False, verbose=0, log_freq=1)
    plain_ms = np.diff(stamps[:n]) * 1e3
    metric_p50 = float(np.median(step_ms))
    plain_p50 = float(np.median(plain_ms))
    shutil.rmtree(root, ignore_errors=True)
    log(f"[fit-api] BertConfig() bf16 B={B} S={S} on {card}: fit 2 epochs x "
        f"{n} steps + eval of {FIT_API_EVAL} batches each in {fit_s:.2f}s "
        f"(a dygraph step's loss kept alive: no AccumulateGrad warning); "
        f"losses {hist['step_loss']}, eval_loss {hist['eval_loss']}; "
        f"nsp_acc {[float(e['nsp_acc']) for e in rec.epochs]} = "
        f"np.argsort(-pred) "
        f"of the fetched logits; train graph p50 with the metric (one "
        f"fetch a step) {metric_p50:.3f} ms (steps {np.round(step_ms, 3).tolist()}) "
        f"against {plain_p50:.3f} ms without metric or user callback, "
        f"log_freq=1 (steps {np.round(plain_ms, 3).tolist()})")
    log(f"[fit-api] eval graph bitwise the eager _eval over "
        f"{FIT_API_EVAL} batches (losses {g_loss}); p50 a batch {graph_ms:.3f} "
        f"ms against eager {eager_ms:.3f} ms ({eager_ms / graph_ms:.2f}x); "
        f"first batch of the signature {eval_first['first']:.1f} ms, of it "
        f"the capture {eval_first['capture']:.1f} ms; launches a replay "
        f"{per_replay}, in the trace of {FIT_API_EVAL} replays {got} (fast "
        f"{fast})")
    log(f"[fit-api] save {save_s * 1e3:.1f} ms, load into a fresh model "
        f"{load_s * 1e3:.1f} ms; files (bytes) {files}; predict after load "
        f"bitwise the trained model's, slots and step count equal; "
        f"scalars.jsonl {len(lines)} lines; launches in fit (train warm-up "
        f"and capture, eval first batch and capture) {fit_counts}")
    return fit_counts, per_replay


# nn.Transformer()'s defaults, Transformer-base (Vaswani et al., 2017,
# Table 3), with the shared source-target vocabulary of the paper's WMT14
# en-de BPE (37,000 tokens, section 5.1)
S2S = dict(vocab=37000, d_model=512, nhead=8, layers=6, ffn=2048,
           dropout=0.1)
S2S_B, S2S_SRC, S2S_TGT = 48, 72, 64   # ~3.1 k target tokens a batch
S2S_PAD, S2S_BOS, S2S_IGNORE = 0, 1, -100
S2S_BATCHES, S2S_EPOCHS = 4, 3         # fit: 12 steps over 4 batches
S2S_EVAL = 2                           # eval batches
S2S_DECODE = (8, 32)                   # sources, new tokens
S2S_KERNELS = ("layer_norm",) + ATTENTION_KERNELS + XENT_KERNELS


def sinusoid(n, d):
    """Sinusoidal positions (Vaswani et al., 2017, section 3.5), float32
    [n, d]."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    rate = np.power(10000.0, -np.arange(0, d, 2, dtype=np.float64) / d)
    pe = np.zeros((n, d))
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos * rate), np.cos(pos * rate)
    return pe.astype(np.float32)


def seq2seq_model(torch, device, dtype=None, tgt_len=S2S_TGT, **kw):
    """Transformer-base as a user of ``nn.Transformer`` trains it (neither
    package has a seq2seq model class): ``nn.Transformer`` at its
    defaults (``S2S``, overridable by ``kw``), one Embedding shared by
    source, target and the pre-softmax projection (logits = h E^T),
    scaled by sqrt(d_model), sinusoidal positions and dropout.  The
    source's padding mask is built from the ids in the forward, the
    subsequent mask once on ``device`` as a buffer: a mask made on the
    host and moved inside the captured step would copy from pageable
    memory.  Weights come from the framework generator on the CPU, so a
    seed gives the same model on any device."""
    from paddle_tpu_torch import nn

    cfg = dict(S2S, **kw)
    d = cfg["d_model"]

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(
                cfg["vocab"], d,
                weight_attr=nn.initializer.Normal(0.0, d ** -0.5))
            self.transformer = nn.Transformer(
                d, cfg["nhead"], cfg["layers"], cfg["layers"], cfg["ffn"],
                cfg["dropout"])
            self.dropout = nn.Dropout(cfg["dropout"])

        def embed(self, ids, start=0):
            x = self.embedding(ids) * math.sqrt(d) \
                + self.pos[start:start + ids.shape[1]]
            return self.dropout(x)

        def logits(self, h):
            return torch.matmul(h, self.embedding.weight.t())

        def forward(self, src, tgt):
            mask = (src != S2S_PAD)[:, None, None, :]
            n = tgt.shape[1]
            h = self.transformer(self.embed(src), self.embed(tgt), mask,
                                 self.tgt_mask[:n, :n], mask)
            return self.logits(h)

    model = Seq2Seq().to(device=device, dtype=dtype)
    model.register_buffer("pos", torch.from_numpy(sinusoid(256, d)).to(
        device=device, dtype=model.embedding.weight.dtype), persistent=False)
    model.register_buffer("tgt_mask", nn.Transformer
                          .generate_square_subsequent_mask(tgt_len, device),
                          persistent=False)
    return model


def s2s_batches(torch, rs, n, vocab=S2S["vocab"]):
    """``n`` sentence pairs: source lengths 16-72 padded to 72, target
    16-64 padded to 64 (``S2S_PAD``); the decoder's input is BOS and the
    target but its last token, the labels the target, -100 at its pads.
    int64 [n, 72], [n, 64], [n, 64] on the CPU."""
    src_len = rs.randint(16, S2S_SRC + 1, n)
    tgt_len = rs.randint(16, S2S_TGT + 1, n)
    src = np.where(np.arange(S2S_SRC)[None] < src_len[:, None],
                   rs.randint(2, vocab, (n, S2S_SRC)), S2S_PAD)
    words = rs.randint(2, vocab, (n, S2S_TGT))
    inside = np.arange(S2S_TGT)[None] < tgt_len[:, None]
    labels = np.where(inside, words, S2S_IGNORE)
    tgt_in = np.concatenate([np.full((n, 1), S2S_BOS), words[:, :-1]], 1)
    tgt_in = np.where(inside, tgt_in, S2S_PAD)
    return [torch.from_numpy(a.astype(np.int64))
            for a in (src, tgt_in, labels)]


def s2s_loss(logits, labels):
    """The token-level cross entropy through the softmax cross-entropy
    kernels (hard labels, -100 at the target's pads), summed over the
    target's tokens in float32 and divided by their count (a bf16 sum of
    3,072 losses would round the loss to about 0.06)."""
    from paddle_tpu_torch.nn import functional as PF

    tokens = PF.cross_entropy(logits, labels, reduction="none")
    return tokens.float().sum() / (labels != S2S_IGNORE).sum()


def s2s_flops(cfg=S2S, B=S2S_B, S_src=S2S_SRC, S_tgt=S2S_TGT):
    """Model flops of one training step: 6 x matmul parameters x the
    tokens each sees (the encoder's and the cross-attention's K/V
    projections the source tokens, the rest of the decoder the target
    tokens), 12 B H S_q S_k D an attention layer (forward and backward),
    and 6 T d V for the logits against the shared embedding."""
    d, f, L, H = cfg["d_model"], cfg["ffn"], cfg["layers"], cfg["nhead"]
    hd = d // H
    enc = L * (4 * d * d + 2 * d * f)
    cross_kv = L * 2 * d * d
    dec = L * (6 * d * d + 2 * d * f)
    src_tok, tgt_tok = B * S_src, B * S_tgt
    matmul = 6 * ((enc + cross_kv) * src_tok + dec * tgt_tok)
    attention = 12 * B * H * hd * L * (S_src * S_src + S_tgt * S_tgt
                                       + S_tgt * S_src)
    return matmul + attention + 6 * tgt_tok * d * cfg["vocab"]


def seq2seq_kernel_phase(torch, K):
    """The cross form of the three attention kernels against their plain
    versions at the path's cross-attention shape (B = 48, H = 8, S_q = 64
    queries over S_k = 72 keys, D = 64) with the source's padding mask
    (seeded lengths 16-72): bf16 (tensor cores) and float32 (split-TF32
    tensor cores), p = 0 and 0.1, causal off and on (top-left); the
    dropout mask at that shape bitwise ``dropout_keep_plain``'s; then the
    decode step's forward (S_q = 1 over S_k = 32 and 72, B = 8).  The library yardstick is
    scaled_dot_product_attention with the same mask (and dropout),
    forward, and its memory-efficient backward (both dtypes).  Then the
    path's other kernels at its shapes (``seq2seq_row_kernels``).  Returns
    (the attention records of the training form, bf16 p = 0.1 non-causal,
    the other kernels' records)."""
    F = torch.nn.functional
    KF = K.flash_attention
    g = torch.Generator(device="cuda").manual_seed(21)
    B, H, S_q, S_k, D = S2S_B, S2S["nhead"], S2S_TGT, S2S_SRC, 64
    lens = torch.randint(16, S_k + 1, (B,), generator=g, device="cuda")
    keys = torch.arange(S_k, device="cuda")
    pad = (keys[None, :] < lens[:, None])[:, None, None, :]
    bias = KF.fold_mask(pad, B, H, S_q, S_k)
    got = KF.dropout_keep(DROPOUT_SEED, B, H, S_q, DROPOUT_P, "cuda",
                          S_k=S_k)
    want = KF.dropout_keep_plain(DROPOUT_SEED, B, H, S_q, DROPOUT_P, "cuda",
                                 S_k=S_k)
    if not torch.equal(got, want):
        fail(f"seq2seq dropout mask: the kernels' [B, H, {S_q}, {S_k}] mask "
             f"differs from dropout_keep_plain at "
             f"{int((got != want).sum())} pairs")
    log(f"[seq2seq] dropout mask B={B} H={H} S_q={S_q} S_k={S_k} "
        f"p={DROPOUT_P}: the kernels' mask bitwise dropout_keep_plain's "
        f"over {got.numel()} pairs")
    main = {}
    upper = torch.ones(S_q, S_k, dtype=torch.bool, device="cuda").triu(1)
    for dtype in (torch.bfloat16, torch.float32):
        tag = "f32" if dtype == torch.float32 else "bf16"
        isz = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16_TENSOR
        q, do = (torch.randn(B, S_q, H, D, generator=g, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, S_k, H, D, generator=g, device="cuda")
                .to(dtype) for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        nq, nk = B * S_q * H * D * isz, B * S_k * H * D * isz
        stats, bias_bytes = 2 * B * H * S_q * 4, B * S_k * 4
        for p in (0.0, DROPOUT_P):
            for causal in (False, True):
                visible = (keys[None, None, :] < lens[:, None, None]
                           ).expand(B, S_q, S_k)
                if causal:
                    visible = visible & ~upper
                pairs = H * int(visible.sum())
                kw = dict(causal=causal, bias=bias, dropout_p=p,
                          seed=DROPOUT_SEED)
                o, lse = KF.flash_attention(q, k, v, **kw)
                delta = KF.flash_attention_delta(o, do)
                lib_mask = bias.to(dtype)
                if causal:
                    lib_mask = lib_mask.masked_fill(upper, float("-inf"))
                lib_bwd = sdpa_masked_backward(torch, q, k, v, do, lib_mask,
                                               p)
                desc = (f"{tag} cross {'causal ' if causal else ''}padding "
                        f"p={p} B={B} H={H} S_q={S_q} S_k={S_k} D={D}")
                rec = {"flash_attention": compare(
                    torch, f"flash_attention {desc}",
                    lambda: KF.flash_attention(q, k, v, **kw)[0],
                    lambda: KF.flash_attention_plain(q, k, v, **kw)[0],
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=lib_mask, dropout_p=p), dtype,
                    2 * nq + 2 * nk + B * H * S_q * 4 + bias_bytes,
                    4 * D * pairs, peak,
                    variant=("flash_attention", variant_of(dtype)))}
                rec["flash_attention_dq"] = compare(
                    torch, f"flash_attention_dq {desc}",
                    lambda: KF.flash_attention_dq(q, k, v, do, lse, delta,
                                                  **kw),
                    lambda: KF.flash_attention_dq_plain(q, k, v, do, lse,
                                                        delta, **kw),
                    lib_bwd, dtype, 3 * nq + 2 * nk + stats + bias_bytes,
                    6 * D * pairs, peak,
                    variant=("flash_attention_dq",
                             variant_of(dtype)))
                rec["flash_attention_dkv"] = compare(
                    torch, f"flash_attention_dkv {desc}",
                    lambda: KF.flash_attention_dkv(q, k, v, do, lse, delta,
                                                   **kw),
                    lambda: KF.flash_attention_dkv_plain(q, k, v, do, lse,
                                                         delta, **kw),
                    lib_bwd, dtype, 2 * nq + 4 * nk + stats + bias_bytes,
                    8 * D * pairs, peak,
                    variant=("flash_attention_dkv",
                             variant_of(dtype)))
                if dtype == torch.bfloat16 and p > 0 and not causal:
                    main = rec
        # the decode step: one query over the cache, under no_grad
        for n_keys in (32, S_k):
            q1 = torch.randn(8, 1, H, D, generator=g, device="cuda").to(dtype)
            k1, v1 = k[:8, :n_keys], v[:8, :n_keys]
            b1 = KF.fold_mask(pad[:8, ..., :n_keys], 8, H, 1, n_keys)
            lib1 = b1.to(dtype)
            compare(torch, f"flash_attention {tag} decode S_q=1 "
                    f"S_k={n_keys} B=8 H={H} D={D} padding",
                    lambda: KF.flash_attention(q1, k1, v1, False, b1)[0],
                    lambda: KF.flash_attention_plain(q1, k1, v1, False,
                                                     b1)[0],
                    lambda: F.scaled_dot_product_attention(
                        q1.transpose(1, 2), k1.transpose(1, 2),
                        v1.transpose(1, 2), attn_mask=lib1), dtype,
                    2 * 8 * H * D * isz + 2 * 8 * n_keys * H * D * isz
                    + 8 * H * 4 + 8 * n_keys * 4,
                    4 * D * H * int(pad[:8, 0, 0, :n_keys].sum()), peak,
                    variant=("flash_attention", variant_of(dtype)))
    torch.cuda.synchronize()
    return main, seq2seq_row_kernels(torch, K)


def seq2seq_row_kernels(torch, K):
    """The path's other kernels against their plain versions at its
    shapes, in bf16: LayerNorm (the warp kernel) over the encoder's
    48 x 72 rows and the decoder's 48 x 64 at width 512; softmax_xent
    forward and backward over the 3,072 target rows of a seeded batch
    (-100 at its pads, whose gradient rows must be exactly 0) at V =
    37,000; and multi_tensor_step in the path's Adam form (beta2 0.98,
    eps 1e-9, no weight decay) over Transformer-base's bf16 tree, bitwise
    the per-parameter loop after 3 steps.  Returns {name: record},
    LayerNorm's under "layer_norm" (encoder) and "layer_norm_decoder"."""
    import paddle_tpu_torch as ptt

    F = torch.nn.functional
    SX = K.softmax_xent
    g = torch.Generator(device="cuda").manual_seed(22)
    dt = torch.bfloat16
    d, V = S2S["d_model"], S2S["vocab"]
    recs = {}
    for key, R in (("layer_norm", S2S_B * S2S_SRC),
                   ("layer_norm_decoder", S2S_B * S2S_TGT)):
        x = torch.randn(R, d, generator=g, device="cuda").to(dt)
        w = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dt)
        b = (0.1 * torch.randn(d, generator=g, device="cuda")).to(dt)
        recs[key] = compare(
            torch, f"layer_norm bf16 seq2seq R={R} N={d}",
            lambda: K.layer_norm.layer_norm(x, w, b, 1e-5),
            lambda: K.layer_norm.layer_norm_plain(x, w, b, 1e-5),
            lambda: F.layer_norm(x, (d,), w, b, 1e-5), dt,
            (2 * R * d + 2 * d) * 2, 8 * R * d, PEAK_F32,
            variant=("layer_norm", "warp"))
    labels = s2s_batches(torch, np.random.RandomState(34), S2S_B)[2]
    flat = labels.reshape(-1).cuda()
    n = flat.numel()
    keep = flat != S2S_IGNORE
    n_valid = int(keep.sum())
    z = torch.randn(S2S_B, S2S_TGT, V, generator=g, device="cuda").to(dt)
    gr = torch.randn(n, generator=g, device="cuda")
    loss, lse = SX.softmax_xent_fwd(z, flat)
    dz = SX.softmax_xent_bwd(z, flat, lse, gr)
    torch.cuda.synchronize()
    if not torch.all(dz.reshape(n, V)[~keep] == 0):
        fail("softmax_xent_bwd bf16 seq2seq: a pad row's gradient is not "
             "exactly 0")
    del dz
    logp = torch.log_softmax(z.reshape(n, V), -1)
    zero = torch.zeros((), dtype=dt, device="cuda")
    gd = gr.to(dt)
    desc = f"bf16 seq2seq N={n} ({n_valid} labelled) V={V}"
    recs["softmax_xent"] = compare(
        torch, f"softmax_xent {desc}",
        lambda: SX.softmax_xent_fwd(z, flat),
        lambda: SX.softmax_xent_plain(z, flat),
        lambda: F.cross_entropy(z.reshape(n, V), flat, reduction="none"),
        dt, n * V * 2 + 16 * n, 4 * n * V, PEAK_F32)
    recs["softmax_xent_bwd"] = compare(
        torch, f"softmax_xent_bwd {desc}",
        lambda: SX.softmax_xent_bwd(z, flat, lse, gr),
        lambda: SX.softmax_xent_bwd_plain(z, flat, lse, gr),
        lambda: torch.ops.aten._log_softmax_backward_data(
            torch.ops.aten.nll_loss_backward(
                gd, logp, flat, None, 0, -100, zero), logp, 1, dt),
        dt, (n_valid + n) * V * 2 + 16 * n, 4 * n_valid * V, PEAK_F32)
    del z, logp
    net = seq2seq_model(torch, "cuda", dt)

    def make(ps):
        # the schedule at its peak (the end of warm-up): an lr of the
        # first steps (~1.7e-7) moves no bf16 parameter
        sched = ptt.optimizer.lr.NoamDecay(d_model=d, warmup_steps=4000)
        sched.step(4000)
        return ptt.optimizer.Adam(learning_rate=sched, beta1=0.9,
                                  beta2=0.98, epsilon=1e-9, parameters=ps)

    opt, err, _ = optimizer_tree_check(torch, net, make=make)
    params = list(net.parameters())
    lr = opt.get_lr()
    rec = tree_step_record(torch, K, opt, params, lr)
    if rec["kind"] != "adam":
        fail(f"seq2seq optimizer: Adam took the {rec['kind']} rule")
    rec["max_abs_err"] = err
    log(f"[kernels] multi_tensor_step seq2seq Adam(0.9, 0.98, 1e-9, no "
        f"decay) lr {lr:.6e}: 3 steps bitwise the per-parameter loop over "
        f"Transformer-base's {rec['tensors']} bf16 tensors, float32 moments "
        f"(max |d| {err}) | one update of {rec['elements']} elements: "
        f"device ms kernel={rec['ms']} plain loop={rec['plain_ms']} "
        f"bound={rec['bound_ms']} ({rec['bound_by']}, {rec['bytes']} bytes)"
        f" | eager ms kernel={rec['eager_ms']} plain="
        f"{rec['plain_eager_ms']}")
    recs["multi_tensor_step"] = rec
    del net, params, opt
    torch.cuda.synchronize()
    return recs


def seq2seq_parity(torch, K):
    """The full-width model in float32 at dropout 0, B = 2: the loss and
    every parameter's gradient on the card (kernels) against the CPU
    (plain versions), from one seed."""
    from paddle_tpu_torch.framework.random import seed

    batch = s2s_batches(torch, np.random.RandomState(31), 2)
    res = {}
    for device in ("cpu", "cuda"):
        seed(0)
        model = seq2seq_model(torch, device, dropout=0.0).train()
        K.reset_launch_counts()
        before = K.variant_launches() if device == "cuda" else None
        src, tgt_in, labels = (t.to(device) for t in batch)
        loss = s2s_loss(model(src, tgt_in), labels)
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            counts = K.launch_counts()
            f32 = require_fast_variants(K, before, "seq2seq parity",
                                        ATTENTION_KERNELS, F32_FAST)
            cross = K.flash_attention.cross_launches()
        res[device] = (loss.item(), {n: p.grad.cpu() for n, p in
                                     model.named_parameters()})
        del model, loss
    (loss_g, grads_g), (loss_c, grads_c) = res["cuda"], res["cpu"]
    for name in S2S_KERNELS:
        if counts[name] <= 0:
            fail(f"seq2seq parity: kernel {name} was not launched")
    layers = S2S["layers"]
    if cross != dict.fromkeys(cross, layers):
        fail(f"seq2seq parity: cross-form launches {cross}, not {layers} "
             "of each attention kernel")
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    worst, worst_name = 0.0, None
    for name, ref in grads_c.items():
        got = grads_g[name]
        if not torch.isfinite(got).all():
            fail(f"seq2seq parity: {name} has no finite gradient on the "
                 "card")
        # a key projection's bias has an exactly-zero gradient (softmax is
        # shift-invariant over a query's keys): both sides give rounding
        # noise, held against the scale of the same attention's query-bias
        # gradient instead of its own (as [bert-parity] does)
        scale = grads_c[name.replace("k_proj.bias", "q_proj.bias")]
        rel = ((got - ref).abs().max()
               / scale.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    if loss_rel > GRAD_REL_TOL or worst > GRAD_REL_TOL:
        fail(f"seq2seq parity: loss rel {loss_rel:.3e}, worst gradient "
             f"{worst_name} rel {worst:.3e} > {GRAD_REL_TOL}")
    log(f"[seq2seq] parity: full-width f32 Transformer-base, dropout 0, "
        f"B=2 (source 72, target 64): loss {loss_g:.6f} (cpu {loss_c:.6f}, "
        f"rel {loss_rel:.3e}); {len(grads_c)} parameters, every gradient "
        f"finite; worst max|dgrad|/max|ref| {worst:.3e} ({worst_name}; tol "
        f"{GRAD_REL_TOL}; k_proj.bias against its attention's q_proj.bias "
        f"scale); launches {counts}, of them cross-form {cross}, on the "
        f"float32 kernels (attention tf32x3) {f32}")


def s2s_decode(torch, model, src, n, cache=True):
    """Greedy decoding under no_grad: the encoder once, then one decoder
    step a token over ``gen_cache``'s incremental Cache (S_q = 1 over the
    tokens so far) and the memory's StaticCache (S_q = 1 over 72), or
    (``cache`` False) the whole prefix recomputed each step under the
    subsequent mask.  Returns (tokens [B, n], each step's logits, ms a
    token)."""
    from paddle_tpu_torch import nn

    dec = model.transformer.decoder
    mask = (src != S2S_PAD)[:, None, None, :]
    tokens = torch.full((src.shape[0], 1), S2S_BOS, dtype=torch.int64,
                        device=src.device)
    logits = []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        memory = model.transformer.encoder(model.embed(src), mask)
        caches = dec.gen_cache(memory)
        for t in range(n):
            if cache:
                h, caches = dec(model.embed(tokens[:, -1:], t), memory, None,
                                mask, caches)
            else:
                sub = nn.Transformer.generate_square_subsequent_mask(
                    t + 1, src.device)
                h = dec(model.embed(tokens), memory, sub, mask)
            logits.append(model.logits(h[:, -1]))
            tokens = torch.cat([tokens, logits[-1].argmax(-1)[:, None]], 1)
        torch.cuda.synchronize()
    return tokens[:, 1:], logits, (time.perf_counter() - t0) * 1e3 / n


def seq2seq_fit_run(torch, K, form, data, evals):
    """One run of Model.fit on Transformer-base (bf16, dropout 0.1) from
    seed 0: Adam(0.9, 0.98, 1e-9) with NoamDecay(512, 4000) from its peak
    (step 4000) stepped a batch, ``S2S_EPOCHS`` epochs over
    ``S2S_BATCHES`` batches (log every step, so each step's time ends at
    its drain) through the captured
    step ("graph") or ``_step_eager`` ("eager"), then 2 more steps under
    the profiler.  The graph run also evaluates ``evals`` through the
    eval graph and the eager ``_eval``.  Returns what the phase checks
    and prints."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.hapi.engine import EvalEngine, TrainEngine

    seed(0)
    net = seq2seq_model(torch, "cuda", torch.bfloat16)
    # from the schedule's peak (the end of warm-up), as the row-kernel
    # check takes it: the lrs of the first steps (1.7e-7 a step) move no
    # bf16 parameter, so a loss that fell there fell by dropout's draws
    sched = ptt.optimizer.lr.NoamDecay(d_model=S2S["d_model"],
                                       warmup_steps=4000)
    sched.step(4000)
    opt = ptt.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                             epsilon=1e-9, parameters=net.parameters())
    api = ptt.Model(net, inputs=["src", "tgt_in"], labels=["tgt_out"])
    api.prepare(opt, s2s_loss)
    engine = api._engine = TrainEngine(api)
    if form == "eager":
        engine.step = engine._step_eager
    drain, stamps = engine.drain, []

    def stamped():
        # an epoch's end drains again, with nothing pending: not a step
        out = drain()
        if out:
            stamps.append(time.perf_counter())
        return out

    engine.drain = stamped
    n = S2S_BATCHES * S2S_B
    K.reset_launch_counts()
    t0 = time.perf_counter()
    losses = api.fit(ptt.io.TensorDataset([t[:n] for t in data]),
                     batch_size=S2S_B, epochs=S2S_EPOCHS, shuffle=False,
                     verbose=0, log_freq=1)["step_loss"]
    steps = S2S_BATCHES * S2S_EPOCHS
    times = np.diff([t0] + stamps[:steps]) * 1e3
    counts, cross = K.launch_counts(), K.flash_attention.cross_launches()
    losses2, wall, kernels = trace_window(torch, lambda: api.fit(
        ptt.io.TensorDataset([t[n:n + 2 * S2S_B] for t in data]),
        batch_size=S2S_B, shuffle=False, verbose=0, log_freq=1)[
            "step_loss"])
    traced, fast = require_traced(kernels, f"seq2seq {form}",
                                  S2S_KERNELS, dropout=True)
    opt_text = require_optimizer_kernel(traced, opt, 2, f"seq2seq {form}")
    out = dict(losses=losses + losses2, times=times,
               p50=float(np.median(times[1:])), counts=counts, cross=cross,
               traced={k: v / 2 for k, v in traced.items() if v},
               fast=fast, opt_text=opt_text, busy=sum(t for t, _, _ in
                                                     kernels), wall=wall,
               launches=sum(c for _, _, c in kernels) / 2,
               captures=engine.captures, replays=engine.replays,
               graph_launches=list(engine.graph_launches.values()),
               lr=sched.last_lr)
    if form == "graph":
        evaluator = api._eval_engine = EvalEngine(api)
        batches = [[t[i * S2S_B:(i + 1) * S2S_B] for t in evals]
                   for i in range(S2S_EVAL)]
        evaluator.begin()
        for b in batches:
            evaluator.step(b[:2], b[2:])
        g_loss = evaluator.drain()
        e_loss = torch.stack([api._eval(b[:2], b[2:])[1].float()
                              for b in batches]).cpu().tolist()
        if g_loss != e_loss or evaluator.captures != 1:
            fail(f"seq2seq eval: graph losses {g_loss} ({evaluator.captures}"
                 f" captures) against eager {e_loss}")

        def p50_ms(fn, reps=5):
            ms = []
            for _ in range(reps):
                for b in batches:
                    t = time.perf_counter()
                    fn(b)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3)
            return float(np.median(ms))

        evaluator.begin()
        out["eval"] = dict(
            losses=g_loss, graph_ms=p50_ms(
                lambda b: evaluator.step(b[:2], b[2:])),
            eager_ms=p50_ms(lambda b: api._eval(b[:2], b[2:])),
            launches=evaluator.graph_launches)
        evaluator.drain()
        out["net"] = net
    return out


def seq2seq_phase(torch, K, card):
    """The encoder-decoder path at Transformer-base (``S2S``): the cross
    form of the attention kernels against their plain versions
    (``seq2seq_kernel_phase``), float32 parity (``seq2seq_parity``), then
    Model.fit on bf16 batches of 48 pairs (sources 16-72 tokens padded to
    72, targets 16-64 padded to 64) four times from one seed (graph,
    eager, eager, graph): losses bitwise equal and falling, one capture,
    every attention launch in the traces on the tensor cores with dropout,
    18 forward launches a step of which 6 are the cross form, one
    optimizer launch a step; the eval graph bitwise the eager _eval;
    greedy decoding of 8 sources for 32 tokens in float32 with the caches
    equal to recomputing the prefix, and in bf16 every step's logits
    within BF16_TOL of the recompute's up to the first step whose tokens
    differ.  Returns (the cross records, the other kernels' records at
    the path's shapes, the cross-form launches a step, the launches of
    each kernel in the first graph run's fit (the warm-up and the
    capture), its traced launches a step)."""
    from paddle_tpu_torch.framework.random import seed

    t0 = time.perf_counter()
    cross_recs, row_recs = seq2seq_kernel_phase(torch, K)
    seq2seq_parity(torch, K)
    rs = np.random.RandomState(33)
    data = s2s_batches(torch, rs, (S2S_BATCHES + 2) * S2S_B)
    evals = s2s_batches(torch, rs, S2S_EVAL * S2S_B)
    runs = []
    for form in ("graph", "eager", "eager", "graph"):
        release(torch, f"seq2seq {form}")
        runs.append(seq2seq_fit_run(torch, K, form, data, evals))
    first = runs[0]["losses"]
    for r, form in zip(runs[1:], ("eager", "eager", "graph")):
        if r["losses"] != first:
            fail(f"seq2seq: the {form} run's losses {r['losses']} differ "
                 f"from the first graph run's {first}")
    # the same batches, the first epoch's against the last's
    epochs = np.reshape(first[:S2S_BATCHES * S2S_EPOCHS], (S2S_EPOCHS, -1))
    if not all(map(math.isfinite, first)) or \
            epochs[-1].mean() >= epochs[0].mean():
        fail(f"seq2seq: the losses do not fall from the first epoch to the "
             f"last: {first}")
    g, layers = runs[0], S2S["layers"]
    steps = S2S_BATCHES * S2S_EPOCHS
    # the graph run's wrappers counted its first step (eager) and the
    # capture: each a step's launches
    per_step = {k: v / 2 for k, v in g["counts"].items() if v}
    want = {"flash_attention": 3 * layers, "flash_attention_dq": 3 * layers,
            "flash_attention_dkv": 3 * layers,
            "layer_norm": 5 * layers, "softmax_xent": 1,
            "softmax_xent_bwd": 1}
    if g["captures"] != 1 or g["replays"] != steps + 1 \
            or any(per_step.get(k) != c for k, c in want.items()) \
            or g["cross"] != dict.fromkeys(g["cross"], 2 * layers):
        fail(f"seq2seq graph: {g['captures']} captures, {g['replays']} "
             f"replays, launches a step {per_step} (want {want}), "
             f"cross-form launches over the warm-up and the capture "
             f"{g['cross']} (want {2 * layers} each)")
    for r in runs:
        if not all(want[k] <= r["traced"].get(k, 0) * 2 <= 2 * want[k]
                   for k in want):
            fail(f"seq2seq: launches a step in the trace of 2 steps "
                 f"{r['traced']}, not those of one step {want}")
    flops = s2s_flops()
    positions = S2S_B * (S2S_SRC + S2S_TGT)
    # the real tokens of a step (source and target, pads out), averaged
    # over the fit's batches, each of which it takes once an epoch
    fit_src, _, fit_labels = (t[:S2S_BATCHES * S2S_B] for t in data)
    tokens = (int((fit_src != S2S_PAD).sum()) + int((fit_labels != S2S_IGNORE)
                                                 .sum())) / S2S_BATCHES
    rows = []
    for i, (r, form) in enumerate(zip(runs, ("graph", "eager", "eager",
                                            "graph"))):
        rows.append(
            f"{form} run {i + 1}: p50 {r['p50']:.3f} ms, "
            f"{tokens / r['p50'] * 1e3:.1f} tokens/s (real source + target "
            f"tokens, {tokens:g} a step), {positions / r['p50'] * 1e3:.1f} "
            f"positions/s (padded, {positions} a step), "
            f"{mfu_text(flops, r['p50'] / 1e3)}; 2 profiled steps busy "
            f"{r['busy']:.3f} of {r['wall']:.3f} ms "
            f"({100 * r['busy'] / r['wall']:.2f}%), {r['launches']:g} "
            f"launches a step; step ms {np.round(r['times'], 3).tolist()}")
    log(f"[seq2seq] Model.fit Transformer-base bf16 (d_model 512, 8 heads, "
        f"6 + 6 layers, FFN 2048, dropout 0.1, vocab {S2S['vocab']}) "
        f"B={S2S_B} source {S2S_SRC} target {S2S_TGT}, Adam(0.9, 0.98, "
        f"1e-9) + NoamDecay(512, 4000) from step 4000 on {card}: losses "
        f"bitwise equal in "
        f"the 4 runs (graph, eager, eager, graph): {first}; lr after "
        f"{steps + 2} steps {g['lr']:.6e}; captures {g['captures']}, "
        f"replays {g['replays']}, graph launches {g['graph_launches']}; "
        f"cross-form launches (warm-up + capture) {g['cross']}; traced "
        f"launches a step {g['traced']}, fast kernels {g['fast']}; "
        f"{g['opt_text']}; flops a step {flops:.4e} (over the padded "
        f"positions, which the matmuls compute) | " + " | ".join(rows))
    ev = g["eval"]
    log(f"[seq2seq] eval graph bitwise the eager _eval over {S2S_EVAL} "
        f"batches (losses {ev['losses']}); p50 a batch {ev['graph_ms']:.3f} "
        f"ms against eager {ev['eager_ms']:.3f} ms "
        f"({ev['eager_ms'] / ev['graph_ms']:.2f}x); launches a replay "
        f"{ev['launches']}")
    # greedy decoding: float32 with and without the caches (tokens
    # equal), then the trained bf16 model: every step's logits until the
    # first step whose tokens differ (its logits too: a step's inputs are
    # the same in both until then)
    n_src, n_new = S2S_DECODE
    src = evals[0][:n_src].cuda()
    seed(0)
    f32 = seq2seq_model(torch, "cuda", dropout=0.0).eval()
    cached, _, f32_ms = s2s_decode(torch, f32, src, n_new)
    again, _, f32_re_ms = s2s_decode(torch, f32, src, n_new, cache=False)
    if not torch.equal(cached, again):
        fail(f"seq2seq decode f32: greedy tokens with the caches differ "
             f"from the recompute's at "
             f"{int((cached != again).sum())} of {cached.numel()}")
    del f32
    bf16 = runs[0]["net"].eval()
    tok_c, log_c, bf_ms = s2s_decode(torch, bf16, src, n_new)
    tok_r, log_r, bf_re_ms = s2s_decode(torch, bf16, src, n_new,
                                        cache=False)
    differ = (tok_c != tok_r).any(0).nonzero()
    held = int(differ[0]) + 1 if len(differ) else n_new
    err, tol = 0.0, 0.0
    for t in range(held):
        e = (log_c[t].float() - log_r[t].float()).abs().max().item()
        s_tol = BF16_TOL * max(1.0, log_r[t].float().abs().max().item())
        if not math.isfinite(e) or e > s_tol:
            fail(f"seq2seq decode bf16: step {t}'s logits with the caches "
                 f"differ from the recompute's by {e:.3e} > {s_tol:.3e}")
        if e >= err:
            err, tol = e, s_tol
    same = int((tok_c == tok_r).sum())
    log(f"[seq2seq] greedy decoding of {n_src} sources x {n_new} tokens: "
        f"f32 tokens with the caches equal the recompute's; ms a token "
        f"f32 {f32_ms:.3f} with the caches, {f32_re_ms:.3f} recomputing; "
        f"bf16 (the trained model) logits of steps 0-{held - 1} held, "
        f"worst max|d| {err:.3e} (tol {tol:.3e}), {same} of "
        f"{tok_c.numel()} tokens equal, ms a "
        f"token {bf_ms:.3f} with the caches, {bf_re_ms:.3f} recomputing; "
        f"the phase took {time.perf_counter() - t0:.1f}s")
    for r in runs:
        r.pop("net", None)
    # the cross form's launches a step, read from the warm-up and the
    # capture of the first graph run (two steps' worth)
    cross = {k: v / 2 for k, v in g["cross"].items()}
    return cross_recs, row_recs, cross, g["counts"], g["traced"]


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
            f"kernel launches ({launches / 2:g} a step); top: {top}")


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
        before = K.variant_launches() if device == "cuda" else None
        t0 = time.perf_counter()
        loss = model.loss(ids.to(device), mlm.to(device), nsp.to(device),
                          tt.to(device))
        loss.backward()
        with torch.no_grad():
            logits = model(ids.to(device), tt.to(device), mask.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
            counts = K.launch_counts()
            f32 = require_fast_variants(K, before, "bert-parity",
                                        ATTENTION_KERNELS, F32_FAST)
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
        f"card {t_g:.2f}s, cpu {t_c:.2f}s; launches {counts}; of them on the "
        f"float32 kernels (attention tf32x3) {f32}")


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
    of the 10 dygraph steps and (p50 s, model flops, tokens) of a step."""
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
    ptt.optimizer.Optimizer.plain_cuda_updates = 0
    variants = K.variant_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = K.launch_counts()
    fast = require_fast_variants(K, variants, "bert-train", TRAINING_FAST)
    opt_text = require_optimizer_kernel(counts, opt, steps,
                                        "bert-train")
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
        f"per step {per_step}; tensor-core and vector-kernel launches "
        f"{fast}; {opt_text}; losses "
        f"{losses_vs(losses, '11.17882', '10.07555')}")
    profile_steps(torch, "bert-profile", step)

    data = bert_batch(torch, rs, cfg, 3 * B, S)
    mask, lens = padding_mask(torch, rs, 3 * B, S)
    api = ptt.Model(model, labels=["mlm_labels", "nsp_labels"]).prepare(
        opt, bert_fit_loss)
    hist, fit_ms, kernels = trace_window(torch, lambda: api.fit(
        ptt.io.TensorDataset([data[0], data[1], mask, data[2], data[3]]),
        batch_size=B, epochs=1, shuffle=False, verbose=0, log_freq=1))
    fit_counts, _ = require_traced(kernels, "BERT Model.fit", BERT_KERNELS,
                                   dropout=False)
    fit_opt = require_optimizer_kernel(fit_counts, opt, 3,
                                       "BERT Model.fit")
    if len(hist["step_loss"]) != 3 or not all(
            math.isfinite(x) for x in hist["step_loss"]):
        fail(f"BERT Model.fit: step losses {hist['step_loss']}")
    log(f"[bert-fit] Model.fit 3 steps of B={B} S={S}, inputs [ids, "
        f"token_type_ids, [B, 1, 1, S] bool mask] (lengths "
        f"{int(lens.min())}-{int(lens.max())}, mean {lens.mean():.1f}), "
        f"labels [mlm, nsp], loss on the logits through F.cross_entropy "
        f"(1 eager, the capture, 2 replays): step losses "
        f"{hist['step_loss']}; {fit_ms / 1e3:.3f}s under the profiler; "
        f"every attention launch took the mask; launches in the trace "
        f"{fit_counts}; {fit_opt}")
    return counts, (p50, flops, tokens)


# ---------------------------------------------------------------------------
# mixed precision (PR 13): the float16 and mixed forms of the training
# kernels, the unscale kernel, ERNIE in AMP-O2 float16 (path A) and BERT
# Model.fit under auto_cast O1 bf16 (path B)
# ---------------------------------------------------------------------------
ERNIE = dict(vocab_size=18000, type_vocab_size=4)   # ErnieModel's defaults
AMP_STEPS = 30             # path A's dygraph steps a run
AMP_LOSS_RTOL = 5e-3       # float16 first loss on the card, float32 CPU
AMP_FIT_STEPS = 10         # path B's Model.fit steps a run


# the instantiations each AMP path must launch, by (kernel, its leading
# template arguments) as a trace names them: path A all float16, path B
# the mixed forms (bf16 x, float32 weight or bias), bf16 attention and
# NSP logits, float32 MLM logits and parameters
ERNIE_FORMS = {
    "layer_norm f16": ("layer_norm_warp_kernel", "__half", "__half"),
    "bias_gelu f16": ("bias_gelu_fwd_vec_kernel", "__half", "__half"),
    "bias_gelu_bwd f16": ("bias_gelu_bwd_vec_kernel", "__half", "__half"),
    "flash_attention f16": ("flash_fwd_mma_kernel", "__half"),
    "flash_attention_dq f16": ("flash_dq_mma_kernel", "__half"),
    "flash_attention_dkv f16": ("flash_dkv_mma_kernel", "__half"),
    "softmax_xent f16": ("xent_fwd_kernel", "__half"),
    "softmax_xent_bwd f16": ("xent_bwd_kernel", "__half"),
    "multi_tensor_step f16": ("multi_tensor_kernel", "__half"),
    "check_finite_and_unscale f16": ("unscale_kernel", "__half")}
FIT_AMP_FORMS = {
    "layer_norm mixed": ("layer_norm_warp_kernel", "__nv_bfloat16", "float"),
    "layer_norm f32": ("layer_norm_warp_kernel", "float", "float"),
    "bias_gelu mixed": ("bias_gelu_fwd_vec_kernel", "__nv_bfloat16",
                        "float"),
    "bias_gelu_bwd mixed": ("bias_gelu_bwd_vec_kernel", "__nv_bfloat16",
                            "float"),
    "flash_attention bf16": ("flash_fwd_mma_kernel", "__nv_bfloat16"),
    "flash_attention_dq bf16": ("flash_dq_mma_kernel", "__nv_bfloat16"),
    "flash_attention_dkv bf16": ("flash_dkv_mma_kernel", "__nv_bfloat16"),
    "softmax_xent bf16 (NSP)": ("xent_fwd_kernel", "__nv_bfloat16"),
    "softmax_xent f32 (MLM)": ("xent_fwd_kernel", "float"),
    "softmax_xent_bwd bf16 (NSP)": ("xent_bwd_kernel", "__nv_bfloat16"),
    "softmax_xent_bwd f32 (MLM)": ("xent_bwd_kernel", "float"),
    "multi_tensor_step f32": ("multi_tensor_kernel", "float")}


def require_instances(kernels, want, what):
    """{label: launches} in a trace (``kernels``, as trace_window returns
    them) of each instantiation of ``want``; fails if one never
    launched."""
    out = {}
    for label, (kernel, *args) in want.items():
        pat = re.compile(rf"(?<!\w){kernel}<\s*" + r"\s*,\s*".join(
            map(re.escape, args)) + r"\s*[,>]")
        out[label] = sum(c for _, key, c in kernels if pat.search(key))
        if out[label] <= 0:
            fail(f"{what}: the trace holds no launch of {kernel}<"
                 f"{', '.join(args)}, ...>: {label} did not run")
    return out


def library_or_none(torch, name, fn, tag="[amp-kernels]"):
    """A library yardstick that this PyTorch may not offer for a dtype or
    a device: ``fn`` if one call runs, else None (logged).  Only the
    yardstick is skipped, never a kernel."""
    try:
        fn()
        torch.cuda.synchronize()
        return fn
    except (AttributeError, RuntimeError, TypeError) as e:
        log(f"{tag} {name}: no library call for these tensors "
            f"({str(e).splitlines()[0][:120]})")
        return None


def amp_kernel_phase(torch, K):
    """Each float16 and mixed form of rows 1-8 at the AMP paths' shapes
    against its plain version: LayerNorm R = 4096, N = 768 (float16; bf16
    x with float32 weights, the MLM head under O1), bias-GeLU forward and
    backward R = 4096, F = 3072 (float16; bf16 x with a float32 bias),
    softmax cross-entropy forward and backward on float16 logits (ERNIE's
    MLM head N = 4096, V = 18,000, 15 % labelled; its NSP head N = 32,
    V = 2), and the three attention kernels at B = 32, H = 12, S = 128,
    D = 64 with the padding mask and dropout 0.1 in float16, each beside
    the same kernel in bf16 at the same shape and the library call in
    float16.  The float16 and bf16 forwards drop the same pairs for one
    seed.  Returns {kernel: {"float16": rec, "mixed": rec}}."""
    F = torch.nn.functional
    KF = K.flash_attention
    g = torch.Generator(device="cuda").manual_seed(31)
    f16, bf16, f32 = torch.float16, torch.bfloat16, torch.float32
    recs = {}

    def rnd(*shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale
                + shift).to(dtype)

    def keep(name, form, rec, bf16_rec=None):
        if bf16_rec is not None:
            rec["bf16_ms"] = bf16_rec["ms"]
        recs.setdefault(name, {})[form] = rec
        log(f"[amp-kernels] {name} {form}: device ms {rec['ms']} "
            f"(bf16 {rec.get('bf16_ms')}), bound {rec['bound_ms']} "
            f"({rec['bound_by']}), plain {rec['plain_ms']}, library "
            f"{rec['library_ms']}")

    # row 1: LayerNorm
    R, N = 4096, 768
    by_form = {}
    for form, xd, wd in (("bf16", bf16, bf16), ("float16", f16, f16),
                         ("mixed", bf16, f32)):
        x = rnd(R, N, dtype=xd, scale=3.0, shift=1.0)
        w = rnd(N, dtype=wd, scale=0.1, shift=1.0)
        b = rnd(N, dtype=wd, scale=0.1)
        lib = library_or_none(torch, f"layer_norm {form}",
                              lambda: F.layer_norm(x, (N,), w, b, 1e-12))
        by_form[form] = compare(
            torch, f"layer_norm {form} R={R} N={N} x {xd} w {wd}",
            lambda: K.layer_norm.layer_norm(x, w, b, 1e-12),
            lambda: K.layer_norm.layer_norm_plain(x, w, b, 1e-12), lib, xd,
            2 * R * N * x.element_size() + 2 * N * w.element_size(),
            8 * R * N, PEAK_F32, variant=("layer_norm", "warp"))
    keep("layer_norm", "float16", by_form["float16"], by_form["bf16"])
    keep("layer_norm", "mixed", by_form["mixed"], by_form["bf16"])
    # rows 2-3: bias-GeLU forward and backward
    R, Fd = 4096, 3072
    fwd, bwd = {}, {}
    for form, xd, bd in (("bf16", bf16, bf16), ("float16", f16, f16),
                         ("mixed", bf16, f32)):
        x, dy = rnd(R, Fd, dtype=xd, scale=2.0), rnd(R, Fd, dtype=xd)
        b = rnd(Fd, dtype=bd, scale=0.5)
        isz, bsz = x.element_size(), b.element_size()
        desc = f"R={R} F={Fd} x {xd} b {bd}"
        fwd[form] = compare(
            torch, f"bias_gelu {form} {desc}",
            lambda: K.bias_gelu.bias_gelu(x, b),
            lambda: K.bias_gelu.bias_gelu_plain(x, b),
            lambda: F.gelu(x + b), xd, 2 * R * Fd * isz + Fd * bsz,
            5 * R * Fd, PEAK_F32, variant=("bias_gelu", "vec"))
        lib = library_or_none(
            torch, f"bias_gelu_bwd {form}",
            lambda: torch.ops.aten.gelu_backward(dy, x + b))
        bwd[form] = compare(
            torch, f"bias_gelu_bwd {form} {desc}",
            lambda: K.bias_gelu.bias_gelu_bwd(x, b, dy),
            lambda: K.bias_gelu.bias_gelu_bwd_plain(x, b, dy), lib, xd,
            3 * R * Fd * isz + Fd * bsz, 12 * R * Fd, PEAK_F32,
            variant=("bias_gelu_bwd", "vec"))
        del x, dy, b
    for form in ("float16", "mixed"):
        keep("bias_gelu", form, fwd[form], fwd["bf16"])
        keep("bias_gelu_bwd", form, bwd[form], bwd["bf16"])
    # rows 4-5: softmax cross-entropy on float16 logits
    SX = K.softmax_xent
    for head, (n, V), frac in (("mlm", (4096, ERNIE["vocab_size"]), 0.15),
                               ("nsp", (32, 2), 1.0)):
        pair = {}
        for form, dtype in (("bf16", bf16), ("float16", f16)):
            z = rnd(n, V, dtype=dtype, scale=2.0)
            lab = torch.where(
                torch.rand(n, generator=g, device="cuda") < frac,
                torch.randint(0, V, (n,), generator=g, device="cuda"), -100)
            n_valid = int((lab != -100).sum())
            gr = torch.randn(n, generator=g, device="cuda")
            loss, lse = SX.softmax_xent_fwd(z, lab)
            dz = SX.softmax_xent_bwd(z, lab, lse, gr)
            torch.cuda.synchronize()
            if not torch.all(dz[lab == -100] == 0):
                fail(f"softmax_xent_bwd {form} {head}: an ignored row's "
                     "gradient is not exactly 0")
            logp = torch.log_softmax(z, -1)
            zero = torch.zeros((), dtype=dtype, device="cuda")
            gd = gr.to(dtype)
            desc = f"{form} {head} N={n} V={V}"
            isz = z.element_size()
            rf = compare(
                torch, f"softmax_xent {desc}",
                lambda: SX.softmax_xent_fwd(z, lab),
                lambda: SX.softmax_xent_plain(z, lab),
                lambda: F.cross_entropy(z, lab, reduction="none"), dtype,
                n * V * isz + 16 * n, 4 * n * V, PEAK_F32)
            rb = compare(
                torch, f"softmax_xent_bwd {desc}",
                lambda: SX.softmax_xent_bwd(z, lab, lse, gr),
                lambda: SX.softmax_xent_bwd_plain(z, lab, lse, gr),
                lambda: torch.ops.aten._log_softmax_backward_data(
                    torch.ops.aten.nll_loss_backward(
                        gd, logp, lab, None, 0, -100, zero), logp, 1,
                    dtype), dtype,
                (n_valid + n) * V * isz + 16 * n, 4 * n_valid * V, PEAK_F32)
            pair[form] = (rf, rb)
            del z, dz, logp
        if head == "mlm":
            keep("softmax_xent", "float16", pair["float16"][0],
                 pair["bf16"][0])
            keep("softmax_xent_bwd", "float16", pair["float16"][1],
                 pair["bf16"][1])
        else:
            for name, rec in zip(("softmax_xent", "softmax_xent_bwd"),
                                 pair["float16"]):
                recs[name]["float16"]["nsp"] = {
                    k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "max_abs_err")}
    # rows 6-8: attention, BERT's padded shape with dropout 0.1
    B, S, H, D, p = 32, 128, 12, 64, DROPOUT_P
    lens = torch.randint(64, S + 1, (B,), generator=g, device="cuda")
    bias = KF.fold_mask((torch.arange(S, device="cuda")[None, :]
                         < lens[:, None])[:, None, None, :], B, H, S, S)
    pairs = H * S * int(lens.sum())
    att = {}
    for form, dtype in (("bf16", bf16), ("float16", f16)):
        q, k, v = rnd(B, S, 3, H, D, dtype=dtype).unbind(2)
        do = rnd(B, S, H, D, dtype=dtype)
        kw = dict(causal=False, bias=bias, dropout_p=p, seed=DROPOUT_SEED)
        o, lse = KF.flash_attention(q, k, v, **kw)
        delta = KF.flash_attention_delta(o, do)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_mask = bias.to(dtype)
        lib_bwd = sdpa_masked_backward(torch, q, k, v, do, bias, p)
        one, stats = B * S * H * D * 2, 2 * B * H * S * 4
        desc = f"{form} padding dropout p={p} B={B} S={S} H={H} D={D}"
        att[form] = {
            "flash_attention": compare(
                torch, f"flash_attention {desc}",
                lambda: KF.flash_attention(q, k, v, **kw)[0],
                lambda: KF.flash_attention_plain(q, k, v, **kw)[0],
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=lib_mask, dropout_p=p), dtype,
                4 * one + B * H * S * 4 + B * S * 4, 4 * D * pairs,
                PEAK_BF16_TENSOR, variant=("flash_attention", "mma")),
            "flash_attention_dq": compare(
                torch, f"flash_attention_dq {desc}",
                lambda: KF.flash_attention_dq(q, k, v, do, lse, delta, **kw),
                lambda: KF.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                                    **kw),
                lib_bwd, dtype, 5 * one + stats + B * S * 4, 6 * D * pairs,
                PEAK_BF16_TENSOR, variant=("flash_attention_dq", "mma")),
            "flash_attention_dkv": compare(
                torch, f"flash_attention_dkv {desc}",
                lambda: KF.flash_attention_dkv(q, k, v, do, lse, delta,
                                               **kw),
                lambda: KF.flash_attention_dkv_plain(q, k, v, do, lse,
                                                     delta, **kw),
                lib_bwd, dtype, 6 * one + stats + B * S * 4, 8 * D * pairs,
                PEAK_BF16_TENSOR, variant=("flash_attention_dkv", "mma"))}
        del q, k, v, do, o, lse, delta
    for name in ATTENTION_KERNELS:
        keep(name, "float16", att["float16"][name], att["bf16"][name])
    # the dropout mask: q = 0 gives every weight 1 / S, and V = I puts
    # weight (i, j) in O[i, j]: the kept pairs of each dtype
    S2 = D2 = 128
    q0 = torch.zeros(2, S2, 2, D2, device="cuda")
    eye = torch.eye(S2, D2, device="cuda")[None, :, None].expand(
        2, S2, 2, D2).contiguous()
    kept = [KF.flash_attention(q0.to(dt), q0.to(dt), eye.to(dt),
                               causal=False, dropout_p=p,
                               seed=DROPOUT_SEED)[0] != 0
            for dt in (f16, bf16)]
    want = KF.dropout_keep_plain(DROPOUT_SEED, 2, 2, S2, p, "cuda")
    if not (torch.equal(kept[0], kept[1])
            and torch.equal(kept[0], want.permute(0, 2, 1, 3))):
        fail("amp-kernels: the float16 and bf16 forwards dropped different "
             "pairs for one seed")
    log(f"[amp-kernels] dropout p={p}: the float16 and bf16 forwards keep "
        f"the same {int(kept[0].sum())} of {kept[0].numel()} pairs, the "
        "plain version's mask")
    torch.cuda.synchronize()
    return recs


def amp_unscale_phase(torch, K):
    """check_finite_and_unscale_ over GPT-2-small's 148 gradients (float16,
    the parameters' shapes) against its plain version, bitwise: clean,
    then with an inf planted in one gradient and a NaN in another (the
    flag set, inf and NaN where the plain version has them); one launch.
    Timed at inv_scale 1 against its bound (each element read and written
    once), the plain version and torch's
    _amp_foreach_non_finite_check_and_unscale_.  Returns the record."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    KA = K.amp
    shapes = [tuple(p.shape) for p in GPTForCausalLM(
        GPTConfig(), device="cpu").parameters()]
    g = torch.Generator(device="cuda").manual_seed(17)
    inv = torch.full((1,), 2.0 ** -15, device="cuda")
    base = [(torch.randn(s, generator=g, device="cuda") * 2048).half()
            for s in shapes]
    numel = sum(t.numel() for t in base)
    for plant in ("clean", "inf+nan"):
        grads = [t.clone() for t in base]
        if plant != "clean":
            grads[0].view(-1)[12345] = float("inf")
            grads[-1].view(-1)[7] = float("nan")
        ref = [t.clone() for t in grads]
        found = torch.zeros(1, dtype=torch.int32, device="cuda")
        ref_found = torch.zeros(1, dtype=torch.int32, device="cuda")
        before = KA.check_finite_and_unscale_.launches
        KA.check_finite_and_unscale_(grads, inv, found)
        launches = KA.check_finite_and_unscale_.launches - before
        KA.check_finite_and_unscale_plain(ref, inv, ref_found)
        torch.cuda.synchronize()
        same = all(torch.equal(a.isnan(), b.isnan())
                   and torch.equal(a.nan_to_num(), b.nan_to_num())
                   for a, b in zip(grads, ref))
        if not same or launches != 1 or found.item() != ref_found.item() \
                or found.item() != (plant != "clean"):
            fail(f"amp-unscale {plant}: bitwise {same}, {launches} launches, "
                 f"flag {found.item()} (plain {ref_found.item()})")
        log(f"[amp-unscale] {plant}: {len(grads)} float16 gradients, "
            f"{numel} elements, inv_scale 2**-15: bitwise the plain "
            f"version, flag {found.item()}, 1 launch")
    one = torch.ones(1, device="cuda")
    found = torch.zeros(1, dtype=torch.int32, device="cuda")
    found_f = torch.zeros(1, device="cuda")
    grads = [t.clone() for t in base]
    rec = {"max_abs_err": 0.0, "tol": 0.0, "variant": None}
    for key, fn in (
            ("ms", lambda: KA.check_finite_and_unscale_(grads, one, found)),
            ("plain_ms", lambda: KA.check_finite_and_unscale_plain(
                grads, one, found)),
            ("library_ms", lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                grads, found_f, one))):
        rec[key] = time_ms(torch, fn)[0]
    rec["bound_ms"], rec["bound_by"] = bound_ms(4 * numel, numel, PEAK_F32)
    rec["tensors"], rec["elements"] = len(grads), numel
    log(f"[amp-unscale] device ms: kernel {rec['ms']}, plain {rec['plain_ms']}"
        f", library (torch._amp_foreach_non_finite_check_and_unscale_) "
        f"{rec['library_ms']}, bound {rec['bound_ms']} ({rec['bound_by']}: "
        f"{4 * numel} bytes)")
    del base, grads
    return rec


def scale_rule(skipped, init, incr_every=1000, decr_every=2):
    """The reference's dynamic loss scale after each step, from which
    steps found an inf or a NaN (GradScaler.update)."""
    scale, good, bad, out = init, 0, 0, []
    for s in skipped:
        if s:
            good, bad = 0, bad + 1
            if bad >= decr_every:
                scale, bad = max(scale * 0.5, 1.0), 0
        else:
            good, bad = good + 1, 0
            if good >= incr_every:
                scale, good = scale * 2.0, 0
        out.append(scale)
    return out


def ernie_batches(torch, n):
    """``n`` seeded ERNIE pretraining batches of B = 32, S = 128 on the
    card: ids over the 18,000-token vocabulary, four segment types, ~15 %
    MLM labels, NSP labels and a [B, 1, 1, S] bool padding mask (lengths
    64-128)."""
    from paddle_tpu_torch.models import BertConfig

    cfg = BertConfig(**ERNIE)
    rs = np.random.RandomState(23)
    out = []
    for _ in range(n):
        ids, _, mlm, nsp = bert_batch(torch, rs, cfg, 32, 128)
        tt = torch.from_numpy(rs.randint(0, 4, (32, 128)))
        mask = padding_mask(torch, rs, 32, 128)[0]
        out.append([t.cuda() for t in (ids, tt, mask, mlm, nsp)])
    return out


def ernie_o2_run(torch, K, batches, profile=False):
    """One run of path A from seed 0: BertForPretraining(BertConfig(
    vocab_size=18000, type_vocab_size=4)) (ErnieModel's defaults, dropout
    0.1), AdamW(1e-4, wd 0.01), ``amp.decorate(model, opt, level="O2",
    dtype="float16")``, GradScaler(2**15); AMP_STEPS steps of the
    reference's idiom, each under ``auto_cast(level="O2",
    dtype="float16")``.  Returns a dict of what the phase checks."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    seed(0)
    model = BertForPretraining(BertConfig(**ERNIE), device="cuda").train()
    opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    out = {"n_params": sum(p.numel() for p in model.parameters())}
    if profile:         # the first batch's loss in eval mode, for the CPU
        with torch.no_grad(), amp.auto_cast(level="O2", dtype="float16"):
            model.eval()
            out["eval_loss"] = bert_fit_loss(
                *model(*batches[0][:3]), *batches[0][3:]).item()
            model.train()
        out["state"] = {k: v.detach().cpu()
                        for k, v in model.state_dict().items()}

    def step(i):
        ids, tt, mask, mlm, nsp = batches[i % len(batches)]
        with amp.auto_cast(level="O2", dtype="float16"):
            loss = bert_fit_loss(*model(ids, tt, mask), mlm, nsp)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        return loss.detach()

    K.reset_launch_counts()
    ptt.optimizer.Optimizer.plain_cuda_updates = 0
    variants = K.variant_launches()
    losses, times, skipped, scales = [], [], [], []
    for i in range(AMP_STEPS):
        t0 = time.perf_counter()
        applied = opt._step_count
        losses.append(step(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        skipped.append(opt._step_count == applied)
        scales.append(scaler.get_loss_scaling())
    out["counts"] = K.launch_counts()
    out["fast"] = require_fast_variants(K, variants, "ernie-o2",
                                        TRAINING_FAST)
    out["losses"] = torch.stack(losses).float().cpu().tolist()
    out.update(times=times, skipped=skipped, scales=scales,
               dtypes={str(p.dtype) for p in model.parameters()})
    if profile:
        _, wall_ms, kernels = trace_window(
            torch, lambda: [step(AMP_STEPS + j) for j in range(2)])
        out["traced"], _ = require_traced(
            kernels, "ernie-o2", BERT_KERNELS + ("check_finite_and_unscale",),
            dropout=True)
        out["forms"] = require_instances(kernels, ERNIE_FORMS, "ernie-o2")
        out["busy"] = (sum(t for t, _, _ in kernels), wall_ms)
    del model, opt
    return out


def ernie_cpu_loss(torch, state, batch):
    """The port's own CPU run (plain versions) of the first batch's loss
    in eval mode, from the card run's float16 weights held exactly in
    float32: a host CPU without float16 arithmetic units takes minutes
    for this forward in float16, seconds in float32.  AMP_LOSS_RTOL
    covers the card's float16 rounding."""
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         load_numpy_state)

    model = BertForPretraining(BertConfig(**ERNIE), device="cpu")
    load_numpy_state(model, {k: v.float().numpy() for k, v in state.items()})
    model.eval()
    with torch.no_grad():
        cpu = [t.cpu() for t in batch]
        return bert_fit_loss(*model(*cpu[:3]), *cpu[3:]).item()


def ernie_o2_phase(torch, K, card):
    """Path A, run twice from one seed: ERNIE pretraining (full width, 12
    layers) in AMP-O2 float16 with dynamic loss scaling, B = 32, S = 128,
    padded batches.  Fails unless the losses over the applied steps are
    finite, bitwise equal in both runs and falling, the scale follows the
    reference's rule from the skipped steps, every training kernel
    launched in float16 (the unscale kernel once a step) and the first
    batch's loss matches the port's CPU run within AMP_LOSS_RTOL.  Step
    p50, samples/s, MFU.  Returns (launch counts of the first run, its
    traced launches a step, a summary)."""
    batches = ernie_batches(torch, 4)
    runs = [ernie_o2_run(torch, K, batches, profile=i == 0)
            for i in range(2)]
    a, b = runs
    if a["losses"] != b["losses"] or a["skipped"] != b["skipped"]:
        fail(f"ernie-o2: two runs from one seed differ: {a['losses']} / "
             f"{b['losses']}")
    applied = [x for x, s in zip(a["losses"], a["skipped"]) if not s]
    if not applied or not all(math.isfinite(x) for x in applied) \
            or np.mean(applied[-5:]) >= np.mean(applied[:5]):
        fail(f"ernie-o2: the applied steps' losses {applied} are not finite "
             "and falling")
    want = scale_rule(a["skipped"], 2.0 ** 15)
    if a["scales"] != want:
        fail(f"ernie-o2: scales {a['scales']} do not follow the rule "
             f"{want}")
    if a["dtypes"] != {"torch.float16"}:
        fail(f"ernie-o2: parameters {a['dtypes']} after the steps")
    counts = a["counts"]
    unscale = counts["check_finite_and_unscale"]
    n_applied = len(applied)
    for name in BERT_KERNELS:
        if counts[name] <= 0:
            fail(f"ernie-o2: kernel {name} was not launched")
    if unscale != AMP_STEPS or counts["multi_tensor_step"] != n_applied:
        fail(f"ernie-o2: {unscale} unscale and "
             f"{counts['multi_tensor_step']} optimizer launches in "
             f"{AMP_STEPS} steps, {n_applied} applied")
    t0 = time.perf_counter()
    cpu = ernie_cpu_loss(torch, a["state"], batches[0])
    cpu_s = time.perf_counter() - t0
    rel = abs(a["eval_loss"] - cpu) / abs(cpu)
    if not rel <= AMP_LOSS_RTOL:
        fail(f"ernie-o2: first batch's eval loss {a['eval_loss']} on the "
             f"card, {cpu} on the CPU (rel {rel:.3e} > {AMP_LOSS_RTOL})")
    times = a["times"][2:] + b["times"][2:]
    p50 = float(np.median(times))
    B, S = 32, 128
    flops = 6.0 * a["n_params"] * B * S + 12 * 12 * S * S * 768 * B
    busy, wall = a["busy"]
    per_step = {n: c / 2 for n, c in a["traced"].items() if c}
    log(f"[ernie-o2] ERNIE (BertConfig(vocab_size=18000, type_vocab_size=4), "
        f"{a['n_params']} parameters, dropout 0.1) AMP-O2 float16, "
        f"GradScaler(2**15), AdamW(1e-4, wd 0.01), B={B} S={S} padded, "
        f"{AMP_STEPS} steps x 2 runs on {card}: losses {a['losses']} "
        f"bitwise equal in both runs; skipped steps "
        f"{[i for i, s in enumerate(a['skipped']) if s]}; scales "
        f"{a['scales']} (the reference's rule); first batch eval loss "
        f"card {a['eval_loss']:.6f} cpu {cpu:.6f} (rel {rel:.3e}, tol "
        f"{AMP_LOSS_RTOL}; cpu {cpu_s:.1f}s); step p50 {p50 * 1e3:.3f} ms "
        f"(steps 3-{AMP_STEPS} of both runs); {B / p50:.1f} samples/s; "
        f"{B * S / p50:.1f} tokens/s; {mfu_text(flops, p50)}; launches in "
        f"{AMP_STEPS} steps {counts}; tensor-core and vector launches "
        f"{a['fast']}; traced launches a step (2 profiled steps) "
        f"{per_step}; instantiations in them {a['forms']}; busy "
        f"{busy:.3f} of {wall:.3f} ms ({100 * busy / wall:.2f}%)")
    return counts, per_step, {
        "p50_ms": p50 * 1e3, "samples_s": B / p50,
        "mfu": flops / p50 / PEAK_BF16_TENSOR,
        "forms_a_step": {k: v / 2 for k, v in a["forms"].items()}}


def fit_amp_run(torch, K, form, data, B):
    """One Model.fit run of path B from seed 0: BertConfig() in float32,
    AdamW(1e-4, wd 0.01), AMP_FIT_STEPS steps under ``auto_cast(
    level="O1", dtype="bfloat16")``, through the captured step ("graph")
    or ``_step_eager``; then (graph) two more under the profiler and a
    plain fit of the same model outside auto_cast."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.hapi.engine import TrainEngine
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    seed(0)
    model = BertForPretraining(BertConfig(), device="cuda")
    opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              parameters=model.parameters())
    api = ptt.Model(model, labels=["mlm_labels", "nsp_labels"]).prepare(
        opt, bert_fit_loss)
    engine = api._engine = TrainEngine(api)
    if form == "eager":
        engine.step = engine._step_eager
    stamps, drain = [], engine.drain

    def stamped():
        out = drain()
        stamps.append(time.perf_counter())
        return out

    engine.drain = stamped

    def fit(lo, hi, log_freq=1):
        return api.fit(ptt.io.TensorDataset([t[lo * B:hi * B] for t in data]),
                       batch_size=B, shuffle=False, verbose=0,
                       log_freq=log_freq)["step_loss"]

    K.reset_launch_counts()
    t0 = time.perf_counter()
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        losses = fit(0, AMP_FIT_STEPS)
    out = {"losses": losses, "counts": K.launch_counts(),
           "times": np.diff([t0] + stamps[:AMP_FIT_STEPS]) * 1e3,
           "params": [p.detach().clone() for p in model.parameters()],
           "dtypes": {str(p.dtype) for p in model.parameters()}}
    if form == "graph":
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            _, wall_ms, kernels = trace_window(
                torch, lambda: fit(AMP_FIT_STEPS, AMP_FIT_STEPS + 2))
        out["traced"], _ = require_traced(kernels, "fit-amp", BERT_KERNELS,
                                          dropout=True)
        out["forms"] = require_instances(kernels, FIT_AMP_FORMS, "fit-amp")
        out["busy"] = (sum(t for t, _, _ in kernels), wall_ms)
        out["captures_amp"] = engine.captures
        out["sigs"] = [s[-1] for s in engine.graph_launches]
        plain = fit(AMP_FIT_STEPS + 2, AMP_FIT_STEPS + 4)
        out["captures_plain"] = engine.captures
        out["sigs_after"] = [s[-1] for s in engine.graph_launches]
        out["plain_losses"] = plain
        out["replays"] = engine.replays
    del api, engine, model, opt
    return out


def fit_amp_phase(torch, K, card):
    """Path B: BERT-base (BertConfig(), float32 parameters) through
    Model.fit under auto_cast(level="O1", dtype="bfloat16"), B = 32,
    S = 128, padded batches: the captured step against _step_eager
    (losses and parameters bitwise equal), the mixed bias-GeLU and
    LayerNorm forms, the bf16 attention and NSP cross-entropy and the
    float32 MLM cross-entropy in the trace; a plain fit of the same model
    afterwards captures its own graph.  Returns (the graph run's counts,
    its traced launches a step, a summary)."""
    from paddle_tpu_torch.models import BertConfig

    B, S = 32, 128
    cfg = BertConfig()
    rs = np.random.RandomState(29)
    n = AMP_FIT_STEPS + 4
    ids, tt, mlm, nsp = bert_batch(torch, rs, cfg, n * B, S)
    data = [ids, tt, padding_mask(torch, rs, n * B, S)[0], mlm, nsp]
    graph = fit_amp_run(torch, K, "graph", data, B)
    eager = fit_amp_run(torch, K, "eager", data, B)
    if graph["losses"] != eager["losses"] or not all(
            torch.equal(x, y) for x, y in zip(graph["params"],
                                              eager["params"])):
        fail(f"fit-amp: graph losses {graph['losses']} against eager "
             f"{eager['losses']} (or the parameters) differ")
    if not all(math.isfinite(x) for x in graph["losses"] +
               graph["plain_losses"]):
        fail(f"fit-amp: losses {graph['losses']} (plain fit "
             f"{graph['plain_losses']}) not all finite")
    key = (True, torch.bfloat16, "O1")
    if graph["captures_amp"] != 1 or graph["sigs"] != [key] \
            or graph["captures_plain"] != 2 \
            or sorted(map(str, graph["sigs_after"])) != sorted(
                map(str, [key, (False,)])):
        fail(f"fit-amp: captures {graph['captures_amp']} then "
             f"{graph['captures_plain']}, signatures {graph['sigs_after']}")
    if graph["dtypes"] != {"torch.float32"}:
        fail(f"fit-amp: parameters {graph['dtypes']} under O1")
    traced = {k: v / 2 for k, v in graph["traced"].items() if v}
    p50 = float(np.median(graph["times"][1:]))
    p50_e = float(np.median(eager["times"][1:]))
    n_params = sum(x.numel() for x in graph["params"])
    flops = 6.0 * n_params * B * S + 12 * 12 * S * S * 768 * B
    busy, wall = graph["busy"]
    log(f"[fit-amp] BertConfig() float32 parameters, Model.fit under "
        f"auto_cast(level='O1', dtype='bfloat16'), AdamW(1e-4, wd 0.01), "
        f"B={B} S={S} padded on {card}: graph losses {graph['losses']} "
        f"bitwise the eager step's, parameters too; captures: 1 under "
        f"auto_cast, then a plain fit's own ({graph['sigs_after']}), "
        f"{graph['replays']} replays; plain fit losses "
        f"{graph['plain_losses']}; step p50 graph {p50:.3f} ms / eager "
        f"{p50_e:.3f} ms (steps 2-{AMP_FIT_STEPS}); {B / p50 * 1e3:.1f} "
        f"samples/s; {mfu_text(flops, p50 / 1e3)}; launches at the "
        f"warm-up and the capture {graph['counts']}; traced launches a "
        f"replay {traced}; instantiations in 2 replays {graph['forms']}; "
        f"busy {busy:.3f} of {wall:.3f} ms ({100 * busy / wall:.2f}%)")
    return graph["counts"], traced, {
        "p50_ms": p50, "eager_p50_ms": p50_e, "samples_s": B / p50 * 1e3,
        "mfu": flops / (p50 / 1e3) / PEAK_BF16_TENSOR,
        "forms_a_step": {k: v / 2 for k, v in graph["forms"].items()}}


# -- float16 paged decode, float16 serving, LeNet, ResNet-50 ---------------
# the float16 instantiations the float16 serving wave must launch, as the
# trace names them (prefill: the flash forward; decode: paged decode in
# the graph; LayerNorm and the bias-GeLU forward in both)
FP16_SERVE_FORMS = {
    "paged_decode_attention f16": ("paged_decode_split_kernel", "__half"),
    "flash_attention f16": ("flash_fwd_mma_kernel", "__half"),
    "layer_norm f16": ("layer_norm_warp_kernel", "__half", "__half"),
    "bias_gelu f16": ("bias_gelu_fwd_vec_kernel", "__half", "__half")}
FP16_NEW = 32              # new tokens a request of the float16 wave
LENET_TARGET = 0.97        # BASELINE.md config 1's eval accuracy bar
LENET_MAX_EPOCHS = 10
R50_B = 128                # BASELINE.md config 2's batch on one card
R50_FLOPS_IMAGE = 3 * 4.1e9  # train flops an image: 3 x the 4.1 GFLOP fwd
R50_STEPS = 20             # dygraph steps on one batch (the loss falls)
R50_FIT_STEPS = 12         # Model.fit steps a timed run
# device kernels of the ResNet-50 step by family, matched in this order
# against the trace's kernel names (cuDNN's, ATen's and the port's)
R50_FAMILIES = (
    ("softmax cross-entropy", r"xent_(fwd|bwd)_kernel"),
    ("optimizer", r"multi_tensor_kernel|norm_partials_kernel|"
     r"norm_update_kernel"),
    ("batch norm", r"batch_norm|bn_fw|bn_bw|bn_fwd|bn_bwd|welford"),
    ("pooling", r"pool"),
    ("conv backward (dgrad, wgrad)", r"dgrad|wgrad|convolve_dgrad|"
     r"wgrad_alg|conv2d_grouped_direct_filter|backward_data|"
     r"backward_filter"),
    ("conv forward", r"fprop|conv|implicit|xmma|cudnn|cutlass|sm90|sm80"),
    ("conv as GEMM (cuDNN's nvjet kernels: 1x1 convs, their backward, "
     "the fc)", r"nvjet"),
    ("layout transform", r"nchwToNhwc|nhwcToNchw|transpose"),
    ("GEMM (fc)", r"gemm|Gemm"),
    ("memcpy / memset", r"^Memcpy|^Memset"),
    ("elementwise and reductions", r"elementwise|reduce|fill|copy|"
     r"index|scatter|gather|threshold|where|add|mul"))


def paged_f16_phase(torch, K):
    """[kernels] paged_decode float16: the split kernel on a float16 pool
    against its plain version at the serving table's shape and a serving
    wave's, each timed beside the same kernel on bf16 inputs of that
    shape in this run, and the lane kernel on an unaligned float16 q.
    Returns the table case's record (``bf16_ms`` beside ``ms``)."""
    g = torch.Generator(device="cuda").manual_seed(41)
    recs = {}
    for case, lane_pos in (
            ("table", (511, 15, 16, 100, 255, 37, 480, -1)),
            ("wave", (20, 176, 57, 131, 88, 160, 35, 113))):
        rec = paged_case(torch, K, g, torch.float16, case, lane_pos, ps=16,
                         hd=64)
        rec["bf16_ms"] = paged_case(torch, K, g, torch.bfloat16, case,
                                    lane_pos, ps=16, hd=64)["ms"]
        log(f"[kernels] paged_decode float16 {case}: {rec['ms']} ms "
            f"against bf16's {rec['bf16_ms']} ms at the same shape "
            f"(bound {rec['bound_ms']} ms by {rec['bound_by']})")
        recs[case] = rec
    paged_case(torch, K, g, torch.float16, "unaligned",
               (511, 15, 16, 100, 255, 37, 480, -1), ps=16, hd=64,
               variant="lane", q_offset=1)
    return recs["table"]


def fp16_serve_phase(torch, K, card):
    """GPT-2-small (GPTConfig(), dropout 0) cast to float16 with
    ``astype`` behind GenerationEngine at the reference's defaults
    (prefix cache on, its decode step captured at start()): 16 greedy
    requests (prompts 20-128) and 4 that share a 64-token prefix, under
    the profiler; the same traffic through a second engine whose step is
    ``_step_eager``: tokens identical.  Fails unless the pool is float16,
    the decode graph replayed, the trace's paged decode launches are the
    eager ones plus the graph's x its replays, every FP16_SERVE_FORMS
    instantiation launched, the shared prompts hit the prefix cache, and
    a model made float16 by ``amp.decorate(level="O2")`` serves the same
    tokens.  Returns {launches (the eager ones and the graph's x its
    replays), traced_launches, replays, ...}."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = GPTConfig(dropout=0.0, attn_dropout=0.0)
    seed(0)
    model = GPTForCausalLM(cfg, device="cuda")
    model.astype("float16")
    model.eval()
    rng = np.random.RandomState(43)
    prefix = rng.randint(0, cfg.vocab_size, 64).tolist()
    shared = [prefix + rng.randint(0, cfg.vocab_size, k).tolist()
              for k in (8, 20, 33, 47)]
    prompts = wave_prompts(cfg.vocab_size, 44)

    def traffic(eng):
        outs, wall = serve_wave(eng, prompts, FP16_NEW, sampled=False)
        # one request of the prefix first (a miss), then the others (hits)
        outs += [eng.generate(shared[0], FP16_NEW, timeout=600)]
        more, _ = serve_wave(eng, shared[1:], FP16_NEW, sampled=False)
        wait_idle(eng)
        return outs + more, wall

    engines = {}
    try:
        for form in ("graph", "eager"):
            eng = GenerationEngine(model, device=model.device,
                                   **SERVING_ENGINE).start()
            if form == "eager":
                eng.step = eng._step_eager
            engines[form] = eng
        g = engines["graph"]
        if g._state["kp"].dtype != torch.float16:
            fail(f"fp16-serve: the KV pool is {g._state['kp'].dtype}")
        fast = graph_check(g, "fp16-serve")
        K.reset_launch_counts()
        replays0 = g.replays
        (outs, wall), _, kernels = trace_window(torch, lambda: traffic(g))
        replays = g.replays - replays0
        eager = K.launch_counts()
        forms = require_instances(kernels, FP16_SERVE_FORMS, "fp16-serve")
        traced = traced_launches(kernels)
        paged = sum(traced["paged_decode_attention"].values())
        per = g.graph_launches.get("paged_decode_attention", 0)
        want = eager["paged_decode_attention"] + per * replays
        # the trace may miss at most a few whole replays at the window's
        # edge (1392 of 1488 in one run), never a part of one
        if replays <= 0 or per <= 0 or not 0 <= want - paged <= 8 * per \
                or (want - paged) % per:
            fail(f"fp16-serve: {paged} paged decode launches in the trace, "
                 f"against {eager['paged_decode_attention']} eager + "
                 f"{per} x {replays} replays")
        hits = g.metrics.snapshot()["prefix_cache_hits"]
        if hits < len(shared) - 1:
            fail(f"fp16-serve: {hits} prefix-cache hits for the "
                 f"{len(shared) - 1} prompts of a shared prefix")
        mark("fp16-serve: the traced wave")
        eager_outs, _ = traffic(engines["eager"])
        diff = [i for i, (a, b) in enumerate(zip(outs, eager_outs))
                if a != b]
        if diff or len(outs) != len(eager_outs):
            fail(f"fp16-serve: requests {diff} differ between the decode "
                 "graph and the eager decode step")
        for i, o in enumerate(outs):
            if len(o) != FP16_NEW or min(o) < 0 or max(o) >= cfg.vocab_size:
                fail(f"fp16-serve: request {i} gave {len(o)} tokens in "
                     f"[{min(o)}, {max(o)}]")
        pages = pages_accounted(g, "fp16-serve")
        mark("fp16-serve: the eager wave")
    finally:
        for eng in engines.values():
            eng.stop()
    seed(0)
    twin = amp.decorate(GPTForCausalLM(cfg, device="cuda"), level="O2",
                        dtype="float16").eval()
    t_eng = GenerationEngine(twin, device=twin.device,
                             **SERVING_ENGINE).start()
    try:
        twin_outs = [t_eng.generate(p, FP16_NEW, timeout=600)
                     for p in prompts[:4]]
    finally:
        t_eng.stop()
    if twin_outs != outs[:4]:
        fail("fp16-serve: the amp.decorate(O2, float16) model served other "
             "tokens than the astype('float16') one")
    total = sum(len(o) for o in outs[:len(prompts)])
    log(f"[fp16-serve] GPT-2-small in float16 (astype; a float16 KV pool) "
        f"on {card}: 16 greedy requests (prompts 20-128, {FP16_NEW} new "
        f"tokens) under the profiler, {total} tokens in {wall:.3f}s = "
        f"{total / wall:.1f} tokens/s, then 4 on a shared 64-token prefix "
        f"({hits} hits); decode graph captured {g.capture_count}x, "
        f"{replays} replays of {g.graph_launches} (fast launches {fast}); "
        f"paged decode launches in the trace {paged} of "
        f"{eager['paged_decode_attention']} eager + {per} x {replays} "
        f"replays = {want}; "
        f"float16 instantiations in the "
        f"trace {forms}; tokens identical to the eager decode step's and "
        f"to an amp.decorate(O2, float16) model's; {pages}")
    return {"launches": want, "traced_launches": paged, "replays": replays,
            "graph_launches_a_replay": per, "forms": forms}


def vision_xent_phase(torch, K):
    """softmax_xent forward and backward at the vision paths' shapes:
    ResNet-50's logits (N = 128, V = 1000, bf16) and LeNet's (N = 128,
    V = 10, float32), every row labelled, against the plain versions and
    F.cross_entropy / its backward.  Returns {"resnet50": (fwd, bwd),
    "lenet": (fwd, bwd)} records."""
    F = torch.nn.functional
    SX = K.softmax_xent
    g = torch.Generator(device="cuda").manual_seed(47)
    out = {}
    for path, V, dtype in (("resnet50", 1000, torch.bfloat16),
                           ("lenet", 10, torch.float32)):
        n = 128
        isz = torch.empty((), dtype=dtype).element_size()
        z = (4 * torch.randn(n, V, generator=g, device="cuda")).to(dtype)
        lab = torch.randint(0, V, (n,), generator=g, device="cuda")
        gr = torch.full((n,), 1.0 / n, device="cuda")
        loss, lse = SX.softmax_xent_fwd(z, lab)
        logp = torch.log_softmax(z, -1)
        zero = torch.zeros((), dtype=dtype, device="cuda")
        gd = gr.to(dtype)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        desc = f"{tag} {path} N={n} V={V}"
        rec_f = compare(
            torch, f"softmax_xent {desc}",
            lambda: SX.softmax_xent_fwd(z, lab),
            lambda: SX.softmax_xent_plain(z, lab),
            lambda: F.cross_entropy(z, lab, reduction="none"), dtype,
            n * V * isz + 16 * n, 4 * n * V, PEAK_F32)
        rec_b = compare(
            torch, f"softmax_xent_bwd {desc}",
            lambda: SX.softmax_xent_bwd(z, lab, lse, gr),
            lambda: SX.softmax_xent_bwd_plain(z, lab, lse, gr),
            lambda: torch.ops.aten._log_softmax_backward_data(
                torch.ops.aten.nll_loss_backward(
                    gd, logp, lab, None, 0, -100, zero), logp, 1, dtype),
            dtype, 2 * n * V * isz + 16 * n, 4 * n * V, PEAK_F32)
        out[path] = (rec_f, rec_b)
    torch.cuda.synchronize()
    return out


def drain_stamps(engine):
    """Host times at the end of each of ``engine``'s fetches that brought
    a step's loss (the fetch waits for the step): its drain() and, where a
    metric makes fit() fetch every step, its ring's drain_with().  fit()'s
    begin() makes the ring anew, so the wrapper goes on each one."""
    stamps, begin = [], engine._begin

    def begun():
        out = begin()
        fetch = engine.ring.drain_with

        def stamped(extra):
            losses, host = fetch(extra)
            if losses:
                stamps.append(time.perf_counter())
            return losses, host

        engine.ring.drain_with = stamped
        return out

    engine._begin = begun
    return stamps


def first_samples(torch, data, n):
    """The first ``n`` samples of ``data`` collated once, as a
    TensorDataset (a synthetic dataset draws its noise at each
    __getitem__)."""
    import paddle_tpu_torch as ptt

    return ptt.io.TensorDataset(
        [torch.stack([torch.from_numpy(data[i][0]) for i in range(n)]),
         torch.from_numpy(np.stack([data[i][1] for i in range(n)]))])


def lenet_model(torch, K, form="graph"):
    """LeNet() from seed 0 on the card behind Model with Adam(1e-3),
    CrossEntropyLoss and Accuracy, as bench.py's body_mnist, with its
    train engine (the eager step for ``form`` "eager"): (net, model,
    the engine's drain stamps)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.hapi.engine import TrainEngine
    from paddle_tpu_torch.vision.models import LeNet

    seed(0)
    net = LeNet()
    model = ptt.Model(net)
    model.prepare(ptt.optimizer.Adam(learning_rate=1e-3,
                                     parameters=net.parameters()),
                  ptt.nn.CrossEntropyLoss(), ptt.metric.Accuracy())
    engine = model._engine = TrainEngine(model)
    if form == "eager":
        engine.step = engine._step_eager
    return net, model, drain_stamps(engine)


def lenet_phase(torch, K, card):
    """BASELINE.md config 1: LeNet on synthetic MNIST (2048 training, 512
    test samples) through Model.fit's captured step, fit(batch_size=128,
    epochs=1) until evaluate(batch_size=256) reaches LENET_TARGET, at most
    LENET_MAX_EPOCHS; then an epoch through ``_step_eager`` from the same
    seed (step p50 beside the graph's); then, under
    cudnn.deterministic, 3 steps graph against eager from one seed on the
    same batches: losses and parameters bitwise equal; then Adam(1e-3)'s
    multi_tensor_step over LeNet's float32 tree bitwise against the
    per-parameter loop, and its device ms.  Float32 with TF32 off.  Fails
    unless the target is reached, the cross-entropy kernels launched (the
    wrappers' counts at the warm-up and the capture, and the trace of 2
    replayed steps).  Returns (counts, record)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.vision.datasets import MNIST

    train, test = MNIST(mode="train"), MNIST(mode="test")
    if not (train.synthetic and len(train) == 2048 and len(test) == 512):
        fail(f"lenet: MNIST is not the 2048 / 512 synthetic split "
             f"({len(train)}, {len(test)})")
    net, model, stamps = lenet_model(torch, K)
    K.reset_launch_counts()
    graph_ms, accs = [], []
    for epoch in range(LENET_MAX_EPOCHS):
        k = len(stamps)
        model.fit(train, batch_size=128, epochs=1, verbose=0)
        graph_ms.extend(np.diff(stamps[k:]) * 1e3)
        res = model.evaluate(test, batch_size=256, verbose=0)
        accs.append(float(res["acc"]))
        if accs[-1] >= LENET_TARGET:
            break
    counts = K.launch_counts()
    if accs[-1] < LENET_TARGET:
        fail(f"lenet: eval accuracy {accs} after {len(accs)} epochs, not "
             f"{LENET_TARGET}")
    for name in XENT_KERNELS:
        if counts[name] <= 0:
            fail(f"lenet: {name} was not launched ({counts})")
    engine = model._engine
    _, wall_ms, kernels = trace_window(
        torch, lambda: model.fit(first_samples(torch, train, 256),
                                 batch_size=128, shuffle=False, verbose=0))
    traced, _ = require_traced(kernels, "lenet", XENT_KERNELS)
    if engine.captures != 1:
        fail(f"lenet: {engine.captures} captures for one batch signature")
    # the step without the synthetic dataset's per-sample noise draws:
    # the epoch's batches collated once, graph then eager
    whole = first_samples(torch, train, len(train))
    k = len(stamps)
    model.fit(whole, batch_size=128, shuffle=False, verbose=0)
    pre_ms = np.diff(stamps[k:]) * 1e3
    # the eager step from the same seed, one epoch
    net_e, model_e, stamps_e = lenet_model(torch, K, "eager")
    model_e.fit(train, batch_size=128, epochs=1, verbose=0)
    eager_ms = np.diff(stamps_e) * 1e3
    k = len(stamps_e)
    model_e.fit(whole, batch_size=128, shuffle=False, verbose=0)
    pre_e_ms = np.diff(stamps_e[k:]) * 1e3
    # bitwise: 3 steps graph against eager on the same batches
    first = first_samples(torch, train, 384)
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for form in ("graph", "eager"):
            n_, m_, _ = lenet_model(torch, K, form)
            hist = m_.fit(first, batch_size=128, shuffle=False, verbose=0,
                          log_freq=1)
            runs.append((hist["step_loss"],
                         [p.detach().clone() for p in n_.parameters()]))
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, pg), (le, pe) = runs
    if len(lg) != 3 or lg != le or not all(torch.equal(a, b)
                                           for a, b in zip(pg, pe)):
        fail(f"lenet: graph losses {lg} against eager {le} (or the "
             "parameters) differ")
    # the path's optimizer kernel at its own tree: Adam(1e-3), float32
    net_o, _, _ = lenet_model(torch, K)
    opt, opt_err, _ = optimizer_tree_check(
        torch, net_o, make=lambda ps: ptt.optimizer.Adam(
            learning_rate=1e-3, parameters=ps))
    KO = K.optimizer
    opt_rec = tree_step_record(torch, K, opt, list(net_o.parameters()),
                               1e-3, library=fused_adam(torch))
    ((_, chunk0, chunk),) = KO.chunk_groups(
        [p.numel() for p in net_o.parameters()],
        sm_count=KO.sm_count("cuda"))
    opt_rec.update(max_abs_err=opt_err, chunk=chunk, blocks=chunk0[-1])
    del net_o, opt
    p50, p50_e = float(np.median(graph_ms)), float(np.median(eager_ms))
    pre, pre_e = float(np.median(pre_ms)), float(np.median(pre_e_ms))
    log(f"[lenet] LeNet float32 (TF32 off), Adam(1e-3), CrossEntropyLoss, "
        f"Accuracy, synthetic MNIST 2048 / 512, fit(batch_size=128) on "
        f"{card}: eval accuracy {accs} -> {accs[-1]:.4f} >= {LENET_TARGET} "
        f"after {len(accs)} epoch(s); step p50 graph {p50:.3f} ms / eager "
        f"{p50_e:.3f} ms (each step to its loss and accuracy fetch; cuDNN "
        f"deterministic off; the synthetic samples' noise drawn on the "
        f"host each step); on the epoch collated once, graph {pre:.3f} ms "
        f"/ eager {pre_e:.3f} ms ({128 / pre * 1e3:.1f} samples/s); "
        f"captures "
        f"{engine.captures}, replays {engine.replays}; wrapper launches "
        f"(warm-up and captures, eval included) {counts}; traced launches "
        f"in 2 replayed steps {traced}; 3 steps under cudnn.deterministic "
        f"graph bitwise eager (losses {lg}, every parameter) | "
        f"multi_tensor_step Adam(1e-3): 3 steps bitwise the per-parameter "
        f"loop over LeNet's {opt_rec['tensors']} float32 tensors (max |d| "
        f"{opt_err}); one update of {opt_rec['elements']} elements in "
        f"{opt_rec['blocks']} blocks of {opt_rec['chunk']}: device "
        f"ms kernel={opt_rec['ms']} plain loop={opt_rec['plain_ms']} "
        f"bound={opt_rec['bound_ms']} ({opt_rec['bound_by']}, "
        f"{opt_rec['bytes']} bytes) library (torch._fused_adam_)="
        f"{opt_rec['library_ms']}")
    return counts, {"epochs": len(accs), "acc": accs[-1], "p50_ms": p50,
                    "eager_p50_ms": p50_e, "collated_p50_ms": pre,
                    "collated_eager_p50_ms": pre_e,
                    "traced_a_step": {k: traced[k] / 2 for k in
                                      XENT_KERNELS + ("multi_tensor_step",)},
                    "optimizer": opt_rec}


class _RepeatBatch:
    """One batch's samples, served ``steps`` times over (a Dataset)."""

    def __init__(self, x, y, steps):
        self.x, self.y, self.n = x, y, x.shape[0] * steps

    def __getitem__(self, i):
        i %= self.x.shape[0]
        return self.x[i], self.y[i]

    def __len__(self):
        return self.n


def r50_model(torch, lr=0.1):
    """resnet50(num_classes=1000) from seed 0 in bf16 with
    Momentum(lr, 0.9), as bench.py's body_resnet50."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.vision.models import resnet50

    seed(0)
    model = resnet50(num_classes=1000)
    model.astype("bfloat16")
    opt = ptt.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                 parameters=model.parameters())
    return model, opt


def r50_fit(torch, form, x, y, steps, log_freq=1):
    """A fresh ResNet-50 behind Model.fit for ``steps`` steps of the batch
    (x, y) on the host (its collation and pinned copy in every step):
    (model, api, engine, losses, step ms to each drain)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.hapi.engine import TrainEngine

    model, opt = r50_model(torch)
    api = ptt.Model(model).prepare(opt, ptt.nn.CrossEntropyLoss())
    engine = api._engine = TrainEngine(api)
    if form == "eager":
        engine.step = engine._step_eager
    stamps = drain_stamps(engine)
    t0 = time.perf_counter()
    losses = api.fit(_RepeatBatch(x, y, steps), batch_size=x.shape[0],
                     shuffle=False, verbose=0,
                     log_freq=log_freq)["step_loss"]
    return model, api, engine, losses, np.diff([t0] + stamps[:steps]) * 1e3


def r50_families(kernels):
    """{family: (device ms, launches)} of a trace's device events by
    R50_FAMILIES, and the names that fell to "other"."""
    fam, other = {}, []
    for t, key, c in kernels:
        for name, pat in R50_FAMILIES:
            if re.search(pat, key):
                break
        else:
            name = "other"
            other.append((t, key[:70], c))
        ms, n = fam.get(name, (0.0, 0))
        fam[name] = (ms + t, n + c)
    return fam, sorted(other, reverse=True)[:6]


def resnet50_phase(torch, K, card):
    """BASELINE.md config 2 on one card: resnet50(num_classes=1000) in
    bf16, Momentum(0.1, 0.9), B = 128 images of 3 x 224 x 224 from
    RandomState(0) (bf16 on the host), labels in [0, 1000).  A dygraph
    loop of R50_STEPS steps on the batch (the loss must fall; the
    wrappers' launches counted over it), then Model.fit through the
    captured step and through ``_step_eager`` (R50_FIT_STEPS each, graph
    then eager), 2 replayed steps under the profiler (busy share, device
    ms by family, launches a step), the host ms of one batch's collation
    and pinned copy, and the peak memory; then, under
    cudnn.deterministic, 3 fit steps graph against eager from one seed:
    losses, parameters and running statistics bitwise equal; then
    Momentum(0.1, 0.9)'s multi_tensor_step over ResNet-50's bf16 tree
    bitwise against the per-parameter loop, and its device ms.  Returns
    (the dygraph loop's counts, record)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.place import copy_to_device
    from paddle_tpu_torch.io import default_collate_fn

    if torch.backends.cudnn.benchmark:
        fail("resnet50: cudnn.benchmark is on: cuDNN would autotune "
             "inside the capture")
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(R50_B, 3, 224, 224).astype(
        np.float32)).to(torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, 1000, (R50_B,)).astype(np.int64))
    xd, yd = x.cuda(), y.cuda()
    model, opt = r50_model(torch)
    n_params = sum(p.numel() for p in model.parameters())
    loss_fn = ptt.nn.CrossEntropyLoss()
    model.train()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses, times = [], []
    for _ in range(R50_STEPS):
        t0 = time.perf_counter()
        loss = loss_fn(model(xd), yd)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        times.append((time.perf_counter() - t0) * 1e3)
    counts = K.launch_counts()
    peak_dygraph = peak_text(torch, base)
    for name in XENT_KERNELS + ("multi_tensor_step",):
        if counts[name] <= 0:
            fail(f"resnet50: {name} was not launched in the dygraph loop")
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        fail(f"resnet50: dygraph losses {losses} do not fall")
    dy_p50 = float(np.median(times[1:]))
    del model, opt, loss
    release(torch, "resnet50 fit")
    mark("resnet50: the dygraph loop")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model, api, engine, g_losses, g_ms = r50_fit(torch, "graph", x, y,
                                                 R50_FIT_STEPS)
    peak_fit = peak_text(torch, base)
    # the same graph with one drain at the epoch's end: the host collates
    # the next batch while the card runs the step before
    t0 = time.perf_counter()
    api.fit(_RepeatBatch(x, y, R50_FIT_STEPS), batch_size=R50_B,
            shuffle=False, verbose=0, log_freq=0)
    piped_ms = (time.perf_counter() - t0) * 1e3 / R50_FIT_STEPS
    _, wall_ms, kernels = trace_window(
        torch, lambda: api.fit(_RepeatBatch(x, y, 2), batch_size=R50_B,
                               shuffle=False, verbose=0))
    traced, _ = require_traced(kernels, "resnet50 fit",
                               XENT_KERNELS + ("multi_tensor_step",))
    if engine.captures != 1 or engine.replays != 2 * R50_FIT_STEPS + 1:
        fail(f"resnet50: {engine.captures} captures, {engine.replays} "
             f"replays in {2 * R50_FIT_STEPS + 2} steps of one signature")
    busy = sum(t for t, _, _ in kernels)
    launches = sum(c for _, _, c in kernels) / 2
    fam, other = r50_families(kernels)
    # the host's copy of one batch: collation of 128 samples, then the
    # pinned staging and the copy to the card
    samples = [(x[i], y[i]) for i in range(R50_B)]
    t0 = time.perf_counter()
    xb, yb = default_collate_fn(samples)
    t1 = time.perf_counter()
    dst = torch.empty(xb.shape, dtype=xb.dtype, device="cuda")
    copy_to_device(dst, xb)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    collate_ms, copy_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    del model, api, engine, dst
    release(torch, "resnet50 eager fit")
    _, _, engine_e, e_losses, e_ms = r50_fit(torch, "eager", x, y,
                                             R50_FIT_STEPS)
    del engine_e
    release(torch, "resnet50 bitwise")
    mark("resnet50: the graph and eager fits")
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for form in ("graph", "eager"):
            m_, _, e_, l_, _ = r50_fit(torch, form, x, y, 3)
            runs.append((l_, [t.detach().clone() for t in
                              (*m_.parameters(), *m_.buffers())]))
            del m_, e_
            release(torch, f"resnet50 bitwise {form}")
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, tg), (le, te) = runs
    if lg != le or len(tg) != len(te) or not all(
            torch.equal(a, b) for a, b in zip(tg, te)):
        fail(f"resnet50: under cudnn.deterministic the graph's losses {lg} "
             f"against the eager step's {le} (or the parameters, or the "
             "running statistics) differ")
    del runs, tg, te
    # the path's optimizer kernel at its own tree: Momentum(0.1, 0.9) over
    # the bf16 parameters (velocities in bf16)
    model, _ = r50_model(torch)
    opt, opt_err, _ = optimizer_tree_check(
        torch, model, make=lambda ps: ptt.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, parameters=ps))
    opt_rec = tree_step_record(torch, K, opt, list(model.parameters()), 0.1,
                               library=fused_sgd(torch, 0.9))
    if opt_rec["kind"] != "momentum":
        fail(f"resnet50 optimizer: Momentum took the {opt_rec['kind']} "
             "rule")
    opt_rec["max_abs_err"] = opt_err
    del model, opt
    p50 = float(np.median(g_ms[1:]))
    p50_e = float(np.median(e_ms[1:]))
    flops = R50_FLOPS_IMAGE * R50_B
    device_ms = busy / 2

    def mfu(ms):
        return flops / (ms / 1e3) / PEAK_BF16_TENSOR
    fams = "; ".join(f"{k} {v[0] / 2:.3f} ms x{v[1] / 2:g}"
                     for k, v in sorted(fam.items(), key=lambda kv: -kv[1][0]))
    per_step = {k: v / 2 for k, v in traced.items() if v}
    log(f"[resnet50] resnet50(num_classes=1000) bf16, Momentum(0.1, 0.9), "
        f"B={R50_B} x 3 x 224 x 224 (RandomState(0)), {n_params} "
        f"parameters, NCHW at the interface and channels-last inside, "
        f"on {card}: dygraph {R50_STEPS} steps, losses "
        f"{losses[0]:.5f} -> {losses[-1]:.5f} (falling), step p50 "
        f"{dy_p50:.3f} ms, peak {peak_dygraph}; Model.fit step p50 graph "
        f"{p50:.3f} ms / eager {p50_e:.3f} ms (steps 2-{R50_FIT_STEPS}, "
        f"each to its loss's drain, the batch's collation and pinned copy "
        f"included; cudnn.deterministic off, benchmark off), "
        f"{R50_B / p50 * 1e3:.1f} samples/s; with one drain an epoch "
        f"{piped_ms:.3f} ms a step, {R50_B / piped_ms * 1e3:.1f} "
        f"samples/s; device ms a step (the profiled replays' busy time) "
        f"{device_ms:.3f}, {R50_B / device_ms * 1e3:.1f} samples/s; MFU "
        f"{mfu(p50):.4f} at the drain-a-step p50, {mfu(piped_ms):.4f} at "
        f"one drain an epoch, {mfu(device_ms):.4f} at the device ms (3 x "
        f"4.1e9 x {R50_B} images / step ms / 9.89e14 FLOP/s: 4.1e9 counts "
        f"the forward's multiply-adds, so at 2 flops a multiply-add each "
        f"MFU doubles), peak {peak_fit}; "
        f"2 profiled replays: busy {busy:.3f} of {wall_ms:.3f} ms "
        f"({100 * busy / wall_ms:.2f}%), {launches:g} launches a step, "
        f"device ms a step by family: {fams}; other kernels {other}; "
        f"traced launches a step {per_step}; "
        f"host ms of one batch: collation {collate_ms:.3f}, pinned copy "
        f"{copy_ms:.3f}; graph losses {g_losses[:3]}...; 3 steps under "
        f"cudnn.deterministic: graph bitwise eager (losses {lg}, every "
        f"parameter and running statistic) | multi_tensor_step Momentum("
        f"0.1, 0.9): 3 steps bitwise the per-parameter loop over "
        f"ResNet-50's {opt_rec['tensors']} bf16 tensors, bf16 velocities "
        f"(max |d| {opt_err}); one update of {opt_rec['elements']} "
        f"elements: device ms kernel={opt_rec['ms']} plain loop="
        f"{opt_rec['plain_ms']} bound={opt_rec['bound_ms']} "
        f"({opt_rec['bound_by']}, {opt_rec['bytes']} bytes) library "
        f"(torch._fused_sgd_)={opt_rec['library_ms']} | eager ms "
        f"kernel={opt_rec['eager_ms']} plain={opt_rec['plain_eager_ms']}")
    return counts, {"p50_ms": p50, "eager_p50_ms": p50_e,
                    "dygraph_p50_ms": dy_p50, "one_drain_ms": piped_ms,
                    "device_ms": device_ms,
                    "samples_s": R50_B / p50 * 1e3, "mfu": mfu(p50),
                    "collate_ms": collate_ms, "copy_ms": copy_ms,
                    "traced_a_step": {k: traced[k] / 2 for k in
                                      XENT_KERNELS + ("multi_tensor_step",)},
                    "launches_a_step": launches, "optimizer": opt_rec}


# ---------------------------------------------------------------------------
# the rest of the single-card training step: the remaining
# optimizers' rules over the BERT-base and LeNet trees, the wrappers in
# dygraph, BERT-base through Model.fit with Lamb and gradient accumulation,
# ResNet-50 through Model.fit with LarsMomentum
# ---------------------------------------------------------------------------
NEW_RULES = {   # each rule the kernels gained, as a user builds it
    "adagrad": lambda O, R, ps: O.Adagrad(
        0.01, initial_accumulator_value=0.1, parameters=ps),
    "adamax": lambda O, R, ps: O.Adamax(1e-3, parameters=ps),
    "adadelta": lambda O, R, ps: O.Adadelta(1.0, parameters=ps),
    "rmsprop": lambda O, R, ps: O.RMSProp(1e-3, parameters=ps),
    "rmsprop_centered": lambda O, R, ps: O.RMSProp(
        1e-3, momentum=0.9, centered=True, parameters=ps),
    "ftrl": lambda O, R, ps: O.Ftrl(0.1, l1=1e-4, l2=1e-4, parameters=ps),
    "sgd_l1": lambda O, R, ps: O.SGD(0.01, weight_decay=R.L1Decay(1e-4),
                                     parameters=ps),
    # the norm rules at learning rates whose 3 steps move a bf16 element
    # several ulps (Lamb about 5 % of each tensor's norm a step, LARS about
    # 1 %, Dpsgd's noise about 0.03), so that the check of the kernel's
    # step against the loop's sees the update
    "lamb": lambda O, R, ps: O.Lamb(0.05, lamb_weight_decay=0.01,
                                    parameters=ps),
    "lars": lambda O, R, ps: O.LarsMomentum(10.0, parameters=ps),
    "dpsgd": lambda O, R, ps: O.Dpsgd(1.0, clip=1.0, batch_size=32,
                                      sigma=1.0, parameters=ps),
}
NORM_RULES = ("lamb", "lars", "dpsgd")
# why a rule has no library yardstick: torch.optim's foreach forms issue
# several calls, and no one call computes these functions
NO_LIBRARY = "none (no single PyTorch call computes this rule)"
# [bert-lamb-accum]: Lamb's learning rate, one at which the seeded loss
# falls within the phase (from 5e-3 up, its first steps overshoot further)
LAMB_LR = 2e-3
ACCUM = 4                # microbatches a step
ACC_B, ACC_S = 128, 128  # the global batch (32 a microbatch) and length
ACC_STEPS = 6            # timed steps a run
# [resnet50-lars]: LarsMomentum's learning rate (its local rate scales each
# tensor's step to lars_coeff * ||w|| / ||g||, so a base rate of a few
# units moves ResNet-50; at 20 the seeded loss rises)
LARS_LR = 5.0


def fused_adagrad(torch):
    """``torch._fused_adagrad_`` as a yardstick of Adagrad (m += g^2; p -=
    lr g / (sqrt(m) + eps)): where this PyTorch has no kernel of it on the
    card, ``library_or_none`` logs so and the row says none."""
    steps = {}

    def call(params, grads, slots, lr):
        if "t" not in steps:
            steps["t"] = [torch.full((), 2.0, device=p.device)
                          for p in params]
        torch._fused_adagrad_(params, grads, [s[0] for s in slots],
                              steps["t"], lr=lr, lr_decay=0.0,
                              weight_decay=0.0, eps=1e-6, maximize=False)
    return call


def optimizers_phase(torch, K, card):
    """[optimizers]: each rule the kernels gained (NEW_RULES) over
    BERT-base's bf16 tree (206 tensors) and LeNet's float32 tree: 3 steps
    of step() against step_plain() (the per-parameter loop) from the same
    gradients, the elementwise rules bitwise, the norm rules within
    NORM_RTOL / NORM_BF16_RTOL; the kernel's launches (one a step and
    tree, two for the norm rules); one update of the BERT tree timed from
    a replayed graph against the loop, its bound (bytes at 3.35 TB/s,
    counting the rule's slots) and, for Adagrad, torch._fused_adagrad_.
    Then Dpsgd's noise over 2**20 elements: mean and standard deviation
    within 5 standard errors of N(0, 1), bitwise again from the same seed
    and bitwise its plain version (torch's log, cos and sin on the card),
    and sigma = 0 with gradients under the clip bitwise SGD.  Returns
    {rule: record}."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.vision.models import LeNet

    O, R, KO = ptt.optimizer, ptt.regularizer, K.optimizer
    seed(0)
    bert = BertForPretraining(BertConfig(dropout=0.0), device="cuda",
                              dtype=torch.bfloat16)
    seed(0)
    lenet = LeNet()
    # each rule starts from the same trees: the timing repeats one update
    # many times over the same gradients, which drives a rule's slots
    # where no training would take them
    start = {m: [p.detach().clone() for p in m.parameters()]
             for m in (bert, lenet)}
    breakdowns = norm_breakdowns(torch, K, bert, "BERT-base")
    lenet_breakdowns = norm_breakdowns(torch, K, lenet, "LeNet")
    recs = {}
    for rule, make in NEW_RULES.items():
        kernel = KO.multi_tensor_norm_step if rule in NORM_RULES \
            else KO.multi_tensor_step
        before = kernel.launches
        errs, steps = {}, {}
        for tree, model in (("lenet", lenet), ("bert", bert)):
            with torch.no_grad():
                for p, v in zip(model.parameters(), start[model]):
                    p.copy_(v)
            opt, errs[tree], steps[tree] = optimizer_tree_check(
                torch, model, make=lambda ps: make(O, R, ps))
        launches = kernel.launches - before
        want = 2 * 3 * (2 if rule in NORM_RULES else 1)
        if launches != want or ptt.optimizer.Optimizer.plain_cuda_updates:
            fail(f"optimizers {rule}: {launches} kernel launches for 3 "
                 f"steps over two trees, not {want}")
        library = fused_adagrad(torch) if rule == "adagrad" else None
        rec = tree_step_record(torch, K, opt, list(bert.parameters()),
                               opt.get_lr(), library=library)
        rec.update(max_abs_err=max(errs.values()), launches=launches,
                   lenet_max_abs_err=errs["lenet"])
        how = "bitwise"
        if rule in NORM_RULES:
            rec["steps_vs_loop"] = steps
            rec["breakdown"] = breakdowns[rule]
            rec["lenet_breakdown"] = lenet_breakdowns[rule]
            how = (f"within its tolerance (steps: kernel vs loop "
                   f"{steps['bert']['step_rel_err']:.3e} bf16, "
                   f"{steps['lenet']['step_rel_err']:.3e} float32 of the "
                   f"loop's step; the loop at {NORM_PLANTED} x lr "
                   f"{steps['bert']['planted_rel_err']:.3e} and "
                   f"{steps['lenet']['planted_rel_err']:.3e}, refused) of")
        recs[rule] = rec
        lib = rec["library_ms"] if rec["library_ms"] is not None \
            else NO_LIBRARY
        log(f"[optimizers] {rule} ({rec['kind']}, {type(opt).__name__}) on "
            f"{card}: 3 steps {how} the per-parameter loop over BERT-base's "
            f"{rec['tensors']} bf16 tensors (max |d| {errs['bert']}) and "
            f"LeNet's float32 tree (max |d| {errs['lenet']}); kernel "
            f"launches {launches}; one update of {rec['elements']} elements: "
            f"device ms kernel={rec['ms']} plain loop={rec['plain_ms']} "
            f"bound={rec['bound_ms']} ({rec['bound_by']}, {rec['bytes']} "
            f"bytes) library={lib} | eager ms kernel={rec['eager_ms']} "
            f"plain={rec['plain_eager_ms']}")
        del opt
    del bert, lenet, start
    # Dpsgd's noise: lr -1 and zero gradients leave p = the noise
    n = 1 << 20
    p = torch.nn.Parameter(torch.zeros(n, device="cuda"))
    p.grad = torch.zeros(n, device="cuda")
    hyper = {"clip": 1.0, "sigma": 1.0, "batch_size": 1}
    scalars = KO.write_scalars(KO.make_scalars("cuda"), "dpsgd", -1.0, 1,
                               hyper)
    runs = []
    for _ in range(2):
        with torch.no_grad():
            p.zero_()
        KO.multi_tensor_norm_step("dpsgd", [p], [p.grad], [[]], -1.0, 1,
                                  hyper, scalars, 0x5EED)
        runs.append(p.detach().clone())
    torch.cuda.synchronize()
    z = runs[0]
    mean, std = z.mean().item(), z.std().item()
    se = 1 / math.sqrt(n)
    plain_err = (z - KO.dpsgd_noise_plain(0x5EED, 0, n, "cuda")).abs() \
        .max().item()
    if not torch.equal(runs[0], runs[1]) or abs(mean) > 5 * se \
            or abs(std - 1) > 5 * se / math.sqrt(2) or plain_err != 0:
        fail(f"optimizers dpsgd: noise mean {mean}, std {std} over {n} "
             f"(5 standard errors: {5 * se:.3e}, {5 * se / math.sqrt(2):.3e})"
             f", repeat bitwise {torch.equal(runs[0], runs[1])}, max |kernel"
             f" - plain| {plain_err:.3e}")
    g = torch.Generator(device="cuda").manual_seed(3)
    ps = [torch.nn.Parameter(torch.randn(4097, generator=g, device="cuda"))
          for _ in range(2)]
    twins = [torch.nn.Parameter(q.detach().clone()) for q in ps]
    for q, t in zip(ps, twins):
        q.grad = 1e-4 * torch.randn(4097, generator=g, device="cuda")
        t.grad = q.grad.clone()
    O.Dpsgd(0.1, clip=1.0, sigma=0.0, parameters=ps).step()
    O.SGD(0.1, parameters=twins).step()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(ps, twins)):
        fail("optimizers dpsgd: sigma = 0 under the clip is not SGD")
    recs["dpsgd"]["noise"] = {"elements": n, "mean": mean, "std": std,
                              "max_abs_vs_plain": plain_err}
    log(f"[optimizers] dpsgd noise over {n} elements: mean {mean:.3e}, std "
        f"{std:.6f} (within 5 standard errors of N(0, 1)), the same seed "
        f"bitwise, bitwise the plain version (max |d| {plain_err:.3e}); "
        f"sigma = 0 with gradients under the clip bitwise SGD")
    return recs


def tree_bytes(params, slots):
    """The bytes one update of the tree must move: each parameter read and
    written, each gradient read, each slot read and written once."""
    return sum(3 * p.numel() * p.element_size()
               + sum(2 * t.numel() * t.element_size() for t in s)
               for p, s in zip(params, slots))


# the elements of p's dtype that the two norm launches move for each
# element of the tree: Lamb reads p, g, m and v and writes m and v, then
# reads p, m and v and writes p; LARS reads p and g, then p, g and its
# velocity and writes p and the velocity; Dpsgd reads g, then p and g and
# writes p
NORM_SWEEPS = {"lamb": 10, "lars": 7, "dpsgd": 4}


def kernel_b_breakdown(torch, K, opt, params, lr, calls=5):
    """Kernel B over ``params`` in the rule of ``opt`` (its slots and the
    parameters' gradients in place): the device ms of one call (from a
    replayed graph); the device ms of a launch of each of its kernels,
    from a trace of one replay of a graph of ``calls`` calls, under
    ``per_launch`` where the trace holds its launches (a trace late in a
    long run can hold none of them); a copy twin
    (one ``copy_`` of float32 that reads and writes the bytes of the
    tree's bound, timed from a replayed graph); and the two launches'
    floor (the bytes they move, :data:`NORM_SWEEPS`, at 3.35 TB/s)."""
    KO = K.optimizer
    kind, hyper = opt._kernel_spec()
    hyper = opt._kernel_hyper(hyper)
    grads = [p.grad for p in params]
    slots = [[opt._slots[id(p)][n] for n in opt._slot_names()]
             for p in params]
    scalars = KO.write_scalars(KO.make_scalars("cuda"), kind, lr, 2, hyper)

    def one():
        KO.multi_tensor_norm_step(kind, params, grads, slots, lr, 2, hyper,
                                  scalars)

    call_ms = time_ms(torch, one, iters=5, reps=3)[0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            one()
    _, _, kernels = trace_window(torch, graph.replay)
    per = {}
    for name in TRACE_KERNELS["multi_tensor_norm_step"].values():
        hits = [(t, c) for t, key, c in kernels if name in key]
        n = sum(c for _, c in hits)
        if n:
            per[name] = {"ms": sum(t for t, _ in hits) / n, "traced": n}
    del graph
    n_bytes = tree_bytes(params, slots)
    src = torch.zeros(n_bytes // 8, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = time_ms(torch, lambda: dst.copy_(src), iters=5, reps=3)[0]
    del src, dst
    design = NORM_SWEEPS[kind] * sum(p.numel() * p.element_size()
                                     for p in params)
    rec = {"kind": kind, "ms": call_ms, "copy_twin_ms": copy_ms,
           "bytes": n_bytes, "design_bytes": design,
           "floor_ms": design / HBM_BYTES_PER_S * 1e3}
    if per:
        rec["per_launch"] = per
    return rec


def breakdown_text(r):
    per = ", ".join(f"{k} {v['ms']:.5f} ms (traced x{v['traced']})"
                    for k, v in r.get("per_launch", {}).items()) \
        or "no launch in the trace"
    return (f"{r['kind']}: one call {r['ms']:.5f} ms; by launch {per}; a "
            f"copy of the bound's {r['bytes']} bytes "
            f"{r['copy_twin_ms']:.5f} ms; the two launches' floor "
            f"{r['floor_ms']:.5f} ms ({r['design_bytes']} bytes)")


def norm_breakdowns(torch, K, model, tree):
    """``kernel_b_breakdown`` of each norm rule (NEW_RULES' optimizers)
    over ``model``'s parameters, after one step from seeded gradients
    (which makes the slots)."""
    import paddle_tpu_torch as ptt

    O, R = ptt.optimizer, ptt.regularizer
    params = list(model.parameters())
    out = {}
    for rule in NORM_RULES:
        g = torch.Generator(device="cuda").manual_seed(33)
        for p in params:
            p.grad = (1e-3 * torch.randn(*p.shape, generator=g,
                                         device="cuda")).to(p.dtype)
        opt = NEW_RULES[rule](O, R, params)
        opt.step()
        out[rule] = kernel_b_breakdown(torch, K, opt, params, opt.get_lr())
        log(f"[optimizers] Kernel B over {tree}'s {len(params)} "
            f"{str(params[0].dtype)[6:]} tensors, one call: "
            f"{breakdown_text(out[rule])}")
        del opt
    for p in params:
        p.grad = None
    return out


def optimizers_main():
    """``python3 chip_smoke.py --optimizers``: the build and the phases
    that hold the optimizer kernels, alone (the full run is the script
    without arguments)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import paddle_tpu_torch.ops.kernels as K
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    warnings.filterwarnings("error", message=ACCUMULATE_WARNING)
    card = device_and_build(torch, build)
    optimizer_phase(torch, K, GPTConfig(dropout=0.0, attn_dropout=0.0))
    for name, phase in (("lenet", lenet_phase), ("resnet50", resnet50_phase),
                        ("optimizers", optimizers_phase),
                        ("bert-lamb-accum", bert_lamb_accum_phase),
                        ("resnet50-lars", resnet50_lars_phase)):
        release(torch, name)
        mark(name)
        phase(torch, K, card)
        torch.cuda.synchronize()
    log(f"[time] the run took {time.perf_counter() - START:.1f}s")
    return 0


def wrappers_phase(torch, K, card):
    """[wrappers]: EMA (thres_steps) and ModelAverage over BERT-base's bf16
    tree in dygraph on the card, each beside the same wrapper over a CPU
    copy of the tree (its plain version: the same ops on the host): 4
    updates after the same seeded moves of the parameters, then apply()
    (averaged values within BF16_TOL of the CPU's) and restore() (the
    parameters bitwise what they were); update ms.  Lookahead(AdamW, k=2)
    for 4 dygraph steps of BERT-base at B = 8: the fast weights equal the
    slow ones right after each sync.  Model.fit refuses a wrapper, as the
    reference's does (AttributeError)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    O = ptt.optimizer
    cfg = BertConfig(dropout=0.0)
    seed(0)
    bert = BertForPretraining(cfg, device="cuda", dtype=torch.bfloat16)
    host = BertForPretraining(cfg, device="cpu", dtype=torch.bfloat16)
    host.set_state_dict(bert.state_dict())
    out = {}
    for name, make in (
            ("EMA", lambda ps: O.EMA(0.999, thres_steps=True,
                                     parameters=ps)),
            ("ModelAverage", lambda ps: O.ModelAverage(
                0.15, parameters=ps, min_average_window=2,
                max_average_window=3))):
        dev_ps, host_ps = list(bert.parameters()), list(host.parameters())
        w_dev, w_host = make(dev_ps), make(host_ps)
        g = torch.Generator(device="cuda").manual_seed(17)
        ms = []
        for _ in range(4):
            with torch.no_grad():
                for p, q in zip(dev_ps, host_ps):
                    d = (1e-3 * torch.randn(*p.shape, generator=g,
                                            device="cuda")).to(p.dtype)
                    p.add_(d)
                    q.add_(d.cpu())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w_dev.update()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            w_host.update()
        before = [p.detach().clone() for p in dev_ps]
        with w_dev.apply():
            avg = [p.detach().clone() for p in dev_ps]
        with w_host.apply():
            avg_host = [p.detach().clone() for p in host_ps]
        err, worst = 0.0, 0.0
        for a, b in zip(avg, avg_host):
            d = (a.float().cpu() - b.float()).abs().max().item()
            err = max(err, d)
            worst = max(worst, d / (BF16_TOL * max(
                1.0, b.float().abs().max().item())))
        restored = all(torch.equal(a, b) for a, b in zip(dev_ps, before))
        if worst > 1.0 or not restored:
            fail(f"wrappers {name}: averaged values off the CPU's by "
                 f"{err:.3e} ({worst:.2f} of BF16_TOL), restored {restored}")
        out[name] = {"update_ms": float(np.median(ms)), "max_abs_err": err}
        log(f"[wrappers] {name} over BERT-base's {len(dev_ps)} bf16 tensors "
            f"on {card}: 4 updates, apply() within BF16_TOL of the CPU "
            f"version's (max |d| {err:.3e}), restore() bitwise; update ms "
            f"{[round(t, 3) for t in ms]}")
        del w_dev, w_host
    del host
    rs = np.random.RandomState(13)
    ids, tt, mlm, nsp = (t.cuda() for t in bert_batch(torch, rs, cfg, 8, 128))
    la = O.LookaheadOptimizer(O.AdamW(1e-4, parameters=bert.parameters()),
                              alpha=0.5, k=2)
    losses, synced = [], []
    for step in range(4):
        loss = bert.loss(ids, mlm, nsp, tt)
        loss.backward()
        la.step()
        la.clear_grad()
        losses.append(float(loss.detach()))
        synced.append(all(torch.equal(p, s) for p, s in
                          zip(bert.parameters(), la._slow)))
    if synced != [False, True, False, True]:
        fail(f"wrappers Lookahead: fast weights equal to the slow ones "
             f"after steps {synced}, not [False, True, False, True]")
    api = ptt.Model(bert, labels=["mlm_labels", "nsp_labels"]).prepare(
        la, bert_fit_loss)
    try:
        api.fit(ptt.io.TensorDataset([ids.cpu(), tt.cpu(), mlm.cpu(),
                                      nsp.cpu()]), batch_size=8, verbose=0)
        fail("wrappers: Model.fit took a LookaheadOptimizer, which the "
             "reference's fit refuses")
    except AttributeError:
        pass
    log(f"[wrappers] Lookahead(AdamW(1e-4), alpha 0.5, k 2) over "
        f"BERT-base bf16 at B=8: losses {losses}; the fast weights equal "
        f"the slow ones after the syncs (steps 2 and 4) only; Model.fit "
        f"refuses it (AttributeError), as the reference's fit does")
    del bert, la, api
    return out


def lamb_accum_model(torch, form):
    """BertForPretraining(BertConfig()) (dropout 0.1) in bf16 from seed 0
    behind Model with Lamb(LAMB_LR, lamb_weight_decay 0.01) and
    bert_fit_loss, with its train engine (``_step_eager`` for "eager"):
    (model, api, engine)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.hapi.engine import TrainEngine
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    seed(0)
    model = BertForPretraining(BertConfig(), device="cuda",
                               dtype=torch.bfloat16)
    api = ptt.Model(model, labels=["mlm_labels", "nsp_labels"]).prepare(
        ptt.optimizer.Lamb(learning_rate=LAMB_LR, lamb_weight_decay=0.01,
                           parameters=model.parameters()), bert_fit_loss)
    engine = api._engine = TrainEngine(api)
    if form == "eager":
        engine.step = engine._step_eager
    return model, api, engine


def bert_lamb_accum_phase(torch, K, card):
    """[bert-lamb-accum]: BERT-base pretraining (BertConfig(), dropout
    0.1, bf16) through Model.fit with Lamb and accumulate_grad_batches=4
    over a global batch of 128 (32 a microbatch, S = 128, ~15 % MLM labels,
    padded, made as [bert-fit]'s) each step: ACC_STEPS steps through the
    captured
    step (one capture, then one replay a step; the wrappers' launches at
    the warm-up and the capture: 4 microbatches of the B = 32 step's
    kernels and Kernel B's 2), then 2 profiled replays (every kernel with
    dropout, busy share, launches a step), 4 steps under
    torch.cuda.set_sync_debug_mode (the drains the only syncs), the same
    ACC_STEPS steps through ``_step_eager`` (losses bitwise equal), and
    the peak memory of accum 1 fits at B = 32 and B = 128.  Returns (the
    wrappers' counts over the graph fit, record)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import BertConfig

    cfg = BertConfig()
    rs = np.random.RandomState(11)
    ids, tt, mlm, nsp = bert_batch(torch, rs, cfg, ACC_B, ACC_S)
    mask, lens = padding_mask(torch, rs, ACC_B, ACC_S)
    # one global batch, every step (as [bert-train] repeats its batch): a
    # few steps of random tokens show a falling loss only on one batch
    data = [t.repeat((ACC_STEPS + 6,) + (1,) * (t.dim() - 1))
            for t in (ids, tt, mask, mlm, nsp)]

    def part(lo, hi, b=ACC_B):
        return ptt.io.TensorDataset([d[lo * b:hi * b] for d in data])

    def fit(api, lo, hi, b=ACC_B, accum=ACCUM, log_freq=1):
        return api.fit(part(lo, hi, b), batch_size=b, shuffle=False,
                       verbose=0, log_freq=log_freq,
                       accumulate_grad_batches=accum)["step_loss"]

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model, api, engine = lamb_accum_model(torch, "graph")
    n_params = sum(p.numel() for p in model.parameters())
    stamps = drain_stamps(engine)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    losses = fit(api, 0, ACC_STEPS)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    step_ms = np.diff([t0] + stamps[:ACC_STEPS]) * 1e3
    if engine.captures != 1 or engine.replays != ACC_STEPS - 1:
        fail(f"bert-lamb-accum: {engine.captures} captures, "
             f"{engine.replays} replays in {ACC_STEPS} steps")
    (per_replay,) = engine.graph_launches.values()
    want = {"flash_attention": 48, "flash_attention_dq": 48,
            "flash_attention_dkv": 48, "layer_norm": 104, "bias_gelu": 48,
            "bias_gelu_bwd": 48, "softmax_xent": 8, "softmax_xent_bwd": 8,
            "multi_tensor_norm_step": 2}
    got = {k: per_replay.get(k, 0) for k in want}
    if got != want or per_replay.get("multi_tensor_step", 0):
        fail(f"bert-lamb-accum: a replay's launches {per_replay}, not "
             f"{want} (4 microbatches of the B = 32 step, Kernel B twice)")
    for name in BERT_KERNELS + ("multi_tensor_norm_step",):
        if counts[name] <= 0:
            fail(f"bert-lamb-accum: {name} was not launched")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"bert-lamb-accum: losses {losses} do not fall")
    _, wall_ms, kernels = trace_window(
        torch, lambda: fit(api, ACC_STEPS, ACC_STEPS + 2))
    traced, _ = require_traced(
        kernels, "bert-lamb-accum",
        BERT_KERNELS + ("multi_tensor_norm_step",), dropout=True)
    busy = sum(t for t, _, _ in kernels)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fit(api, ACC_STEPS + 2, ACC_STEPS + 6, log_freq=4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [os.path.basename(w.filename) for w in caught
             if str(w.message).startswith(SYNC_WARNING)]
    if syncs != ["engine.py"] * 2:
        fail(f"bert-lamb-accum: 4 replayed steps with log_freq 4 made the "
             f"syncs {syncs}, not the two drains")
    # the path's Kernel B at its own tree and rule, from seeded gradients
    params = list(model.parameters())
    g = torch.Generator(device="cuda").manual_seed(35)
    for p in params:
        p.grad = (1e-3 * torch.randn(*p.shape, generator=g,
                                     device="cuda")).to(p.dtype)
    kernel_b = kernel_b_breakdown(torch, K, api._optimizer, params, LAMB_LR)
    del model, api, engine, params
    release(torch, "bert-lamb-accum eager")
    _, api_e, engine_e = lamb_accum_model(torch, "eager")
    eager_losses = fit(api_e, 0, ACC_STEPS)
    if eager_losses != losses:
        fail(f"bert-lamb-accum: graph losses {losses} against the eager "
             f"step's {eager_losses}")
    del api_e, engine_e
    peaks = {}
    for b in (32, 128):
        release(torch, f"bert-lamb-accum accum 1 B={b}")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, api_1, _ = lamb_accum_model(torch, "graph")
        fit(api_1, 0, 3, b=b, accum=1)
        peaks[b] = torch.cuda.max_memory_allocated() - base
        del api_1
    p50 = float(np.median(step_ms[1:]))
    tokens = 32 * ACC_S
    flops = ACCUM * (6.0 * n_params * tokens + cfg.num_layers * 12 * ACC_S
                     * ACC_S * cfg.hidden_size * 32)
    per_step = {k: v / 2 for k, v in traced.items() if v}
    gib = 2 ** 30
    log(f"[bert-lamb-accum] BertConfig() (dropout 0.1) bf16, {n_params} "
        f"parameters, Lamb({LAMB_LR}, lamb_weight_decay 0.01), Model.fit("
        f"accumulate_grad_batches={ACCUM}) over one global batch of {ACC_B} "
        f"({ACC_B // ACCUM} a microbatch, S={ACC_S}, padded, lengths "
        f"{int(lens.min())}-{int(lens.max())}) on {card}: losses {losses} "
        f"(falling), the eager step's bitwise equal; step ms "
        f"{[round(t, 3) for t in step_ms]}, p50 {p50:.3f} ms (steps 2-"
        f"{ACC_STEPS}, each to its loss's drain); {ACC_B / p50 * 1e3:.1f} "
        f"samples/s; {mfu_text(flops, p50 / 1e3)}; one capture, one replay "
        f"a step, a replay's launches {got}; 2 profiled replays: busy "
        f"{busy:.3f} of {wall_ms:.3f} ms ({100 * busy / wall_ms:.2f}%), "
        f"traced launches a step {per_step}, every attention launch with "
        f"dropout on the tensor cores; 4 replays under sync debug mode: "
        f"the 2 drains only; peak memory above the phase's start: "
        f"accum {ACCUM} at B={ACC_B} {peak / gib:.3f} GiB, accum 1 at B=32 "
        f"{peaks[32] / gib:.3f} GiB, accum 1 at B=128 "
        f"{peaks[128] / gib:.3f} GiB; wrapper launches (warm-up and "
        f"capture) {counts} | Kernel B at this tree, one call: "
        f"{breakdown_text(kernel_b)}")
    return counts, {"p50_ms": p50, "samples_s": ACC_B / p50 * 1e3,
                    "kernel_b": kernel_b,
                    "mfu": flops / (p50 / 1e3) / PEAK_BF16_TENSOR,
                    "busy_share": busy / wall_ms, "losses": losses,
                    "peak_gib": {"accum4_b128": peak / gib,
                                 "accum1_b32": peaks[32] / gib,
                                 "accum1_b128": peaks[128] / gib},
                    "launches_a_replay": got,
                    "traced_a_step": per_step}


def r50_lars_fit(torch, form, x, y, steps, log_freq=1):
    """A fresh ResNet-50 (bf16, seed 0) behind Model.fit with
    LarsMomentum(LARS_LR) at the reference's other defaults (momentum
    0.9, lars_coeff 0.001, lars_weight_decay 0.0005): (model, api, engine,
    losses, step ms to each drain)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.hapi.engine import TrainEngine
    from paddle_tpu_torch.vision.models import resnet50

    seed(0)
    model = resnet50(num_classes=1000)
    model.astype("bfloat16")
    api = ptt.Model(model).prepare(
        ptt.optimizer.LarsMomentum(learning_rate=LARS_LR,
                                   parameters=model.parameters()),
        ptt.nn.CrossEntropyLoss())
    engine = api._engine = TrainEngine(api)
    if form == "eager":
        engine.step = engine._step_eager
    stamps = drain_stamps(engine)
    t0 = time.perf_counter()
    losses = api.fit(_RepeatBatch(x, y, steps), batch_size=x.shape[0],
                     shuffle=False, verbose=0,
                     log_freq=log_freq)["step_loss"]
    return model, api, engine, losses, np.diff([t0] + stamps[:steps]) * 1e3


def resnet50_lars_phase(torch, K, card):
    """[resnet50-lars]: ResNet-50 bf16, B = 128 (the [resnet50] batch),
    Model.fit with LarsMomentum(LARS_LR) at the reference's momentum,
    lars_coeff and lars_weight_decay defaults: R50_FIT_STEPS steps through
    the captured step (the loss falls; one capture; Kernel B twice a
    replay, as the wrappers counted at the capture), 2 profiled replays
    (device ms a step, samples/s, launches), then 3 steps graph against
    eager under cudnn.deterministic: losses, parameters and running
    statistics bitwise; then the path's kernel at its own tree:
    LarsMomentum(LARS_LR) over ResNet-50's bf16 parameters, 3 steps of
    step() against the per-parameter loop (``optimizer_tree_check``) and
    one update timed against the loop and its bound
    (``tree_step_record``).  Returns (the wrappers' counts over the graph
    fit, record)."""
    import paddle_tpu_torch as ptt

    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(R50_B, 3, 224, 224).astype(
        np.float32)).to(torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, 1000, (R50_B,)).astype(np.int64))
    K.reset_launch_counts()
    model, api, engine, losses, step_ms = r50_lars_fit(
        torch, "graph", x, y, R50_FIT_STEPS)
    counts = K.launch_counts()
    (per_replay,) = engine.graph_launches.values()
    if engine.captures != 1 \
            or per_replay.get("multi_tensor_norm_step") != 2 \
            or per_replay.get("multi_tensor_step", 0):
        fail(f"resnet50-lars: {engine.captures} captures, a replay's "
             f"launches {per_replay} (Kernel B twice, the elementwise "
             "kernel never)")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"resnet50-lars: losses {losses} do not fall at lr {LARS_LR}")
    _, wall_ms, kernels = trace_window(
        torch, lambda: api.fit(_RepeatBatch(x, y, 2), batch_size=R50_B,
                               shuffle=False, verbose=0))
    traced, _ = require_traced(kernels, "resnet50-lars",
                               XENT_KERNELS + ("multi_tensor_norm_step",))
    busy = sum(t for t, _, _ in kernels)
    fam, _ = r50_families(kernels)
    del model, api, engine
    release(torch, "resnet50-lars bitwise")
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for form in ("graph", "eager"):
            m_, _, e_, l_, _ = r50_lars_fit(torch, form, x, y, 3)
            runs.append((l_, [t.detach().clone() for t in
                              (*m_.parameters(), *m_.buffers())]))
            del m_, e_
            release(torch, f"resnet50-lars bitwise {form}")
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, tg), (le, te) = runs
    if lg != le or not all(torch.equal(a, b) for a, b in zip(tg, te)):
        fail(f"resnet50-lars: under cudnn.deterministic the graph's losses "
             f"{lg} against the eager step's {le} (or the parameters, or "
             "the running statistics) differ")
    del runs, tg, te
    model, _ = r50_model(torch)
    opt, opt_err, opt_steps = optimizer_tree_check(
        torch, model, make=lambda ps: ptt.optimizer.LarsMomentum(
            learning_rate=LARS_LR, parameters=ps))
    params = list(model.parameters())
    opt_rec = tree_step_record(torch, K, opt, params, LARS_LR)
    if opt_rec["kind"] != "lars":
        fail(f"resnet50-lars optimizer: LarsMomentum took the "
             f"{opt_rec['kind']} rule")
    opt_rec.update(max_abs_err=opt_err, **opt_steps)
    opt_rec["breakdown"] = kernel_b_breakdown(torch, K, opt, params, LARS_LR)
    del model, opt, params
    device_ms = busy / 2
    p50 = float(np.median(step_ms[1:]))
    opt_ms = fam.get("optimizer", (0.0, 0))
    per_step = {k: v / 2 for k, v in traced.items() if v}
    log(f"[resnet50-lars] resnet50(num_classes=1000) bf16, B={R50_B}, "
        f"LarsMomentum({LARS_LR}, momentum 0.9, lars_coeff 0.001, "
        f"lars_weight_decay 0.0005) through Model.fit on {card}: losses "
        f"{losses[0]:.5f} -> {losses[-1]:.5f} over {R50_FIT_STEPS} steps "
        f"(falling; {[round(v, 5) for v in losses]}); step p50 {p50:.3f} ms "
        f"to each drain; device ms a step (2 profiled replays' busy) "
        f"{device_ms:.3f}, {R50_B / device_ms * 1e3:.1f} samples/s, busy "
        f"{busy:.3f} of {wall_ms:.3f} ms ({100 * busy / wall_ms:.2f}%); "
        f"Kernel B a step: {opt_ms[0] / 2:.3f} ms over {opt_ms[1] / 2:g} "
        f"launches; a replay's launches {per_replay}; traced launches a "
        f"step {per_step}; 3 steps under cudnn.deterministic graph bitwise "
        f"eager (losses {lg}, every parameter and running statistic) | "
        f"LarsMomentum({LARS_LR}) over ResNet-50's {opt_rec['tensors']} bf16 "
        f"tensors, 3 steps of the kernel against the per-parameter loop: "
        f"max |d| {opt_err}, steps within {opt_steps['step_rel_err']:.3e} "
        f"of the loop's (tol {K.optimizer.NORM_BF16_RTOL:.3e}; the loop at "
        f"{NORM_PLANTED} x lr {opt_steps['planted_rel_err']:.3e}, refused); "
        f"one update of {opt_rec['elements']} elements: device ms kernel="
        f"{opt_rec['ms']} plain loop={opt_rec['plain_ms']} bound="
        f"{opt_rec['bound_ms']} ({opt_rec['bound_by']}, {opt_rec['bytes']} "
        f"bytes) library={NO_LIBRARY}; one call by launch: "
        f"{breakdown_text(opt_rec['breakdown'])}")
    return counts, {"p50_ms": p50, "device_ms": device_ms,
                    "samples_s": R50_B / device_ms * 1e3,
                    "losses": losses, "optimizer_ms": opt_ms[0] / 2,
                    "launches_a_replay": per_replay,
                    "traced_a_step": per_step,
                    "tree_check": {k: opt_rec[k] for k in (
                        "tensors", "elements", "max_abs_err", "step_rel_err",
                        "planted_rel_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "breakdown")}}


# ---------------------------------------------------------------------------
# durable checkpoints and resume in Model.fit
# ---------------------------------------------------------------------------
RESUME_STEPS = 8        # the unbroken run's steps (one epoch)
RESUME_KILL = 5         # the child is sent SIGTERM after this step
RESUME_INTERVAL = 2     # checkpoint_interval of the child's run
RESUME_SYNC_INTERVAL = 4  # and of the run with synchronous saves
RESUME_B, RESUME_S = 32, 128


def resume_fit(torch, rec, ckpt=None, sync=False, kill_at=None,
               interval=RESUME_INTERVAL):
    """One [resume] run from seed 0: BertForPretraining(BertConfig()) at
    its dropout 0.1, bf16, AdamW(1e-4, wd 0.01), B = 32, S = 128 padded
    batches with their mask, shuffle off, Model.fit's captured step over
    RESUME_STEPS batches.  With ``ckpt``: ``resume=ckpt``,
    ``checkpoint_interval=interval`` (None: a save at the epoch's end),
    ``fault_tolerant=True``, synchronous saves with ``sync``; ``kill_at``: SIGTERM to this process
    after that step.  Fills ``rec`` as it goes (so a run ended by its
    SystemExit leaves it): the losses, a time stamp at each step's end
    (after its loss's drain), the training thread's stall in each save,
    (ms, "sync"/"async"), and the ms of each save's host snapshot (its
    part of the stall).  Returns the Model."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    B, S, n = RESUME_B, RESUME_S, RESUME_STEPS
    seed(0)
    cfg = BertConfig()
    model = BertForPretraining(cfg, device="cuda", dtype=torch.bfloat16)
    rs = np.random.RandomState(7)
    ids, tt, mlm, nsp = bert_batch(torch, rs, cfg, n * B, S)
    data = [ids, tt, padding_mask(torch, rs, n * B, S)[0], mlm, nsp]
    opt = ptt.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                              parameters=model.parameters())
    api = ptt.Model(model, labels=["mlm_labels", "nsp_labels"]).prepare(
        opt, bert_fit_loss)
    rec.update(losses=[], stamps=[], stalls=[], snapshots=[])
    save, snapshot = api._ft_save, api._ft_state

    def timed_snapshot(it):
        t = time.perf_counter()
        out = snapshot(it)
        rec["snapshots"].append((time.perf_counter() - t) * 1e3)
        return out

    api._ft_state = timed_snapshot

    def timed_save(mgr, saver, it, force=False, sync=False):
        t = time.perf_counter()
        save(mgr, saver, it, force=force, sync=sync)
        rec["stalls"].append(((time.perf_counter() - t) * 1e3,
                              "sync" if sync or saver is None else "async"))

    api._ft_save = timed_save

    class Record(Callback):
        def on_train_batch_end(self, step, logs=None):
            rec["losses"].append(logs["loss"])
            rec["stamps"].append(time.perf_counter())
            if len(rec["losses"]) == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)

    kw = {} if ckpt is None else dict(
        resume=ckpt, checkpoint_interval=interval, fault_tolerant=True)
    flags.set_flags({"FLAGS_ckpt_async": not sync})
    rec["t0"] = time.perf_counter()
    try:
        api.fit(ptt.io.TensorDataset(data), batch_size=B, epochs=1,
                shuffle=False, verbose=0, callbacks=[Record()], **kw)
    finally:
        flags.set_flags({"FLAGS_ckpt_async": True})
    return api


def resume_child(ckpt):
    """The child of [resume]: the saving run, killed by SIGTERM after step
    RESUME_KILL (fit writes the emergency generation and exits 75).  Its
    record goes to ``ckpt``/child.json, whatever the exit."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {}
    try:
        resume_fit(torch, rec, ckpt, kill_at=RESUME_KILL)
    except SystemExit as e:
        rec["exit"] = e.code
        raise
    finally:
        with open(os.path.join(ckpt, "child.json"), "w") as f:
            json.dump(rec, f)
    return 0


def step_ms(rec):
    """Each step's time: the gaps between the step-end stamps (the first
    from fit's start, the warm-up and the capture included)."""
    stamps = [rec["t0"]] + rec["stamps"]
    return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]


def state_equal(torch, a, b, what):
    """Two ft_state trees bitwise equal, leaf by leaf."""
    from paddle_tpu_torch.distributed.checkpoint import _flatten

    la, lb = _flatten(a)[1], _flatten(b)[1]
    if [k for k, _ in la] != [k for k, _ in lb]:
        fail(f"[resume] {what}: the state trees' keys differ")
    bad = [k for (k, x), (_, y) in zip(la, lb)
           if x.dtype != y.dtype or not torch.equal(x, y)]
    if bad:
        fail(f"[resume] {what}: {len(bad)} of {len(la)} leaves differ, "
             f"first {bad[:3]}")
    return len(la)


def same_leaves(gen_a, gen_b):
    """The leaf files of two generations: (same bytes, leaves, bytes)."""
    man_a = json.load(open(os.path.join(gen_a, "manifest.json")))
    man_b = json.load(open(os.path.join(gen_b, "manifest.json")))
    if [(e["key"], e["dtype"], e["shape"]) for e in man_a["leaves"]] != \
            [(e["key"], e["dtype"], e["shape"]) for e in man_b["leaves"]]:
        return False, len(man_a["leaves"]), 0
    n = 0
    for ea, eb in zip(man_a["leaves"], man_b["leaves"]):
        with open(os.path.join(gen_a, ea["file"]), "rb") as fa, \
                open(os.path.join(gen_b, eb["file"]), "rb") as fb:
            if fa.read() != fb.read():
                return False, len(man_a["leaves"]), n
        n += ea["bytes"]
    return True, len(man_a["leaves"]), n


def hist_delta(h, before):
    """(observations, sum ms) a registry histogram gained since
    ``before`` = (total, sum)."""
    return h.total - before[0], h.sum - before[1]


def resume_phase(torch, K, card):
    """[resume]: see the module docstring, phase 27.  Returns the launch
    counts of the resumed run (counts set to 0 just before it)."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt_mod
    from paddle_tpu_torch.distributed.resilience import PREEMPTED_EXIT_CODE
    from paddle_tpu_torch.utils.metrics import default_registry

    t_phase = time.perf_counter()
    reg = default_registry()
    save_h, restore_h = (reg.get("paddle_ckpt_save_ms"),
                         reg.get("paddle_ckpt_restore_ms"))
    n = RESUME_STEPS
    with tempfile.TemporaryDirectory(prefix="resume-") as tmp:
        # 1. unbroken
        unbroken, synced, resumed = {}, {}, {}
        api = resume_fit(torch, unbroken)
        if api._engine.captures != 1:
            fail(f"[resume] the unbroken run captured "
                 f"{api._engine.captures} graphs, not 1")
        want = api._engine.ft_state(n)
        del api
        release(torch, "resume: sync saves")
        # 2. synchronous saves every RESUME_SYNC_INTERVAL steps
        sync_dir = os.path.join(tmp, "sync")
        before = (save_h.total, save_h.sum)
        api = resume_fit(torch, synced, sync_dir, sync=True,
                         interval=RESUME_SYNC_INTERVAL)
        sync_saves, sync_save_ms = hist_delta(save_h, before)
        state_equal(torch, api._engine.ft_state(n), want,
                    "the run with synchronous saves against the unbroken")
        if synced["losses"] != unbroken["losses"]:
            fail(f"[resume] saving changed the losses: {synced['losses']} "
                 f"vs {unbroken['losses']}")
        del api
        release(torch, "resume: child")
        # 3. the child: async saves, SIGTERM after step RESUME_KILL
        child_dir = os.path.join(tmp, "child")
        os.makedirs(child_dir)
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--resume-child",
             child_dir], capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        child_s = time.perf_counter() - t
        if proc.returncode != PREEMPTED_EXIT_CODE:
            log(proc.stderr[-4000:])
            fail(f"[resume] the child exited {proc.returncode}, not "
                 f"{PREEMPTED_EXIT_CODE}")
        child = json.load(open(os.path.join(child_dir, "child.json")))
        if child["losses"] != unbroken["losses"][:RESUME_KILL]:
            fail(f"[resume] the child's losses {child['losses']} are not "
                 f"the unbroken run's {unbroken['losses'][:RESUME_KILL]}")
        gens = os.path.join(child_dir, "resilient")
        mgr = ckpt_mod.CheckpointManager(gens, max_to_keep=2)
        if mgr.all_steps() != [RESUME_KILL - 1, RESUME_KILL]:
            fail(f"[resume] the child left generations {mgr.all_steps()}, "
                 f"not [{RESUME_KILL - 1}, {RESUME_KILL}]")
        gen = os.path.join(gens, str(RESUME_KILL))
        t = time.perf_counter()
        man, reason = ckpt_mod.verify_generation(gen, deep=True)
        verify_ms = (time.perf_counter() - t) * 1e3
        if man is None:
            fail(f"[resume] the emergency generation fails "
                 f"verify_generation(deep=True): {reason}")
        gen_bytes = sum(e["bytes"] for e in man["leaves"])
        # 4. a new Model resumes from the emergency generation
        release(torch, "resume: resumed run")
        before = (restore_h.total, restore_h.sum)
        K.reset_launch_counts()
        api = resume_fit(torch, resumed, child_dir, interval=None)
        counts = K.launch_counts()
        restores, restore_ms = hist_delta(restore_h, before)
        if resumed["losses"] != unbroken["losses"][RESUME_KILL:]:
            fail(f"[resume] resumed losses {resumed['losses']} are not the "
                 f"unbroken run's {unbroken['losses'][RESUME_KILL:]}")
        leaves = state_equal(torch, api._engine.ft_state(n), want,
                             "the resumed run against the unbroken")
        for name in BERT_KERNELS + ("multi_tensor_step",):
            if counts[name] <= 0:
                fail(f"[resume] kernel {name} was not launched on the "
                     f"resumed run")
        del api, want
        # the resumed run's async generation of its epoch's end against
        # the synchronous run's of the same step
        same, n_leaves, compared = same_leaves(
            os.path.join(gens, str(n)),
            os.path.join(sync_dir, "resilient", str(n)))
        if not same:
            fail(f"[resume] the async and sync generations of step {n} "
                 f"differ (after {compared} bytes)")
    release(torch, "resume: done")
    stall = {kind: [round(ms, 3) for ms, k in synced["stalls"] + [
        tuple(x) for x in child["stalls"]] if k == kind]
        for kind in ("sync", "async")}
    p50_plain = float(np.median(step_ms(unbroken)[2:]))
    p50_sync = float(np.median(step_ms(synced)[2:]))
    p50_async = float(np.median(step_ms(child)[2:]))
    log(f"[resume] BERT-base (BertConfig(), dropout 0.1) bf16 AdamW "
        f"B={RESUME_B} S={RESUME_S} padded, Model.fit's captured step on "
        f"{card}: {n} steps unbroken, losses {unbroken['losses']}; the "
        f"child (async saves every {RESUME_INTERVAL}, SIGTERM after step "
        f"{RESUME_KILL}) exited {proc.returncode} in {child_s:.1f}s with "
        f"its emergency generation {RESUME_KILL}; a new Model resumed from "
        f"it: losses {resumed['losses']} and all {leaves} parameters, "
        f"buffers, slots and counters bitwise the unbroken run's")
    log(f"[resume] generation: {len(man['leaves'])} leaves, {gen_bytes} "
        f"bytes ({gen_bytes / 2 ** 30:.3f} GiB), verify_generation(deep) "
        f"{verify_ms:.1f} ms; the resumed run's async generation of step "
        f"{n} and the sync run's the same {compared} bytes ({n_leaves} "
        f"leaves); "
        f"save ms (fsyncs included, the sync run's {sync_saves} saves) "
        f"{sync_save_ms / max(sync_saves, 1):.1f} a save; restore_latest "
        f"{restore_ms:.1f} ms ({restores} restore); the training thread's "
        f"stall a save: sync {stall['sync']} ms, async (host snapshot and "
        f"submit) {stall['async']} ms; the host snapshot's part (into "
        f"page-locked memory, fresh or reused from a written snapshot): "
        f"sync run {[round(x, 3) for x in synced['snapshots']]} ms, child "
        f"{[round(x, 3) for x in child['snapshots']]} ms; step p50 (steps "
        f"3-{n}) {p50_plain:.3f} ms without saves, {p50_sync:.3f} ms with "
        f"sync saves every {RESUME_SYNC_INTERVAL}, {p50_async:.3f} ms (steps "
        f"3-{RESUME_KILL}, the child) with async saves every "
        f"{RESUME_INTERVAL}; step ms unbroken "
        f"{[round(x, 3) for x in step_ms(unbroken)]}, sync "
        f"{[round(x, 3) for x in step_ms(synced)]}, async "
        f"{[round(x, 3) for x in step_ms(child)]}; resumed-run launches "
        f"{ {k: counts[k] for k in BERT_KERNELS + ('multi_tensor_step',)} }"
        f"; the phase took {time.perf_counter() - t_phase:.1f}s on {card}")
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
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated, "
        f"{time.perf_counter() - START:.1f}s into the run")


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


# ---------------------------------------------------------------------------
# the host data path: DataLoader worker processes and the buffered reader
# with pinned placement under Model.fit, then flops on the card
# ---------------------------------------------------------------------------
IO_BANK = 16            # distinct 224 x 224 images [io]'s dataset cycles
IO_WORKERS = 4
IO_STEPS = 12           # fit steps a timed run
IO_PROFILED = 4         # fit steps under the profiler
IO_SLOW_CYCLES = 100_000_000   # torch.cuda._sleep a step: ~50 ms at 2 GHz
IO_TIMEOUT = 120        # seconds a worker batch may take


class R50Bank:
    """[io]'s dataset: ``n`` samples over a bank of IO_BANK distinct bf16
    3 x 224 x 224 images; sample i is ``bank[i % IO_BANK]`` with label
    ``i % 1000``, so collating a batch indexes and stacks 128 images, the
    collation [resnet50] measures.  At module scope: it pickles to the
    forkserver workers, which import this file (hence its ``__main__``
    guard)."""

    def __init__(self, bank, n):
        self.bank, self.n = bank, n

    def __getitem__(self, i):
        return self.bank[i % len(self.bank)], i % 1000

    def __len__(self):
        return self.n


def io_bank(torch):
    rs = np.random.RandomState(1)
    return torch.from_numpy(rs.randn(IO_BANK, 3, 224, 224).astype(
        np.float32)).to(torch.bfloat16)


def io_api(torch, slow=False):
    """A fresh ResNet-50 from seed 0 (r50_model) behind Model with
    CrossEntropyLoss and its train engine; ``slow`` puts a
    ``torch.cuda._sleep`` of IO_SLOW_CYCLES before the network in every
    step (captured with it)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.hapi.engine import TrainEngine

    model, opt = r50_model(torch)
    net = model
    if slow:
        class Slowed(ptt.nn.Layer):
            def __init__(self, inner):
                super().__init__()
                self.inner = inner

            def forward(self, x):
                torch.cuda._sleep(IO_SLOW_CYCLES)
                return self.inner(x)
        net = Slowed(model)
    api = ptt.Model(net).prepare(opt, ptt.nn.CrossEntropyLoss())
    engine = api._engine = TrainEngine(api)
    return api, engine, drain_stamps(engine)


def io_loader(torch, bank, workers, steps, prefetch=2, buffered=True):
    """The shuffled loader of ``steps`` batches of R50_B: its order is
    drawn at construction from the framework generator (the same after
    the same seed and model)."""
    import paddle_tpu_torch as ptt

    return ptt.io.DataLoader(R50Bank(bank, steps * R50_B),
                             batch_size=R50_B, shuffle=True,
                             num_workers=workers, prefetch_factor=prefetch,
                             use_buffer_reader=buffered, timeout=IO_TIMEOUT)


IO_CONFIGS = (   # name, num_workers, use_buffer_reader
    ("unbuffered", 0, False),   # the collation on the training thread
    ("buffered", 0, True),
    ("workers", IO_WORKERS, True),
)


def _waits(e):
    """Whether a host event waits for the card (a synchronize below it)."""
    return "Synchronize" in e.name or any(_waits(c) for c in e.cpu_children)


def thread_trace(torch, run, steps):
    """``run()`` under torch.profiler, which records the thread that runs
    it: (the training thread's host ms a step in its top-level events,
    split into work and waits for the card (an event with a synchronize
    below it: the drain), with its four costliest events; device busy ms
    a step; the trace's device events as (ms, name, count))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    work = wait = 0.0
    names = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or e.cpu_parent is not None:
            continue
        ms = e.cpu_time_total / 1e3
        if _waits(e):
            wait += ms
        else:
            work += ms
            names[e.name] = names.get(e.name, 0.0) + ms
    top = sorted(names.items(), key=lambda kv: -kv[1])[:4]
    kernels = [(e.self_device_time_total / 1e3, e.key, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    host = {"work": work / steps, "wait": wait / steps,
            "top": {k: round(v / steps, 3) for k, v in top}}
    return host, sum(t for t, _, _ in kernels) / steps, kernels


def io_loader_ms(torch, bank, workers, buffered):
    """The loader alone: ms a pinned batch (io.pin_batch as its placement)
    over IO_STEPS batches, the first (and the workers' start) left out."""
    import paddle_tpu_torch as ptt

    loader = io_loader(torch, bank, workers, IO_STEPS, buffered=buffered)
    loader.placement = ptt.io.pin_batch
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    n = sum(1 for _ in it)
    return (time.perf_counter() - t0) * 1e3 / n


def io_run(torch, bank, workers, buffered):
    """ResNet-50 bf16 through Model.fit(num_workers=workers) from seed 0:
    IO_STEPS steps with a drain a step (the step p50 to each drain, the
    first step's capture left out), then IO_PROFILED more on the same
    graph under the profiler.  Returns a record with the losses."""
    import paddle_tpu_torch as ptt

    api, engine, stamps = io_api(torch)
    loader = io_loader(torch, bank, workers, IO_STEPS, buffered=buffered)
    t0 = time.perf_counter()
    losses = api.fit(loader, verbose=0, log_freq=1)["step_loss"]
    step_ms = np.diff([t0] + stamps[:IO_STEPS]) * 1e3
    if loader.placement is not None:
        fail("[io] fit left its placement hook on the loader")
    seen = []
    loader_p = io_loader(torch, bank, workers, IO_PROFILED,
                         buffered=buffered)
    orig = ptt.io.pin_batch

    def watched(batch):
        out = orig(batch)
        seen.append((threading.current_thread().name,
                     all(t.is_pinned() for t in out)))
        return out
    # the hook fit installs, watched: it runs on the reader's thread when
    # the reader is buffered, and hands over page-locked batches
    import paddle_tpu_torch.hapi.model as hapi_model
    hapi_model.pin_batch = watched
    try:
        host, device_ms, kernels = thread_trace(
            torch, lambda: api.fit(loader_p, verbose=0, log_freq=1),
            IO_PROFILED)
    finally:
        hapi_model.pin_batch = orig
    want = "DataLoader reader" if buffered \
        else threading.current_thread().name
    if len(seen) != IO_PROFILED or any(
            name != want or not pinned for name, pinned in seen):
        fail(f"[io] the placement hook ran as {seen}: not on the "
             f"{want!r} thread, or not pinning")
    traced, _ = require_traced(kernels, f"io fit num_workers={workers}",
                               XENT_KERNELS + ("multi_tensor_step",))
    if engine.captures != 1 or engine.replays != IO_STEPS - 1 + IO_PROFILED:
        fail(f"[io] num_workers={workers}: {engine.captures} captures, "
             f"{engine.replays} replays")
    del api, engine
    return {"losses": losses, "p50_ms": float(np.median(step_ms[1:])),
            "host_ms": host, "device_ms": device_ms,
            "loader_ms": io_loader_ms(torch, bank, workers, buffered),
            "traced_a_step": {k: v / IO_PROFILED for k, v in traced.items()}}


def io_one_drain(torch, bank):
    """ms a step of IO_STEPS fit steps with one drain an epoch (the host
    runs ahead of the card, the collation beside the step), the buffered
    reader on and off in turns on one captured graph: {"on": [..],
    "off": [..]}."""
    api, engine, _ = io_api(torch)
    api.fit(io_loader(torch, bank, 0, 2), verbose=0, log_freq=0)
    out = {"on": [], "off": []}
    for buffered in (True, False, False, True):
        loader = io_loader(torch, bank, 0, IO_STEPS, buffered=buffered)
        t0 = time.perf_counter()
        api.fit(loader, verbose=0, log_freq=0)
        out["on" if buffered else "off"].append(
            round((time.perf_counter() - t0) * 1e3 / IO_STEPS, 3))
    del api, engine
    return out


def io_startup(torch, bank):
    """Seconds from iter() to the first batch of a IO_WORKERS-worker
    loader: the first (the forkserver starting, the workers' imports) and
    a second, warm one."""
    out = []
    for _ in range(2):
        it = iter(io_loader(torch, bank, IO_WORKERS, 2))
        t0 = time.perf_counter()
        next(it)
        out.append(time.perf_counter() - t0)
        it.close()
    return out


def io_phase(torch, K, card):
    """[io]: ResNet-50 (BASELINE.md config 2: bf16, Momentum(0.1, 0.9), B
    = 128, 224 x 224) through Model.fit's captured step over R50Bank,
    shuffle on, each batch pinned by fit's placement hook, a drain a step,
    from one seed in three configurations (IO_CONFIGS): the collation on
    the training thread (no buffered reader), on the reader's thread, in
    IO_WORKERS worker processes.  Losses bitwise equal; step p50; the
    training thread's host ms a step from the profile's host events,
    against the device ms of the profiled replays; the loader alone's ms
    a batch; the workers' start-up.  Then the pinned-reuse check: a fit
    whose every step sleeps IO_SLOW_CYCLES on the card first,
    prefetch_factor 2 and no drain but the epoch's (the host and the
    reader run ahead of the card), must give the unslowed fit's losses;
    and one drain an epoch with the reader on and off in turns.  Returns (the launch counts of the workers' run, counts set to 0 just
    before it; its record)."""
    t_phase = time.perf_counter()
    bank = io_bank(torch)
    starts = io_startup(torch, bank)
    recs = {}
    # two runs of one captured step agree bit for bit only with cuDNN's
    # deterministic algorithms (as [resnet50]'s graph-against-eager check)
    torch.backends.cudnn.deterministic = True
    try:
        for name, workers, buffered in IO_CONFIGS:
            release(torch, f"io {name}")
            if workers:
                K.reset_launch_counts()
            recs[name] = io_run(torch, bank, workers, buffered)
            if workers:
                counts = K.launch_counts()
        release(torch, "io pinned reuse")
        api, engine, _ = io_api(torch, slow=True)
        t0 = time.perf_counter()
        slowed = api.fit(io_loader(torch, bank, 0, IO_STEPS, prefetch=2),
                         verbose=0, log_freq=0)["step_loss"]
        slow_ms = (time.perf_counter() - t0) * 1e3 / IO_STEPS
        del api, engine
        release(torch, "io one drain an epoch")
        one_drain = io_one_drain(torch, bank)
    finally:
        torch.backends.cudnn.deterministic = False
    for name in XENT_KERNELS + ("multi_tensor_step",):
        if counts[name] <= 0:
            fail(f"[io] {name} was not launched in the workers' fit")
    want = recs["unbuffered"]["losses"]
    if not all(math.isfinite(v) for v in want):
        fail(f"[io] losses {want} are not finite")
    for name, rec in recs.items():
        if rec["losses"] != want:
            fail(f"[io] the {name} fit's losses {rec['losses']} differ from "
                 f"the unbuffered fit's {want}")
    if slowed != want:
        fail(f"[io] the slowed fit's losses {slowed} differ from the "
             f"unslowed fit's {want}: a pinned batch was overwritten while "
             "its copy to the card was pending")

    def text(r):
        h = r["host_ms"]
        return (f"step p50 {r['p50_ms']:.3f} ms, "
                f"{R50_B / r['p50_ms'] * 1e3:.1f} samples/s; device ms a "
                f"step {r['device_ms']:.3f}; the training thread's host ms "
                f"a step: work {h['work']:.3f} (top {h['top']}), waiting "
                f"for the card {h['wait']:.3f}; the loader alone "
                f"{r['loader_ms']:.3f} ms a pinned batch")
    runs = " | ".join(f"{name} (num_workers={w}): {text(recs[name])}"
                      for name, w, _ in IO_CONFIGS)
    log(f"[io] ResNet-50 bf16 Momentum(0.1, 0.9) B={R50_B} x 3 x 224 x 224"
        f" over a bank of {IO_BANK} images, Model.fit shuffle on, each "
        f"batch pinned by fit's hook, a drain a step, cudnn.deterministic "
        f"on, on {card}: {runs} | losses bitwise equal ({want[:3]}...) | "
        f"worker start-up (iter() to the first batch) {starts[0]:.3f} s "
        f"cold, {starts[1]:.3f} s warm | pinned reuse: {IO_STEPS} steps "
        f"each slowed by torch.cuda._sleep({IO_SLOW_CYCLES}), "
        f"prefetch_factor 2, one drain: losses bitwise the unslowed fit's "
        f"({slow_ms:.3f} ms a step) | one drain an epoch, ms a step, the "
        f"reader on / off in turns: {one_drain} | traced launches a step "
        f"{recs['workers']['traced_a_step']} | "
        f"{time.perf_counter() - t_phase:.1f}s")
    return counts, recs["workers"]


FLOPS_CASES = (   # name, input size, input dtype, hand count of a step
    ("resnet50", [1, 3, 224, 224], None, "3 x 4.1e9 x 128", 3 * 4.1e9 * 128,
     128),
    ("bert-base", [32, 128], "int64", "2.7640e12", 2.7640e12, 1),
    ("gpt2-small", [8, 1024], "int64", "7.0460e12", 7.0460e12, 1),
)


def flops_model(torch, name, device):
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         GPTConfig, GPTForCausalLM)
    from paddle_tpu_torch.vision.models import resnet50

    if name == "resnet50":
        return resnet50(num_classes=1000, device=device)
    if name == "bert-base":
        return BertForPretraining(BertConfig(), device=device)
    return GPTForCausalLM(GPTConfig(), device=device)


def flops_phase(torch, card):
    """[flops]: paddle_tpu_torch.flops of ResNet-50 at [1, 3, 224, 224],
    BERT-base at B = 32, S = 128 and GPT-2-small at B = 8, S = 1024, float32,
    on the card (the fused ops' kernels count themselves) and on the CPU
    (their plain versions): the counts must be equal.  Each is printed as
    a training step (the forward x 3, x 128 images for ResNet-50) beside
    the hand count the MFU lines use."""
    import paddle_tpu_torch as ptt

    t_phase = time.perf_counter()
    parts = []
    for name, size, dtype, hand_text, hand, images in FLOPS_CASES:
        counts = {}
        for device in ("cuda", "cpu"):
            net = flops_model(torch, name, device)
            counts[device] = ptt.flops(net, size, dtypes=dtype)
            del net
            release(torch, f"flops {name} {device}")
        if counts["cuda"] != counts["cpu"]:
            fail(f"[flops] {name}: the card counts {counts['cuda']}, the "
                 f"CPU {counts['cpu']}")
        step = 3 * counts["cuda"] * images
        parts.append(f"{name} {size}: forward {counts['cuda']} (card = CPU)"
                     f", a step {step:.4e} against the hand count "
                     f"{hand_text} = {hand:.4e} (x{step / hand:.3f})")
    log(f"[flops] on {card}, float32: " + "; ".join(parts)
        + f" | {time.perf_counter() - t_phase:.1f}s")


GEN_F32 = dict(B=4, S=64, new=32)      # float32 against the CPU and engine
GEN_BF16 = dict(B=8, S=128, new=128)   # bf16 greedy, sampling and eos
GEN_BEAM = dict(B=2, S=128, new=64, num_beams=4)
GEN_SAMPLE = dict(do_sample=True, top_k=40, temperature=0.8)
GEN_SEEDS = (7, 8)
GEN_EOS_STEP = 10       # eos = greedy row 0's token at this new position
GEN_KERNELS = ("layer_norm", "bias_gelu", "flash_attention")
GEN_TRACE_WINDOWS = 3   # traced calls a run may take to hold every replay


def gen_prompts(torch, cfg, seed, B, S, device):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S)).astype(
        np.int32)).to(device)


def margin_check(torch, got, ref, ref_logits, S, what):
    """Each row of ``got`` [B, S + n] equals the CPU's ``ref`` up to the
    first new position whose tokens differ; there the CPU's top-2 logit
    margin (``ref_logits`` [B, S + n, V] of ref's sequence) must be within
    LOGITS_REL_TOL x max|logits| and got's token one of the two: a near
    tie that float32 summation order may break either way.  Returns the
    (row, step) of each such tie."""
    ties = []
    for b in range(got.shape[0]):
        diff = (got[b, S:] != ref[b, S:]).nonzero()
        if not len(diff):
            continue
        t = int(diff[0])
        lg = ref_logits[b, S + t - 1]
        top = lg.topk(2)
        margin = float(top.values[0] - top.values[1])
        if margin > LOGITS_REL_TOL * float(lg.abs().max()) \
                or int(got[b, S + t]) not in top.indices.tolist():
            fail(f"{what}: row {b} differs from the CPU's at new token "
                 f"{t} ({int(got[b, S + t])} vs {int(ref[b, S + t])}), "
                 f"where the CPU's top-2 margin is {margin:.3e}")
        ties.append((b, t))
    return ties


def gen_call(torch, model, ids, kw, sync_error=False):
    """One generate call; with ``sync_error`` under
    torch.cuda.set_sync_debug_mode("error"), so that any host sync
    raises.  Returns (tokens, device ms of the call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    if sync_error:
        torch.cuda.set_sync_debug_mode("error")
    try:
        out = model.generate(ids, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def gen_mode(torch, K, model, ids, kw, what, record=None, timed=True):
    """A generate key on the card: the first call (the capture), a second
    under sync debug mode "error", an eager call (the key's step swapped
    for ``_step_eager``; ``record`` wraps its sampler), then with ``timed``
    calls graph, eager, eager, graph.  Fails unless every call gives the
    first call's tokens bitwise and the capture holds no slow variant.
    Returns a record, with the launches the wrappers counted in the first
    call (its eager prefill, the warm-up step and the capture: a replay
    runs the kernels without passing through the wrappers)."""
    K.reset_launch_counts()
    t0 = time.perf_counter()
    first, _ = gen_call(torch, model, ids, kw)
    first_wall = (time.perf_counter() - t0) * 1e3
    first_launches = K.launch_counts()
    # the key's run: its first call added it last to the cache
    run = next(reversed(model._gen_cache.values()))
    if run.graph is None:
        fail(f"{what}: the decode step was not captured")
    for name, counts in run.graph_variants.items():
        slow = {v: n for v, n in counts.items()
                if v != FAST_VARIANT[name] and n}
        if slow:
            fail(f"{what}: the decode graph took the slower kernel of "
                 f"{name}: {counts}")
    second, graph_ms = gen_call(torch, model, ids, kw, sync_error=True)
    run.step = run._step_eager
    if record is not None:
        run.sample = record(run.sample)
    try:
        eager, eager_ms = gen_call(torch, model, ids, kw)
    finally:
        del run.step
        run.__dict__.pop("sample", None)
    for name, out in (("the second call", second), ("the eager step", eager)):
        if not torch.equal(out, first):
            fail(f"{what}: {name} gave other tokens than the graph's first "
                 f"call")
    times = {"graph": [graph_ms], "eager": [eager_ms]}
    for form in ("graph", "eager", "eager", "graph") if timed else ():
        if form == "eager":
            run.step = run._step_eager
        try:
            out, ms = gen_call(torch, model, ids, kw)
        finally:
            run.__dict__.pop("step", None)
        if not torch.equal(out, first):
            fail(f"{what}: a timed {form} call gave other tokens")
        times[form].append(ms)
    # the eager prologue alone (the prefill and the first token)
    B, new = ids.shape[0], kw["max_new_tokens"]
    prologue = model._beam_prologue if run.beam \
        else model._generate_prologue
    if run.noise is not None:
        run.generator = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        prefill_ms = min(_events_ms(torch, lambda: prologue(run, ids), 1)
                         for _ in range(3))
    rec = {"run": run, "first_call_ms": first_wall,
           "capture_ms": run.capture_ms,
           "prefill_ms": prefill_ms, "first_call_launches": first_launches,
           "graph_launches": dict(run.graph_launches), "tokens": first}
    for form, ms in times.items():
        call = min(ms)
        rec[form] = {"call_ms": call,
                     "decode_ms_a_token": (call - prefill_ms) / (new - 1),
                     "tokens_s": B * new / call * 1e3}
    return rec


def gen_kernel_shapes(torch, K):
    """Rows 1, 2 and 6 against their plain versions at the generate path's
    shapes: LayerNorm and bias-GeLU at a bf16 decode step's R = 8 rows,
    flash attention at its prefill's B = 8, S = 128 (causal, the packed
    qkv's slices).  Returns {kernel: record}."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(20)
    dt, isz = torch.bfloat16, 2
    R, N, Fd = GEN_BF16["B"], 768, 3072
    B, S, H, D = GEN_BF16["B"], GEN_BF16["S"], 12, 64

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale
                ).to(dt)

    x, w, b = rnd(R, N), 1 + rnd(N, scale=0.1), rnd(N, scale=0.1)
    recs = {"layer_norm": compare(
        torch, f"[generate] layer_norm bf16 decode R={R} N={N}",
        lambda: K.layer_norm.layer_norm(x, w, b, 1e-5),
        lambda: K.layer_norm.layer_norm_plain(x, w, b, 1e-5),
        lambda: F.layer_norm(x, (N,), w, b, 1e-5), dt,
        (2 * R * N + 2 * N) * isz, 8 * R * N, PEAK_F32,
        variant=("layer_norm", "warp"))}
    xf, bf = rnd(R, Fd), rnd(Fd, scale=0.1)
    recs["bias_gelu"] = compare(
        torch, f"[generate] bias_gelu bf16 decode R={R} F={Fd}",
        lambda: K.bias_gelu.bias_gelu(xf, bf),
        lambda: K.bias_gelu.bias_gelu_plain(xf, bf),
        lambda: F.gelu(xf + bf), dt, (2 * R * Fd + Fd) * isz, 5 * R * Fd,
        PEAK_F32, variant=("bias_gelu", "vec"))
    qkv = rnd(B, S, 3, H, D)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    pairs = B * H * S * (S + 1) // 2
    recs["flash_attention"] = compare(
        torch, f"[generate] flash_attention bf16 prefill B={B} S={S} "
        f"H={H} D={D} causal",
        lambda: K.flash_attention.flash_attention(q, k, v)[0],
        lambda: K.flash_attention.flash_attention_plain(q, k, v)[0],
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True), dt,
        4 * B * S * H * D * isz + B * H * S * 4, 4 * D * pairs,
        PEAK_BF16_TENSOR, variant=("flash_attention", "mma"))
    return recs


def generate_phase(torch, K, card):
    """[generate]: GPTForCausalLM.generate on full-width GPT-2-small
    (GPTConfig(), dropout 0), its decode step one CUDA graph a key.
    float32, B = 4, S = 64, 32 new tokens: greedy tokens against the same
    model's on the CPU and against GenerationEngine's, equal up to the
    first near tie (margin_check).  bf16: greedy (B = 8, S = 128, 128
    new), top-k sampling (top_k 40, temperature 0.8, seeds 7 and 8: seed 7
    twice bitwise, seed 8 different, every token inside its step's
    top-40), beam search (4 beams, B = 2, S = 128, 64 new) and an
    eos_token_id run (a row that meets eos emits only eos; the other rows
    as without it): in each mode the graph's tokens bitwise the eager
    step's, a second call of the key under sync debug mode "error"; the
    trace of a replayed greedy call holds rows 1, 2 and 6 on their fast
    kernels, 25 LayerNorm and 12 bias-GeLU launches a new token and 12
    flash launches a call; interop: to_hf_gpt2_state -> load_hf_gpt2 into
    a fresh card model gives bitwise the parameters and the same tokens.
    Returns ({kernel: launches the wrappers counted in the first greedy
    call: the prefill, the warm-up step and the capture}, a record with
    each kernel's traced launches a call and its shape record)."""
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_numpy_state)
    from paddle_tpu_torch.models.interop import (load_hf_gpt2,
                                                 to_hf_gpt2_state)
    from paddle_tpu_torch.serving import GenerationEngine

    t_phase = time.perf_counter()
    cfg = GPTConfig(dropout=0.0, attn_dropout=0.0)
    seed(0)
    model = GPTForCausalLM(cfg, device="cuda").eval()

    # float32: the card against the CPU's plain versions, and the engine
    f = GEN_F32
    ids = gen_prompts(torch, cfg, 50, f["B"], f["S"], "cuda")
    got = model.generate(ids, max_new_tokens=f["new"]).cpu()
    cpu = GPTForCausalLM(cfg, device="cpu")
    load_numpy_state(cpu, {k: v.cpu().numpy()
                           for k, v in model.state_dict().items()})
    cpu.eval()
    ref = cpu.generate(ids.cpu(), max_new_tokens=f["new"])
    with torch.no_grad():
        ref_logits = cpu(ref.long()).float()
    del cpu
    ties = margin_check(torch, got, ref, ref_logits, f["S"],
                        "[generate] f32 generate")
    eng = GenerationEngine(model, device=model.device, max_slots=f["B"],
                           max_seq_len=f["S"] + f["new"] + 8,
                           prompt_buckets=str(f["S"]),
                           prefix_cache=False).start()
    try:
        handles = [eng.submit(p, f["new"]) for p in ids.cpu().tolist()]
        eng_out = [h.result(600) for h in handles]
    finally:
        eng.stop()
    if any(len(o) != f["new"] for o in eng_out):
        fail(f"[generate] the engine gave {[len(o) for o in eng_out]} tokens")
    eng_ids = torch.cat([ids.cpu(), torch.tensor(eng_out, dtype=torch.int32)],
                        dim=1)
    eng_ties = margin_check(torch, eng_ids, ref, ref_logits, f["S"],
                            "[generate] f32 engine")
    del ref_logits
    log(f"[generate] float32 B={f['B']} S={f['S']} {f['new']} new tokens: "
        f"the card's generate = the CPU's, up to near ties at (row, step) "
        f"{ties}; GenerationEngine's greedy = the CPU's, up to near ties at "
        f"{eng_ties}; margin tol {LOGITS_REL_TOL} x max|logits|")

    # bf16: greedy, sampling, beam, eos
    model.__dict__.pop("_gen_cache", None)
    model.to(dtype=torch.bfloat16)
    release(torch, "generate bf16")
    g = GEN_BF16
    ids = gen_prompts(torch, cfg, 51, g["B"], g["S"], "cuda")
    greedy_kw = dict(max_new_tokens=g["new"])
    greedy = gen_mode(torch, K, model, ids, greedy_kw, "[generate] greedy")
    counts = {n: greedy["first_call_launches"][n] for n in GEN_KERNELS}
    for name in GEN_KERNELS:
        if counts[name] <= 0:
            fail(f"[generate] {name} was not launched: {counts}")
    mark("generate: greedy")

    # the trace of a replayed call: rows 1, 2 and 6 on their fast kernels,
    # and in each of its replays exactly the graph's launches (25 LayerNorm,
    # 12 bias-GeLU).  The profiler can lack the records of a window's last
    # replays (when it closes right after them) and, later in a process,
    # of some eager launches (tools/trace_edge_probe.py): the prefill's
    # launches are the wrappers' count, and a window lacking a replay's
    # records is traced again; a launch too many in a replay, or on a slow
    # kernel, fails at once
    per_step = greedy["graph_launches"]
    for window in range(1, GEN_TRACE_WINDOWS + 1):
        by_replay = {}
        out, wall_ms, kernels = trace_window(
            torch, lambda: model.generate(ids, **greedy_kw),
            replays=by_replay)
        if not torch.equal(out, greedy["tokens"]):
            fail("[generate] the traced call gave other tokens")
        traced, fast = require_traced(kernels, "[generate] greedy trace",
                                      GEN_KERNELS)
        per = {n: by_replay["per_replay"][n] for n in per_step}
        if any(c > per_step[n] for n, cs in per.items() for c in cs):
            fail(f"[generate] a replay in the trace holds more launches "
                 f"than the graph's {per_step}: {per}")
        whole = sum(all(per[n][i] == per_step[n] for n in per_step)
                    for i in range(len(per["layer_norm"])))
        if whole == g["new"] - 1:
            break
        log(f"[generate] traced window {window} holds {whole} whole "
            f"replays of {g['new'] - 1}: {per}")
    else:
        fail(f"[generate] {GEN_TRACE_WINDOWS} traced calls all lacked "
             f"records of a replay")
    busy_ms = sum(t for t, _, _ in kernels)
    n_launches = sum(c for _, _, c in kernels)

    recorded = []

    def record(sample):
        def wrapped(logits):
            tok = sample(logits)
            recorded.append((logits.float().clone(), tok.clone()))
            return tok
        return wrapped

    s0, s1 = GEN_SEEDS
    sampled = gen_mode(torch, K, model, ids,
                       dict(max_new_tokens=g["new"], seed=s0, **GEN_SAMPLE),
                       f"[generate] top-k seed {s0}", record=record)
    a = sampled["tokens"]
    if torch.equal(a, model.generate(ids, max_new_tokens=g["new"], seed=s1,
                                     **GEN_SAMPLE)):
        fail(f"[generate] seeds {s0} and {s1} sampled the same tokens")
    if len(recorded) != g["new"]:
        fail(f"[generate] {len(recorded)} sampler calls, not {g['new']}")
    k = GEN_SAMPLE["top_k"]
    for t, (lg, tok) in enumerate(recorded):
        scaled = lg / GEN_SAMPLE["temperature"]
        kth = scaled.topk(k, dim=-1).values[:, -1]
        mine = scaled.gather(1, tok.long()[:, None])[:, 0]
        if not bool((mine >= kth).all()) \
                or not torch.equal(tok, a[:, g["S"] + t]):
            fail(f"[generate] a sampled token at new position {t} lies "
                 f"outside its step's top-{k}")
    mark("generate: sampling")

    b = GEN_BEAM
    bids = gen_prompts(torch, cfg, 52, b["B"], b["S"], "cuda")
    beam_kw = dict(max_new_tokens=b["new"], num_beams=b["num_beams"])
    beam = gen_mode(torch, K, model, bids, beam_kw, "[generate] beam")
    with torch.no_grad():
        beam_select_ms = time_ms(
            torch, lambda: model._beam_select(beam["run"]))[0]
    mark("generate: beam")

    eos = int(greedy["tokens"][0, g["S"] + GEN_EOS_STEP])
    eos_rec = gen_mode(torch, K, model, ids,
                       dict(max_new_tokens=g["new"], eos_token_id=eos),
                       "[generate] eos", timed=False)
    base_new = greedy["tokens"][:, g["S"]:].cpu()
    eos_new = eos_rec["tokens"][:, g["S"]:].cpu()
    for r in range(g["B"]):
        hit = (base_new[r] == eos).nonzero()
        if not len(hit):
            if not torch.equal(eos_new[r], base_new[r]):
                fail(f"[generate] eos run: row {r}, which never meets eos, "
                     "changed")
            continue
        t = int(hit[0])
        if not torch.equal(eos_new[r, :t + 1], base_new[r, :t + 1]) \
                or not bool((eos_new[r, t:] == eos).all()):
            fail(f"[generate] eos run: row {r} meets eos at {t} but does "
                 "not emit only eos after it")

    # interop on the card: export, load into a fresh card model
    state = to_hf_gpt2_state(model)
    seed(1)
    fresh = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16).eval()
    load_hf_gpt2(fresh, state)
    for (n, p), (_, q) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        if p.device != q.device or p.dtype != q.dtype \
                or not torch.equal(p, q):
            fail(f"[generate] interop: {n} differs after the round trip")
    if not torch.equal(fresh.generate(ids, **greedy_kw), greedy["tokens"]):
        fail("[generate] interop: the loaded model generated other tokens")
    del fresh, state

    shapes = gen_kernel_shapes(torch, K)
    gr = greedy
    log(f"[generate] bf16 greedy B={g['B']} S={g['S']} {g['new']} new on "
        f"{card}: prefill {gr['prefill_ms']:.3f} ms; decode ms a token "
        f"graph {gr['graph']['decode_ms_a_token']:.4f} / eager "
        f"{gr['eager']['decode_ms_a_token']:.4f}; tokens/s graph "
        f"{gr['graph']['tokens_s']:.1f} / eager {gr['eager']['tokens_s']:.1f}"
        f" (call {gr['graph']['call_ms']:.3f} / {gr['eager']['call_ms']:.3f}"
        f" ms); first call {gr['first_call_ms']:.1f} ms, capture "
        f"{gr['capture_ms']:.1f} ms; launches a decode step by the wrappers "
        f"{gr['graph_launches']}, in the first call {counts}; traced call "
        f"(window {window}): {n_launches} device launches, busy "
        f"{busy_ms:.3f} of {wall_ms:.3f} ms ({100 * busy_ms / wall_ms:.2f}%),"
        f" rows 1, 2, 6 {traced['layer_norm']} / {traced['bias_gelu']} / "
        f"{traced['flash_attention']} (fast {fast['layer_norm']} / "
        f"{fast['bias_gelu']} / {fast['flash_attention']}; outside the "
        f"replays {by_replay['outside']['layer_norm']} / "
        f"{by_replay['outside']['bias_gelu']} / "
        f"{by_replay['outside']['flash_attention']}), {whole} whole replays"
        f" of {per_step}; graph = eager bitwise, second call under sync "
        f"debug mode 'error'")
    log(f"[generate] bf16 top-k {k} T={GEN_SAMPLE['temperature']} seeds "
        f"{GEN_SEEDS}: seed {s0} twice bitwise, seed {s1} different, every "
        f"token inside its step's top-{k}; decode ms a token graph "
        f"{sampled['graph']['decode_ms_a_token']:.4f} / eager "
        f"{sampled['eager']['decode_ms_a_token']:.4f}; graph = eager bitwise")
    log(f"[generate] bf16 beam {b['num_beams']} B={b['B']} S={b['S']} "
        f"{b['new']} new: prefill {beam['prefill_ms']:.3f} ms; decode ms a "
        f"token graph {beam['graph']['decode_ms_a_token']:.4f} / eager "
        f"{beam['eager']['decode_ms_a_token']:.4f}; the beam step "
        f"(beam_search_step, parents, cache reorder) {beam_select_ms:.5f} ms"
        f"; capture {beam['capture_ms']:.1f} ms; launches a decode step "
        f"{beam['graph_launches']}; graph = eager bitwise")
    log(f"[generate] bf16 eos {eos}: rows meeting it emit only eos, the "
        f"others as without it; graph = eager bitwise.  Interop: "
        f"to_hf_gpt2_state -> load_hf_gpt2 on the card bitwise, same tokens"
        f" | {time.perf_counter() - t_phase:.1f}s")
    return counts, {"traced_a_call": {n: traced[n] for n in GEN_KERNELS},
                    "shapes": shapes}


SPEC_K = 4              # draft proposals a speculative step
SPEC_NEW = 48           # new tokens a request of the [spec] waves
SPEC_SAMPLE = dict(do_sample=True, top_k=40, temperature=0.8, seed=7)
SPEC_KERNELS = ("layer_norm", "bias_gelu", "paged_decode_attention")


def spec_prompts(vocab, seed=40):
    """16 prompts: 8 of a shared 64-token prefix and 20-64 tokens of their
    own (prefix-cache hits after the first), 8 of 20-128 fresh tokens."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, 64).tolist()
    out = []
    for _ in range(8):
        out.append(shared + rng.randint(0, vocab,
                                        rng.randint(20, 65)).tolist())
        out.append(rng.randint(0, vocab, rng.randint(20, 129)).tolist())
    return out


def spec_draft(torch, model, layers=2, own_seed=None):
    """A ``GPTConfig(num_layers=layers)`` draft on the card in the model's
    dtype holding the target's embeddings, first ``layers`` blocks and
    ln_f (layers 12: a self-draft); with ``own_seed``, initialised from
    that seed instead (a bad draft)."""
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    seed(0 if own_seed is None else own_seed)
    draft = GPTForCausalLM(
        GPTConfig(num_layers=layers, dropout=0.0, attn_dropout=0.0),
        device="cuda", dtype=model.dtype).eval()
    if own_seed is None:
        sd = model.state_dict()
        draft.set_state_dict({k: sd[k] for k in draft.state_dict()})
    return draft


def spec_wave(eng, prompts, kws=None):
    """Every prompt submitted at once (``kws``: each one's sampling
    arguments), all waited for: (outputs, wall s, the wave's metrics)."""
    from paddle_tpu_torch.serving.metrics import GenerationMetrics

    eng.metrics = GenerationMetrics(max_slots=eng.max_slots,
                                    num_pages=eng.geometry.num_pages)
    t0 = time.perf_counter()
    handles = [eng.submit(p, SPEC_NEW, **(kws[i] if kws else {}))
               for i, p in enumerate(prompts)]
    outs = [h.result(600) for h in handles]
    wall = time.perf_counter() - t0
    if any(len(o) != SPEC_NEW for o in outs):
        fail(f"[spec] a request gave {[len(o) for o in outs]} tokens")
    pages_accounted(eng, "[spec] wave")
    return outs, wall, eng.metrics.snapshot()


def spec_tie_check(torch, model, prompts, ref, got, what, skip=()):
    """Each request's greedy tokens ``got`` (but those of ``skip``) equal
    ``ref`` (the plain engine's) up to the first that differs; there the
    model's float32 forward logits of ref's sequence must hold a near tie
    (top-2 margin within LOGITS_REL_TOL x max|logits|, got's token one of
    the two).  Returns the (request, new token) of each tie."""
    ties = []
    for i, (p, a, b) in enumerate(zip(prompts, ref, got)):
        if a == b or i in skip:
            continue
        t = next(j for j in range(len(a)) if a[j] != b[j])
        with torch.no_grad():
            lg = model(torch.tensor([p + a], device=model.device))[
                0, len(p) + t - 1].float()
        top = lg.topk(2)
        margin = float(top.values[0] - top.values[1])
        if margin > LOGITS_REL_TOL * float(lg.abs().max()) \
                or b[t] not in top.indices.tolist():
            fail(f"{what}: request {i} differs from the plain engine's at "
                 f"new token {t} ({b[t]} vs {a[t]}), where the top-2 margin "
                 f"is {margin:.3e}")
        ties.append((i, t))
    return ties


def spec_sampled_check(torch, model, prompt, ref, got, kw, what):
    """A sampled stream ``got`` equals ``ref`` (the plain engine's, same
    seed) up to the first token t that differs; there the draw must be a
    near tie.  Both steps are taken again, teacher-forced on ref's tokens:
    the plain step's logits (slot_decode_paged, row 9) and the
    speculative step's (slot_verify_paged), each over a cache it wrote
    itself; d = max|their difference| at t.  With the step's Gumbel row
    (drawn again from the request's seed, one row a token as the engines
    draw them), z = (the plain logits / T, top-k cut) + noise must have a
    top-2 margin within max(2 d, the dtype's floor) / T (floor:
    LOGITS_REL_TOL x max|logits| in float32, BF16_TOL x max(1, max|logits|)
    in bf16), and got's token must be one of the two.  Returns (t, margin,
    tolerance), or None when the streams are equal."""
    from paddle_tpu_torch.framework.random import make_generator

    if got == ref:
        return None
    t = next(j for j in range(len(ref)) if ref[j] != got[j])
    with torch.no_grad():
        dec, _ = decode_run(torch, model, prompt, t, feed=ref[:t])
        ver, _ = decode_run(torch, model, prompt, t, feed=ref[:t],
                            verify=True)
    lg = dec[t]
    d = float((lg - ver[t]).abs().max())
    top_abs = float(lg.abs().max())
    floor = LOGITS_REL_TOL * top_abs if model.dtype == torch.float32 \
        else BF16_TOL * max(1.0, top_abs)
    V = model.cfg.vocab_size
    gen = make_generator(kw["seed"], model.device)
    for _ in range(t + 1):
        u = torch.rand(V, generator=gen, device=model.device)
    noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(
        torch.float32).tiny))).cpu()
    lg2 = lg / kw["temperature"]
    kth = lg2.topk(kw["top_k"]).values[-1]
    z = torch.where(lg2 < kth, torch.finfo(torch.float32).min, lg2) + noise
    top = z.topk(2)
    margin = float(top.values[0] - top.values[1])
    tol = max(2 * d, floor) / kw["temperature"]
    if margin > tol or got[t] not in top.indices.tolist():
        fail(f"{what}: the sampled stream differs from the plain engine's "
             f"at new token {t} ({got[t]} vs {ref[t]}) with a draw margin "
             f"{margin:.3e} > {tol:.3e} (the two steps' logits differ by "
             f"{d:.3e} there)")
    return t, margin, tol


def spec_kernel_shapes(torch, K):
    """Rows 1, 2 and 9 against their plain versions at the speculative
    step's shapes, bf16: LayerNorm and bias-GeLU at the verify's R = 8
    slots x (K + 1) = 40 rows, paged decode at the draft pool's geometry
    (8 slots, 12 heads x 64, page 16, 32 pages a slot) with a wave's lane
    extents.  Returns {kernel: record}."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(21)
    dt, isz = torch.bfloat16, 2
    R, N, Fd = SERVING_ENGINE["max_slots"] * (SPEC_K + 1), 768, 3072

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale
                ).to(dt)

    x, w, b = rnd(R, N), 1 + rnd(N, scale=0.1), rnd(N, scale=0.1)
    recs = {"layer_norm": compare(
        torch, f"[spec] layer_norm bf16 verify R={R} N={N}",
        lambda: K.layer_norm.layer_norm(x, w, b, 1e-5),
        lambda: K.layer_norm.layer_norm_plain(x, w, b, 1e-5),
        lambda: F.layer_norm(x, (N,), w, b, 1e-5), dt,
        (2 * R * N + 2 * N) * isz, 8 * R * N, PEAK_F32,
        variant=("layer_norm", "warp"))}
    xf, bf = rnd(R, Fd), rnd(Fd, scale=0.1)
    recs["bias_gelu"] = compare(
        torch, f"[spec] bias_gelu bf16 verify R={R} F={Fd}",
        lambda: K.bias_gelu.bias_gelu(xf, bf),
        lambda: K.bias_gelu.bias_gelu_plain(xf, bf),
        lambda: F.gelu(xf + bf), dt, (2 * R * Fd + Fd) * isz, 5 * R * Fd,
        PEAK_F32, variant=("bias_gelu", "vec"))
    recs["paged_decode_attention"] = paged_case(
        torch, K, g, dt, "[spec] draft pool",
        (84, 150, 101, 176, 97, 133, 120, 160), ps=16, hd=64)
    return recs


def spec_trace(torch, eng, prompts, what):
    """A wave of greedy requests through ``eng``'s captured step under
    the profiler, traced again (up to GEN_TRACE_WINDOWS times) until
    every replay in the trace holds exactly the graph's launches of rows
    1, 2 and 9; no traced launch of theirs on a slower kernel.  Returns
    (wall ms, busy ms, replays traced, per replay (device events, device
    ms) in the trace)."""
    per_step = {n: eng.graph_launches[n] for n in SPEC_KERNELS}
    for window in range(1, GEN_TRACE_WINDOWS + 1):
        by_replay = {}
        _, wall_ms, kernels = trace_window(
            torch, lambda: [h.result(600) for h in
                            [eng.submit(p, SPEC_NEW) for p in prompts]],
            replays=by_replay)
        require_traced(kernels, what, SPEC_KERNELS)
        per = {n: by_replay["per_replay"][n] for n in per_step}
        if any(c > per_step[n] for n, cs in per.items() for c in cs):
            fail(f"{what}: a replay in the trace holds more launches than "
                 f"the graph's {per_step}: {per}")
        n = len(per["layer_norm"])
        whole = sum(all(per[k][i] == per_step[k] for k in per_step)
                    for i in range(n))
        if n and whole == n:
            return (wall_ms, sum(t for t, _, _ in kernels), n,
                    by_replay["device"])
        log(f"{what}: traced window {window} holds {whole} whole replays "
            f"of {n}")
    fail(f"{what}: {GEN_TRACE_WINDOWS} traced waves all lacked records of "
         "a replay")


def spec_phase(torch, K, card):
    """[spec]: speculative decode in GenerationEngine on full-width
    GPT-2-small (GPTConfig(), dropout 0) at the serving engine's defaults
    (8 slots x 512, page 16, prefix cache on), spec_tokens 4, the
    speculative step (the draft's 5 chained paged decode calls and the
    target's verify) one CUDA graph.  float32: 16 requests (8 on a
    shared 64-token prefix; request 1 sampled, seed 7, top-k 40, T 0.8)
    through the plain engine, a 2-layer draft (the target's embeddings,
    first two blocks and ln_f), a self-draft (12 layers, the target's
    weights) and a bad draft (2 layers seeded on their own): greedy tokens
    equal to the plain engine's up to the first near tie, the sampled
    stream up to the first near tie of its draw, the self-draft's accept
    ratio >= 0.9, the bad draft's < 0.9.  bf16, the 2-layer draft: the
    same wave through the graph and through ``_step_spec_eager`` bitwise
    equal; the sampled stream the plain engine's up to the first near tie
    of its draw; a second wave's steps make one sync each, the fetch; a
    traced wave's replays hold rows 1, 2 and 9 on their fast kernels at
    the graph's counts; device ms, launches and tokens a step, accept
    ratio, tokens/s and TTFT beside the plain graph engine's, busy share.
    Returns ({kernel: launches on the path}, {kernel: shape record})."""
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import GenerationEngine

    t_phase = time.perf_counter()
    cfg = GPTConfig(dropout=0.0, attn_dropout=0.0)
    seed(0)
    model = GPTForCausalLM(cfg, device="cuda").eval()
    prompts = spec_prompts(cfg.vocab_size)

    def engine(draft):
        return GenerationEngine(model, device=model.device,
                                draft_model=draft, spec_tokens=SPEC_K,
                                **SERVING_ENGINE).start()

    # request 1 samples (seed 7, top-k 40, T 0.8), the others are greedy
    kws = [SPEC_SAMPLE if i == 1 else {} for i in range(len(prompts))]

    # float32
    f32 = {}
    for name, layers, own in (("plain", 0, None), ("draft-2", 2, None),
                              ("self-draft", 12, None),
                              ("bad-draft", 2, 99)):
        draft = spec_draft(torch, model, layers, own) if layers else None
        eng = engine(draft)
        try:
            if eng.capture_count != 1:
                fail(f"[spec] f32 {name}: captured {eng.capture_count}x")
            outs, wall, snap = spec_wave(eng, prompts, kws)
        finally:
            eng.stop()
        del draft
        f32[name] = {"outs": outs, "ratio": snap["spec_accept_ratio"],
                     "hits": snap["prefix_cache_hits"],
                     "tokens_s": len(prompts) * SPEC_NEW / wall}
        if name != "plain":
            plain = f32["plain"]["outs"]
            f32[name]["ties"] = spec_tie_check(
                torch, model, prompts, plain, outs, f"[spec] f32 {name}",
                skip=(1,))
            f32[name]["sampled_tie"] = spec_sampled_check(
                torch, model, prompts[1], plain[1], outs[1], SPEC_SAMPLE,
                f"[spec] f32 {name} sampled")
    if f32["self-draft"]["ratio"] < 0.9:
        fail(f"[spec] the self-draft accepted {f32['self-draft']['ratio']}"
             " of its proposals, below 0.9")
    if not 0.0 <= f32["bad-draft"]["ratio"] < 0.9:
        fail(f"[spec] the bad draft accepted {f32['bad-draft']['ratio']}")
    log(f"[spec] float32 GPT-2-small on {card}, 16 requests x {SPEC_NEW} "
        f"new (request 1 sampled: seed 7, top-k 40, T 0.8), spec_tokens "
        f"{SPEC_K}: " + "; ".join(
            f"{n} accept ratio {r['ratio']:.4f}, {r['tokens_s']:.1f} "
            f"tokens/s, prefix hits {r['hits']}"
            + (f", greedy tokens = plain's up to near ties at {r['ties']}, "
               f"the sampled request's up to {r['sampled_tie']}"
               if "ties" in r else "") for n, r in f32.items())
        + " (a tie: (request, new token); the sampled one: (new token, "
          "draw margin, tolerance), None when equal throughout)")
    mark("spec: float32")

    # bf16, the 2-layer draft
    model.to(dtype=torch.bfloat16)
    release(torch, "spec bf16")
    draft = spec_draft(torch, model)
    bf = {}
    for form in ("plain", "graph", "eager"):
        eng = engine(None if form == "plain" else draft)
        try:
            if form == "eager":
                eng.step_spec = eng._step_spec_eager
            K.reset_launch_counts()
            outs, wall, snap = spec_wave(eng, prompts, kws)
            bf[form] = {"outs": outs, "snap": snap, "replays": eng.replays,
                        "tokens_s": len(prompts) * SPEC_NEW / wall,
                        "wall": wall}
            if form == "graph":
                graph_fast = graph_check(eng, "[spec] bf16 graph")
                launches = dict(eng.graph_launches)
                # the wrappers count the eager prefills (and the warm-up
                # and capture); a replay counts nothing
                spec_counts = {n: K.launch_counts()[n]
                               + launches.get(n, 0) * eng.replays
                               for n in SPEC_KERNELS}
                fresh = spec_prompts(cfg.vocab_size, seed=41)
                syncs = sync_check(torch, eng, fresh[:4], "step_spec")
                traced = spec_trace(torch, eng, spec_prompts(
                    cfg.vocab_size, seed=42)[:8], "[spec] bf16 trace")
            elif form == "plain":
                plain_traced = spec_trace(torch, eng, spec_prompts(
                    cfg.vocab_size, seed=42)[:8], "[spec] bf16 plain trace")
        finally:
            eng.stop()
    diff = [i for i in range(len(prompts))
            if bf["graph"]["outs"][i] != bf["eager"]["outs"][i]]
    if diff:
        fail(f"[spec] bf16: requests {diff} differ between the graph and "
             "the eager step")
    tie = spec_sampled_check(torch, model, prompts[1],
                             bf["plain"]["outs"][1], bf["graph"]["outs"][1],
                             SPEC_SAMPLE, "[spec] bf16 sampled")
    same = sum(bf["plain"]["outs"][i] == bf["graph"]["outs"][i]
               for i in range(len(prompts)) if i != 1)
    for name in SPEC_KERNELS:
        if spec_counts[name] <= 0 or launches.get(name, 0) <= 0:
            fail(f"[spec] {name} was not launched on the path: "
                 f"{spec_counts}, a replay {launches}")
    shapes = spec_kernel_shapes(torch, K)
    g, p = bf["graph"], bf["plain"]
    wall_ms, busy_ms, n_rep, dev = traced
    step_ms = float(np.median([d for _, d in dev]))
    step_launches = float(np.median([n for n, _ in dev]))
    plain_ms = float(np.median([d for _, d in plain_traced[3]]))
    plain_launches = float(np.median([n for n, _ in plain_traced[3]]))
    tokens_a_step = (len(prompts) * (SPEC_NEW - 1)) / g["replays"]
    log(f"[spec] bf16 GPT-2-small + 2-layer draft on {card}, 16 requests x "
        f"{SPEC_NEW} new (request 1 sampled: seed 7, top-k 40, T 0.8), "
        f"spec_tokens {SPEC_K}: graph = eager bitwise ({g['replays']} "
        f"replays); sampled stream = the plain engine's"
        + (f" up to a near tie of its draw (new token, margin, "
           f"tolerance) {tie}" if tie is not None else "")
        + f"; greedy requests equal to the plain engine's {same}/15; "
        f"accept ratio {g['snap']['spec_accept_ratio']:.4f} "
        f"({g['snap']['spec_proposed']} proposed); tokens/s "
        f"{g['tokens_s']:.1f} vs plain graph {p['tokens_s']:.1f}; TTFT p50 "
        f"{g['snap']['ttft_p50_ms']:.3f} vs {p['snap']['ttft_p50_ms']:.3f} "
        f"ms; inter-token p50 {g['snap']['inter_token_p50_ms']:.3f} vs "
        f"{p['snap']['inter_token_p50_ms']:.3f} ms; a spec step "
        f"{step_ms:.4f} device ms, {step_launches:.1f} device launches, "
        f"{tokens_a_step:.3f} tokens (armed lanes x emitted) against a plain "
        f"decode step's {plain_ms:.4f} ms, {plain_launches:.1f} launches "
        f"(median per replay of traced waves of 8 greedy requests); traced "
        f"spec wave: {n_rep} whole replays of {launches}, busy "
        f"{busy_ms:.3f} of {wall_ms:.3f} ms ({100 * busy_ms / wall_ms:.2f}%)"
        f"; fast launches a replay {graph_fast}; path launches "
        f"{spec_counts}; {syncs} | {time.perf_counter() - t_phase:.1f}s")
    return spec_counts, shapes



PREDICT_BUCKETS = "1,2,4,8x32,64,128"   # 4 batch x 3 seq = 12 bucket graphs
PREDICT_CLIENTS = 4      # ServingClient threads of [predict-serve]
PREDICT_PER_CLIENT = 8   # requests a thread, 8-128 ids each
PREDICT_CPU_EVERY = 8    # every 8th response also against the CPU port
PREDICT_CPU_TOL = 1e-4   # x max(1, max|ref|): float32 card vs CPU, 12 layers
PREDICT_KERNELS = ("layer_norm", "bias_gelu", "flash_attention")
# launches a replay of a BERT-base bucket: LayerNorm 1 + 2 a layer,
# bias-GeLU and non-causal flash forward one a layer
PREDICT_WANT = {"layer_norm": 25, "bias_gelu": 12, "flash_attention": 12}
HTTP_NEW = 48            # new tokens a request of [http-generate]
HTTP_CUT = 16            # the resume check cuts a stream after this many
HTTP_KERNELS = ("layer_norm", "bias_gelu", "flash_attention",
                "paged_decode_attention")


def predict_kernel_shapes(torch, K):
    """Rows 1, 2 and 6 against their plain versions at /predict's smallest
    and largest buckets, float32 (BERT-base served in float32): LayerNorm
    and bias-GeLU at R = B x S rows (32 and 1024), the non-causal flash
    forward at B = 1, S = 32 and B = 8, S = 128 (H = 12, D = 64).
    Returns {kernel: {"1x32": record, "8x128": record}}."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(22)
    dt, isz = torch.float32, 4
    recs = {n: {} for n in PREDICT_KERNELS}

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale
                ).to(dt)

    for B, S in ((1, 32), (8, 128)):
        R, N, Fd, H, D = B * S, 768, 3072, 12, 64
        tag = f"{B}x{S}"
        x, w, b = rnd(R, N), 1 + rnd(N, scale=0.1), rnd(N, scale=0.1)
        recs["layer_norm"][tag] = compare(
            torch, f"[predict-serve] layer_norm f32 R={R} N={N}",
            lambda: K.layer_norm.layer_norm(x, w, b, 1e-12),
            lambda: K.layer_norm.layer_norm_plain(x, w, b, 1e-12),
            lambda: F.layer_norm(x, (N,), w, b, 1e-12), dt,
            (2 * R * N + 2 * N) * isz, 8 * R * N, PEAK_F32,
            variant=("layer_norm", "warp"))
        xf, bf = rnd(R, Fd), rnd(Fd, scale=0.1)
        recs["bias_gelu"][tag] = compare(
            torch, f"[predict-serve] bias_gelu f32 R={R} F={Fd}",
            lambda: K.bias_gelu.bias_gelu(xf, bf),
            lambda: K.bias_gelu.bias_gelu_plain(xf, bf),
            lambda: F.gelu(xf + bf), dt, (2 * R * Fd + Fd) * isz,
            5 * R * Fd, PEAK_F32, variant=("bias_gelu", "vec"))
        qkv = rnd(B, S, 3, H, D)              # the fused projection
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        recs["flash_attention"][tag] = compare(
            torch, f"[predict-serve] flash_attention f32 non-causal B={B} "
            f"S={S} H={H} D={D}",
            lambda: K.flash_attention.flash_attention(
                q, k, v, causal=False)[0],
            lambda: K.flash_attention.flash_attention_plain(
                q, k, v, causal=False)[0],
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
            dt, 4 * B * S * H * D * isz + B * H * S * 4,
            4 * D * B * H * S * S, PEAK_F32,
            variant=("flash_attention", "tf32x3"))
    return recs


class BatchRecorder:
    """Stands in for a ServingEngine's predictor: runs it and keeps each
    batch's host inputs and fetched outputs."""

    def __init__(self, pred):
        self.pred, self.batches = pred, []

    def __getattr__(self, name):
        return getattr(self.pred, name)

    def run(self, arrays):
        outs = self.pred.run(arrays)
        self.batches.append(([a.copy() for a in arrays], outs))
        return outs


def pct(xs, q):
    return float(np.percentile(xs, q)) if len(xs) else None


def predict_serve_phase(torch, K, card):
    """[predict-serve]: Model(BertModel(BertConfig())).serve on the card:
    BERT-base at full width (hidden 768, 12 layers, vocab 30522), seeded
    weights, float32, eval; buckets 1,2,4,8 x 32,64,128 (12 bucket graphs
    captured by serve() before the port opens), batch_timeout_ms 2, int64
    ids.  4 ServingClient threads x 8 requests of 8-128 ids (seeded).
    Fails unless every response is bitwise its row of a direct
    Predictor.run of the padded batch it was served in (same bucket),
    every 8th is within PREDICT_CPU_TOL of the CPU port's float32 forward
    of the same padded row, no bucket is captured after warm-up, and each
    of rows 1, 2 and 6 launched on the path (row 6 only on its float32
    split-TF32 kernel).  Rows 1, 2 and 6 against
    their plain versions at the 1 x 32 and 8 x 128 buckets' shapes; capture
    ms, request p50/p99, mean batch, padding waste, the 8 x 128 replay's
    device ms and launches, the host's JSON encode of the largest
    response.  Returns (record, the running server, probes: (ids, the
    direct run's outputs at their batch-1 bucket)) — the server serves on
    through [http-generate]."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import (BertConfig, BertModel,
                                         load_numpy_state)
    from paddle_tpu_torch.serving import ServingClient

    t_phase = time.perf_counter()
    shapes = predict_kernel_shapes(torch, K)
    cfg = BertConfig()
    seed(0)
    bert = BertModel(cfg, device="cuda").eval()
    K.reset_launch_counts()
    variants0 = K.variant_launches()
    t0 = time.perf_counter()
    srv = Model(bert).serve(
        port=0, blocking=False, install_signal_handlers=False,
        buckets=PREDICT_BUCKETS, batch_timeout_ms=2,
        input_spec=[((-1, -1), "int64")])
    start_ms = (time.perf_counter() - t0) * 1e3
    eng = srv.engine
    pred = eng._predictor
    if pred.compile_count != 12:
        fail(f"[predict-serve] serve() captured {pred.compile_count} bucket "
             "graphs, not 12")
    rec = BatchRecorder(pred)
    eng._predictor = rec
    rs = np.random.RandomState(52)
    reqs = [[rs.randint(0, cfg.vocab_size, rs.randint(8, 129)).astype(
        np.int64) for _ in range(PREDICT_PER_CLIENT)]
        for _ in range(PREDICT_CLIENTS)]
    results, lat, errors = {}, [], []

    def client(c):
        cl = ServingClient(srv.url, timeout=300)
        try:
            for i, ids in enumerate(reqs[c]):
                t = time.perf_counter()
                results[(c, i)] = cl.predict([ids])
                lat.append((time.perf_counter() - t) * 1e3)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"client {c}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(PREDICT_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"[predict-serve] {errors}")
    counts = K.launch_counts()
    # the eager warm-ups and captures pass through the wrappers: every
    # float32 attention launch of the bucket graphs took the split-TF32
    # kernel
    took = {v: c - variants0["flash_attention"][v]
            for v, c in K.variant_launches()["flash_attention"].items()}
    if took["simt"] or took["mma"] or not took["tf32x3"]:
        fail(f"[predict-serve] the bucket graphs' attention launches took "
             f"{took}")
    replays = dict(pred.replays)
    snap = eng.metrics.snapshot()
    eng._predictor = pred
    if pred.compile_count != 12 or snap["compile_count"] != 12:
        fail(f"[predict-serve] {pred.compile_count} bucket graphs after "
             "the traffic: a bucket was captured after warm-up")
    key8 = (((8, 128), "int64"),)
    per_replay = pred.graph_launches[key8]
    path = {n: counts[n] + sum(pred.graph_launches[k].get(n, 0) * r
                               for k, r in replays.items())
            for n in PREDICT_KERNELS}
    for n in PREDICT_KERNELS:
        if path[n] <= 0 or per_replay.get(n, 0) <= 0:
            fail(f"[predict-serve] {n} was not launched on the path: "
                 f"{path}, an 8 x 128 replay {per_replay}")
    # every response is bitwise its row of the direct run of its batch
    flat = [(c, i, ids) for c in range(PREDICT_CLIENTS)
            for i, ids in enumerate(reqs[c])]
    matched = {}
    for arrays, outs in rec.batches:
        direct = pred.run(arrays)
        for o, d in zip(outs, direct):
            if not np.array_equal(o, d):
                fail("[predict-serve] a served batch differs from its "
                     f"direct run at bucket {arrays[0].shape}")
        for j, row in enumerate(arrays[0]):
            for c, i, ids in flat:
                if np.array_equal(row[:len(ids)], ids) \
                        and not row[len(ids):].any():
                    got = results[(c, i)]
                    if not (np.array_equal(got[0], outs[0][j, :len(ids)])
                            and np.array_equal(got[1], outs[1][j])):
                        fail(f"[predict-serve] response ({c}, {i}) is not "
                             "bitwise its row of the served batch")
                    matched[(c, i)] = (arrays[0].shape, row)
    if len(matched) != len(flat):
        fail(f"[predict-serve] matched {len(matched)} of {len(flat)} "
             "responses to a row of a served batch")
    batch_shapes = sorted({tuple(a[0].shape) for a, _ in rec.batches})
    # every 8th against the CPU port's float32 forward of the padded row
    cpu = BertModel(cfg, device="cpu").eval()
    load_numpy_state(cpu, {k: v.cpu().numpy()
                           for k, v in bert.state_dict().items()})
    cpu_err = []
    for c, i, ids in flat[::PREDICT_CPU_EVERY]:
        _, row = matched[(c, i)]
        with torch.no_grad():
            seq, pooled = cpu(torch.from_numpy(row[None]))
        for got, want in ((results[(c, i)][0], seq[0, :len(ids)].numpy()),
                          (results[(c, i)][1], pooled[0].numpy())):
            err = float(np.abs(got - want).max())
            tol = PREDICT_CPU_TOL * max(1.0, float(np.abs(want).max()))
            if not err <= tol:
                fail(f"[predict-serve] response ({c}, {i}) differs from "
                     f"the CPU port's by {err:.3e} > {tol:.3e}")
            cpu_err.append(err)
    del cpu
    # the 8 x 128 replay's device time, the largest response's JSON encode
    b8 = pred._buckets[key8]
    b8.graph.replay()
    replay_ms = _events_ms(
        torch, lambda: [b8.graph.replay() for _ in range(20)], 20)
    big = max(results.values(), key=lambda o: o[0].size)
    enc = []
    for _ in range(5):
        t = time.perf_counter()
        body = json.dumps({"outputs": [np.asarray(o).tolist() for o in big],
                           "dtypes": [str(o.dtype) for o in big],
                           "latency_ms": 0.0}).encode()
        enc.append((time.perf_counter() - t) * 1e3)
    # probes for [http-generate]: batch-1 requests with their direct runs
    probes = []
    for S in (40, 77, 128):
        ids = rs.randint(0, cfg.vocab_size, S).astype(np.int64)
        padded = np.zeros((1, eng.buckets.seq_for(S)), np.int64)
        padded[0, :S] = ids
        d = pred.run([padded])
        probes.append((ids, [d[0][0, :S].copy(), d[1][0].copy()]))
    cap = sorted(pred.capture_ms.values())
    record = {
        "counts": path, "launches_a_replay_8x128": dict(per_replay),
        "shapes": shapes, "captures": pred.compile_count,
        "capture_ms_total": sum(cap), "replay_8x128_ms": replay_ms,
        "p50_ms": snap["p50_ms"], "p99_ms": snap["p99_ms"],
        "mean_batch": snap["mean_batch_size"],
        "padding_waste_ratio": snap["padding_waste_ratio"]}
    log(f"[predict-serve] BERT-base float32 on {card}: serve() took "
        f"{start_ms:.1f} ms, {pred.compile_count} bucket captures "
        f"{sum(cap):.1f} ms in all (each {cap[0]:.1f}-{cap[-1]:.1f} ms), 0 "
        f"after warm-up; {len(flat)} requests from {PREDICT_CLIENTS} "
        f"ServingClient threads in {wall:.3f} s ({len(flat) / wall:.2f} "
        f"requests/s): server p50 {snap['p50_ms']} ms, p99 "
        f"{snap['p99_ms']} ms; client p50 {pct(lat, 50):.3f} ms, p99 "
        f"{pct(lat, 99):.3f} ms; {snap['batches']} batches, mean batch "
        f"{snap['mean_batch_size']}, padding_waste_ratio "
        f"{snap['padding_waste_ratio']}; batch shapes {batch_shapes}; every "
        f"response bitwise its row of the direct run at its bucket; every "
        f"{PREDICT_CPU_EVERY}th within the CPU port's by max "
        f"{max(cpu_err):.3e}; an 8 x 128 replay {replay_ms:.4f} device ms, "
        f"launches {per_replay} (expected {PREDICT_WANT}); the largest "
        f"response ({big[0].shape[0]} x {big[0].shape[1]} + pooled) JSON "
        f"encode {pct(enc, 50):.3f} ms for {len(body)} bytes; path "
        f"launches {path} | {time.perf_counter() - t_phase:.1f}s")
    return record, srv, probes


def bf16_tie(torch, model, prompt, ref, got, kw, what, cut=None,
             verify=False):
    """``got`` equals ``ref`` (two runs of one request on the bf16 model,
    same seed) up to the first new token t that differs; there the choice
    must be a near tie.  The logits at t: the model's forward of prompt +
    ref[:t] (the flash prefill path); with ``cut`` (got resumed after
    ``cut`` tokens), the uninterrupted path's (slot_prefill of the prompt,
    then slot_decode_paged steps fed ref[:t]) and d = max|their difference
    from the resumed path's| (slot_prefill of prompt + ref[:cut], then
    steps fed ref[cut:t]; ``verify``: slot_verify_paged steps, the
    speculative step's first position).  Greedy: a top-2 margin within max(2 d,
    BF16_TOL x max(1, max|logits|)) with got's token one of the two;
    sampled, on z = logits / T + the request's Gumbel row t (drawn again
    from its seed, one row a token) and the tolerance over T: got's token
    in the top-k cut or within the tolerance of it (the cut is a
    threshold: a token that close is in one path's cut and may be out of
    the other's), and its z at most the tolerance below every other
    token's that is surely in the cut.  Returns (t, margin, tolerance[,
    the tokens at the cut]), or None when equal."""
    from paddle_tpu_torch.framework.random import make_generator

    if got == ref:
        return None
    t = next(j for j in range(min(len(ref), len(got))) if ref[j] != got[j])
    d = 0.0
    with torch.no_grad():
        if cut is None:
            lg = model(torch.tensor([prompt + ref[:t]], device=model.device))[
                0, -1].float().cpu()
        else:
            a, _ = decode_run(torch, model, prompt, t, feed=ref[:t],
                              verify=verify)
            b, _ = decode_run(torch, model, prompt + ref[:cut], t - cut,
                              feed=ref[cut:t], verify=verify)
            lg = a[t]
            d = float((a[t] - b[t - cut]).abs().max())
    tol = max(2 * d, BF16_TOL * max(1.0, float(lg.abs().max())))
    g = got[t]
    if not kw.get("do_sample"):
        top = lg.topk(2)
        margin = float(top.values[0] - top.values[1])
        if margin > tol or g not in top.indices.tolist():
            fail(f"{what}: differs at new token {t} ({g} vs {ref[t]}) with "
                 f"a top-2 margin {margin:.3e} > {tol:.3e} (the paths' "
                 f"logits differ by {d:.3e} there)")
        return t, margin, tol
    gen = make_generator(kw["seed"], model.device)
    for _ in range(t + 1):
        u = torch.rand(model.cfg.vocab_size, generator=gen,
                       device=model.device)
    noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(
        torch.float32).tiny))).cpu()
    tol /= kw["temperature"]
    lg2 = lg / kw["temperature"]
    kth = float(lg2.topk(kw["top_k"]).values[-1])
    # top-k's cut is a threshold: a token within the tolerance of the
    # k-th value may be in one path's cut and out of the other's
    sure = lg2 > kth + tol
    edge = (lg2 - kth).abs() <= tol
    z = lg2 + noise
    rivals = z.masked_fill(~sure, float("-inf"))
    rivals[g] = float("-inf")
    margin = float(rivals.max() - z[g])      # how far got's draw lost
    if not (bool(sure[g] or edge[g]) and margin <= tol):
        fail(f"{what}: differs at new token {t} ({g} vs {ref[t]}): got's "
             f"draw loses by {margin:.3e} > {tol:.3e} to a token surely in "
             f"the top-k cut, or lies out of it (the paths' logits differ "
             f"by {d:.3e} there; {int(edge.sum())} tokens within the "
             "tolerance of the cut)")
    return t, margin, tol, f"{int(edge.sum())} at the top-k cut"


def http_wave(url, prompts, kws, streamed, probe=None, new=HTTP_NEW,
              tag="[http-generate]", pace=None):
    """Every prompt sent at once over HTTP, one ServingClient thread a
    request (``streamed[i]``: SSE, else one JSON body), ``new`` new tokens
    each; ``probe`` runs on one more thread meanwhile.  ``pace``: requests
    0 and 1 start one by one, each followed by ``pace(k)``, which returns
    once k requests are in flight; then the rest start.  Returns (tokens,
    wall s, client TTFT ms of the streams, their inter-token gaps ms)."""
    from paddle_tpu_torch.serving import ServingClient

    outs, ttft, gaps, errors = {}, [], [], []

    def one(i):
        cl = ServingClient(url, timeout=300)
        try:
            if not streamed[i]:
                outs[i] = cl.generate(prompts[i], new, **kws[i])["tokens"]
                return
            t0 = last = time.perf_counter()
            toks = []
            for evt in cl.generate_stream(prompts[i], new, **kws[i]):
                now = time.perf_counter()
                if "token" in evt:
                    (ttft.append((now - t0) * 1e3) if not toks
                     else gaps.append((now - last) * 1e3))
                    toks.append(evt["token"])
                    last = now
                elif evt.get("error"):
                    errors.append(f"request {i}: {evt['error']}")
            outs[i] = toks
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    if probe is not None:
        threads.append(threading.Thread(target=probe))
    t0 = time.perf_counter()
    for k in (range(2) if pace else ()):
        threads[k].start()
        pace(k + 1)
    for t in threads:
        if t.ident is None:
            t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or len(outs) != len(prompts):
        fail(f"{tag} {errors}")
    return [outs[i] for i in range(len(prompts))], wall, ttft, gaps


def inproc_wave(eng, prompts, kws):
    """The same requests submitted in process, all at once: (tokens, wall
    s, the engine's metrics of the wave)."""
    from paddle_tpu_torch.serving.metrics import GenerationMetrics

    eng.metrics = GenerationMetrics(max_slots=eng.max_slots,
                                    num_pages=eng.geometry.num_pages)
    t0 = time.perf_counter()
    hs = [eng.submit(p, HTTP_NEW, **kws[i]) for i, p in enumerate(prompts)]
    outs = [h.result(600) for h in hs]
    return outs, time.perf_counter() - t0, eng.metrics.snapshot()


def http_generate_phase(torch, K, card, predict_srv, probes):
    """[http-generate]: Model(GPTForCausalLM(GPTConfig())).serve_generate
    on the card: GPT-2-small, seeded weights, bf16, dropout 0, the serving
    cell's engine (8 slots x 512, page 16, prefix cache on, its decode
    step one CUDA graph).  16 requests of 20-128 prompt tokens (8 on a
    shared 64-token prefix), 48 new tokens each, 8 streamed as SSE, 2
    sampling with top-k 40: a cold in-process wave fills the prefix cache,
    then the HTTP wave (with 3 /predict probes to [predict-serve]'s server
    on another thread) and the same wave in process, each request's
    tokens equal up to a near tie (bf16_tie).  The probes must be bitwise
    their direct runs (the BERT bucket graphs survive the decode graph's
    replays beside them).  Resume: 2 greedy and 1 sampled request of the
    wave, and 1 sampled through a speculative engine (the 2-layer draft
    of [spec]) behind a ServingServer of its own, cut after 16 tokens and
    resubmitted over HTTP with them appended and resume_pos 16: the rest
    must equal the uninterrupted stream up to a near tie (bf16_tie with
    the two paths' logit difference: the resumed prompt's K/V come from a
    prefill, the uninterrupted stream's from decode steps).  Then
    shutdown() with 4 SSE streams open: each ends with its done event,
    the drain clean.  Returns a record with every kernel's launches on
    the path."""
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.framework.random import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import (GenerationEngine, ServingClient,
                                          ServingServer)

    t_phase = time.perf_counter()
    cfg = GPTConfig(dropout=0.0, attn_dropout=0.0)
    seed(0)
    model = GPTForCausalLM(cfg, device="cuda").eval()
    model.to(dtype=torch.bfloat16)
    engine_kw = dict(max_slots=SERVING_ENGINE["max_slots"],
                     max_seq_len=SERVING_ENGINE["max_seq_len"],
                     prompt_buckets=SERVING_ENGINE["prompt_buckets"],
                     page_size=SERVING_ENGINE["page_size"],
                     prefix_cache=True)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    srv = Model(model).serve_generate(port=0, blocking=False,
                                      install_signal_handlers=False,
                                      **engine_kw)
    start_ms = (time.perf_counter() - t0) * 1e3
    eng = srv.gen_engine
    if eng.capture_count != 1:
        fail(f"[http-generate] captured {eng.capture_count}x")
    prompts = spec_prompts(cfg.vocab_size, seed=43)
    # the resumed prompts (with HTTP_CUT tokens appended) must fit the
    # largest prompt bucket: 2 of those sample, 2 others are greedy
    fits = [i for i, p in enumerate(prompts)
            if len(p) + HTTP_CUT <= int(engine_kw["prompt_buckets"].split(
                ",")[-1])]
    sampled = fits[:2]
    kws = [dict(GEN_SAMPLE, seed=70 + i) if i in sampled else {}
           for i in range(len(prompts))]
    streamed = [i % 2 == 0 for i in range(len(prompts))]
    inproc_wave(eng, prompts, kws)                # fills the prefix cache
    probe_out, probe_err = [], []

    def probe():
        cl = ServingClient(predict_srv.url, timeout=300)
        try:
            for ids, _ in probes:
                probe_out.append(cl.predict([ids]))
        except Exception as e:  # noqa: BLE001 - reported below
            probe_err.append(f"{type(e).__name__}: {e}")

    replays0 = eng.replays
    http_outs, http_wall, ttft, gaps = http_wave(srv.url, prompts, kws,
                                                 streamed, probe)
    http_replays = eng.replays - replays0
    http_snap = eng.metrics.snapshot()
    in_outs, in_wall, in_snap = inproc_wave(eng, prompts, kws)
    if probe_err:
        fail(f"[http-generate] /predict probes: {probe_err}")
    for (ids, want), got in zip(probes, probe_out):
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            fail("[http-generate] a /predict probe served beside the decode "
                 "graph is not bitwise its direct run")
    ties = {}
    for i, p in enumerate(prompts):
        if len(http_outs[i]) != HTTP_NEW:
            fail(f"[http-generate] request {i} gave {len(http_outs[i])} "
                 "tokens over HTTP")
        tie = bf16_tie(torch, model, p, in_outs[i], http_outs[i], kws[i],
                       f"[http-generate] request {i} (HTTP vs in-process)")
        if tie is not None:
            ties[i] = tie
    # resume: cut after HTTP_CUT tokens, resubmit over HTTP
    cl = ServingClient(srv.url, timeout=300)
    greedy = [i for i in fits if i not in sampled]
    resumed = {}
    for i in greedy[:2] + [sampled[0]]:
        ref = in_outs[i]
        rest = cl.generate(prompts[i] + ref[:HTTP_CUT], HTTP_NEW - HTTP_CUT,
                           resume_pos=HTTP_CUT, **kws[i])["tokens"]
        resumed[i] = bf16_tie(torch, model, prompts[i], ref,
                              ref[:HTTP_CUT] + rest, kws[i],
                              f"[http-generate] resumed request {i}",
                              cut=HTTP_CUT)
    counts = K.launch_counts()
    path = {n: counts[n] + eng.graph_launches.get(n, 0) * eng.replays
            for n in HTTP_KERNELS}
    for n in HTTP_KERNELS:
        if path[n] <= 0:
            fail(f"[http-generate] {n} was not launched on the path: {path}")
    # the speculative engine's sampled stream, resumed over HTTP
    draft = spec_draft(torch, model)
    spec_eng = GenerationEngine(model, device=model.device,
                                draft_model=draft, spec_tokens=SPEC_K,
                                **engine_kw)
    spec_srv = ServingServer(None, gen_engine=spec_eng, port=0,
                             install_signal_handlers=False).start()
    try:
        j = sampled[1]
        ref = spec_eng.generate(prompts[j], HTTP_NEW, timeout=600, **kws[j])
        rest = ServingClient(spec_srv.url, timeout=300).generate(
            prompts[j] + ref[:HTTP_CUT], HTTP_NEW - HTTP_CUT,
            resume_pos=HTTP_CUT, **kws[j])["tokens"]
        resumed[f"spec {j}"] = bf16_tie(
            torch, model, prompts[j], ref, ref[:HTTP_CUT] + rest, kws[j],
            f"[http-generate] resumed request {j} (spec engine)",
            cut=HTTP_CUT, verify=True)
    finally:
        spec_clean = spec_srv.shutdown()
    del draft, spec_eng, spec_srv
    # shutdown with 4 SSE streams open
    events = {i: [] for i in range(4)}
    drain_prompts = spec_prompts(cfg.vocab_size, seed=44)[:4]

    def stream(i):
        c = ServingClient(srv.url, timeout=300)
        try:
            for evt in c.generate_stream(drain_prompts[i], HTTP_NEW):
                events[i].append(evt)
        except Exception as e:  # noqa: BLE001 - reported below
            events[i].append({"client_error": f"{type(e).__name__}: {e}"})

    threads = [threading.Thread(target=stream, args=(i,)) for i in events]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + 120
    while not all(any("token" in e for e in ev) for ev in events.values()):
        if time.perf_counter() > deadline:
            fail("[http-generate] the drain's streams gave no token")
        time.sleep(0.002)
    open_at = [sum("token" in e for e in ev) for ev in events.values()]
    t0 = time.perf_counter()
    clean = srv.shutdown()
    drain_ms = (time.perf_counter() - t0) * 1e3
    for t in threads:
        t.join(120)
    code = srv.wait(5)
    for i, ev in events.items():
        last = ev[-1] if ev else {}
        if not (last.get("done") and "error" not in last
                and last.get("tokens") == HTTP_NEW
                and sum("token" in e for e in ev) == HTTP_NEW):
            fail(f"[http-generate] drained stream {i} ended with {last}")
    if not (clean and spec_clean and code == 0):
        fail(f"[http-generate] the drain was not clean: {clean}, spec "
             f"{spec_clean}, wait() {code}")
    n_tok = len(prompts) * HTTP_NEW
    record = {
        "counts": path, "graph_launches_a_replay": dict(eng.graph_launches),
        "http_tokens_s": n_tok / http_wall, "inproc_tokens_s": n_tok / in_wall,
        "http_ttft_p50_ms": http_snap["ttft_p50_ms"],
        "inproc_ttft_p50_ms": in_snap["ttft_p50_ms"],
        "http_inter_token_p50_ms": http_snap["inter_token_p50_ms"],
        "inproc_inter_token_p50_ms": in_snap["inter_token_p50_ms"],
        "client_ttft_p50_ms": pct(ttft, 50),
        "client_inter_token_p50_ms": pct(gaps, 50),
        "ties": ties, "resumed": resumed, "drain_ms": drain_ms}
    log(f"[http-generate] GPT-2-small bf16 on {card}: serve_generate() took "
        f"{start_ms:.1f} ms (1 decode graph); 16 requests x {HTTP_NEW} new "
        f"(8 SSE, requests {sampled} sampled top-k 40): HTTP "
        f"{n_tok / http_wall:.1f} tokens/s ({http_replays} replays), "
        f"engine TTFT p50 {http_snap['ttft_p50_ms']:.3f} ms, inter-token "
        f"p50 {http_snap['inter_token_p50_ms']:.3f} ms, at the client "
        f"TTFT p50 {pct(ttft, 50):.3f} ms, inter-token p50 "
        f"{pct(gaps, 50):.3f} ms (the 8 streams); in process "
        f"{n_tok / in_wall:.1f} tokens/s, TTFT p50 "
        f"{in_snap['ttft_p50_ms']:.3f} ms, inter-token p50 "
        f"{in_snap['inter_token_p50_ms']:.3f} ms; tokens HTTP = in-process "
        f"{16 - len(ties)}/16 (near ties (new token, margin, tolerance) "
        f"{ties}); {len(probes)} /predict probes bitwise beside the decode "
        f"graph; resumed at {HTTP_CUT} over HTTP (None = equal to the "
        f"uninterrupted stream) {resumed}; shutdown() with 4 SSE streams "
        f"open at {open_at} tokens: clean in {drain_ms:.1f} ms, every "
        f"stream done at {HTTP_NEW} tokens; a decode replay's launches "
        f"{eng.graph_launches}; path launches {path} | "
        f"{time.perf_counter() - t_phase:.1f}s")
    return record


FLEET_ARGV = ["--layers", "12", "--hidden", "768", "--heads", "12",
              "--vocab", "50304", "--max-seq-len", "512", "--slots", "8",
              "--prompt-buckets", "64,128", "--page-size", "16",
              "--seed", "0"]     # the replica's argv at GPTConfig()'s widths
FLEET_NEW = 48           # new tokens a request of [fleet]
FLEET_KILL_AT = 16       # the drill kills its stream's replica after this
FLEET_CPU_NEW = 8        # the twin's first tokens held against the CPU's
FLEET_HEARTBEAT_S = 5.0  # the supervisor's heartbeat timeout (the
#                          reference's drill's; its library default is 2.0)
FLEET_WANT = {"layer_norm": 25, "bias_gelu": 12,
              "paged_decode_attention": 12}   # launches in a decode replay
ROOT = os.path.dirname(os.path.abspath(__file__))


def fleet_kernel_shapes(torch, K):
    """Rows 1, 2, 6 and 9 against their plain versions at a full-width
    float32 replica's shapes: LayerNorm and bias-GeLU at a decode step's
    R = 8 rows and a prefill's R = 64 and 128, causal flash attention at a
    prefill of S = 64 and S = 128 (B = 1, the packed qkv's slices: the
    split-TF32 kernel, float32), paged decode over the 8-slot table (page
    16, 32 pages a slot).  Returns {kernel: {shape: record}}."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(23)
    dt, isz = torch.float32, 4
    N, Fd, H, D = 768, 3072, 12, 64
    recs = {n: {} for n in SERVING_KERNELS}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    for R in (8, 64, 128):
        tag = "decode R=8" if R == 8 else f"prefill R={R}"
        x, w, b = rnd(R, N), 1 + rnd(N, scale=0.1), rnd(N, scale=0.1)
        recs["layer_norm"][tag] = compare(
            torch, f"[fleet] layer_norm f32 {tag} N={N}",
            lambda: K.layer_norm.layer_norm(x, w, b, 1e-5),
            lambda: K.layer_norm.layer_norm_plain(x, w, b, 1e-5),
            lambda: F.layer_norm(x, (N,), w, b, 1e-5), dt,
            (2 * R * N + 2 * N) * isz, 8 * R * N, PEAK_F32,
            variant=("layer_norm", "warp"))
        xf, bf = rnd(R, Fd), rnd(Fd, scale=0.1)
        recs["bias_gelu"][tag] = compare(
            torch, f"[fleet] bias_gelu f32 {tag} F={Fd}",
            lambda: K.bias_gelu.bias_gelu(xf, bf),
            lambda: K.bias_gelu.bias_gelu_plain(xf, bf),
            lambda: F.gelu(xf + bf), dt, (2 * R * Fd + Fd) * isz,
            5 * R * Fd, PEAK_F32, variant=("bias_gelu", "vec"))
    for S in (64, 128):
        qkv = rnd(1, S, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        pairs = H * S * (S + 1) // 2
        recs["flash_attention"][f"prefill S={S}"] = compare(
            torch, f"[fleet] flash_attention f32 prefill B=1 S={S} H={H} "
            f"D={D} causal",
            lambda: K.flash_attention.flash_attention(q, k, v)[0],
            lambda: K.flash_attention.flash_attention_plain(q, k, v)[0],
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True), dt,
            4 * S * H * D * isz + H * S * 4, 4 * D * pairs, PEAK_F32,
            variant=("flash_attention", "tf32x3"))
    recs["paged_decode_attention"]["decode 8 slots"] = paged_case(
        torch, K, g, dt, "[fleet] decode",
        [79, 95, 111, 127, 143, 80, 64, 127], 16, D, nh=H, pps=32)
    return recs


def fleet_prompts(vocab, seed, groups=1, n=8):
    """``groups`` x ``n`` prompts: each group a 64-token prefix of its own
    and 1-16 tokens of each prompt's (65-80 tokens: the router's affinity
    key is the page-aligned shareable prefix, the first 4 pages of 16
    exactly), the groups interleaved."""
    rng = np.random.RandomState(seed)
    heads = [rng.randint(0, vocab, 64).tolist() for _ in range(groups)]
    return [heads[j] + rng.randint(0, vocab, rng.randint(1, 17)).tolist()
            for _ in range(n) for j in range(groups)]


def fleet_wave(url, prompts, streamed, pace=None):
    """:func:`http_wave` of greedy requests, FLEET_NEW new tokens each."""
    return http_wave(url, prompts, [{}] * len(prompts), streamed,
                     new=FLEET_NEW, tag="[fleet]", pace=pace)


def inproc_fleet_wave(eng, prompts, streamed):
    """The same requests submitted to the engine in process, all at once,
    each read on a thread of its own as tokens arrive.  Returns as
    :func:`http_wave` (TTFT and gaps of the ``streamed`` ones)."""
    outs, ttft, gaps = {}, [], []

    def one(i, h, t0):
        toks, last = [], t0
        for tok in h:
            now = time.perf_counter()
            if streamed[i]:
                (ttft.append((now - t0) * 1e3) if not toks
                 else gaps.append((now - last) * 1e3))
            toks.append(tok)
            last = now
        outs[i] = toks

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(
        i, eng.submit(p, FLEET_NEW), time.perf_counter()))
        for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if len(outs) != len(prompts):
        fail("[fleet] the in-process wave did not finish")
    return [outs[i] for i in range(len(prompts))], wall, ttft, gaps


def wave_text(name, n_req, wall, ttft, gaps):
    return (f"{name}: {n_req * FLEET_NEW / wall:.1f} tokens/s, client "
            f"TTFT p50 {pct(ttft, 50):.3f} ms, inter-token p50 "
            f"{pct(gaps, 50):.3f} ms")


def prefix_counts(url):
    """(hits, misses) of a replica's prefix cache, from its /metrics."""
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    got = {}
    for line in text.splitlines():
        for key in ("hits", "misses"):
            if line.startswith(f"paddle_genserve_prefix_cache_{key}_total "):
                got[key] = int(float(line.split()[1]))
    return got["hits"], got["misses"]


class HeartbeatGaps:
    """Samples the coordinator's last-beat clock of every rank every 20
    ms on a thread: the largest gap between two beats of one process of a
    rank (from its first beat on), which the supervisor's heartbeat
    timeout must stay above."""

    def __init__(self, coord):
        self._det = coord.detector
        self._stop = threading.Event()
        self.gaps: dict[int, float] = {}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        last = {}
        while not self._stop.wait(0.02):
            for r, t in list(self._det._last_beat.items()):
                if r not in self._det._beaten:   # not beaten since (re)start
                    last.pop(r, None)
                    continue
                if r in last and t != last[r]:
                    self.gaps[r] = max(self.gaps.get(r, 0.0), t - last[r])
                last[r] = t

    def stop(self):
        self._stop.set()
        self._thread.join(5)
        return {r: round(g, 3) for r, g in sorted(self.gaps.items())}


def capture_ms_of(log_path):
    """The engine's capture time from a replica's log line."""
    m = re.findall(r"capture ms=([0-9.]+)", log_path.read_text())
    return float(m[-1]) if m else None


def fleet_phase(torch, K, card):
    """[fleet]: GPT-2-small replicas as processes, behind the router.

    The replica's argv (``python -m paddle_tpu_torch.serving.generation``
    at GPTConfig()'s widths: 12 layers, hidden 768, 12 heads, vocab 50304,
    max_seq_len 512, 8 slots, prompt buckets 64 and 128, page 16, seed 0),
    float32, TF32 off, on the card.  First the in-process twin: the same
    argv through ``build_replica`` (the function main() builds with) and
    ``start()``; its decode graph's launches and variants (its prefills'
    attention only on the split-TF32 kernel), rows 1, 2, 6 and 9 against
    their plain versions at its shapes, 4 greedy prompts
    (the first 8 tokens held against the CPU port's, up to a near tie by
    margin_check) and an in-process wave.  Then a ReplicaSupervisor of 2
    replicas (their kernels already built by this process) and a
    FleetRouter on its coordinator: start-up (spawn to registration) and
    each replica's capture time from its log; each replica's tokens for
    the 4 prompts bitwise the twin's; an affinity burst of 8 requests on
    one 64-token prefix (>= 7 routed prefix_hit to one replica, whose
    prefix cache hits >= 7 of the 8); the wave through the router (its two
    prefix groups on different replicas) and straight to one replica; the
    SIGKILL drill (a greedy SSE stream cut after its 16th token: no error,
    0 failed requests, a mid-stream failover, the tokens the twin's up to
    a near tie by margin_check against the CPU port's logits of them, the
    victim respawned and re-admitted, a replica_lost dump with down_s >
    0, device memory before and after); the drain of the router and the
    supervisor with 2 streams open.  Every replica is killed in a finally.
    Returns the record of rows 1, 2, 6 and 9 on this path."""
    import contextlib
    import io
    import logging

    from paddle_tpu_torch.monitor import flightrec
    from paddle_tpu_torch.serving import ServingClient
    from paddle_tpu_torch.serving.fleet import ReplicaSupervisor
    from paddle_tpu_torch.serving.generation import (build_replica,
                                                     replica_parser)
    from paddle_tpu_torch.serving.router import FleetRouter
    from paddle_tpu_torch.utils.metrics import MetricsRegistry

    t_phase = time.perf_counter()
    shapes = fleet_kernel_shapes(torch, K)
    # -- the in-process twin -------------------------------------------
    args = replica_parser().parse_args(FLEET_ARGV + ["--device", "cuda"])
    K.reset_launch_counts()
    variants0 = K.variant_launches()
    t0 = time.perf_counter()
    twin = build_replica(args).start()
    twin_start_ms = (time.perf_counter() - t0) * 1e3
    replay = graph_check(twin, "[fleet] twin")
    if {n: twin.graph_launches.get(n, 0) for n in FLEET_WANT} != FLEET_WANT:
        fail(f"[fleet] a decode replay's launches {twin.graph_launches}, "
             f"not {FLEET_WANT}")
    cfg = twin.model.cfg
    rng = np.random.RandomState(50)
    probes = [rng.randint(0, cfg.vocab_size, n).tolist()
              for n in (20, 64, 97, 128)]
    hs = [twin.submit(p, FLEET_NEW) for p in probes]
    twin_toks = [h.result(600) for h in hs]
    inproc = inproc_fleet_wave(
        twin, fleet_prompts(cfg.vocab_size, 61, groups=2),
        [i % 2 == 0 for i in range(16)])
    drill_prompt = np.random.RandomState(70).randint(
        0, cfg.vocab_size, 64).tolist()
    oracle = twin.generate(drill_prompt, FLEET_NEW, timeout=600)
    counts = K.launch_counts()
    path = {n: counts[n] + twin.graph_launches.get(n, 0) * twin.replays
            for n in SERVING_KERNELS}
    took = {n: {v: c - variants0[n][v] for v, c in vs.items()}
            for n, vs in K.variant_launches().items() if n in path}
    # float32 prefills: every attention launch on the split-TF32 kernel
    if any(path[n] <= 0 for n in SERVING_KERNELS) \
            or took["flash_attention"]["mma"] \
            or took["flash_attention"]["simt"] \
            or not took["flash_attention"]["tf32x3"]:
        fail(f"[fleet] twin path launches {path}, variants {took}")
    # the CPU port, same argv on the CPU: its greedy tokens for the
    # probes, and its logits of the drill's oracle for its near-tie check
    cpu = build_replica(replica_parser().parse_args(
        FLEET_ARGV + ["--device", "cpu"])).model
    cpu_ties = []
    with torch.no_grad():
        for i, p in enumerate(probes):
            ref = cpu.generate(torch.tensor([p]),
                               max_new_tokens=FLEET_CPU_NEW)
            got = torch.tensor([p + twin_toks[i][:FLEET_CPU_NEW]])
            cpu_ties += [(i, t) for _, t in margin_check(
                torch, got, ref, cpu(ref.long()).float(), len(p),
                f"[fleet] twin probe {i} (card vs CPU)")]
        ref_seq = torch.tensor([drill_prompt + oracle])
        oracle_logits = cpu(ref_seq).float()
    del cpu
    log(f"[fleet] twin on {card}: built and captured in {twin_start_ms:.1f}"
        f" ms (capture {twin.capture_ms:.1f} ms); a decode replay "
        f"{replay}; path launches {path}; variants {took}; 4 probes x "
        f"{FLEET_NEW} greedy, first {FLEET_CPU_NEW} = the CPU port's up to "
        f"near ties {cpu_ties}")
    release(torch, "the fleet's replicas")
    # -- the fleet --------------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="fleet-", dir=os.environ.get("TMPDIR"))
    logs = pathlib.Path(tmp) / "logs"
    router_log = []

    class _Keep(logging.Handler):
        def emit(self, record):
            router_log.append(record.getMessage())

    keep = _Keep(level=logging.INFO)
    rlog = logging.getLogger("paddle_tpu_torch.serving.router")
    rlog.addHandler(keep)
    rlog.setLevel(logging.INFO)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), OMP_NUM_THREADS="1")
    reg = MetricsRegistry()
    sup = ReplicaSupervisor(
        [sys.executable, "-m", "paddle_tpu_torch.serving.generation",
         "--device", "cuda", "--port", "0", *FLEET_ARGV], 2, env=env,
        heartbeat_timeout_s=FLEET_HEARTBEAT_S, respawn_backoff_s=0.2,
        telemetry_dir=os.path.join(tmp, "telemetry"), log_dir=str(logs),
        registry=reg)
    router = None
    beats = None
    try:
        t_spawn = time.perf_counter()
        sup.start()
        up = {}
        while len(up) < 2:
            for r in range(2):
                if r not in up and sup.replica_url(r):
                    up[r] = time.perf_counter() - t_spawn
            if time.perf_counter() - t_spawn > 300 or any(
                    p.poll() is not None for p in sup.procs):
                fail(f"[fleet] bring-up: registered {up}, exits "
                     f"{[p.poll() for p in sup.procs]}; logs in {logs}")
            time.sleep(0.01)
        if not sup.wait_ready(60):
            fail("[fleet] the supervisor did not see both replicas up")
        beats = HeartbeatGaps(sup.coord)
        captures = [capture_ms_of(logs / f"replica{r}.0.log")
                    for r in range(2)]
        router = FleetRouter([], coord=sup.coord.address, port=0,
                             page_size=16, probe_interval_s=0.5,
                             dead_after=3, membership_poll_s=0.05,
                             install_signal_handlers=False).start()
        urls = [sup.replica_url(r) for r in range(2)]
        log(f"[fleet] 2 replicas up: spawn to registration "
            f"{[round(up[r], 2) for r in range(2)]} s, capture "
            f"{captures} ms; router {router.url} over {urls}")
        # each replica's tokens for the probes, bitwise the twin's
        for r, url in enumerate(urls):
            got, _, _, _ = fleet_wave(url, probes, [True] * len(probes))
            if got != twin_toks:
                bad = [i for i in range(len(probes)) if got[i] != twin_toks[i]]
                fail(f"[fleet] replica {r}'s tokens differ from the twin's "
                     f"for probes {bad}")
        # affinity: 8 requests on one 64-token prefix
        burst = fleet_prompts(cfg.vocab_size, 80)
        h0 = [prefix_counts(u) for u in urls]
        fleet_wave(router.url, burst[:1], [False])
        fleet_wave(router.url, burst[1:], [i % 2 == 0 for i in range(7)])
        routed = router.metrics.snapshot()["routed"]
        hits = {k: v for k, v in routed.items() if k.endswith("|prefix_hit")}
        if sum(hits.values()) < 7 or len(hits) != 1:
            fail(f"[fleet] affinity burst routed {routed}")
        owner = int(next(iter(hits)).split("|")[0][1:])
        h1 = prefix_counts(urls[owner])
        d_hits, d_miss = (h1[0] - h0[owner][0], h1[1] - h0[owner][1])
        if d_hits < 7 or d_hits + d_miss != 8:
            fail(f"[fleet] the burst's replica r{owner} hit its prefix cache"
                 f" {d_hits} times in 8 (misses {d_miss})")
        log(f"[fleet] affinity: 8 requests on one 64-token prefix routed "
            f"{routed}; r{owner}'s prefix cache hit {d_hits}/8")
        # the wave: through the router, straight to one replica
        streamed = [i % 2 == 0 for i in range(16)]
        before = router.metrics.snapshot()["routed"]

        def pace(k):     # group A's first request bound to r0, then B's
            wait_for(lambda: sum(r.inflight for r in router.replicas) >= k,
                      30, "[fleet] the wave's first requests")

        w_router = fleet_wave(router.url, fleet_prompts(
            cfg.vocab_size, 62, groups=2), streamed, pace=pace)
        after = router.metrics.snapshot()["routed"]
        delta = {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
        if delta != {"r0|least_loaded": 1, "r0|prefix_hit": 7,
                     "r1|least_loaded": 1, "r1|prefix_hit": 7}:
            fail(f"[fleet] the wave's two prefix groups did not land on "
                 f"one replica each: {delta}")
        w_one = fleet_wave(urls[0], fleet_prompts(cfg.vocab_size, 63,
                                                  groups=2), streamed)
        log("[fleet] wave of 16 x " + str(FLEET_NEW) + " (8 SSE, 2 prefix "
            "groups of 8) on " + card + ": "
            + wave_text("router over 2 replicas", 16, *w_router[1:]) + "; "
            + wave_text("one replica over HTTP", 16, *w_one[1:]) + "; "
            + wave_text("the engine in process", 16, *inproc[1:])
            + f"; routed {delta}")
        # the drill
        free0 = torch.cuda.mem_get_info()
        toks, err, stamps, victim = [], None, [], None
        c = ServingClient(router.url, timeout=300)
        for evt in c.generate_stream(drill_prompt, FLEET_NEW):
            if "token" in evt:
                toks.append(evt["token"])
                stamps.append(time.perf_counter())
                if len(toks) == FLEET_KILL_AT:
                    victim = max(router.replicas, key=lambda r: r.inflight)
                    rank = int(victim.name[1:])
                    old_url = victim.url
                    t_kill = time.perf_counter()
                    os.kill(sup.procs[rank].pid, signal.SIGKILL)
            if evt.get("done"):
                err = evt.get("error")
        snap = router.metrics.snapshot()
        if err is not None or len(toks) != FLEET_NEW \
                or snap["requests_failed"] != 0 \
                or snap["failovers"]["mid_stream"] < 1:
            fail(f"[fleet] drill: error {err}, {len(toks)} tokens, {snap}")
        ties = margin_check(torch, torch.tensor([drill_prompt + toks]),
                            ref_seq, oracle_logits, len(drill_prompt),
                            "[fleet] drill (resumed vs undisturbed)")
        # the victim had relayed tokens beyond the 16th before it died: the
        # router's failover line says how many; the stall is the gap from
        # the last of them to the survivor's first
        relayed = [int(m.group(1)) for m in map(re.compile(
            r"stream failover: (\d+) tokens relayed").match, router_log) if m]
        if not relayed or not FLEET_KILL_AT <= relayed[-1] < FLEET_NEW:
            fail(f"[fleet] drill: the router's failover lines {relayed}")
        cut = relayed[-1]
        stall = (stamps[cut] - stamps[cut - 1]) * 1e3
        deadline = time.perf_counter() + 300
        while not (victim.alive and victim.url != old_url
                   and sup.wait_ready(0.05)):
            if time.perf_counter() > deadline:
                fail(f"[fleet] the victim r{rank} was not re-admitted: "
                     f"{victim.snapshot()}")
            time.sleep(0.01)
        readmit_s = time.perf_counter() - t_kill
        free1 = torch.cuda.mem_get_info()
        dumps = list((pathlib.Path(tmp) / "telemetry").glob("flightrec-*"))
        doc = json.loads(dumps[0].read_text()) if dumps else {}
        down_s = doc.get("accounting", {}).get("down_s", 0)
        if doc.get("reason") != "replica_lost" or not down_s > 0:
            fail(f"[fleet] the replica_lost dump: {doc.get('reason')} "
                 f"down_s {down_s}")
        respawn_capture = capture_ms_of(logs / f"replica{rank}.1.log")
        again = ServingClient(victim.url, timeout=300).generate(
            drill_prompt, FLEET_NEW)["tokens"]
        if again != oracle:
            fail(f"[fleet] the respawned r{rank}'s tokens differ from the "
                 "twin's")
        lost = reg.snapshot()["paddle_fleet_replica_lost_total"]
        log(f"[fleet] drill on {card}: SIGKILL r{rank} after token "
            f"{FLEET_KILL_AT} reached the client; the victim had relayed "
            f"{cut}: stream done, {snap['requests_failed']} failed, "
            f"failovers {snap['failovers']}, the client's stall (token {cut}"
            f" to {cut + 1}) {stall:.1f} ms, recovery (the router's loss to "
            f"resumed) {snap['failover_recovery_ms']} ms, tokens = the "
            f"undisturbed run's up to near ties (row, new token) {ties}; "
            f"death to re-admission "
            f"{readmit_s:.2f} s (respawn capture {respawn_capture} ms), "
            f"down_s {down_s}; device free/total before the kill "
            f"{free0[0] / 2 ** 30:.2f}/{free0[1] / 2 ** 30:.2f} GiB, after "
            f"the respawn {free1[0] / 2 ** 30:.2f} GiB; replicas lost "
            f"{lost}")
        # the drain with 2 streams open
        events = {0: [], 1: []}
        drain_prompts = fleet_prompts(cfg.vocab_size, 64, groups=2, n=1)

        def stream(i):
            try:
                for evt in ServingClient(router.url, timeout=300)\
                        .generate_stream(drain_prompts[i], FLEET_NEW):
                    events[i].append(evt)
            except Exception as e:  # noqa: BLE001 - reported below
                events[i].append({"client_error": f"{type(e).__name__}: "
                                                  f"{e}"})

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in events]
        for t in threads:
            t.start()
        wait_for(lambda: all(any("token" in e for e in ev)
                              for ev in events.values()), 120,
                  "[fleet] the drain's streams")
        gaps = beats.stop()
        beats = None
        r_clean = router.shutdown()
        for t in threads:
            t.join(120)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            s_clean = sup.shutdown()
        said = out.getvalue()
        log(said.strip())
        for i, ev in events.items():
            last = ev[-1] if ev else {}
            if not (last.get("done") and "error" not in last
                    and last.get("tokens") == FLEET_NEW):
                fail(f"[fleet] drained stream {i} ended with {last}")
        if not (r_clean and "router drain clean" in router_log
                and s_clean and "fleet drain clean" in said):
            fail(f"[fleet] drains: router {r_clean} {router_log[-3:]}, "
                 f"fleet {s_clean} {said!r}")
        log(f"[fleet] drain with 2 streams open: router drain clean, fleet "
            f"drain clean; heartbeat gaps (s) {gaps} against the timeout "
            f"{FLEET_HEARTBEAT_S} (the library's default 2.0: "
            f"{'exceeded' if any(g > 2.0 for g in gaps.values()) else 'held'})"
            f" | {time.perf_counter() - t_phase:.1f}s")
    finally:
        if beats is not None:
            beats.stop()
        if router is not None:
            router.shutdown()
        with contextlib.redirect_stdout(io.StringIO()):
            sup.shutdown(timeout_s=30)
        for p in sup.procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        rlog.removeHandler(keep)
        flightrec.reset()
        twin.stop()
    return {"counts": path, "launches_a_replay": replay, "shapes": shapes,
            "capture_ms": twin.capture_ms}


def wait_for(cond, timeout, what):
    """Poll ``cond`` every 2 ms; fail after ``timeout`` seconds."""
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            fail(f"{what}: timed out")
        time.sleep(0.002)


def kernel_entry(mangled):
    """A kernel's name and template arguments in its mangled entry name:
    each part of the name is its length in digits, then its characters
    (an anonymous namespace first), and the kernel is the last part."""
    pos, name = (3 if mangled.startswith("_ZN") else 2), None
    while n := re.match(r"\d+", mangled[pos:]):
        start = pos + n.end()
        name, pos = mangled[start:start + int(n.group())], start + int(
            n.group())
    if name is None:
        return mangled
    args = re.match(r"(I\w*?E)?E?v", mangled[pos:])
    return name + ((args.group(1) or "") if args else "")


def device_and_build(torch, build):
    """The card's name and power limit (returned as nvidia-smi prints
    them), then every kernel library built from the checkout's sources,
    its ptxas report (a spill fails the run) and its SASS checked."""
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
                entry = kernel_entry(m.group(1))
            if "registers" in line or "spill" in line:
                if "spill" in line and " 0 bytes spill stores" not in line:
                    spills.append(f"{entry}: {line.strip()}")
                log(f"[build] {name} {entry}: {line.strip()}")
    if spills:
        fail(f"ptxas reports register spills: {spills}")
    sass_phase(paths)
    return card

def front_end_phases(torch, K, card):
    """[predict-serve], then [http-generate] with the predict server still
    serving, then that server's drain.  Returns their records."""
    release(torch, "predict-serve")
    mark("predict-serve")
    predict, predict_srv, probes = predict_serve_phase(torch, K, card)
    release(torch, "http-generate")
    mark("http-generate")
    try:
        generate = http_generate_phase(torch, K, card, predict_srv, probes)
    finally:
        clean = predict_srv.shutdown()
    if not clean:
        fail("[predict-serve] the server's drain was not clean")
    mark("serving front end done")
    return {"predict": predict, "generate": generate}


def front_end_main():
    """``python3 chip_smoke.py --serving-front-end``: the build and the two
    HTTP serving phases alone (a quick check of that path; the full run
    is the script without arguments)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import paddle_tpu_torch.ops.kernels as K
    from paddle_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_and_build(torch, build)
    front_end_phases(torch, K, card)
    log(f"[time] the run took {time.perf_counter() - START:.1f}s")
    return 0


def fleet_main():
    """``python3 chip_smoke.py --fleet``: the build and the [fleet] phase
    alone (the full run is the script without arguments)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch.ops.kernels as K
        from paddle_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_and_build(torch, build)
    mark("fleet")
    fleet_phase(torch, K, card)
    log(f"[time] the run took {time.perf_counter() - START:.1f}s")
    return 0


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
    # the training engine's warm-up must never meet AccumulateGrad nodes
    # of another stream (a dygraph loss kept alive before Model.fit)
    warnings.filterwarnings("error", message=ACCUMULATE_WARNING)

    card = device_and_build(torch, build)

    main_cases = kernel_phase(torch, K)
    main_cases.update(backward_kernel_phase(torch, K))
    main_cases.update(xent_kernel_phase(torch, K))
    bert_attention = masked_attention_phase(torch, K)
    unaligned_phase(torch, K)
    dropout_mask_phase(torch, K)
    dropout_attention = dropout_kernel_phase(torch, K)

    cfg = GPTConfig(dropout=0.0, attn_dropout=0.0)
    main_cases["multi_tensor_step"] = optimizer_phase(torch, K, cfg)
    release(torch, "GPT serving")
    seed(0)
    model = GPTForCausalLM(cfg, device="cuda")
    model.eval()
    model_cpu = GPTForCausalLM(cfg, device="cpu")
    load_numpy_state(model_cpu, {k: v.cpu().numpy()
                                 for k, v in model.state_dict().items()})
    model_cpu.eval()
    logits_phase(torch, model, model_cpu)
    del model_cpu
    f32_prefix_chunk_phase(torch, model, card)
    release(torch, "GPT bf16 serving")

    model.to(dtype=torch.bfloat16)
    serve_counts = serving_phase(torch, K, model, card)
    serving_graph_phase(torch, model, card)
    prefix_phase(torch, model, card)
    torch.cuda.synchronize()
    del model
    release(torch, "GPT training")

    train_parity_phase(torch, K, cfg)
    train_counts, gpt_step = train_phase(torch, K, cfg, card)
    gpt_labels_phase(torch, K, cfg)
    torch.cuda.synchronize()
    release(torch, "BERT")

    bert_parity_phase(torch, K)
    release(torch, "BERT training")
    bert_counts, bert_step = bert_train_phase(torch, K, card)
    torch.cuda.synchronize()
    dropout_counts = dropout_train_phase(
        torch, K, card, {"gpt": gpt_step, "bert": bert_step})
    torch.cuda.synchronize()
    graph_counts = train_graph_phase(torch, K, card)
    torch.cuda.synchronize()
    release(torch, "fit-f32")
    mark("fit-f32")
    fit_f32_phase(torch, K, card)
    torch.cuda.synchronize()
    release(torch, "fit-api")
    fit_api_counts, eval_launches = fit_api_phase(torch, K, card)
    torch.cuda.synchronize()
    release(torch, "seq2seq")
    s2s_cross, s2s_rows, s2s_cross_steps, s2s_counts, s2s_traced = \
        seq2seq_phase(torch, K, card)
    torch.cuda.synchronize()
    release(torch, "amp-kernels")
    mark("amp-kernels")
    amp_recs = amp_kernel_phase(torch, K)
    unscale_rec = amp_unscale_phase(torch, K)
    release(torch, "ernie-o2")
    mark("ernie-o2")
    ernie_counts, ernie_traced, ernie_step = ernie_o2_phase(torch, K, card)
    torch.cuda.synchronize()
    release(torch, "fit-amp")
    mark("fit-amp")
    fit_amp_counts, fit_amp_traced, fit_amp_step = fit_amp_phase(torch, K,
                                                                 card)
    torch.cuda.synchronize()
    release(torch, "paged-f16")
    mark("paged-f16")
    paged_f16 = paged_f16_phase(torch, K)
    vision_xent = vision_xent_phase(torch, K)
    release(torch, "fp16-serve")
    mark("fp16-serve")
    fp16_serve = fp16_serve_phase(torch, K, card)
    release(torch, "lenet")
    mark("lenet")
    lenet_counts, lenet_rec = lenet_phase(torch, K, card)
    release(torch, "resnet50")
    mark("resnet50")
    r50_counts, r50_rec = resnet50_phase(torch, K, card)
    torch.cuda.synchronize()
    release(torch, "optimizers")
    mark("optimizers")
    rule_recs = optimizers_phase(torch, K, card)
    release(torch, "wrappers")
    mark("wrappers")
    wrapper_recs = wrappers_phase(torch, K, card)
    release(torch, "bert-lamb-accum")
    mark("bert-lamb-accum")
    accum_counts, accum_rec = bert_lamb_accum_phase(torch, K, card)
    release(torch, "resnet50-lars")
    mark("resnet50-lars")
    lars_counts, lars_rec = resnet50_lars_phase(torch, K, card)
    torch.cuda.synchronize()
    release(torch, "resume")
    mark("resume")
    resume_counts = resume_phase(torch, K, card)
    release(torch, "io")
    mark("io")
    io_counts, io_rec = io_phase(torch, K, card)
    torch.cuda.synchronize()
    release(torch, "flops")
    mark("flops")
    flops_phase(torch, card)
    release(torch, "generate")
    mark("generate")
    gen_counts, gen_rec = generate_phase(torch, K, card)
    release(torch, "spec")
    mark("spec")
    spec_counts, spec_shapes = spec_phase(torch, K, card)
    serving = front_end_phases(torch, K, card)
    release(torch, "fleet")
    mark("fleet")
    fleet = fleet_phase(torch, K, card)
    mark("fleet done")

    kernels = []
    for name, rec in main_cases.items():
        source, replaces = REPLACES[name]
        # each kernel's launches on its own path: serving for the forward
        # kernels of slice 1, the 10 GPT training steps for the backward
        # ones and the optimizer's, the 10 BERT training steps for the
        # cross-entropy kernels
        counts = serve_counts if name in SERVING_KERNELS else (
            bert_counts if name in XENT_KERNELS else train_counts)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
        if name in TRAINING_KERNELS or name in XENT_KERNELS \
                or name == "multi_tensor_step":
            # launches a step of Model.fit's replayed step at the default
            # configs, read from the trace of 2 replays
            entry["train_graph_launches_a_step"] = {
                model: c[name] for model, c in graph_counts.items()
                if name in c}
        if name in fit_api_counts and name in BERT_KERNELS + (
                "multi_tensor_step",):
            # the [fit-api] path: launches in its fit (the train step's
            # warm-up and capture, the eval step's first batch and
            # capture), and a replay of its eval graph
            entry["fit_api_launches"] = fit_api_counts[name]
            entry["eval_graph_launches_a_batch"] = eval_launches.get(name, 0)
        if name in BERT_KERNELS + ("multi_tensor_step",):
            # the [resume] path: launches in the resumed run's fit (its
            # first step and the capture)
            entry["resume_launches"] = resume_counts[name]
        if name in XENT_KERNELS + ("multi_tensor_step",):
            # the [io] path (ResNet-50 fit with worker processes): launches
            # in its fit (the first step and the capture), and a step of
            # its replays in the trace
            entry["io_launches"] = io_counts[name]
            entry["io_traced_launches_a_step"] = io_rec["traced_a_step"][name]
        if name in S2S_KERNELS + ("multi_tensor_step",):
            # the seq2seq path (Transformer-base Model.fit): launches in
            # its first graph run's fit (the first step and the capture),
            # and a step of its replays in the trace
            entry["seq2seq_launches"] = s2s_counts[name]
            entry["seq2seq_launches_a_step"] = s2s_traced.get(name, 0)
        if name in s2s_rows:
            # held against its plain version at the seq2seq path's shape
            # (LayerNorm: the encoder's rows, the decoder's beside them)
            keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err")
            entry["seq2seq_shape"] = {k: s2s_rows[name][k] for k in keys}
            if name == "layer_norm":
                entry["seq2seq_shape"]["decoder_rows"] = {
                    k: s2s_rows["layer_norm_decoder"][k] for k in keys}
        for form, (counts_of, traced_of, step_of, tag, path) in (
                ("float16", (ernie_counts, ernie_traced, ernie_step, "f16",
                             "ernie-o2")),
                ("mixed", (fit_amp_counts, fit_amp_traced, fit_amp_step,
                           "mixed", "fit-amp"))):
            if form in amp_recs.get(name, {}):
                # the AMP paths' forms at their shapes, beside the bf16
                # kernel at the same shape: the wrapper's launches on the
                # path (path A's steps; path B's warm-up and capture, every
                # form), a step of its trace, and of this form in the trace
                r = amp_recs[name][form]
                entry[form] = {
                    "path": path, "launches": counts_of[name],
                    "traced_launches_a_step": traced_of.get(name, 0),
                    "form_launches_a_step": step_of["forms_a_step"].get(
                        f"{name} {tag}"),
                    **{k: r[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "bf16_ms") if k in r},
                    **({"nsp": r["nsp"]} if "nsp" in r else {})}
        if name == "paged_decode_attention":
            # the float16 form at the serving table's shape,
            # beside the bf16 kernel there, with its launches in the
            # float16 serving wave (its trace)
            # launches: the wrapper's eager count plus a replay's
            # launches times the replays; traced_launches: the trace's
            entry["float16"] = {
                "path": "fp16-serve", "launches": fp16_serve["launches"],
                "traced_launches": fp16_serve["traced_launches"],
                "graph_launches_a_replay":
                    fp16_serve["graph_launches_a_replay"],
                **{k: paged_f16[k] for k in (
                    "max_abs_err", "ms", "bf16_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}}
        if name in XENT_KERNELS:
            # the vision paths' shapes: the wrappers' launches
            # on each path (ResNet-50's dygraph loop; LeNet's fit, at its
            # warm-ups and captures) and a replayed step's in the trace
            at = XENT_KERNELS.index(name)
            for path, path_counts, path_rec in (
                    ("resnet50", r50_counts, r50_rec),
                    ("lenet", lenet_counts, lenet_rec)):
                r = vision_xent[path][at]
                entry[path] = {
                    "launches": path_counts[name],
                    "traced_launches_a_step":
                        path_rec["traced_a_step"][name],
                    **{k: r[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")}}
        if name == "multi_tensor_step":
            # the vision paths' rules at their own trees (ResNet-50's
            # Momentum over bf16, LeNet's Adam over float32): launches as
            # for the cross-entropy kernels
            for path, path_counts, path_rec in (
                    ("resnet50", r50_counts, r50_rec),
                    ("lenet", lenet_counts, lenet_rec)):
                r = path_rec["optimizer"]
                entry[path] = {
                    "launches": path_counts[name],
                    "traced_launches_a_step":
                        path_rec["traced_a_step"][name],
                    "rule": r["kind"], "tensors": r["tensors"],
                    "elements": r["elements"],
                    **{k: r[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "chunk", "blocks")
                        if k in r}}
        if name == "multi_tensor_step":
            # the elementwise rules this kernel gained last, each over
            # BERT-base's bf16 tree: bitwise the loop, timed
            entry["rules"] = {
                rule: {k: r[k] for k in (
                    "kind", "launches", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms")}
                for rule, r in rule_recs.items() if rule not in NORM_RULES}
        if name in GEN_KERNELS:
            # the generate path: launches the wrappers counted in its
            # greedy key's first call (the prefill, the warm-up step and
            # the capture), a replayed call's in the trace, and
            # the kernel held against its plain version at the path's shape
            # (LayerNorm and bias-GeLU at a decode step's rows, attention at
            # the prefill's)
            entry["generate_launches"] = gen_counts[name]
            entry["generate_traced_launches_a_call"] = \
                gen_rec["traced_a_call"][name]
            entry["generate_shape"] = {k: gen_rec["shapes"][name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")}
        if name in SPEC_KERNELS:
            # the speculative path: the wrappers' eager launches on its
            # bf16 graph wave plus a replay's launches times its replays,
            # and the kernel held against its plain version at the path's
            # shape (LayerNorm and bias-GeLU at the verify's rows, paged
            # decode at the draft pool's geometry)
            entry["spec_launches"] = spec_counts[name]
            entry["spec_shape"] = {k: spec_shapes[name][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")}
        if name in PREDICT_KERNELS:
            # the /predict path (BERT-base float32 through Model.serve):
            # the wrappers' launches in serve()'s warm-up and captures plus
            # each bucket's launches a replay times its replays, a replay
            # of the 8 x 128 bucket, and the kernel held against its plain
            # version at the smallest and largest buckets' shapes
            ps = serving["predict"]
            entry["predict_serve"] = {
                "launches": ps["counts"][name],
                "launches_a_replay_8x128":
                    ps["launches_a_replay_8x128"].get(name, 0),
                "shapes": {tag: {k: r[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err", "bound_simt_ms") if k in r}
                    for tag, r in ps["shapes"][name].items()}}
        if name in HTTP_KERNELS:
            # the /generate path (GPT-2-small bf16 through serve_generate):
            # eager prefills and the capture plus the decode graph's
            # launches times its replays
            entry["http_generate_launches"] = \
                serving["generate"]["counts"][name]
        if name in SERVING_KERNELS:
            # the fleet path (float32 GPT-2-small replicas): the in-process
            # twin's eager prefills and capture plus its decode graph's
            # launches times its replays, a replay's launches, and the
            # kernel held against its plain version at the replica's shapes
            entry["fleet"] = {
                "launches": fleet["counts"][name],
                "launches_a_replay": fleet["launches_a_replay"].get(name, 0),
                "shapes": {tag: {k: r[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err", "bound_simt_ms") if k in r}
                    for tag, r in fleet["shapes"][name].items()}}
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
                              "causal+additive", "dropout", "cross"]
            entry["bert_padding_mask"] = {
                "launches": bert_counts[name], "ms": b["ms"],
                "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": b["library_ms"],
                "max_abs_err": b["max_abs_err"]}
            # the dropout form (p = 0.1) at both shapes, beside the same
            # kernel at p = 0, with its launches in the default-config
            # training steps
            entry["dropout"] = {"p": DROPOUT_P, **{
                form: {"launches": dropout_counts[model][name],
                       **{key: d[key] for key in (
                           "ms", "ms_p0", "plain_ms", "bound_ms", "bound_by",
                           "library_ms", "max_abs_err")}}
                for (form, d), model in zip(
                    dropout_attention[name].items(), ("gpt", "bert"))}}
            # the cross form (S_q != S_k) at the seq2seq path's shape, in
            # its training form (bf16, padding mask, dropout 0.1), with
            # its launches a step (one a decoder layer)
            c = s2s_cross[name]
            entry["seq2seq_cross"] = {
                "shape": f"B={S2S_B} H={S2S['nhead']} S_q={S2S_TGT} "
                         f"S_k={S2S_SRC} D=64 bf16 padding p={DROPOUT_P}",
                "launches_a_step": s2s_cross_steps[name],
                **{key: c[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err")}}
        kernels.append(entry)
    # the loss scaler's unscale (beyond the pallas_call set): path A's
    # launches, once a step
    source, replaces = REPLACES["check_finite_and_unscale"]
    kernels.append({
        "name": "check_finite_and_unscale", "route": "cuda",
        "source": source, "replaces": replaces,
        "launches": ernie_counts["check_finite_and_unscale"],
        **{k: unscale_rec[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "tensors", "elements")},
        "traced_launches_a_step": ernie_traced.get(
            "check_finite_and_unscale", 0),
        "paths": {"ernie-o2": ernie_step, "fit-amp": fit_amp_step}})
    # Kernel B, the norm rules: its main numbers are Lamb's over
    # BERT-base's bf16 tree; launches are [bert-lamb-accum]'s (the
    # wrappers count its warm-up and capture; a replay's in the trace)
    source, replaces = REPLACES["multi_tensor_norm_step"]
    lamb = rule_recs["lamb"]
    kernels.append({
        "name": "multi_tensor_norm_step", "route": "cuda",
        "source": source, "replaces": replaces,
        "launches": accum_counts["multi_tensor_norm_step"],
        **{k: lamb[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        "rule": "lamb", "tensors": lamb["tensors"],
        "elements": lamb["elements"],
        "floor_ms": lamb["breakdown"]["floor_ms"],
        "rules": {rule: {k: rule_recs[rule][k] for k in (
            "kind", "launches", "max_abs_err", "steps_vs_loop", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "breakdown")}
            for rule in NORM_RULES},
        "dpsgd_noise": rule_recs["dpsgd"]["noise"],
        "paths": {
            "bert-lamb-accum": {
                "launches_a_replay": accum_rec["launches_a_replay"][
                    "multi_tensor_norm_step"],
                "traced_launches_a_step": accum_rec["traced_a_step"].get(
                    "multi_tensor_norm_step", 0),
                **{k: accum_rec[k] for k in ("p50_ms", "samples_s", "mfu",
                                             "busy_share", "peak_gib",
                                             "kernel_b")}},
            "resnet50-lars": {
                "launches": lars_counts["multi_tensor_norm_step"],
                "launches_a_replay": lars_rec["launches_a_replay"][
                    "multi_tensor_norm_step"],
                "traced_launches_a_step": lars_rec["traced_a_step"].get(
                    "multi_tensor_norm_step", 0),
                **{k: lars_rec[k] for k in ("p50_ms", "device_ms",
                                            "samples_s", "optimizer_ms",
                                            "tree_check")}}},
        "wrappers": wrapper_recs})
    log(f"[time] the run took {time.perf_counter() - START:.1f}s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-child"]:
        sys.exit(resume_child(sys.argv[2]))
    if sys.argv[1:2] == ["--serving-front-end"]:
        sys.exit(front_end_main())
    if sys.argv[1:2] == ["--fleet"]:
        sys.exit(fleet_main())
    if sys.argv[1:2] == ["--optimizers"]:
        sys.exit(optimizers_main())
    sys.exit(main())
