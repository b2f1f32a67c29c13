"""Where a profiler trace of replayed CUDA graphs loses kernel records.

    python3 tools/trace_edge_probe.py wave [N]       # on a CUDA card
    python3 tools/trace_edge_probe.py generate [N]

``wave``: the float16 GPT-2-small serving wave of chip_smoke.py's
``[fp16-serve]`` (16 greedy requests of 20-128 prompt tokens, 32 new each,
through the engine's decode graph; 12 paged decode launches a replay).
``generate``: one bf16 GPT-2-small ``generate`` call of chip_smoke.py's
``[generate]`` (B = 8, S = 128, 128 new tokens: an eager prefill, then
127 replays of the decode graph; 25 LayerNorm launches each).  Each is
traced N times (default 30) under torch.profiler, alternating plain
windows and windows that keep the card idle ``chip_smoke.TRACE_EDGE_S`` at
both edges (as ``chip_smoke.trace_window`` does).  Each window prints one
JSON line: the replays made, the launches of the probed kernel they
imply, those that ``key_averages()`` and the exported chrome trace hold,
and the replays the trace holds fewer of (by ``cudaGraphLaunch``
correlation: the replay's index among the window's replays, what it
holds).  The last line counts, by form, the windows that lost a launch.
"""
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.framework.random import seed  # noqa: E402
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM  # noqa: E402
from paddle_tpu_torch.ops.kernels import build  # noqa: E402
from paddle_tpu_torch.serving import GenerationEngine  # noqa: E402


def window(work, idle_edges, kernel):
    """Trace ``work()`` (which returns the replays it made): (replays,
    ``kernel``'s launches in key_averages, {graph launch correlation:
    its launches} in launch order, its launches outside graphs)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if idle_edges:
            time.sleep(cs.TRACE_EDGE_S)
        replays = work()
        torch.cuda.synchronize()
        if idle_edges:
            time.sleep(cs.TRACE_EDGE_S)
    averaged = sum(e.count for e in prof.key_averages()
                   if kernel in e.key and e.self_device_time_total > 0)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("name") == "cudaGraphLaunch")
    per = dict.fromkeys((c for _, c in launches), 0)
    eager = 0
    for e in events:
        if e.get("cat") == "kernel" and kernel in e.get("name", ""):
            c = e["args"].get("correlation")
            if c in per:
                per[c] += 1
            else:
                eager += 1
    return replays, averaged, per, eager


def wave_work():
    cfg = GPTConfig(dropout=0.0, attn_dropout=0.0)
    seed(0)
    model = GPTForCausalLM(cfg, device="cuda")
    model.astype("float16")
    model.eval()
    prompts = cs.wave_prompts(cfg.vocab_size, 44)
    eng = GenerationEngine(model, device=model.device,
                           **cs.SERVING_ENGINE).start()

    def work():
        r0 = eng.replays
        cs.serve_wave(eng, prompts, cs.FP16_NEW, sampled=False)
        cs.wait_idle(eng)
        return eng.replays - r0

    work()
    return work, eng.stop, "paged_decode_split_kernel", 12, 0


def generate_work():
    g = cs.GEN_BF16
    cfg = GPTConfig(dropout=0.0, attn_dropout=0.0)
    seed(0)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16).eval()
    ids = cs.gen_prompts(torch, cfg, 51, g["B"], g["S"], "cuda")
    model.generate(ids, max_new_tokens=g["new"])

    def work():
        model.generate(ids, max_new_tokens=g["new"])
        return g["new"] - 1

    return work, lambda: None, "layer_norm_warp_kernel", 25, 25


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "wave"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    build.build_all()
    work, stop, kernel, a_replay, outside = {
        "wave": wave_work, "generate": generate_work}[mode]()
    lost = {"plain": 0, "idle edges": 0}
    try:
        for i in range(n):
            form = "idle edges" if i % 2 else "plain"
            replays, averaged, per, eager = window(work, i % 2 == 1, kernel)
            order = list(per)
            short = [(order.index(c), len(order), k) for c, k in per.items()
                     if k != a_replay]
            want = a_replay * replays + outside
            if averaged != want:
                lost[form] += 1
            print(json.dumps({"window": i, "form": form, "kernel": kernel,
                              "replays": replays, "want": want,
                              "key_averages": averaged,
                              "chrome_trace": sum(per.values()) + eager,
                              "outside graphs": eager,
                              "short replays (index, of, held)": short}),
                  flush=True)
    finally:
        stop()
    print(json.dumps({"mode": mode, "windows": n,
                      "windows that lost a launch": lost}))


if __name__ == "__main__":
    main()
