"""Run chip_smoke.py's [resume] phase N times on one checkout and print
which runs passed: a check of that phase's bitwise comparisons on the
card, run after one of them failed once.

    python3 tools/chip_resume_repeat.py CHECKOUT N

CHECKOUT is the root of a checkout (this one, or another commit's unpacked
with `git archive`); the kernels are built there first."""
import os
import sys

root, n = os.path.abspath(sys.argv[1]), int(sys.argv[2])
os.chdir(root)
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import paddle_tpu_torch.ops.kernels as K  # noqa: E402
from paddle_tpu_torch.ops.kernels import build  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all()
results = []
for i in range(n):
    try:
        cs.resume_phase(torch, K, "card")
        results.append("pass")
    except SystemExit as e:
        results.append(f"fail({e.code})")
    cs.release(torch, f"loop {i}")
print("RESULTS", root, results, flush=True)
