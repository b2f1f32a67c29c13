"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, at first
use, into ``build/paddle_tpu_torch/`` at the root of the checkout (listed
in ``.gitignore``).  All missing libraries are compiled at once, one
``nvcc`` process per source, started together.  A library's file name
carries a hash of its source and of every shared header (``csrc/*.cuh``),
so an edited source or header rebuilds and a stale library is never
loaded.  Libraries are loaded with
``ctypes``; each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``, which :func:`check` turns into an
exception.

Nothing here runs at import time: this module is imported on hosts
without ``nvcc`` (the CPU tests), where the kernels are never launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCES = ("layer_norm", "bias_gelu", "flash_attention",
           "flash_attention_bwd", "paged_attention", "softmax_xent")

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}
last_build_seconds = 0.0     # wall time of the last build_all() that compiled


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built at first use and need the CUDA toolkit")
    return path


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where library ``name`` is built: the file name carries a hash of
    ``<name>.cu`` and of every header (``*.cuh``) beside it, so an edit to
    any of them builds a new library."""
    h = hashlib.sha1()
    for p in (csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel.
    Returns {name: library path}.  Raises RuntimeError with nvcc's output
    when a build fails.  The ptxas report (registers, shared memory,
    spills) of each build is kept beside its library as ``.log``."""
    global last_build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in SOURCES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        paths[name].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (rc={proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    last_build_seconds = time.perf_counter() - t0
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib


def bind(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """A C entry point of library ``name`` with its argtypes declared and
    an int (cudaError_t) result, or ``restype``; bound once, then
    cached."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[symbol] = fn
    return fn


def variant_counts(counters, variants):
    """{kernel: {variant: launches}} as the C entries that choose between
    two kernels counted them since the libraries were loaded.
    ``counters``: kernel name -> (library, counting symbol, which takes the
    variant's index); ``variants``: the names of index 0 and 1."""
    out = {}
    for name, (lib, symbol) in counters.items():
        fn = getattr(library(lib), symbol)
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
        out[name] = {v: fn(i) for i, v in enumerate(variants)}
    return out


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def strides(*tensors):
    """The (b, s, h) element strides of each [B, S, H, D] tensor, as one
    host array of long longs for a kernel entry that takes them."""
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def dtype_code(t) -> int:
    """0 float32, 1 bfloat16 (the kernels' two input types)."""
    import torch

    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"CUDA kernels take float32 or bfloat16, got {t.dtype}")
