"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The module layout mirrors ``paddle_tpu`` so each module's counterpart is
found by path: ``paddle_tpu/serving/generation.py`` ports to
``paddle_tpu_torch/serving/generation.py`` and so on.  Plain tensor code
is PyTorch; every Pallas TPU kernel on a ported path is a hand-written
CUDA C++ kernel for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at
first use and bound through ``ctypes`` (``ops/kernels``).

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
``RuntimeError`` where CUDA is absent.  Pass ``device="cpu"`` to run the
kernels' plain PyTorch versions instead (the tests do).
"""
from . import (amp, io, metric, nn, optimizer, regularizer,  # noqa: F401
               tensor_ops, vision)
from .framework.io_state import load, save  # noqa: F401
from .framework.place import default_device  # noqa: F401
from .framework.random import seed  # noqa: F401
from .hapi import Model, callbacks, flops, summary  # noqa: F401
from .nn.layer_base import ParamAttr  # noqa: F401

__version__ = "0.1.0"
