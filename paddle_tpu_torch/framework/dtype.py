"""Dtype names (port of paddle_tpu/framework/dtype.py).

The reference's dtypes are jnp dtypes; the port's are torch dtypes, found
by the same Paddle names (``"float16"``, ``"bfloat16"``, ``"float32"``,
...).  :func:`convert_dtype` takes a name, a torch dtype or a numpy
dtype and gives the torch dtype.
"""
from __future__ import annotations

import numpy as np
import torch

# Canonical name -> torch dtype
_DTYPE_MAP = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "bool": torch.bool,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_FLOAT_DTYPES = {float16, bfloat16, float32, float64}
_NAMES = {v: k for k, v in _DTYPE_MAP.items()}

_default_dtype = float32


def convert_dtype(dtype):
    """A name, torch dtype or numpy dtype as a torch dtype (None stays
    None); an unknown name raises ``ValueError``."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _DTYPE_MAP:
            raise ValueError(f"Unknown dtype {dtype!r}")
        return _DTYPE_MAP[dtype]
    name = np.dtype(dtype).name
    if name not in _DTYPE_MAP:
        raise ValueError(f"Unknown dtype {dtype!r}")
    return _DTYPE_MAP[name]


def dtype_name(dtype) -> str:
    return _NAMES[convert_dtype(dtype)]


def is_floating(dtype) -> bool:
    return convert_dtype(dtype) in _FLOAT_DTYPES


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not d.is_floating_point and not d.is_complex and d != torch.bool


def set_default_dtype(d):
    global _default_dtype
    d = convert_dtype(d)
    if d not in _FLOAT_DTYPES:
        raise TypeError(f"set_default_dtype only accepts float dtypes, got {d}")
    _default_dtype = d


def get_default_dtype():
    return _default_dtype
