"""paddle.save / paddle.load (port of paddle_tpu/framework/io_state.py).

The reference's file format: a pickle of the object in which every tensor
is a numpy array; nested dicts, lists and tuples keep their structure.
Files written by either package load in the other.

A bfloat16 tensor is written as a float32 array, which holds every
bfloat16 value exactly: numpy has no bfloat16 of its own, and the
reference's ``set_value`` (and the port's ``Layer.set_state_dict``) casts
a loaded array to the parameter's dtype.  The reference pickles its
bfloat16 arrays as ``ml_dtypes.bfloat16`` arrays, so loading such a file
needs the ``ml_dtypes`` package; where it is missing, :func:`load` raises
an ``ImportError`` that says so.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]


def _to_storable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        # a copy that owns its bytes: the tensor may be updated in place
        return t.cpu().numpy().copy()
    if isinstance(obj, dict):
        return {k: _to_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_storable(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_storable(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        try:
            return pickle.load(f)
        except ImportError as e:
            if "ml_dtypes" not in str(e):
                raise
            raise ImportError(
                f"{path} holds bfloat16 arrays pickled by the JAX package as "
                "ml_dtypes.bfloat16, and the ml_dtypes package is not "
                "installed here; install it, or save the file from this "
                f"package, which writes bfloat16 as float32 ({e})") from e


def as_array(value) -> np.ndarray:
    """A loaded value (numpy array, tensor or array-like) as a numpy array
    whose floats numpy can compute with: bfloat16 (an ``ml_dtypes`` array
    or a tensor) becomes float32, exactly."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    a = np.asarray(value)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a
