"""paddle_tpu_torch.inference — the ``Predictor`` surface that serving uses
(port of ``Predictor.from_layer``, ``run``, ``warm``, ``compile_count``,
the name lists and the handles of paddle_tpu/inference/__init__.py).

The reference AOT-compiles one XLA executable per input signature (a
"bucket").  Here, on a CUDA card, each input signature is ONE CUDA graph,
captured through ``ops/capture.py`` ``capture`` with the layer in eval
mode under ``no_grad``:

* the graph reads a static device input buffer, which ``run`` fills with
  ONE host-to-device copy a call from pinned memory (every input of the
  signature packed into one byte buffer, each on a 16-byte boundary);
* the graph writes its outputs into one static packed byte buffer, which
  ``run`` fetches to the host in ONE device-to-host copy into a fresh host
  buffer, whose numpy views it returns (the next replay overwrites the
  static buffer, never them);
* the replays run on the predictor's own stream, so a predictor serving
  from one thread and a generation engine decoding on another do not
  serialise on the default stream.

A capture that fails raises: there is no per-call fallback (the reference
swallows a failed compile and dispatches per call).  On the CPU, ``run``
calls the layer eagerly and fetches its outputs the same way; dispatch
depends only on the device of the layer's parameters.

``compile_count`` keeps the reference's name; on the card it counts
bucket captures.  ``graph_launches`` holds each bucket's kernel launches
a replay (``Captured.launches``), ``capture_ms`` each capture's wall time
and ``replays`` each bucket's replays.

``Config`` / ``create_predictor`` of an export prefix (the StableHLO or
pickled ``jit.save`` artifact) need ``jit/`` and the export format, which
are not ported yet (ROADMAP.md A11): they raise ``NotImplementedError``.
"""
from __future__ import annotations

import re
import threading
import time

import numpy as np
import torch

__all__ = ["Config", "Predictor", "create_predictor"]

_EXPORT_TODO = ("loading an exported inference model needs the port's "
                "jit/ and export format (ROADMAP.md A11); serve an "
                "in-memory layer with Predictor.from_layer(layer)")
_ALIGN = 16   # byte boundary of each tensor in a packed buffer


def _natural_key(name):
    """Sort key splitting digit runs so x2 < x10 (AnalysisPredictor binds
    feeds by declaration order; numeric-suffix names must follow it)."""
    return [int(p) if p.isdigit() else p
            for p in re.split(r"(\d+)", str(name))]


class Config:
    """AnalysisConfig of an export prefix: not ported yet (A11)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_EXPORT_TODO)


def create_predictor(config):
    raise NotImplementedError(_EXPORT_TODO)


class _Handle:
    """ZeroCopy input/output handle (api/details/zero_copy_tensor.cc)."""

    def __init__(self, name):
        self.name = name
        self._value = None

    def reshape(self, shape):
        pass  # shapes come from the bound array

    def copy_from_cpu(self, arr):
        self._value = np.ascontiguousarray(arr)

    def copy_to_cpu(self):
        return np.asarray(self._value)

    def share_external_data(self, arr):
        self._value = arr


def _layout(shapes_dtypes):
    """(byte offsets, total bytes) of tensors packed one after another,
    each on an _ALIGN boundary."""
    offs, off = [], 0
    for shape, itemsize in shapes_dtypes:
        offs.append(off)
        n = int(np.prod(shape, dtype=np.int64)) * itemsize
        off += -(-n // _ALIGN) * _ALIGN
    return offs, max(off, _ALIGN)


def _pack(outs):
    """The outputs as one uint8 tensor (each on an _ALIGN boundary) and
    their (shape, dtype) list."""
    meta = [(tuple(o.shape), o.dtype) for o in outs]
    offs, total = _layout([(s, torch.empty((), dtype=d).element_size())
                           for s, d in meta])
    parts, at = [], 0
    for o, off in zip(outs, offs):
        if off > at:
            parts.append(torch.zeros(off - at, dtype=torch.uint8,
                                     device=o.device))
        b = o.detach().contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        at = off + b.numel()
    if total > at:
        parts.append(torch.zeros(total - at, dtype=torch.uint8,
                                 device=outs[0].device))
    return torch.cat(parts), meta


def _unpack(host, meta):
    """numpy arrays of the outputs packed in the host uint8 tensor
    ``host`` (views of it, a fresh tensor per fetch); bfloat16, which
    numpy lacks, comes back as float32."""
    offs, _ = _layout([(s, torch.empty((), dtype=d).element_size())
                       for s, d in meta])
    outs = []
    for (shape, dt), off in zip(meta, offs):
        n = int(np.prod(shape, dtype=np.int64)) \
            * torch.empty((), dtype=dt).element_size()
        t = host[off:off + n].view(dt).reshape(shape)
        outs.append(t.float().numpy() if dt == torch.bfloat16
                    else t.numpy())
    return outs


def _fetch(packed):
    # the call's one device-to-host copy (copy=True: one aten._to_copy on
    # every device; on the CPU .cpu() would return the tensor itself)
    return packed.to("cpu", copy=True)


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


class _Bucket:
    """One input signature's CUDA graph: the packed static input and
    output buffers, the pinned staging buffer and the graph."""

    def __init__(self, layer, key, device):
        from ..ops.capture import capture, side_stream

        np_dtypes = [np.dtype(dt) for _, dt in key]
        self.in_offs, total = _layout([(s, d.itemsize) for (s, _), d
                                       in zip(key, np_dtypes)])
        self.host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        self.host_np = self.host.numpy()
        self.dev = torch.zeros(total, dtype=torch.uint8, device=device)
        self.inputs = []
        for (shape, _), d, off in zip(key, np_dtypes, self.in_offs):
            dt = torch.from_numpy(np.zeros(0, d)).dtype
            n = int(np.prod(shape, dtype=np.int64)) * d.itemsize
            self.inputs.append(self.dev[off:off + n].view(dt).view(shape))

        def body():
            return _pack(_as_tuple(layer(*self.inputs)))

        t0 = time.perf_counter()
        cap = capture(body, warm_up=lambda: side_stream(body, device))
        torch.cuda.synchronize(device)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph = cap.graph
        self.packed, self.meta = cap.out
        self.launches = cap.launches
        self.replays = 0

    def run(self, arrays):
        for a, off in zip(arrays, self.in_offs):
            dst = self.host_np[off:off + a.nbytes].view(a.dtype)
            dst.reshape(a.shape)[...] = a
        # the call's one host-to-device copy, from pinned memory
        self.dev.copy_(self.host, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        return _unpack(_fetch(self.packed), self.meta)


class Predictor:
    """AnalysisPredictor parity: named handles + Run loop, over an
    in-memory layer (``from_layer``), with one CUDA graph per input
    signature on the card (see the module docstring)."""

    def __init__(self, config):
        raise NotImplementedError(_EXPORT_TODO)

    @classmethod
    def from_layer(cls, layer):
        """Serve an in-memory Layer through the Predictor surface: on the
        card its forward is captured once a bucket (input signature) and
        replayed; on the CPU it runs eagerly."""
        self = cls.__new__(cls)
        self.config = None
        self._layer = layer.eval()
        tensors = list(layer.parameters()) + list(layer.buffers())
        self.device = tensors[0].device if tensors else torch.device("cpu")
        self._buckets: dict = {}
        self.compile_count = 0
        self.graph_launches: dict = {}
        self.capture_ms: dict = {}
        self._input_specs = None
        self._input_names = None  # discovered at first run
        self._output_names = None
        self._lock = threading.Lock()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        return self

    @property
    def replays(self) -> dict:
        return {k: b.replays for k, b in self._buckets.items()}

    # -- bucket-aware graph cache ------------------------------------------
    @staticmethod
    def _bucket_key(arrays):
        return tuple((tuple(int(d) for d in a.shape),
                      str(np.dtype(a.dtype))) for a in arrays)

    def _get_bucket(self, arrays):
        """The CUDA graph of this exact input signature, captured on first
        sight.  A capture that fails raises."""
        key = self._bucket_key(arrays)
        b = self._buckets.get(key)
        if b is None:
            with torch.no_grad():
                b = _Bucket(self._layer, key, self.device)
            self._buckets[key] = b
            self.compile_count += 1
            self.graph_launches[key] = b.launches
            self.capture_ms[key] = b.capture_ms
        return b

    def warm(self, shapes, dtypes=None):
        """Capture the bucket for ``shapes`` (one shape tuple per input,
        batch dim included) ahead of traffic (on the CPU: run it once).
        Returns True when the bucket is servable without a capture."""
        if dtypes is None:
            dtypes = [s["dtype"] for s in (self._input_specs or [])] \
                or ["float32"] * len(shapes)
        arrays = [np.zeros(tuple(shape), np.dtype(dt))
                  for shape, dt in zip(shapes, dtypes)]
        if self.device.type == "cuda":
            with self._lock:
                self._get_bucket(arrays)
        if self._input_names is None:
            self.run(arrays)  # discover input/output names once
        return True

    # -- handle API (reference get_input_handle/get_output_handle) ---------
    def get_input_names(self):
        return list(self._input_names or [])

    def get_output_names(self):
        return list(self._output_names or [])

    def get_input_handle(self, name):
        if not hasattr(self, "_in_handles"):
            self._in_handles = {}
        return self._in_handles.setdefault(name, _Handle(name))

    def get_output_handle(self, name):
        if not hasattr(self, "_out_handles"):
            self._out_handles = {}
        return self._out_handles.setdefault(name, _Handle(name))

    def _eager(self, arrays):
        with torch.no_grad():
            outs = _as_tuple(self._layer(
                *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)))
            packed, meta = _pack(outs)
        return _unpack(_fetch(packed), meta)

    def run(self, inputs=None):
        """Run with positional numpy inputs (returns a list of numpy
        arrays), or with bound handles when inputs is None (ZeroCopyRun
        path).  On the card: the bucket's graph (captured on a new
        signature), one copy in and one copy out."""
        if inputs is None:
            names = self._input_names or sorted(
                getattr(self, "_in_handles", {}), key=_natural_key)
            inputs = [self._in_handles[n]._value for n in names]
        arrays = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                  else np.asarray(x) for x in inputs]
        if self._stream is None:
            outs = self._eager(arrays)
        else:
            with self._lock, torch.cuda.stream(self._stream):
                outs = self._get_bucket(arrays).run(arrays)
        if self._input_names is None:
            self._input_names = [f"x{i}" for i in range(len(arrays))]
            self._output_names = [f"out{i}" for i in range(len(outs))]
        for i, n in enumerate(self._output_names or []):
            if hasattr(self, "_out_handles") and n in self._out_handles:
                self._out_handles[n]._value = outs[i]
        return outs
