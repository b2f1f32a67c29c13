"""One capture routine for every CUDA graph of the port: the serving
engine's decode (or speculative) step, ``generate``'s decode step a key and
``Model.fit``'s train and eval steps a batch signature.

A CUDA graph that the cyclic garbage collector frees in the middle of
another capture invalidates that capture (``cudaErrorStreamCaptureInvalidated``):
freeing a graph returns its memory pool, which can free device memory,
and that is not allowed while a stream captures.  Engines, requests and
handles hold each other in reference cycles, so a dropped engine's graphs
wait for the collector.  :func:`capture` therefore collects before the
warm-up, so that dead graphs are freed outside any capture, and turns the
collector off for the capture (in every thread: it is one switch for the
process), restoring its state afterwards.
"""
from __future__ import annotations

import gc
from dataclasses import dataclass

import torch

from . import kernels


@dataclass
class Captured:
    """A capture's result: the graph, what the body returned while it was
    captured, and the launches the kernel wrappers counted during it
    (name -> launches, and kernel -> {variant: launches} of the entries
    with two kernels).  A replay runs the kernels again without passing
    through the wrappers, so these counts are the graph's launches a
    replay."""
    graph: torch.cuda.CUDAGraph
    out: object
    launches: dict
    variants: dict


def side_stream(fn, device):
    """A warm-up for :func:`capture`: ``fn()`` on a side stream that waits
    for the current one, which then waits for it, so that the kernel
    libraries load, workspaces and lazy state are made and every lazy
    choice is taken outside the capture."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn()
    current.wait_stream(side)


def capture(body, warm_up=None, pool=None) -> Captured:
    """Capture ``body()`` into one CUDA graph (in memory pool ``pool``,
    a new one if None) with ``capture_error_mode="thread_local"``, after
    a garbage collection and ``warm_up()`` (when given), with the cyclic
    collector off during the capture.  A capture that fails raises."""
    gc.collect()
    if warm_up is not None:
        warm_up()
    counts, variants = kernels.launch_counts(), kernels.variant_launches()
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            out = body()
    finally:
        if collecting:
            gc.enable()
    after = kernels.variant_launches()
    return Captured(
        graph, out,
        {n: c - counts[n] for n, c in kernels.launch_counts().items()
         if c != counts[n]},
        {n: {v: c - variants[n][v] for v, c in vs.items()}
         for n, vs in after.items() if vs != variants[n]})
