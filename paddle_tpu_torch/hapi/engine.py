"""The training engine behind Model.fit (port of paddle_tpu/hapi/engine.py:
``_LossRing``, ``build_pure_train_step`` and ``TrainEngine`` on one
device, with its compiled, donated step).

The reference snapshots the training state into one device-resident
pytree and jits a donated step over it: one compiled executable per input
signature, the learning rate a device scalar, the step counter advanced
inside the step, a fresh rng key handed to every dispatch.  Eager PyTorch
already keeps the state on the card, in the module's parameters and the
optimizer's moments, and updates it in place.  What the compiled step buys
the reference, one dispatch a step instead of ~1,400 launches from Python,
the engine gets from a CUDA graph on a CUDA device:

- the first step of each input signature (the shapes and dtypes of the
  inputs and labels) runs eagerly on a side stream: a real step, whose
  loss goes to the ring; then the engine captures the step (forward,
  loss, backward, the multi-tensor update, clearing the gradients) as
  one ``torch.cuda.CUDAGraph`` over static input buffers, every graph in
  one shared memory pool;
- every later step of that signature copies its batch into those buffers
  (from pinned memory) and replays the graph.  The cache of graphs is the
  counterpart of jit's compile cache: an epoch's short last batch gets a
  graph of its own, not an eager step.

What changes from step to step and a kernel would otherwise take by value
is read from device memory, written by the step's host prologue once per
executed step (never at the capture, which runs nothing): the optimizer's
scalars, the lr and the bias corrections of its step count
(``Optimizer.begin_step``), and the attention dropout's step counter
(framework/random.py ``StepKeys``, the counterpart of the reference's
``split_key``).  The hidden dropout (``F.dropout``) draws from torch's CUDA
generator, which the graph registers: a replay advances it by the
captured step's whole offset, so it draws what the eager step draws from
the same state.  A capture that fails raises, as does a step that syncs
the host (the reference's jit raises on host-dependent control flow): there
is no eager fallback.  On the CPU the step is the eager one
(:meth:`TrainEngine._step_eager`), which on the card is the graph's
reference.

Steps are issued without a host sync: each loss stays on the card in the
``_LossRing`` (a copy of the graph's static loss), and ``drain()`` brings
every pending loss back in ONE device-to-host copy.  The step math
(forward, loss, backward, update) is one function,
:func:`build_train_step`, shared by ``Model.train_batch`` and the engine,
as the reference shares ``build_pure_train_step``.  Not ported yet
(ROADMAP.md): meshes and layouts, recompute, gradient accumulation, the
pod hooks, checkpoint state and the op report.
"""
from __future__ import annotations

import contextlib

import torch

from ..framework.place import copy_to_device
from ..framework.random import StepKeys
from ..ops import kernels

__all__ = ["TrainEngine", "build_train_step", "to_device"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def to_device(xs, device):
    """Tensors (or array-likes) onto ``device`` without a host sync
    (framework/place.py ``copy_to_device``: through pinned memory to a
    CUDA device); a tensor already there is returned as it is."""
    device = torch.device(device)
    return [x if x.device == device else copy_to_device(
                torch.empty(x.shape, dtype=x.dtype, device=device), x)
            for x in map(torch.as_tensor, xs)]


class _LossRing:
    """Loss scalars still on the card, awaiting one batched fetch.

    ``append`` never blocks; ``drain()`` copies everything pending to the
    host at once and returns python floats in step order."""

    def __init__(self):
        self._pending = []

    def append(self, dev_scalar):
        self._pending.append(dev_scalar.detach().float().reshape(()))

    def __len__(self):
        return len(self._pending)

    def drain(self):
        if not self._pending:
            return []
        out = torch.stack(self._pending).cpu().tolist()
        self._pending = []
        return out


def build_train_step(network, loss_layer, opt):
    """THE train-step math: ``step(inputs, labels) -> (loss, outs)`` runs
    the network in train mode, the loss (its mean), the backward, the
    optimizer's device half (``opt.apply_step``: the caller runs
    ``opt.begin_step()`` first, once per executed step) and clears the
    gradients.  The loss is returned on the device, detached."""

    def step(inputs, labels):
        if not callable(loss_layer):
            raise RuntimeError("prepare() a loss before fit()")
        network.train()
        outs = network(*inputs)
        loss = loss_layer(*(_to_list(outs) + list(labels))).mean()
        loss.backward()
        opt.apply_step()
        opt.clear_grad()
        return loss.detach(), outs

    return step


def _map(fn, outs):
    """``fn`` on each tensor of a network's outputs (a tensor, or a list or
    tuple of them), in the same structure."""
    if isinstance(outs, torch.Tensor):
        return fn(outs)
    if isinstance(outs, (list, tuple)):
        return type(outs)(_map(fn, o) for o in outs)
    return outs


def _signature(inputs, labels):
    """A batch's input signature, the key of the graph cache: the shape
    and dtype of every input and label."""
    return tuple((tuple(t.shape), t.dtype) for t in inputs), \
        tuple((tuple(t.shape), t.dtype) for t in labels)


class _StepGraph:
    """One captured step: ``replay`` (the CUDA graph's), the static inputs
    and labels it reads, the static loss and outputs it writes, and the
    launches of each kernel wrapper in one replay."""

    def __init__(self, replay, inputs, labels, loss, outs, launches):
        self.replay, self.inputs, self.labels = replay, inputs, labels
        self.loss, self.outs, self.launches = loss, outs, launches


class TrainEngine:
    """Owns the sync-free step loop for one Model across fit() runs.

    Lifecycle: ``begin()`` → N x ``step()`` (no host sync) → ``drain()``
    at log and epoch boundaries → ``finish()`` at fit exit.  The graphs
    and the dropout key state live as long as the engine (a ``prepare()``
    makes a new one) while the training state stays where the graphs
    captured it: a graph reads and writes the parameters, the optimizer's
    slots and its scalars at fixed addresses, so ``begin()`` drops every
    graph once any of them was replaced (a loaded optimizer state, a
    cast), as the reference re-snapshots its state at ``begin()``.
    Capture bookkeeping: ``captures`` (graphs made, one per signature and
    state), ``replays`` (steps replayed), ``graph_launches`` (signature ->
    kernel wrapper -> launches in one replay, as the wrappers counted them
    while the step was captured: a replay runs no Python)."""

    def __init__(self, model):
        self.model = model
        self.ring = _LossRing()
        self._body = None
        self._graphs: dict[tuple, _StepGraph] = {}
        self._pool = None          # the graphs' shared memory pool
        self._state = None         # _state_key() of the graphs' state
        self._keys = None          # StepKeys: steps go through graphs
        self.captures = 0
        self.replays = 0

    @property
    def graph_launches(self) -> dict:
        return {sig: g.launches for sig, g in self._graphs.items()}

    def begin(self):
        m = self.model
        opt = m._optimizer
        if opt is None or m._loss is None:
            raise RuntimeError("prepare() an optimizer and a loss before "
                               "fit()")
        self._body = build_train_step(m.network, m._loss, opt)
        self.ring = _LossRing()
        if self._graphs and self._state_key() != self._state:
            self._graphs, self._pool = {}, None
        if m.device.type == "cuda" and self._keys is None:
            if opt._kernel_spec() is None:
                raise NotImplementedError(
                    f"{type(opt).__name__}'s update rule has no kernel: its "
                    "per-parameter loop takes the lr and step by value, so "
                    "the captured train step cannot replay it")
            self._keys = StepKeys(m.device)
        return self

    def _state_key(self):
        """The addresses of the state a graph updates in place: the
        network's parameters and buffers, the optimizer's slots and its
        scalars."""
        net, opt = self.model.network, self.model._optimizer
        return tuple(t.data_ptr() for t in (
            *net.parameters(), *net.buffers(),
            *(v for slots in opt._slots.values() for v in slots.values()),
            *opt._scalars.values()))

    def step(self, inputs, labels):
        """Issue one train step WITHOUT a host sync.  The loss lands in the
        ring; returns the step's model outputs (on the graph path the
        graph's static outputs, which its next replay overwrites).  On a
        CUDA device: the first step of a signature runs eagerly and is
        captured, later ones replay the capture."""
        if self._keys is None:
            return self._step_eager(inputs, labels)
        inputs = [torch.as_tensor(x) for x in inputs]
        labels = [torch.as_tensor(x) for x in labels]
        sig = _signature(inputs, labels)
        g = self._graphs.get(sig)
        if g is None:
            return self._first_step(sig, inputs, labels)
        self._prologue()
        for dst, src in zip(g.inputs + g.labels, inputs + labels):
            copy_to_device(dst, src)
        g.replay()
        self.replays += 1
        self.ring.append(g.loss.to(torch.float32, copy=True))
        return g.outs

    def _step_eager(self, inputs, labels):
        """The same step issued op by op on the current stream: the CPU's
        step, and on the card the graph's reference (it runs the same
        prologue and draws what a replay draws)."""
        dev = self.model.device
        return self._eager(to_device(inputs, dev), to_device(labels, dev))

    def _prologue(self):
        """The host prologue, once per executed step: the optimizer's step
        count, lr and kernel scalars, and the dropout step counter, each
        written to the device without a sync."""
        self.model._optimizer.begin_step()
        if self._keys is not None:
            self._keys.advance()

    def _scope(self):
        return contextlib.nullcontext() if self._keys is None \
            else self._keys.scope()

    def _eager(self, inputs, labels):
        self._prologue()
        with self._scope():
            loss, outs = self._body(inputs, labels)
        self.ring.append(loss)
        return outs

    def _first_step(self, sig, inputs, labels):
        """A new signature's first step: the real step, issued eagerly over
        static copies of the batch (``_warm_up``), then the capture of the
        step over the same buffers, which runs nothing and advances no
        host state."""
        dev = self.model.device
        static = [copy_to_device(torch.empty(t.shape, dtype=t.dtype,
                                             device=dev), t)
                  for t in inputs + labels]
        s_in, s_lab = static[:len(inputs)], static[len(inputs):]
        outs = self._warm_up(s_in, s_lab)
        counts = kernels.launch_counts()
        g = self._graphs[sig] = self._capture(sig, s_in, s_lab)
        g.launches = {n: c - counts[n]
                      for n, c in kernels.launch_counts().items()
                      if c != counts[n]}
        self._state = self._state_key()
        self.captures += 1
        return outs

    def _warm_up(self, s_in, s_lab):
        """The eager step on a side stream, so the kernel libraries load
        and cuBLAS's workspace, the optimizer's slots and scalars and the
        dropout keys are made outside the capture."""
        current = torch.cuda.current_stream(self.model.device)
        side = torch.cuda.Stream(self.model.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            outs = self._eager(s_in, s_lab)
        current.wait_stream(side)
        # what the caller and the ring hold was made on the side stream
        _map(lambda t: t.record_stream(current), outs)
        self.ring._pending[-1].record_stream(current)
        return outs

    def _capture(self, sig, s_in, s_lab):
        """Capture the step over the static batch into one CUDA graph in
        the engine's memory pool; raises if the capture fails."""
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                with self._keys.scope():
                    loss, g_outs = self._body(s_in, s_lab)
        except RuntimeError as e:
            raise RuntimeError(
                "the train step could not be captured as a CUDA graph (a "
                "host sync, or host-dependent control flow, in the network "
                f"or the loss?) for inputs/labels {sig}: {e}") from e
        if self._pool is None:
            self._pool = graph.pool()
        return _StepGraph(graph.replay, s_in, s_lab, loss,
                          _map(torch.Tensor.detach, g_outs), {})

    def drain(self):
        """Batched fetch of every pending loss (the sanctioned sync)."""
        return self.ring.drain()

    def finish(self):
        self._body = None
