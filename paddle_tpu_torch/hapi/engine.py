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
as the reference shares ``build_pure_train_step``.

Autograd keeps one AccumulateGrad node a parameter for as long as any
graph holds it, and the node keeps the stream it was made on.  A graph
the caller still holds from an earlier step (a dygraph loss kept alive)
would make the warm-up's and the capture's backward, on streams of their
own, accumulate across streams, so both first give every parameter a
fresh node (:func:`_fresh_grad_accumulators`).

:class:`EvalEngine` is the counterpart of the reference's jitted eval step
(``Model._build_eval_step``): the forward and the loss under
``torch.no_grad()`` in eval mode, captured once per batch signature in a
memory pool of its own and replayed; ``Model.evaluate``, ``eval_batch``,
``predict`` and ``predict_batch`` go through it.  ``fit(accum_steps=k)``
accumulates gradients over k microbatches inside the one captured step
(:func:`build_train_step`).  :meth:`TrainEngine.ft_state` and
:meth:`TrainEngine.adopt_ft_state` are the checkpoint state of
``fit(resume=)``: a host copy of the parameters, buffers, slots and
counters, and its landing in place, in the tensors the graphs hold.  Not
ported yet (ROADMAP.md): meshes and layouts, recompute, the pod hooks and
the op report.
"""
from __future__ import annotations

import contextlib

import torch

from ..amp import amp_key
from ..framework import random as _random
from ..framework.place import copy_to_device
from ..framework.random import StepKeys
from ..ops.capture import capture
from ..optimizer import Optimizer

__all__ = ["EvalEngine", "TrainEngine", "build_eval_step",
           "build_train_step", "fetch", "microbatch_split", "to_device"]


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


def fetch(tensors):
    """Tensors of any dtypes and devices to host tensors in ONE
    device-to-host copy: their bytes are concatenated on the device, copied
    once and split again.  A tensor already on the host, or a value that
    is no tensor, is returned as it is."""
    def on_device(t):
        return isinstance(t, torch.Tensor) and t.device.type != "cpu"

    tensors = [t.detach() if isinstance(t, torch.Tensor) else t
               for t in tensors]
    dev = [t for t in tensors if on_device(t)]
    if not dev:
        return tensors
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in dev]).cpu()
    out, at = [], 0
    for t in tensors:
        if not on_device(t):
            out.append(t)
            continue
        n = t.numel() * t.element_size()
        # a copy starts at offset 0, where any dtype may view the bytes
        out.append(flat[at:at + n].clone().view(t.dtype).reshape(t.shape))
        at += n
    return out


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
        return self.drain_with(())[0]

    def drain_with(self, extra):
        """The pending losses and the tensors ``extra`` in the same single
        copy: (losses as floats, ``extra`` as host tensors)."""
        n = len(self._pending)
        host = fetch(self._pending + list(extra))
        self._pending = []
        losses = torch.stack(host[:n]).tolist() if n else []
        return losses, host[n:]


def microbatch_split(tensors, k_steps):
    """Each tensor [k*mb, ...] as k contiguous views [mb, ...] (a 0-d
    tensor as it is, k times), the reference's ``microbatch_split``
    (paddle_tpu/distributed/layout.py:92): a batch dim that ``k_steps`` does
    not divide raises ``ValueError``.  Returns a list of k lists."""
    def leaf(x):
        if x.dim() == 0:
            return [x] * k_steps
        if x.shape[0] % k_steps:
            raise ValueError(
                f"global batch dim {x.shape[0]} not divisible by "
                f"accum_steps={k_steps}")
        return list(x.split(x.shape[0] // k_steps))

    per = [leaf(x) for x in tensors]
    return [[views[j] for views in per] for j in range(k_steps)]


def _merge_into(merged, out, j, k):
    """Write microbatch ``j``'s outputs ``out`` (detached) into ``merged``,
    the outputs in global batch order, made at microbatch 0: the reference
    re-merges its [k, mb, ...] outputs to [k*mb, ...], and keeps a 0-d
    output stacked as [k].  Returns ``merged``."""
    if isinstance(out, torch.Tensor):
        if merged is None:
            shape = (k * out.shape[0],) + tuple(out.shape[1:]) \
                if out.dim() else (k,)
            merged = out.new_empty(shape)
        if out.dim():
            n = out.shape[0]
            merged[j * n:(j + 1) * n].copy_(out)
        else:
            merged[j].copy_(out)
        return merged
    if isinstance(out, (list, tuple)):
        merged = merged or [None] * len(out)
        return type(out)(_merge_into(m, o, j, k)
                         for m, o in zip(merged, out))
    return out


def build_train_step(network, loss_layer, opt, accum_steps=1,
                     outputs=True):
    """THE train-step math: ``step(inputs, labels) -> (loss, outs)`` runs
    the network in train mode, the loss (its mean), the backward, the
    optimizer's device half in the reference's ``apply_pytree`` form
    (``opt.apply_step(pytree=True)``: the caller runs
    ``opt.begin_step(pytree=True)`` first, once per executed step) and
    clears the gradients.  The loss is returned on the device, detached.

    With ``accum_steps`` k > 1, the reference's ``microbatch_scan``
    (paddle_tpu/distributed/layout.py:107) inside the one step: the batch
    in k equal contiguous microbatches, each one's mean loss backpropagated
    unscaled, the gradients summed in the parameter's dtype from zero
    (autograd accumulates into the zeroed ``.grad``), then multiplied by
    1/k in place; buffers (batch norm's running statistics) move through
    the microbatches in order; the loss is the float32 sum of the
    microbatch losses times 1/k and the outputs are re-merged to global
    order (with ``outputs`` False, as ``fit`` asks where no metric reads
    them, the step returns None for them and keeps no copy: a microbatch's
    outputs, the MLM logits of a BERT microbatch, are freed with its
    graph).  The gradients stay allocated and are zeroed in place at the
    step's end, so their addresses stay fixed across steps."""

    def step(inputs, labels):
        if not callable(loss_layer):
            raise RuntimeError("prepare() a loss before fit()")
        network.train()
        if accum_steps == 1:
            outs = network(*inputs)
            loss = loss_layer(*(_to_list(outs) + list(labels))).mean()
            loss.backward()
            opt.apply_step(pytree=True)
            opt.clear_grad()
            return loss.detach(), outs
        n_in = len(inputs)
        total = torch.zeros((), dtype=torch.float32,
                            device=inputs[0].device)
        outs = None
        micros = microbatch_split(list(inputs) + list(labels), accum_steps)
        for j, micro in enumerate(micros):
            out = network(*micro[:n_in])
            loss = loss_layer(*(_to_list(out) + micro[n_in:])).mean()
            loss.backward()
            total = total + loss.detach().float()
            if outputs:
                with torch.no_grad():
                    outs = _merge_into(outs, out, j, accum_steps)
            del out, loss
        inv = 1.0 / accum_steps
        with torch.no_grad():
            for p in opt._parameter_list or []:
                if p.grad is not None:
                    p.grad.mul_(inv)
        opt.apply_step(pytree=True)
        opt.clear_grad(set_to_zero=True)
        return total * inv, outs

    return step


def _fresh_grad_accumulators(params):
    """Make every parameter take a new AccumulateGrad node at its next use
    in a graph, made on the stream current then.

    A graph the caller still holds (an earlier step's loss) keeps its
    nodes, and each node the stream it was made on: reused by a backward
    on another stream, it accumulates across the two streams (autograd
    warns, and a node of the default stream breaks a capture).  Setting
    ``.data`` to a tensor of another dtype drops the parameter's node
    (autograd's ``set_data``); setting the same tensor back leaves the
    parameter as it was, its address and its gradient included.  The
    held graph keeps its own node."""
    with torch.no_grad():
        for p in params:
            data = p.data
            p.data = data.new_empty(0, dtype=torch.float16 if data.dtype
                                    != torch.float16 else torch.float32)
            p.data = data


def _map(fn, outs):
    """``fn`` on each tensor of a network's outputs (a tensor, or a list or
    tuple of them), in the same structure."""
    if isinstance(outs, torch.Tensor):
        return fn(outs)
    if isinstance(outs, (list, tuple)):
        return type(outs)(_map(fn, o) for o in outs)
    return outs


def build_eval_step(network, loss_layer):
    """THE eval-step math (the reference's ``_build_eval_step``):
    ``step(inputs, labels) -> (loss, outs)`` runs the network in eval mode
    under ``torch.no_grad()`` and the loss (its mean) when there are labels
    and a loss, else ``loss`` is None.  Shared by ``Model._eval`` and
    :class:`EvalEngine`."""

    @torch.no_grad()
    def step(inputs, labels):
        network.eval()
        outs = network(*inputs)
        loss = None
        if loss_layer is not None and labels:
            loss = loss_layer(*(_to_list(outs) + list(labels))).mean()
        return loss, outs

    return step


def _signature(inputs, labels, accum_steps=1, outputs=True):
    """A batch's input signature, the key of the graph cache: the shape
    and dtype of every input and label, the microbatches a step
    (``fit(accum_steps=)``) and whether the step keeps their merged
    outputs, and, last, the AMP policy the step runs under
    (``amp.amp_key()``: enabled, dtype, level), so a graph captured
    outside ``auto_cast`` is never replayed inside it, nor the other way
    round (the reference's jit traces the policy into its step)."""
    return tuple((tuple(t.shape), t.dtype) for t in inputs), \
        tuple((tuple(t.shape), t.dtype) for t in labels), \
        (accum_steps, outputs), amp_key()


class _StepGraph:
    """One captured step: ``replay`` (the CUDA graph's), the static inputs
    and labels it reads, the static loss and outputs it writes, and the
    launches of each kernel wrapper in one replay."""

    def __init__(self, replay, inputs, labels, loss, outs, launches):
        self.replay, self.inputs, self.labels = replay, inputs, labels
        self.loss, self.outs, self.launches = loss, outs, launches


class _GraphEngine:
    """The graph cache both engines share: on a CUDA device one CUDA graph
    per batch signature, replayed; elsewhere the eager step.

    A signature's first batch runs as the real step over static copies of
    the batch (``_warm_up``), then the step (``_body``) is captured over
    the same buffers into the engine's memory pool; later batches copy
    into those buffers (from pinned memory) and replay.  A replay returns
    the graph's static outputs, which the next replay overwrites, and
    hands the ring a copy of its static loss.  A graph reads and writes
    the network's parameters and buffers (gathered by ``begin()``) and
    the tensors of :meth:`_own_state` at their captured addresses, so
    :meth:`refresh` (run by ``begin()``) drops every graph once any of
    them was replaced.  A capture that fails raises: there is no eager
    fallback.  Bookkeeping: ``captures`` (graphs made, one per signature
    and state), ``replays`` (steps replayed), ``graph_launches``
    (signature -> kernel wrapper -> launches in one replay, as the
    wrappers counted them while the step was captured: a replay runs no
    Python).

    A subclass supplies ``_what`` (its name in errors), ``begin()`` (which
    builds ``_body``: ``(inputs, labels) -> (loss or None, outputs)``,
    then calls ``_begin``), and, where it differs from doing nothing,
    ``_own_state``, ``_prologue`` (host work before each executed step),
    ``_scope`` (the context the body runs in) and ``_warm_up``."""

    _what = "step"

    def __init__(self, model):
        self.model = model
        self.ring = _LossRing()
        self._body = None
        self._graphs: dict[tuple, _StepGraph] = {}
        self._pool = None          # the graphs' shared memory pool
        self._state = None         # _state_key() of the graphs' state
        self._held = ()            # the network's tensors, from begin()
        self._replaying = model.device.type == "cuda"
        self._accum = 1            # microbatches a step (TrainEngine)
        self._outputs = True       # whether it merges their outputs
        self.captures = 0
        self.replays = 0

    @property
    def graph_launches(self) -> dict:
        return {sig: g.launches for sig, g in self._graphs.items()}

    def _begin(self):
        net = self.model.network
        self.ring = _LossRing()
        # gathered once here: a walk of the module tree costs the host
        # more than the addresses refresh() reads before each step
        self._held = (*net.parameters(), *net.buffers())
        self.refresh()
        return self

    def refresh(self):
        """Drop every graph (and the pool) once a tensor the graphs hold
        was replaced since the captures (a cast, a loaded optimizer
        state, a callback's new ``p.data``).  Call it only while no
        replay is pending on the card."""
        if self._graphs and self._state_key() != self._state:
            self._graphs, self._pool = {}, None

    def _own_state(self):
        """Tensors a graph holds besides the network's."""
        return ()

    def _state_key(self):
        return tuple(t.data_ptr() for t in (*self._held, *self._own_state()))

    def step(self, inputs, labels):
        """Issue one step WITHOUT a host sync: its loss (if any) lands in
        the ring; returns the step's outputs (on the graph path the
        graph's static outputs)."""
        if not self._replaying:
            return self._step_eager(inputs, labels)
        inputs = [torch.as_tensor(x) for x in inputs]
        labels = [torch.as_tensor(x) for x in labels]
        sig = _signature(inputs, labels, self._accum, self._outputs)
        g = self._graphs.get(sig)
        if g is None:
            return self._first_step(sig, inputs, labels)
        self._prologue()
        for dst, src in zip(g.inputs + g.labels, inputs + labels):
            copy_to_device(dst, src)
        g.replay()
        self.replays += 1
        if g.loss is not None:
            self.ring.append(g.loss.to(torch.float32, copy=True))
        return g.outs

    def _step_eager(self, inputs, labels):
        """The same step issued op by op on the current stream: the CPU's
        step, and on the card the graph's reference."""
        dev = self.model.device
        return self._eager(to_device(inputs, dev), to_device(labels, dev))

    def _prologue(self):
        pass

    def _scope(self):
        return contextlib.nullcontext()

    def _eager(self, inputs, labels):
        self._prologue()
        with self._scope():
            loss, outs = self._body(inputs, labels)
        if loss is not None:
            self.ring.append(loss)
        return outs

    def _warm_up(self, s_in, s_lab):
        return self._eager(s_in, s_lab)

    def _first_step(self, sig, inputs, labels):
        """A new signature's first step: the real step over static copies
        of the batch (``_warm_up``), then the capture of the step over the
        same buffers, which runs nothing and advances no host state."""
        dev = self.model.device
        static = [copy_to_device(torch.empty(t.shape, dtype=t.dtype,
                                             device=dev), t)
                  for t in inputs + labels]
        s_in, s_lab = static[:len(inputs)], static[len(inputs):]
        outs = self._warm_up(s_in, s_lab)
        self._graphs[sig] = self._capture(sig, s_in, s_lab)
        self._state = self._state_key()
        self.captures += 1
        return outs

    def _capture(self, sig, s_in, s_lab):
        """Capture the step over the static batch into one CUDA graph in
        the engine's memory pool (ops/capture.py); raises if the capture
        fails."""
        def body():
            with self._scope():
                return self._body(s_in, s_lab)

        try:
            cap = capture(body, pool=self._pool)
        except RuntimeError as e:
            raise RuntimeError(
                f"the {self._what} step could not be captured as a CUDA "
                "graph (a host sync, or host-dependent control flow, in the "
                f"network or the loss?) for inputs/labels {sig}: {e}") from e
        if self._pool is None:
            self._pool = cap.graph.pool()
        loss, outs = cap.out
        return _StepGraph(cap.graph.replay, s_in, s_lab, loss,
                          _map(torch.Tensor.detach, outs), cap.launches)

    def drain(self):
        """Batched fetch of every pending loss (the sanctioned sync)."""
        return self.ring.drain()


class TrainEngine(_GraphEngine):
    """Owns the sync-free step loop for one Model across fit() runs.

    Lifecycle: ``begin()`` → N x ``step()`` (no host sync) → ``drain()``
    at log and epoch boundaries → ``finish()`` at fit exit.  The graphs
    and the dropout key state live as long as the engine (a ``prepare()``
    makes a new one) while the training state stays where the graphs
    captured it: a graph reads and writes the parameters, the optimizer's
    slots and its scalars at fixed addresses, so ``begin()`` drops every
    graph once any of them was replaced (a loaded optimizer state, a
    cast), as the reference re-snapshots its state at ``begin()``; with
    user callbacks ``fit`` runs that check (``refresh``) before every
    step, as the reference refreshes its state from the layers then."""

    _what = "train"

    def __init__(self, model):
        super().__init__(model)
        self._keys = None          # StepKeys of the graph path

    def begin(self, accum_steps=1, outputs=True):
        """Start a ``fit``: ``accum_steps`` microbatches a step, whose
        outputs are merged for the caller only with ``outputs``.  The
        optimizer runs in the reference's ``apply_pytree`` form (no
        per-parameter learning rates, AdamW decays every parameter)."""
        m = self.model
        opt = m._optimizer
        if opt is None or m._loss is None:
            raise RuntimeError("prepare() an optimizer and a loss before "
                               "fit()")
        if not isinstance(opt, Optimizer):
            # the reference's engine reads the optimizer's _step_count and
            # calls its init_pytree, which a wrapper lacks
            raise AttributeError(
                f"{type(opt).__name__!r} object has no attribute "
                "'_step_count': Model.fit takes an Optimizer, not a wrapper "
                "(as the reference's fit)")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self._accum = int(accum_steps)
        self._outputs = bool(outputs)
        self._body = build_train_step(m.network, m._loss, opt, self._accum,
                                      self._outputs)
        self._begin()
        if self._replaying and self._keys is None:
            if opt._kernel_spec() is None:
                raise NotImplementedError(
                    f"{type(opt).__name__}'s update rule has no kernel: its "
                    "per-parameter loop takes the lr and step by value, so "
                    "the captured train step cannot replay it")
            self._keys = StepKeys(m.device)
        return self

    def _own_state(self):
        """The optimizer's slots and scalars, which a graph updates in
        place with the parameters."""
        opt = self.model._optimizer
        return (*(v for slots in opt._slots.values() for v in slots.values()),
                *opt._scalars.values())

    def _state_key(self):
        """The addresses, and which parameters are trainable: a graph
        updates the parameters that had a gradient when it was captured,
        so a parameter frozen (or thawed) since then drops the graphs at
        the next ``begin()``, as the reference splits its trainable tree
        there."""
        return (super()._state_key(),
                tuple(t.requires_grad for t in self._held))

    def _prologue(self):
        """The host prologue, once per executed step: the optimizer's step
        count, lr and kernel scalars, and the dropout step counter, each
        written to the device without a sync."""
        self.model._optimizer.begin_step(pytree=True)
        if self._keys is not None:
            self._keys.advance()

    def _scope(self):
        return contextlib.nullcontext() if self._keys is None \
            else self._keys.scope()

    def _warm_up(self, s_in, s_lab):
        """The eager step on a side stream, so the kernel libraries load
        and cuBLAS's workspace, the optimizer's slots and scalars and the
        dropout keys are made outside the capture.  Its outputs come back
        detached, so its autograd graph is gone before the capture."""
        current = torch.cuda.current_stream(self.model.device)
        side = torch.cuda.Stream(self.model.device)
        side.wait_stream(current)
        _fresh_grad_accumulators(self.model.network.parameters())
        with torch.cuda.stream(side):
            outs = _map(torch.Tensor.detach, self._eager(s_in, s_lab))
        current.wait_stream(side)
        # what the caller and the ring hold was made on the side stream
        _map(lambda t: t.record_stream(current), outs)
        self.ring._pending[-1].record_stream(current)
        return outs

    def _capture(self, sig, s_in, s_lab):
        _fresh_grad_accumulators(self.model.network.parameters())
        return super()._capture(sig, s_in, s_lab)

    def finish(self):
        self._body = None

    # -- checkpoint state (fit(resume=)) -----------------------------------
    def _trainable(self):
        return {n: p for n, p in self.model.network.named_parameters()
                if p.requires_grad}

    def ft_state(self, it_count):
        """The checkpointable state as one tree, copied to the host: the
        trainable parameters, the buffers and the optimizer's slots by
        structured name (``/params/<name>``, ``/buffers/<name>``,
        ``/opt/<name>/<slot>``, the reference's keypaths) and the loop's
        counters (``/meta/it``, ``/meta/opt_steps``).  The copy is a
        blocking one on the current stream, after every step issued so
        far: the next replay updates these tensors in place, so the
        snapshot is complete before it is enqueued (it is the async
        writer's double buffer)."""
        from ..distributed.resilience import materialize

        m = self.model
        return materialize({
            "params": self._trainable(),
            "buffers": dict(m.network.named_buffers()),
            "opt": m._opt_tree(),
            "meta": {"it": torch.tensor(it_count, dtype=torch.int32),
                     "opt_steps": torch.tensor(m._optimizer._step_count,
                                               dtype=torch.int32)}})

    def ft_template(self):
        """The structure of :meth:`ft_state` with None leaves: a restore
        matches leaves by keypath and takes dtypes and shapes from the
        manifest."""
        opt = self.model._optimizer
        return {"params": dict.fromkeys(self._trainable()),
                "buffers": dict.fromkeys(
                    n for n, _ in self.model.network.named_buffers()),
                "opt": {n: dict.fromkeys(opt._slot_names())
                        for n in self._trainable()},
                "meta": {"it": None, "opt_steps": None}}

    def adopt_ft_state(self, snap):
        """Write a restored snapshot into the live state IN PLACE: the
        parameters, buffers and slots a captured graph reads keep their
        addresses, so its next replay reads the restored values (a slot
        the optimizer does not hold yet is made, and then the graphs are
        dropped, as ``refresh`` does for a replaced tensor).  Sets the
        optimizer's step count."""
        m = self.model
        opt = m._optimizer
        params = self._trainable()
        buffers = dict(m.network.named_buffers())
        made = False
        with torch.no_grad():
            for k, v in snap["params"].items():
                params[k].copy_(v)
            for k, v in snap["buffers"].items():
                buffers[k].copy_(v)
            for k, slots in snap["opt"].items():
                p = params[k]
                own = opt._slots.get(id(p))
                if own is None or set(own) != set(slots):
                    opt._slots[id(p)] = {n: opt._slot_from(n, p, v)
                                         for n, v in slots.items()}
                    made = True
                else:
                    for n, v in slots.items():
                        own[n].copy_(v)
        opt._step_count = int(snap["meta"]["opt_steps"])
        if made:
            self._graphs, self._pool = {}, None

    def rng_state(self):
        """The random streams a step draws from, as JSON: torch's CPU
        generator and that of the network's CUDA device (the hidden
        dropout's; a replay advances it as the eager step does), the
        initialisation generator (the attention calls' seeds) and the
        graph path's :class:`StepKeys` (keys and step counter).  Restored
        by :meth:`adopt_rng_state`, a resumed run draws what the unbroken
        run drew."""
        dev = self.model.device
        state = {"cpu": torch.get_rng_state().numpy().tobytes().hex(),
                 "init": _random.default_generator().get_state()
                 .numpy().tobytes().hex()}
        if dev.type == "cuda":
            state["cuda"] = torch.cuda.get_rng_state(dev).numpy() \
                .tobytes().hex()
        if self._keys is not None:
            state["step_keys"] = {"keys": list(self._keys.keys),
                                  "step": self._keys.step}
        return state

    def adopt_rng_state(self, state, it_count):
        """Restore :meth:`rng_state`'s streams (a graph captured with other
        attention keys is dropped: it holds them by value).  A generation
        without them (the reference's) only moves the step counter of the
        attention keys to ``it_count``, so no mask of an earlier step is
        drawn again."""
        def tensor(hex_):
            return torch.frombuffer(bytearray.fromhex(hex_),
                                    dtype=torch.uint8)

        if not state:
            if self._keys is not None:
                self._keys.step = int(it_count)
            return
        torch.set_rng_state(tensor(state["cpu"]))
        _random.default_generator().set_state(tensor(state["init"]))
        dev = self.model.device
        if dev.type == "cuda" and "cuda" in state:
            torch.cuda.set_rng_state(tensor(state["cuda"]), dev)
        if self._keys is not None and "step_keys" in state:
            keys = [int(k) for k in state["step_keys"]["keys"]]
            if keys != self._keys.keys:
                # a captured graph holds its calls' keys by value
                self._graphs, self._pool = {}, None
            self._keys.keys = keys
            self._keys.step = int(state["step_keys"]["step"])


class EvalEngine(_GraphEngine):
    """The eval step of one Model (the reference jits its eval step and
    calls it per batch): the forward and the loss under
    ``torch.no_grad()`` in eval mode, its graphs in a memory pool of the
    engine's own (a train graph's replay never writes it).  Nothing of the
    step draws a dropout key or advances a host counter: in eval mode
    dropout is off.  The graphs read the parameters and buffers, so
    ``begin()`` drops them once any of those was replaced."""

    _what = "eval"

    def begin(self):
        m = self.model
        self._body = build_eval_step(m.network, m._loss)
        return self._begin()

    def _prologue(self):
        # a replay runs no Python: leave the network as the eager step does
        self.model.network.eval()
