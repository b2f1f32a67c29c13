"""paddle.io (port of paddle_tpu/io/__init__.py): the datasets
(``Dataset``, ``IterableDataset``, ``TensorDataset``, ``ComposeDataset``,
``ChainDataset``, ``Subset``, ``random_split``), the samplers
(``SequenceSampler``, ``RandomSampler``, ``WeightedRandomSampler``,
``BatchSampler``), ``default_collate_fn``, ``pad_ragged`` and
``DataLoader`` with its worker processes and buffered reader.

Batches are collated on the host as CPU tensors; the training engine
moves them to the card (framework/place.py ``copy_to_device``, on the
step's stream).  Shuffling draws from an explicit ``torch.Generator``: the
caller's, or one seeded from the framework generator
(framework/random.py), so ``paddle_tpu_torch.seed()`` fixes the order as
``paddle.seed()`` does in the reference.  The two packages draw different
orders from one seed.

``DataLoader(num_workers=n)`` runs ``n`` worker processes, each fetching
and collating whole batches; the reference's counterpart collates into
numpy, which has no bfloat16, so here a worker collates into CPU torch
tensors (``collate_fn`` as it is), which reach the parent through
``multiprocessing``'s queue in shared memory (torch's own reductions):
every dtype arrives bit for bit as the in-process collate makes it.  With
``use_buffer_reader`` (the default) a thread keeps ``prefetch_factor``
batches in flight ahead of the consumer (the reference's
``buffered_reader.cc`` analog) and runs the ``placement`` hook on each.
Not ported yet (ROADMAP.md): ``DistributedBatchSampler`` and the mesh
placement (A9), the ``dataloader.batches`` counter (A11).
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import time

import numpy as np
import torch

from ..framework import random as _random

_IN_WORKER = False        # set in a DataLoader worker process


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]

    # a worker gets host copies: a CUDA tensor is never pickled as a
    # device handle, and a worker never touches the card
    def __getstate__(self):
        return {"tensors": [t.detach().cpu() if isinstance(t, torch.Tensor)
                            else t for t in self.tensors]}

    def __setstate__(self, state):
        self.tensors = state["tensors"]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def _seeded_generator():
    """A CPU generator seeded from the framework generator's stream."""
    s = torch.empty((), dtype=torch.int64).random_(
        generator=_random.default_generator())
    return torch.Generator().manual_seed(int(s))


def random_split(dataset, lengths, generator=None):
    """Disjoint ``Subset``s of ``lengths`` (summing to the dataset's size)
    over one permutation drawn from ``generator`` (else the framework
    generator's stream)."""
    total = len(dataset)
    if sum(lengths) != total:
        raise ValueError("sum of lengths must equal dataset size")
    perm = torch.randperm(total, generator=generator if generator is not None
                          else _seeded_generator()).tolist()
    out, start = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[start:start + ln]))
        start += ln
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    """``num_samples`` indices (default: the dataset's size) from
    ``generator``: a permutation's head, or with ``replacement`` uniform
    draws.  Each epoch's ``iter()`` continues the generator's stream, so
    epochs differ."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator if generator is not None \
            else _seeded_generator()

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(torch.randint(0, n, (self.num_samples,),
                                      generator=self.generator).tolist())
        return iter(torch.randperm(n, generator=self.generator)
                    [:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    """``num_samples`` indices drawn with probability proportional to
    ``weights`` (a zero weight is never drawn), with or without
    replacement, from ``generator`` (else the framework generator's
    stream)."""

    def __init__(self, weights, num_samples, replacement=True,
                 generator=None):
        self.weights = torch.as_tensor(np.asarray(weights, np.float64))
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = generator if generator is not None \
            else _seeded_generator()

    def __iter__(self):
        return iter(torch.multinomial(self.weights, self.num_samples,
                                      self.replacement,
                                      generator=self.generator).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False, generator=None):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset, generator=generator)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def default_collate_fn(batch):
    """Stack samples field by field into CPU tensors (ints int64, floats
    float32, arrays and tensors stacked as they are)."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn([b[i] for b in batch])
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        if _IN_WORKER and sample.device.type == "cpu":
            # a worker stacks straight into shared memory, so the batch
            # crosses to the parent without another copy
            storage = sample._typed_storage()._new_shared(
                len(batch) * sample.numel(), device=sample.device)
            out = sample.new(storage).resize_(len(batch), *sample.shape)
            return torch.stack(batch, out=out)
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.tensor(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.tensor(np.asarray(batch, np.float32))
    return batch


def pad_ragged(seqs, buckets=None, pad_value=0, dtype=np.int64,
               truncate="tail"):
    """Ragged per-sample sequences -> one dense ``[B, L]`` array.

    ``L`` is the smallest entry of ``buckets`` that fits the batch's
    longest sequence (so a few shapes, and captured steps, serve every
    batch); without buckets, the exact max length.  Sequences beyond the
    last bucket are truncated: ``truncate="tail"`` keeps the last elements,
    ``"head"`` the first.  Returns ``(dense, lengths)`` with
    post-truncation int32 lengths.  Numpy only: it runs inside a
    ``collate_fn``, on the reader's thread or in a worker.
    """
    cap = None
    if buckets:
        buckets = sorted(int(b) for b in buckets)
        cap = buckets[-1]
    lens = [len(s) if cap is None else min(len(s), cap) for s in seqs]
    width = max(lens) if lens else 1
    if buckets:
        for b in buckets:
            if width <= b:
                width = b
                break
    out = np.full((len(seqs), max(width, 1)), pad_value, dtype)
    for i, s in enumerate(seqs):
        arr = np.asarray(s, dtype)
        if lens[i] < len(arr):
            arr = arr[-lens[i]:] if truncate == "tail" else arr[:lens[i]]
        out[i, :lens[i]] = arr
    return out, np.asarray(lens, np.int32)


def pin_batch(batch):
    """The placement hook of a fit on the card: each CPU tensor of a
    collated batch (lists, tuples and dicts walked) copied into page-locked
    memory, a fresh block of PyTorch's caching host allocator for every
    batch; a tensor already pinned is kept as it is.

    It runs on the buffered reader's thread and does host work only: the
    batch is pinned before it leaves the reader's queue, and the copy to
    the card is issued later by the consumer (``copy_to_device`` on the
    step's stream), so no cross-stream event is needed.  That holds only
    while this hook never issues a device copy itself.  The copy records
    its stream's use of the block, so the allocator hands the block out
    again only after the copy has run: a batch is never written into
    memory a pending copy still reads."""
    if isinstance(batch, torch.Tensor):
        if batch.device.type == "cpu" and not batch.is_pinned():
            return batch.pin_memory()
        return batch
    if isinstance(batch, (list, tuple)):
        return type(batch)(pin_batch(b) for b in batch)
    if isinstance(batch, dict):
        return {k: pin_batch(v) for k, v in batch.items()}
    return batch


class _WorkerError:
    """A worker's exception, sent back to be re-raised in the parent."""

    def __init__(self, worker_id, tb):
        self.worker_id = worker_id
        self.traceback = tb


def _worker_loop(dataset, collate_fn, index_queue, result_queue, worker_id,
                 worker_init_fn):
    """A worker process: fetch and collate each batch of indices it is
    sent, into CPU tensors, until it is sent None (the reference's
    ``_worker_loop``)."""
    import traceback

    global _IN_WORKER
    _IN_WORKER = True
    # no card in a worker, also one forked from a server another library
    # started (CUDA reads this at its first call)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # one intra-op thread a worker, as torch's DataLoader workers: the
    # workers run side by side, and a forked child must not use the
    # parent's thread pool
    torch.set_num_threads(1)
    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
    except Exception:
        result_queue.put((None, _WorkerError(worker_id,
                                             traceback.format_exc())))
        return
    while True:
        job = index_queue.get()
        if job is None:
            break
        bid, indices = job
        try:
            batch = collate_fn([dataset[i] for i in indices])
        except Exception:
            batch = _WorkerError(worker_id, traceback.format_exc())
        result_queue.put((bid, batch))


class _CapHit(Exception):
    pass


class _NullSink:
    """A stream to nowhere with a byte cap: the picklability probe only
    needs to know whether pickling fails (lambdas and locks fail early),
    not the bytes."""

    def __init__(self, cap=64 << 20):
        self.n, self.cap = 0, cap

    def write(self, b):
        self.n += len(b)
        if self.n > self.cap:
            raise _CapHit


class DataLoader:
    """Batches of ``dataset`` through a ``BatchSampler`` and
    ``collate_fn``; the reference's parameters in its order.

    ``feed_list``, ``places``, ``return_list``, ``use_shared_memory`` and
    ``persistent_workers`` are accepted and ignored, as in the reference
    (a worker's batches always cross in shared memory; workers start
    anew each epoch).  ``generator`` (keyword only) is the shuffle's
    ``torch.Generator``.

    ``num_workers > 0`` fetches and collates in that many processes, each
    sent whole batches of indices round robin, ``num_workers x
    prefetch_factor`` batches in flight, their results yielded in order.
    The workers never touch CUDA:

    - they start by ``forkserver`` (a clean server process that never
      initialised CUDA forks each worker), or by ``fork`` with a
      ``RuntimeWarning`` when the dataset, ``collate_fn`` or
      ``worker_init_fn`` does not pickle; ``PADDLE_TPU_MP_START=fork|
      forkserver|spawn`` overrides the choice.  A script whose loader runs
      workers needs an ``if __name__ == "__main__":`` guard: the server
      imports the main module;
    - ``CUDA_VISIBLE_DEVICES`` is ``""`` while they start (restored after),
      so a worker, and the forkserver it comes from, sees no card; a
      forked child of a process that initialised CUDA raises at its first
      CUDA call.  Either way a worker that reaches CUDA fails loudly.

    A worker's exception is raised in the caller with its traceback; a
    worker that dies raises ``RuntimeError`` within about a second, as
    does a batch that takes longer than ``timeout`` seconds (when > 0).
    Workers are shut down when the epoch ends or the consumer stops.

    With ``use_buffer_reader`` a thread runs the source (the workers'
    results, or the in-process collate) ``prefetch_factor`` batches
    ahead, and applies ``placement`` (a function of the collated batch,
    None by default; ``Model.fit`` on the card sets :func:`pin_batch`).
    Each epoch's indices are drawn on the thread that calls ``iter()``;
    a ``batch_sampler`` of the caller's is read lazily (it may be
    infinite).  An ``IterableDataset`` is read in the calling process.
    """

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=False, timeout=0, worker_init_fn=None,
                 persistent_workers=False, *, generator=None):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1)
        self.use_buffer_reader = use_buffer_reader
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.placement = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.drop_last = drop_last
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        elif not self._iterable_mode:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last, generator=generator)
            self.batch_size = batch_size
        else:
            self.batch_sampler = None
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no fixed length")
        return len(self.batch_sampler)

    def __iter__(self):
        # this epoch's indices are drawn here, on the thread that calls
        # iter(), never on the reader's thread; a plain method, so the draw
        # happens at iter() and not at the first next().  A batch sampler
        # of the caller's stays lazy: it may be infinite
        idx_batches = ([list(b) for b in self.batch_sampler]
                       if isinstance(self.batch_sampler, BatchSampler)
                       else None)
        return self._iter_impl(idx_batches)

    def _iter_impl(self, idx_batches):
        gen = self._produce(idx_batches)
        if self.placement is not None:
            gen = self._placed(gen, self.placement)
        if not self.use_buffer_reader:
            yield from gen
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
        sentinel = object()
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def reader():
            try:
                for item in gen:
                    if not put_or_stop(item):
                        return
                put_or_stop(sentinel)
            except BaseException as e:  # re-raised in the consumer
                put_or_stop(e)
            finally:
                # the source's cleanup (the workers' shutdown) on its own
                # thread: a consumer that stops early leaks no process
                gen.close()

        t = threading.Thread(target=reader, daemon=True,
                             name="DataLoader reader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)

    @staticmethod
    def _placed(gen, place):
        """``place`` applied inside the producing generator, so it runs on
        whichever thread drives ``gen`` (the reader's, when buffered)."""
        try:
            for item in gen:
                yield place(item)
        finally:
            gen.close()

    def _produce(self, idx_batches):
        if self._iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
            return
        source = idx_batches if idx_batches is not None \
            else self.batch_sampler
        if self.num_workers > 0:
            yield from self._produce_multiprocess(source)
            return
        for idx_batch in source:
            yield self.collate_fn([self.dataset[i] for i in idx_batch])

    def _pick_start_method(self):
        """``PADDLE_TPU_MP_START`` if set; else ``forkserver`` when the
        dataset, ``collate_fn`` and ``worker_init_fn`` pickle, ``fork``
        with a RuntimeWarning when they do not (the verdict is kept for
        the loader's later epochs)."""
        import multiprocessing as mp
        import pickle
        import warnings

        env = os.environ.get("PADDLE_TPU_MP_START", "").strip().lower()
        if env:
            return env
        cached = getattr(self, "_mp_start_cache", None)
        if cached is not None:
            return cached
        try:
            # the functions first and uncapped: they are small, and the
            # usual unpicklables (lambdas, local functions) live there
            pickle.Pickler(_NullSink(cap=1 << 62)).dump(
                (self.collate_fn, self.worker_init_fn))
            pickle.Pickler(_NullSink()).dump(self.dataset)
        except _CapHit:
            pass        # large but picklable: forkserver is fine
        except Exception:
            warnings.warn(
                "DataLoader dataset/collate_fn/worker_init_fn is not "
                "picklable; falling back to fork-based workers (deadlock "
                "risk in multithreaded processes). Define them at module "
                "scope to enable forkserver workers.", RuntimeWarning)
            self._mp_start_cache = "fork"
            return "fork"
        method = ("forkserver"
                  if "forkserver" in mp.get_all_start_methods() else "spawn")
        self._mp_start_cache = method
        return method

    def _start_workers(self, ctx, index_queues, result_queue):
        """The worker processes, started with no visible CUDA device."""
        if ctx.get_start_method() == "forkserver":
            # the server imports this package once; each worker forks from
            # it ready to run (no effect once the server is up)
            ctx.set_forkserver_preload(["__main__", __name__])
        prev = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        workers = []
        try:
            for wid, iq in enumerate(index_queues):
                w = ctx.Process(
                    target=_worker_loop,
                    args=(self.dataset, self.collate_fn, iq, result_queue,
                          wid, self.worker_init_fn),
                    daemon=True)
                w.start()
                workers.append(w)
        except BaseException:
            _stop_workers(workers, index_queues)
            raise
        finally:
            if prev is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = prev
        return workers

    def _produce_multiprocess(self, idx_batches):
        """Batches collated by the worker pool, in order (the reference's
        ``_produce_multiprocess``).  ``idx_batches`` is read lazily: one
        more batch of indices is sent each time one is yielded."""
        import multiprocessing as mp

        n = self.num_workers
        ctx = mp.get_context(self._pick_start_method())
        index_queues = [ctx.Queue() for _ in range(n)]
        result_queue = ctx.Queue()
        workers = self._start_workers(ctx, index_queues, result_queue)
        source = iter(idx_batches)
        sent = 0

        def send_one():
            nonlocal sent
            idx = next(source, None)
            if idx is not None:
                index_queues[sent % n].put((sent, list(idx)))
                sent += 1

        def recv_one():
            """The next result, polling for dead workers (a worker killed
            by a signal or the OOM killer would otherwise hang the loader)
            and honouring ``timeout``."""
            deadline = (time.monotonic() + self.timeout
                        if self.timeout > 0 else None)
            while True:
                try:
                    return result_queue.get(timeout=0.2)
                except queue.Empty:
                    pass
                for w in workers:
                    if not w.is_alive():
                        raise RuntimeError(
                            f"DataLoader worker pid={w.pid} died with exit "
                            f"code {w.exitcode}. If this happened at start "
                            "up, the launching script probably lacks an "
                            "`if __name__ == '__main__':` guard: forkserver "
                            "and spawn workers import the main module. "
                            "Guard the script, or set "
                            "PADDLE_TPU_MP_START=fork.")
                if deadline is not None and time.monotonic() > deadline:
                    raise RuntimeError(
                        f"DataLoader worker timed out after {self.timeout}s")

        try:
            for _ in range(n * self.prefetch_factor):
                send_one()
            reorder, next_yield = {}, 0
            while next_yield < sent:
                if next_yield in reorder:
                    batch = reorder.pop(next_yield)
                    next_yield += 1
                    send_one()
                    yield batch
                    continue
                bid, payload = recv_one()
                if isinstance(payload, _WorkerError):
                    raise RuntimeError(
                        f"DataLoader worker {payload.worker_id} failed:\n"
                        f"{payload.traceback}")
                reorder[bid] = payload
        finally:
            _stop_workers(workers, index_queues)
            result_queue.cancel_join_thread()
            result_queue.close()


def _stop_workers(workers, index_queues):
    """Ask each worker to end, then end those that have not within a
    second."""
    for iq in index_queues:
        try:
            iq.put(None)
        except (OSError, ValueError):
            pass
    deadline = time.monotonic() + 1.0
    for w in workers:
        w.join(timeout=max(0.0, deadline - time.monotonic()))
        if w.is_alive():
            w.terminate()
            w.join(timeout=1.0)
    for iq in index_queues:
        iq.cancel_join_thread()
        iq.close()


def get_worker_info():
    """None, as the reference's: a worker's dataset is its own copy, and
    the loader splits no IterableDataset between workers."""
    return None
