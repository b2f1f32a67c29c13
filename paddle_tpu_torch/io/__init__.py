"""paddle.io subset (port of paddle_tpu/io/__init__.py): ``Dataset``,
``TensorDataset``, ``SequenceSampler``, ``RandomSampler``,
``BatchSampler``, ``default_collate_fn`` and a single-process
``DataLoader``.

Batches are collated on the host as CPU tensors; the training engine
moves them to the card.  Shuffling draws from an explicit
``torch.Generator``: the caller's, or one seeded from the framework
generator (framework/random.py), so ``paddle_tpu_torch.seed()`` fixes the
order as ``paddle.seed()`` does in the reference.  Not ported yet
(ROADMAP.md): worker processes (``num_workers > 0``), the buffered
prefetch thread, the placement hook, ``IterableDataset`` and the other
samplers and datasets.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import random as _random


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


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


def _seeded_generator():
    """A CPU generator seeded from the framework generator's stream."""
    s = torch.empty((), dtype=torch.int64).random_(
        generator=_random.default_generator())
    return torch.Generator().manual_seed(int(s))


class RandomSampler(Sampler):
    """A permutation from ``generator``; each epoch's ``iter()`` continues
    its stream, so epochs differ."""

    def __init__(self, data_source, generator=None):
        super().__init__(data_source)
        self.generator = generator if generator is not None \
            else _seeded_generator()

    def __iter__(self):
        return iter(torch.randperm(len(self.data_source),
                                   generator=self.generator).tolist())

    def __len__(self):
        return len(self.data_source)


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
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.tensor(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.tensor(np.asarray(batch, np.float32))
    return batch


class DataLoader:
    """Batches of ``dataset`` through a ``BatchSampler`` and
    ``collate_fn``, in the calling process."""

    def __init__(self, dataset, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, generator=None):
        if num_workers:
            raise NotImplementedError(
                "DataLoader worker processes are not ported yet "
                "(num_workers must be 0)")
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last, generator=generator)
            self.batch_size = batch_size

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        for idx_batch in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in idx_batch])
