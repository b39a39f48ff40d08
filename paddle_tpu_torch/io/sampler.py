# Copied from paddle_tpu/io/sampler.py (the port imports nothing of the JAX
# package); the numpy draws are the same, so one np.random.seed gives the
# same index streams. Only DistributedBatchSampler's defaults differ.
"""Samplers (reference ``python/paddle/fluid/dataloader/batch_sampler.py``,
``sampler.py``; DistributedBatchSampler
``python/paddle/fluid/dataloader/dataloader_iter.py`` + ``distributed/...``)."""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "Sampler",
    "SequenceSampler",
    "RandomSampler",
    "WeightedRandomSampler",
    "BatchSampler",
    "DistributedBatchSampler",
    "SubsetRandomSampler",
]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            yield from np.random.randint(0, n, self.num_samples).tolist()
        else:
            yield from np.random.permutation(n)[: self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray([float(w) for w in weights])
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples, replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1, drop_last=False):
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

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
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the index space across data-parallel ranks (reference
    ``python/paddle/io/DistributedBatchSampler``). ``num_replicas`` and
    ``rank`` default to 1 and 0 until the port has its distributed
    package."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        # the port has no distributed package yet (ROADMAP.md A8): one
        # process is one replica of rank 0, what the JAX package's
        # get_world_size / get_rank give in one process
        num_replicas = 1 if num_replicas is None else num_replicas
        rank = 0 if rank is None else rank
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        # pad so every rank sees the same count
        if self.total_size > n:
            indices = np.concatenate([indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank : self.total_size : self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size
