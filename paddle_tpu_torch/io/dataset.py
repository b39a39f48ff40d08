# Copied unchanged from paddle_tpu/io/dataset.py: it needs no jax, and the port
# imports nothing of the JAX package.
"""Datasets (reference ``python/paddle/fluid/dataloader/dataset.py``)."""
from __future__ import annotations

import bisect

import numpy as np

__all__ = [
    "Dataset",
    "IterableDataset",
    "TensorDataset",
    "ComposeDataset",
    "ChainDataset",
    "ConcatDataset",
    "Subset",
    "random_split",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        n = len(tensors[0])
        assert all(len(t) == n for t in tensors), "tensors must share dim 0"
        self.tensors = tensors

    def __getitem__(self, index):
        return tuple(t[index] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        assert all(len(d) == n for d in self.datasets)

    def __getitem__(self, index):
        out = []
        for d in self.datasets:
            sample = d[index]
            out.extend(sample if isinstance(sample, (list, tuple)) else [sample])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    perm = np.random.permutation(len(dataset))
    out, off = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[off : off + ln].tolist()))
        off += ln
    return out
