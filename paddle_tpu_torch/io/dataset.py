"""Datasets (counterpart of ``paddle_tpu/io/dataset.py``).

``random_split`` draws from an explicit ``torch.Generator`` (default:
the port's CPU generator); the JAX package draws from numpy's global
state, so the two split differently from one seed.
"""

from __future__ import annotations

import bisect
import threading

import torch

from ..framework import random as _random


class Dataset:
    """Map-style dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    """A stream of samples: ``__iter__``.  Under a loader with workers,
    each worker iterates it with :func:`get_worker_info` set, so a
    dataset that shards by it splits the stream."""

    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Samples are the ``idx``-th rows of equally long arrays or
    tensors."""

    def __init__(self, tensors):
        lengths = {t.shape[0] for t in tensors}
        if len(lengths) != 1:
            raise ValueError(f"tensors must share dim 0, got {lengths}")
        self.tensors = list(tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Sample ``idx`` of each dataset, fields concatenated."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if any(len(d) != len(self.datasets[0]) for d in self.datasets):
            raise ValueError("ComposeDataset needs datasets of one length")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    """The iterable datasets one after another."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    """The map-style datasets end to end."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        s = 0
        for d in self.datasets:
            s += len(d)
            self.cumulative_sizes.append(s)

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
    """Disjoint :class:`Subset` s of ``lengths`` (counts, or fractions
    that sum to 1), from one permutation drawn from ``generator``."""
    n = len(dataset)
    if all(isinstance(l, float) for l in lengths):
        lengths = [int(round(l * n)) for l in lengths]
        lengths[-1] = n - sum(lengths[:-1])
    if sum(lengths) != n:
        raise ValueError(f"lengths {lengths} do not sum to {n}")
    gen = generator if generator is not None else \
        _random.default_generator("cpu")
    perm = torch.randperm(n, generator=gen).tolist()
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l]))
        offset += l
    return out


# -- worker context ---------------------------------------------------------

class WorkerInfo:
    """Identity of the current DataLoader worker: ``id``,
    ``num_workers`` and ``dataset``."""

    def __init__(self, id: int, num_workers: int, dataset=None):
        self.id = int(id)
        self.num_workers = int(num_workers)
        self.dataset = dataset

    def __repr__(self):
        return (f"WorkerInfo(id={self.id}, "
                f"num_workers={self.num_workers})")


_WORKER_TLS = threading.local()


def _set_worker_info(info) -> None:
    _WORKER_TLS.info = info


def get_worker_info():
    """None outside a worker; a :class:`WorkerInfo` inside a DataLoader
    worker thread (thread-local, since the workers are threads)."""
    return getattr(_WORKER_TLS, "info", None)
