"""Samplers (counterpart of ``paddle_tpu/io/sampler.py``).

Every random draw comes from an explicit ``torch.Generator`` (default:
the port's CPU generator, which ``paddle.seed`` seeds).  The JAX
samplers draw from numpy's global state, so shuffled orders differ
between the packages from one seed; sequential orders are the same.

``DistributedBatchSampler`` keeps the upstream contract: pad to a
multiple of the replicas, shard by rank, ``set_epoch`` reshuffles.  Its
``rank`` and ``num_replicas`` are given explicitly until the port has a
world to read them from (ROADMAP queue A, item 10).
"""

from __future__ import annotations

import math

import torch

from ..framework import random as _random


def _gen(generator):
    return generator if generator is not None else \
        _random.default_generator("cpu")


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    """A permutation (or, with ``replacement``, uniform draws) of the
    indices, drawn from ``generator`` at each pass."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        gen = _gen(self.generator)
        if self.replacement:
            return iter(torch.randint(0, n, (self.num_samples,),
                                      generator=gen).tolist())
        return iter(torch.randperm(n, generator=gen)[:self.num_samples]
                    .tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True,
                 generator=None):
        self.weights = torch.as_tensor(weights, dtype=torch.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = generator

    def __iter__(self):
        idx = torch.multinomial(self.weights, self.num_samples,
                                self.replacement,
                                generator=_gen(self.generator))
        return iter(idx.tolist())

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


class DistributedBatchSampler(BatchSampler):
    """Batches of this rank's share of the dataset: the indices (a
    permutation drawn from a generator seeded with the epoch when
    ``shuffle``, so every rank draws the same one) padded to
    a multiple of ``num_replicas`` by repeating their head, then every
    ``num_replicas``-th from ``rank``."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        if num_replicas is None or rank is None:
            raise NotImplementedError(
                "DistributedBatchSampler needs rank= and num_replicas= "
                "until the port's distributed world is ported (ROADMAP "
                "queue A, item 10)")
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} not in [0, {num_replicas})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.nranks = int(num_replicas)
        self.local_rank = int(rank)
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            gen = torch.Generator().manual_seed(self.epoch)
            indices = torch.randperm(n, generator=gen).tolist()
        else:
            indices = list(range(n))
        # pad so every rank sees the same number of samples
        indices += indices[:(self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
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

    def set_epoch(self, epoch):
        self.epoch = epoch


class SubsetRandomSampler(Sampler):
    """A permutation of a fixed index subset, drawn at each pass."""

    def __init__(self, indices, generator=None):
        super().__init__(None)
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        order = torch.randperm(len(self.indices),
                               generator=_gen(self.generator)).tolist()
        return iter([self.indices[i] for i in order])

    def __len__(self):
        return len(self.indices)
