"""DataLoader (counterpart of ``paddle_tpu/io/dataloader.py``): batches
of a map-style dataset, collated on the host into torch tensors.

Shuffling draws from an explicit ``torch.Generator`` (default: the
port's CPU generator).  When a card is present every batch lands in
page-locked host memory, so the model's ``tensor.to(device,
non_blocking=True)`` copy runs asynchronously.
Worker processes (``num_workers > 0``) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework import random as _random
from .dataset import Dataset


def default_collate_fn(batch):
    """Stack samples: arrays and tensors along a new dim 0, Python ints
    as int64, floats as float32; tuples and lists field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.as_tensor(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.as_tensor(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(f))
                            for f in zip(*batch))
    return torch.as_tensor(np.asarray(batch))


def _pin(batch):
    if isinstance(batch, torch.Tensor):
        return batch.pin_memory()
    if isinstance(batch, (list, tuple)):
        return type(batch)(_pin(b) for b in batch)
    return batch


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size=1, shuffle=False,
                 drop_last=False, num_workers=0, generator=None):
        if num_workers:
            raise NotImplementedError(
                "DataLoader worker processes are not ported yet (ROADMAP "
                "queue A, item 7: io worker processes); use "
                "num_workers=0")
        if batch_size is None or int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.generator = generator
        self.pin_memory = torch.cuda.is_available()

    def _order(self):
        n = len(self.dataset)
        if not self.shuffle:
            return range(n)
        gen = (self.generator if self.generator is not None
               else _random.default_generator("cpu"))
        return torch.randperm(n, generator=gen).tolist()

    def __iter__(self):
        order = list(self._order())
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            batch = default_collate_fn([self.dataset[i] for i in idx])
            yield _pin(batch) if self.pin_memory else batch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)
