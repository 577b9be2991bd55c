"""Datasets (counterpart of ``paddle_tpu/io/dataset.py``)."""

from __future__ import annotations


class Dataset:
    """Map-style dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


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
