"""Synthetic images (counterpart of
``paddle_tpu/vision/datasets/synthetic.py``): ImageNet-shaped samples
from one buffer rolled per index, as the JAX package makes them."""

from __future__ import annotations

import numpy as np

from ...io.dataset import Dataset


class SyntheticImages(Dataset):
    def __init__(self, num_samples=1280, image_shape=(3, 224, 224),
                 num_classes=1000, seed=0, dtype=np.float32):
        self.n = num_samples
        self.shape = tuple(image_shape)
        self.num_classes = num_classes
        rng = np.random.RandomState(seed)
        # one shared buffer + per-index shift: O(1) memory
        self._base = rng.rand(*self.shape).astype(dtype)
        self._labels = rng.randint(0, num_classes, size=num_samples
                                   ).astype(np.int64)

    def __getitem__(self, idx):
        img = np.roll(self._base, idx % 16, axis=-1)
        return img, np.asarray([self._labels[idx]], dtype=np.int64)

    def __len__(self):
        return self.n
