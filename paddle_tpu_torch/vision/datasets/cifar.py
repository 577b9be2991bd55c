"""Cifar10/100 (counterpart of
``paddle_tpu/vision/datasets/cifar.py``): the python-pickle tar
archive where given, else the JAX package's deterministic synthetic
images, array for array.  ``download=True`` fetches nothing."""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import Optional

import numpy as np

from ...framework import env_knobs
from ...io.dataset import Dataset


def _synthetic_cifar(n, num_classes, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(np.int64)
    images = rng.rand(n, 3, 32, 32).astype(np.float32) * 0.2
    for i in range(n):
        c = labels[i]
        images[i, c % 3, (c // 3) % 4 * 8:(c // 3) % 4 * 8 + 8] += 0.6
    return np.clip(images, 0, 1), labels


class Cifar10(Dataset):
    NUM_CLASSES = 10

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 transform=None, download: bool = True, backend="cv2"):
        self.mode = mode
        self.transform = transform
        if data_file and os.path.exists(data_file):
            self._load_archive(data_file)
        else:
            n = 50000 if mode == "train" else 10000
            n = int(env_knobs.get_raw("PADDLE_TORCH_SYNTH_N", n))
            self.images, self.labels = _synthetic_cifar(
                n, self.NUM_CLASSES, seed=0 if mode == "train" else 1)

    def _load_archive(self, path):
        images, labels = [], []
        with tarfile.open(path) as tf:
            names = [m for m in tf.getmembers()
                     if ("data_batch" in m.name if self.mode == "train"
                         else "test_batch" in m.name)]
            for m in sorted(names, key=lambda m: m.name):
                d = pickle.load(tf.extractfile(m), encoding="bytes")
                images.append(d[b"data"].reshape(-1, 3, 32, 32))
                key = b"labels" if b"labels" in d else b"fine_labels"
                labels.extend(d[key])
        self.images = (np.concatenate(images).astype(np.float32) / 255.0)
        self.labels = np.asarray(labels, dtype=np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], dtype=np.int64)

    def __len__(self):
        return len(self.labels)


class Cifar100(Cifar10):
    NUM_CLASSES = 100
