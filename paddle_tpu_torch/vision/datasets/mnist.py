"""MNIST (counterpart of ``paddle_tpu/vision/datasets/mnist.py``): the
idx-ubyte files under ``PADDLE_DATASET_HOME`` where present, else the
JAX package's deterministic synthetic digits, array for array.
``download=True`` fetches nothing.  Without ``PADDLE_DATASET_HOME``
(or explicit paths) the synthetic digits are used; nothing else
around the checkout is read."""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from ...framework import env_knobs
from ...io.dataset import Dataset


def _load_idx_images(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(n, rows, cols)


def _load_idx_labels(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(), dtype=np.uint8)


def _synthetic_mnist(n, seed):
    """Deterministic class-separable synthetic digits: class k = blob at a
    k-dependent position — learnable by LeNet, so loss-goes-down tests
    are meaningful."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    images = rng.rand(n, 28, 28).astype(np.float32) * 0.15
    ys = (labels % 5) * 5 + 2
    xs = (labels // 5) * 12 + 6
    for i in range(n):
        y, x = ys[i], xs[i]
        images[i, y:y + 6, x:x + 6] += 0.8
    return np.clip(images, 0, 1), labels


class MNIST(Dataset):
    NAME = "mnist"

    def __init__(self, image_path: Optional[str] = None,
                 label_path: Optional[str] = None, mode: str = "train",
                 transform=None, download: bool = True,
                 backend: str = "cv2"):
        self.mode = mode
        self.transform = transform
        root = os.environ.get("PADDLE_DATASET_HOME")
        base = os.path.join(root, self.NAME) if root else None
        split = "train" if mode == "train" else "t10k"
        img = image_path or (base and os.path.join(
            base, f"{split}-images-idx3-ubyte.gz"))
        lbl = label_path or (base and os.path.join(
            base, f"{split}-labels-idx1-ubyte.gz"))
        if img and lbl and os.path.exists(img) and os.path.exists(lbl):
            self.images = (_load_idx_images(img).astype(np.float32) / 255.0)
            self.labels = _load_idx_labels(lbl).astype(np.int64)
        else:
            n = 60000 if mode == "train" else 10000
            n = int(env_knobs.get_raw("PADDLE_TORCH_SYNTH_N", n))
            self.images, self.labels = _synthetic_mnist(
                n, seed=0 if mode == "train" else 1)

    def __getitem__(self, idx):
        img = self.images[idx][None, :, :]  # CHW, C=1
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], dtype=np.int64)

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"
