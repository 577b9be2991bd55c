"""Linear, Embedding and Dropout layers (counterpart of
``paddle_tpu/nn/common.py``).

``Linear`` keeps Paddle's weight layout ``[in_features, out_features]``
and computes ``x @ W + b``, so a weight carries over from the JAX
package as it is.  Weights start in fp32 (``amp.decorate`` casts them
later) and are drawn from an explicit ``torch.Generator``, by default
the port's generator of the device.
"""

from __future__ import annotations

import torch
from torch import nn

from ..framework import random as _random


def _normal(shape, std, device, generator):
    gen = generator if generator is not None else \
        _random.default_generator(device)
    w = torch.empty(shape, device=device, dtype=torch.float32)
    w.normal_(0.0, std, generator=gen)
    return nn.Parameter(w)


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` ``[in, out]`` drawn from
    Normal(0, ``init_std``) and the bias starting at 0."""

    def __init__(self, in_features, out_features, init_std, device="cpu",
                 generator=None):
        super().__init__()
        self.weight = _normal((in_features, out_features), init_std, device,
                              generator)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        return torch.matmul(x, self.weight) + self.bias


class Embedding(nn.Module):
    """Table lookup; the table starts as Normal(0, ``init_std``)."""

    def __init__(self, num_embeddings, embedding_dim, init_std,
                 device="cpu", generator=None):
        super().__init__()
        self.weight = _normal((num_embeddings, embedding_dim), init_std,
                              device, generator)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)


class Dropout(nn.Module):
    """Paddle's ``upscale_in_train`` dropout: while training, zero each
    element with probability ``p`` and scale the rest by
    ``1 / (1 - p)``; identity in eval mode or at ``p == 0``.  The mask
    comes from the port's generator of the tensor's device."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        gen = _random.default_generator(x.device)
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))
