"""Linear, Embedding, Dropout and Identity layers (counterpart of
``paddle_tpu/nn/common.py``).

``Linear`` keeps Paddle's weight layout ``[in_features, out_features]``
and computes ``x @ W + b``, so a weight carries over from the JAX
package as it is.  Weights start in fp32 (``amp.decorate`` casts them
later) and are drawn from an explicit ``torch.Generator``, by default
the port's generator of the device.  ``device=None`` means the card
(:func:`~paddle_tpu_torch.resolve_device`); pass ``device="cpu"`` for
the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..framework import random as _random
from ..ops import nn_ops
from . import initializer as I
from .param_attr import Parameter


def _normal(shape, std, device, generator):
    gen = generator if generator is not None else \
        _random.default_generator(device)
    w = torch.empty(shape, device=device, dtype=torch.float32)
    w.normal_(0.0, std, generator=gen)
    return Parameter(w)


class Linear(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` ``[in, out]`` and Paddle's
    signature: the weight from ``XavierNormal`` and the bias from 0
    unless ``weight_attr`` / ``bias_attr`` give an initializer;
    ``bias_attr=False`` leaves the bias out.  The models' own
    initialisation passes ``init_std``: the weight from Normal(0,
    ``init_std``) instead."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, init_std=None, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        if init_std is not None:
            self.weight = _normal((in_features, out_features), init_std,
                                  device, generator)
        else:
            self.weight = I.make_parameter(
                (in_features, out_features), weight_attr, I.XavierNormal(),
                device, generator)
        self.bias = None if bias_attr is False else I.make_parameter(
            (out_features,), bias_attr, I.Constant(0.0), device, generator)

    def forward(self, x):
        return nn_ops.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """Table lookup; the table starts as Normal(0, ``init_std``)."""

    def __init__(self, num_embeddings, embedding_dim, init_std,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
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


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x
