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

from .. import resolve_device
from ..framework import random as _random
from ..ops import nn_ops
from . import initializer as I
from .layer import Layer
from .param_attr import Parameter


def _normal(shape, std, device, generator):
    gen = generator if generator is not None else \
        _random.default_generator(device)
    w = torch.empty(shape, device=device, dtype=torch.float32)
    w.normal_(0.0, std, generator=gen)
    return Parameter(w)


class Linear(Layer):
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


class Embedding(Layer):
    """Table lookup with Paddle's signature (``num_embeddings,
    embedding_dim, padding_idx=None, sparse=False, weight_attr=None``):
    the table from Normal(0, 1), or ``weight_attr``'s initializer; a
    negative ``padding_idx`` counts from the end; that row starts at 0
    and the output is 0 wherever the id is ``padding_idx``, so the row
    gets no gradient, as the JAX layer's lookup does.  The models' own
    initialisation passes ``init_std``: the table from Normal(0,
    ``init_std``) instead."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, init_std=None,
                 device=None, generator=None):
        super().__init__()
        if sparse:
            raise NotImplementedError(
                "Embedding(sparse=True) (SelectedRows gradients) is not "
                "ported yet (ROADMAP queue A, item 8: the rest of nn)")
        device = resolve_device(device)
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        shape = (num_embeddings, embedding_dim)
        if init_std is not None:
            self.weight = _normal(shape, init_std, device, generator)
        else:
            self.weight = I.make_parameter(shape, weight_attr,
                                           I.Normal(0.0, 1.0), device,
                                           generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, ids):
        out = torch.nn.functional.embedding(ids, self.weight)
        if self._padding_idx is not None:
            out = out.masked_fill((ids == self._padding_idx).unsqueeze(-1),
                                  0.0)
        return out

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """Paddle's ``upscale_in_train`` dropout: while training, zero each
    element with probability ``p`` and scale the rest by
    ``1 / (1 - p)``; identity in eval mode or at ``p == 0``.  The mask
    comes from the port's generator of the tensor's device.  ``axis``
    and ``downscale_in_infer`` are refused (``nn_ops.dropout_refusals``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        nn_ops.dropout_refusals(axis, mode)
        self.p = float(p)

    def forward(self, x):
        return nn_ops.dropout(x, self.p, training=self.training)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x
