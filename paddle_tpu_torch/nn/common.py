"""Common layers (counterpart of ``paddle_tpu/nn/common.py``): Linear,
Embedding, the dropouts, Identity, Flatten / Unflatten, the pads, the
upsampling and rearranging layers, Fold / Unfold, CosineSimilarity and
Bilinear.

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
from ..ops import manipulation as M
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
            (out_features,), bias_attr, I.Constant(0.0), device, generator,
            is_bias=True)

    def forward(self, x):
        return nn_ops.linear(x, self.weight, self.bias)


class Embedding(Layer):
    """Table lookup with Paddle's signature (``num_embeddings,
    embedding_dim, padding_idx=None, sparse=False, weight_attr=None``):
    the table from Normal(0, 1), or ``weight_attr``'s initializer; a
    negative ``padding_idx`` counts from the end; that row starts at 0
    and the output is 0 wherever the id is ``padding_idx``, so the row's
    gradient is 0, as the JAX layer's lookup does.  ``sparse=True``
    gives the table a sparse row gradient, eagerly and in a ``Model``
    prepared with ``jit=False`` (``ops/nn_ops.py::embedding``).  The
    models' own initialisation passes ``init_std``: the table from
    Normal(0, ``init_std``) instead."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, init_std=None,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self._sparse = bool(sparse)
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
        return nn_ops.embedding(ids, self.weight, self._padding_idx,
                                self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """Paddle's dropout (``ops/nn_ops.py::dropout``): while training,
    zero each element with probability ``p`` (one draw shared along the
    dims not in ``axis`` when it is given) and scale the rest by ``1 /
    (1 - p)`` (``upscale_in_train``), or leave them and scale by ``1 -
    p`` in eval mode (``downscale_in_infer``).  The mask comes from the
    port's generator of the tensor's device."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = float(p), axis, mode

    def forward(self, x):
        return nn_ops.dropout(x, self.p, self.axis, self.training, self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    """Whole channels of ``[N, C, H, W]`` dropped while training."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return nn_ops.dropout2d(x, self.p, self.training, self.data_format)


class Dropout3D(Layer):
    """Whole channels of ``[N, C, D, H, W]`` dropped while training."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return nn_ops.dropout3d(x, self.p, self.training, self.data_format)


class AlphaDropout(Layer):
    """SELU's dropout (``ops/nn_ops.py::alpha_dropout``) while training."""

    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return nn_ops.alpha_dropout(x, self.p, self.training)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return M.flatten(x, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    """Dim ``axis`` of the input split into ``shape``."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, list(shape)

    def forward(self, x):
        full = list(x.shape)
        ax = self.axis % len(full)
        return M.reshape(x, full[:ax] + self.shape + full[ax + 1:])


class _Pad(Layer):
    """``ops/manipulation.py::pad`` with a fixed ``padding`` (Paddle's
    last-dims-first list, or an int for every side), ``mode`` and
    ``value``."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return M.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Pad1D(_Pad):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_Pad):
    """CycleGAN's ``Pad2D(3, mode="reflect")`` before its 7x7
    convolutions."""


class Pad3D(_Pad):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_Pad):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Upsample(Layer):
    """``ops/nn_ops.py::interpolate`` with fixed arguments;
    ``align_corners=True`` and a linear mode's ``align_mode=1`` are
    refused, as the function refuses them (the JAX resize reads
    neither)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        nn_ops.check_alignment(mode, align_corners, align_mode)
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.interpolate(x, self.size, self.scale_factor,
                                  self.mode, self.align_corners,
                                  data_format=self.data_format)


class _Upsampling2D(Layer):
    _mode = None

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__()
        _nchw_layer(self, data_format)
        self.size, self.scale_factor = size, scale_factor

    def forward(self, x):
        return nn_ops.interpolate(x, self.size, self.scale_factor,
                                  self._mode)


class UpsamplingBilinear2D(_Upsampling2D):
    """Half-pixel bilinear resize, which is what the JAX layer computes:
    it passes ``align_corners=True`` to an ``interpolate`` that ignores
    it, so neither package gives Paddle's corner-aligned resize here
    (ROADMAP C, the reference behaviours)."""

    _mode = "bilinear"


class UpsamplingNearest2D(_Upsampling2D):
    _mode = "nearest"


def _nchw_layer(layer, data_format):
    """The JAX rearranging layers drop ``data_format`` and compute NCHW:
    a channel-last one is refused."""
    if data_format != "NCHW":
        nn_ops.ignored_by_reference(
            f"{type(layer).__name__}(data_format={data_format!r})")


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        _nchw_layer(self, data_format)
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return nn_ops.pixel_shuffle(x, self.upscale_factor)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        _nchw_layer(self, data_format)
        self.downscale_factor = downscale_factor

    def forward(self, x):
        return nn_ops.pixel_unshuffle(x, self.downscale_factor)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        _nchw_layer(self, data_format)
        self.groups = groups

    def forward(self, x):
        return nn_ops.channel_shuffle(x, self.groups)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self._cfg = dict(kernel_sizes=kernel_sizes, strides=strides,
                         paddings=paddings, dilations=dilations)

    def forward(self, x):
        return M.unfold(x, **self._cfg)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1,
                 paddings=0, dilations=1, name=None):
        super().__init__()
        self._cfg = dict(output_sizes=output_sizes,
                         kernel_sizes=kernel_sizes, strides=strides,
                         paddings=paddings, dilations=dilations)

    def forward(self, x):
        return nn_ops.fold(x, **self._cfg)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return nn_ops.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(Layer):
    """``out[b, o] = x1[b]^T W[o] x2[b] + bias``: the weight ``[out, in1,
    in2]`` from ``XavierNormal`` over those dims and the bias ``[1,
    out]`` from 0, as the JAX layer makes them."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = I.make_parameter(
            (out_features, in1_features, in2_features), weight_attr,
            I.XavierNormal(), device, generator)
        self.bias = None if bias_attr is False else I.make_parameter(
            (1, out_features), bias_attr, I.Constant(0.0), device,
            generator, is_bias=True)

    def forward(self, x1, x2):
        return nn_ops.bilinear(x1, x2, self.weight, self.bias)
