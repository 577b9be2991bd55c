"""Normalisation layers (counterpart of ``paddle_tpu/nn/norm.py``):
LayerNorm, the BatchNorms (1-, 2- and 3-D, the legacy one, and
``SyncBatchNorm``, the JAX package's alias), RMSNorm, GroupNorm,
InstanceNorm1D/2D/3D, LocalResponseNorm and SpectralNorm; the
arithmetic is ``ops/nn_ops.py``'s."""

from __future__ import annotations

import math

import torch

from .. import resolve_device
from ..framework import random as _random
from ..ops import activation as _act
from ..ops import nn_ops
from . import initializer as I
from .layer import Layer


def _affine_params(shape, weight_attr, bias_attr, device, generator):
    """The weight (from 1) and bias (from 0) of a norm, each left out
    (None) when its attr is False."""
    weight = None if weight_attr is False else I.make_parameter(
        shape, weight_attr, I.Constant(1.0), device, generator)
    bias = None if bias_attr is False else I.make_parameter(
        shape, bias_attr, I.Constant(0.0), device, generator, is_bias=True)
    return weight, bias


class LayerNorm(Layer):
    """Normalisation over the trailing ``normalized_shape`` dims with the
    JAX package's mixed-precision contract: statistics and the affine
    step in fp32, the output in the input's dtype.  Under AMP O2 the
    norm's weight and bias stay fp32 while the activations are bf16, so
    a bf16 activation leaves the norm as bf16 and the next matmul stays
    in bf16.  Paddle's signature: ``weight_attr`` / ``bias_attr`` an
    initializer or a ``ParamAttr`` (False leaves the weight or bias
    out).  ``device=None`` means the card; pass ``device="cpu"`` for
    the CPU."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight, self.bias = _affine_params(
            self.normalized_shape, weight_attr, bias_attr, device, generator)

    def forward(self, x):
        return nn_ops.layer_norm(x, self.normalized_shape, self.weight,
                                 self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={list(self.normalized_shape)}"


class _BatchNormBase(Layer):
    """BatchNorm over the channel axis, 1 (channel-first layouts only)
    with the JAX layer's contract (``ops/nn_ops.py::batch_norm``):
    fp32 statistics, the output in the input's dtype, Paddle's momentum
    (``running = momentum * running + (1 - momentum) * batch``, the
    unbiased variance).  The running statistics are the buffers
    ``_mean`` and ``_variance``, named as the JAX layer's so state-dict
    keys match one to one, and updated in place while training: a
    captured training step bakes their addresses in.  The weight starts
    at 1 and the bias at 0 (``weight_attr`` / ``bias_attr``: an
    initializer, or False to leave it out).  ``use_global_stats``
    normalises by the running statistics in training mode too."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight, self.bias = _affine_params(
            (num_features,), weight_attr, bias_attr, device, generator)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x):
        training = self.training and not self._use_global_stats
        return nn_ops.batch_norm(x, self._mean, self._variance, self.weight,
                                 self.bias, training, self._momentum,
                                 self._epsilon, self._data_format)

    def extra_repr(self):
        return f"num_features={self._num_features}"


class BatchNorm(_BatchNormBase):
    """Paddle's legacy ``nn.BatchNorm``: ``act`` ("relu", "relu6",
    "sigmoid", ...) applied to the output."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False, *,
                 device=None, generator=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats,
                         device=device, generator=generator)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        return getattr(_act, self._act)(out) if self._act else out


class BatchNorm1D(_BatchNormBase):
    """Over ``[N, C]`` or ``[N, C, L]``."""


class BatchNorm2D(_BatchNormBase):
    """Over ``[N, C, H, W]``."""


class BatchNorm3D(_BatchNormBase):
    """Over ``[N, C, D, H, W]`` (the channel axis 1)."""


class SyncBatchNorm(_BatchNormBase):
    """The JAX package's alias of BatchNorm: the statistics are the local
    batch's (on every rank of a world too, as the JAX alias keeps them),
    and ``convert_sync_batchnorm`` returns the layer as it is."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        return layer


class RMSNorm(Layer):
    """``x / rms(x) * weight`` over the last dim, the weight from 1."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = I.make_parameter((hidden_size,), weight_attr,
                                       I.Constant(1.0),
                                       resolve_device(device), generator)

    def forward(self, x):
        return nn_ops.rms_norm(x, self.weight, epsilon=self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, generator=None):
        super().__init__()
        nn_ops._nchw_only(data_format)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight, self.bias = _affine_params(
            (num_channels,), weight_attr, bias_attr, resolve_device(device),
            generator)

    def forward(self, x):
        return nn_ops.group_norm(x, self._num_groups, self.weight, self.bias,
                                 self._epsilon, self._data_format)


class InstanceNorm2D(Layer):
    """Per sample and channel over the spatial dims, with no running
    statistics (nor does the JAX layer keep any: ``momentum`` is read by
    neither).  ``weight_attr=False, bias_attr=False`` leaves the affine
    out, CycleGAN's norm.  The JAX layer normalises the trailing dims
    whatever ``data_format`` says; a channel-last one is refused."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, generator=None):
        super().__init__()
        nn_ops._nchw_only(data_format)
        self._epsilon = epsilon
        self.weight, self.bias = _affine_params(
            (num_features,), weight_attr, bias_attr, resolve_device(device),
            generator)

    def forward(self, x):
        return nn_ops.instance_norm(x, self.weight, self.bias,
                                    self._epsilon)


class InstanceNorm1D(InstanceNorm2D):
    """Over ``[N, C, L]``."""


class InstanceNorm3D(InstanceNorm2D):
    """Over ``[N, C, D, H, W]``."""


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        nn_ops._nchw_only(data_format)
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return nn_ops.local_response_norm(x, self.size, self.alpha,
                                          self.beta, self.k)


def power_iteration(mat, u, v, iters, eps):
    """``iters`` rounds of ``v = normalize(mat^T u)``, ``u =
    normalize(mat v)`` (the norm plus ``eps`` below), as the JAX
    package's spectral norms run them; returns ``(u, v)``."""
    for _ in range(iters):
        v = mat.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return u, v


def unit_normal(n, eps, device, generator):
    """A Normal(0, 1) vector of ``n`` from ``generator`` (the port's of
    ``device`` when None) divided by its norm plus ``eps``: the starting
    ``u`` / ``v`` of a spectral norm (the JAX package draws its own, so
    tests carry them across)."""
    gen = generator if generator is not None else \
        _random.default_generator(device)
    u = torch.empty(n, device=device).normal_(generator=gen)
    return u / (torch.linalg.vector_norm(u) + eps)


class SpectralNorm(Layer):
    """``forward(weight)`` is ``weight / (sigma + epsilon)``, ``sigma``
    the leading singular value of ``weight`` as a ``[shape[dim], -1]``
    matrix estimated by ``power_iters`` rounds of power iteration from
    the buffers ``weight_u`` / ``weight_v`` (Miyato et al. 2018).  The
    gradient runs through the iteration, as in the JAX layer.  The
    buffers advance, in place, on every forward in training mode and
    stay in eval mode."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self._dim = int(dim)
        self._power_iters = int(power_iters)
        self._epsilon = float(epsilon)
        self._shape = list(weight_shape)
        if not self._shape:
            raise ValueError("SpectralNorm needs a non-scalar weight")
        self._h = int(self._shape[self._dim])
        self._w = math.prod(self._shape) // self._h
        self.register_buffer("weight_u", unit_normal(
            self._h, self._epsilon, device, generator))
        self.register_buffer("weight_v", unit_normal(
            self._w, self._epsilon, device, generator))

    def forward(self, x):
        nd = len(self._shape)
        perm = [self._dim] + [i for i in range(nd) if i != self._dim]
        mat = x.permute(perm).reshape(self._h, self._w)
        u, v = power_iteration(mat, self.weight_u.clone(),
                               self.weight_v.clone(), self._power_iters,
                               self._epsilon)
        sigma = u @ mat @ v
        if self.training:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        out = (mat / (sigma + self._epsilon)).reshape(
            [self._shape[i] for i in perm])
        return out.permute([perm.index(i) for i in range(nd)])
