"""LayerNorm and BatchNorm (counterpart of ``paddle_tpu/nn/norm.py`` and
``paddle_tpu/ops/nn_ops.py::layer_norm`` / ``batch_norm_*``)."""

from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..amp.auto_cast import cast_inputs
from ..ops import activation as _act
from ..ops import nn_ops
from . import initializer as I
from .layer import Layer
from .param_attr import Parameter


class LayerNorm(Layer):
    """Normalisation over the trailing ``normalized_shape`` dims with the
    JAX package's mixed-precision contract: statistics and the affine
    step in fp32, the output in the input's dtype.  Under AMP O2 the
    norm's weight and bias stay fp32 while the activations are bf16, so
    a bf16 activation leaves the norm as bf16 and the next matmul stays
    in bf16.  ``device=None`` means the card; pass ``device="cpu"`` for
    the CPU."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None):
        super().__init__()
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = Parameter(torch.ones(self.normalized_shape,
                                           device=device))
        self.bias = Parameter(torch.zeros(self.normalized_shape,
                                          device=device))

    def forward(self, x):
        (x,) = cast_inputs("layer_norm", x)
        out = torch.nn.functional.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.epsilon)
        return out.to(x.dtype)


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
        self.weight = None if weight_attr is False else I.make_parameter(
            (num_features,), weight_attr, I.Constant(1.0), device,
            generator)
        self.bias = None if bias_attr is False else I.make_parameter(
            (num_features,), bias_attr, I.Constant(0.0), device, generator)
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
