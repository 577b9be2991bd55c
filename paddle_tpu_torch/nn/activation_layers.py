"""Activation layers (counterpart of
``paddle_tpu/nn/activation_layers.py``), over ``ops/activation.py``."""

from __future__ import annotations

import torch

from .. import resolve_device
from ..framework import random as _random
from ..ops import activation as A
from . import initializer as I
from .layer import Layer


def _make(name, fn):
    class _Act(Layer):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            # positional args map onto the op's extra params in order
            self._args, self._kwargs = args, kwargs

        def forward(self, x):
            return fn(x, *self._args, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _make("ReLU", A.relu)
ReLU6 = _make("ReLU6", A.relu6)
LeakyReLU = _make("LeakyReLU", A.leaky_relu)
ELU = _make("ELU", A.elu)
SELU = _make("SELU", A.selu)
CELU = _make("CELU", A.celu)
GELU = _make("GELU", A.gelu)
Silu = _make("Silu", A.silu)
Swish = _make("Swish", A.swish)
Hardswish = _make("Hardswish", A.hardswish)
Sigmoid = _make("Sigmoid", A.sigmoid)
LogSigmoid = _make("LogSigmoid", A.log_sigmoid)
Hardsigmoid = _make("Hardsigmoid", A.hardsigmoid)
Hardtanh = _make("Hardtanh", A.hardtanh)
Tanh = _make("Tanh", A.tanh)
Tanhshrink = _make("Tanhshrink", A.tanhshrink)
Softplus = _make("Softplus", A.softplus)
Softsign = _make("Softsign", A.softsign)
Softshrink = _make("Softshrink", A.softshrink)
Hardshrink = _make("Hardshrink", A.hardshrink)
Mish = _make("Mish", A.mish)
ThresholdedReLU = _make("ThresholdedReLU", A.thresholded_relu)
Maxout = _make("Maxout", A.maxout)
GLU = _make("GLU", A.glu)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return A.softmax(x, axis=self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return A.log_softmax(x, axis=self.axis)


class PReLU(Layer):
    """``x`` where positive, ``weight * x`` else; ``num_parameters`` 1
    (one slope) or the channel count, the weight from ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None,
                 generator=None):
        super().__init__()
        self._data_format = data_format
        self.weight = I.make_parameter((num_parameters,), weight_attr,
                                       I.Constant(init),
                                       resolve_device(device), generator)

    def forward(self, x):
        return A.prelu(x, self.weight, self._data_format)


class Softmax2D(Layer):
    """Softmax over the channel dim of ``[N, C, H, W]`` (or ``[C, H,
    W]``)."""

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError("Softmax2D expects a 3D/4D input")
        return A.softmax(x, axis=-3)


class RReLU(Layer):
    """Randomized leaky ReLU: while training each negative element's
    slope is drawn from U[lower, upper] (the port's generator of the
    tensor's device; ``ops.activation.rrelu_apply`` takes given slopes),
    in eval mode the mean slope."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        if not self.training:
            return A.leaky_relu(x, (self.lower + self.upper) / 2.0)
        slope = torch.empty(x.shape, device=x.device).uniform_(
            self.lower, self.upper,
            generator=_random.default_generator(x.device))
        return A.rrelu_apply(x, slope.to(x.dtype))
