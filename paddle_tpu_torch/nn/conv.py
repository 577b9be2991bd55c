"""Convolution layers (counterpart of ``paddle_tpu/nn/conv.py``):
``Conv2D`` with Paddle's weight layout ``[out, in/groups, kh, kw]``,
which is torch's OIHW, so a weight carries over from the JAX package
as it is.  ``device=None`` means the card; pass ``device="cpu"`` for
the CPU."""

from __future__ import annotations

import math

from .. import resolve_device
from ..ops import nn_ops
from ..ops.nn_ops import _pair
from . import initializer as I
from .layer import Layer


class Conv2D(Layer):
    """``groups`` (depthwise when it equals the channels), ``dilation``,
    ``padding`` an int, a pair, a ``[top, bottom, left, right]`` list or
    "SAME"/"VALID"; the weight from ``KaimingUniform(fan_in)`` with
    ``fan_in = in/groups * kh * kw`` and the bias from 0 unless
    ``weight_attr`` / ``bias_attr`` give an initializer;
    ``bias_attr=False`` leaves the bias out."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"Conv2D(padding_mode={padding_mode!r}) is not ported yet "
                "(ROADMAP queue A, item 8)")
        device = resolve_device(device)
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _pair(kernel_size)
        self._stride = _pair(stride)
        self._padding = padding
        self._dilation = _pair(dilation)
        self._groups = groups
        self._data_format = data_format
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        self.weight = I.make_parameter(
            (out_channels, in_channels // groups) + self._kernel_size,
            weight_attr, I.KaimingUniform(fan_in=fan_in), device, generator)
        if bias_attr is not False:
            self.bias = I.make_parameter((out_channels,), bias_attr,
                                         I.Constant(0.0), device, generator)
        else:
            self.bias = None

    def forward(self, x):
        return nn_ops.conv2d(x, self.weight, self.bias, self._stride,
                             self._padding, self._dilation, self._groups,
                             self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")
