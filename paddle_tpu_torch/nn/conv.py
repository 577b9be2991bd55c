"""Convolution layers (counterpart of ``paddle_tpu/nn/conv.py``): 1-, 2-
and 3-D convolutions with Paddle's weight layout ``[out, in/groups,
*k]`` (torch's OI...), and the transposed ones with ``[in, out/groups,
*k]`` (torch's layout too), so a weight carries over from the JAX
package as it is.  ``device=None`` means the card; pass ``device="cpu"``
for the CPU."""

from __future__ import annotations

import math

from .. import resolve_device
from ..ops import nn_ops
from ..ops.nn_ops import _pair
from . import initializer as I
from .layer import Layer


class _ConvNd(Layer):
    """What every convolution layer holds: the weight from
    ``KaimingUniform(fan_in)`` with ``fan_in = in/groups * prod(k)``
    (the JAX ``_ConvBase``'s, for the transposed layers too) and the
    bias from 0 unless ``weight_attr`` / ``bias_attr`` give an
    initializer; ``bias_attr=False`` leaves the bias out.  A
    ``padding_mode`` other than "zeros" is refused: the JAX layers take
    it and pad with zeros whatever it says."""

    _nd = 2
    _transpose = False

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, output_padding=0, *, device,
                 generator):
        super().__init__()
        if padding_mode != "zeros":
            nn_ops.ignored_by_reference(
                f"{type(self).__name__}(padding_mode={padding_mode!r})")
        nn_ops._nchw_only(data_format)
        device = resolve_device(device)
        nd = self._nd
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _pair(kernel_size, nd)
        self._stride = _pair(stride, nd)
        self._padding = padding
        self._dilation = _pair(dilation, nd)
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        shape = ((in_channels, out_channels // groups) if self._transpose
                 else (out_channels, in_channels // groups))
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        self.weight = I.make_parameter(
            shape + self._kernel_size, weight_attr,
            I.KaimingUniform(fan_in=fan_in), device, generator)
        if bias_attr is not False:
            self.bias = I.make_parameter((out_channels,), bias_attr,
                                         I.Constant(0.0), device, generator,
                                         is_bias=True)
        else:
            self.bias = None

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}, "
                f"padding={self._padding}")


class Conv1D(_ConvNd):
    _nd = 1

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return nn_ops.conv1d(x, self.weight, self.bias, self._stride,
                             self._padding, self._dilation, self._groups)


class Conv2D(_ConvNd):
    """``groups`` (depthwise when it equals the channels), ``dilation``,
    ``padding`` an int, a pair, a ``[top, bottom, left, right]`` list or
    "SAME"/"VALID"."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return nn_ops.conv2d(x, self.weight, self.bias, self._stride,
                             self._padding, self._dilation, self._groups,
                             self._data_format)


class Conv3D(_ConvNd):
    """Over ``[N, C, D, H, W]``; R(2+1)D's (1, 3, 3) and (3, 1, 1)
    factored kernels are this layer's."""

    _nd = 3

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)

    def forward(self, x):
        return nn_ops.conv3d(x, self.weight, self.bias, self._stride,
                             self._padding, self._dilation, self._groups)


class Conv2DTranspose(_ConvNd):
    """Positional order ``(..., padding, output_padding, dilation,
    groups, ...)``, the JAX layer's (the 1-D and 3-D ones put ``groups``
    before ``dilation``); ``forward(x, output_size=None)``."""

    _transpose = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding,
                         device=device, generator=generator)

    def forward(self, x, output_size=None):
        return nn_ops.conv2d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._dilation, self._groups, output_size)


class Conv1DTranspose(_ConvNd):
    _nd = 1
    _transpose = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding,
                         device=device, generator=generator)

    def forward(self, x, output_size=None):
        return nn_ops.conv1d_transpose(
            x, self.weight, self.bias, self._stride[0], self._padding,
            self._output_padding, self._dilation[0], self._groups,
            output_size)


class Conv3DTranspose(_ConvNd):
    _nd = 3
    _transpose = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=None, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, output_padding,
                         device=device, generator=generator)

    def forward(self, x, output_size=None):
        return nn_ops.conv3d_transpose(
            x, self.weight, self.bias, self._stride, self._padding,
            self._output_padding, self._dilation, self._groups,
            output_size)
