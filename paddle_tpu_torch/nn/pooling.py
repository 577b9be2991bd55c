"""Pooling layers (counterpart of ``paddle_tpu/nn/pooling.py``); the
arithmetic is ``ops/nn_ops.py``'s (Paddle's ``exclusive`` and the JAX
``ceil_mode``, held against the JAX functions)."""

from __future__ import annotations

from ..ops import nn_ops
from .layer import Layer


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.max_pool2d(x, self.kernel_size, self.stride,
                                 self.padding, self.ceil_mode,
                                 self.return_mask, self.data_format)


class AvgPool2D(Layer):
    """``exclusive=True`` (the default) divides by the count of real
    elements in a padded window (torch's ``count_include_pad=False``)."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.exclusive, self.divisor_override = exclusive, divisor_override
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.avg_pool2d(x, self.kernel_size, self.stride,
                                 self.padding, self.ceil_mode,
                                 self.exclusive, self.divisor_override,
                                 self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.adaptive_avg_pool2d(x, self.output_size,
                                          self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return nn_ops.adaptive_max_pool2d(x, self.output_size,
                                          self.return_mask)
