"""Pooling layers (counterpart of ``paddle_tpu/nn/pooling.py``); the
arithmetic is ``ops/nn_ops.py``'s (Paddle's ``exclusive`` and the JAX
``ceil_mode``, held against the JAX functions).  Where a JAX layer
takes an argument and never passes it on (``MaxPool2D``'s and
``AdaptiveMaxPool2D``'s ``return_mask``, ``MaxPool1D``'s ``return_mask``
and ``ceil_mode``, ``AvgPool1D``'s ``ceil_mode``, a 3-D layer's
channel-last ``data_format``), the port refuses it rather than ignore it."""

from __future__ import annotations

from ..ops import nn_ops
from .layer import Layer


class MaxPool2D(Layer):
    """The JAX layer takes ``return_mask`` and never passes it on (the
    function ``max_pool2d(return_mask=True)`` returns the mask): it is
    refused here."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        if return_mask:
            nn_ops.ignored_by_reference("MaxPool2D(return_mask=True)")
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.ceil_mode = padding, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return nn_ops.max_pool2d(x, self.kernel_size, self.stride,
                                 self.padding, self.ceil_mode,
                                 data_format=self.data_format)


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


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, name=None):
        super().__init__()
        for arg, on in (("return_mask", return_mask),
                        ("ceil_mode", ceil_mode)):
            if on:
                nn_ops.ignored_by_reference(f"MaxPool1D({arg}=True)")
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding

    def forward(self, x):
        return nn_ops.max_pool1d(x, self.kernel_size, self.stride,
                                 self.padding)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        if ceil_mode:
            nn_ops.ignored_by_reference("AvgPool1D(ceil_mode=True)")
        self.kernel_size, self.stride, self.padding = \
            kernel_size, stride, padding
        self.exclusive = exclusive

    def forward(self, x):
        return nn_ops.avg_pool1d(x, self.kernel_size, self.stride,
                                 self.padding, self.exclusive)


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
        if return_mask:
            nn_ops.ignored_by_reference(
                "AdaptiveMaxPool2D(return_mask=True)")
        self.output_size = output_size

    def forward(self, x):
        return nn_ops.adaptive_max_pool2d(x, self.output_size)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return nn_ops.adaptive_avg_pool1d(x, self.output_size)


class _Pool3D(Layer):
    """The 3-D layers pool axes 2-4 whatever ``data_format`` says in the
    JAX package; a channel-last one is refused (ROADMAP item 2)."""

    def __init__(self, data_format):
        super().__init__()
        nn_ops._nchw_only(data_format)


class MaxPool3D(_Pool3D):
    def __init__(self, kernel_size, stride=None, padding=0,
                 ceil_mode=False, return_mask=False,
                 data_format="NCDHW", name=None):
        super().__init__(data_format)
        self._cfg = dict(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         return_mask=return_mask)

    def forward(self, x):
        return nn_ops.max_pool3d(x, **self._cfg)


class AvgPool3D(_Pool3D):
    def __init__(self, kernel_size, stride=None, padding=0,
                 ceil_mode=False, exclusive=True, divisor_override=None,
                 data_format="NCDHW", name=None):
        super().__init__(data_format)
        self._cfg = dict(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive,
                         divisor_override=divisor_override)

    def forward(self, x):
        return nn_ops.avg_pool3d(x, **self._cfg)


class AdaptiveAvgPool3D(_Pool3D):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(data_format)
        self._output_size = output_size

    def forward(self, x):
        return nn_ops.adaptive_avg_pool3d(x, self._output_size)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._output_size = output_size
        self._return_mask = return_mask

    def forward(self, x):
        return nn_ops.adaptive_max_pool1d(x, self._output_size,
                                          return_mask=self._return_mask)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._output_size = output_size
        self._return_mask = return_mask

    def forward(self, x):
        return nn_ops.adaptive_max_pool3d(x, self._output_size,
                                          return_mask=self._return_mask)


class _MaxUnPoolNd(Layer):
    """The inverse of a max pool with ``return_mask=True``:
    ``forward(x, indices)``."""

    _default_format = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format=None, output_size=None, name=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.output_size = padding, output_size
        self.data_format = data_format or self._default_format

    def forward(self, x, indices):
        return self._fn(x, indices, self.kernel_size, self.stride,
                        self.padding, data_format=self.data_format,
                        output_size=self.output_size)


class MaxUnPool1D(_MaxUnPoolNd):
    _fn = staticmethod(nn_ops.max_unpool1d)
    _default_format = "NCL"


class MaxUnPool2D(_MaxUnPoolNd):
    _fn = staticmethod(nn_ops.max_unpool2d)
    _default_format = "NCHW"


class MaxUnPool3D(_MaxUnPoolNd):
    _fn = staticmethod(nn_ops.max_unpool3d)
    _default_format = "NCDHW"
