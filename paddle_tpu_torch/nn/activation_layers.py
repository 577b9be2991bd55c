"""Activation layers (counterpart of
``paddle_tpu/nn/activation_layers.py``): the ones the vision zoo uses,
over ``ops/activation.py``."""

from __future__ import annotations

from ..ops import activation as A
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
Hardswish = _make("Hardswish", A.hardswish)
Hardsigmoid = _make("Hardsigmoid", A.hardsigmoid)
Swish = _make("Swish", A.swish)
Sigmoid = _make("Sigmoid", A.sigmoid)
GELU = _make("GELU", A.gelu)
Silu = _make("Silu", A.silu)
