"""Comparison, logical and bitwise ops (counterpart of
``paddle_tpu/ops/logic.py``): functions on torch tensors, registered as
``Tensor``-level ops by ``_primitive.primitive``.  A Python scalar
operand takes the tensor's dtype, as JAX's weak typing does."""

from __future__ import annotations

import torch

from ._primitive import primitive
from .math import _pair


def _binary(name, fn):
    def op(x, y, name=None):
        x, y = _pair(x, y)
        return fn(x, y)
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = f"``{name}`` elementwise, broadcasting."
    return primitive(op)


equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
logical_and = _binary("logical_and", torch.logical_and)
logical_or = _binary("logical_or", torch.logical_or)
logical_xor = _binary("logical_xor", torch.logical_xor)
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)
bitwise_left_shift = _binary("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = _binary("bitwise_right_shift",
                              torch.bitwise_right_shift)


@primitive
def logical_not(x, name=None):
    return torch.logical_not(x)


@primitive
def bitwise_not(x, name=None):
    return torch.bitwise_not(x)


@primitive
def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)
