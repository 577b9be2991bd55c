"""Activations of the port (counterpart of the zoo's part of
``paddle_tpu/ops/activation.py``), each casting its input by the AMP
rule first and computing as the JAX function does."""

from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs


def relu(x):
    (x,) = cast_inputs("relu", x)
    return torch.relu(x)


def relu6(x):
    """``clip(x, 0, 6)``."""
    (x,) = cast_inputs("relu6", x)
    return torch.nn.functional.relu6(x)


def hardswish(x):
    """``x * clip(x + 3, 0, 6) / 6``."""
    (x,) = cast_inputs("hardswish", x)
    return torch.nn.functional.hardswish(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5):
    """``clip(slope * x + offset, 0, 1)`` with Paddle's slope 0.1666667
    (not 1/6) and offset 0.5."""
    (x,) = cast_inputs("hardsigmoid", x)
    return torch.clamp(x * slope + offset, 0.0, 1.0)


def swish(x):
    """``x * sigmoid(x)``."""
    (x,) = cast_inputs("swish", x)
    return torch.nn.functional.silu(x)


def sigmoid(x):
    (x,) = cast_inputs("sigmoid", x)
    return torch.sigmoid(x)


def gelu(x, approximate=False):
    """``x * Phi(x)``: the exact erf form by default, the tanh form with
    ``approximate=True`` (``jax.nn.gelu(x, approximate)``)."""
    (x,) = cast_inputs("gelu", x)
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate
                                    else "none")


def silu(x):
    """``x * sigmoid(x)``."""
    (x,) = cast_inputs("silu", x)
    return torch.nn.functional.silu(x)
