"""Activations of the port (counterpart of
``paddle_tpu/ops/activation.py``), each casting its input by the AMP
rule first and computing as the JAX function does.  The random ones
(``gumbel_softmax``, the ``RReLU`` layer's slopes) keep their arithmetic
in a plain function of the drawn noise (``*_apply``), which a test can
feed the JAX package's noise."""

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


def leaky_relu(x, negative_slope=0.01):
    (x,) = cast_inputs("leaky_relu", x)
    return torch.nn.functional.leaky_relu(x, negative_slope)


def prelu(x, weight, data_format="NCHW"):
    """``x`` where positive, ``weight * x`` else; a weight of more than
    one element is per channel (axis 1, or the last with a channel-last
    ``data_format``)."""
    x, weight = cast_inputs("prelu", x, weight)
    if weight.numel() > 1:
        shape = [1] * x.ndim
        shape[1 if data_format == "NCHW" else x.ndim - 1] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x > 0, x, weight * x)


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=False):
    """The mean slope ``(lower + upper) / 2`` below 0, as the JAX function
    computes; it ignores ``training``, which is refused here (the
    ``nn.RReLU`` layer draws its slopes while training)."""
    if training:
        from .nn_ops import ignored_by_reference
        ignored_by_reference("rrelu(training=True)")
    (x,) = cast_inputs("rrelu", x)
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


def rrelu_apply(x, slope):
    """``x`` where ``x >= 0``, ``x * slope`` else (the ``RReLU`` layer's
    training form with its drawn slopes)."""
    return torch.where(x >= 0, x, x * slope)


def elu(x, alpha=1.0):
    (x,) = cast_inputs("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    (x,) = cast_inputs("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0):
    """``max(x, 0) + alpha * expm1(min(x, 0) / alpha)``."""
    (x,) = cast_inputs("celu", x)
    return torch.clamp(x, min=0.0) + alpha * torch.expm1(
        torch.clamp(x, max=0.0) / alpha)


def log_sigmoid(x):
    (x,) = cast_inputs("log_sigmoid", x)
    return torch.nn.functional.logsigmoid(x)


def hardtanh(x, min=-1.0, max=1.0):
    (x,) = cast_inputs("hardtanh", x)
    return torch.clamp(x, min, max)


def tanhshrink(x):
    (x,) = cast_inputs("tanhshrink", x)
    return x - torch.tanh(x)


def softplus(x, beta=1.0, threshold=20.0):
    """``log1p(exp(beta * x)) / beta``, and ``x`` itself where ``beta * x >
    threshold``."""
    (x,) = cast_inputs("softplus", x)
    return torch.where(x * beta > threshold, x, torch.log1p(torch.exp(
        beta * torch.clamp(x, max=threshold / beta))) / beta)


def softsign(x):
    (x,) = cast_inputs("softsign", x)
    return x / (1.0 + x.abs())


def softshrink(x, threshold=0.5):
    (x,) = cast_inputs("softshrink", x)
    return torch.where(x > threshold, x - threshold, torch.where(
        x < -threshold, x + threshold, torch.zeros_like(x)))


def hardshrink(x, threshold=0.5):
    (x,) = cast_inputs("hardshrink", x)
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def mish(x):
    """``x * tanh(softplus(x))``."""
    (x,) = cast_inputs("mish", x)
    return x * torch.tanh(torch.nn.functional.softplus(x))


def tanh(x):
    (x,) = cast_inputs("tanh", x)
    return torch.tanh(x)


def _as_dtype(x, dtype):
    if dtype is None:
        return x
    from ..nn.layer import to_torch_dtype
    return x.to(to_torch_dtype(dtype))


def softmax(x, axis=-1, dtype=None):
    (x,) = cast_inputs("softmax", x)
    return torch.softmax(_as_dtype(x, dtype), dim=axis)


def log_softmax(x, axis=-1, dtype=None):
    (x,) = cast_inputs("log_softmax", x)
    return torch.log_softmax(_as_dtype(x, dtype), dim=axis)


def gumbel_softmax_apply(x, gumbel, temperature=1.0, hard=False, axis=-1):
    """``softmax((x + gumbel) / temperature)``; with ``hard`` the one-hot
    of its argmax forward and the soft gradient backward."""
    y = torch.softmax((x + gumbel) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    """Softmax of ``x`` plus Gumbel noise drawn from the port's generator
    of ``x``'s device (the JAX package draws its own: compare by
    distribution, or through :func:`gumbel_softmax_apply`)."""
    from ..framework import random as _random
    (x,) = cast_inputs("gumbel_softmax", x)
    u = torch.rand(x.shape, generator=_random.default_generator(x.device),
                   device=x.device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny))).to(x.dtype)
    return gumbel_softmax_apply(x, g, temperature, hard, axis)


def glu(x, axis=-1):
    """``a * sigmoid(b)`` of ``x``'s two halves along ``axis``."""
    (x,) = cast_inputs("glu", x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1):
    """The max over each run of ``groups`` consecutive channels of
    ``axis`` (``C / groups`` channels out)."""
    (x,) = cast_inputs("maxout", x)
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return x.reshape(shape).amax(dim=axis + 1)


def thresholded_relu(x, threshold=1.0, value=0.0):
    (x,) = cast_inputs("thresholded_relu", x)
    return torch.where(x > threshold, x, torch.full_like(x, value))


#: the JAX module's functions, which the JAX package exports at its top
#: level; ``ops/__init__.py`` registers their ``Tensor``-level forms
TOP_LEVEL = ("relu", "relu6", "leaky_relu", "prelu", "rrelu", "elu", "selu",
             "celu", "gelu", "silu", "swish", "hardswish", "sigmoid",
             "log_sigmoid", "hardsigmoid", "hardtanh", "tanhshrink",
             "softplus", "softsign", "softshrink", "hardshrink", "mish",
             "tanh", "softmax", "log_softmax", "gumbel_softmax", "glu",
             "maxout", "thresholded_relu")
