"""Initializers (counterpart of ``paddle_tpu/nn/initializer.py``): the
ones the port's layers default to.  Each is called with the shape, the
device and a ``torch.Generator`` (None: the port's generator of the
device) and returns an fp32 tensor.  Fans follow Paddle's layouts: a
2-D weight is ``[in, out]``, a conv weight ``[out, in/groups, *k]``.
The JAX package draws with threefry and the port with Philox, so the
two give other numbers from one seed (``framework/random.py``)."""

from __future__ import annotations

import math

import torch

from ..framework import random as _random
from .param_attr import Parameter, ParamAttr

#: on inside ``nn.LazyGuard``: parameters start as zeros placeholders
_LAZY_INIT = {"on": False}


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _empty(shape, device):
    return torch.empty(tuple(shape), dtype=torch.float32, device=device)


def _gen(generator, device):
    return generator if generator is not None else \
        _random.default_generator(device)


class Initializer:
    def __call__(self, shape, device, generator=None) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def __call__(self, shape, device, generator=None):
        return torch.full(tuple(shape), self.value, dtype=torch.float32,
                          device=device)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, shape, device, generator=None):
        return _empty(shape, device).normal_(
            self.mean, self.std, generator=_gen(generator, device))


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = float(low), float(high)

    def __call__(self, shape, device, generator=None):
        return _empty(shape, device).uniform_(
            self.low, self.high, generator=_gen(generator, device))


class TruncatedNormal(Initializer):
    """Normal(``mean``, ``std``) cut at ``a`` and ``b`` standard
    deviations from the mean (the JAX initializer draws a standard
    normal cut at ``[a, b]``, then scales and shifts it)."""

    def __init__(self, mean: float = 0.0, std: float = 1.0, a=-2.0, b=2.0):
        self.mean, self.std = float(mean), float(std)
        self.a, self.b = float(a), float(b)

    def __call__(self, shape, device, generator=None):
        return torch.nn.init.trunc_normal_(
            _empty(shape, device), self.mean, self.std,
            self.mean + self.a * self.std, self.mean + self.b * self.std,
            generator=_gen(generator, device))


class XavierNormal(Initializer):
    """Normal(0, gain * sqrt(2 / (fan_in + fan_out)))."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, device, generator=None):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _empty(shape, device).normal_(
            0.0, std, generator=_gen(generator, device))


class KaimingUniform(Initializer):
    """Uniform(-limit, limit), ``limit = gain * sqrt(3 / fan_in)`` with
    ``gain = sqrt(2 / (1 + negative_slope^2))`` for relu / leaky_relu,
    else 1."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, device, generator=None):
        fi, _ = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        gain = (math.sqrt(2.0 / (1 + self.negative_slope ** 2))
                if self.nonlinearity in ("relu", "leaky_relu") else 1.0)
        limit = gain * math.sqrt(3.0 / fi)
        return _empty(shape, device).uniform_(
            -limit, limit, generator=_gen(generator, device))


def make_parameter(shape, attr, default, device, generator=None):
    """A :class:`~paddle_tpu_torch.nn.param_attr.Parameter` of ``shape``
    (fp32) from ``attr`` (``ParamAttr._to_attr``: None, a name, an
    initializer or a ``ParamAttr``): drawn by its initializer, else by
    ``default``; named, scaled and regularized as it says, as
    ``paddle_tpu/nn/layer.py::create_parameter`` does.  Under
    ``nn.LazyGuard`` the value is zeros and the initializer waits
    for ``Layer.apply_deferred_init``."""
    attr = ParamAttr._to_attr(attr)
    init = attr.initializer if attr.initializer is not None else default
    lazy = _LAZY_INIT["on"]
    value = (torch.zeros(tuple(shape), dtype=torch.float32, device=device)
             if lazy else init(shape, device, generator))
    p = Parameter(value, requires_grad=bool(attr.trainable), name=attr.name)
    if lazy:
        # nn.LazyGuard: drawn later by Layer.apply_deferred_init
        p._deferred_init = (init, generator)
    p.optimize_attr["learning_rate"] = attr.learning_rate
    p.regularizer = attr.regularizer
    return p


def create_parameter(shape, attr=None, is_bias=False,
                     default_initializer=None, *, device, generator=None):
    """``Layer.create_parameter``: an fp32 parameter of ``shape`` from
    ``attr`` (:func:`make_parameter`), drawn by its initializer, else by
    ``default_initializer``, else 0 for a bias and ``XavierNormal``
    otherwise."""
    default = default_initializer if default_initializer is not None else (
        Constant(0.0) if is_bias else XavierNormal())
    return make_parameter(shape, attr, default, device, generator)
