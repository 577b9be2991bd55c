"""Initializers (counterpart of ``paddle_tpu/nn/initializer.py``): all
twelve of the JAX module, its lower-case aliases, ``calculate_gain``
and ``set_global_initializer``.  Each is called with the shape, the
device and a ``torch.Generator`` (None: the port's generator of the
device) and returns an fp32 tensor.  Fans follow Paddle's layouts: a
2-D weight is ``[in, out]``, a conv weight ``[out, in/groups, *k]``.
The JAX package draws with threefry and the port with Philox, so the
random ones give other numbers from one seed (``framework/random.py``);
``Constant``, ``Assign``, ``Dirac`` and ``Bilinear`` draw nothing and
give the JAX values exactly.

Every parameter a layer of the port makes goes through
:func:`make_parameter`, which picks its initializer as the JAX
``Layer.create_parameter`` does: the ``ParamAttr``'s initializer, else
the global default of :func:`set_global_initializer` (the weight's or
the bias's), else the layer's own default."""

from __future__ import annotations

import math

import numpy as np
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


def _kaiming_gain(negative_slope, nonlinearity):
    return (math.sqrt(2.0 / (1 + negative_slope ** 2))
            if nonlinearity in ("relu", "leaky_relu") else 1.0)


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
        limit = _kaiming_gain(self.negative_slope,
                              self.nonlinearity) * math.sqrt(3.0 / fi)
        return _empty(shape, device).uniform_(
            -limit, limit, generator=_gen(generator, device))


class XavierUniform(Initializer):
    """Uniform(-limit, limit), ``limit = gain * sqrt(6 / (fan_in +
    fan_out))``."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, device, generator=None):
        fi, fo = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _empty(shape, device).uniform_(
            -limit, limit, generator=_gen(generator, device))


class KaimingNormal(Initializer):
    """Normal(0, gain / sqrt(fan_in)), the gain as
    :class:`KaimingUniform`'s."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, device, generator=None):
        fi, _ = _fan_in_out(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        std = _kaiming_gain(self.negative_slope,
                            self.nonlinearity) / math.sqrt(fi)
        return _empty(shape, device).normal_(
            0.0, std, generator=_gen(generator, device))


class Assign(Initializer):
    """The given value (an array, a list or a tensor) as fp32, which must
    have the parameter's shape."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, device, generator=None):
        v = self.value
        out = (v.detach().to(device=device, dtype=torch.float32)
               if isinstance(v, torch.Tensor) else
               torch.as_tensor(np.asarray(v, np.float32), device=device))
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"Assign shape {tuple(out.shape)} != "
                             f"{tuple(shape)}")
        return out.clone()


class Orthogonal(Initializer):
    """``gain`` times a matrix with orthonormal rows or columns, laid out
    as ``jax.nn.initializers.orthogonal`` lays it: the last axis is the
    columns, every other axis the rows."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, device, generator=None):
        shape = tuple(shape)
        if len(shape) < 2:
            raise ValueError("Orthogonal needs a shape of two dims or more, "
                             f"got {shape}")
        cols = shape[-1]
        rows = math.prod(shape) // cols
        a = _empty((max(rows, cols), min(rows, cols)), device).normal_(
            generator=_gen(generator, device))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.t()
        return (self.gain * q).reshape(shape).contiguous()


class Dirac(Initializer):
    """A conv weight ``[out, in, *k]`` that passes channels through: 1 at
    the kernel's centre of ``(i, i % in)`` for ``i < min(out, in *
    groups)``, 0 elsewhere."""

    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, shape, device, generator=None):
        out = np.zeros(tuple(shape), np.float32)
        oc, ic = shape[0], shape[1]
        centre = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + centre] = 1.0
        return torch.as_tensor(out, device=device)


class Bilinear(Initializer):
    """The bilinear upsampling filter of a square ``[out, in, K, K]``
    transposed-conv weight, on every channel pair (upstream
    ``nn.initializer.Bilinear``, as the JAX package fills it)."""

    def __call__(self, shape, device, generator=None):
        if len(shape) != 4:
            raise ValueError(
                f"Bilinear initializer needs a 4-D conv weight, got "
                f"shape {list(shape)}")
        c_out, c_in, kh, kw = (int(s) for s in shape)
        if kh != kw:
            raise ValueError("Bilinear initializer needs square kernels")
        f = math.ceil(kh / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        og = np.ogrid[:kh, :kw]
        filt = ((1 - abs(og[0] / f - c))
                * (1 - abs(og[1] / f - c))).astype(np.float32)
        w = np.broadcast_to(filt, (c_out, c_in, kh, kw)).copy()
        return torch.as_tensor(w, device=device)


# Paddle's functional-style names
constant = Constant
normal = Normal
uniform = Uniform


def calculate_gain(nonlinearity: str, param=None) -> float:
    """The recommended gain of ``nonlinearity`` (tanh 5/3, relu sqrt(2),
    leaky_relu sqrt(2 / (1 + a^2)) with ``a = param`` or 0.01, selu 3/4,
    anything else 1)."""
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    return 1.0


_GLOBAL_INIT = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None) -> None:
    """The initializers of every weight and bias made after this call
    that has no ``ParamAttr`` initializer, over each layer's own default
    (upstream ``nn.initializer.set_global_initializer``); ``None,
    None`` resets."""
    _GLOBAL_INIT["weight"] = weight_init
    _GLOBAL_INIT["bias"] = bias_init


def make_parameter(shape, attr, default, device, generator=None,
                   is_bias=False):
    """A :class:`~paddle_tpu_torch.nn.param_attr.Parameter` of ``shape``
    (fp32) from ``attr`` (``ParamAttr._to_attr``: None, a name, an
    initializer or a ``ParamAttr``): drawn by its initializer, else by
    the global default for a weight (``is_bias`` False) or a bias, else
    by ``default``; named, scaled and regularized as it says, as
    ``paddle_tpu/nn/layer.py::create_parameter`` does.  Under
    ``nn.LazyGuard`` the value is zeros and the initializer waits
    for ``Layer.apply_deferred_init``."""
    attr = ParamAttr._to_attr(attr)
    init = attr.initializer
    if init is None:
        init = _GLOBAL_INIT["bias" if is_bias else "weight"]
    if init is None:
        init = default
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
    return make_parameter(shape, attr, default, device, generator, is_bias)
