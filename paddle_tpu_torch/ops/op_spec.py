"""The op catalogue's specs, the port's own copy (counterpart of
``paddle_tpu/ops/op_spec.py``, of which it keeps ``OpSpec``, the input
generators, the numpy oracles and ``build_specs()``, with ``P`` the
port; the port imports nothing of the JAX package).

``chip_smoke.py``'s ``[tensor ops]`` phase runs every spec on the card
against the port on the CPU; ``tests/test_torch_op_catalogue.py`` holds
this copy equal to the JAX package's table (names, inputs, kwargs,
dtypes, tolerances), so the two cannot drift apart.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

@dataclass
class OpSpec:
    name: str                       # display/id
    fn: Callable                    # paddle-level op over Tensors
    ref: Callable                   # numpy oracle over np arrays
    inputs: Sequence[Callable]      # each: rng -> np.ndarray
    kwargs: Dict = field(default_factory=dict)
    dtypes: Tuple[str, ...] = ("float32", "bfloat16")
    check_grad: bool = True
    covers: Optional[str] = None    # OP_TABLE op this spec exercises
                                    # when fn is a lambda over it
    grad_inputs: Optional[Sequence[int]] = None  # default: all float
    fw_rtol: Dict[str, float] = field(default_factory=lambda: {
        "float32": 1e-5, "bfloat16": 2e-2, "float16": 1e-2})
    fw_atol: Dict[str, float] = field(default_factory=lambda: {
        "float32": 1e-5, "bfloat16": 2e-2, "float16": 1e-2})
    grad_atol: float = 1e-2
    grad_rtol: float = 1e-2
    grad_eps: float = 1e-3

    def __repr__(self):
        return self.name


def rand(*shape, lo=0.0, hi=1.0):
    def gen(rng):
        return (rng.rand(*shape) * (hi - lo) + lo).astype(np.float32)
    return gen


def randn(*shape, scale=1.0):
    def gen(rng):
        return (rng.randn(*shape) * scale).astype(np.float32)
    return gen


def randint(*shape, lo=0, hi=10, dtype=np.int64):
    def gen(rng):
        return rng.randint(lo, hi, size=shape).astype(dtype)
    return gen


def _np_i1(x):
    """Modified Bessel I1 oracle: truncated power series (numpy has
    i0 built in but not i1); exact to f64 precision for |x| ≲ 5."""
    import math as _m
    half = x / 2.0
    out = np.zeros_like(x)
    for k in range(30):
        out = out + half ** (2 * k + 1) / (
            _m.factorial(k) * _m.factorial(k + 1))
    return out


def randbool(*shape):
    def gen(rng):
        return rng.rand(*shape) > 0.5
    return gen


# --- oracle helpers -------------------------------------------------------
def np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def np_softmax(x, axis=-1):
    e = np.exp(x - np.max(x, axis=axis, keepdims=True))
    return e / np.sum(e, axis=axis, keepdims=True)


def np_erf(x):
    # Abramowitz–Stegun 7.1.26, enough for 1e-5
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741)
                * t - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return sign * y


def _spd(rng, n):
    a = rng.randn(n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _renorm_ref(a, p, axis, maxn):
    reduce_axes = tuple(i for i in range(a.ndim) if i != axis)
    norms = np.sum(np.abs(a) ** p, axis=reduce_axes,
                   keepdims=True) ** (1.0 / p)
    factor = np.where(norms > maxn, maxn / (norms + 1e-7),
                      np.ones_like(norms))
    return a * factor


def _index_fill_ref(a, i, v):
    out = a.copy()
    out[i] = v
    return out




def build_specs():
    """The op table: name, paddle fn, numpy oracle, inputs, tolerances."""
    import paddle_tpu_torch as paddle
    P = paddle
    FP32 = ("float32",)

    specs = [
        # ---- binary elementwise ----
        OpSpec("add", P.add, lambda a, b: a + b, [randn(3, 4), randn(3, 4)]),
        OpSpec("add_bcast", P.add, lambda a, b: a + b,
               [randn(3, 4), randn(4)]),
        OpSpec("subtract", P.subtract, lambda a, b: a - b,
               [randn(3, 4), randn(3, 4)]),
        OpSpec("multiply", P.multiply, lambda a, b: a * b,
               [randn(3, 4), randn(3, 4)]),
        OpSpec("divide", P.divide, lambda a, b: a / b,
               [randn(3, 4), rand(3, 4, lo=0.5, hi=1.5)]),
        OpSpec("maximum", P.maximum, np.maximum, [randn(3, 4), randn(3, 4)],
               grad_atol=5e-2),
        OpSpec("minimum", P.minimum, np.minimum, [randn(3, 4), randn(3, 4)],
               grad_atol=5e-2),
        OpSpec("fmax", P.fmax, np.fmax, [randn(3, 4), randn(3, 4)],
               check_grad=False),
        OpSpec("fmin", P.fmin, np.fmin, [randn(3, 4), randn(3, 4)],
               check_grad=False),
        OpSpec("pow", lambda x: P.pow(x, 3.0), lambda a: a ** 3.0,
               [rand(3, 4, lo=0.5, hi=1.5)]),
        OpSpec("elementwise_pow", P.elementwise_pow, lambda a, b: a ** b,
               [rand(3, 4, lo=0.5, hi=2.0), rand(3, 4, lo=0.5, hi=2.0)]),
        OpSpec("atan2", P.atan2, np.arctan2,
               [rand(3, 4, lo=0.2, hi=1.0), rand(3, 4, lo=0.2, hi=1.0)]),
        OpSpec("hypot", P.hypot, np.hypot,
               [rand(3, lo=0.5), rand(3, lo=0.5)]),
        OpSpec("copysign", P.copysign, np.copysign,
               [randn(3, 4), randn(3, 4)], check_grad=False),
        OpSpec("logaddexp", P.logaddexp, np.logaddexp,
               [randn(3, 4), randn(3, 4)]),
        OpSpec("heaviside", P.heaviside,
               lambda a, b: np.heaviside(a, b),
               [randn(3, 4), rand(3, 4)], check_grad=False),
        OpSpec("remainder", P.remainder, np.mod,
               [rand(3, 4, lo=1.0, hi=5.0), rand(3, 4, lo=1.0, hi=2.0)],
               check_grad=False),
        OpSpec("floor_divide", P.floor_divide, np.floor_divide,
               [rand(3, 4, lo=1.0, hi=9.0), rand(3, 4, lo=1.0, hi=3.0)],
               check_grad=False),
        OpSpec("ldexp", P.ldexp, np.ldexp,
               [randn(3), randint(3, lo=-2, hi=3, dtype=np.int32)],
               check_grad=False),
        OpSpec("nextafter", P.nextafter, np.nextafter,
               [rand(3), rand(3)], dtypes=FP32, check_grad=False,
               fw_rtol={"float32": 1e-3}, fw_atol={"float32": 1e-3}),
        # ---- unary elementwise ----
        OpSpec("abs", P.abs, np.abs, [rand(3, 4, lo=0.2, hi=1.0)]),
        OpSpec("neg", P.neg, np.negative, [randn(3, 4)]),
        OpSpec("sign", P.sign, np.sign, [randn(3, 4)], check_grad=False),
        OpSpec("signbit", P.signbit, np.signbit, [randn(3, 4)],
               check_grad=False),
        OpSpec("exp", P.exp, np.exp, [randn(3, 4)]),
        OpSpec("expm1", P.expm1, np.expm1, [randn(3, 4)]),
        OpSpec("log", P.log, np.log, [rand(3, 4, lo=0.5, hi=2.0)]),
        OpSpec("log2", P.log2, np.log2, [rand(3, 4, lo=0.5, hi=2.0)]),
        OpSpec("log10", P.log10, np.log10, [rand(3, 4, lo=0.5, hi=2.0)]),
        OpSpec("log1p", P.log1p, np.log1p, [rand(3, 4)]),
        OpSpec("sqrt", P.sqrt, np.sqrt, [rand(3, 4, lo=0.3)]),
        OpSpec("rsqrt", P.rsqrt, lambda a: 1 / np.sqrt(a),
               [rand(3, 4, lo=0.3)]),
        OpSpec("square", P.square, np.square, [randn(3, 4)]),
        OpSpec("reciprocal", P.reciprocal, np.reciprocal,
               [rand(3, 4, lo=0.5, hi=1.5)]),
        OpSpec("floor", P.floor, np.floor, [randn(3, 4)], check_grad=False),
        OpSpec("ceil", P.ceil, np.ceil, [randn(3, 4)], check_grad=False),
        OpSpec("round", P.round, np.round, [randn(3, 4)], check_grad=False),
        OpSpec("trunc", P.trunc, np.trunc, [randn(3, 4)], check_grad=False),
        OpSpec("frac", P.frac, lambda a: a - np.trunc(a), [randn(3, 4)],
               check_grad=False),
        OpSpec("sin", P.sin, np.sin, [randn(3, 4)]),
        OpSpec("cos", P.cos, np.cos, [randn(3, 4)]),
        OpSpec("tan", P.tan, np.tan, [rand(3, 4, lo=-1.0, hi=1.0)]),
        OpSpec("asin", P.asin, np.arcsin, [rand(3, 4, lo=-0.8, hi=0.8)]),
        OpSpec("acos", P.acos, np.arccos, [rand(3, 4, lo=-0.8, hi=0.8)]),
        OpSpec("atan", P.atan, np.arctan, [randn(3, 4)]),
        OpSpec("sinh", P.sinh, np.sinh, [randn(3, 4)]),
        OpSpec("cosh", P.cosh, np.cosh, [randn(3, 4)]),
        OpSpec("tanh", P.tanh, np.tanh, [randn(3, 4)]),
        OpSpec("asinh", P.asinh, np.arcsinh, [randn(3, 4)]),
        OpSpec("acosh", P.acosh, np.arccosh, [rand(3, 4, lo=1.5, hi=3.0)]),
        OpSpec("atanh", P.atanh, np.arctanh, [rand(3, 4, lo=-0.7, hi=0.7)]),
        OpSpec("erf", P.erf, np_erf, [randn(3, 4)],
               fw_rtol={"float32": 1e-4, "bfloat16": 2e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 2e-2}),
        OpSpec("deg2rad", P.deg2rad, np.deg2rad, [randn(3, 4, scale=90)]),
        OpSpec("rad2deg", P.rad2deg, np.rad2deg, [randn(3, 4)],
               fw_rtol={"float32": 1e-4, "bfloat16": 2e-2},
               fw_atol={"float32": 1e-3, "bfloat16": 2e-1}),
        OpSpec("clip", lambda x: P.clip(x, -0.5, 0.5),
               lambda a: np.clip(a, -0.5, 0.5), [randn(3, 4)],
               grad_atol=5e-2),
        OpSpec("lerp", P.lerp,
               lambda a, b, w: a + w * (b - a),
               [randn(3, 4), randn(3, 4), rand(3, 4)]),
        OpSpec("scale", lambda x: P.scale(x, 2.0, 1.0),
               lambda a: a * 2.0 + 1.0, [randn(3, 4)]),
        # ---- activations ----
        OpSpec("relu", P.relu, lambda a: np.maximum(a, 0),
               [rand(3, 4, lo=-1, hi=1)], grad_atol=5e-2),
        OpSpec("relu6", P.relu6, lambda a: np.clip(a, 0, 6),
               [randn(3, 4, scale=3)], grad_atol=5e-2),
        OpSpec("sigmoid", P.sigmoid, np_sigmoid, [randn(3, 4)]),
        OpSpec("silu", P.silu, lambda a: a * np_sigmoid(a), [randn(3, 4)]),
        OpSpec("gelu_tanh", lambda x: P.gelu(x, approximate=True),
               lambda a: 0.5 * a * (1 + np.tanh(
                   np.sqrt(2 / np.pi) * (a + 0.044715 * a ** 3))),
               [randn(3, 4)], covers="gelu"),
        OpSpec("softplus", P.softplus, lambda a: np.log1p(np.exp(a)),
               [randn(3, 4)]),
        OpSpec("softsign", P.softsign, lambda a: a / (1 + np.abs(a)),
               [randn(3, 4)]),
        OpSpec("mish", P.mish,
               lambda a: a * np.tanh(np.log1p(np.exp(a))), [randn(3, 4)]),
        OpSpec("hardtanh", P.hardtanh, lambda a: np.clip(a, -1, 1),
               [randn(3, 4, scale=2)], grad_atol=5e-2),
        OpSpec("hardsigmoid", P.hardsigmoid,
               lambda a: np.clip(a / 6.0 + 0.5, 0, 1),
               [randn(3, 4, scale=4)],
               fw_rtol={"float32": 2e-3, "bfloat16": 3e-2},
               fw_atol={"float32": 2e-3, "bfloat16": 3e-2},
               check_grad=False),
        OpSpec("hardswish", P.hardswish,
               lambda a: a * np.clip(a + 3, 0, 6) / 6, [randn(3, 4, scale=4)],
               grad_atol=5e-2),
        OpSpec("elu", P.elu,
               lambda a: np.where(a > 0, a, np.exp(a) - 1), [randn(3, 4)]),
        OpSpec("leaky_relu", P.leaky_relu,
               lambda a: np.where(a > 0, a, 0.01 * a), [randn(3, 4)],
               grad_atol=5e-2),
        OpSpec("log_sigmoid", P.log_sigmoid,
               lambda a: -np.log1p(np.exp(-a)), [randn(3, 4)]),
        OpSpec("tanhshrink", P.tanhshrink, lambda a: a - np.tanh(a),
               [randn(3, 4)]),
        OpSpec("hardshrink", P.hardshrink,
               lambda a: np.where(np.abs(a) > 0.5, a, 0.0),
               [randn(3, 4)], check_grad=False),
        OpSpec("softshrink", P.softshrink,
               lambda a: np.where(a > 0.5, a - 0.5,
                                  np.where(a < -0.5, a + 0.5, 0.0)),
               [randn(3, 4)], check_grad=False),
        OpSpec("logit", P.logit, lambda a: np.log(a / (1 - a)),
               [rand(3, 4, lo=0.2, hi=0.8)]),
        OpSpec("softmax", lambda x: P.softmax(x, axis=-1), np_softmax,
               [randn(3, 4)]),
        OpSpec("log_softmax", lambda x: P.log_softmax(x, axis=-1),
               lambda a: np.log(np_softmax(a)), [randn(3, 4)]),
        # ---- reductions ----
        OpSpec("sum", lambda x: x.sum(), np.sum, [randn(3, 4)]),
        OpSpec("sum_axis", lambda x: P.sum(x, axis=1),
               lambda a: np.sum(a, axis=1), [randn(3, 4)]),
        OpSpec("mean", lambda x: P.mean(x, axis=0),
               lambda a: np.mean(a, axis=0), [randn(3, 4)]),
        OpSpec("max_red", lambda x: P.max(x, axis=1),
               lambda a: np.max(a, axis=1), [randn(3, 4)],
               covers="max", grad_atol=5e-2),
        OpSpec("min_red", lambda x: P.min(x, axis=1),
               lambda a: np.min(a, axis=1), [randn(3, 4)],
               covers="min", grad_atol=5e-2),
        OpSpec("prod", lambda x: P.prod(x, axis=1),
               lambda a: np.prod(a, axis=1), [rand(3, 4, lo=0.5, hi=1.5)]),
        OpSpec("std", lambda x: P.std(x, axis=1),
               lambda a: np.std(a, axis=1, ddof=1), [randn(3, 4)]),
        OpSpec("var", lambda x: P.var(x, axis=1),
               lambda a: np.var(a, axis=1, ddof=1), [randn(3, 4)]),
        OpSpec("logsumexp", lambda x: P.logsumexp(x, axis=1),
               lambda a: np.log(np.sum(np.exp(a), axis=1)), [randn(3, 4)]),
        OpSpec("amax", lambda x: P.amax(x, axis=1),
               lambda a: np.max(a, axis=1), [randn(3, 4)], check_grad=False),
        OpSpec("amin", lambda x: P.amin(x, axis=1),
               lambda a: np.min(a, axis=1), [randn(3, 4)], check_grad=False),
        OpSpec("nansum", lambda x: P.nansum(x, axis=1),
               lambda a: np.nansum(a, axis=1), [randn(3, 4)],
               check_grad=False),
        OpSpec("nanmedian", lambda x: P.nanmedian(x, axis=1),
               lambda a: np.nanmedian(a, axis=1), [randn(3, 4)],
               check_grad=False),
        OpSpec("nan_to_num", lambda x: P.nan_to_num(x, nan=1.5),
               lambda a: np.nan_to_num(a, nan=1.5), [randn(3, 4)],
               check_grad=False),
        OpSpec("cumulative_trapezoid",
               lambda x: P.cumulative_trapezoid(x, dx=0.5, axis=1),
               lambda a: np.cumsum((a[:, :-1] + a[:, 1:]) * 0.25,
                                   axis=1), [randn(3, 5)]),
        OpSpec("i0", lambda x: P.i0(x),
               lambda a: np.i0(a.astype(np.float64)).astype(a.dtype),
               [randn(3, 4)], check_grad=False),
        OpSpec("as_complex", lambda x: P.as_real(P.as_complex(x)),
               lambda a: a, [randn(3, 4, 2)], dtypes=("float32",),
               check_grad=False, covers="as_complex"),
        OpSpec("as_real", lambda x: P.as_real(P.as_complex(x)),
               lambda a: a, [randn(3, 4, 2)], dtypes=("float32",),
               check_grad=False, covers="as_real"),
        OpSpec("i1", lambda x: P.i1(x),
               lambda a: _np_i1(a.astype(np.float64)).astype(a.dtype),
               [randn(3, 4)], check_grad=False),
        OpSpec("cumsum", lambda x: P.cumsum(x, axis=1),
               lambda a: np.cumsum(a, axis=1), [randn(3, 4)]),
        OpSpec("cumprod", lambda x: P.cumprod(x, dim=1),
               lambda a: np.cumprod(a, axis=1),
               [rand(3, 4, lo=0.5, hi=1.5)]),
        OpSpec("logcumsumexp", lambda x: P.logcumsumexp(x, axis=1),
               lambda a: np.log(np.cumsum(np.exp(a), axis=1)),
               [randn(3, 4)],
               fw_rtol={"float32": 1e-4, "bfloat16": 2e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 2e-2}),
        OpSpec("diff", lambda x: P.diff(x, axis=1),
               lambda a: np.diff(a, axis=1), [randn(3, 4)]),
        OpSpec("trapezoid", P.trapezoid,
               lambda a: np.trapezoid(a) if hasattr(np, "trapezoid")
               else np.trapz(a), [randn(4)]),
        OpSpec("median", lambda x: P.median(x, axis=1),
               lambda a: np.median(a, axis=1), [randn(3, 5)],
               check_grad=False),
        OpSpec("quantile", lambda x: P.quantile(x, 0.5, axis=1),
               lambda a: np.quantile(a, 0.5, axis=1), [randn(3, 5)],
               dtypes=FP32, check_grad=False),
        OpSpec("nanquantile", lambda x: P.nanquantile(x, 0.5, axis=1),
               lambda a: np.nanquantile(a, 0.5, axis=1), [randn(3, 5)],
               dtypes=FP32, check_grad=False),
        # ---- manipulation ----
        OpSpec("reshape", lambda x: P.reshape(x, [4, 3]),
               lambda a: np.reshape(a, (4, 3)), [randn(3, 4)]),
        OpSpec("transpose", lambda x: P.transpose(x, [1, 0]),
               lambda a: a.T, [randn(3, 4)]),
        OpSpec("flatten_op", lambda x: P.flatten(x),
               lambda a: a.reshape(-1), [randn(2, 3, 2)], covers="flatten"),
        OpSpec("squeeze", lambda x: P.squeeze(x, 1),
               lambda a: np.squeeze(a, 1), [randn(3, 1, 4)]),
        OpSpec("unsqueeze", lambda x: P.unsqueeze(x, 0),
               lambda a: a[None], [randn(3, 4)]),
        OpSpec("tile", lambda x: P.tile(x, [2, 3]),
               lambda a: np.tile(a, (2, 3)), [randn(2, 3)]),
        OpSpec("broadcast_to", lambda x: P.broadcast_to(x, [3, 4]),
               lambda a: np.broadcast_to(a, (3, 4)).copy(), [randn(4)]),
        OpSpec("flip", lambda x: P.flip(x, [0]),
               lambda a: np.flip(a, 0).copy(), [randn(3, 4)]),
        OpSpec("roll", lambda x: P.roll(x, 2, 1),
               lambda a: np.roll(a, 2, 1), [randn(3, 4)]),
        OpSpec("rot90", lambda x: P.rot90(x),
               lambda a: np.rot90(a).copy(), [randn(3, 4)]),
        OpSpec("tril", P.tril, np.tril, [randn(4, 4)]),
        OpSpec("triu", P.triu, np.triu, [randn(4, 4)]),
        OpSpec("diag", P.diag, np.diag, [randn(4)]),
        OpSpec("diagonal", lambda x: P.diagonal(x),
               lambda a: np.diagonal(a).copy(), [randn(3, 3)]),
        OpSpec("kron", P.kron, np.kron, [randn(2, 2), randn(2, 3)]),
        OpSpec("unflatten", lambda x: P.unflatten(x, 1, [2, 3]),
               lambda a: a.reshape(2, 2, 3), [randn(2, 6)]),
        OpSpec("gather", lambda x, i: P.gather(x, i, axis=0),
               lambda a, i: a[i], [randn(5, 3), randint(4, lo=0, hi=5)]),
        OpSpec("index_select", lambda x, i: P.index_select(x, i, axis=1),
               lambda a, i: a[:, i], [randn(3, 5), randint(2, lo=0, hi=5)]),
        OpSpec("take_along_axis",
               lambda x, i: P.take_along_axis(x, i, 1),
               lambda a, i: np.take_along_axis(a, i, 1),
               [randn(3, 5), randint(3, 2, lo=0, hi=5)]),
        OpSpec("take", lambda x, i: P.take(x, i),
               lambda a, i: np.take(a, i),
               [randn(3, 4), randint(5, lo=0, hi=12)], check_grad=False),
        OpSpec("masked_fill", lambda x, m: P.masked_fill(x, m, 0.0),
               lambda a, m: np.where(m, 0.0, a),
               [randn(3, 4), randbool(3, 4)]),
        OpSpec("index_fill",
               lambda x, i: P.index_fill(x, i, 0, 7.0),
               lambda a, i: _index_fill_ref(a, i, 7.0),
               [randn(4, 3), lambda rng: np.array([1, 3])],
               check_grad=False),
        OpSpec("where", lambda c, x, y: P.where(c, x, y), np.where,
               [randbool(3, 4), randn(3, 4), randn(3, 4)]),
        OpSpec("pad", lambda x: P.pad(x, [1, 2], value=0.5),
               lambda a: np.pad(a, ((0, 0), (1, 2)),
                                constant_values=0.5), [randn(2, 3)]),
        OpSpec("one_hot", lambda x: P.one_hot(x, 5),
               lambda a: np.eye(5)[a],
               [randint(4, lo=0, hi=5)], check_grad=False),
        # ---- linalg ----
        OpSpec("matmul", P.matmul, lambda a, b: a @ b,
               [randn(3, 4), randn(4, 2)],
               fw_rtol={"float32": 1e-4, "bfloat16": 5e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 5e-2}),
        OpSpec("matmul_tt",
               lambda x, y: P.matmul(x, y, transpose_x=True,
                                     transpose_y=True),
               lambda a, b: a.T @ b.T, [randn(4, 3), randn(2, 4)],
               fw_rtol={"float32": 1e-4, "bfloat16": 5e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 5e-2}),
        OpSpec("bmm", P.bmm, lambda a, b: a @ b,
               [randn(2, 3, 4), randn(2, 4, 2)],
               fw_rtol={"float32": 1e-4, "bfloat16": 5e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 5e-2}),
        OpSpec("mv", P.mv, lambda a, b: a @ b, [randn(3, 4), randn(4)],
               fw_rtol={"float32": 1e-4, "bfloat16": 5e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 5e-2}),
        OpSpec("dot", P.dot, np.dot, [randn(5), randn(5)],
               fw_rtol={"float32": 1e-4, "bfloat16": 5e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 5e-2}),
        OpSpec("outer", P.outer, np.outer, [randn(3), randn(4)]),
        OpSpec("inner", P.inner, np.inner, [randn(3, 4), randn(2, 4)],
               fw_rtol={"float32": 1e-4, "bfloat16": 5e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 5e-2}),
        OpSpec("addmm", P.addmm,
               lambda i, a, b: i + a @ b,
               [randn(3, 2), randn(3, 4), randn(4, 2)],
               fw_rtol={"float32": 1e-4, "bfloat16": 5e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 5e-2}),
        OpSpec("trace", P.trace, np.trace, [randn(4, 4)]),
        OpSpec("norm_fro", lambda x: P.norm(x),
               lambda a: np.linalg.norm(a), [randn(3, 4)], covers="norm"),
        OpSpec("norm_1", lambda x: P.norm(x, p=1, axis=1),
               lambda a: np.sum(np.abs(a), axis=1),
               [rand(3, 4, lo=0.2, hi=1.0)]),
        OpSpec("dist", P.dist, lambda a, b: np.linalg.norm(a - b),
               [randn(3, 4), randn(3, 4)]),
        OpSpec("cdist", P.cdist,
               lambda a, b: np.sqrt(
                   np.sum((a[:, None] - b[None]) ** 2, -1) + 1e-30),
               [randn(3, 4), randn(2, 4)], dtypes=FP32),
        OpSpec("cross", lambda x, y: P.cross(x, y, axis=1),
               lambda a, b: np.cross(a, b, axis=1),
               [randn(2, 3), randn(2, 3)]),
        OpSpec("det", P.det, np.linalg.det,
               [lambda rng: (rng.randn(3, 3) +
                             3 * np.eye(3)).astype(np.float32)],
               dtypes=FP32),
        OpSpec("inverse", P.inverse, np.linalg.inv,
               [lambda rng: (rng.randn(3, 3) +
                             3 * np.eye(3)).astype(np.float32)],
               dtypes=FP32,
               fw_rtol={"float32": 1e-3}, fw_atol={"float32": 1e-3}),
        OpSpec("cholesky", P.cholesky,
               lambda a: np.linalg.cholesky(a),
               [lambda rng: _spd(rng, 3)], dtypes=FP32,
               fw_rtol={"float32": 1e-3}, fw_atol={"float32": 1e-3},
               check_grad=False),
        OpSpec("matrix_power", lambda x: P.matrix_power(x, 3),
               lambda a: np.linalg.matrix_power(a, 3),
               [lambda rng: (0.3 * rng.randn(3, 3)).astype(np.float32)],
               dtypes=FP32,
               fw_rtol={"float32": 1e-3}, fw_atol={"float32": 1e-3}),
        OpSpec("vander", lambda x: P.vander(x, 4),
               lambda a: np.vander(a, 4), [rand(4, lo=0.5, hi=1.5)],
               dtypes=FP32),
        OpSpec("renorm", lambda x: P.renorm(x, 2.0, 0, 1.0),
               lambda a: _renorm_ref(a, 2.0, 0, 1.0), [randn(3, 4)],
               dtypes=FP32,
               fw_rtol={"float32": 1e-4}, fw_atol={"float32": 1e-4}),
        # ---- losses ----
        OpSpec("mse_loss", P.mse_loss,
               lambda i, t: np.mean((i - t) ** 2),
               [randn(3, 4), randn(3, 4)]),
        OpSpec("l1_loss", P.l1_loss,
               lambda i, t: np.mean(np.abs(i - t)),
               [randn(3, 4), randn(3, 4)], grad_atol=5e-2),
        OpSpec("smooth_l1", P.smooth_l1_loss,
               lambda i, t: np.mean(np.where(
                   np.abs(i - t) < 1.0, 0.5 * (i - t) ** 2,
                   np.abs(i - t) - 0.5)),
               [randn(3, 4), randn(3, 4)]),
        OpSpec("kl_div", P.kl_div,
               lambda i, t: np.mean(t * (np.log(t) - i)),
               [randn(3, 4), rand(3, 4, lo=0.2, hi=1.0)],
               grad_inputs=[0]),
        OpSpec("bce", P.binary_cross_entropy,
               lambda i, t: -np.mean(t * np.log(i) +
                                     (1 - t) * np.log(1 - i)),
               [rand(3, 4, lo=0.1, hi=0.9), randbool(3, 4)],
               grad_inputs=[0],
               fw_rtol={"float32": 1e-4, "bfloat16": 5e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 5e-2}),
        OpSpec("bce_logits", P.binary_cross_entropy_with_logits,
               lambda i, t: np.mean(
                   np.maximum(i, 0) - i * t + np.log1p(np.exp(-np.abs(i)))),
               [randn(3, 4), randbool(3, 4)], grad_inputs=[0]),
        OpSpec("nll_loss", P.nll_loss,
               lambda i, t: -np.mean(i[np.arange(len(t)), t]),
               [randn(4, 5), randint(4, lo=0, hi=5)], grad_inputs=[0]),
        OpSpec("cross_entropy",
               lambda x, t: P.cross_entropy(x, t),
               lambda a, t: -np.mean(np.log(
                   np_softmax(a)[np.arange(len(t)), t])),
               [randn(4, 5), randint(4, lo=0, hi=5)], grad_inputs=[0]),
        # ---- nn functional ----
        OpSpec("linear", P.linear,
               lambda x, w, b: x @ w + b,
               [randn(3, 4), randn(4, 2), randn(2)],
               fw_rtol={"float32": 1e-4, "bfloat16": 5e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 5e-2}),
        OpSpec("embedding", lambda i, w: P.embedding(i, w),
               lambda i, w: w[i],
               [randint(3, 4, lo=0, hi=6), randn(6, 5)], grad_inputs=[1]),
        OpSpec("layer_norm",
               lambda x: P.layer_norm(x, [4]),
               lambda a: (a - a.mean(-1, keepdims=True)) /
               np.sqrt(a.var(-1, keepdims=True) + 1e-5),
               [randn(3, 4)],
               fw_rtol={"float32": 1e-4, "bfloat16": 3e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 3e-2}),
        OpSpec("rms_norm_f",
               lambda x, w: P.rms_norm(x, w),
               lambda a, w: a / np.sqrt(
                   np.mean(a * a, -1, keepdims=True) + 1e-6) * w,
               [randn(3, 4), rand(4, lo=0.5, hi=1.5)],
               fw_rtol={"float32": 1e-4, "bfloat16": 3e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 3e-2}),
        OpSpec("cosine_similarity", P.cosine_similarity,
               lambda a, b: np.sum(a * b, 1) /
               (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)),
               [randn(3, 4), randn(3, 4)],
               fw_rtol={"float32": 1e-4, "bfloat16": 3e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 3e-2}),
        # -- round-5 widening batch (scipy oracles for the special fns)
        OpSpec("sinc", P.sinc, lambda a: np.sinc(a), [randn(3, 4)]),
        OpSpec("sgn", P.sgn, lambda a: np.sign(a), [randn(3, 4)],
               check_grad=False),
        OpSpec("logaddexp2", P.logaddexp2,
               lambda a, b: np.logaddexp2(a, b),
               [randn(3, 4), randn(3, 4)]),
        OpSpec("gammaln", P.gammaln,
               lambda a: _scipy_sp().gammaln(a.astype(np.float64)
                                             ).astype(a.dtype),
               [rand(3, 4, lo=0.5, hi=4.0)], dtypes=("float32",)),
        OpSpec("gammainc", P.gammainc,
               lambda a, b: _scipy_sp().gammainc(
                   a.astype(np.float64), b.astype(np.float64)
               ).astype(a.dtype),
               [rand(3, 4, lo=0.5, hi=4.0), rand(3, 4, lo=0.1, hi=4.0)],
               dtypes=("float32",), check_grad=False),
        OpSpec("gammaincc", P.gammaincc,
               lambda a, b: _scipy_sp().gammaincc(
                   a.astype(np.float64), b.astype(np.float64)
               ).astype(a.dtype),
               [rand(3, 4, lo=0.5, hi=4.0), rand(3, 4, lo=0.1, hi=4.0)],
               dtypes=("float32",), check_grad=False),
        OpSpec("polygamma", lambda x: P.polygamma(x, n=1),
               lambda a: _scipy_sp().polygamma(
                   1, a.astype(np.float64)).astype(a.dtype),
               [rand(3, 4, lo=0.5, hi=4.0)], dtypes=("float32",),
               check_grad=False, covers="polygamma"),
        OpSpec("multigammaln", lambda x: P.multigammaln(x, p=2),
               lambda a: _scipy_sp().multigammaln(
                   a.astype(np.float64), 2).astype(a.dtype),
               [rand(3, 4, lo=1.5, hi=4.0)], dtypes=("float32",),
               covers="multigammaln"),
        OpSpec("i0e", P.i0e,
               lambda a: _scipy_sp().i0e(a.astype(np.float64)
                                         ).astype(a.dtype),
               [randn(3, 4)], dtypes=("float32",), check_grad=False),
        OpSpec("i1e", P.i1e,
               lambda a: _scipy_sp().i1e(a.astype(np.float64)
                                         ).astype(a.dtype),
               [randn(3, 4)], dtypes=("float32",), check_grad=False),
        OpSpec("positive", P.positive, lambda a: +a, [randn(3, 4)]),
        OpSpec("pdist", P.pdist,
               lambda a: _np_pdist(a), [randn(5, 3)],
               fw_rtol={"float32": 1e-4, "bfloat16": 3e-2},
               fw_atol={"float32": 1e-4, "bfloat16": 3e-2}),
        OpSpec("cartesian_prod",
               lambda x, y: P.cartesian_prod(x, y),
               lambda a, b: np.stack(
                   [np.repeat(a, len(b)), np.tile(b, len(a))], -1),
               [randn(3), randn(4)], check_grad=False,
               covers="cartesian_prod"),
        OpSpec("combinations",
               lambda x: P.combinations(x, r=2),
               lambda a: np.asarray(
                   [[a[i], a[j]] for i in range(len(a))
                    for j in range(i + 1, len(a))], dtype=a.dtype),
               [randn(4)], check_grad=False, covers="combinations"),
        OpSpec("slice_scatter",
               lambda x, v: P.slice_scatter(
                   x, v, axes=[0], starts=[1], ends=[3], strides=[1]),
               lambda a, b: _np_slice_scatter(a, b),
               [randn(4, 3), randn(2, 3)], covers="slice_scatter"),
        OpSpec("select_scatter",
               lambda x, v: P.select_scatter(x, v, 1, 2),
               lambda a, b: _np_select_scatter(a, b),
               [randn(4, 4), randn(4)], covers="select_scatter"),
        OpSpec("diagonal_scatter",
               lambda x, v: P.diagonal_scatter(x, v, offset=1),
               lambda a, b: _np_diagonal_scatter(a, b),
               [randn(4, 4), randn(3)], covers="diagonal_scatter"),
        OpSpec("multi_margin_loss",
               lambda x, y: P.multi_margin_loss(x, y),
               lambda a, lab: _np_multi_margin(a, lab),
               [randn(4, 5), randint(4, lo=0, hi=5)],
               grad_inputs=[0], covers="multi_margin_loss"),
    ]
    return specs


def _scipy_sp():
    import scipy.special
    return scipy.special


def _np_pdist(a):
    n = a.shape[0]
    out = []
    for i in range(n):
        for j in range(i + 1, n):
            out.append(np.sqrt(np.maximum(
                ((a[i] - a[j]) ** 2).sum(), 1e-24)))
    return np.asarray(out, dtype=a.dtype)


def _np_slice_scatter(a, b):
    out = a.copy()
    out[1:3] = b
    return out


def _np_select_scatter(a, b):
    out = a.copy()
    out[:, 2] = b
    return out


def _np_diagonal_scatter(a, b):
    out = a.copy()
    for i in range(len(b)):
        out[i, i + 1] = b[i]
    return out


def _np_multi_margin(a, lab):
    n, c = a.shape
    x_y = a[np.arange(n), lab][:, None]
    loss = np.maximum(1.0 - x_y + a, 0.0)
    loss[np.arange(n), lab] = 0.0
    return (loss.sum(1) / c).mean().astype(a.dtype)


# Ops in OP_TABLE intentionally NOT covered by a forward/grad spec —
# each carries the reason (multi-output/structural tests, stateful RNG,
# IO/distributed/framework plumbing). audit_coverage() enforces that
# everything else is spec'd.
