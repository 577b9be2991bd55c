"""Elementwise math and reductions (counterpart of
``paddle_tpu/ops/math.py``).

Functions on torch tensors (``_primitive`` says how each becomes a
``Tensor``-level op); each calls torch's op where torch has the same
function, and otherwise the JAX function's formula, so that values and
gradients agree.  No Pallas kernel computes any of them in the JAX
package: XLA does.  Where the JAX function follows numpy and torch does
not, the numpy meaning is kept: ``median`` / ``nanmedian`` average the
two middle values of an even count, ``sort`` / ``argsort`` with
``descending`` flip a stable ascending sort, ``cummax`` / ``cummin``
return the values only, ``outer`` flattens its inputs, ``max`` / ``min``
split the gradient among ties.  A Python scalar operand takes the
tensor's dtype (JAX's weak typing).
"""

from __future__ import annotations

import itertools

import torch

from ..framework import dtype as dtypes
from ._primitive import primitive

def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _as_t(v, ref: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a tensor beside ``ref`` in ``ref``'s dtype where
    JAX's weak typing keeps it (a float beside a floating tensor, an int
    beside any but bool)."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, bool):
        dt = torch.bool
    elif isinstance(v, int):
        dt = ref.dtype if ref.dtype != torch.bool else torch.int64
    elif isinstance(v, float):
        dt = (ref.dtype if ref.is_floating_point() or ref.is_complex()
              else dtypes.default_float_dtype().torch_dtype)
    elif isinstance(v, complex):
        dt = torch.complex64
    else:
        return torch.as_tensor(v, device=ref.device)
    return torch.as_tensor(v, dtype=dt, device=ref.device)


def _pair(x, y):
    if not isinstance(x, torch.Tensor):
        x = _as_t(x, y)
    if not isinstance(y, torch.Tensor):
        y = _as_t(y, x)
    return x, y


def _binary(name, fn):
    def op(x, y, name=None):
        x, y = _pair(x, y)
        return fn(x, y)
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = f"``{name}`` elementwise, broadcasting."
    return primitive(op)


add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
remainder = _binary("remainder", torch.remainder)
elementwise_pow = _binary("elementwise_pow", torch.pow)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", torch.atan2)
logaddexp = _binary("logaddexp", torch.logaddexp)
logaddexp2 = _binary("logaddexp2", torch.logaddexp2)
hypot = _binary("hypot", torch.hypot)
nextafter = _binary("nextafter", torch.nextafter)
copysign = _binary("copysign", torch.copysign)
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)
primitive(remainder, name="mod")
primitive(remainder, name="floor_mod")
mod = floor_mod = remainder


@primitive
def pow(x, y, name=None):
    if isinstance(y, torch.Tensor) or not isinstance(x, torch.Tensor):
        x, y = _pair(x, y)
    return torch.pow(x, y)


@primitive
def lerp(x, y, weight, name=None):
    x, y = _pair(x, y)
    return x + weight * (y - x)


@primitive
def ldexp(x, y, name=None):
    return x * torch.pow(2.0, y.to(x.dtype) if isinstance(
        y, torch.Tensor) else float(y))


@primitive
def heaviside(x, y, name=None):
    yv = _as_t(y, x).to(x.dtype)
    out = torch.where(x < 0, torch.zeros_like(x),
                      torch.where(x > 0, torch.ones_like(x), yv))
    if x.is_floating_point():
        out = torch.where(torch.isnan(x), x, out)
    return out


def _wide(fn):
    """``fn`` computed in fp32 for a 16-bit input and rounded back (the
    special functions, whose 16-bit kernels not every device has)."""
    def run(x):
        if x.dtype in (torch.bfloat16, torch.float16):
            return fn(x.float()).to(x.dtype)
        return fn(x)
    return run


def _unary(name, fn):
    def op(x, name=None):
        return fn(x)
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = f"``{name}`` elementwise."
    return primitive(op)


_UNARY = {
    "neg": torch.neg, "abs": torch.abs, "sign": torch.sign,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "square": torch.square,
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "floor": torch.floor, "ceil": torch.ceil, "trunc": torch.trunc,
    "frac": lambda x: x - torch.trunc(x),
    "reciprocal": torch.reciprocal, "erf": torch.erf,
    "erfinv": _wide(torch.erfinv), "lgamma": _wide(torch.lgamma),
    "gammaln": _wide(torch.lgamma), "digamma": _wide(torch.digamma),
    "rad2deg": torch.rad2deg, "deg2rad": torch.deg2rad,
    "angle": torch.angle, "conj": torch.conj_physical,
    "real": torch.real, "imag": torch.imag, "isnan": torch.isnan,
    "isinf": torch.isinf, "isfinite": torch.isfinite,
    "signbit": torch.signbit, "i0": _wide(torch.special.i0),
    "i1": _wide(torch.special.i1), "i0e": _wide(torch.special.i0e),
    "i1e": _wide(torch.special.i1e), "sinc": torch.sinc, "sgn": torch.sgn,
    "positive": torch.positive, "isneginf": torch.isneginf,
    "isposinf": torch.isposinf, "isreal": torch.isreal,
}
for _n, _f in _UNARY.items():
    globals()[_n] = _unary(_n, _f)


@primitive
def round(x, decimals=0, name=None):
    return torch.round(x, decimals=int(decimals)) if decimals else \
        torch.round(x)


@primitive
def logit(x, eps=None, name=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@primitive
def clip(x, min=None, max=None, name=None):
    if isinstance(min, torch.Tensor):
        min = min.item()
    if isinstance(max, torch.Tensor):
        max = max.item()
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min, max)


@primitive
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


# -- reductions -------------------------------------------------------------
def _keep_all(out, x, keepdim):
    return out.reshape((1,) * x.ndim) if keepdim else out


def _dims(x, axis):
    ax = _axis(axis)
    if ax is None:
        return tuple(range(x.ndim))
    return ax if isinstance(ax, tuple) else (ax,)


@primitive
def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    dt = dtypes.to_torch_dtype(dtype)
    if x.dtype == torch.bool and dt is None:
        dt = torch.int64
    ax = _axis(axis)
    if ax is None:
        return _keep_all(torch.sum(x, dtype=dt), x, keepdim)
    return torch.sum(x, dim=ax, keepdim=keepdim, dtype=dt)


@primitive
def mean(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    if ax is None:
        return _keep_all(torch.mean(x), x, keepdim)
    return torch.mean(x, dim=ax, keepdim=keepdim)


def _amax(x, axis, keepdim, fn):
    if x.ndim == 0:
        return x.clone()
    return fn(x, dim=_dims(x, axis), keepdim=keepdim)


@primitive
def max(x, axis=None, keepdim=False, name=None):
    return _amax(x, axis, keepdim, torch.amax)


@primitive
def min(x, axis=None, keepdim=False, name=None):
    return _amax(x, axis, keepdim, torch.amin)


@primitive
def amax(x, axis=None, keepdim=False, name=None):
    return _amax(x, axis, keepdim, torch.amax)


@primitive
def amin(x, axis=None, keepdim=False, name=None):
    return _amax(x, axis, keepdim, torch.amin)


@primitive
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    dt = dtypes.to_torch_dtype(dtype)
    ax = _axis(axis)
    if ax is None:
        return _keep_all(torch.prod(x, dtype=dt), x, keepdim)
    out = x if dt is None else x.to(dt)
    for d in sorted((a % x.ndim for a in (ax if isinstance(ax, tuple)
                                          else (ax,))), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def _moments(fn, x, axis, unbiased, keepdim):
    ax = _axis(axis)
    corr = 1 if unbiased else 0
    if ax is None:
        return _keep_all(fn(x, correction=corr), x, keepdim)
    return fn(x, dim=ax, correction=corr, keepdim=keepdim)


@primitive
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moments(torch.std, x, axis, unbiased, keepdim)


@primitive
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moments(torch.var, x, axis, unbiased, keepdim)


@primitive
def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    dt = dtypes.to_torch_dtype(dtype)
    ax = _axis(axis)
    if ax is None:
        return _keep_all(torch.nansum(x, dtype=dt), x, keepdim)
    return torch.nansum(x, dim=ax, keepdim=keepdim, dtype=dt)


@primitive
def nanmean(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    if ax is None:
        return _keep_all(torch.nanmean(x), x, keepdim)
    return torch.nanmean(x, dim=ax, keepdim=keepdim)


@primitive
def logsumexp(x, axis=None, keepdim=False, name=None):
    if x.ndim == 0:
        return x.clone()
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


def _arg(fn, x, axis, keepdim, dtype):
    dt = dtypes.to_torch_dtype(dtype)
    if axis is None:
        out = fn(x.reshape(-1))
        return _keep_all(out, x, keepdim).to(dt)
    return fn(x, dim=int(axis), keepdim=keepdim).to(dt)


@primitive
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


@primitive
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def _flat_axis(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, int(axis))


@primitive
def cumsum(x, axis=None, dtype=None, name=None):
    x, axis = _flat_axis(x, axis)
    return torch.cumsum(x, dim=axis, dtype=dtypes.to_torch_dtype(dtype))


@primitive
def cumprod(x, dim=None, dtype=None, name=None):
    x, dim = _flat_axis(x, dim)
    return torch.cumprod(x, dim=dim, dtype=dtypes.to_torch_dtype(dtype))


@primitive
def cummax(x, axis=None, name=None):
    x, axis = _flat_axis(x, axis)
    return torch.cummax(x, dim=axis).values


@primitive
def cummin(x, axis=None, name=None):
    x, axis = _flat_axis(x, axis)
    return torch.cummin(x, dim=axis).values


@primitive
def logcumsumexp(x, axis=None, name=None):
    x, axis = _flat_axis(x, axis)
    return _wide(lambda v: torch.logcumsumexp(v, dim=axis))(x)


def _bool_red(fn, x, axis, keepdim):
    x = x.bool() if x.dtype != torch.bool else x
    ax = _axis(axis)
    if ax is None:
        return _keep_all(fn(x), x, keepdim)
    return fn(x, dim=ax, keepdim=keepdim)


@primitive
def all(x, axis=None, keepdim=False, name=None):
    return _bool_red(torch.all, x, axis, keepdim)


@primitive
def any(x, axis=None, keepdim=False, name=None):
    return _bool_red(torch.any, x, axis, keepdim)


@primitive
def count_nonzero(x, axis=None, keepdim=False, name=None):
    return sum(x != 0, axis, None, keepdim).to(torch.int64)


def _to_last(x, axis):
    """``x`` with the reduced axes (all for None) moved last and merged:
    (tensor, their former positions)."""
    dims = tuple(d % x.ndim for d in _dims(x, axis)) if x.ndim else ()
    keep = [d for d in range(x.ndim) if d not in dims]
    moved = x.permute(keep + list(dims)) if x.ndim else x.reshape(1)
    return moved.reshape(tuple(x.shape[d] for d in keep) + (-1,)), dims


def _quantile(fn, x, q, axis, keepdim):
    flat, dims = _to_last(x, axis)
    # torch's quantile takes fp32 / fp64 only: 16-bit inputs go through
    # fp32 and back
    wide = flat if flat.dtype in (torch.float32, torch.float64) \
        else flat.float()
    qt = q if isinstance(q, torch.Tensor) else torch.as_tensor(
        q, dtype=wide.dtype, device=x.device)
    out = fn(wide, qt.to(wide.dtype), dim=-1).to(x.dtype)
    if keepdim:
        lead = out.shape[:out.ndim - (x.ndim - len(dims))]
        shape = list(x.shape)
        for d in dims:
            shape[d] = 1
        out = out.reshape(tuple(lead) + tuple(shape))
    return out


@primitive
def median(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


@primitive
def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


@primitive
def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim)


@primitive
def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim)


@primitive
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    srt, idx = torch.sort(x, dim=axis, stable=True)
    val = srt.select(axis, int(k) - 1)
    ind = idx.select(axis, int(k) - 1)
    if keepdim:
        val, ind = val.unsqueeze(axis), ind.unsqueeze(axis)
    return val, ind


@primitive
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    v, i = torch.topk(x, int(k), dim=int(axis), largest=largest,
                      sorted=True)
    return v, i


@primitive
def sort(x, axis=-1, descending=False, stable=False, name=None):
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, (axis,)) if descending else out


@primitive
def argsort(x, axis=-1, descending=False, stable=False, name=None):
    out = torch.sort(x, dim=axis, stable=True).indices
    return torch.flip(out, (axis,)) if descending else out


@primitive
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(sorted_sequence, values, out_int32=out_int32,
                              right=right)


@primitive
def bincount(x, weights=None, minlength=0, name=None):
    return torch.bincount(x, weights, int(minlength))


@primitive
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, int(n), int(axis), prepend, append)


@primitive
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


@primitive
def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    n = y.shape[axis]
    avg = (y.narrow(axis, 0, n - 1) + y.narrow(axis, 1, n - 1)) * 0.5
    if x is not None:
        xs = x
        if xs.ndim == 1:
            shape = [1] * y.ndim
            shape[axis] = xs.shape[0]
            xs = xs.reshape(shape)
        avg = avg * torch.diff(xs, dim=axis if xs.ndim == y.ndim else -1)
    else:
        avg = avg * (1.0 if dx is None else dx)
    return torch.cumsum(avg, dim=axis)


@primitive
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan, posinf, neginf)


@primitive
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _pair(x, y)
    return torch.as_tensor(torch.allclose(x, y.to(x.dtype), float(rtol),
                                          float(atol), equal_nan),
                           device=x.device)


@primitive
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _pair(x, y)
    return torch.isclose(x, y.to(x.dtype), float(rtol), float(atol),
                         equal_nan)


@primitive
def equal_all(x, y, name=None):
    x, y = _pair(x, y)
    return torch.as_tensor(x.shape == y.shape and bool(torch.equal(
        x, y.to(x.dtype))), device=x.device)


@primitive
def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


@primitive
def rank(x, name=None):
    return torch.tensor(x.ndim, dtype=torch.int64, device=x.device)


@primitive
def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


@primitive
def as_real(x, name=None):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


@primitive
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    if isinstance(scale, torch.Tensor):
        scale = scale.to(x.dtype)
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


@primitive
def increment(x, value=1.0, name=None):
    return x + value


@primitive
def multiplex(inputs, index, name=None):
    stacked = torch.stack(list(inputs), dim=0)
    idx = index.reshape(1, -1, *([1] * (stacked.ndim - 2))).expand(
        (1,) + tuple(stacked.shape[1:]))
    return torch.take_along_dim(stacked, idx.long(), dim=0)[0]


@primitive
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * input + alpha * (x @ y)


@primitive
def inner(x, y, name=None):
    return torch.inner(x, y)


@primitive
def outer(x, y, name=None):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@primitive
def frexp(x, name=None):
    m, e = torch.frexp(x)
    return m, e


@primitive
def polar(abs, angle, name=None):
    return torch.complex(abs * torch.cos(angle), abs * torch.sin(angle))


@primitive
def renorm(x, p, axis, max_norm, name=None):
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    norms = torch.sum(torch.abs(x) ** p, dim=reduce_axes,
                      keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


@primitive
def vander(x, n=None, increasing=False, name=None):
    n = x.shape[-1] if n is None else int(n)
    pows = torch.arange(n, dtype=x.dtype, device=x.device)
    if not increasing:
        pows = torch.flip(pows, (0,))
    return x[..., :, None] ** pows


@primitive
def gammainc(x, y, name=None):
    return torch.special.gammainc(x, y)


@primitive
def gammaincc(x, y, name=None):
    return torch.special.gammaincc(x, y)


@primitive
def polygamma(x, n=1, name=None):
    return torch.special.polygamma(int(n), x)


@primitive
def multigammaln(x, p=1, name=None):
    return torch.special.multigammaln(x, int(p))


@primitive
def pdist(x, p=2.0, name=None):
    n = x.shape[0]
    diff = x[:, None, :] - x[None, :, :]
    if p == 2.0:
        d = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1),
                                   min=1e-24))
    else:
        d = torch.sum(torch.abs(diff) ** p, dim=-1) ** (1.0 / p)
    iu = torch.triu_indices(n, n, 1, device=x.device)
    return d[iu[0], iu[1]]


@primitive
def cartesian_prod(*xs, name=None):
    if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
        xs = tuple(xs[0])
    if len(xs) == 1:
        return xs[0].reshape(-1)
    grids = torch.meshgrid(*xs, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


@primitive
def combinations(x, r=2, with_replacement=False, name=None):
    n = x.shape[0]
    it = (itertools.combinations_with_replacement(range(n), int(r))
          if with_replacement else itertools.combinations(range(n), int(r)))
    idx = torch.tensor(list(it), dtype=torch.int64, device=x.device)
    if idx.numel() == 0:
        idx = idx.reshape(0, int(r))
    return x[idx]
