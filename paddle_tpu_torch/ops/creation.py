"""Creation ops (counterpart of ``paddle_tpu/ops/creation.py``).

Functions on torch tensors (``_primitive`` says how each becomes a
``Tensor``-level op).  A new tensor goes to the current place
(``places.set_device``; the card by default), in the default float dtype
where a float is meant and int64 where an integer is.  The random ops
draw from the port's generator for that device
(``framework.random.default_generator``): the JAX package's streams
are its own, so random values are not comparable between the packages.
"""

from __future__ import annotations

import torch

from ..framework import dtype as dtypes
from ..framework import random as _random
from ..places import expected_device
from ._primitive import primitive


def _dt(dtype, default=None):
    if dtype is None:
        return None if default is None else dtypes.to_torch_dtype(default)
    return dtypes.to_torch_dtype(dtype)


def _float(dtype=None):
    return _dt(dtype, dtypes.default_float_dtype())


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _num(v):
    return v.item() if isinstance(v, torch.Tensor) else v


@primitive
def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_float(dtype),
                       device=expected_device())


@primitive
def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_float(dtype),
                      device=expected_device())


@primitive
def full(shape, fill_value, dtype=None, name=None):
    fill_value = _num(fill_value)
    if dtype is None:
        if isinstance(fill_value, bool):
            dt = torch.bool
        elif isinstance(fill_value, int):
            dt = torch.int64
        else:
            dt = _float()
    else:
        dt = _dt(dtype)
    return torch.full(_shape(shape), fill_value, dtype=dt,
                      device=expected_device())


@primitive
def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=_dt(dtype))


@primitive
def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=_dt(dtype))


@primitive
def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, _num(fill_value), dtype=_dt(dtype))


@primitive
def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


@primitive
def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


@primitive
def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _num(start), _num(end), _num(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (dtypes.default_float_dtype()
                 if any(isinstance(v, float) for v in (start, end, step))
                 else dtypes.int64)
    return torch.arange(start, end, step, dtype=_dt(dtype),
                        device=expected_device())


@primitive
def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_num(start), _num(stop), int(_num(num)),
                          dtype=_float(dtype), device=expected_device())


@primitive
def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(_num(start), _num(stop), int(_num(num)),
                          base=float(_num(base)), dtype=_float(dtype),
                          device=expected_device())


@primitive
def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = int(num_columns) if num_columns else n
    return torch.eye(n, m, dtype=_float(dtype), device=expected_device())


@primitive
def diag(x, offset=0, padding_value=0, name=None):
    if x.ndim == 1 and padding_value != 0:
        n = x.shape[0] + abs(offset)
        base = torch.full((n, n), padding_value, dtype=x.dtype,
                          device=x.device)
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        return torch.where(mask, torch.diag(x, offset), base)
    return torch.diag(x, offset)


@primitive
def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


@primitive
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2)


@primitive
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


@primitive
def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


@primitive
def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


@primitive
def tril_indices(row, col, offset=0, dtype="int64"):
    return torch.tril_indices(int(row), int(col), int(offset),
                              dtype=_dt(dtype), device=expected_device())


@primitive
def triu_indices(row, col=None, offset=0, dtype="int64"):
    return torch.triu_indices(int(row), int(col or row), int(offset),
                              dtype=_dt(dtype), device=expected_device())


@primitive
def meshgrid(*args, **kwargs):
    arrays = (args[0] if len(args) == 1 and isinstance(args[0], (list, tuple))
              else args)
    return list(torch.meshgrid(*arrays, indexing="ij"))


@primitive
def assign(x, output=None):
    if not isinstance(x, torch.Tensor):
        from ..tensor import to_torch_value
        return to_torch_value(x)
    return x.clone()


@primitive
def clone(x, name=None):
    return assign(x)


@primitive
def cast(x, dtype):
    return x.to(_dt(dtype))


@primitive
def one_hot(x, num_classes, name=None):
    from .manipulation import one_hot as _one_hot
    return _one_hot(x, num_classes)


@primitive
def complex(real, imag, name=None):
    return torch.complex(real, imag)


# -- random ----------------------------------------------------------------
def _gen(device):
    return _random.default_generator(device)


@primitive
def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


@primitive
def randn(shape, dtype=None, name=None):
    dev = expected_device()
    return torch.randn(_shape(shape), dtype=_float(dtype), device=dev,
                       generator=_gen(dev))


@primitive
def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


@primitive
def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        ref = mean if isinstance(mean, torch.Tensor) else std
        shp = torch.broadcast_shapes(torch.as_tensor(mean).shape,
                                     torch.as_tensor(std).shape)
        z = torch.randn(shp, dtype=_float(), device=ref.device,
                        generator=_gen(ref.device))
        return z * std + mean
    dev = expected_device()
    z = torch.randn(_shape(shape if shape is not None else [1]),
                    dtype=_float(), device=dev, generator=_gen(dev))
    return z * std + mean


@primitive
def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = expected_device()
    gen = _gen(dev)
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    out = torch.empty(_shape(shape), dtype=_float(dtype), device=dev)
    return out.uniform_(float(_num(min)), float(_num(max)), generator=gen)


@primitive
def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = expected_device()
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=_dt(dtype, dtypes.int64), device=dev,
                         generator=_gen(dev))


@primitive
def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), tuple(x.shape),
                         dtype=_dt(dtype) or x.dtype, device=x.device,
                         generator=_gen(x.device))


@primitive
def randperm(n, dtype="int64", name=None):
    dev = expected_device()
    return torch.randperm(int(n), dtype=_dt(dtype), device=dev,
                          generator=_gen(dev))


@primitive
def bernoulli(x, name=None):
    return torch.bernoulli(x, generator=_gen(x.device)).to(x.dtype)


@primitive
def multinomial(x, num_samples=1, replacement=False, name=None):
    return torch.multinomial(x, int(num_samples), replacement,
                             generator=_gen(x.device))


@primitive
def poisson(x, name=None):
    return torch.poisson(x, generator=_gen(x.device))


@primitive
def rand_like(x, dtype=None, name=None):
    out = torch.empty_like(x, dtype=_dt(dtype))
    return out.uniform_(0.0, 1.0, generator=_gen(x.device))


@primitive
def randn_like(x, dtype=None, name=None):
    out = torch.empty_like(x, dtype=_dt(dtype))
    return out.normal_(generator=_gen(x.device))

