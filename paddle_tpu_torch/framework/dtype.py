"""Paddle's dtypes over torch's (counterpart of
``paddle_tpu/framework/dtype.py``).

A :class:`DType` is a thin handle over a ``torch.dtype`` that also
compares equal to its Paddle name (``"float32"``), to the torch dtype
and to the numpy dtype, so ``t.dtype == paddle.float32``,
``t.dtype == "float32"`` and ``t.dtype == np.float32`` all hold, as in
the JAX package.  numpy has no bfloat16: ``bfloat16.np_dtype`` is
``ml_dtypes.bfloat16`` where that package is importable, else None, and
the port never needs it (``Tensor.numpy()`` widens bf16 to fp32, as
``framework/io.py`` writes it).
"""

from __future__ import annotations

import numpy as np
import torch


def _ml_dtype(name):
    try:
        import ml_dtypes
    except ImportError:
        return None
    return getattr(ml_dtypes, name, None)


class DType:
    """A Paddle dtype: ``name``, ``torch_dtype`` and ``np_dtype`` (None
    where numpy has none)."""

    __slots__ = ("name", "torch_dtype", "np_dtype")

    def __init__(self, name, torch_dtype, np_dtype):
        self.name = name
        self.torch_dtype = torch_dtype
        self.np_dtype = None if np_dtype is None else np.dtype(np_dtype)

    def __repr__(self):
        return f"paddle.{self.name}"

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.torch_dtype == other.torch_dtype
        try:
            return self.torch_dtype == convert_dtype(other).torch_dtype
        except (ValueError, TypeError):
            return False

    def __hash__(self):
        return hash(self.torch_dtype)

    @property
    def is_floating_point(self) -> bool:
        return self.torch_dtype.is_floating_point


bool_ = DType("bool", torch.bool, np.bool_)
uint8 = DType("uint8", torch.uint8, np.uint8)
int8 = DType("int8", torch.int8, np.int8)
int16 = DType("int16", torch.int16, np.int16)
int32 = DType("int32", torch.int32, np.int32)
int64 = DType("int64", torch.int64, np.int64)
float16 = DType("float16", torch.float16, np.float16)
bfloat16 = DType("bfloat16", torch.bfloat16, _ml_dtype("bfloat16"))
float32 = DType("float32", torch.float32, np.float32)
float64 = DType("float64", torch.float64, np.float64)
complex64 = DType("complex64", torch.complex64, np.complex64)
complex128 = DType("complex128", torch.complex128, np.complex128)
float8_e4m3fn = DType("float8_e4m3fn", torch.float8_e4m3fn,
                      _ml_dtype("float8_e4m3fn"))
float8_e5m2 = DType("float8_e5m2", torch.float8_e5m2,
                    _ml_dtype("float8_e5m2"))

_ALL = [bool_, uint8, int8, int16, int32, int64, float16, bfloat16,
        float32, float64, complex64, complex128, float8_e4m3fn, float8_e5m2]
_BY_NAME = {d.name: d for d in _ALL}
_BY_NAME.update({"float": float32, "double": float64, "half": float16,
                 "int": int32})
_BY_TORCH = {d.torch_dtype: d for d in _ALL}
_BY_NP = {d.np_dtype: d for d in _ALL if d.np_dtype is not None}

_DEFAULT_DTYPE = [float32]


def set_default_dtype(d) -> None:
    _DEFAULT_DTYPE[0] = convert_dtype(d)


def get_default_dtype() -> str:
    return _DEFAULT_DTYPE[0].name


def default_float_dtype() -> DType:
    return _DEFAULT_DTYPE[0]


def convert_dtype(d) -> DType:
    """A Paddle name, a torch dtype, a numpy dtype (or type) or a DType
    as a DType."""
    if isinstance(d, DType):
        return d
    if isinstance(d, torch.dtype):
        if d in _BY_TORCH:
            return _BY_TORCH[d]
        raise ValueError(f"Unsupported dtype {d!r}")
    if isinstance(d, str):
        name = d.replace("paddle.", "").replace("torch.", "")
        if name in _BY_NAME:
            return _BY_NAME[name]
        raise ValueError(f"Unknown dtype name {d!r}")
    npd = np.dtype(d)
    if npd in _BY_NP:
        return _BY_NP[npd]
    if npd.name in _BY_NAME:
        return _BY_NAME[npd.name]
    raise ValueError(f"Unsupported dtype {d!r}")


def to_torch_dtype(d):
    """Any dtype :func:`convert_dtype` takes as a torch dtype; None stays
    None."""
    return None if d is None else convert_dtype(d).torch_dtype


def is_floating(d) -> bool:
    return convert_dtype(d).torch_dtype.is_floating_point


def is_integer(d) -> bool:
    t = convert_dtype(d).torch_dtype
    return not t.is_floating_point and not t.is_complex and t != torch.bool


class _FInfo:
    """``paddle.finfo``'s result, from ``torch.finfo``."""

    __slots__ = ("dtype", "min", "max", "eps", "tiny", "smallest_normal",
                 "resolution", "bits")

    def __init__(self, d: DType):
        fi = torch.finfo(d.torch_dtype)
        self.dtype = d.name
        self.min = float(fi.min)
        self.max = float(fi.max)
        self.eps = float(fi.eps)
        self.tiny = float(fi.tiny)
        self.smallest_normal = float(fi.smallest_normal)
        self.resolution = float(fi.resolution)
        self.bits = int(fi.bits)

    def __repr__(self):
        return (f"finfo(dtype={self.dtype}, min={self.min}, "
                f"max={self.max}, eps={self.eps})")


class _IInfo:
    __slots__ = ("dtype", "min", "max", "bits")

    def __init__(self, d: DType):
        ii = torch.iinfo(d.torch_dtype)
        self.dtype = d.name
        self.min = int(ii.min)
        self.max = int(ii.max)
        self.bits = int(ii.bits)

    def __repr__(self):
        return (f"iinfo(dtype={self.dtype}, min={self.min}, "
                f"max={self.max}, bits={self.bits})")


def finfo(dtype):
    """``paddle.finfo``: the limits of a floating dtype."""
    return _FInfo(convert_dtype(dtype))


def iinfo(dtype):
    """``paddle.iinfo``: the limits of an integer dtype."""
    return _IInfo(convert_dtype(dtype))
