"""The op table of the port (counterpart of
``paddle_tpu/ops/_primitive.py``).

Each op of the catalogue is a plain function on torch tensors in its
module (``ops/math.py``, ``ops/creation.py``, ...), so that the port's
own code calls it on torch tensors with no wrapper in the way.
:func:`primitive` registers its ``Tensor``-level form in ``OP_TABLE``:

  1. unwrap ``Tensor`` arguments (also inside a list or tuple
     argument) to their ``_value``;
  2. the AMP hook: under ``amp.auto_cast`` the floating tensor
     arguments are cast by the port's O1/O2 rule for the op's
     ``OP_TABLE`` name (``amp/auto_cast.py::_target``; ``split`` by
     ``split_p``, ``_AMP_RULE``), as the JAX
     primitive's ``_amp_hook`` casts them;
  3. run the function (autograd is torch's own: nothing is recorded);
     under ``auto_cast`` the casts of the torch functions it reaches
     (``cast_inputs``, which the port's layers rely on) are off
     meanwhile, so each op casts once, by one rule and one name;
  4. wrap every tensor result in a ``Tensor``, always, whether the
     inputs were ``Tensor`` s or torch tensors;
  5. under ``FLAGS_check_nan_inf`` (``set_flags``) raise on a NaN or
     Inf result; this reads the device once per op.  It reads no
     environment knob: ``framework/env_knobs.py`` gains none.

``ops/__init__.py`` exports ``OP_TABLE`` as the ``Tensor``-level
functions of ``paddle_tpu_torch.ops`` and of the top level, and
attaches the Tensor methods.  The JAX package's static-graph and
operator-stats hooks wait for the static-graph module (ROADMAP A12).

:func:`boundary` is the other wrapping rule, that of ``nn.functional``
and ``nn.Layer.__call__``: unwrap ``Tensor`` arguments, and wrap the
tensor results back only when an input was a ``Tensor``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from ..amp.auto_cast import _amp_state, _target
from ..tensor import Tensor, _wrap, unwrap  # noqa: F401

OP_TABLE: Dict[str, Callable] = {}

_CHECK_NAN_INF = [False]


def set_flags(flags: dict) -> None:
    """``paddle.set_flags``: ``FLAGS_check_nan_inf`` is the one flag
    the port reads."""
    for k, v in flags.items():
        if k != "FLAGS_check_nan_inf":
            raise ValueError(f"unknown flag {k!r}")
        _CHECK_NAN_INF[0] = bool(v)


def get_flags(flags):
    names = [flags] if isinstance(flags, str) else list(flags)
    for k in names:
        if k != "FLAGS_check_nan_inf":
            raise ValueError(f"unknown flag {k!r}")
    return {"FLAGS_check_nan_inf": _CHECK_NAN_INF[0]}


def _unwrap_arg(a):
    if isinstance(a, Tensor):
        return a._value
    if isinstance(a, (list, tuple)) and any(isinstance(e, Tensor)
                                            for e in a):
        return type(a)(_unwrap_arg(e) for e in a) \
            if type(a) in (list, tuple) else [_unwrap_arg(e) for e in a]
    return a


def wrap_out(o):
    """Every torch tensor in ``o`` (also inside tuples, lists and dicts)
    as a ``Tensor``."""
    if isinstance(o, torch.Tensor):
        return _wrap(o)
    if isinstance(o, tuple):
        vals = [wrap_out(e) for e in o]
        return type(o)(*vals) if hasattr(o, "_fields") else tuple(vals)
    if isinstance(o, list):
        return [wrap_out(e) for e in o]
    if isinstance(o, dict):
        return type(o)((k, wrap_out(v)) for k, v in o.items())
    return o


def has_tensor(args, kwargs) -> bool:
    """Whether a ``Tensor`` is among ``args`` / ``kwargs`` (or inside a
    list or tuple argument)."""
    for a in args:
        if isinstance(a, Tensor) or (isinstance(a, (list, tuple)) and any(
                isinstance(e, Tensor) for e in a)):
            return True
    for a in kwargs.values():
        if isinstance(a, Tensor) or (isinstance(a, (list, tuple)) and any(
                isinstance(e, Tensor) for e in a)):
            return True
    return False


def unwrap_args(args, kwargs):
    return ([_unwrap_arg(a) for a in args],
            {k: _unwrap_arg(v) for k, v in kwargs.items()})


def _check_nan_inf(name, out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for o in outs:
        if isinstance(o, torch.Tensor) and (o.is_floating_point()
                                            or o.is_complex()):
            if not bool(torch.isfinite(o.detach()).all()):
                raise FloatingPointError(
                    f"FLAGS_check_nan_inf: op '{name}' produced NaN/Inf")


#: ops whose AMP rule goes by another name: the JAX package's ``split``
#: casts in its ``split_p`` primitive, and the port's ``split`` body so
#: casts on torch tensors
_AMP_RULE = {"split": "split_p"}


def _amp_call(f, rule, args, kwargs):
    """``f`` under ``auto_cast`` (module docstring, steps 2 and 3)."""
    dt = _target(rule)
    if dt is not None:
        def cast(a):
            return (a.to(dt) if isinstance(a, torch.Tensor)
                    and a.is_floating_point() and a.dtype != dt else a)
        args = [cast(a) for a in args]
        kwargs = {k: cast(v) for k, v in kwargs.items()}
    _amp_state["enabled"] = False
    try:
        return f(*args, **kwargs)
    finally:
        _amp_state["enabled"] = True


def make_op(f: Callable, opname: str) -> Callable:
    """The ``Tensor``-level form of the torch function ``f`` (module
    docstring, steps 1-5)."""
    rule = _AMP_RULE.get(opname, opname)

    def op(*args, **kwargs):
        args, kwargs = unwrap_args(args, kwargs)
        out = (_amp_call(f, rule, args, kwargs) if _amp_state["enabled"]
               else f(*args, **kwargs))
        if _CHECK_NAN_INF[0]:
            _check_nan_inf(opname, out)
        return wrap_out(out)

    op.__name__ = opname
    op.__qualname__ = opname
    op.__doc__ = f.__doc__
    op.raw = f
    return op


def primitive(fn=None, *, name=None):
    """Register ``fn``'s ``Tensor``-level form in ``OP_TABLE`` under
    ``name`` (default: its own) and return ``fn`` itself."""

    def deco(f):
        opname = name or f.__name__
        OP_TABLE[opname] = make_op(f, opname)
        return f

    return deco(fn) if fn is not None else deco


def apply_closure(f: Callable, tensors, name: str = "closure_op"):
    """``f`` on the values of ``tensors``, its tensor results wrapped
    (torch's autograd records it as it runs)."""
    return wrap_out(f(*[unwrap(t) for t in tensors]))


def boundary(fn: Callable) -> Callable:
    """``fn`` (a function on torch tensors) that also takes ``Tensor``
    s: they are unwrapped, and then the tensor results wrapped back;
    called on torch tensors only, it is ``fn`` with one scan of the
    arguments in front."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not has_tensor(args, kwargs):
            return fn(*args, **kwargs)
        args, kwargs = unwrap_args(args, kwargs)
        return wrap_out(fn(*args, **kwargs))

    wrapper.raw = fn
    return wrapper
