"""Functional higher-order autograd (counterpart of
``paddle_tpu/autograd/functional.py``): ``jvp``, ``vjp``, ``jacobian``,
``hessian`` and the ``Jacobian`` / ``Hessian`` objects over
``torch.autograd.functional`` (``batch_axis=0``: ``torch.func``'s
``vmap`` over the per-example transform).  The user function sees and
returns ``Tensor`` s; the results are Tensors with
``stop_gradient=True``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..tensor import Tensor, _wrap, unwrap

__all__ = ["jvp", "vjp", "jacobian", "hessian", "Jacobian", "Hessian"]


def _values(xs):
    return [unwrap(x) if isinstance(x, (Tensor, torch.Tensor))
            else torch.as_tensor(x) for x in (
                xs if isinstance(xs, (list, tuple)) else [xs])]


def _is_seq(xs) -> bool:
    return isinstance(xs, (list, tuple))


def _pure(func: Callable, n: int, seq_in: bool):
    def fn(*vals):
        args = [_wrap(v) for v in vals]
        out = func(*args) if (seq_in or n > 1) else func(args[0])
        if isinstance(out, (list, tuple)):
            return tuple(unwrap(o) for o in out)
        return unwrap(out)
    return fn


def _rewrap(vals, like_seq):
    outs = tuple(_wrap(v.detach()) for v in vals)
    return outs if like_seq or len(outs) != 1 else outs[0]


def _wrap_tree(j):
    if isinstance(j, (tuple, list)):
        return tuple(_wrap_tree(x) for x in j)
    return _wrap(j.detach())


def jvp(func: Callable, xs, v=None):
    """``(func(xs), J @ v)``; ``v`` defaults to ones like ``xs``."""
    seq = _is_seq(xs)
    vals = _values(xs)
    tans = [torch.ones_like(a) for a in vals] if v is None else _values(v)
    out, tangent = torch.autograd.functional.jvp(
        _pure(func, len(vals), seq), tuple(vals), tuple(tans))
    multi = isinstance(out, tuple)
    return (_rewrap(out if multi else (out,), multi),
            _rewrap(tangent if multi else (tangent,), multi))


def vjp(func: Callable, xs, v=None):
    """``(func(xs), v^T @ J)``; ``v`` defaults to ones like the
    output."""
    seq = _is_seq(xs)
    vals = _values(xs)
    fn = _pure(func, len(vals), seq)
    if v is None:
        with torch.no_grad():
            probe = fn(*vals)
        multi = isinstance(probe, tuple)
        cts = tuple(torch.ones_like(o) for o in (
            probe if multi else (probe,)))
    else:
        cts = tuple(_values(v))
    out, grads = torch.autograd.functional.vjp(
        fn, tuple(vals), cts if len(cts) > 1 else cts[0])
    multi = isinstance(out, tuple)
    return (_rewrap(out if multi else (out,), multi),
            _rewrap(grads if isinstance(grads, tuple) else (grads,), seq))


def _batched(transform, fn, vals, batch_axis):
    if batch_axis is None:
        return transform(fn, tuple(vals))
    if batch_axis != 0:
        raise ValueError("batch_axis must be None or 0")
    return torch.func.vmap(lambda *a: transform(fn, a))(*vals)


def jacobian(func: Callable, xs, batch_axis=None):
    """The full Jacobian of ``func`` at ``xs``: one Tensor for one input
    and one output, else nested tuples (output, then input)."""
    seq = _is_seq(xs)
    vals = _values(xs)
    fn = _pure(func, len(vals), seq)
    if batch_axis is None:
        jac = torch.autograd.functional.jacobian(fn, tuple(vals))
    else:
        argnums = tuple(range(len(vals)))
        jac = _batched(lambda f, a: torch.func.jacrev(f, argnums)(*a),
                       fn, vals, batch_axis)
    out = _wrap_tree(jac)
    if not seq and isinstance(out, tuple) and len(out) == 1:
        return out[0]
    return out


def hessian(func: Callable, xs, batch_axis=None):
    """The Hessian of a scalar ``func`` at ``xs``."""
    seq = _is_seq(xs)
    vals = _values(xs)
    fn = _pure(func, len(vals), seq)

    def scalar(*a):
        out = fn(*a)
        if isinstance(out, tuple):
            raise ValueError("hessian expects a single scalar output")
        return out.reshape(())

    if batch_axis is None:
        h = torch.autograd.functional.hessian(scalar, tuple(vals))
    else:
        argnums = tuple(range(len(vals)))
        h = _batched(lambda f, a: torch.func.hessian(f, argnums)(*a),
                     scalar, vals, batch_axis)
    out = _wrap_tree(h)
    if not seq and isinstance(out, tuple) and len(out) == 1:
        inner = out[0]
        if isinstance(inner, tuple) and len(inner) == 1:
            return inner[0]
        return inner
    return out


class Jacobian:
    """A Jacobian to index (``J[i, j]``) or read whole (``.tensors``)."""

    def __init__(self, func: Callable, xs, is_batched: bool = False):
        self._mat = jacobian(func, xs, batch_axis=0 if is_batched else None)

    def __getitem__(self, idx):
        if isinstance(self._mat, tuple):
            raise TypeError("indexing a multi-input Jacobian; select the "
                            "input first via .tensors")
        return _wrap(self._mat._value[idx])

    @property
    def tensors(self):
        return self._mat

    @property
    def shape(self):
        m = self._mat
        return m.shape if isinstance(m, Tensor) else [t.shape for t in m]


class Hessian(Jacobian):
    def __init__(self, func: Callable, xs, is_batched: bool = False):
        self._mat = hessian(func, xs, batch_axis=0 if is_batched else None)
