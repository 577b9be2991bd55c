"""Deferred device→host materialization (counterpart of
``paddle_tpu/framework/lazy.py``).

A decode dispatch emits one ``[B]`` token tensor on the device.  The
engine hands every request a :class:`LazyScalar` view of that tensor
through one shared :class:`LazyStack`, so reading any number of the
views costs ONE device→host copy per dispatch, and a dispatch whose
tokens nobody reads costs none.  The copy (``Tensor.cpu()``) waits for
the device, so it is the consumer's sync, never the engine loop's.
The tensor a stack holds must not be written in place afterwards.
"""

from __future__ import annotations

import numpy as np


def _to_host(value) -> np.ndarray:
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class LazyStack:
    """One device tensor shared by many :class:`LazyScalar` views."""

    __slots__ = ("_dev", "_host")

    def __init__(self, dev):
        self._dev = dev
        self._host = None

    def _materialize(self) -> np.ndarray:
        """THE device→host copy for every view of this stack."""
        if self._host is None:
            self._host = _to_host(self._dev)
            self._dev = None
        return self._host


class LazyScalar:
    """Device scalar with on-demand host materialization.

    ``dev`` is a tensor or a :class:`LazyStack`; ``post`` (optional)
    is a host-side finisher applied to the fetched array, e.g. picking
    one slot of the stack.
    """

    __slots__ = ("_dev", "_post", "_host")

    def __init__(self, dev, post=None):
        self._dev = dev
        self._post = post
        self._host = None

    def _materialize(self) -> np.ndarray:
        if self._host is None:
            if isinstance(self._dev, LazyStack):
                h = self._dev._materialize()
            else:
                h = _to_host(self._dev)
            if self._post is not None:
                h = np.asarray(self._post(h))
            self._host = h
            self._dev = self._post = None
        return self._host

    def __array__(self, dtype=None, copy=None):
        h = self._materialize()
        return h.astype(dtype) if dtype is not None else h

    def __float__(self):
        return float(self._materialize())

    def __int__(self):
        return int(self._materialize())

    def __bool__(self):
        return bool(self._materialize())

    def item(self):
        return self._materialize().item()

    def numpy(self):
        return self._materialize()

    def __format__(self, spec):
        if spec:
            return format(float(self), spec)
        return str(self._materialize())

    def __repr__(self):
        return f"LazyScalar({self._materialize()!r})"

    def __eq__(self, other):
        return self._materialize() == other

    def __ne__(self, other):
        return self._materialize() != other

    __hash__ = object.__hash__
