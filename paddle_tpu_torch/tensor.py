"""The Paddle ``Tensor`` of the port (counterpart of
``paddle_tpu/tensor.py``).

A :class:`Tensor` is a wrapper over one ``torch.Tensor``, ``_value``;
it does not subclass ``torch.Tensor``, because Paddle's methods and
torch's share names with other meanings (``transpose(perm)``,
``split(num_or_sections, axis)``, ``flatten(start_axis, stop_axis)``,
``shape`` a list, ``size`` an int, ``dtype`` a Paddle dtype) and the
port's own modules call torch's meanings on the tensors they receive.

Autograd is torch's, on ``_value``: ``stop_gradient=False`` is
``requires_grad``, ``backward()`` is ``torch.autograd.backward``, and a
leaf's ``grad`` is ``_value.grad`` (a dense ``Tensor``, or a
``SelectedRows`` over torch's sparse gradient of a ``sparse=True``
lookup).  Gradients accumulate across ``backward()`` calls until
``clear_grad()`` sets ``grad`` to None.

The boundary between the two worlds:

- every op of the catalogue (``ops.OP_TABLE``, exported at the top
  level and as Tensor methods) takes ``Tensor`` s or ``torch.Tensor`` s
  and returns ``Tensor`` s;
- ``nn.Layer.__call__`` and the ``nn.functional`` functions unwrap
  ``Tensor`` arguments and wrap tensor results back only when an input
  was a ``Tensor``; ``Model.fit``, the optimizers and serving run on
  torch tensors as before;
- a layer's parameters are ``torch.nn.Parameter`` s, so
  ``isinstance(p, paddle.Tensor)`` is False for them, while
  ``paddle.is_tensor(p)`` is True (it is for either kind); the
  optimizers take both, and hold a ``Tensor`` leaf by its handle,
  reading its ``_value`` at each ``step``, ``clear_grad`` and
  ``state_dict`` (an in-place write swaps ``_value``).

In-place methods (``add_``, ``set_value``, ``x[i] = v``, ...) follow
the JAX package, where they swap the buffer and every op recorded
earlier keeps the value it read: the port computes the new value out of
place and swaps ``_value``, so torch's version counter never sees a
write to a tensor an op saved.  A leaf that requires grad stays a leaf
(a new one), and gradients that reach the replaced one (from ops
recorded before the write) are added into its ``grad``.  On a tensor
produced by an op, the write is an op of its own, so the gradient goes
through it (the JAX tape passes it through unchanged).

Place: a tensor made without a place goes to the current one
(``places.set_device``), the card by default; without a card that
raises, unless the CPU was asked for.
"""

from __future__ import annotations

import copy as _copy
import itertools
import weakref
from typing import List, Optional

import numpy as np
import torch

from .framework import dtype as dtypes
from .places import Place, expected_device, place_of, to_place

_names = itertools.count(1)


def _auto_name(prefix: str) -> str:
    return f"{prefix}_{next(_names)}"


def _np_to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" or a.dtype.name in ("bfloat16", "float8_e4m3fn",
                                               "float8_e5m2"):
        if a.dtype.name == "bfloat16":
            bits = np.ascontiguousarray(a).view(np.int16)
            return torch.from_numpy(bits.copy()).view(torch.bfloat16)
        return torch.from_numpy(a.astype(np.float32))
    return torch.from_numpy(np.array(a, copy=True))


def to_torch_value(value, dtype=None, device=None) -> torch.Tensor:
    """``value`` (a Tensor, a torch tensor, a numpy array, a Python
    scalar or nested list) as a new torch tensor with Paddle's dtype
    rules: Python floats take the default float dtype, Python ints
    int64, numpy arrays and tensors keep theirs; ``device`` None is the
    current place.  It never shares memory with ``value``."""
    if isinstance(value, Tensor):
        value = value._value
    tdt = dtypes.to_torch_dtype(dtype)
    if isinstance(value, torch.Tensor):
        src = value.detach()
        out = src.to(device=expected_device() if device is None
                     else device, dtype=tdt)
        return out.clone() if out.data_ptr() == src.data_ptr() else out
    else:
        if isinstance(value, np.ndarray) or np.isscalar(value) and \
                isinstance(value, np.generic):
            out = _np_to_torch(np.asarray(value))
        else:
            if isinstance(value, (list, tuple)) and value and any(
                    isinstance(v, (Tensor, torch.Tensor)) for v in value):
                value = [np.asarray(to_torch_value(v).cpu())
                         if isinstance(v, (Tensor, torch.Tensor)) else v
                         for v in value]
            probe = np.asarray(value)
            if tdt is None and probe.dtype == np.float64:
                tdt = dtypes.default_float_dtype().torch_dtype
            out = _np_to_torch(probe)
        if device is None:
            device = expected_device()
    if device is not None or tdt is not None:
        out = out.to(device=device, dtype=tdt)
    return out


class Tensor:
    """Paddle's tensor over one ``torch.Tensor`` (module docstring)."""

    # numpy's binary operators defer to ours
    __array_priority__ = 100

    def __init__(self, value, dtype=None, place: Optional[Place] = None,
                 stop_gradient: bool = True, name: Optional[str] = None):
        dev = None if place is None else to_place(place).torch_device()
        self._value = to_torch_value(value, dtype, dev)
        self._name = name
        self.persistable = False
        if not stop_gradient:
            self.stop_gradient = False

    # -- meta ---------------------------------------------------------------
    @property
    def value(self) -> torch.Tensor:
        return self._value

    @property
    def name(self) -> str:
        if self._name is None:
            self._name = _auto_name("generated_tensor")
        return self._name

    @name.setter
    def name(self, v):
        self._name = v

    @property
    def shape(self) -> List[int]:
        return list(self._value.shape)

    @property
    def ndim(self) -> int:
        return self._value.ndim

    dim = ndim

    @property
    def size(self) -> int:
        return self._value.numel()

    @property
    def dtype(self) -> dtypes.DType:
        return dtypes.convert_dtype(self._value.dtype)

    @property
    def place(self) -> Place:
        return place_of(self._value.device)

    @property
    def is_leaf(self) -> bool:
        return self._value.grad_fn is None

    @property
    def T(self) -> "Tensor":
        return _OPS["transpose"](self, list(range(self.ndim))[::-1])

    @property
    def mT(self) -> "Tensor":
        perm = list(range(self.ndim))
        perm[-2], perm[-1] = perm[-1], perm[-2]
        return _OPS["transpose"](self, perm)

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._value.shape[0]

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},"
                f"\n       {self.numpy()!r})")

    # -- autograd state -----------------------------------------------------
    @property
    def stop_gradient(self) -> bool:
        v = self._value
        if v.is_floating_point() or v.is_complex():
            return not v.requires_grad
        return self.__dict__.get("_int_stop_gradient", True)

    @stop_gradient.setter
    def stop_gradient(self, flag) -> None:
        v = self._value
        if not (v.is_floating_point() or v.is_complex()):
            # integer tensors never carry a gradient; the flag is kept
            self._int_stop_gradient = bool(flag)
            return
        if flag and v.requires_grad:
            self._value = (v.requires_grad_(False) if v.is_leaf
                           else v.detach())
        elif not flag and not v.requires_grad:
            v.requires_grad_(True)

    @property
    def grad(self):
        v = self._value
        if not (v.is_leaf or v.retains_grad):
            return None
        g = v.grad
        if g is None:
            return None
        if g.is_sparse:
            from .framework.selected_rows import SelectedRows
            return SelectedRows.from_grad(g)
        return _wrap(g)

    @grad.setter
    def grad(self, g) -> None:
        if g is not None and hasattr(g, "to_sparse") and \
                not isinstance(g, (Tensor, torch.Tensor)):
            g = g.to_sparse()
        self._value.grad = None if g is None else unwrap(g)

    @property
    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    def backward(self, grad_tensor=None, retain_graph: bool = False) -> None:
        from .autograd import tape
        tape.backward(self, grad_tensor, retain_graph=retain_graph)

    def clear_grad(self, set_to_zero: bool = False) -> None:
        v = self._value
        if set_to_zero and v.grad is not None:
            v.grad = torch.zeros_like(v.grad)
        else:
            v.grad = None

    clear_gradient = clear_grad

    def retain_grads(self) -> None:
        if self._value.requires_grad and not self._value.is_leaf:
            self._value.retain_grad()

    def register_hook(self, hook):
        """``hook(grad)`` when this tensor's gradient (summed over every
        use in one backward) is computed; a result other than None
        replaces it.  Returns a helper whose ``remove()`` detaches it."""
        if self.stop_gradient:
            raise RuntimeError(
                "Cannot register_hook on a tensor with stop_gradient=True "
                "— it will never receive a gradient")
        if not callable(hook):
            raise TypeError("hook must be callable")

        def torch_hook(g):
            out = hook(_wrap(g))
            return None if out is None else unwrap(out)

        return _HookRemoveHelper(self._value.register_hook(torch_hook))

    # -- conversion ---------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """A writable host copy; bf16 and fp8 widen to fp32 (numpy has
        neither, as ``framework/io.py`` writes them)."""
        v = self._value.detach()
        if v.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            v = v.float()
        if v.device.type == "cpu":
            return np.array(v.resolve_conj().numpy(), copy=True)
        return v.cpu().resolve_conj().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._value.item()

    def tolist(self):
        return self._value.tolist()

    def astype(self, dtype) -> "Tensor":
        return _OPS["cast"](self, dtype)

    cast = astype

    def clone(self) -> "Tensor":
        return _OPS["assign"](self)

    def detach(self) -> "Tensor":
        return Tensor._from(self._value.detach(), self._name)

    def detach_(self) -> "Tensor":
        self.stop_gradient = True
        return self

    def _moved(self, device) -> "Tensor":
        out = Tensor._from(self._value.detach().to(device))
        if not self.stop_gradient:
            out.stop_gradient = False
        return out

    def cpu(self) -> "Tensor":
        return self._moved("cpu")

    def cuda(self, device_id: int = 0, blocking: bool = True) -> "Tensor":
        from . import resolve_device
        return self._moved(resolve_device(f"cuda:{int(device_id or 0)}"))

    def pin_memory(self) -> "Tensor":
        return Tensor._from(self._value.detach().cpu().pin_memory())

    def to(self, *args, **kwargs) -> "Tensor":
        dtype = kwargs.get("dtype")
        device = kwargs.get("device")
        for a in args:
            if isinstance(a, (Place, torch.device)) or (
                    isinstance(a, str) and a.split(":")[0] in (
                        "cpu", "gpu", "cuda", "tpu", "xpu")):
                device = a
            else:
                dtype = a
        out = self
        if dtype is not None:
            out = out.astype(dtype)
        if device is not None:
            out = out._moved(to_place(device).torch_device())
        return out

    # -- in-place writes (module docstring) ---------------------------------
    def _swap(self, new: torch.Tensor) -> None:
        old = self._value
        if old.requires_grad and old.is_leaf:
            new = new.detach().requires_grad_(True)
            _route_grads(old, weakref.ref(self))
        self._value = new

    def set_value(self, value) -> None:
        v = self._value
        self._swap(to_torch_value(value, v.dtype, v.device))

    def copy_(self, other, blocking: bool = True) -> "Tensor":
        self.set_value(other)
        return self

    def fill_(self, value) -> "Tensor":
        self._swap(torch.full_like(self._value.detach(), unwrap(value)))
        return self

    def zero_(self) -> "Tensor":
        self._swap(torch.zeros_like(self._value.detach()))
        return self

    # -- indexing -----------------------------------------------------------
    def __getitem__(self, idx) -> "Tensor":
        return _OPS["getitem"](self, idx)

    def __setitem__(self, idx, value) -> None:
        from .ops.manipulation import _torch_index
        v = self._value
        val = torch.as_tensor(unwrap(value), dtype=v.dtype, device=v.device)
        # recorded only when a gradient can flow through the write
        new = v.clone() if v.requires_grad or val.requires_grad \
            else v.detach().clone()
        new[_torch_index(idx, v.device)] = val
        self._swap(new)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self) -> bool:
        return bool(self._value.item())

    def __int__(self) -> int:
        return int(self._value.item())

    def __float__(self) -> float:
        return float(self._value.item())

    def __index__(self) -> int:
        return int(self._value.item())

    def __hash__(self):
        return id(self)

    def __deepcopy__(self, memo):
        cls = type(self)
        new = cls.__new__(cls)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k == "_value":
                val = v.detach().clone()
                new._value = val.requires_grad_(v.requires_grad)
            else:
                new.__dict__[k] = _copy.deepcopy(v, memo)
        return new

    @staticmethod
    def _from(value: torch.Tensor, name=None) -> "Tensor":
        t = Tensor.__new__(Tensor)
        t._value = value
        t._name = name
        t.persistable = False
        return t

    # -- arithmetic (the catalogue's ops) -----------------------------------
    def __add__(self, o): return _OPS["add"](self, o)
    def __radd__(self, o): return _OPS["add"](self, o)
    def __sub__(self, o): return _OPS["subtract"](self, o)
    def __rsub__(self, o): return _OPS["subtract"](o, self)
    def __mul__(self, o): return _OPS["multiply"](self, o)
    def __rmul__(self, o): return _OPS["multiply"](self, o)
    def __truediv__(self, o): return _OPS["divide"](self, o)
    def __rtruediv__(self, o): return _OPS["divide"](o, self)
    def __floordiv__(self, o): return _OPS["floor_divide"](self, o)
    def __mod__(self, o): return _OPS["remainder"](self, o)
    def __pow__(self, o): return _OPS["pow"](self, o)
    def __rpow__(self, o): return _OPS["elementwise_pow"](o, self)
    def __matmul__(self, o): return _OPS["matmul"](self, o)
    def __neg__(self): return _OPS["neg"](self)
    def __abs__(self): return _OPS["abs"](self)
    def __invert__(self): return _OPS["logical_not"](self)
    def __eq__(self, o): return _OPS["equal"](self, o)
    def __ne__(self, o): return _OPS["not_equal"](self, o)
    def __lt__(self, o): return _OPS["less_than"](self, o)
    def __le__(self, o): return _OPS["less_equal"](self, o)
    def __gt__(self, o): return _OPS["greater_than"](self, o)
    def __ge__(self, o): return _OPS["greater_equal"](self, o)
    def __and__(self, o): return _OPS["logical_and"](self, o)
    def __or__(self, o): return _OPS["logical_or"](self, o)
    def __xor__(self, o): return _OPS["logical_xor"](self, o)


#: the catalogue by name, filled when ``ops`` is imported
_OPS: dict = {}

_wrap = Tensor._from


def unwrap(x):
    """A Tensor's ``_value``; anything else as it is."""
    return x._value if isinstance(x, Tensor) else x


def _route_grads(old: torch.Tensor, owner) -> None:
    """After ``owner``'s leaf ``old`` was replaced: a gradient that still
    reaches ``old`` is added into the current leaf's ``grad``."""
    def move(leaf):
        t = owner()
        g = leaf.grad
        leaf.grad = None
        if t is None or g is None:
            return
        cur = t._value
        if not cur.requires_grad:
            return
        g = g.to(cur.dtype) if not g.is_sparse else g
        cur.grad = g if cur.grad is None else cur.grad + g

    old.register_post_accumulate_grad_hook(move)


class _HookRemoveHelper:
    """What ``Tensor.register_hook`` returns: ``remove()`` detaches the
    hook (True the first time, False after)."""

    def __init__(self, handle):
        self._handle = handle

    def remove(self) -> bool:
        if self._handle is None:
            return False
        self._handle.remove()
        self._handle = None
        return True


class Parameter(Tensor):
    """A trainable Tensor (``paddle.Parameter``): ``stop_gradient=False``
    unless ``trainable=False``.  The port's layers make
    ``nn.Parameter`` s (``torch.nn.Parameter``) instead; this class is
    for parameters made by hand on Tensors."""

    def __init__(self, value, dtype=None, name: Optional[str] = None,
                 trainable: bool = True, place=None):
        super().__init__(value, dtype=dtype, place=place,
                         stop_gradient=not trainable,
                         name=name or _auto_name("param"))
        self.trainable = trainable
        self.persistable = True
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.is_distributed = False

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """``paddle.to_tensor``: a new Tensor of ``data`` on ``place`` (the
    current place when None: the card unless ``set_device("cpu")``),
    a copy: it shares no memory with ``data``."""
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)


def is_tensor(x) -> bool:
    """True for a Tensor and for a torch tensor (a layer's parameter)."""
    return isinstance(x, (Tensor, torch.Tensor))


__all__ = ["Tensor", "Parameter", "to_tensor", "is_tensor", "unwrap"]
