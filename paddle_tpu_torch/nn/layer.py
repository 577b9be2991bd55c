"""``nn.Layer``, the base of every layer and model of the port
(counterpart of ``paddle_tpu/nn/layer.py``).

A :class:`Layer` is a ``torch.nn.Module`` that also speaks Paddle's API:
``create_parameter``, ``add_parameter``, ``add_sublayer``,
``register_buffer(persistable=)``, ``parameters()`` as a list,
``sublayers``, ``state_dict(structured_name_prefix=)``,
``set_state_dict``, ``to(dtype="float16")``, ``astype``,
``register_forward_post_hook``, ``full_name``, ``clear_gradients``, and
:class:`LazyGuard` with ``apply_deferred_init``.  torch's own callers
keep working: ``parameters()`` is a list that ``next()`` also reads,
``named_parameters(prefix, recurse, remove_duplicate)``,
``state_dict(prefix=, keep_vars=)``, ``train(mode)``, ``to(*args)``.

Structure version: every Layer that gains, loses or replaces a
parameter or a sub-layer bumps one process-wide counter and logs its
id, as the JAX package does.  ``hapi.Model`` reads it before each step:
a captured graph reads the storage of the parameters it was captured
with, so when the trained network's structure moved the model drops
its graphs (and hands a replaced parameter to the optimizer) before the
next step.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List

import numpy as np
import torch

from .. import resolve_device
from ..ops._primitive import has_tensor, unwrap_args, wrap_out
from . import initializer as I

#: Paddle's dtype names and their torch dtypes
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
           "int8": torch.int8, "uint8": torch.uint8}


def to_torch_dtype(dtype):
    """A Paddle dtype name (``"float16"``) or a torch dtype as a torch
    dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("paddle.", "")
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _DTYPES[name]


class LazyGuard:
    """Defer parameter initialization while a model is built (upstream
    ``paddle.LazyGuard``): under the guard every parameter the port's
    layers create (``initializer.make_parameter``) is a zeros
    placeholder that records its initializer, and
    ``layer.apply_deferred_init()`` draws the real values later."""

    def __enter__(self):
        self._prev = I._LAZY_INIT["on"]
        I._LAZY_INIT["on"] = True
        return self

    def __exit__(self, *exc):
        I._LAZY_INIT["on"] = self._prev
        return False


#: what a hook registration returns (``.remove()``), Paddle's name
HookRemoveHelper = torch.utils.hooks.RemovableHandle

# Structural-mutation log, as the JAX package keeps it: bumped whenever
# any Layer gains, loses or replaces a parameter or a sub-layer, with
# the id of the mutated layer, so a model asks whether a mutation
# touched its own tree (a set intersection) before it drops graphs.
_STRUCTURE_VERSION = 0
_MUTATION_LOG: List[int] = []
_LOG_BASE = 0
_MUTATION_LOG_MAX = 4096


def bump_structure_version(layer=None):
    global _STRUCTURE_VERSION, _LOG_BASE
    _STRUCTURE_VERSION += 1
    _MUTATION_LOG.append(id(layer))
    if len(_MUTATION_LOG) > _MUTATION_LOG_MAX:
        drop = _MUTATION_LOG_MAX // 2
        del _MUTATION_LOG[:drop]
        _LOG_BASE += drop


def structure_version() -> int:
    return _STRUCTURE_VERSION


def mutations_since(version: int):
    """ids of the layers mutated after ``version``; None when the log
    was trimmed past it (the caller must assume its tree was touched)."""
    start = version - _LOG_BASE
    if start < 0:
        return None
    return _MUTATION_LOG[start:]


class _IterList(list):
    """A list (Paddle's ``parameters()``) that is also an iterator over
    itself, as torch's generator is, so ``next(net.parameters())``
    reads the first element."""

    _pos = 0

    def __next__(self):
        if self._pos >= len(self):
            raise StopIteration
        self._pos += 1
        return self[self._pos - 1]


class Layer(torch.nn.Module):
    """The module base (``paddle.nn.Layer``).  ``dtype`` is the dtype of
    the parameters :meth:`create_parameter` makes by default."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = to_torch_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()

    def __call__(self, *args, **kwargs):
        """torch's call; given a Paddle ``Tensor`` among the inputs, the
        forward sees its torch tensor and the tensor results come back
        as ``Tensor`` s (``tensor.py``, the boundary)."""
        if has_tensor(args, kwargs):
            args, kwargs = unwrap_args(args, kwargs)
            return wrap_out(super().__call__(*args, **kwargs))
        return super().__call__(*args, **kwargs)

    # -- structure ----------------------------------------------------------
    def __setattr__(self, name, value):
        # torch routes a Parameter (or None for one) through
        # register_parameter, which bumps; a sub-layer it stores itself
        if isinstance(value, torch.nn.Module) or (
                value is None and name in self.__dict__.get("_modules", ())):
            bump_structure_version(self)
        super().__setattr__(name, value)

    def __delattr__(self, name):
        if name in self._parameters or name in self._modules or \
                name in self._buffers:
            bump_structure_version(self)
        super().__delattr__(name)

    def register_parameter(self, name, param):
        super().register_parameter(name, param)
        bump_structure_version(self)

    def add_module(self, name, module):
        super().add_module(name, module)
        bump_structure_version(self)

    register_module = add_module

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """``persistable`` (Paddle) or ``persistent`` (torch): whether the
        buffer is in :meth:`state_dict`."""
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, tensor, persistent=bool(keep))
        bump_structure_version(self)
        return tensor

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def _param_device(self):
        for p in self.parameters():
            return p.device
        return None

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None,
                         generator=None):
        """A parameter of ``shape`` from ``attr`` (an initializer, a name
        or a ``ParamAttr``), else ``default_initializer``, else 0 for a
        bias and ``XavierNormal`` otherwise (``initializer.
        create_parameter``), in ``dtype`` (the layer's by default).  It
        is made on ``device``, else beside this layer's parameters,
        else on the card."""
        dev = device if device is not None else self._param_device()
        p = I.create_parameter(shape, attr, is_bias, default_initializer,
                               device=resolve_device(dev),
                               generator=generator)
        dt = to_torch_dtype(dtype) or self._dtype
        if dt is not None and dt != p.dtype:
            p.data = p.data.to(dt)
        return p

    def apply_deferred_init(self) -> int:
        """Draw the values of the parameters made under :class:`LazyGuard`
        (zeros until now) in place; returns how many were drawn."""
        n = 0
        with torch.no_grad():
            for _, p in self.named_parameters():
                ini = getattr(p, "_deferred_init", None)
                if ini is None:
                    continue
                init, gen = ini
                p.copy_(init(tuple(p.shape), p.device, gen).to(p.dtype))
                p._deferred_init = None
                n += 1
        return n

    # -- traversal ----------------------------------------------------------
    def parameters(self, include_sublayers=True, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return _IterList(super().parameters(recurse=rec))

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, *, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix=prefix, recurse=rec,
                                        remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return _IterList(super().buffers(recurse=rec))

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, *, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return super().named_buffers(prefix=prefix, recurse=rec,
                                     remove_duplicate=remove_duplicate)

    def sublayers(self, include_self=False) -> List[torch.nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        it = self.named_modules(prefix=prefix)
        if not include_self:
            next(it)
        return it

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *,
                   prefix=None, keep_vars=False):
        """The parameters and persistable buffers by structured name
        (``structured_name_prefix`` or torch's ``prefix`` before each),
        detached unless ``keep_vars``; ``include_sublayers=False`` keeps
        this layer's own."""
        pre = structured_name_prefix if prefix is None else prefix
        if include_sublayers:
            return super().state_dict(destination=destination, prefix=pre,
                                      keep_vars=keep_vars)
        dest = OrderedDict() if destination is None else destination
        self._save_to_state_dict(dest, pre, keep_vars)
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict`` (torch tensors or numpy arrays, bf16 ones
        of ``ml_dtypes`` too) into the live parameters and buffers in
        place, so captured graphs stay valid.  Keys are structured names
        (the JAX package's, e.g. ``encoder.layers.0.linear1.weight``),
        or with ``use_structured_name=False`` the parameters' ``name``.
        A shape mismatch raises; returns ``(missing, unexpected)``."""
        own = self.state_dict(keep_vars=True)
        if not use_structured_name:
            by_name = {getattr(v, "name", None): k for k, v in own.items()}
            state_dict = {by_name.get(k, k): v for k, v in
                          state_dict.items()}
        missing = [k for k in own if k not in state_dict]
        unexpected = []
        for k, v in state_dict.items():
            tgt = own.get(k)
            if tgt is None:
                unexpected.append(k)
                continue
            val = v if isinstance(v, torch.Tensor) else _from_numpy(v)
            if tuple(val.shape) != tuple(tgt.shape):
                raise ValueError(f"shape mismatch for {k}: checkpoint "
                                 f"{tuple(val.shape)} vs model "
                                 f"{tuple(tgt.shape)}")
            tgt.copy_(val)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # -- dtype and device ---------------------------------------------------
    def to(self, *args, **kwargs):
        """torch's ``to`` that also takes Paddle's ``to(device=None,
        dtype="float16", blocking=None)``: the floating parameters and
        buffers cast to ``dtype``."""
        kwargs.pop("blocking", None)
        for key in ("device", "dtype"):
            if key in kwargs and kwargs[key] is None:
                del kwargs[key]
        if "dtype" in kwargs:
            kwargs["dtype"] = to_torch_dtype(kwargs["dtype"])
        args = tuple(to_torch_dtype(a) if isinstance(a, str) and a in _DTYPES
                     else a for a in args)
        if not args and not kwargs:
            return self
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- hooks and misc -----------------------------------------------------
    def register_forward_post_hook(self, hook: Callable):
        """``hook(layer, inputs, outputs)`` after each forward; a result
        other than None replaces the outputs."""
        return self.register_forward_hook(hook)

    def full_name(self) -> str:
        return self._name_scope

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None


def _from_numpy(v):
    a = np.asarray(v)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))
