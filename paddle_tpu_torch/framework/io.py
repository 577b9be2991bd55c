"""``paddle.save`` / ``paddle.load`` (counterpart of
``paddle_tpu/framework/io.py``).

The format is the JAX package's: a pickle (protocol 4) of nested dicts,
lists and tuples whose tensors are numpy arrays.  So a ``.pdparams`` or
``.pdopt`` written by either package loads in the other, and
``state_dict`` keys are the structured parameter names in both.

bf16: numpy has no bfloat16.  The port writes a bf16 tensor as its
fp32 widening, which is exact (every bf16 value is an fp32 value), and
adds no tag: loading gives fp32, and copying it into a bf16 parameter
or state (``Module.load_state_dict``, ``Optimizer.set_state_dict``)
rounds it back to the same bits.  The JAX package writes a bf16 array as
an ``ml_dtypes.bfloat16`` array.  Unpickling such a file needs the
``ml_dtypes`` package importable (a package of its own, not JAX); the
port then reads it bit for bit as a bf16 tensor.  Without
``ml_dtypes`` such a file is refused with an error that says so.

Learning-rate schedulers: a ``.pdopt``'s ``LR_Scheduler`` entry is the
scheduler's ``state_dict``, Python scalars, and for ``LinearWarmup``
the scheduler it warms into, pickled as an object of the JAX package's
class (``paddle_tpu.optimizer.lr.<name>``).  The port writes its own
schedulers under those class names too (rebuilt through
``importlib.import_module`` and ``getattr``, so writing needs no JAX
package), and reads either package's as the port's class of the same
name in ``paddle_tpu_torch.optimizer.lr``; no object of any other
JAX-package module is read.
"""

from __future__ import annotations

import copyreg
import importlib
import os
import pickle
from typing import Any

import numpy as np
import torch


def _to_serializable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.cpu().numpy())
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_serializable(v) for v in obj)
    return obj


_PORT_LR = "paddle_tpu_torch.optimizer.lr"
_JAX_LR = "paddle_tpu.optimizer.lr"


class _JaxLrModule:
    """Pickles as ``importlib.import_module("paddle_tpu.optimizer.lr")``."""

    def __reduce__(self):
        return importlib.import_module, (_JAX_LR,)


class _JaxLrClass:
    """Pickles as ``getattr(<the JAX package's lr module>, name)``."""

    def __init__(self, name):
        self.name = name

    def __reduce__(self):
        return getattr, (_JaxLrModule(), self.name)


class _Pickler(pickle.Pickler):
    """Writes a port scheduler as an object of the JAX package's class
    of the same name, with the same ``__dict__``."""

    def reducer_override(self, obj):
        cls = type(obj)
        if getattr(cls, "__module__", None) == _PORT_LR and \
                hasattr(obj, "get_lr"):
            return (copyreg._reconstructor,
                    (_JaxLrClass(cls.__name__), object, None),
                    dict(obj.__dict__))
        return NotImplemented


def _import_module(name):
    """``importlib.import_module`` for the unpickler: the JAX package's
    scheduler module is read as the port's."""
    if name == _JAX_LR:
        name = _PORT_LR
    elif name == "paddle_tpu" or name.startswith("paddle_tpu."):
        raise pickle.UnpicklingError(
            f"the file needs the JAX package's module {name}, which the "
            "port does not read")
    return importlib.import_module(name)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == _JAX_LR:
            module = _PORT_LR
        elif module == "importlib" and name == "import_module":
            return _import_module
        elif module == "paddle_tpu" or module.startswith("paddle_tpu."):
            raise pickle.UnpicklingError(
                f"the file holds an object of the JAX package's "
                f"{module}.{name}, which the port does not read")
        return super().find_class(module, name)


def save(obj: Any, path: str, protocol: int = 4, **configs) -> None:
    """Write ``obj`` (nested dicts, lists and tuples of tensors, arrays,
    numbers and schedulers) to ``path`` as the JAX package does."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_to_serializable(obj))


def array_to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor of ``arr``; an ``ml_dtypes.bfloat16`` array becomes a
    bf16 tensor with the same bits."""
    arr = np.array(arr, order="C")      # a copy; keeps 0-d arrays 0-d
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_tensors(obj, return_numpy=False):
    if isinstance(obj, np.ndarray):
        return obj if return_numpy else array_to_tensor(obj)
    if isinstance(obj, dict):
        return {k: _to_tensors(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensors(v, return_numpy) for v in obj)
    return obj


def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """What :func:`save` wrote, with its arrays as CPU tensors (as numpy
    arrays with ``return_numpy=True``)."""
    with open(path, "rb") as f:
        try:
            obj = _Unpickler(f).load()
        except ModuleNotFoundError as e:
            if e.name == "ml_dtypes":
                raise RuntimeError(
                    f"{path} holds bfloat16 arrays written by the JAX "
                    "package; reading them needs the ml_dtypes package, "
                    "which is not installed") from e
            raise
    return _to_tensors(obj, return_numpy)
