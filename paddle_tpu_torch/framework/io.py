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
"""

from __future__ import annotations

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


def save(obj: Any, path: str, protocol: int = 4, **configs) -> None:
    """Write ``obj`` (nested dicts, lists and tuples of tensors, arrays
    and numbers) to ``path`` as the JAX package does."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_serializable(obj), f, protocol=protocol)


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
            obj = pickle.load(f)
        except ModuleNotFoundError as e:
            if e.name == "ml_dtypes":
                raise RuntimeError(
                    f"{path} holds bfloat16 arrays written by the JAX "
                    "package; reading them needs the ml_dtypes package, "
                    "which is not installed") from e
            raise
    return _to_tensors(obj, return_numpy)
