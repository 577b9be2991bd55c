"""``TensorArray`` and the array ops (counterpart of
``paddle_tpu/ops/array_ops.py``): a growable Python list of Tensors,
as upstream's LoDTensorArray is a vector of tensors."""

from __future__ import annotations

from typing import List, Optional

import torch

from ..places import _expected_place
from ..tensor import Tensor, _wrap


def _as_tensor(t) -> Tensor:
    if isinstance(t, Tensor):
        return t
    return _wrap(t) if isinstance(t, torch.Tensor) else Tensor(t)


class TensorArray:
    """A growable array of Tensors (LoDTensorArray)."""

    def __init__(self, items: Optional[List[Tensor]] = None):
        self._items: List[Tensor] = [_as_tensor(t) for t in items or []]

    def append(self, t) -> "TensorArray":
        self._items.append(_as_tensor(t))
        return self

    def write(self, i: int, t) -> "TensorArray":
        i = int(i)
        if i == len(self._items):
            self.append(t)
        elif i < len(self._items):
            self._items[i] = _as_tensor(t)
        else:
            raise IndexError(
                f"array_write index {i} out of range (length "
                f"{len(self._items)}; paddle requires i <= length)")
        return self

    def read(self, i: int) -> Tensor:
        return self._items[int(i)]

    def stack(self, axis: int = 0) -> Tensor:
        from ._primitive import OP_TABLE
        return OP_TABLE["stack"](self._items, axis=axis)

    def pop(self, i: int = -1) -> Tensor:
        return self._items.pop(int(i))

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __repr__(self):
        return f"TensorArray(len={len(self._items)})"


def create_array(dtype: str = "float32", initialized_list=None):
    return TensorArray(list(initialized_list) if initialized_list else None)


def array_write(x, i, array: Optional[TensorArray] = None) -> TensorArray:
    if array is None:
        array = TensorArray()
    return array.write(int(i), x)


def array_read(array: TensorArray, i) -> Tensor:
    return array.read(int(i))


def array_length(array: TensorArray) -> Tensor:
    return Tensor(torch.tensor(len(array), dtype=torch.int64),
                  place=_expected_place())
