"""``SelectedRows``: row-wise sparse gradients (counterpart of
``paddle_tpu/framework/selected_rows.py``, upstream
``phi::SelectedRows``).

An embedding table's gradient names the rows that were looked up and
holds their cotangents, so the optimizer touches only those rows of a
wide table.  torch lets a parameter's ``.grad`` hold a tensor only, so
in the port the gradient itself is torch's sparse COO tensor (sparse
dim 1, one dense dim: ``indices()[0]`` are the rows, ``values()`` their
``[n, dim]`` cotangents), as ``torch.nn.functional.embedding(sparse=
True)`` makes it and torch's autograd accumulates it: a table looked
up several times in one backward, or in several backwards, holds every
lookup's rows, duplicates included (the JAX tape's ``sparse + sparse``
concatenation), and a dense gradient added to it makes it dense.
:class:`SelectedRows` is the Paddle view over such a tensor
(:meth:`SelectedRows.from_grad`) and back (:meth:`SelectedRows.
to_sparse`).

Merging (:func:`merge_rows`, :meth:`SelectedRows.merged`) sums the
values of duplicate rows and sorts the rows, as ``jnp.unique`` and
``segment_sum`` do: ``Tensor.coalesce``, whose output size depends on
the data, so on the card it reads one count on the host.  That is one
sync per sparse table per step, as the JAX package's eager
``jnp.unique`` has.

The sparse route runs only where the JAX one does: eagerly
(``backward`` / ``step`` / ``clear_grad``, and ``Model`` with
``prepare(jit=False)``).  Inside :func:`dense_lookups` (the forward of
a ``Model`` step under ``prepare(jit=True)``, which the JAX package
compiles and the card captures into a CUDA graph) a sparse lookup is
the dense one.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_DENSE = {"depth": 0}


@contextlib.contextmanager
def dense_lookups():
    """Inside: ``Embedding(sparse=True)`` and ``F.embedding(sparse=True)``
    give dense gradients, as the JAX layer's lookup under a trace."""
    _DENSE["depth"] += 1
    try:
        yield
    finally:
        _DENSE["depth"] -= 1


def sparse_lookup_allowed() -> bool:
    """Whether a ``sparse=True`` lookup makes a sparse gradient here."""
    return _DENSE["depth"] == 0


def merge_rows(grad: torch.Tensor) -> torch.Tensor:
    """A sparse row gradient with its duplicate rows summed and its rows
    sorted (``coalesce``); an already merged one as it is."""
    return grad if grad.is_coalesced() else grad.coalesce()


class SelectedRows:
    """``rows`` ``[n]`` (int64) into dim 0 of a ``height``-row tensor,
    ``values`` ``[n, ...]`` their entries; rows may repeat until
    :meth:`merged`."""

    def __init__(self, rows, values, height: int, _merged: bool = False):
        self.values = torch.as_tensor(values)
        self.rows = torch.as_tensor(rows, device=self.values.device).to(
            torch.int64).reshape(-1)
        self.height = int(height)
        self._merged = _merged

    @classmethod
    def from_grad(cls, grad: torch.Tensor) -> "SelectedRows":
        """The view of a sparse COO row gradient (a parameter's ``.grad``
        after a ``sparse=True`` lookup)."""
        if not grad.is_sparse or grad.sparse_dim() != 1:
            raise TypeError("SelectedRows.from_grad takes a sparse COO "
                            "tensor with one sparse dim, got "
                            f"{grad.layout} {tuple(grad.shape)}")
        if grad.is_coalesced():
            return cls(grad.indices()[0], grad.values(), grad.shape[0],
                       _merged=True)
        return cls(grad._indices()[0], grad._values(), grad.shape[0])

    def to_sparse(self) -> torch.Tensor:
        """The sparse COO tensor of these rows (what ``.grad`` holds)."""
        return torch.sparse_coo_tensor(
            self.rows.reshape(1, -1), self.values, self.shape,
            check_invariants=False, is_coalesced=self._merged)

    def is_selected_rows(self) -> bool:
        return True

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def numpy(self) -> np.ndarray:
        """The dense array (a 16-bit value as fp32)."""
        d = self.to_dense().detach()
        return (d.float() if d.dtype in (torch.bfloat16, torch.float16)
                else d).cpu().numpy()

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add_(0, self.rows, self.values)

    def merged(self) -> "SelectedRows":
        """Duplicate rows summed, rows sorted (upstream ``MergeAdd``);
        idempotent."""
        if self._merged:
            return self
        return SelectedRows.from_grad(merge_rows(self.to_sparse()))

    def scale(self, s) -> "SelectedRows":
        return SelectedRows(self.rows, self.values * s, self.height,
                            _merged=self._merged)

    def __add__(self, other):
        if isinstance(other, SelectedRows):
            if other.height != self.height:
                raise ValueError("SelectedRows height mismatch")
            return SelectedRows(torch.cat([self.rows, other.rows]),
                                torch.cat([self.values, other.values]),
                                self.height)
        # dense + sparse: dense
        other = torch.as_tensor(other)
        return other.index_add(0, self.rows, self.values.to(other.dtype))

    __radd__ = __add__

    def __repr__(self):
        return (f"SelectedRows(rows={self.rows.shape[0]}, "
                f"height={self.height}, value_shape="
                f"{tuple(self.values.shape)})")
