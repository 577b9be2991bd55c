"""Megatron sequence parallelism over the mp group (counterpart of
``paddle_tpu/distributed/fleet/utils/sequence_parallel_utils.py``;
upstream ``fleet/utils/sequence_parallel_utils.py``).

The JAX package marks an activation's sequence dim (axis 1 of ``[b, s,
h]``) sharded on ``mp`` and lets XLA turn the mp all-reduce into a
reduce-scatter and an all-gather.  Here each rank holds its slice of the
sequence between the blocks, and the operators are
``torch.autograd.Function`` s over the mp group:

- ``ScatterOp``: this rank's slice of the sequence (backward: the
  slices all-gathered);
- ``GatherOp``: the slices all-gathered (backward: this rank's slice);
- ``AllGatherOp``: the slices all-gathered (backward: the gradients
  reduce-scattered, as each rank's is a partial sum);
- ``ReduceScatterOp``: the ranks' partial sums reduced, each rank
  keeping its slice (backward: the slices all-gathered).

``ColumnSequenceParallelLinear`` all-gathers the sequence before its
column-split product (whose input gradient the all-gather's backward
reduce-scatters, so no ``c_identity``); ``RowSequenceParallelLinear``
reduce-scatters its row-split product onto the sequence slices, then
adds the bias.  At mp 1 every operator is the identity and the linears
are the plain ones.
"""

from __future__ import annotations

import torch

from ... import communication as comm
from ..meta_parallel.mp_layers import (ColumnParallelLinear,
                                       RowParallelLinear, _mp_group,
                                       mark_as_sequence_parallel_parameter)
from ..meta_parallel.mp_ops import c_concat, c_split
from ....ops import nn_ops

__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "scatter", "all_gather", "mark_as_sequence_parallel_parameter",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear"]


def _live(group):
    return group is not None and group.nranks > 1


def _slice(x, group):
    n = x.shape[1] // group.nranks
    r = group.rank
    return x[:, r * n:(r + 1) * n].contiguous()


def _gather(x, group):
    parts = []
    comm.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _reduce_scatter(x, group):
    """Sum over the group of ``x`` ``[b, s, ...]``; this rank keeps rows
    ``rank * s/n ..`` of the sequence."""
    n = group.nranks
    chunks = [c.contiguous() for c in x.chunk(n, dim=1)]
    out = torch.empty_like(chunks[0])
    comm.reduce_scatter(out, chunks, group=group)
    return out


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


def _op(fn):
    class Op:
        @staticmethod
        def apply(x, group=None):
            group = _mp_group(group)
            return fn.apply(x, group) if _live(group) else x
    Op.__name__ = fn.__name__.lstrip("_") + "Op"
    return Op


ScatterOp = _op(_Scatter)
GatherOp = _op(_Gather)
AllGatherOp = _op(_AllGather)
ReduceScatterOp = _op(_ReduceScatter)


def scatter(x, group=None):
    """This rank's slice of the sequence (the JAX ``scatter``)."""
    return ScatterOp.apply(x, group)


def all_gather(x, group=None):
    """The whole sequence (the JAX ``all_gather``)."""
    return GatherOp.apply(x, group)


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """Input ``[b, s / mp, in]``: the sequence all-gathered, then the
    column-split product (``gather_output`` as for the base layer)."""

    def forward(self, x):
        if self._group is None:
            return super().forward(x)
        x = _AllGather.apply(x, self._group)
        out = nn_ops.linear(x, self.weight, self.bias)
        return c_concat(out, self._group) if self.gather_output else out


class RowSequenceParallelLinear(RowParallelLinear):
    """Input ``[b, s, in / mp]`` (split from the whole input unless
    ``input_is_parallel``): the row-split product reduce-scattered onto
    the sequence slices ``[b, s / mp, out]``, then the bias.  The bias
    is marked sequence-parallel (upstream's mark): each rank's gradient
    of it covers its slice of the sequence only."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.bias is not None and self._group is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        if self._group is None:
            return super().forward(x)
        if not self.input_is_parallel:
            x = c_split(x, self._group)
        out = _ReduceScatter.apply(nn_ops.linear(x, self.weight, None),
                                   self._group)
        return out if self.bias is None else out + self.bias
