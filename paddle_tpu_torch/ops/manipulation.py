"""Shape operators of the port that the vision zoo calls (counterpart
of the zoo's part of ``paddle_tpu/ops/manipulation.py``): ``flatten``,
``split``, ``reshape``, ``transpose`` and ``expand`` cast by the AMP
rule as the JAX primitives do.  ``concat`` does not: the JAX ``concat``
is a closure outside the AMP hook, so its inputs meet in the widest
dtype there too."""

from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs


def flatten(x, start_axis=0, stop_axis=-1):
    (x,) = cast_inputs("flatten", x)
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def split(x, num_or_sections, axis=0):
    """A list of parts: ``num_or_sections`` equal ones, or the sizes
    given (one of them may be -1, the rest)."""
    (x,) = cast_inputs("split_p", x)
    axis = int(axis)
    if isinstance(num_or_sections, int):
        return list(torch.chunk(x, num_or_sections, dim=axis))
    sizes = list(num_or_sections)
    if -1 in sizes:
        sizes[sizes.index(-1)] = x.shape[axis] - sum(
            s for s in sizes if s != -1)
    return list(torch.split(x, sizes, dim=axis))


def reshape(x, shape):
    (x,) = cast_inputs("reshape", x)
    return torch.reshape(x, tuple(int(s) for s in shape))


def transpose(x, perm):
    """The axes of ``x`` in the order ``perm`` (numpy's transpose)."""
    (x,) = cast_inputs("transpose", x)
    return x.permute(tuple(int(p) for p in perm))


def expand(x, shape):
    """``x`` broadcast to ``shape``; -1 keeps that dim of ``x`` (leading
    dims are added as size 1 first)."""
    (x,) = cast_inputs("expand", x)
    shape = tuple(int(s) for s in shape)
    x_shape = (1,) * (len(shape) - x.ndim) + tuple(x.shape)
    tgt = tuple(xs if s == -1 else s for s, xs in zip(shape, x_shape))
    return x.reshape(x_shape).expand(tgt)


def concat(x, axis=0):
    """The tensors of ``x`` joined along ``axis``, in their widest
    dtype."""
    return torch.cat(list(x), dim=int(axis))
