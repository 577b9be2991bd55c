"""Shape and indexing operators (counterpart of
``paddle_tpu/ops/manipulation.py``, with ``one_hot`` of
``ops/creation.py``).

Functions on torch tensors (``_primitive`` says how each becomes a
``Tensor``-level op); the port's layers call ``flatten``, ``split``,
``reshape``, ``transpose``, ``expand``, ``pad`` and ``unfold`` directly,
and those cast by the AMP rule as the JAX primitives do.  ``concat``
does not: the JAX ``concat`` is a closure outside the AMP hook, so its
inputs meet in the widest dtype there too.

Shapes that depend on the data (``nonzero``, ``masked_select``,
``unique``, ``unique_consecutive``) read the device once, as the JAX
functions do eagerly.  ``scatter(overwrite=True)`` with a repeated
index keeps one of the updates, which one being the device's choice in
both packages.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..amp.auto_cast import cast_inputs
from ._primitive import primitive

_pyslice = builtins.slice


@primitive
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    (x,) = cast_inputs("flatten", x)
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


@primitive
def split(x, num_or_sections, axis=0, name=None):
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


@primitive
def reshape(x, shape, name=None):
    (x,) = cast_inputs("reshape", x)
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return torch.reshape(x, tuple(int(s) for s in shape))


@primitive
def transpose(x, perm, name=None):
    """The axes of ``x`` in the order ``perm`` (numpy's transpose)."""
    (x,) = cast_inputs("transpose", x)
    return x.permute(tuple(int(p) for p in perm))


@primitive
def expand(x, shape, name=None):
    """``x`` broadcast to ``shape``; -1 keeps that dim of ``x`` (leading
    dims are added as size 1 first)."""
    (x,) = cast_inputs("expand", x)
    shape = tuple(int(s) for s in shape)
    x_shape = (1,) * (len(shape) - x.ndim) + tuple(x.shape)
    tgt = tuple(xs if s == -1 else s for s, xs in zip(shape, x_shape))
    return x.reshape(x_shape).expand(tgt)


@primitive
def concat(x, axis=0, name=None):
    """The tensors of ``x`` joined along ``axis``, in their widest
    dtype."""
    return torch.cat(list(x), dim=int(axis.item() if isinstance(
        axis, torch.Tensor) else axis))


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "replicate", "circular": "circular"}


def _pad_config(ndim, pad, data_format):
    """Paddle's ``pad`` list as ``[(lo, hi)]`` for every dim of ``x``: a
    pair for each dim when the list covers them all, else pairs for the
    last ``len(pad) // 2`` spatial dims, the last dim's first (the
    spatial dims before the channel for a ``...C`` ``data_format``)."""
    pad = [int(p) for p in pad]
    if len(pad) == 2 * ndim:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(ndim)]
    k = len(pad) // 2
    cfg = [(0, 0)] * ndim
    spatial = (list(range(1, 1 + k)) if data_format.endswith("C")
               else list(range(ndim - k, ndim)))
    for i, d in enumerate(reversed(spatial)):
        cfg[d] = (pad[2 * i], pad[2 * i + 1])
    return cfg


@primitive
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``x`` padded as the JAX ``pad`` (``jnp.pad``) pads it: ``mode``
    "constant" (with ``value``), "reflect" (the edge not repeated),
    "replicate" or "circular"; ``pad`` as :func:`_pad_config` reads it.
    A mode other than constant pads up to three trailing dims in one
    ``F.pad``, and other dims one at a time (each mode is separable)."""
    (x,) = cast_inputs("pad", x)
    if mode not in _PAD_MODES:
        raise ValueError(f"pad mode {mode!r}")
    if isinstance(pad, int):
        pad = [pad] * (2 * (x.ndim - 2))
    cfg = _pad_config(x.ndim, pad, data_format)
    F = torch.nn.functional
    if mode == "constant":
        return F.pad(x, tuple(v for lo_hi in reversed(cfg) for v in lo_hi),
                     value=value)
    dims = [d for d, (lo, hi) in enumerate(cfg) if lo or hi]
    if not dims:
        return x
    trailing = dims == list(range(x.ndim - len(dims), x.ndim))
    if trailing and len(dims) <= 3 and x.ndim - len(dims) >= 1:
        lead = x.shape[:x.ndim - len(dims)]
        xr = x.reshape((1, -1) + tuple(x.shape[x.ndim - len(dims):]))
        out = F.pad(xr, tuple(v for d in reversed(dims) for v in cfg[d]),
                    mode=_PAD_MODES[mode])
        return out.reshape(tuple(lead) + tuple(out.shape[2:]))
    out = x
    for d in dims:
        moved = out.movedim(d, -1)
        flat = moved.reshape(1, -1, moved.shape[-1])
        padded = F.pad(flat, cfg[d], mode=_PAD_MODES[mode])
        out = padded.reshape(tuple(moved.shape[:-1]) + (-1,)).movedim(-1, d)
    return out


@primitive
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col of ``[N, C, H, W]``: ``[N, C*kh*kw, L]``, channel-major
    (counterpart of ``manipulation.unfold``; a padding list gives its
    first two elements, the H and W pads, as the JAX function reads
    it)."""
    (x,) = cast_inputs("unfold", x)

    def two(v):
        return tuple(v[:2]) if isinstance(v, (list, tuple)) else (v, v)

    return torch.nn.functional.unfold(x, two(kernel_sizes), two(dilations),
                                      two(paddings), two(strides))


def one_hot(x, num_classes, name=None):
    """The float32 one-hot rows of the ids ``x`` (counterpart of
    ``creation.one_hot``); an id outside ``[0, num_classes)`` gives a
    zero row, as ``jax.nn.one_hot`` does."""
    ids = x.long()
    valid = (ids >= 0) & (ids < num_classes)
    out = torch.nn.functional.one_hot(ids.clamp(0, num_classes - 1),
                                      num_classes).float()
    return out * valid.unsqueeze(-1)


# -- the rest of the JAX module's ops ----------------------------------------
def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _ints(vs):
    if isinstance(vs, torch.Tensor):
        return [int(v) for v in vs.tolist()]
    if isinstance(vs, int):
        return [vs]
    return [_int(v) for v in vs]


@primitive
def t(x, name=None):
    return x.clone() if x.ndim < 2 else x.permute(
        tuple(range(x.ndim))[::-1])


@primitive
def squeeze(x, axis=None, name=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, (list, tuple)):
        dims = tuple(a % x.ndim for a in _ints(axis)
                     if x.shape[a % x.ndim] == 1)
        return torch.squeeze(x, dims) if dims else x
    axis = _int(axis) % x.ndim
    return torch.squeeze(x, axis) if x.shape[axis] == 1 else x


@primitive
def unsqueeze(x, axis, name=None):
    out = x
    for a in sorted(_ints(axis)):
        out = torch.unsqueeze(out, a)
    return out


@primitive
def stack(x, axis=0, name=None):
    return torch.stack(list(x), dim=_int(axis))


@primitive
def split_p(x, sections, axis):
    return tuple(split(x, sections, axis))


@primitive
def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


@primitive
def unbind(x, axis=0, name=None):
    return list(torch.unbind(x, _int(axis)))


primitive(unbind, name="unbind_p")
primitive(unbind, name="unstack")


@primitive
def tile(x, repeat_times, name=None):
    reps = _ints(repeat_times)
    if len(reps) < x.ndim:
        reps = [1] * (x.ndim - len(reps)) + reps
    return x.repeat(reps) if len(reps) >= x.ndim else x


@primitive
def expand_as(x, y, name=None):
    return expand(x, list(y.shape))


@primitive
def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(x, tuple(_ints(shape)))


@primitive
def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@primitive
def flip(x, axis, name=None):
    return torch.flip(x, tuple(_ints(axis)))


@primitive
def roll(x, shifts, axis=None, name=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


@primitive
def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, int(k), tuple(axes))


@primitive
def gather(x, index, axis=0, name=None):
    axis = _int(axis)
    if index.ndim == 0:
        return torch.index_select(x, axis, index.reshape(1)).squeeze(axis)
    return torch.index_select(x, axis, index.reshape(-1))


@primitive
def gather_nd(x, index, name=None):
    return x[tuple(torch.movedim(index, -1, 0))]


@primitive
def take_along_axis(x, indices, axis, broadcast=True, name=None):
    ax = axis % x.ndim
    if broadcast:
        shape = list(torch.broadcast_shapes(
            tuple(1 if i == ax else s for i, s in enumerate(x.shape)),
            tuple(indices.shape)))
        shape[ax] = indices.shape[ax]
        indices = indices.expand(shape)
        xs = list(shape)
        xs[ax] = x.shape[ax]
        x = x.expand(xs)
    return torch.gather(x, ax, indices)


@primitive
def put_along_axis(x, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    ax = axis % x.ndim
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(values, dtype=x.dtype, device=x.device)
    values = values.to(x.dtype).expand(indices.shape)
    if reduce == "assign":
        return x.scatter(ax, indices, values)
    at = torch.gather(x, ax, indices)
    if reduce in ("add", "sum"):
        upd = at + values if include_self else values
    elif reduce in ("mul", "multiply"):
        upd = at * values if include_self else values
    elif reduce == "amax":
        upd = torch.maximum(at, values)
    elif reduce == "amin":
        upd = torch.minimum(at, values)
    else:
        raise ValueError(f"unsupported reduce {reduce}")
    return x.scatter(ax, indices, upd)


@primitive
def scatter(x, index, updates, overwrite=True, name=None):
    idx = (index.reshape(-1),)
    if overwrite:
        return x.index_put(idx, updates)
    zeroed = x.index_put(idx, torch.zeros_like(updates))
    return zeroed.index_put(idx, updates, accumulate=True)


@primitive
def scatter_nd_add(x, index, updates, name=None):
    return x.index_put(tuple(torch.movedim(index, -1, 0)), updates,
                       accumulate=True)


@primitive
def scatter_nd(index, updates, shape, name=None):
    z = torch.zeros(tuple(_ints(shape)), dtype=updates.dtype,
                    device=updates.device)
    return scatter_nd_add(z, index, updates)


@primitive
def index_select(x, index, axis=0, name=None):
    return torch.index_select(x, _int(axis), index.reshape(-1))


@primitive
def index_sample(x, index, name=None):
    return torch.gather(x, 1, index)


@primitive
def index_add(x, index, axis, value, name=None):
    return torch.index_add(x, _int(axis), index, value.to(x.dtype))


@primitive
def index_put(x, indices, value, accumulate=False, name=None):
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    idx = tuple(torch.as_tensor(i, device=x.device) for i in indices)
    return x.index_put(idx, value.to(x.dtype), accumulate)


@primitive
def masked_select(x, mask, name=None):
    return torch.masked_select(x, mask)


@primitive
def masked_fill(x, mask, value, name=None):
    v = value.to(x.dtype) if isinstance(value, torch.Tensor) else \
        torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return torch.where(mask, v, x)


@primitive
def where(condition, x=None, y=None, name=None):
    if condition.dtype != torch.bool:
        condition = condition != 0          # numpy's truth of a value
    if x is None and y is None:
        return where_single(condition)
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x = torch.as_tensor(x, device=condition.device)
    from .math import _pair
    x, y = _pair(x, y)
    return torch.where(condition, x, y)


@primitive
def where_single(condition):
    return list(torch.nonzero(condition, as_tuple=True))


@primitive
def nonzero(x, as_tuple=False, name=None):
    if as_tuple:
        return list(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


@primitive
def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@primitive
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    from ..framework.dtype import to_torch_dtype
    dt = to_torch_dtype(dtype)
    vals, inv, cnt = torch.unique(x, sorted=True, return_inverse=True,
                                  return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return vals
    out = [vals]
    if return_index:
        n = x.numel() if axis is None else x.shape[axis]
        pos = torch.arange(n, device=x.device)
        first = torch.full((vals.shape[0] if axis is None
                            else vals.shape[axis],), n, device=x.device,
                           dtype=pos.dtype)
        out.append(first.scatter_reduce(0, inv.reshape(-1), pos, "amin")
                   .to(dt))
    if return_inverse:
        out.append(inv.reshape(-1).to(dt) if axis is None else inv.to(dt))
    if return_counts:
        out.append(cnt.to(dt))
    return tuple(out)


@primitive
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    from ..framework.dtype import to_torch_dtype
    dt = to_torch_dtype(dtype)
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis")
    vals, inv, cnt = torch.unique_consecutive(
        x.reshape(-1), return_inverse=True, return_counts=True)
    outs = [vals]
    if return_inverse:
        outs.append(inv.to(dt))
    if return_counts:
        outs.append(cnt.to(dt))
    return outs[0] if len(outs) == 1 else tuple(outs)


@primitive
def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


@primitive
def swapaxes(x, axis1, axis2, name=None):
    return torch.swapaxes(x, int(axis1), int(axis2))


@primitive
def slice(x, axes, starts, ends, name=None):
    idx = [_pyslice(None)] * x.ndim
    for ax, st, en in zip(axes, _ints(starts), _ints(ends)):
        idx[ax] = _pyslice(st, en)
    return x[tuple(idx)]


primitive(slice, name="slice_op")


@primitive
def strided_slice(x, axes, starts, ends, strides, name=None):
    out = x
    for ax, st, en, sd in zip(axes, _ints(starts), _ints(ends),
                              _ints(strides)):
        idx = [_pyslice(None)] * x.ndim
        if sd > 0:
            idx[ax] = _pyslice(st, en, sd)
            out = out[tuple(idx)]
        else:
            n = out.shape[ax]
            pos = list(range(n))[_pyslice(st, en, sd)]
            out = torch.index_select(out, ax, torch.tensor(
                pos, dtype=torch.int64, device=x.device))
    return out


@primitive
def crop(x, shape=None, offsets=None, name=None):
    offsets = _ints(offsets) if offsets is not None else [0] * x.ndim
    shape = _ints(shape) if shape is not None else list(x.shape)
    return x[tuple(_pyslice(o, o + s) for o, s in zip(offsets, shape))]


def _torch_index(idx, device):
    """A Paddle index (Tensors, lists, numpy arrays, slices with tensor
    bounds) as torch indexes it."""
    from ..tensor import Tensor

    def norm(i):
        if isinstance(i, Tensor):
            i = i._value
        if isinstance(i, torch.Tensor):
            return i.to(device) if i.device != device else i
        if isinstance(i, np.ndarray):
            return torch.from_numpy(np.array(i)).to(device)
        if isinstance(i, list):
            return torch.as_tensor(
                [(v._value.item() if isinstance(v, Tensor) else v)
                 for v in i], device=device)
        if isinstance(i, _pyslice):
            return _pyslice(*(None if v is None else _int(
                v._value if isinstance(v, Tensor) else v)
                for v in (i.start, i.stop, i.step)))
        return i

    if isinstance(idx, tuple):
        return tuple(norm(i) for i in idx)
    return norm(idx)


@primitive
def getitem(x, idx):
    return x[_torch_index(idx, x.device)]


@primitive
def as_strided(x, shape, stride, offset=0, name=None):
    return torch.as_strided(x, tuple(shape), tuple(stride), int(offset))


@primitive
def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(tuple(_ints(shape_or_dtype)))
    from ..framework.dtype import to_torch_dtype
    return x.view(to_torch_dtype(shape_or_dtype))


@primitive
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * shard_size, (shard_id + 1) * shard_size
    in_range = (input >= lo) & (input < hi)
    return torch.where(in_range, input - lo,
                       torch.full_like(input, ignore_value))


@primitive
def tensordot(x, y, axes=2, name=None):
    return torch.tensordot(x, y, dims=axes)


@primitive
def kron(x, y, name=None):
    return torch.kron(x, y)


@primitive
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return torch.searchsorted(sorted_sequence, x, out_int32=out_int32,
                              right=right)


def tolist(x):
    from ..tensor import unwrap
    return unwrap(x).tolist()


@primitive
def unflatten(x, axis, shape, name=None):
    return torch.unflatten(x, _int(axis), tuple(_ints(shape)))


def _stack_like(fn, name):
    def op(x, name=None):
        return fn(list(x))
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = f"``{name}`` of the tensors of ``x``."
    return primitive(op)


hstack = _stack_like(torch.hstack, "hstack")
vstack = _stack_like(torch.vstack, "vstack")
dstack = _stack_like(torch.dstack, "dstack")
row_stack = _stack_like(torch.vstack, "row_stack")
column_stack = _stack_like(torch.column_stack, "column_stack")


def _atleast(fn):
    def op(*xs, name=None):
        outs = [fn(x) if x.ndim < 3 else x.clone() for x in xs]
        outs = [o.clone() if o is x else o for o, x in zip(outs, xs)]
        return outs if len(outs) > 1 else outs[0]
    return op


atleast_1d = primitive(_atleast(torch.atleast_1d), name="atleast_1d")
atleast_2d = primitive(_atleast(torch.atleast_2d), name="atleast_2d")
atleast_3d = primitive(_atleast(torch.atleast_3d), name="atleast_3d")


@primitive
def masked_scatter(x, mask, value, name=None):
    n_true = int(torch.broadcast_to(mask, x.shape).sum())
    if n_true > value.numel():
        raise ValueError(
            f"masked_scatter: mask selects {n_true} elements but value "
            f"has only {value.numel()}")
    return torch.masked_scatter(x, mask, value.to(x.dtype))


@primitive
def tensor_split(x, num_or_indices, axis=0, name=None):
    return list(torch.tensor_split(x, num_or_indices, dim=_int(axis)))


@primitive
def block_diag(inputs, name=None):
    mats = list(inputs)
    return torch.block_diag(*[m.to(mats[0].dtype) for m in mats])


@primitive
def take(x, index, mode="raise", name=None):
    flat = x.reshape(-1)
    n = flat.shape[0]
    if mode == "wrap":
        idx = torch.remainder(index, n)
    elif mode == "clip":
        idx = torch.clamp(index, 0, n - 1)
    else:
        idx = torch.where(index < 0, index + n, index)
    return flat[idx]


@primitive
def mode(x, axis=-1, keepdim=False, name=None):
    axis = _int(axis) % x.ndim
    xm = torch.movedim(x, axis, -1)
    n = xm.shape[-1]
    s = torch.sort(xm, dim=-1).values
    counts = (s[..., :, None] == s[..., None, :]).sum(-1)
    best = torch.argmax(counts, dim=-1)
    values = torch.gather(s, -1, best[..., None])[..., 0]
    pos = torch.arange(n, device=x.device)
    last = torch.where(xm == values[..., None], pos,
                       torch.full_like(pos, -1)).amax(-1)
    if keepdim:
        values, last = values.unsqueeze(axis), last.unsqueeze(axis)
    return values, last


@primitive
def index_fill(x, index, axis, value, name=None):
    axis = _int(axis) % x.ndim
    mask = torch.zeros(x.shape[axis], dtype=torch.bool, device=x.device)
    mask[index] = True
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    v = value.to(x.dtype) if isinstance(value, torch.Tensor) else \
        torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return torch.where(mask.reshape(shape), v, x)


@primitive
def hsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, 0 if x.ndim == 1 else 1)


@primitive
def vsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, 0)


@primitive
def dsplit(x, num_or_indices, name=None):
    return tensor_split(x, num_or_indices, 2)


@primitive
def view_as(x, other, name=None):
    return x.reshape(tuple(other.shape))


@primitive
def slice_scatter(x, value, axes=(), starts=(), ends=(), strides=(), **_kw):
    idx = [_pyslice(None)] * x.ndim
    for a, s, e, st in zip(axes, starts, ends, strides):
        idx[int(a)] = _pyslice(int(s), int(e), int(st))
    out = x.clone()
    out[tuple(idx)] = value.to(x.dtype)
    return out


@primitive
def select_scatter(x, values, axis, index, **_kw):
    return torch.select_scatter(x, values.to(x.dtype), int(axis), int(index))


@primitive
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, **_kw):
    nd = x.ndim
    n, m = x.shape[int(axis1) % nd], x.shape[int(axis2) % nd]
    off = int(offset)
    length = builtins.min(n, m - off) if off >= 0 else builtins.min(
        n + off, m)
    if length <= 0:
        raise ValueError(
            f"diagonal_scatter: offset {off} is out of range for diagonal "
            f"dims ({n}, {m})")
    return torch.diagonal_scatter(x, y.to(x.dtype), off, int(axis1),
                                  int(axis2))
