"""Shape operators of the port (counterpart of the ``nn`` and vision
zoo's part of ``paddle_tpu/ops/manipulation.py``, with ``one_hot`` of
``ops/creation.py``): ``flatten``, ``split``, ``reshape``,
``transpose``, ``expand``, ``pad`` and ``unfold`` cast by the AMP rule
as the JAX primitives do.  ``concat`` does not: the JAX ``concat`` is a
closure outside the AMP hook, so its inputs meet in the widest dtype
there too."""

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


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
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


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col of ``[N, C, H, W]``: ``[N, C*kh*kw, L]``, channel-major
    (counterpart of ``manipulation.unfold``; a padding list gives its
    first two elements, the H and W pads, as the JAX function reads
    it)."""
    (x,) = cast_inputs("unfold", x)

    def two(v):
        return tuple(v[:2]) if isinstance(v, (list, tuple)) else (v, v)

    return torch.nn.functional.unfold(x, two(kernel_sizes), two(dilations),
                                      two(paddings), two(strides))


def one_hot(x, num_classes):
    """The float32 one-hot rows of the ids ``x`` (counterpart of
    ``creation.one_hot``); an id outside ``[0, num_classes)`` gives a
    zero row, as ``jax.nn.one_hot`` does."""
    ids = x.long()
    valid = (ids >= 0) & (ids < num_classes)
    out = torch.nn.functional.one_hot(ids.clamp(0, num_classes - 1),
                                      num_classes).float()
    return out * valid.unsqueeze(-1)
