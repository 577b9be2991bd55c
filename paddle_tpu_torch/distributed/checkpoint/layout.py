"""Where a rank's tensor sits in the whole one: the layouts the
distributed checkpoint writes and reshards by.

A :class:`Layout` maps the elements of a rank's local tensor onto a
global (logical) tensor of shape ``global_shape`` by a list of
:class:`Segment` s: each is a box of the global tensor (``offsets``,
``lengths``) whose elements lie contiguously, in row-major order, in the
local tensor's flat view from ``start`` on.  One box covers a plain
tensor (the whole, or an mp shard); a flat range of a local tensor (a
sharding stage's or the sharded weight update's chunk) becomes a few
boxes, each contiguous.

The layouts of the port's parallel pieces:

- a parameter split by an mp layer (``is_mp_split``) covers the box of
  its ``split_axis`` at ``mp rank * local size`` of the global extent
  ``mp degree * local size`` (``_mp_coords`` holds ``(rank, degree)``);
  a ``split_view`` (GPT's fused qkv: ``(3, heads, head_dim)``) views the
  split axis as those global sizes and splits its ``split_view_axis``
  (the heads), so a rank's q, k and v heads are one box;
- a chunk of a sharding stage or of the sharded weight update (stage 2
  over the dp group): :meth:`Layout.flat_range` of its parameter's
  layout.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class Segment(NamedTuple):
    offsets: Tuple[int, ...]
    lengths: Tuple[int, ...]
    start: int


def _flat_boxes(a, b, shape):
    """Elements ``[a, b)`` of a row-major ``shape`` as ``(offsets,
    lengths, first)`` boxes, each contiguous (``first`` its first
    element's flat index)."""
    if b <= a:
        return []
    if not shape:
        return [((), (), 0)]
    if len(shape) == 1:
        return [((a,), (b - a,), a)]
    inner = math.prod(shape[1:])
    i0, i1 = a // inner, (b - 1) // inner

    def row(i, lo, hi):
        return [((i,) + o, (1,) + l, s + i * inner)
                for o, l, s in _flat_boxes(lo, hi, shape[1:])]

    if i0 == i1:
        return row(i0, a - i0 * inner, b - i0 * inner)
    out, lo, hi, tail = [], i0, i1 + 1, []
    if a % inner:
        out += row(i0, a - i0 * inner, inner)
        lo = i0 + 1
    if b % inner:
        tail = row(i1, 0, b - i1 * inner)
        hi = i1
    if hi > lo:
        out.append(((lo,) + (0,) * (len(shape) - 1),
                    (hi - lo,) + tuple(shape[1:]), lo * inner))
    return out + tail


class Layout:
    """``global_shape`` and the :class:`Segment` s of a local tensor of
    ``local_shape`` (module docstring)."""

    def __init__(self, global_shape, segments, local_shape):
        self.global_shape = tuple(int(s) for s in global_shape)
        self.segments = [Segment(tuple(o), tuple(l), int(s))
                         for o, l, s in segments]
        self.local_shape = tuple(int(s) for s in local_shape)

    @classmethod
    def whole(cls, shape):
        shape = tuple(shape)
        return cls(shape, [((0,) * len(shape), shape, 0)], shape)

    @property
    def is_whole(self) -> bool:
        return (len(self.segments) == 1 and self.segments[0].lengths ==
                self.global_shape == self.local_shape)

    def key(self):
        """What two ranks holding the same piece share."""
        return (self.global_shape, tuple(self.segments))

    def __eq__(self, other):
        return isinstance(other, Layout) and self.key() == other.key() \
            and self.local_shape == other.local_shape

    def __repr__(self):
        return (f"Layout(global {self.global_shape}, local "
                f"{self.local_shape}, {len(self.segments)} segments)")

    def _sub(self, ranges, local_shape):
        """The piece of the local tensor made of local flat ranges
        ``(a, b, new_start)``: each maps through the segments it meets,
        ``new_start`` being where ``a`` lands in the piece."""
        segs = []
        for a, b, at in ranges:
            for seg in self.segments:
                n = math.prod(seg.lengths)
                lo, hi = max(a, seg.start), min(b, seg.start + n)
                if hi <= lo:
                    continue
                for o, l, s in _flat_boxes(lo - seg.start, hi - seg.start,
                                           seg.lengths):
                    segs.append((tuple(x + y for x, y in
                                       zip(seg.offsets, o)), l,
                                 at + (seg.start + s - a)))
        return Layout(self.global_shape, segs, local_shape)

    def flat_range(self, a, b, local_len=None) -> "Layout":
        """The layout of elements ``[a, b)`` of the local tensor's flat
        view, held as a 1-d tensor of ``local_len`` elements (``b - a``
        when None; past ``b - a`` the tensor is padding, in no
        segment)."""
        b = max(a, b)
        return self._sub([(a, b, 0)],
                         ((b - a) if local_len is None else local_len,))

    def take(self, whole):
        """This piece of the whole tensor ``whole``."""
        out = torch.zeros(self.local_shape, dtype=whole.dtype,
                          device=whole.device)
        flat = out.view(-1)
        for seg in self.segments:
            box = whole[tuple(slice(o, o + n) for o, n in
                              zip(seg.offsets, seg.lengths))]
            flat[seg.start:seg.start + box.numel()].copy_(box.reshape(-1))
        return out

    def wrap(self, local):
        return ShardedTensor(local, self)


class ShardedTensor:
    """A rank's local tensor with its :class:`Layout`: how a state dict
    presents a slice of a whole-shape tensor (a sharded update's
    moments in ``Optimizer.state_dict()``), and a template
    leaf of :func:`~paddle_tpu_torch.distributed.checkpoint.
    load_state_dict` that fills ``local`` in place."""

    is_sharded_tensor = True

    def __init__(self, local, layout: Layout):
        if tuple(local.shape) != layout.local_shape:
            raise ValueError(f"local shape {tuple(local.shape)} does not "
                             f"match {layout}")
        self.local = local
        self.layout = layout

    @property
    def shape(self):
        return self.layout.global_shape

    def __repr__(self):
        return f"ShardedTensor({self.layout}, {self.local.dtype})"

    def local_for(self, layout, local_shape):
        """This value as the local tensor of ``layout`` (None: a whole
        tensor of ``local_shape``); raises unless it holds every element
        that layout needs."""
        if layout is None:
            layout = Layout.whole(local_shape)
        if layout == self.layout:
            return self.local
        if self.layout.is_whole:
            return layout.take(self.local.reshape(self.layout.global_shape))
        raise ValueError(
            f"a slice ({self.layout}) does not hold {layout}; load it "
            "through distributed.checkpoint.load_state_dict")


def _mp_box(p, shape):
    """``(global_shape, offsets)`` of parameter ``p`` (local ``shape``)
    under its mp split and its ``split_view``."""
    from ..fleet.meta_parallel.mp_layers import is_mp_split
    split = is_mp_split(p)
    axis = getattr(p, "split_axis", None)
    view = getattr(p, "split_view", None)
    rank, degree = getattr(p, "_mp_coords", (0, 1)) if split else (0, 1)
    if axis is None:
        if split:
            raise ValueError("an mp-split parameter without split_axis")
        return shape, (0,) * len(shape), shape
    axis %= max(len(shape), 1)
    if view is not None:
        vaxis = getattr(p, "split_view_axis", 0)
        gview = tuple(view)
        lview = list(gview)
        lview[vaxis] = gview[vaxis] // degree
        if math.prod(lview) != shape[axis]:
            raise ValueError(f"split_view {gview} does not view dim {axis} "
                             f"of {shape} at mp degree {degree}")
        off = [0] * len(gview)
        off[vaxis] = rank * lview[vaxis]
        gshape = shape[:axis] + gview + shape[axis + 1:]
        local = shape[:axis] + tuple(lview) + shape[axis + 1:]
        offsets = (0,) * axis + tuple(off) + (0,) * (len(shape) - axis - 1)
        return gshape, offsets, local
    gshape = list(shape)
    gshape[axis] = shape[axis] * degree
    offsets = [0] * len(shape)
    offsets[axis] = rank * shape[axis]
    return tuple(gshape), tuple(offsets), shape


def param_layout(p) -> Layout:
    """The layout of a model parameter (or any tensor carrying the mp
    marks): a piece's own ``_global_layout`` when it has one, else its
    mp box (module docstring), else the whole."""
    own = getattr(p, "_global_layout", None)
    if own is not None:
        return own
    shape = tuple(p.shape)
    gshape, offsets, local = _mp_box(p, shape)
    return Layout(gshape, [(offsets, local, 0)], shape)
