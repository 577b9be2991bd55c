"""Tensor-parallel layers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py``; upstream
``fleet/layers/mpu/mp_layers.py``).

The JAX layers hold full-size arrays tagged with a sharding spec and
leave the split to XLA.  Here each rank holds its own shard, in
Megatron's layout (upstream Paddle's), and the collectives are the
``mp_ops`` operators:

- ``ColumnParallelLinear``: weight ``[in, out / mp]`` and bias
  ``[out / mp]``; ``c_identity`` on the input, the output all-gathered
  when ``gather_output``;
- ``RowParallelLinear``: weight ``[in / mp, out]``, the input split
  unless ``input_is_parallel``, the partial products all-reduced, then
  the (replicated) bias added;
- ``VocabParallelEmbedding``: rows ``rank * V/mp ..`` of the table; an
  id outside them looks up row 0 and is zeroed, and the lookups are
  all-reduced;
- ``ParallelCrossEntropy``: ``mp_ops.parallel_cross_entropy`` over
  logits split on the vocabulary.

The mp group is the registered topology's (``fleet.init``) unless
``mp_group`` is given.  At mp 1 each layer is the plain one (``Linear``,
``Embedding``, ``F.cross_entropy``): the same parameter names, layouts
and initial draws, so a model built of them keeps its single-card
numbers.  The split weights carry ``is_distributed = True`` (the hybrid
clip sums their squares over the mp group); :func:`is_mp_split` reads
the mark.  Each split weight also carries its ``split_axis`` and
``_mp_coords`` (mp rank, degree), from which the distributed checkpoint
places its shard in the whole tensor.
"""

from __future__ import annotations

from ....nn.common import Embedding, Linear
from ....nn.layer import Layer
from ....ops import nn_ops
from .mp_ops import (c_concat, c_identity, c_split, mp_allreduce,
                     parallel_cross_entropy)


def is_mp_split(p) -> bool:
    """Whether an mp layer split ``p`` over its group.  Only an explicit
    ``True`` counts: on a torch tensor without the mark,
    ``is_distributed`` is ``torch.Tensor``'s method, which is truthy."""
    return getattr(p, "is_distributed", False) is True


def _mp_group(mp_group):
    if mp_group is not None:
        return mp_group
    from ..base.topology import _get_hybrid_parallel_group
    hcg = _get_hybrid_parallel_group()
    return hcg.get_model_parallel_group() if hcg is not None else None


def _degree(group) -> int:
    return 1 if group is None else group.nranks


def _mark(p, axis, group, n):
    """The split's geometry on ``p`` (the checkpoint's layout reads it):
    ``split_axis`` (upstream's attribute) and ``_mp_coords`` ``(rank,
    degree)``."""
    p.split_axis = axis
    p._mp_coords = (group.rank, n) if n > 1 else (0, 1)


def _split(n, parts, what):
    if n % parts:
        raise ValueError(f"{what} {n} does not divide by mp degree {parts}")
    return n // parts


class ColumnParallelLinear(Linear):
    """``y = x @ W + b`` with ``W``'s output columns split over mp."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, init_std=None, device=None,
                 generator=None):
        group = _mp_group(mp_group)
        n = _degree(group)
        super().__init__(in_features,
                         _split(out_features, n, "out_features"),
                         weight_attr=weight_attr,
                         bias_attr=None if has_bias in (None, True)
                         else False, init_std=init_std, device=device,
                         generator=generator)
        self._in_features, self._out_features = in_features, out_features
        self.gather_output = gather_output
        self.is_mp = n > 1
        self._group = group if n > 1 else None
        self.weight.is_distributed = n > 1
        _mark(self.weight, 1, group, n)
        if self.bias is not None:
            self.bias.is_distributed = n > 1
            _mark(self.bias, 0, group, n)

    def forward(self, x):
        if self._group is None:
            return super().forward(x)
        out = nn_ops.linear(c_identity(x, self._group), self.weight,
                            self.bias)
        return c_concat(out, self._group) if self.gather_output else out


class RowParallelLinear(Linear):
    """``y = x @ W + b`` with ``W``'s input rows split over mp."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 init_std=None, device=None, generator=None):
        group = _mp_group(mp_group)
        n = _degree(group)
        super().__init__(_split(in_features, n, "in_features"),
                         out_features, weight_attr=weight_attr,
                         bias_attr=None if has_bias else False,
                         init_std=init_std, device=device,
                         generator=generator)
        self._in_features, self._out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.is_mp = n > 1
        self._group = group if n > 1 else None
        self.weight.is_distributed = n > 1
        _mark(self.weight, 0, group, n)
        if self.bias is not None:
            self.bias.is_distributed = False

    def forward(self, x):
        if self._group is None:
            return super().forward(x)
        if not self.input_is_parallel:
            x = c_split(x, self._group)
        out = mp_allreduce(nn_ops.linear(x, self.weight, None), self._group)
        return out if self.bias is None else out + self.bias


class VocabParallelEmbedding(Embedding):
    """Embedding table split on its rows (the vocabulary) over mp."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, init_std=None, device=None,
                 generator=None):
        group = _mp_group(mp_group)
        n = _degree(group)
        per = _split(num_embeddings, n, "num_embeddings")
        super().__init__(per, embedding_dim, weight_attr=weight_attr,
                         init_std=init_std, device=device,
                         generator=generator)
        self._num_embeddings = num_embeddings
        self._group = group if n > 1 else None
        self._start = group.rank * per if n > 1 else 0
        self.weight.is_distributed = n > 1
        _mark(self.weight, 0, group, n)

    def forward(self, ids):
        if self._group is None:
            return super().forward(ids)
        per = self.weight.shape[0]
        local = ids - self._start
        inside = (local >= 0) & (local < per)
        local = local.masked_fill(~inside, 0)
        out = nn_ops.embedding(local, self.weight)
        out = out * inside.unsqueeze(-1).to(out.dtype)
        return mp_allreduce(out, self._group)


class ParallelCrossEntropy(Layer):
    """Per-token softmax cross-entropy over vocab-split logits
    (``reduction="none"``; 0 where the label is ``ignore_index``)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        group = _mp_group(mp_group)
        self._group = group if _degree(group) > 1 else None

    def forward(self, input, label):
        if self._group is None:
            return nn_ops.cross_entropy(input, label, reduction="none",
                                        ignore_index=self.ignore_index)
        (input,) = nn_ops.cast_inputs("cross_entropy", input)
        return parallel_cross_entropy(input, label, self._group,
                                      self.ignore_index)


def mark_as_sequence_parallel_parameter(parameter):
    parameter.sequence_parallel = True
