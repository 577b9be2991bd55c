"""Context parallelism over the sep group: ring attention and Ulysses
attention (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/context_parallel.py``).

The JAX package writes both as ``shard_map`` programs over global
tensors.  In the port every rank of the sep group holds its own slice
of the sequence, ``[B, S / sep, H, D]``, and the functions take and
return that slice:

- ring attention (:func:`ring_flash_attention`): the K/V block of each
  rank passes around the ring (to the left neighbour, from the right
  one, ``isend`` / ``irecv`` posted together so the ring cannot wait on
  itself), and each rank folds every block into its queries' online
  softmax ``(m, l, acc)`` in fp32, with the causal mask of each (query
  block, source block) pair from the rows' global positions; a block
  wholly above the diagonal is skipped.  The backward is a
  ``torch.autograd.Function`` that runs the ring again: ``dq`` stays
  home, ``dk`` / ``dv`` travel with their block and come home after one
  more hop.  The gradients are those of the JAX scan's autodiff (the
  same softmax, differentiated);
- ``balanced=True``: the zigzag layout (rank ``i`` holds chunks ``i``
  and ``2 sep - 1 - i`` of ``2 sep``; :func:`zigzag_split_sequence`),
  the same ring with that layout's positions;
- Ulysses (:func:`ulysses_attention`): an all-to-all turns the sequence
  split into a head split (``[B, S, H / sep, D]``), the plain attention
  runs on the whole sequence for those heads, and the inverse all-to-all
  restores the sequence split; each all-to-all's backward is the other.

Composed from torch operations, as the JAX functions are composed from
``jnp`` (no kernel, no SDPA).  At sep 1 both are the plain attention
(:func:`~paddle_tpu_torch.ops.flash_attention_kernel.
flash_attention_reference`).

A replicated tensor carries its whole gradient on every rank: the
sequence helpers that cut a global tensor into this rank's slice gather
the gradient in backward, and those that join the slices take this
rank's part of it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ....ops._primitive import boundary
from ....ops.flash_attention_kernel import flash_attention_reference
from ...communication import all_gather, alltoall, irecv, isend

_NEG_INF = -1e30


def _sep_group(mesh=None, group=None):
    if group is not None:
        return group
    if mesh is None:
        from ... import collective as coll
        mesh = coll.get_mesh()
    return None if mesh is None else mesh.get_sep_parallel_group()


def _degree(group) -> int:
    return 1 if group is None else group.nranks


def _plain_attention(q, k, v, causal):
    return flash_attention_reference(q, k, v, causal)[0]


# ---------------------------------------------------------------------------
# the layouts: this rank's rows of the global sequence
# ---------------------------------------------------------------------------
def zigzag_indices(seq_len: int, n_shards: int):
    """Global gather indices of the zigzag layout: rank ``i``'s slice of
    the permuted sequence is chunks ``(i, 2n-1-i)``."""
    c = seq_len // (2 * n_shards)
    order = []
    for i in range(n_shards):
        order.extend(range(i * c, (i + 1) * c))
        j = 2 * n_shards - 1 - i
        order.extend(range(j * c, (j + 1) * c))
    return np.asarray(order, dtype=np.int32)


def _positions(rank, s_loc, n, balanced):
    """Global positions of the ``s_loc`` rows rank ``rank`` holds."""
    if not balanced:
        return np.arange(rank * s_loc, (rank + 1) * s_loc)
    return zigzag_indices(s_loc * n, n)[rank * s_loc:(rank + 1) * s_loc]


def _check_zigzag(seq_len, n, what):
    if seq_len % (2 * n):
        raise ValueError(
            f"{what}: 2*sep_degree = {2 * n} must divide sequence length "
            f"{seq_len}; pad the sequence or change sep_degree")


class _SplitSeq(torch.autograd.Function):
    """This rank's rows (``index``) of a replicated tensor along ``dim``;
    backward gathers every rank's rows into the whole gradient."""

    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        ctx.index = index
        me = index[group.rank].to(x.device)
        return x.index_select(dim, me)

    @staticmethod
    def backward(ctx, g):
        parts = []
        all_gather(parts, g.contiguous(), group=ctx.group)
        whole = torch.cat(parts, dim=ctx.dim)
        order = torch.cat(list(ctx.index)).to(g.device)
        out = torch.empty_like(whole)
        out.index_copy_(ctx.dim, order, whole)
        return out, None, None, None


class _GatherSeq(torch.autograd.Function):
    """The whole tensor from every rank's rows (``index``); backward takes
    this rank's rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, dim, index):
        ctx.group, ctx.dim, ctx.index = group, dim, index
        parts = []
        all_gather(parts, x.contiguous(), group=group)
        whole = torch.cat(parts, dim=dim)
        order = torch.cat(list(index)).to(x.device)
        out = torch.empty_like(whole)
        out.index_copy_(dim, order, whole)
        return out

    @staticmethod
    def backward(ctx, g):
        me = ctx.index[ctx.group.rank].to(g.device)
        return g.index_select(ctx.dim, me), None, None, None


def _row_index(seq_len, n, balanced):
    s_loc = seq_len // n
    return [torch.as_tensor(_positions(r, s_loc, n, balanced),
                            dtype=torch.long) for r in range(n)]


@boundary
def split_sequence(x, seq_axis: str = "sep", dim: int = 1, group=None):
    """This rank's contiguous slice of dim ``dim`` of ``x`` over the sep
    group (the JAX function's constraint onto the sep axis)."""
    group = _sep_group(group=group)
    n = _degree(group)
    if n <= 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"split_sequence: sep degree {n} must divide "
                         f"sequence length {x.shape[dim]}")
    return _SplitSeq.apply(x, group, dim,
                           _row_index(x.shape[dim], n, False))


@boundary
def zigzag_split_sequence(x, seq_axis: str = "sep", dim: int = 1,
                          mesh=None, group=None):
    """This rank's rows of dim ``dim`` in the zigzag layout: chunks
    ``(i, 2n-1-i)`` of ``2n``.  Apply once after the embedding and
    :func:`zigzag_merge_sequence` once before the loss."""
    group = _sep_group(mesh, group)
    n = _degree(group)
    if n <= 1:
        return x
    _check_zigzag(x.shape[dim], n, f"zigzag layout (dim {dim})")
    return _SplitSeq.apply(x, group, dim, _row_index(x.shape[dim], n, True))


@boundary
def zigzag_merge_sequence(x, seq_axis: str = "sep", dim: int = 1,
                          mesh=None, group=None):
    """The whole sequence, in order, from every rank's zigzag rows (the
    inverse of :func:`zigzag_split_sequence`)."""
    group = _sep_group(mesh, group)
    n = _degree(group)
    if n <= 1:
        return x
    return _GatherSeq.apply(x, group, dim,
                            _row_index(x.shape[dim] * n, n, True))


def _gather_sequence(x, group, dim=1):
    """The whole sequence from every rank's contiguous slice."""
    n = _degree(group)
    if n <= 1:
        return x
    return _GatherSeq.apply(x, group, dim,
                            _row_index(x.shape[dim] * n, n, False))


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------
def _rotate(t, group):
    """``t`` to the left neighbour, the right neighbour's in return (the
    send and the receive posted together)."""
    n, r = group.nranks, group.rank
    left, right = group.ranks[(r - 1) % n], group.ranks[(r + 1) % n]
    got = torch.empty_like(t)
    recv = irecv(got, src=right, group=group)
    send = isend(t.contiguous(), dst=left, group=group)
    recv.wait()
    send.wait()
    return got


def _block_mask(q_pos, k_pos, causal, device):
    """``None`` (no mask), ``False`` (every pair masked) or the bool
    ``[Sq, Sk]`` mask of the pairs a query sees."""
    if not causal:
        return None
    if q_pos.max() < k_pos.min():
        return False
    if q_pos.min() >= k_pos.max():
        return None
    return torch.as_tensor(q_pos[:, None] >= k_pos[None, :], device=device)


def _online_update(q, k_blk, v_blk, m, l, acc, mask, scale):
    """One block of the online softmax (the JAX ``_online_update``):
    ``q`` ``[B,H,Sq,D]``, ``k_blk`` / ``v_blk`` ``[B,H,Sk,D]`` fp32,
    ``m`` / ``l`` ``[B,H,Sq,1]``, ``acc`` ``[B,H,Sq,D]``."""
    s = torch.matmul(q, k_blk.transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(-1, keepdim=True)
    acc_new = acc * alpha + torch.matmul(p, v_blk)
    return m_new, l_new, acc_new


def _bhsd(t):
    return t.permute(0, 2, 1, 3).float().contiguous()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, group, balanced):
        n, idx = group.nranks, group.rank
        b, s_loc, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        qf, kv = _bhsd(q), torch.stack([_bhsd(k), _bhsd(v)])
        q_pos = _positions(idx, s_loc, n, balanced)
        m = torch.full((b, h, s_loc, 1), _NEG_INF, device=q.device)
        l = torch.zeros((b, h, s_loc, 1), device=q.device)
        acc = torch.zeros((b, h, s_loc, d), device=q.device)
        for t in range(n):
            src = (idx + t) % n
            mask = _block_mask(q_pos, _positions(src, s_loc, n, balanced),
                               causal, q.device)
            if mask is not False:
                m, l, acc = _online_update(qf, kv[0], kv[1], m, l, acc,
                                           mask, scale)
            if t < n - 1:
                kv = _rotate(kv, group)
        l = l.clamp_min(1e-30)
        out = acc / l
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.causal, ctx.group, ctx.balanced = causal, group, balanced
        return out.permute(0, 2, 1, 3).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, balanced = ctx.group, ctx.causal, ctx.balanced
        n, idx = group.nranks, group.rank
        b, s_loc, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        qf, do = _bhsd(q), _bhsd(dout)
        delta = (do * out).sum(-1, keepdim=True)
        q_pos = _positions(idx, s_loc, n, balanced)
        dq = torch.zeros_like(qf)
        kv = torch.stack([_bhsd(k), _bhsd(v)])
        dkv = torch.zeros_like(kv)
        for t in range(n):
            src = (idx + t) % n
            mask = _block_mask(q_pos, _positions(src, s_loc, n, balanced),
                               causal, q.device)
            if mask is not False:
                s = torch.matmul(qf, kv[0].transpose(-1, -2)) * scale
                if mask is not None:
                    s = s.masked_fill(~mask, _NEG_INF)
                p = torch.exp(s - lse)
                if mask is not None:
                    p = p.masked_fill(~mask, 0.0)
                dkv[1] += torch.matmul(p.transpose(-1, -2), do)
                ds = p * (torch.matmul(do, kv[1].transpose(-1, -2)) - delta)
                dq += torch.matmul(ds, kv[0]) * scale
                dkv[0] += torch.matmul(ds.transpose(-1, -2), qf) * scale
            if t < n - 1:
                both = _rotate(torch.cat([kv, dkv]), group)
                kv, dkv = both[:2], both[2:]
            else:
                dkv = _rotate(dkv, group)

        def back(t, like):
            return t.permute(0, 2, 1, 3).to(like.dtype)

        return (back(dq, q), back(dkv[0], k), back(dkv[1], v), None, None,
                None)


@boundary
def ring_flash_attention(query, key, value, causal=False,
                         seq_axis: str = "sep", mesh=None,
                         balanced: bool = False, group=None):
    """Ring attention over the sep group on this rank's ``[B, S/sep, H,
    D]`` slices (module docstring); ``balanced`` takes the zigzag
    layout.  At sep 1 the plain attention."""
    group = _sep_group(mesh, group)
    n = _degree(group)
    if n <= 1:
        return _plain_attention(query, key, value, causal)
    if balanced:
        _check_zigzag(query.shape[1] * n, n, "balanced ring attention "
                      "(zigzag chunking)")
    return _RingAttention.apply(query, key, value, bool(causal), group,
                                bool(balanced))


# ---------------------------------------------------------------------------
# Ulysses attention
# ---------------------------------------------------------------------------
def _exchange(x, group, split_dim, cat_dim):
    """Chunk ``j`` of ``x`` along ``split_dim`` to rank ``j``; what every
    rank sent here joined along ``cat_dim`` in rank order."""
    outs = []
    alltoall(outs, [c.contiguous() for c in
                    x.chunk(group.nranks, dim=split_dim)], group=group)
    return torch.cat(outs, dim=cat_dim)


class _SeqToHeads(torch.autograd.Function):
    """``[B, S/n, H, D]`` -> ``[B, S, H/n, D]``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, 2, 1)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, 1, 2), None


class _HeadsToSeq(torch.autograd.Function):
    """``[B, S, H/n, D]`` -> ``[B, S/n, H, D]``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, 1, 2)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, 2, 1), None


@boundary
def ulysses_attention(query, key, value, causal=False,
                      seq_axis: str = "sep", mesh=None, group=None):
    """Ulysses attention over the sep group on this rank's ``[B, S/sep,
    H, D]`` slices (``H`` this rank's heads under mp; module
    docstring).  At sep 1 the plain attention."""
    group = _sep_group(mesh, group)
    n = _degree(group)
    if n <= 1:
        return _plain_attention(query, key, value, causal)
    from ... import collective as coll
    mp = coll.model_parallel_degree()
    heads = query.shape[2] * mp
    if query.shape[2] % n:
        raise ValueError(
            f"ulysses attention: num heads {heads} must be divisible by "
            f"sep_degree*mp_degree = {n}*{mp}")
    qg, kg, vg = (_SeqToHeads.apply(t, group) for t in (query, key, value))
    out = _plain_attention(qg, kg, vg, causal)
    return _HeadsToSeq.apply(out, group)
