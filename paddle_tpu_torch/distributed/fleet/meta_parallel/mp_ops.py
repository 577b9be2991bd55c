"""The mp communication operators of the Megatron layers (upstream
Paddle's ``fleet/layers/mpu/mp_ops.py``; the JAX package has no
counterpart: XLA's SPMD partitioner inserts these collectives itself).

Each is a ``torch.autograd.Function`` over the mp group:

- :func:`c_identity`: identity forward, all-reduce (sum) backward: the
  input of a column-parallel product, whose gradient each rank forms
  only for its own columns;
- :func:`mp_allreduce`: all-reduce forward, identity backward: the
  partial products of a row-parallel product (and of the vocab-parallel
  lookup);
- :func:`c_split` / :func:`c_concat`: this rank's slice of the last dim
  forward (all-gather backward), and the reverse;
- :func:`parallel_cross_entropy`: softmax cross-entropy over logits
  split on the vocabulary: the row max and the sum of exponentials
  all-reduced (max, then sum), the label's logit summed from the rank
  that holds it; fp32 arithmetic; the gradient ``softmax - onehot``
  on each rank's slice, 0 where the label is ``ignore_index``;
- :func:`vocab_parallel_lmce`: the fused lm-head cross-entropy over a
  vocabulary split across the group (rank ``r`` holds rows ``r * V/P``
  .. of the tied weight): each rank runs the ``ops/lmce_kernel.py``
  kernels on its shard; the forward's label is the local index where it
  falls in the shard and -1 elsewhere (loss 0, lse still formed), the
  picked logit ``lse_r - loss_r`` on the shard's rows, the ``lse_r``
  all-gathered and merged by ``logsumexp`` in rank order (one float on
  every rank), the picked logits summed; the loss ``lse - pick`` where
  the label is >= 0.  The backward kernels take the merged lse and the
  label the local index, ``V/P`` (outside the shard: the softmax term
  only) where it is valid elsewhere, -1 where it is ignored.  ``dh`` is
  summed over the group by the ``c_identity`` the caller put on the
  hidden states, not here.  :func:`vocab_parallel_lmce_reference` is
  the same composition on the plain versions.
"""

from __future__ import annotations

import torch

from ...communication import ReduceOp, all_gather, all_reduce


def _group_size(group) -> int:
    return 1 if group is None else group.nranks


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce(g, group=ctx.group)
        return g, None


class _MpAllreduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x, group):
    parts = []
    all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _slice_last(x, group):
    n = x.shape[-1] // group.nranks
    r = group.rank
    return x[..., r * n:(r + 1) * n].contiguous()


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _slice_last(g, ctx.group), None


def c_identity(x, group):
    return x if _group_size(group) <= 1 else _CIdentity.apply(x, group)


def mp_allreduce(x, group):
    return x if _group_size(group) <= 1 else _MpAllreduce.apply(x, group)


def c_split(x, group):
    return x if _group_size(group) <= 1 else _CSplit.apply(x, group)


def c_concat(x, group):
    return x if _group_size(group) <= 1 else _CConcat.apply(x, group)


class _ParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label, group, ignore_index, start):
        lf = logits.float()
        n = lf.shape[-1]
        m = lf.detach().amax(-1)
        all_reduce(m, op=ReduceOp.MAX, group=group)
        e = torch.exp(lf - m.unsqueeze(-1))
        s = e.sum(-1)
        all_reduce(s, group=group)
        local = label.to(torch.int64) - start
        inside = (local >= 0) & (local < n)
        safe = torch.where(inside, local, torch.zeros_like(local))
        pred = torch.gather(lf, -1, safe.unsqueeze(-1)).squeeze(-1)
        pred = torch.where(inside, pred, torch.zeros_like(pred))
        all_reduce(pred, group=group)
        valid = (label != ignore_index).to(torch.float32)
        loss = (torch.log(s) + m - pred) * valid
        e.div_(s.unsqueeze(-1))
        ctx.save_for_backward(e, safe, inside, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        soft, safe, inside, valid = ctx.saved_tensors
        grad = soft.clone()
        grad.scatter_add_(-1, safe.unsqueeze(-1),
                          -inside.to(grad.dtype).unsqueeze(-1))
        grad.mul_((g.float() * valid).unsqueeze(-1))
        return grad.to(ctx.dtype), None, None, None, None


def parallel_cross_entropy(logits, label, group, ignore_index=-100):
    """Per-token loss of ``logits`` ``[..., V / mp]`` (this rank's vocab
    slice: rows ``rank * V/mp ..``) against ``label`` ``[...]``."""
    start = group.rank * logits.shape[-1]
    return _ParallelCrossEntropy.apply(logits, label, group, ignore_index,
                                       start)


def _vocab_labels(labels, start, per):
    lab = labels.to(torch.int64)
    local = lab - start
    inside = (lab >= 0) & (local >= 0) & (local < per)
    lab_fwd = torch.where(inside, local, torch.full_like(local, -1))
    lab_bwd = torch.where(inside, local, torch.where(
        lab >= 0, torch.full_like(local, per), torch.full_like(local, -1)))
    return (lab, inside, lab_fwd.to(torch.int32), lab_bwd.to(torch.int32))


def _vocab_merge(loss_r, lse_r, lab, inside, group):
    """The whole vocabulary's ``(loss, lse)`` from each rank's."""
    pick = torch.where(inside, lse_r - loss_r, torch.zeros_like(lse_r))
    parts = []
    all_gather(parts, lse_r.contiguous(), group=group)
    lse = torch.logsumexp(torch.stack(parts), dim=0)
    all_reduce(pick, group=group)
    loss = torch.where(lab >= 0, lse - pick, torch.zeros_like(lse))
    return loss, lse


class _VocabParallelLMCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, group, fwd, bwd_dh, bwd_dw):
        start = group.rank * w.shape[0]
        lab, inside, lab_fwd, lab_bwd = _vocab_labels(labels, start,
                                                      w.shape[0])
        loss_r, lse_r = fwd(h, w, lab_fwd)
        loss, lse = _vocab_merge(loss_r, lse_r, lab, inside, group)
        ctx.save_for_backward(h, w, lab_bwd, lse)
        ctx.bwd = (bwd_dh, bwd_dw)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        h, w, lab_bwd, lse = ctx.saved_tensors
        bwd_dh, bwd_dw = ctx.bwd
        g = g.float()
        dh = bwd_dh(h, w, lab_bwd, lse, g)
        dw = bwd_dw(h, w, lab_bwd, lse, g)
        return dh, dw, None, None, None, None, None


def vocab_parallel_lmce(h, w, labels, group):
    """Per-token cross-entropy of ``softmax(h @ W.T)`` over the whole
    vocabulary, ``w`` ``[V/P, D]`` being this rank's rows of ``W``
    (module docstring): fp32 ``[N]``, 0 where a label is negative.  Runs
    the ``lmce_fwd`` / ``lmce_bwd_dh`` / ``lmce_bwd_dw`` wrappers."""
    from ....ops import lmce_kernel as lk
    return _VocabParallelLMCE.apply(h, w, labels, group, lk.lmce_fwd,
                                    lk.lmce_bwd_dh, lk.lmce_bwd_dw)


def vocab_parallel_lmce_reference(h, w, labels, group):
    """:func:`vocab_parallel_lmce` on the plain versions
    (``lmce_reference`` and the plain backwards), on any device."""
    from ....ops import lmce_kernel as lk

    def fwd(h, w, lab):
        with torch.no_grad():
            return lk.lmce_reference(h, w, lab)

    return _VocabParallelLMCE.apply(h, w, labels, group, fwd,
                                    lk.lmce_bwd_dh_reference,
                                    lk.lmce_bwd_dw_reference)
