"""Ragged batched attention over paged KV (counterpart of
``paddle_tpu/inference/serving/ragged_attention.py``).

The mask arithmetic is built for exactness against a per-request
dense reference:

- masked logits are a large finite negative (never ``-inf``) and an
  explicit ``where`` pins their weights to exact ``0.0``;
- the denominator is ``max(sum, DENOM_TINY)``: bit-inert for a row with
  any valid position, while an all-masked row (empty batch slot)
  returns ``0`` instead of ``NaN``;
- statistics run in f32; the output returns in the input dtype.

:func:`paged_decode_attention` is THE decode-attention seam.  It picks
by the tensors' device: CUDA tensors go to the hand-written kernel
(``paged_attention_kernel.py``), CPU tensors to its plain version.
"""

from __future__ import annotations

import math

import torch

#: large-finite mask value (``-inf`` breeds NaN under 0*inf folding)
MASK_VALUE = -1e30
#: denominator guard — bit-inert for any row with >= 1 valid position
DENOM_TINY = 1e-30


def paged_decode_attention(pool, layer, page_table, lengths, q):
    """Per-request single-token queries against the paged KV pool.

    ``pool`` ``[L, 2, NB, BS, H, Dh]``; ``page_table`` ``[B, MAXNB]``
    int32; ``lengths`` ``[B]`` int32 (positions ``t < lengths[b]``
    attend); ``q`` ``[B, H, Dh]``.  Returns ``[B, H, Dh]`` in ``q``'s
    dtype.  On a CUDA tensor this launches the paged-attention kernel
    (or raises); on a CPU tensor it runs the kernel's plain version.
    """
    from .paged_attention_kernel import paged_ragged_attention
    return paged_ragged_attention(pool[layer, 0], pool[layer, 1],
                                  page_table, lengths, q.contiguous())


def ragged_decode_attention(q, k, v, lengths, scale=None):
    """Single-token queries against per-request ragged contexts.

    ``q`` ``[B, H, Dh]``; ``k``/``v`` ``[B, T, H, Dh]`` (padded to a
    common ``T``); ``lengths`` ``[B]`` int — request ``b`` attends
    positions ``t < lengths[b]``.  Returns ``[B, H, Dh]`` in ``q``'s
    dtype.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    orig = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.einsum("bhd,bthd->bht", qf, kf) * scale
    T = k.shape[1]
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.to(device=q.device, dtype=torch.int64)[:, None])
    valid = valid[:, None, :]                           # [B, 1, T]
    logits = torch.where(valid, logits, MASK_VALUE)
    m = logits.amax(dim=-1, keepdim=True)
    w = torch.where(valid, torch.exp(logits - m), 0.0)
    denom = w.sum(dim=-1, keepdim=True).clamp_min(DENOM_TINY)
    out = torch.einsum("bht,bthd->bhd", w / denom, vf)
    return out.to(orig)


def chunked_prefill_attention(q, k_ctx, v_ctx, ctx_len, k_chunk, v_chunk,
                              scale=None):
    """Attention of one prefill *chunk* against the cached context plus
    itself.

    ``q``/``k_chunk``/``v_chunk`` ``[B, C, H, Dh]``: the chunk's
    projections; ``k_ctx``/``v_ctx`` ``[B, T, H, Dh]``: the page gather
    of what the cache holds already (prefix-cache hits, earlier
    chunks), padded to ``T``; ``ctx_len`` (an int, or a ``[1]`` tensor
    on ``q``'s device, as a captured chunk holds it): the real context
    extent.  Chunk row ``i`` (position ``ctx_len + i``) attends every
    valid context position and chunk positions ``j <= i``: the rows a
    whole-prompt causal prefill computes for those positions, in the
    same masked-softmax arithmetic (exact zeros, f32 statistics), so a
    chunk boundary changes only the order of the sums.  Returns ``[B,
    C, H, Dh]`` in ``q``'s dtype.  No TPU kernel computes this: it is
    composed in both packages.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    orig = q.dtype
    C, T = q.shape[1], k_ctx.shape[1]
    dev = q.device
    kf = torch.cat([k_ctx, k_chunk], dim=1).float()
    # [B, H, C, T + C], worked on in place: at a 32k context in 1k
    # chunks it is the largest tensor of the prefill
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    del kf
    cols = torch.arange(T + C, device=dev)[None, :]
    rows = torch.arange(C, device=dev)[:, None]
    if not isinstance(ctx_len, torch.Tensor):
        ctx_len = int(ctx_len)
    invalid = torch.where(cols < T, cols >= ctx_len,
                          cols - T > rows)                # [C, T + C]
    logits.masked_fill_(invalid, MASK_VALUE)
    m = logits.amax(dim=-1, keepdim=True)
    w = logits.sub_(m).exp_().masked_fill_(invalid, 0.0)
    denom = w.sum(dim=-1, keepdim=True).clamp_min(DENOM_TINY)
    vf = torch.cat([v_ctx, v_chunk], dim=1).float()
    out = torch.einsum("bhqk,bkhd->bqhd", w.div_(denom), vf)
    return out.to(orig)


def causal_prefill_attention(q, k, v, scale=None):
    """Dense causal attention for the prefill pass.

    ``q``/``k``/``v`` ``[B, S, H, Dh]`` → ``[B, S, H, Dh]``.  Same
    explicit masked-softmax arithmetic as
    :func:`ragged_decode_attention`, so a bucket-padded prefill computes
    the real prompt rows exactly as an unpadded one does.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    orig = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    S = q.shape[1]
    causal = torch.ones((S, S), dtype=torch.bool,
                        device=q.device).tril()[None, None]
    logits = torch.where(causal, logits, MASK_VALUE)
    m = logits.amax(dim=-1, keepdim=True)
    w = torch.where(causal, torch.exp(logits - m), 0.0)
    denom = w.sum(dim=-1, keepdim=True).clamp_min(DENOM_TINY)
    out = torch.einsum("bhqk,bkhd->bqhd", w / denom, vf)
    return out.to(orig)
