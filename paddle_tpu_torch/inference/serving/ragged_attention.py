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
