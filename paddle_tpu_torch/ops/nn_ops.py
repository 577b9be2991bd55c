"""Composed operators of the port (counterpart of the attention part of
``paddle_tpu/ops/nn_ops.py``)."""

from __future__ import annotations

import math

import torch


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Composed attention over ``[B, S, H, D]`` (Paddle's layout), the
    counterpart of ``nn_ops.scaled_dot_product_attention``: scores
    ``q k^T / sqrt(D)``, a causal mask and ``attn_mask`` (bool: keep
    where True, else the most negative float; float: added, e.g. BERT's
    ``[B, 1, 1, S]`` padding mask of -1e4), softmax, dropout with
    ``generator``'s bits while training, then ``P v``.  The arithmetic
    is fp32 whatever the input dtype (the JAX form runs in the input
    dtype promoted with the mask's); the output is in ``query``'s
    dtype.  Plain PyTorch: the port's masked path, not a library
    kernel."""
    q, k, v = (t.transpose(1, 2).float() for t in (query, key, value))
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    neg = torch.finfo(torch.float32).min
    if is_causal:
        sq, sk = logits.shape[-2:]
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=logits.device).tril()
        logits = logits.masked_fill(~keep, neg)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, neg)
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and training:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < (1.0 - dropout_p)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return out.transpose(1, 2).to(query.dtype)
