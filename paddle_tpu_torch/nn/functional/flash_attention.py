"""The public flash-attention function (counterpart of
``paddle_tpu/nn/functional/__init__.py::flash_attention`` and
``paddle_tpu/ops/pallas_ops.py::flash_attention``).

``[B, S, H, D]`` in and out, Paddle's convention.  Without dropout it
runs :class:`~paddle_tpu_torch.ops.FlashAttnFunc`: the CUDA kernels on
the card, their plain versions on the CPU.  There is no eligibility
test and no fallback: the kernels mask the ragged edge themselves, so
any ``Sq``/``Sk`` goes to them.  ``dropout > 0`` while training runs
the composed attention with the port's generator, as the JAX package
runs its composed XLA form.
"""

from __future__ import annotations

import torch

from ...framework import random as _random
from ...ops.flash_attention_kernel import (FlashAttnFunc,
                                           flash_attention_reference)


def _segments(segment_ids, kv_segment_ids, b, sk, device):
    if segment_ids is None:
        return None, None
    qseg = torch.as_tensor(segment_ids, device=device).to(torch.int32)
    kseg = (qseg if kv_segment_ids is None else torch.as_tensor(
        kv_segment_ids, device=device).to(torch.int32))
    if kseg.shape[1] != sk:
        raise ValueError(f"kv_segment_ids length {kseg.shape[1]} != Sk {sk}")
    if qseg.shape[0] != b or kseg.shape[0] != b:
        raise ValueError(f"segment ids must have batch {b}, got "
                         f"{qseg.shape[0]} and {kseg.shape[0]}")
    return qseg.contiguous(), kseg.contiguous()


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    training=True, segment_ids=None, kv_segment_ids=None,
                    name=None, generator=None):
    """Attention over ``[B, Sq, H, D]`` queries and ``[B, Sk, Hkv, D]``
    keys/values; returns ``(out [B, Sq, H, D], None)`` as the JAX
    package does (the softmax is never returned).

    ``key``/``value`` may have fewer heads (GQA/MQA): they are repeated
    up to the query heads before the kernel, as the JAX package does.
    ``segment_ids`` ``[B, Sq]`` / ``kv_segment_ids`` ``[B, Sk]`` mask
    attention across packed sequences; with only ``segment_ids`` it is
    used for both sides.  ``causal`` needs ``Sq == Sk``.  ``generator``
    (default: the port's generator for the device) draws the dropout
    mask."""
    b, sq, hq, d = query.shape
    sk, hkv = key.shape[1], key.shape[2]
    if causal and sq != sk:
        raise ValueError(
            f"causal flash_attention requires Sq == Sk, got {sq} vs {sk}")
    if hq != hkv:
        if hq % hkv != 0:
            raise ValueError(
                f"GQA requires query heads ({hq}) divisible by kv heads "
                f"({hkv})")
        rep = hq // hkv
        key = torch.repeat_interleave(key, rep, dim=2)
        value = torch.repeat_interleave(value, rep, dim=2)
    qseg, kseg = _segments(segment_ids, kv_segment_ids, b, sk, query.device)
    if dropout > 0.0 and training:
        gen = (generator if generator is not None
               else _random.default_generator(query.device))
        out, _ = flash_attention_reference(
            query, key, value, causal, qseg, kseg, dropout_p=float(dropout),
            generator=gen)
    else:
        out = FlashAttnFunc.apply(query, key, value, bool(causal), qseg,
                                  kseg)
    return out, None
