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

By default the kernels read strided ``[B, S, H, D]`` views in place
(the JAX package's packed layout).  ``PADDLE_TORCH_FLASH_NO_PACKED``
takes the JAX package's ``[B*H, S, D]`` path instead: q, k and v are
copied to contiguous ``[B*H, S, D]`` (segment ids repeated per head),
the forward is ``flash_fwd_hpack`` when ``PADDLE_TORCH_FLASH_HEADPACK``
is above 1, there are no segment ids, ``B*H`` divides by it and the
head dim is at most 64 (the rule of ``_pallas_flash_bh``), else
``flash_fwd``; the backward is ``flash_bwd_fused`` under
``PADDLE_TORCH_FLASH_FUSED_BWD``, else the split pair.  The head-pack
rule is the JAX package's dispatch, not a fallback: a kernel that
fails raises.
"""

from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs
from ...framework import env_knobs
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


def _flash_bh(query, key, value, causal, qseg, kseg):
    """The ``[B*H, S, D]`` path (``pallas_ops.flash_attention``'s
    ``moveaxis`` branch): contiguous copies, handed to the kernels as
    ``[B*H, S, 1, D]``, and the output moved back to ``[B, S, H, D]``."""
    b, sq, h, d = query.shape

    def to_bh(t):
        return t.transpose(1, 2).contiguous().view(b * h, t.shape[1], 1, d)

    q, k, v = to_bh(query), to_bh(key), to_bh(value)
    qs = None if qseg is None else qseg.repeat_interleave(h, dim=0)
    ks = None if kseg is None else kseg.repeat_interleave(h, dim=0)
    hp = env_knobs.get_int("PADDLE_TORCH_FLASH_HEADPACK", 1)
    if not (hp > 1 and qs is None and (b * h) % hp == 0 and d <= 64):
        hp = 1
    fused = env_knobs.get_bool("PADDLE_TORCH_FLASH_FUSED_BWD")
    out = FlashAttnFunc.apply(q, k, v, bool(causal), qs, ks, hp, fused)
    return out.view(b, h, sq, d).transpose(1, 2)


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
    # the JAX function is the primitive "flash_attention", which
    # auto_cast casts (on the white list: O1 runs it in the low dtype)
    query, key, value = cast_inputs("flash_attention", query, key, value)
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
    elif env_knobs.get_bool("PADDLE_TORCH_FLASH_NO_PACKED"):
        out = _flash_bh(query, key, value, causal, qseg, kseg)
    else:
        out = FlashAttnFunc.apply(query, key, value, bool(causal), qseg,
                                  kseg)
    return out, None
