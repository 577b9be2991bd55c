"""Compressed dp collectives (counterpart of
``paddle_tpu/distributed/compressed.py``; technique: EQuARX, arxiv
2506.17615).

The JAX functions run inside a ``shard_map`` over a mesh axis and move
their payloads by ``lax.ppermute``; these take a process group
(``group=`` where the JAX ones take ``axis_name``) and move them by the
port's ``isend`` / ``irecv`` pairs, each hop posting its send and its
receive before waiting on either (a blocking host send on gloo
deadlocks the ring).  The ring, its chunk order, the padding to
``block * W`` and the fp32 accumulation are the JAX package's:

- :func:`quantized_all_reduce`: W-1 reduce-scatter hops (the partial of
  chunk ``(r - s) mod W`` crosses at hop ``s``), then W-1 all-gather hops
  of the owner's **decoded** payload, so every rank ends with the same
  array (an owner that kept its exact chunk would let the replicas drift
  apart step by step);
- ``bits=8``: int8 blocks of ``block`` elements with a bf16 scale a
  block, stochastically rounded (the noise from ``generator``, or the
  draws given to :func:`_block_quant` as ``noise``); the int8 and bf16
  tensors cross as what they are;
- ``bits=16``: each fp32 element crosses as its high and low 16-bit
  halves (``int16`` bit views) and is rebuilt exactly: the parity
  anchor, bit-identical to a plain all-reduce at W = 2;
- :func:`ring_reduce_scatter`: the reduce-scatter half alone, rank ``r``
  keeping shard ``r`` along ``shard_axis`` (the sharded weight update's
  gradient side);
- :func:`bf16_all_reduce`, :func:`compressed_psum_tree` and the byte
  model (:func:`wire_bits_per_element`, :func:`dp_comm_bytes_per_step`).

The codec is composed from torch operations; a fused codec kernel is
later work.  On a group without a process group (one rank) every
function returns its input.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .communication import all_reduce, get_group, irecv, isend


def _block_quant(x, block, bits, generator=None, noise=None):
    """``x`` ``[N]`` fp32 -> ``(int8 [N], bf16 scales [N / block, 1])``
    with stochastic rounding: the uniform draws on ``[-0.5, 0.5)`` come
    from ``noise`` when given (shape ``[N / block, block]``), else from
    ``generator``.  The scale is rounded to bf16 before the division, so
    the receiver dequantizes with the scale the sender quantized by."""
    q_max = float(2 ** (bits - 1) - 1)
    xb = x.reshape(-1, block)
    scale = xb.abs().amax(dim=1, keepdim=True) / q_max
    scale = torch.clamp_min(scale, 1e-30).to(torch.bfloat16)
    y = xb / scale.float()
    if noise is None:
        noise = torch.rand(y.shape, generator=generator, device=y.device,
                           dtype=y.dtype) - 0.5
    q = torch.clamp(torch.round(y + noise.to(y.dtype)), -q_max, q_max)
    return q.to(torch.int8), scale


def _block_dequant(q, scale):
    return (q.float() * scale.float()).reshape(-1)


def _split16(x):
    """Lossless fp32 -> two 16-bit words (the high and the low half of
    the bit pattern, as ``int16`` bit views): the high half is x's bf16
    truncation, the low half the rest of the mantissa."""
    u = x.float().contiguous().view(torch.int32)
    return (u >> 16).to(torch.int16), (u & 0xFFFF).to(torch.int16)


def _merge16(hi, lo):
    u = (hi.to(torch.int32) << 16) | (lo.to(torch.int32) & 0xFFFF)
    return u.view(torch.float32)


def _encode_hop(x, bits, block, generator=None):
    """One hop's wire payload for fp32 ``x``: the tensors that cross."""
    if bits == 16:
        return _split16(x)
    return _block_quant(x, block, bits, generator)


def _decode_hop(payload, bits, shape):
    if bits == 16:
        return _merge16(*payload).reshape(shape)
    return _block_dequant(*payload).reshape(shape)


def _ring_hop(payload, group):
    """``payload`` to the next rank of ``group``, the previous rank's in
    return (the JAX ``ppermute`` with ``perm = [(i, i + 1 mod W)]``):
    every send and receive posted, then waited."""
    r, w = group.rank, group.nranks
    nxt, prv = group.ranks[(r + 1) % w], group.ranks[(r - 1) % w]
    got = [torch.empty_like(p) for p in payload]
    tasks = []
    for p, g in zip(payload, got):
        tasks.append(isend(p.contiguous(), dst=nxt, group=group))
        tasks.append(irecv(g, src=prv, group=group))
    for t in tasks:
        t.wait()
    return tuple(got)


def wire_bits_per_element(bits: int, block: int = 256) -> float:
    """Wire bits of one fp32 element on one hop: 8 -> int8 and its share
    of the bf16 block scale; 16 (the exact split) and 0 -> 32."""
    if bits == 8:
        return 8.0 + 16.0 / block
    return 32.0


def dp_comm_bytes_per_step(n_elems: int, world: int, bits: int,
                           sharded_update: bool, block: int = 256) -> int:
    """Modeled dp bytes a rank a step (the JAX function): a ring
    all-reduce of the gradients at the mode's wire width, or under the
    sharded update their reduce-scatter at that width plus the
    all-gather of the updated parameters at 32 bits."""
    if world <= 1:
        return 0
    hops = (world - 1) / world * n_elems
    grad_bits = wire_bits_per_element(bits or 0, block)
    if sharded_update:
        return int(hops * (grad_bits + 32.0) / 8)
    return int(2 * hops * grad_bits / 8)


def _pad_to(x, mult):
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % mult
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, n


def _default_generator(device, group, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 1000003 + group.rank)
    return gen


def quantized_all_reduce(x, group=None, bits: int = 8, block: int = 256,
                         generator: Optional[torch.Generator] = None):
    """Sum of ``x`` over ``group`` through the encoded ring (module
    docstring): fp32 arithmetic, the result cast back to ``x``'s dtype,
    the same array on every rank.  ``generator`` draws the stochastic
    rounding at bits 8 (a generator on ``x``'s device; default one
    seeded by the rank)."""
    g = get_group(group)
    w = g.nranks
    if w == 1 or g.pg is None:
        return x
    r = g.rank
    if bits == 8 and generator is None:
        generator = _default_generator(x.device, g)
    orig = x.dtype
    flat, n = _pad_to(x.float(), block * w)
    chunks = flat.view(w, -1)
    cshape = chunks[0].shape
    acc = torch.zeros(cshape, dtype=torch.float32, device=x.device)
    for s in range(w - 1):
        part = chunks[(r - s) % w] + acc
        payload = _ring_hop(_encode_hop(part, bits, block, generator), g)
        acc = _decode_hop(payload, bits, cshape)
    own = (r + 1) % w
    final = chunks[own] + acc
    payload = _encode_hop(final, bits, block, generator)
    out = torch.empty((w,) + tuple(cshape), dtype=torch.float32,
                      device=x.device)
    out[own] = _decode_hop(payload, bits, cshape)
    for s in range(w - 1):
        payload = _ring_hop(payload, g)
        out[(r - s) % w] = _decode_hop(payload, bits, cshape)
    return out.reshape(-1)[:n].reshape(x.shape).to(orig)


def ring_reduce_scatter(x, group=None, shard_axis: int = 0, bits: int = 8,
                        block: int = 256,
                        generator: Optional[torch.Generator] = None):
    """Sum of ``x`` over ``group``, of which rank ``r`` keeps shard ``r``
    along ``shard_axis`` (which W must divide): W-1 hops, the partial of
    chunk ``(r - s - 1) mod W`` crossing at hop ``s``, each chunk padded
    to a whole number of blocks."""
    g = get_group(group)
    w = g.nranks
    if w == 1 or g.pg is None:
        return x
    r = g.rank
    if bits == 8 and generator is None:
        generator = _default_generator(x.device, g)
    orig = x.dtype
    xf = torch.movedim(x.float(), shard_axis, 0)
    lead = xf.shape[0]
    if lead % w:
        raise ValueError(f"dim {shard_axis} of {tuple(x.shape)} does not "
                         f"divide by {w}")
    rows = xf.reshape((w, lead // w) + tuple(xf.shape[1:]))
    shard_shape = rows.shape[1:]
    size = math.prod(shard_shape)
    per = -(-size // block) * block
    chunks = torch.zeros((w, per), dtype=torch.float32, device=x.device)
    chunks[:, :size] = rows.reshape(w, -1)
    cshape = chunks[0].shape
    acc = torch.zeros(cshape, dtype=torch.float32, device=x.device)
    for s in range(w - 1):
        part = chunks[(r - s - 1) % w] + acc
        payload = _ring_hop(_encode_hop(part, bits, block, generator), g)
        acc = _decode_hop(payload, bits, cshape)
    own = chunks[r] + acc
    shard = own[:size].reshape(shard_shape)
    return torch.movedim(shard, 0, shard_axis).to(orig)


def bf16_all_reduce(x, group=None):
    """The 2x-compressed all-reduce: bf16 crosses and accumulates."""
    y = x.to(torch.bfloat16)
    all_reduce(y, group=group)
    return y.to(x.dtype)


def compressed_psum_tree(tree, group=None, mode="int8",
                         generator: Optional[torch.Generator] = None,
                         **kw):
    """Each leaf of a dict / list / tuple tree summed over ``group``:
    mode ``'int8'`` / 8 (the int8 ring), ``'exact16'`` / 16 (the exact
    ring), ``'bf16'`` or ``'none'`` (the plain all-reduce)."""
    if mode == "none":
        def fn(leaf):
            out = leaf.clone()
            all_reduce(out, group=group)
            return out
    elif mode == "bf16":
        def fn(leaf):
            return bf16_all_reduce(leaf, group)
    else:
        if mode in ("int8", 8):
            bits = 8
        elif mode in ("exact16", "int16", 16):
            bits = 16
        else:
            raise ValueError(f"unknown compressed allreduce mode {mode!r}")

        def fn(leaf):
            return quantized_all_reduce(leaf, group, bits=bits,
                                        generator=generator, **kw)
    return _tree_map(fn, tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
