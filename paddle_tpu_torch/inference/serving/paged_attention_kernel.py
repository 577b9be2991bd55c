"""Ragged paged decode attention: the hand-written CUDA kernels, their
wrapper, their plain versions and their launch counts (counterpart of
``paddle_tpu/inference/serving/paged_attention_kernel.py``).

The kernel (``csrc/paged_attention_sm90.cu``) splits each request's
context over several CTAs (split-K), brings its K/V tiles into shared
memory by 1-D bulk asynchronous copies straight through the page table,
and merges the splits' partial softmax states in a second launch in a
fixed order.  Every launch number comes from the shapes alone
(:func:`split_plan`), never from the lengths, so a launch never waits
on the device.  It never builds the ``[B, MAXNB*BS, H, Dh]`` gather
that the plain version (:func:`paged_ragged_attention_reference`)
materialises; :func:`paged_split_reference` is the plain mirror of its
partition.

:func:`paged_ragged_attention` is the only entry: on CUDA tensors it
launches the kernel or raises, on CPU tensors it runs the plain
version.  Nothing falls back from CUDA to the plain version or to the
kernel it replaced (``csrc/paged_attention.cu``, one CTA per (head,
request)), which stays reachable for comparison on the card as
:func:`_cuda_core_paged`; no path of the port calls it.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ... import _build
from .kv_cache import gather_pages
from .ragged_attention import (DENOM_TINY, MASK_VALUE,
                               ragged_decode_attention)

KERNEL_NAME = "paged_attention_sm90"
CORE_KERNEL_NAME = "paged_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_libs = {}
# the current stream's handle without building a torch.cuda.Stream
# (present in CUDA builds of torch)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)

# The plan's constants (split_plan).
STAGE_BYTES = 48 * 1024   # K + V of one tile
STAGES = 2                # tiles in a CTA's ring
CTAS_PER_SM = 2           # ring ~96 KB and <= 416 threads a CTA
CONSUMER_THREADS = 384    # consumer threads a CTA aims at
MIN_TILE = 4              # tokens a tile holds at least, heads permitting


class Launch(ctypes.Structure):
    """``struct Launch`` of ``csrc/paged_attention_sm90.cu``: a launch's
    numbers, packed once per shape and passed by address."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "dtype", "B", "H", "Dh", "NB", "BS", "MAXNB", "heads", "tile",
        "token_groups", "stages", "split_tokens", "splits")] + [
        ("scale", ctypes.c_float)]


def bind(lib):
    """Set the argument types of a library built from
    ``csrc/paged_attention_sm90.cu``; returns it."""
    fn = lib.paddle_paged_attention_sm90
    fn.argtypes = [ctypes.c_void_p] * 9
    fn.restype = ctypes.c_int
    return lib


def bind_core(lib):
    """The same for ``csrc/paged_attention.cu`` (the comparison entry)."""
    fn = lib.paddle_paged_attention
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _lib(name):
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        lib = bind(lib) if name == KERNEL_NAME else bind_core(lib)
        _libs[name] = lib
    return lib


class SplitPlan(NamedTuple):
    """One launch's numbers (see ``csrc/paged_attention_sm90.cu``)."""
    heads: int          # heads a CTA takes (a divisor of H)
    tile: int           # tokens a ring tile holds at most
    token_groups: int   # lane groups per head, each taking every n-th token
    stages: int         # tiles in the ring
    split_tokens: int   # tokens a split (a CTA) takes
    splits: int         # ceil(MAXNB*BS / split_tokens)


def group_lanes(Dh: int, itemsize: int) -> int:
    """Lanes a head's row takes: one 16-byte chunk each, a power of two
    from 2 to 32 (two chunks a lane past 32 chunks)."""
    chunks = Dh * itemsize // 16
    return min(32, max(2, 1 << (chunks - 1).bit_length()))


def split_plan(B: int, H: int, Dh: int, BS: int, MAXNB: int, itemsize: int,
               sms: int) -> SplitPlan:
    """Every launch number of the kernel, from the shapes only.

    A CTA takes all ``H`` heads when a tile of ``MIN_TILE`` tokens' K
    and V fits ``STAGE_BYTES`` and a lane group for each head fits
    ``CONSUMER_THREADS``, else the most heads (a divisor of H) that do;
    a tile holds as many tokens as fit, at most a page.  The
    split count fills ``CTAS_PER_SM`` CTAs on each of the ``sms`` SMs
    over the ``B x H/heads`` (request, head group) pairs, at most one
    split per tile of the longest possible context (``MAXNB*BS``), and
    the split length is a whole number of tiles.  The lengths never
    enter, so any lengths of one shape launch the same grid."""
    head_bytes = Dh * itemsize
    lanes = group_lanes(Dh, itemsize)
    heads = max(d for d in range(1, H + 1) if H % d == 0 and (d == 1 or (
        2 * MIN_TILE * d * head_bytes <= STAGE_BYTES
        and d * lanes <= CONSUMER_THREADS)))
    tile = max(1, min(BS, STAGE_BYTES // (2 * heads * head_bytes)))
    token_groups = max(1, min(tile, CONSUMER_THREADS // (heads * lanes)))
    T = MAXNB * BS
    pairs = B * (H // heads)
    splits = max(1, min(-(-T // tile), CTAS_PER_SM * sms // pairs))
    split_tokens = -(-T // splits)
    split_tokens = -(-split_tokens // tile) * tile
    return SplitPlan(heads, tile, token_groups, STAGES, split_tokens,
                     -(-T // split_tokens))


_SMS = {}


def _sm_count(idx: int) -> int:
    n = _SMS.get(idx)
    if n is None:
        n = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def _stream(idx: int) -> int:
    """The handle of device ``idx``'s current stream."""
    if _raw_stream is not None:
        return _raw_stream(idx)
    return torch.cuda.current_stream(idx).cuda_stream


def paged_ragged_attention_reference(pool_k, pool_v, page_table, lengths,
                                     q, scale=None):
    """The plain version: page-table gather + masked ragged attention
    (the JAX package's "gather" mode)."""
    pool = torch.stack([pool_k, pool_v])[None]    # [1, 2, NB, BS, H, Dh]
    kp, vp = gather_pages(pool, 0, page_table)
    return ragged_decode_attention(q, kp, vp, lengths, scale=scale)


def paged_split_partials(pool_k, pool_v, page_table, lengths, q,
                         split_tokens, scale=None):
    """Each split's partial softmax state as the kernel's CTAs leave it:
    ``(m, l, acc)`` in fp32, ``[B, S, H]``, ``[B, S, H]`` and ``[B, S, H,
    Dh]`` for ``S = ceil(MAXNB*BS / split_tokens)`` splits, split ``s``
    over the tokens ``[s*split_tokens, (s+1)*split_tokens)`` below the
    length (clamped to ``[0, MAXNB*BS]``; page ids clamped to the pool).
    A split with no token is ``(MASK_VALUE, 0, 0)``."""
    NB, BS, H, Dh = pool_k.shape
    B, MAXNB = page_table.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    T = MAXNB * BS
    S = -(-T // split_tokens)
    pool = torch.stack([pool_k, pool_v])[None]
    k, v = gather_pages(pool, 0, page_table.clamp(0, NB - 1))
    pad = (0, 0, 0, 0, 0, S * split_tokens - T)
    k = torch.nn.functional.pad(k.float(), pad).reshape(
        B, S, split_tokens, H, Dh)
    v = torch.nn.functional.pad(v.float(), pad).reshape(
        B, S, split_tokens, H, Dh)
    lens = lengths.to(device=q.device, dtype=torch.int64).clamp(0, T)
    valid = (torch.arange(S * split_tokens, device=q.device)[None, :]
             < lens[:, None]).reshape(B, S, 1, split_tokens)
    logits = torch.einsum("bhd,bsthd->bsht", q.float(), k) * scale
    logits = torch.where(valid, logits, MASK_VALUE)
    m = logits.amax(dim=-1)
    w = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    return m, w.sum(dim=-1), torch.einsum("bsht,bsthd->bshd", w, v)


def paged_split_combine(m, l, acc, lengths, split_tokens, max_tokens,
                        dtype):
    """The kernel's second launch: the partials of the splits ``s <
    ceil(len/split_tokens)`` (len clamped to ``[0, max_tokens]``) merged
    in split order; ``[B, H, Dh]`` in ``dtype``, an empty row exactly 0."""
    S = m.shape[1]
    lens = lengths.to(device=m.device, dtype=torch.int64).clamp(
        0, max_tokens)
    active = (torch.arange(S, device=m.device)[None, :]
              < (lens[:, None] + split_tokens - 1) // split_tokens)
    act = active[..., None]                            # [B, S, 1]
    mx = torch.where(act, m, MASK_VALUE).amax(dim=1)   # [B, H]
    ls = torch.zeros_like(mx)
    a = torch.zeros_like(acc[:, 0])
    for s in range(S):
        w = torch.where(act[:, s], torch.exp(m[:, s] - mx), 0.0)
        ls = ls + l[:, s] * w
        a = a + acc[:, s] * w[..., None]
    return (a / ls.clamp_min(DENOM_TINY)[..., None]).to(dtype)


def paged_split_reference(pool_k, pool_v, page_table, lengths, q,
                          split_tokens, scale=None):
    """The plain mirror of the kernel's partition: each split's partial
    from the gathered rows (:func:`paged_split_partials`), merged in the
    kernel's order (:func:`paged_split_combine`)."""
    m, l, acc = paged_split_partials(pool_k, pool_v, page_table, lengths, q,
                                     split_tokens, scale)
    BS = pool_k.shape[1]
    return paged_split_combine(m, l, acc, lengths, split_tokens,
                               page_table.shape[1] * BS, q.dtype)


def _check(pool_k, pool_v, page_table, lengths, q):
    if pool_k.dim() != 4 or pool_v.shape != pool_k.shape:
        raise ValueError(
            f"pool_k/pool_v must both be [NB, BS, H, Dh], got "
            f"{tuple(pool_k.shape)} and {tuple(pool_v.shape)}")
    NB, BS, H, Dh = pool_k.shape
    if q.dim() != 3 or tuple(q.shape[1:]) != (H, Dh):
        raise ValueError(f"q must be [B, {H}, {Dh}], got {tuple(q.shape)}")
    B = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be [{B}, MAXNB], got "
                         f"{tuple(page_table.shape)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got "
                         f"{tuple(lengths.shape)}")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    devices = {t.device for t in (pool_k, pool_v, page_table, lengths, q)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share one device, got {devices}")


def _kernel_ready(pool_k, pool_v, page_table, lengths, q):
    """The CUDA kernels' own limits (the plain version takes anything)."""
    Dh = pool_k.shape[3]
    if q.dtype not in _DTYPE_CODES or pool_k.dtype != q.dtype or \
            pool_v.dtype != q.dtype:
        raise TypeError(
            f"kernel takes float32, bfloat16 or float16 with q in the "
            f"pool's dtype; got q {q.dtype}, pool {pool_k.dtype}/"
            f"{pool_v.dtype}")
    if Dh % 16 or not 0 < Dh <= 256:
        raise ValueError(f"kernel takes Dh a multiple of 16 up to 256, "
                         f"got {Dh}")
    if not all(t.is_contiguous()
               for t in (pool_k, pool_v, page_table, lengths, q)):
        raise ValueError("kernel inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (pool_k, pool_v, q)):
        raise ValueError("q and the pools must be 16-byte aligned")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


_launches = {}    # shapes, dtype, scale, plan -> (Launch, address, floats)
_workspaces = {}  # (device, stream, floats) -> the split's fp32 partials
_calls = {}       # a call's shapes, dtype, scale, device, stream, plan ->
                  # (address of its Launch, workspace pointer)


def _prepare(stream, pool_k, page_table, q, scale, sms, plan):
    """The packed launch numbers (one per shape) and the partials'
    workspace (one per device, stream and size) of a call."""
    NB, BS, H, Dh = pool_k.shape
    B, MAXNB = page_table.shape
    if plan is None:
        plan = split_plan(B, H, Dh, BS, MAXNB, q.element_size(), sms)
    key = (NB, BS, H, Dh, B, MAXNB, q.dtype, scale, plan)
    entry = _launches.get(key)
    if entry is None:
        desc = Launch(_DTYPE_CODES[q.dtype], B, H, Dh, NB, BS, MAXNB, *plan,
                      scale)
        floats = B * plan.splits * H * (Dh + 2) if plan.splits > 1 else 0
        entry = _launches[key] = (desc, ctypes.addressof(desc), floats)
    _, desc_ptr, floats = entry
    if not floats:
        return desc_ptr, None
    wkey = (q.device, stream, floats)
    ws = _workspaces.get(wkey)
    if ws is None:
        ws = _workspaces[wkey] = q.new_empty(floats, dtype=torch.float32)
    return desc_ptr, ws.data_ptr()


def _launch_sm90(lib, stream, pool_k, pool_v, page_table, lengths, q,
                 scale, sms, plan=None, out=None):
    """Launch ``csrc/paged_attention_sm90.cu`` (split and, with several
    splits, combine) through ``lib`` on ``stream``, writing ``out`` (a
    new tensor like ``q`` by default); ``plan`` defaults to
    :func:`split_plan` of the shapes and ``sms``.  Returns the output.

    A call's launch numbers and workspace are looked up once per shape
    and stream (:func:`_prepare`), so a decode step's twelve calls pay
    one dictionary lookup each.  The workspace is reused: calls on one
    stream run in order, so a call's split never overwrites partials
    that the previous call's combine still reads."""
    key = (pool_k.shape, page_table.shape, q.dtype, scale, q.get_device(),
           stream, sms, plan)
    call = _calls.get(key)
    if call is None:
        call = _calls[key] = _prepare(stream, pool_k, page_table, q, scale,
                                      sms, plan)
    desc_ptr, ws_ptr = call
    if out is None:
        out = torch.empty_like(q)
    _raise_on(lib.paddle_paged_attention_sm90(
        desc_ptr, q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws_ptr,
        stream), "paged attention")
    return out


def _launch_core(lib, stream, pool_k, pool_v, page_table, lengths, q,
                 scale):
    """Launch ``csrc/paged_attention.cu`` through ``lib``."""
    NB, BS, H, Dh = pool_k.shape
    B, MAXNB = page_table.shape
    out = torch.empty_like(q)
    _raise_on(lib.paddle_paged_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
        pool_v.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, H, Dh, NB, BS, MAXNB, float(scale), stream),
        "paged attention (CUDA-core comparison)")
    return out


def paged_ragged_attention(pool_k, pool_v, page_table, lengths, q,
                           scale=None):
    """Paged decode attention over one layer's pool.

    ``pool_k``/``pool_v`` ``[NB, BS, H, Dh]``; ``page_table``
    ``[B, MAXNB]`` int32; ``lengths`` ``[B]`` int32; ``q`` ``[B, H,
    Dh]``.  Returns ``[B, H, Dh]`` in ``q``'s dtype.  CPU tensors run
    the plain version.  CUDA tensors launch the split-K kernel (and its
    combine) on the current stream without synchronising; it takes
    fp32, bf16 or fp16 with ``q`` in the pool's dtype, contiguous
    inputs, ``q`` and the pools 16-byte aligned and ``Dh`` a multiple of
    16 up to 256, and anything else raises.  Each call on the card adds
    one to ``paged_ragged_attention.launches`` (the split and the
    combine together).
    """
    _check(pool_k, pool_v, page_table, lengths, q)
    Dh = pool_k.shape[3]
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    if q.device.type == "cpu":
        return paged_ragged_attention_reference(pool_k, pool_v, page_table,
                                                lengths, q, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _kernel_ready(pool_k, pool_v, page_table, lengths, q)
    if q.shape[0] == 0:
        return torch.empty_like(q)
    lib = _lib(KERNEL_NAME)
    idx = q.get_device()
    with torch.cuda.device(idx):
        out = _launch_sm90(lib, _stream(idx), pool_k, pool_v, page_table,
                           lengths, q, scale, _sm_count(idx))
    paged_ragged_attention.launches += 1
    return out


paged_ragged_attention.launches = 0


def _cuda_core_paged(pool_k, pool_v, page_table, lengths, q, scale=None):
    """The kernel :func:`paged_ragged_attention` replaced
    (``csrc/paged_attention.cu``: one CTA per (head, request) walking the
    whole context), kept for comparison on the card.  No path of the
    port calls it; its launches count in ``_cuda_core_paged.launches``,
    not in the wrapper's.  CUDA tensors only."""
    _check(pool_k, pool_v, page_table, lengths, q)
    if q.device.type != "cuda":
        raise ValueError("_cuda_core_paged runs on the card only")
    _kernel_ready(pool_k, pool_v, page_table, lengths, q)
    if scale is None:
        scale = 1.0 / math.sqrt(pool_k.shape[3])
    if q.shape[0] == 0:
        return torch.empty_like(q)
    lib = _lib(CORE_KERNEL_NAME)
    with torch.cuda.device(q.device):
        out = _launch_core(lib, _stream(q.get_device()), pool_k, pool_v,
                           page_table, lengths, q, scale)
    _cuda_core_paged.launches += 1
    return out


_cuda_core_paged.launches = 0


def attention_bytes(lengths, block_size: int, num_heads: int,
                    head_dim: int, itemsize: int) -> int:
    """Least device-memory bytes one call must move: the K and V rows of
    every real position (``sum(lengths)``), q read once, out written
    once, the lengths and the int32 page-table entries the walk
    reads."""
    lens = [max(0, int(n)) for n in lengths]
    row = num_heads * head_dim * itemsize
    pages = sum(-(-n // block_size) for n in lens)
    return 2 * sum(lens) * row + 2 * len(lens) * row + 4 * (len(lens)
                                                           + pages)
