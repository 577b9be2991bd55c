"""Ragged paged decode attention: the hand-written CUDA kernel, its
wrapper, its plain version and its launch count (counterpart of
``paddle_tpu/inference/serving/paged_attention_kernel.py``).

The kernel (``csrc/paged_attention.cu``) walks each request's page
table through the ``[NB, BS, H, Dh]`` pool with an online softmax and
reads only the request's real positions, so it never builds the
``[B, MAXNB*BS, H, Dh]`` gather that the plain version
(:func:`paged_ragged_attention_reference`) materialises.

:func:`paged_ragged_attention` is the only entry: on CUDA tensors it
launches the kernel or raises, on CPU tensors it runs the plain
version.  Nothing falls back from CUDA to the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ... import _build
from .kv_cache import gather_pages
from .ragged_attention import ragged_decode_attention

KERNEL_NAME = "paged_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load(KERNEL_NAME)
        fn = lib.paddle_paged_attention
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib.paddle_paged_attention


def paged_ragged_attention_reference(pool_k, pool_v, page_table, lengths,
                                     q, scale=None):
    """The plain version: page-table gather + masked ragged attention
    (the JAX package's "gather" mode)."""
    pool = torch.stack([pool_k, pool_v])[None]    # [1, 2, NB, BS, H, Dh]
    kp, vp = gather_pages(pool, 0, page_table)
    return ragged_decode_attention(q, kp, vp, lengths, scale=scale)


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


def paged_ragged_attention(pool_k, pool_v, page_table, lengths, q,
                           scale=None):
    """Paged decode attention over one layer's pool.

    ``pool_k``/``pool_v`` ``[NB, BS, H, Dh]``; ``page_table``
    ``[B, MAXNB]`` int32; ``lengths`` ``[B]`` int32; ``q`` ``[B, H,
    Dh]``.  Returns ``[B, H, Dh]`` in ``q``'s dtype.  CPU tensors run
    the plain version.  CUDA tensors launch the kernel on the current
    stream without synchronising; the kernel takes fp32, bf16 or fp16
    with ``q`` in the pool's dtype, contiguous inputs and ``Dh`` a
    multiple of 16 up to 256 (a warp per row when Dh is a multiple of
    32, half a warp otherwise), and anything else raises.  Each launch
    adds one to ``paged_ragged_attention.launches``.
    """
    _check(pool_k, pool_v, page_table, lengths, q)
    NB, BS, H, Dh = pool_k.shape
    B, MAXNB = page_table.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    if q.device.type == "cpu":
        return paged_ragged_attention_reference(pool_k, pool_v, page_table,
                                                lengths, q, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES or pool_k.dtype != q.dtype or \
            pool_v.dtype != q.dtype:
        raise TypeError(
            f"kernel takes float32, bfloat16 or float16 with q in the "
            f"pool's dtype; got q {q.dtype}, pool {pool_k.dtype}/"
            f"{pool_v.dtype}")
    if Dh % 16 or not 0 < Dh <= 256:
        raise ValueError(f"kernel takes Dh a multiple of 16 up to 256, "
                         f"got {Dh}")
    tensors = (pool_k, pool_v, page_table, lengths, q)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (pool_k, pool_v, q)):
        raise ValueError("q and the pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
                 pool_v.data_ptr(), page_table.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, H, Dh, NB, BS,
                 MAXNB, float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: "
                           f"cudaError {err}")
    paged_ragged_attention.launches += 1
    return out


paged_ragged_attention.launches = 0


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
