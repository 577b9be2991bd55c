"""Flash attention: the hand-written CUDA kernels, their wrappers, their
plain versions, their launch counts and the autograd function around
them (counterpart of the flash-attention part of
``paddle_tpu/ops/pallas_ops.py``).

Five kernels in ``csrc/flash_attention.cu``:

- :func:`flash_fwd` -> ``(out, lse)``, the online-softmax forward;
- :func:`flash_bwd_dq` -> ``(dq, delta)``, ``delta = rowsum(dO * O)``;
- :func:`flash_bwd_dkv` -> ``(dk, dv)``, which reads that ``delta``;
- :func:`flash_fwd_hpack` -> ``(out, lse)`` as :func:`flash_fwd`, with
  ``hp`` consecutive heads of ``B*H`` per CTA (``PADDLE_TORCH_FLASH_
  HEADPACK``);
- :func:`flash_bwd_fused` -> ``(dq, dk, dv)`` in one sweep over the k
  tiles, dq summed through atomics (``PADDLE_TORCH_FLASH_FUSED_BWD``);
  a pre-pass computes delta and zeroes the fp32 dq workspace, and for
  bf16 an epilogue rounds it into dq.

Each wrapper takes ``q`` ``[B, Sq, H, D]`` and ``k``/``v``/``dout``
``[B, S, H, D]`` as strided views (the head dim must have stride 1), so
the GPT path hands in slices of the fused qkv projection with no copy;
the ``[B*H, S, D]`` layout is the same call with ``H = 1``.  Outputs are
contiguous ``[B, S, H, D]`` in the input dtype, and ``lse``/``delta``
fp32 ``[B, H, Sq]``.  The softmax statistics are those of the JAX
kernels: the running max is clamped at :data:`LSE_FLOOR`, so a row that
sees no key gives ``out = 0`` and ``lse = LSE_FLOOR``, never NaN.

On a CUDA tensor a wrapper launches its kernel or raises (a build
failure raises :class:`~paddle_tpu_torch._build.KernelBuildError`);
the kernels take fp32 or bf16 with ``D`` 64 or 128, and any other head
dim raises ``NotImplementedError``.  On a CPU tensor it runs its plain
version, which repeats the kernel's arithmetic with whole-tensor ops.
Each launch adds one to ``<wrapper>.launches``; each plain run adds
one to ``<wrapper>.plain_calls``.  The fused backward's helper launches
are counted in ``flash_bwd_fused.helper_launches`` under their kernel
names.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

KERNEL_NAME = "flash_attention"
#: clamp of the saved log-sum-exp (``_LSE_FLOOR`` of the JAX package)
LSE_FLOOR = -1e30
#: denominator guard: inert for a row with any visible key
DENOM_TINY = 1e-30
HEAD_DIMS = (64, 128)
#: heads per CTA and head dim that ``flash_fwd_hpack``'s kernel is built for
HPACK_HEADS = (2, 4)
HPACK_HEAD_DIM = 64
#: the fused backward's helper kernels (pre-pass, bf16 dq epilogue)
FUSED_HELPERS = ("flash_bwd_fused_prep", "flash_bwd_fused_dq_cast")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def bind(lib):
    """Set the argument and result types of the library's C entries
    (a ctypes library built from ``csrc/flash_attention.cu``)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd.argtypes = [i, i] + [p] * 7 + [i] * 5 + [f, p, p]
    for fn in (lib.flash_bwd_dq, lib.flash_bwd_dkv):
        fn.argtypes = [i, i] + [p] * 10 + [i] * 5 + [f, p, p]
    lib.flash_fwd_hpack.argtypes = [i, i, i] + [p] * 5 + [i] * 5 + [f, p, p]
    lib.flash_bwd_fused.argtypes = [i, i] + [p] * 13 + [i] * 5 + [f, p, p]
    for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv,
               lib.flash_fwd_hpack, lib.flash_bwd_fused):
        fn.restype = ctypes.c_int
    return lib


def _kernel():
    global _lib
    if _lib is None:
        _lib = bind(_build.load(KERNEL_NAME))
    return _lib


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _visible(q, k, causal, q_seg, k_seg):
    """Bool ``[B or 1, 1, Sq, Sk]``: which keys each query sees."""
    sq, sk = q.shape[1], k.shape[1]
    mask = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask)
    if q_seg is not None:
        mask = mask & (q_seg[:, None, :, None] == k_seg[:, None, None, :])
    return mask


def _scores(q, k, scale):
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def flash_attention_reference(q, k, v, causal, q_seg=None, k_seg=None,
                              scale=None, dropout_p=0.0, generator=None):
    """The composed attention (the JAX package's ``_flash_reference``) on
    ``[B, S, H, D]``, differentiable through torch's autograd.  Returns
    ``(out, lse)``: ``out`` in ``q``'s dtype, ``lse`` fp32 ``[B, H, Sq]``
    clamped at :data:`LSE_FLOOR`.  A fully-masked row gives 0 output and
    0 gradients: the max is clamped and detached and the denominator is
    ``max(sum, DENOM_TINY)``, so no ``-inf - -inf`` is ever formed.
    ``dropout_p > 0`` drops probabilities with ``generator``'s bits and
    rescales by ``1 / (1 - dropout_p)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, scale).masked_fill(
        ~_visible(q, k, causal, q_seg, k_seg), float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(LSE_FLOOR).detach()
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(DENOM_TINY)
    p = e / denom
    lse = (m + torch.log(denom)).squeeze(-1).clamp_min(LSE_FLOOR)
    if dropout_p > 0.0:
        keep = torch.rand(p.shape, generator=generator,
                          device=p.device) < (1.0 - dropout_p)
        p = torch.where(keep, p / (1.0 - dropout_p), torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse


def _probs(q, k, lse, causal, q_seg, k_seg, scale):
    """P = exp(S - lse) on the visible pairs, 0 elsewhere (fp32)."""
    s = _scores(q, k, scale)
    p = torch.exp(s - lse[..., None])
    return torch.where(_visible(q, k, causal, q_seg, k_seg), p,
                       torch.zeros_like(p))


def flash_bwd_dq_reference(q, k, v, out, lse, dout, causal, q_seg=None,
                           k_seg=None, scale=None):
    """Plain version of :func:`flash_bwd_dq`: ``(dq, delta)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lse, causal, q_seg, k_seg, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), delta.contiguous()


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal, q_seg=None,
                            k_seg=None, scale=None):
    """Plain version of :func:`flash_bwd_dkv`: ``(dk, dv)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lse, causal, q_seg, k_seg, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_fused_reference(q, k, v, out, lse, dout, causal, q_seg=None,
                              k_seg=None, scale=None):
    """Plain version of :func:`flash_bwd_fused`: ``(dq, dk, dv)``.
    ``delta = rowsum(dO * O)``, then the products of
    :func:`flash_bwd_dq_reference` and :func:`flash_bwd_dkv_reference`,
    with ``p`` rounded to dO's dtype before ``P^T dO`` and ``dS`` to q's
    dtype before ``dS^T Q`` and ``dS K``, where the JAX fused kernel
    rounds them (no-ops in fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lse, causal, q_seg, k_seg, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    p = p.to(dout.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check(q, k, v, q_seg, k_seg, extra=()):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be [B, Sq, H, D] and k/v [B, Sk, H, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, heads or head dim")
    tensors = (q, k, v) + tuple(extra)
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"q, k, v and the gradients must share one dtype, "
                        f"got {[t.dtype for t in tensors]}")
    if (q_seg is None) != (k_seg is None):
        raise ValueError("give both segment-id tensors or neither")
    for name, seg, n in (("q_seg", q_seg, Sq), ("k_seg", k_seg, k.shape[1])):
        if seg is not None and (seg.dtype != torch.int32
                                or tuple(seg.shape) != (B, n)):
            raise ValueError(f"{name} must be int32 [{B}, {n}], got "
                             f"{seg.dtype} {tuple(seg.shape)}")
    devices = {t.device for t in tensors}
    devices |= {s.device for s in (q_seg, k_seg) if s is not None}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share one device, got {devices}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _kernel_ready(q):
    """The CUDA path's own limits (the plain version takes anything)."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise NotImplementedError(
            f"the flash kernels are built for head dim {HEAD_DIMS}, got "
            f"{q.shape[-1]}")


def _rows(t):
    """``t`` with a unit stride on the head dim (a copy only if not)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _strides(*tensors):
    vals = []
    for t in tensors:
        vals.extend((t.stride(0), t.stride(1), t.stride(2)))
    return (ctypes.c_int64 * len(vals))(*vals)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _segs(q_seg, k_seg):
    """Segment ids as the kernels index them: contiguous rows."""
    if q_seg is None:
        return None, None
    return q_seg.contiguous(), k_seg.contiguous()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _launch_fwd(lib, stream, q, k, v, causal, q_seg, k_seg, scale):
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, out)
    _raise_on(lib.flash_fwd(
        _DTYPE_CODES[q.dtype], D, _ptr(q), _ptr(k), _ptr(v), _ptr(out),
        _ptr(lse), _ptr(q_seg), _ptr(k_seg), B, H, Sq, k.shape[1],
        int(causal), float(scale), ctypes.cast(strides, ctypes.c_void_p),
        stream), "flash_fwd")
    return out, lse


def _launch_bwd_dq(lib, stream, q, k, v, out, lse, dout, causal, q_seg,
                   k_seg, scale):
    B, Sq, H, D = q.shape
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, out, dout, dq)
    _raise_on(lib.flash_bwd_dq(
        _DTYPE_CODES[q.dtype], D, _ptr(q), _ptr(k), _ptr(v), _ptr(out),
        _ptr(dout), _ptr(lse), _ptr(delta), _ptr(dq), _ptr(q_seg),
        _ptr(k_seg), B, H, Sq, k.shape[1], int(causal), float(scale),
        ctypes.cast(strides, ctypes.c_void_p), stream), "flash_bwd_dq")
    return dq, delta


def _launch_bwd_dkv(lib, stream, q, k, v, dout, lse, delta, causal, q_seg,
                    k_seg, scale):
    B, Sq, H, D = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    strides = _strides(q, k, v, dout, dk, dv)
    _raise_on(lib.flash_bwd_dkv(
        _DTYPE_CODES[q.dtype], D, _ptr(q), _ptr(k), _ptr(v), _ptr(dout),
        _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), _ptr(q_seg),
        _ptr(k_seg), B, H, Sq, k.shape[1], int(causal), float(scale),
        ctypes.cast(strides, ctypes.c_void_p), stream), "flash_bwd_dkv")
    return dk, dv


def _launch_fwd_hpack(lib, stream, q, k, v, hp, causal, scale):
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, out)
    _raise_on(lib.flash_fwd_hpack(
        _DTYPE_CODES[q.dtype], D, hp, _ptr(q), _ptr(k), _ptr(v), _ptr(out),
        _ptr(lse), B, H, Sq, k.shape[1], int(causal), float(scale),
        ctypes.cast(strides, ctypes.c_void_p), stream), "flash_fwd_hpack")
    return out, lse


def _launch_bwd_fused(lib, stream, q, k, v, out, lse, dout, causal, q_seg,
                      k_seg, scale):
    """The pre-pass, the sweep and (bf16) the dq epilogue; returns
    ``(dq, dk, dv)``.  For fp32 the workspace is dq itself."""
    B, Sq, H, D = q.shape
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    ws = dq if q.dtype == torch.float32 else torch.empty(
        (B, Sq, H, D), dtype=torch.float32, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    strides = _strides(q, k, v, out, dout, dk, dv)
    _raise_on(lib.flash_bwd_fused(
        _DTYPE_CODES[q.dtype], D, _ptr(q), _ptr(k), _ptr(v), _ptr(out),
        _ptr(dout), _ptr(lse), _ptr(delta), _ptr(ws), _ptr(dq), _ptr(dk),
        _ptr(dv), _ptr(q_seg), _ptr(k_seg), B, H, Sq, k.shape[1],
        int(causal), float(scale), ctypes.cast(strides, ctypes.c_void_p),
        stream), "flash_bwd_fused")
    return dq, dk, dv


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _empty(q, k):
    return 0 in (q.shape[0], q.shape[1], q.shape[2], k.shape[1])


def flash_fwd(q, k, v, causal, q_seg=None, k_seg=None, scale=None):
    """Attention forward: ``(out [B, Sq, H, D], lse [B, H, Sq] fp32)``.
    ``causal`` masks key positions after the query position (row-aligned
    at 0, so it needs ``Sq == Sk``); ``q_seg``/``k_seg`` int32 ``[B, Sq]``
    / ``[B, Sk]`` let a query see only keys of its own segment."""
    _check(q, k, v, q_seg, k_seg)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        flash_fwd.plain_calls += 1
        with torch.no_grad():
            return flash_attention_reference(q, k, v, causal, q_seg, k_seg,
                                             scale)
    _kernel_ready(q)
    q, k, v = _rows(q), _rows(k), _rows(v)
    q_seg, k_seg = _segs(q_seg, k_seg)
    if _empty(q, k):
        return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
                torch.full((q.shape[0], q.shape[2], q.shape[1]), LSE_FLOOR,
                           device=q.device))
    lib = _kernel()
    with torch.cuda.device(q.device):
        res = _launch_fwd(lib, _stream(q), q, k, v, causal, q_seg, k_seg,
                          scale)
    flash_fwd.launches += 1
    return res


def flash_bwd_dq(q, k, v, out, lse, dout, causal, q_seg=None, k_seg=None,
                 scale=None):
    """Gradient of the attention input ``q``: ``(dq, delta)`` with
    ``delta = rowsum(dout * out)`` fp32 ``[B, H, Sq]``, which
    :func:`flash_bwd_dkv` reads."""
    _check(q, k, v, q_seg, k_seg, extra=(out, dout))
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        flash_bwd_dq.plain_calls += 1
        with torch.no_grad():
            return flash_bwd_dq_reference(q, k, v, out, lse, dout, causal,
                                          q_seg, k_seg, scale)
    _kernel_ready(q)
    q, k, v, out, dout = _rows(q), _rows(k), _rows(v), _rows(out), _rows(dout)
    q_seg, k_seg = _segs(q_seg, k_seg)
    if _empty(q, k):
        return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
                torch.zeros(lse.shape, device=q.device))
    lse = lse.contiguous()
    lib = _kernel()
    with torch.cuda.device(q.device):
        res = _launch_bwd_dq(lib, _stream(q), q, k, v, out, lse, dout,
                             causal, q_seg, k_seg, scale)
    flash_bwd_dq.launches += 1
    return res


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal, q_seg=None, k_seg=None,
                  scale=None):
    """Gradients of the attention inputs ``k`` and ``v``: ``(dk, dv)``.
    Runs after :func:`flash_bwd_dq`, whose ``delta`` it reads."""
    _check(q, k, v, q_seg, k_seg, extra=(dout,))
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        flash_bwd_dkv.plain_calls += 1
        with torch.no_grad():
            return flash_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                           causal, q_seg, k_seg, scale)
    _kernel_ready(q)
    q, k, v, dout = _rows(q), _rows(k), _rows(v), _rows(dout)
    q_seg, k_seg = _segs(q_seg, k_seg)
    if _empty(q, k):
        return (torch.zeros(k.shape, dtype=k.dtype, device=k.device),
                torch.zeros(v.shape, dtype=v.dtype, device=v.device))
    lse, delta = lse.contiguous(), delta.contiguous()
    lib = _kernel()
    with torch.cuda.device(q.device):
        res = _launch_bwd_dkv(lib, _stream(q), q, k, v, dout, lse, delta,
                              causal, q_seg, k_seg, scale)
    flash_bwd_dkv.launches += 1
    return res


def flash_fwd_hpack(q, k, v, hp, causal, scale=None):
    """:func:`flash_fwd`'s outputs with ``hp`` consecutive heads of the
    flattened ``B*H`` per CTA (the JAX package's head-packed forward; no
    segment ids).  ``B*H`` must divide by ``hp``; heads are consecutive
    along ``B*H``, so with an odd ``H`` a CTA's heads straddle two
    batches.  The kernel is built for ``hp`` in :data:`HPACK_HEADS` at
    head dim 64; other values raise ``NotImplementedError`` on the card.
    The plain version is :func:`flash_attention_reference`."""
    _check(q, k, v, None, None)
    hp = int(hp)
    if hp < 1 or (q.shape[0] * q.shape[2]) % hp:
        raise ValueError(f"hp={hp} must be >= 1 and divide B*H = "
                         f"{q.shape[0] * q.shape[2]}")
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        flash_fwd_hpack.plain_calls += 1
        with torch.no_grad():
            return flash_attention_reference(q, k, v, causal, scale=scale)
    _kernel_ready(q)
    if hp not in HPACK_HEADS or q.shape[-1] != HPACK_HEAD_DIM:
        raise NotImplementedError(
            f"flash_fwd_hpack's kernel is built for hp in {HPACK_HEADS} at "
            f"head dim {HPACK_HEAD_DIM}, got hp={hp}, head dim "
            f"{q.shape[-1]}")
    q, k, v = _rows(q), _rows(k), _rows(v)
    if _empty(q, k):
        return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
                torch.full((q.shape[0], q.shape[2], q.shape[1]), LSE_FLOOR,
                           device=q.device))
    lib = _kernel()
    with torch.cuda.device(q.device):
        res = _launch_fwd_hpack(lib, _stream(q), q, k, v, hp, causal, scale)
    flash_fwd_hpack.launches += 1
    return res


def flash_bwd_fused(q, k, v, out, lse, dout, causal, q_seg=None, k_seg=None,
                    scale=None):
    """Gradients of q, k and v in one sweep: ``(dq, dk, dv)``.  Three
    launches: the pre-pass (delta, zeroed dq workspace), the sweep (one
    CTA per k tile; dq through fp32 atomics) and, for bf16, the dq
    epilogue; the helpers count in ``flash_bwd_fused.helper_launches``.
    dk and dv are the same bits on every run; dq's atomic sums may
    differ by a few fp32 ulps of its magnitude from run to run."""
    _check(q, k, v, q_seg, k_seg, extra=(out, dout))
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        flash_bwd_fused.plain_calls += 1
        with torch.no_grad():
            return flash_bwd_fused_reference(q, k, v, out, lse, dout, causal,
                                             q_seg, k_seg, scale)
    _kernel_ready(q)
    q, k, v, out, dout = _rows(q), _rows(k), _rows(v), _rows(out), _rows(dout)
    q_seg, k_seg = _segs(q_seg, k_seg)
    if _empty(q, k):
        return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
                torch.zeros(k.shape, dtype=k.dtype, device=k.device),
                torch.zeros(v.shape, dtype=v.dtype, device=v.device))
    lse = lse.contiguous()
    lib = _kernel()
    with torch.cuda.device(q.device):
        res = _launch_bwd_fused(lib, _stream(q), q, k, v, out, lse, dout,
                                causal, q_seg, k_seg, scale)
    flash_bwd_fused.launches += 1
    helpers = flash_bwd_fused.helper_launches
    helpers["flash_bwd_fused_prep"] += 1
    if q.dtype != torch.float32:
        helpers["flash_bwd_fused_dq_cast"] += 1
    return res


#: the default path's kernels, and those the [B*H, S, D] knobs select
WRAPPERS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
BH_WRAPPERS = (flash_fwd_hpack, flash_bwd_fused)
ALL_WRAPPERS = WRAPPERS + BH_WRAPPERS


def reset_counts():
    """Set every wrapper's ``launches`` and ``plain_calls`` (and the
    fused backward's helper launches) to 0."""
    for fn in ALL_WRAPPERS:
        fn.launches = 0
        fn.plain_calls = 0
    flash_bwd_fused.helper_launches = dict.fromkeys(FUSED_HELPERS, 0)


reset_counts()


class FlashAttnFunc(torch.autograd.Function):
    """``out = attention(q, k, v)`` on whichever device the tensors lie.
    The forward is :func:`flash_fwd`, or :func:`flash_fwd_hpack` when
    ``hp > 1`` (no segment ids); the backward is :func:`flash_bwd_dq`
    then :func:`flash_bwd_dkv`, or :func:`flash_bwd_fused` when
    ``fused_bwd``.  Saves q, k, v, out and lse (q/k/v as the caller's
    views, no copy); the incoming gradient is passed with its own
    strides."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_seg, k_seg, hp=1, fused_bwd=False):
        if hp > 1:
            if q_seg is not None:
                raise ValueError("the head-packed forward takes no segment "
                                 "ids")
            out, lse = flash_fwd_hpack(q, k, v, hp, causal)
        else:
            out, lse = flash_fwd(q, k, v, causal, q_seg, k_seg)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.segs = (q_seg, k_seg)
        ctx.fused_bwd = fused_bwd
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        q_seg, k_seg = ctx.segs
        if ctx.fused_bwd:
            dq, dk, dv = flash_bwd_fused(q, k, v, out, lse, dout, ctx.causal,
                                         q_seg, k_seg)
        else:
            dq, delta = flash_bwd_dq(q, k, v, out, lse, dout, ctx.causal,
                                     q_seg, k_seg)
            dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal,
                                   q_seg, k_seg)
        return dq, dk, dv, None, None, None, None, None


# ---------------------------------------------------------------------------
# least work of each kernel (for the bound the chip smoke reports)
# ---------------------------------------------------------------------------
def kernel_work(name, B, H, Sq, Sk, D, causal, itemsize):
    """``(flops, bytes)`` one call of kernel ``name`` must do: each input
    read once and each output written once; 2 flops per multiply-add of
    each product it needs (fwd and fwd_hpack: S and PV; dq: S, dP and
    dS K; dkv: S, dP, P^T dO and dS^T Q; fused: all five once).  Causal
    calls score the lower triangle, diagonal included."""
    pairs = B * H * (min(Sq, Sk) * (min(Sq, Sk) + 1) // 2 if causal
                     else Sq * Sk)
    q_bytes = B * Sq * H * D * itemsize
    k_bytes = B * Sk * H * D * itemsize
    row_stats = B * H * Sq * 4
    if name in ("flash_fwd", "flash_fwd_hpack"):
        return 4 * D * pairs, 2 * q_bytes + 2 * k_bytes + row_stats
    if name == "flash_bwd_fused":
        # q, o, dO, k, v, lse in; dq, dk, dv out (delta stays inside)
        return 10 * D * pairs, 4 * q_bytes + 4 * k_bytes + row_stats
    if name == "flash_bwd_dq":
        # q, o, dO, k, v in; dq, delta out; lse in
        return 6 * D * pairs, 4 * q_bytes + 2 * k_bytes + 2 * row_stats
    if name == "flash_bwd_dkv":
        # q, dO, k, v in; dk, dv out; lse, delta in
        return 8 * D * pairs, 2 * q_bytes + 4 * k_bytes + 2 * row_stats
    raise ValueError(f"unknown kernel {name!r}")
