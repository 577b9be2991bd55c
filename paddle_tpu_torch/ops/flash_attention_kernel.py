"""Flash attention: the hand-written CUDA kernels, their wrappers, their
plain versions, their launch counts and the autograd function around
them (counterpart of the flash-attention part of
``paddle_tpu/ops/pallas_ops.py``).

Five kernels in ``csrc/flash_attention.cu`` (fp32 FMAs on the CUDA
cores), the two forwards also in ``csrc/flash_fwd_sm90.cu`` and the split
and fused backward in ``csrc/flash_bwd_sm90.cu`` (bf16 and fp16 on the
tensor cores, ``wgmma`` fed by TMA):

- :func:`flash_fwd` -> ``(out, lse)``, the online-softmax forward;
- :func:`flash_bwd_dq` -> ``(dq, delta)``, ``delta = rowsum(dO * O)``;
- :func:`flash_bwd_dkv` -> ``(dk, dv)``, which reads that ``delta``;
- :func:`flash_fwd_hpack` -> ``(out, lse)`` as :func:`flash_fwd`, with
  ``hp`` consecutive heads of ``B*H`` per CTA (``PADDLE_TORCH_FLASH_
  HEADPACK``);
- :func:`flash_bwd_fused` -> ``(dq, dk, dv)`` in one sweep over the k
  tiles, dq's per-tile partials added into an fp32 workspace
  (``PADDLE_TORCH_FLASH_FUSED_BWD``; the CUDA-core sweep with
  ``atomicAdd``, the tensor-core one with a TMA reduce-add); a pre-pass
  computes delta and zeroes the workspace, and for bf16 and fp16 an
  epilogue rounds it into dq.

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
the kernels take fp32, bf16 or fp16 with ``D`` in :data:`HEAD_DIMS`
(16, 32, 64, 128), and any other head dim raises
``NotImplementedError``.  Every wrapper routes by dtype and head dim,
before any launch: bf16 and fp16 at ``D`` in :data:`TC_HEAD_DIMS` (64,
128; 64 for the head-packed entry) launch the tensor-core kernel
(``flash_fwd_tc`` / ``flash_fwd_hpack_tc``, ``flash_bwd_dq_tc`` /
``flash_bwd_dkv_tc``, ``flash_bwd_fused_tc``), everything else (fp32,
and ``D`` 16 or 32 in every dtype) the CUDA-core one.  TMA reads q, k, v
and dout (and the tensor-core dq and fused pre-pass read out with
16-byte loads), so a tensor-core call whose base address or batch,
sequence or head stride of one of them is not a multiple of 16 bytes
raises
``NotImplementedError``.  Neither body falls back to the other.  Every
forward rounds p to the input dtype before ``P V``, and every backward
rounds dS to it before ``dS K`` and ``dS^T Q`` and p before ``P^T dO``
(as the TPU kernels do; no-ops in fp32).  On a CPU tensor a wrapper
runs its plain version, which repeats the kernel's arithmetic with
whole-tensor ops (:func:`flash_fwd_tc_reference` holds the 16-bit
forwards' rounding of p, :func:`_dsoftmax` the backward's).  Each
launch adds one to
``<wrapper>.launches`` and, for the tensor-core body, to
``<wrapper>.tc_launches``; each plain run adds one to
``<wrapper>.plain_calls``.  The fused backward's helper launches are
counted in ``flash_bwd_fused.helper_launches`` under their kernel
names.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

KERNEL_NAME = "flash_attention"
TC_KERNEL_NAME = "flash_fwd_sm90"
TC_BWD_KERNEL_NAME = "flash_bwd_sm90"
#: clamp of the saved log-sum-exp (``_LSE_FLOOR`` of the JAX package)
LSE_FLOOR = -1e30
#: denominator guard: inert for a row with any visible key
DENOM_TINY = 1e-30
HEAD_DIMS = (16, 32, 64, 128)
#: head dims of the tensor-core forward and split backward (bf16 and
#: fp16); below 64 the CUDA-core kernels run in those dtypes
TC_HEAD_DIMS = (64, 128)
#: heads per CTA and head dims that ``flash_fwd_hpack``'s kernels are
#: built for (the JAX rule packs every head dim up to 64); the
#: tensor-core body takes 64
HPACK_HEADS = (2, 4)
HPACK_HEAD_DIMS = (16, 32, 64)
#: the fused backward's helper kernels (pre-pass, 16-bit dq epilogue)
FUSED_HELPERS = ("flash_bwd_fused_prep", "flash_bwd_fused_dq_cast")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TC_DTYPES = (torch.bfloat16, torch.float16)
#: TMA's rule for the tensor-core kernels' q, k, v, out and dout: base
#: address and batch, sequence and head strides in multiples of this many
#: bytes
TMA_ALIGN = 16
_TC_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled",
              -2: "the driver refused a tensor map"}
_lib = None
_tc_lib = None
_bwd_tc_lib = None


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


def bind_tc(lib):
    """The same for the tensor-core forward's library
    (``csrc/flash_fwd_sm90.cu``, bf16 and fp16)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd_tc.argtypes = [i, i] + [p] * 7 + [i] * 5 + [f, p, p]
    lib.flash_fwd_hpack_tc.argtypes = ([i, i, i] + [p] * 5 + [i] * 5
                                       + [f, p, p])
    for fn in (lib.flash_fwd_tc, lib.flash_fwd_hpack_tc):
        fn.restype = ctypes.c_int
    return lib


def bind_bwd_tc(lib):
    """The same for the tensor-core backward's library
    (``csrc/flash_bwd_sm90.cu``, bf16 and fp16); the C signatures are
    those of ``flash_bwd_dq``, ``flash_bwd_dkv`` and ``flash_bwd_fused``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.flash_bwd_dq_tc, lib.flash_bwd_dkv_tc):
        fn.argtypes = [i, i] + [p] * 10 + [i] * 5 + [f, p, p]
    lib.flash_bwd_fused_tc.argtypes = [i, i] + [p] * 13 + [i] * 5 + [f, p, p]
    for fn in (lib.flash_bwd_dq_tc, lib.flash_bwd_dkv_tc,
               lib.flash_bwd_fused_tc):
        fn.restype = ctypes.c_int
    return lib


def _kernel():
    global _lib
    if _lib is None:
        _lib = bind(_build.load(KERNEL_NAME))
    return _lib


def _tc_kernel():
    global _tc_lib
    if _tc_lib is None:
        _tc_lib = bind_tc(_build.load(TC_KERNEL_NAME))
    return _tc_lib


def _bwd_tc_kernel():
    global _bwd_tc_lib
    if _bwd_tc_lib is None:
        _bwd_tc_lib = bind_bwd_tc(_build.load(TC_BWD_KERNEL_NAME))
    return _bwd_tc_lib


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


def flash_fwd_tc_reference(q, k, v, causal, q_seg=None, k_seg=None,
                           scale=None):
    """Plain version of the tensor-core forward: the arithmetic of
    :func:`flash_attention_reference` with ``p`` rounded to the input
    dtype before ``P V`` while the denominator sums the unrounded fp32
    ``p``, as the JAX ``_flash_kernel`` rounds (``pallas_ops.py``
    :159-166).  Returns ``(out, lse)`` as that function does."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, scale).masked_fill(
        ~_visible(q, k, causal, q_seg, k_seg), float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(LSE_FLOOR)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True).clamp_min(DENOM_TINY)
    acc = torch.einsum("bhqk,bkhd->bqhd", e.to(q.dtype).float(), v.float())
    out = acc / denom.permute(0, 2, 1, 3)
    lse = (m + torch.log(denom)).squeeze(-1).clamp_min(LSE_FLOOR)
    return out.to(q.dtype), lse


def _probs(q, k, lse, causal, q_seg, k_seg, scale):
    """P = exp(S - lse) on the visible pairs, 0 elsewhere (fp32)."""
    s = _scores(q, k, scale)
    p = torch.exp(s - lse[..., None])
    return torch.where(_visible(q, k, causal, q_seg, k_seg), p,
                       torch.zeros_like(p))


def _delta(out, dout):
    """``delta = rowsum(dO * O)`` in fp32, ``[B, H, Sq]``."""
    return (dout.float() * out.float()).sum(-1).permute(0, 2, 1)


def _dsoftmax(q, k, v, dout, lse, delta, causal, q_seg, k_seg, scale):
    """``(p, dS)`` of every backward, ``[B, H, Sq, Sk]`` fp32: P = exp(S -
    lse) on the visible pairs and dS = P (dP - delta) scale with dP = dO
    V^T, both rounded to the input dtype as the TPU kernels round them
    before their products (p to dO's dtype before ``P^T dO``, dS to q's
    before ``dS K`` and ``dS^T Q``: ``pallas_ops.py:542, 607, 614`` and
    the packed :940, :1009, :1014; no-ops in fp32)."""
    p = _probs(q, k, lse, causal, q_seg, k_seg, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    return p.to(dout.dtype).float(), ds


def flash_bwd_dq_reference(q, k, v, out, lse, dout, causal, q_seg=None,
                           k_seg=None, scale=None):
    """Plain version of :func:`flash_bwd_dq`: ``(dq, delta)``, dS rounded
    as :func:`_dsoftmax` says."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = _delta(out, dout)
    _, ds = _dsoftmax(q, k, v, dout, lse, delta, causal, q_seg, k_seg, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), delta.contiguous()


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal, q_seg=None,
                            k_seg=None, scale=None):
    """Plain version of :func:`flash_bwd_dkv`: ``(dk, dv)``, p and dS
    rounded as :func:`_dsoftmax` says."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _dsoftmax(q, k, v, dout, lse, delta, causal, q_seg, k_seg, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_fused_reference(q, k, v, out, lse, dout, causal, q_seg=None,
                              k_seg=None, scale=None):
    """Plain version of :func:`flash_bwd_fused`: ``(dq, dk, dv)``, the
    products of :func:`flash_bwd_dq_reference` and
    :func:`flash_bwd_dkv_reference` from one ``delta = rowsum(dO * O)``,
    with the same rounding (the JAX fused kernel rounds where the split
    ones do)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _dsoftmax(q, k, v, dout, lse, _delta(out, dout), causal, q_seg,
                      k_seg, scale)
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
        raise TypeError(f"the flash kernels take float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise NotImplementedError(
            f"the flash kernels are built for head dim {HEAD_DIMS}, got "
            f"{q.shape[-1]}")


def _is_tc(q, head_dims=TC_HEAD_DIMS):
    """Whether a forward runs the tensor-core body: 16-bit inputs at a
    head dim it is built for (decided before any launch)."""
    return q.dtype in _TC_DTYPES and q.shape[-1] in head_dims


def _tc_ready(**tensors):
    """TMA's rule for a tensor-core kernel's inputs (by name), checked
    before a launch."""
    for name, t in tensors.items():
        size = t.element_size()
        strides = [st * size for st, n in zip(t.stride()[:3], t.shape[:3])
                   if n > 1]
        if t.data_ptr() % TMA_ALIGN or any(b % TMA_ALIGN for b in strides):
            raise NotImplementedError(
                f"the tensor-core flash kernels read {name} through TMA or "
                f"16-byte loads, which need a {TMA_ALIGN}-byte-aligned base "
                f"address and "
                f"batch, sequence and head strides that are multiples of "
                f"{TMA_ALIGN} bytes; got address {t.data_ptr()} and "
                f"strides {tuple(st * size for st in t.stride()[:3])} "
                f"bytes")


def _tma_strides(*tensors):
    """``_strides`` with the stride of each size-1 dim replaced by the
    one a contiguous tensor would have there: TMA never steps along it,
    but its tensor map still needs a multiple of 16 bytes."""
    vals = []
    for t in tensors:
        b, s, h, d = t.shape
        sb, ss, sh = t.stride()[:3]
        sh = sh if h > 1 else d
        ss = ss if s > 1 else sh * h
        sb = sb if b > 1 else ss * s
        vals.extend((sb, ss, sh))
    return (ctypes.c_int64 * len(vals))(*vals)


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
    if err in _TC_ERRORS:
        raise RuntimeError(f"{name} kernel launch failed: {_TC_ERRORS[err]}")
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


def _launch_fwd_tc(lib, stream, q, k, v, causal, q_seg, k_seg, scale):
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = _tma_strides(q, k, v, out)
    _raise_on(lib.flash_fwd_tc(
        _DTYPE_CODES[q.dtype], D, _ptr(q), _ptr(k), _ptr(v), _ptr(out),
        _ptr(lse), _ptr(q_seg), _ptr(k_seg), B, H, Sq, k.shape[1],
        int(causal), float(scale),
        ctypes.cast(strides, ctypes.c_void_p), stream), "flash_fwd_tc")
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


def _launch_bwd_dq_tc(lib, stream, q, k, v, out, lse, dout, causal, q_seg,
                      k_seg, scale):
    B, Sq, H, D = q.shape
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = _tma_strides(q, k, v, out, dout, dq)
    _raise_on(lib.flash_bwd_dq_tc(
        _DTYPE_CODES[q.dtype], D, _ptr(q), _ptr(k), _ptr(v), _ptr(out),
        _ptr(dout), _ptr(lse), _ptr(delta), _ptr(dq), _ptr(q_seg),
        _ptr(k_seg), B, H, Sq, k.shape[1], int(causal), float(scale),
        ctypes.cast(strides, ctypes.c_void_p), stream), "flash_bwd_dq_tc")
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


def _launch_bwd_dkv_tc(lib, stream, q, k, v, dout, lse, delta, causal, q_seg,
                       k_seg, scale):
    B, Sq, H, D = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    strides = _tma_strides(q, k, v, dout, dk, dv)
    _raise_on(lib.flash_bwd_dkv_tc(
        _DTYPE_CODES[q.dtype], D, _ptr(q), _ptr(k), _ptr(v), _ptr(dout),
        _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), _ptr(q_seg),
        _ptr(k_seg), B, H, Sq, k.shape[1], int(causal), float(scale),
        ctypes.cast(strides, ctypes.c_void_p), stream), "flash_bwd_dkv_tc")
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


def _launch_fwd_hpack_tc(lib, stream, q, k, v, hp, causal, scale):
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = _tma_strides(q, k, v, out)
    _raise_on(lib.flash_fwd_hpack_tc(
        _DTYPE_CODES[q.dtype], D, hp, _ptr(q), _ptr(k), _ptr(v),
        _ptr(out), _ptr(lse), B, H, Sq, k.shape[1], int(causal),
        float(scale),
        ctypes.cast(strides, ctypes.c_void_p), stream), "flash_fwd_hpack_tc")
    return out, lse


def _fused_call(entry, strides_of, lib, stream, q, k, v, out, lse, dout,
                causal, q_seg, k_seg, scale):
    """One call of a fused-backward entry: the pre-pass, the sweep and
    (bf16, fp16) the dq epilogue; returns ``(dq, dk, dv)``.  For fp32 the
    workspace is dq itself."""
    B, Sq, H, D = q.shape
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    ws = dq if q.dtype == torch.float32 else torch.empty(
        (B, Sq, H, D), dtype=torch.float32, device=q.device)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    strides = strides_of(q, k, v, out, dout, dk, dv)
    _raise_on(getattr(lib, entry)(
        _DTYPE_CODES[q.dtype], D, _ptr(q), _ptr(k), _ptr(v), _ptr(out),
        _ptr(dout), _ptr(lse), _ptr(delta), _ptr(ws), _ptr(dq), _ptr(dk),
        _ptr(dv), _ptr(q_seg), _ptr(k_seg), B, H, Sq, k.shape[1],
        int(causal), float(scale), ctypes.cast(strides, ctypes.c_void_p),
        stream), entry)
    return dq, dk, dv


def _launch_bwd_fused(lib, stream, *args):
    return _fused_call("flash_bwd_fused", _strides, lib, stream, *args)


def _launch_bwd_fused_tc(lib, stream, *args):
    return _fused_call("flash_bwd_fused_tc", _tma_strides, lib, stream,
                       *args)


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _empty(q, k):
    return 0 in (q.shape[0], q.shape[1], q.shape[2], k.shape[1])


def flash_fwd(q, k, v, causal, q_seg=None, k_seg=None, scale=None):
    """Attention forward: ``(out [B, Sq, H, D], lse [B, H, Sq] fp32)``.
    ``causal`` masks key positions after the query position (row-aligned
    at 0, so it needs ``Sq == Sk``); ``q_seg``/``k_seg`` int32 ``[B, Sq]``
    / ``[B, Sk]`` let a query see only keys of its own segment.  On the
    card bf16 and fp16 at head dim 64 or 128 run the tensor-core kernel;
    fp32, and head dims 16 and 32 in every dtype, the CUDA-core one."""
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
    tc = _is_tc(q)
    if tc:
        _tc_ready(q=q, k=k, v=v)
    lib = _tc_kernel() if tc else _kernel()
    with torch.cuda.device(q.device):
        launch = _launch_fwd_tc if tc else _launch_fwd
        res = launch(lib, _stream(q), q, k, v, causal, q_seg, k_seg, scale)
    flash_fwd.launches += 1
    flash_fwd.tc_launches += tc
    return res


def flash_bwd_dq(q, k, v, out, lse, dout, causal, q_seg=None, k_seg=None,
                 scale=None):
    """Gradient of the attention input ``q``: ``(dq, delta)`` with
    ``delta = rowsum(dout * out)`` fp32 ``[B, H, Sq]``, which
    :func:`flash_bwd_dkv` reads.  On the card bf16 and fp16 at head dim
    64 or 128 run the tensor-core kernel; fp32, and head dims 16 and 32
    in every dtype, the CUDA-core one."""
    _check(q, k, v, q_seg, k_seg, extra=(out, dout))
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        flash_bwd_dq.plain_calls += 1
        with torch.no_grad():
            return flash_bwd_dq_reference(q, k, v, out, lse, dout, causal,
                                          q_seg, k_seg, scale)
    return _bwd_dq(flash_bwd_dq, _is_tc(q), q, k, v, out, lse, dout, causal,
                   q_seg, k_seg, scale)


def _bwd_dq(counter, tc, q, k, v, out, lse, dout, causal, q_seg, k_seg,
            scale):
    """Launch dq on the card: the tensor-core body when ``tc`` (TMA's
    rule checked first), else the CUDA-core one; counts in ``counter``."""
    _kernel_ready(q)
    q, k, v, out, dout = _rows(q), _rows(k), _rows(v), _rows(out), _rows(dout)
    q_seg, k_seg = _segs(q_seg, k_seg)
    if _empty(q, k):
        return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
                torch.zeros(lse.shape, device=q.device))
    if tc:
        _tc_ready(q=q, k=k, v=v, out=out, dout=dout)
    lse = lse.contiguous()
    lib = _bwd_tc_kernel() if tc else _kernel()
    with torch.cuda.device(q.device):
        launch = _launch_bwd_dq_tc if tc else _launch_bwd_dq
        res = launch(lib, _stream(q), q, k, v, out, lse, dout, causal, q_seg,
                     k_seg, scale)
    counter.launches += 1
    if counter is flash_bwd_dq:
        counter.tc_launches += tc
    return res


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal, q_seg=None, k_seg=None,
                  scale=None):
    """Gradients of the attention inputs ``k`` and ``v``: ``(dk, dv)``.
    Runs after :func:`flash_bwd_dq`, whose ``delta`` it reads; routed as
    :func:`flash_bwd_dq` is."""
    _check(q, k, v, q_seg, k_seg, extra=(dout,))
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        flash_bwd_dkv.plain_calls += 1
        with torch.no_grad():
            return flash_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                           causal, q_seg, k_seg, scale)
    return _bwd_dkv(flash_bwd_dkv, _is_tc(q), q, k, v, dout, lse, delta,
                    causal, q_seg, k_seg, scale)


def _bwd_dkv(counter, tc, q, k, v, dout, lse, delta, causal, q_seg, k_seg,
             scale):
    """Launch dk/dv on the card, as :func:`_bwd_dq` launches dq."""
    _kernel_ready(q)
    q, k, v, dout = _rows(q), _rows(k), _rows(v), _rows(dout)
    q_seg, k_seg = _segs(q_seg, k_seg)
    if _empty(q, k):
        return (torch.zeros(k.shape, dtype=k.dtype, device=k.device),
                torch.zeros(v.shape, dtype=v.dtype, device=v.device))
    if tc:
        _tc_ready(q=q, k=k, v=v, dout=dout)
    lse, delta = lse.contiguous(), delta.contiguous()
    lib = _bwd_tc_kernel() if tc else _kernel()
    with torch.cuda.device(q.device):
        launch = _launch_bwd_dkv_tc if tc else _launch_bwd_dkv
        res = launch(lib, _stream(q), q, k, v, dout, lse, delta, causal,
                     q_seg, k_seg, scale)
    counter.launches += 1
    if counter is flash_bwd_dkv:
        counter.tc_launches += tc
    return res


def flash_fwd_hpack(q, k, v, hp, causal, scale=None):
    """:func:`flash_fwd`'s outputs with ``hp`` consecutive heads of the
    flattened ``B*H`` per CTA (the JAX package's head-packed forward; no
    segment ids).  ``B*H`` must divide by ``hp``; heads are consecutive
    along ``B*H``, so with an odd ``H`` a CTA's heads straddle two
    batches.  The kernels are built for ``hp`` in :data:`HPACK_HEADS` at
    head dims :data:`HPACK_HEAD_DIMS` (the tensor-core body at 64, in
    bf16 and fp16); other values raise ``NotImplementedError`` on the
    card.  The plain version is :func:`flash_attention_reference`."""
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
    if hp not in HPACK_HEADS or q.shape[-1] not in HPACK_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_fwd_hpack's kernels are built for hp in {HPACK_HEADS} "
            f"at head dims {HPACK_HEAD_DIMS}, got hp={hp}, head dim "
            f"{q.shape[-1]}")
    q, k, v = _rows(q), _rows(k), _rows(v)
    if _empty(q, k):
        return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
                torch.full((q.shape[0], q.shape[2], q.shape[1]), LSE_FLOOR,
                           device=q.device))
    tc = _is_tc(q, (64,))
    if tc:
        _tc_ready(q=q, k=k, v=v)
    lib = _tc_kernel() if tc else _kernel()
    with torch.cuda.device(q.device):
        launch = _launch_fwd_hpack_tc if tc else _launch_fwd_hpack
        res = launch(lib, _stream(q), q, k, v, hp, causal, scale)
    flash_fwd_hpack.launches += 1
    flash_fwd_hpack.tc_launches += tc
    return res


def _cuda_core_fwd(q, k, v, causal, q_seg=None, k_seg=None, scale=None,
                   hp=1):
    """The CUDA-core forward of ``csrc/flash_attention.cu`` in any dtype
    it takes (``flash_fwd_hpack``'s kernel when ``hp > 1``): the design
    the tensor-core kernel replaced for bf16 and fp16 at head dims 64
    and 128, kept for comparison on the card.  No wrapper calls it; its
    launches count in ``_cuda_core_fwd.launches``, not in the
    wrappers'."""
    _check(q, k, v, q_seg, k_seg)
    _kernel_ready(q)
    q, k, v = _rows(q), _rows(k), _rows(v)
    q_seg, k_seg = _segs(q_seg, k_seg)
    scale, lib = _scale(q, scale), _kernel()
    with torch.cuda.device(q.device):
        if hp > 1:
            res = _launch_fwd_hpack(lib, _stream(q), q, k, v, hp, causal,
                                    scale)
        else:
            res = _launch_fwd(lib, _stream(q), q, k, v, causal, q_seg,
                              k_seg, scale)
    _cuda_core_fwd.launches += 1
    return res


def _cuda_core_flash_bwd(which, q, k, v, t, lse, u, causal, q_seg=None,
                         k_seg=None, scale=None):
    """The CUDA-core backward of ``csrc/flash_attention.cu`` in any dtype
    it takes: ``which`` ``"dq"`` (``t, u = out, dout``; returns ``(dq,
    delta)``), ``"dkv"`` (``t, u = dout, delta``; returns ``(dk, dv)``) or
    ``"fused"`` (``t, u = out, dout``; returns ``(dq, dk, dv)``, the
    single sweep).  The designs the tensor-core kernels replaced for bf16
    and fp16 at head dims 64 and 128, kept for comparison on the card.
    No wrapper calls it; its launches count in
    ``_cuda_core_flash_bwd.launches``, not in the wrappers' (the fused
    sweep's helpers included)."""
    _check(q, k, v, q_seg, k_seg, extra=(t,) if which == "dkv" else (t, u))
    scale = _scale(q, scale)
    if which == "dq":
        return _bwd_dq(_cuda_core_flash_bwd, False, q, k, v, t, lse, u,
                       causal, q_seg, k_seg, scale)
    if which == "fused":
        return _bwd_fused(_cuda_core_flash_bwd, False, q, k, v, t, lse, u,
                          causal, q_seg, k_seg, scale)
    return _bwd_dkv(_cuda_core_flash_bwd, False, q, k, v, t, lse, u, causal,
                    q_seg, k_seg, scale)


def flash_bwd_fused(q, k, v, out, lse, dout, causal, q_seg=None, k_seg=None,
                    scale=None):
    """Gradients of q, k and v in one sweep: ``(dq, dk, dv)``.  Three
    launches: the pre-pass (delta, zeroed fp32 dq workspace), the sweep
    (one CTA per kv tile, dq's partials added through fp32 atomics) and,
    for bf16 and fp16, the dq epilogue; the helpers count in
    ``flash_bwd_fused.helper_launches``.  On the card bf16 and fp16 at
    head dim 64 or 128 run the tensor-core sweep
    (``flash_bwd_fused_tc``), fp32 and head dims 16 and 32 the CUDA-core
    one.  dk and dv are the same bits on every run; dq's atomic sums may
    differ by a few fp32 ulps of its magnitude from run to run."""
    _check(q, k, v, q_seg, k_seg, extra=(out, dout))
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        flash_bwd_fused.plain_calls += 1
        with torch.no_grad():
            return flash_bwd_fused_reference(q, k, v, out, lse, dout, causal,
                                             q_seg, k_seg, scale)
    return _bwd_fused(flash_bwd_fused, _is_tc(q), q, k, v, out, lse, dout,
                      causal, q_seg, k_seg, scale)


def _bwd_fused(counter, tc, q, k, v, out, lse, dout, causal, q_seg, k_seg,
               scale):
    """Launch the fused backward on the card, as :func:`_bwd_dq` launches
    dq; the helpers count in ``flash_bwd_fused.helper_launches`` only for
    the wrapper's own launches."""
    _kernel_ready(q)
    q, k, v, out, dout = _rows(q), _rows(k), _rows(v), _rows(out), _rows(dout)
    q_seg, k_seg = _segs(q_seg, k_seg)
    if _empty(q, k):
        return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
                torch.zeros(k.shape, dtype=k.dtype, device=k.device),
                torch.zeros(v.shape, dtype=v.dtype, device=v.device))
    if tc:
        _tc_ready(q=q, k=k, v=v, out=out, dout=dout)
    lse = lse.contiguous()
    lib = _bwd_tc_kernel() if tc else _kernel()
    with torch.cuda.device(q.device):
        launch = _launch_bwd_fused_tc if tc else _launch_bwd_fused
        res = launch(lib, _stream(q), q, k, v, out, lse, dout, causal, q_seg,
                     k_seg, scale)
    counter.launches += 1
    if counter is flash_bwd_fused:
        counter.tc_launches += tc
        helpers = counter.helper_launches
        helpers["flash_bwd_fused_prep"] += 1
        if q.dtype != torch.float32:
            helpers["flash_bwd_fused_dq_cast"] += 1
    return res


#: the default path's kernels, and those the [B*H, S, D] knobs select
WRAPPERS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
BH_WRAPPERS = (flash_fwd_hpack, flash_bwd_fused)
ALL_WRAPPERS = WRAPPERS + BH_WRAPPERS
#: the wrappers with a tensor-core body (``tc_launches``)
TC_WRAPPERS = (flash_fwd, flash_fwd_hpack, flash_bwd_dq, flash_bwd_dkv,
               flash_bwd_fused)
#: every function that keeps launch counts (``ops/counts.py`` reads them)
COUNTED = ALL_WRAPPERS + (_cuda_core_fwd, _cuda_core_flash_bwd)


def reset_counts():
    """Set every wrapper's ``launches``, ``tc_launches`` and
    ``plain_calls`` (and the fused backward's helper launches and the
    CUDA-core comparison forward's and backward's launches) to 0."""
    for fn in ALL_WRAPPERS:
        fn.launches = 0
        fn.plain_calls = 0
    for fn in TC_WRAPPERS:
        fn.tc_launches = 0
    flash_bwd_fused.helper_launches = dict.fromkeys(FUSED_HELPERS, 0)
    _cuda_core_fwd.launches = 0
    _cuda_core_flash_bwd.launches = 0


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
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        # the kernels have no double backward: a second-order gradient
        # through this Function raises instead of reading as zero
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
