"""Fused lm-head cross-entropy: the hand-written CUDA kernels, their
wrappers, their plain versions, their launch counts and the autograd
function around them (counterpart of ``paddle_tpu/ops/pallas_lmce.py``).

Three kernels in ``csrc/lmce.cu`` compute the per-token cross-entropy
of ``softmax(h @ w.T)`` against ``labels`` without writing the
``[N, V]`` logits to memory:

- :func:`lmce_fwd` -> ``(loss, lse)``, both fp32 ``[N]``;
- :func:`lmce_bwd_dh` -> ``dh`` ``[N, D]`` in ``h``'s dtype;
- :func:`lmce_bwd_dw` -> ``dw`` ``[V, D]`` in ``w``'s dtype.

``h`` is ``[N, D]``, ``w`` is ``[V, D]``, ``labels`` any integer
``[N]`` (taken as int32).  The semantics are the JAX kernels': a label
``< 0`` is ignored (0 loss, 0 gradient), the running max starts at
:data:`NEG`, ``lse = m + log(max(l, TINY))``, a label outside
``[0, V)`` picks :data:`NEG`, and the backward rounds
``dl = (exp(S - lse) - onehot) * g`` to the operand dtype before its
product, with every sum in fp32.

On a CUDA tensor a wrapper launches its kernel or raises (a build
failure raises :class:`~paddle_tpu_torch._build.KernelBuildError`); the
kernels take fp32 or bf16 (both operands alike) with ``D`` a positive
multiple of 8 up to :data:`MAX_D`, and any other ``D`` raises
``NotImplementedError``.  On a CPU tensor it runs its plain version,
which repeats the kernel's arithmetic with whole-tensor ops (and so
materialises the logits).  Each launch adds one to
``<wrapper>.launches``; each plain run adds one to
``<wrapper>.plain_calls``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

KERNEL_NAME = "lmce"
#: start of the running max, and the picked logit of an unmatched label
NEG = -1e30
#: denominator guard of the log-sum-exp
TINY = 1e-30
MAX_D = 65536
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def bind(lib):
    """Set the argument and result types of ``lib``'s three entries
    (``lib`` built from ``csrc/lmce.cu``); returns ``lib``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lmce_fwd.argtypes = [i] + [p] * 5 + [i] * 3 + [p]
    for fn in (lib.lmce_bwd_dh, lib.lmce_bwd_dw):
        fn.argtypes = [i] + [p] * 6 + [i] * 3 + [p]
    for fn in (lib.lmce_fwd, lib.lmce_bwd_dh, lib.lmce_bwd_dw):
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
def _logits(h, w):
    """fp32 ``h @ w.T`` of the operands' values, as the kernels sum."""
    return h.float() @ w.float().t()


def lmce_reference(h, w, labels):
    """Plain version of :func:`lmce_fwd` (the JAX package's
    ``_reference``): ``(loss, lse)`` fp32 ``[N]``.  Differentiable
    through torch's autograd in ``h`` and ``w``."""
    s = _logits(h, w)
    lab = labels.to(device=s.device, dtype=torch.int64)
    m = s.amax(dim=-1).clamp_min(NEG).detach()
    lse = m + torch.log(torch.exp(s - m[:, None]).sum(-1).clamp_min(TINY))
    inside = (lab >= 0) & (lab < w.shape[0])
    picked = torch.gather(s, 1, lab.clamp(0, w.shape[0] - 1)[:, None])[:, 0]
    picked = torch.where(inside, picked, torch.full_like(picked, NEG))
    loss = torch.where(lab >= 0, lse - picked, torch.zeros_like(lse))
    return loss, lse


def _dlogits(h, w, labels, lse, g, dtype):
    """``(exp(S - lse) - onehot) * g`` with ``g`` zeroed on ignored rows,
    rounded to ``dtype`` and returned in fp32 (``[N, V]``)."""
    s = _logits(h, w)
    lab = labels.to(device=s.device, dtype=torch.int64)
    cols = torch.arange(w.shape[0], device=s.device)
    onehot = (cols[None, :] == lab[:, None]).float()
    gv = torch.where(lab >= 0, g.float(), torch.zeros_like(g.float()))
    dl = (torch.exp(s - lse.float()[:, None]) - onehot) * gv[:, None]
    return dl.to(dtype).float()


def lmce_bwd_dh_reference(h, w, labels, lse, g):
    """Plain version of :func:`lmce_bwd_dh` (the JAX package's composed
    backward): ``dl.astype(w.dtype) @ w`` in fp32, as ``h``'s dtype."""
    dl = _dlogits(h, w, labels, lse, g, w.dtype)
    return (dl @ w.float()).to(h.dtype)


def lmce_bwd_dw_reference(h, w, labels, lse, g):
    """Plain version of :func:`lmce_bwd_dw`: ``dl.T.astype(h.dtype) @ h``
    in fp32, as ``w``'s dtype."""
    dl = _dlogits(h, w, labels, lse, g, h.dtype)
    return (dl.t() @ h.float()).to(w.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check(h, w, labels, rows=()):
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"h must be [N, D] and w [V, D], got "
                         f"{tuple(h.shape)}, {tuple(w.shape)}")
    if h.dtype != w.dtype:
        raise TypeError(f"h and w must share one dtype, got {h.dtype}, "
                        f"{w.dtype}")
    n = h.shape[0]
    for name, t in (("labels", labels),) + tuple(rows):
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
    if labels.is_floating_point() or labels.is_complex():
        raise TypeError(f"labels must be integers, got {labels.dtype}")
    devices = {t.device for t in (h, w, labels) + tuple(t for _, t in rows)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share one device, got {devices}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {h.device}")


def _kernel_ready(h):
    """The CUDA path's own limits (the plain version takes anything)."""
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"the lmce kernels take float32 or bfloat16, got "
                        f"{h.dtype}")
    d = h.shape[1]
    if d <= 0 or d % 8 or d > MAX_D:
        raise NotImplementedError(
            f"the lmce kernels take D a positive multiple of 8 up to "
            f"{MAX_D}, got {d}")


def _aligned(t):
    """``t`` contiguous with a 16-byte-aligned start (the kernels load
    8 elements at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t):
    return t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _launch_fwd(lib, stream, h, w, labels):
    N, D = h.shape
    loss = torch.empty(N, dtype=torch.float32, device=h.device)
    lse = torch.empty(N, dtype=torch.float32, device=h.device)
    _raise_on(lib.lmce_fwd(
        _DTYPE_CODES[h.dtype], _ptr(h), _ptr(w), _ptr(labels), _ptr(loss),
        _ptr(lse), N, w.shape[0], D, stream), "lmce_fwd")
    return loss, lse


def _launch_bwd(lib, stream, which, h, w, labels, lse, g):
    N, D = h.shape
    like = h if which == "lmce_bwd_dh" else w
    grad = torch.empty(like.shape, dtype=like.dtype, device=like.device)
    _raise_on(getattr(lib, which)(
        _DTYPE_CODES[h.dtype], _ptr(h), _ptr(w), _ptr(labels), _ptr(lse),
        _ptr(g), _ptr(grad), N, w.shape[0], D, stream), which)
    return grad


def _launch_bwd_dh(lib, stream, h, w, labels, lse, g):
    return _launch_bwd(lib, stream, "lmce_bwd_dh", h, w, labels, lse, g)


def _launch_bwd_dw(lib, stream, h, w, labels, lse, g):
    return _launch_bwd(lib, stream, "lmce_bwd_dw", h, w, labels, lse, g)


def lmce_fwd(h, w, labels):
    """Per-token cross-entropy of ``softmax(h @ w.T)``: ``(loss [N],
    lse [N])``, both fp32."""
    _check(h, w, labels)
    if h.device.type == "cpu":
        lmce_fwd.plain_calls += 1
        with torch.no_grad():
            return lmce_reference(h, w, labels)
    _kernel_ready(h)
    if h.shape[0] == 0:
        empty = torch.empty(0, dtype=torch.float32, device=h.device)
        return empty, empty.clone()
    h, w = _aligned(h), _aligned(w)
    labels = labels.to(torch.int32).contiguous()
    lib = _kernel()
    with torch.cuda.device(h.device):
        res = _launch_fwd(lib, _stream(h), h, w, labels)
    lmce_fwd.launches += 1
    return res


def _backward(wrapper, launch, plain, h, w, labels, lse, g):
    _check(h, w, labels, rows=(("lse", lse), ("g", g)))
    if h.device.type == "cpu":
        wrapper.plain_calls += 1
        with torch.no_grad():
            return plain(h, w, labels, lse, g)
    _kernel_ready(h)
    out_like = h if launch is _launch_bwd_dh else w
    if h.shape[0] == 0:
        return torch.zeros(out_like.shape, dtype=out_like.dtype,
                           device=out_like.device)
    h, w = _aligned(h), _aligned(w)
    labels = labels.to(torch.int32).contiguous()
    lse = lse.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    lib = _kernel()
    with torch.cuda.device(h.device):
        res = launch(lib, _stream(h), h, w, labels, lse, g)
    wrapper.launches += 1
    return res


def lmce_bwd_dh(h, w, labels, lse, g):
    """Gradient of ``sum(g * loss)`` in ``h``: ``[N, D]`` in ``h``'s
    dtype, from the forward's ``lse`` and the cotangent ``g`` ``[N]``."""
    return _backward(lmce_bwd_dh, _launch_bwd_dh, lmce_bwd_dh_reference, h,
                     w, labels, lse, g)


def lmce_bwd_dw(h, w, labels, lse, g):
    """Gradient of ``sum(g * loss)`` in ``w``: ``[V, D]`` in ``w``'s
    dtype."""
    return _backward(lmce_bwd_dw, _launch_bwd_dw, lmce_bwd_dw_reference, h,
                     w, labels, lse, g)


WRAPPERS = (lmce_fwd, lmce_bwd_dh, lmce_bwd_dw)
for _fn in WRAPPERS:
    _fn.launches = 0
    _fn.plain_calls = 0
del _fn


def reset_counts():
    """Set every wrapper's ``launches`` and ``plain_calls`` to 0."""
    for fn in WRAPPERS:
        fn.launches = 0
        fn.plain_calls = 0


class FusedLinearCrossEntropy(torch.autograd.Function):
    """``loss = cross_entropy(h @ w.T, labels)`` per token, whose
    forward is :func:`lmce_fwd` and whose backward is
    :func:`lmce_bwd_dh` then :func:`lmce_bwd_dw` (the JAX package's
    ``custom_vjp``), on whichever device the tensors lie.  Saves h, w,
    the int32 labels and lse."""

    @staticmethod
    def forward(ctx, h, w, labels):
        labels = labels.to(torch.int32)
        loss, lse = lmce_fwd(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        g = g.float()
        dh = lmce_bwd_dh(h, w, labels, lse, g)
        dw = lmce_bwd_dw(h, w, labels, lse, g)
        return dh, dw, None


def fused_linear_cross_entropy(h, w, labels):
    """Per-token cross-entropy of ``softmax(h @ w.T)`` against
    ``labels``: ``h`` ``[N, D]``, ``w`` ``[V, D]``, ``labels`` integer
    ``[N]`` -> fp32 ``[N]``, 0 where a label is negative.  On the card
    the ``[N, V]`` logits never reach device memory."""
    return FusedLinearCrossEntropy.apply(h, w, labels)


# ---------------------------------------------------------------------------
# least work of each kernel (for the bound the chip smoke reports)
# ---------------------------------------------------------------------------
def kernel_work(name, N, V, D, itemsize):
    """``(flops, bytes)`` one call of kernel ``name`` must do: each input
    read once and each output written once; 2 flops per multiply-add of
    each product it needs (fwd: S = h w^T; dh and dw: S again, then
    dL w or dL^T h).  The exps and the data-dependent skips are not
    counted: these kernels compute every tile."""
    h_bytes, w_bytes = N * D * itemsize, V * D * itemsize
    if name == "lmce_fwd":
        # h, w, labels in; loss, lse out
        return 2 * N * V * D, h_bytes + w_bytes + 3 * 4 * N
    if name == "lmce_bwd_dh":
        # h, w, labels, lse, g in; dh out
        return 4 * N * V * D, 2 * h_bytes + w_bytes + 3 * 4 * N
    if name == "lmce_bwd_dw":
        # h, w, labels, lse, g in; dw out
        return 4 * N * V * D, h_bytes + 2 * w_bytes + 3 * 4 * N
    raise ValueError(f"unknown kernel {name!r}")
