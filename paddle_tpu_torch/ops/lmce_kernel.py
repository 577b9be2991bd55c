"""Fused lm-head cross-entropy: the hand-written CUDA kernels, their
wrappers, their plain versions, their launch counts and the autograd
function around them (counterpart of ``paddle_tpu/ops/pallas_lmce.py``).

Three kernels in ``csrc/lmce.cu`` (fp32 FMAs on the CUDA cores), the
forward also in ``csrc/lmce_fwd_sm90.cu`` and the two backward ones in
``csrc/lmce_sm90.cu`` (bf16 and fp16 on the tensor cores, ``wgmma`` fed by
TMA), compute the per-token cross-entropy of
``softmax(h @ w.T)`` against ``labels`` without writing the ``[N, V]``
logits to memory:

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
kernels take fp32, bf16 or fp16 (both operands alike) with ``D`` a
positive multiple of 8 up to :data:`MAX_D`, and any other ``D`` raises
``NotImplementedError``.  Every wrapper routes by dtype before any
launch: bf16 and fp16 launch the tensor-core entries (``lmce_fwd_tc``,
``lmce_bwd_dh_tc`` / ``lmce_bwd_dw_tc``), fp32 the CUDA-core ones
(TF32 would break the fp32 parity gates).  The tensor-core forward
splits the vocabulary into :func:`vocab_slices` runs so its grid fills
the card, writes a partial (max, sum-exp, pick) per row and slice, and
merges them in slice order (:func:`lmce_fwd_split_reference` is its
plain mirror).  TMA reads h and w from the
wrapper's contiguous, 16-byte-aligned copies (D a multiple of 8 is
TMA's 16-byte row stride at 2 bytes an element).  Neither body falls
back to the other.  On a CPU tensor a wrapper runs
its plain version, which repeats the kernel's arithmetic with
whole-tensor ops (and so materialises the logits).  Each launch adds
one to ``<wrapper>.launches`` and, for the tensor-core body, to
``<wrapper>.tc_launches``; each plain run adds one to
``<wrapper>.plain_calls``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

KERNEL_NAME = "lmce"
TC_KERNEL_NAME = "lmce_sm90"
TC_FWD_KERNEL_NAME = "lmce_fwd_sm90"
#: the tensor-core forward's h rows per CTA and vocabulary rows per tile
FWD_ROW_BLOCK = 128
FWD_VOCAB_TILE = 64
#: start of the running max, and the picked logit of an unmatched label
NEG = -1e30
#: denominator guard of the log-sum-exp
TINY = 1e-30
MAX_D = 65536
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TC_DTYPES = (torch.bfloat16, torch.float16)
_TC_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled",
              -2: "the driver refused a tensor map"}
_lib = None
_tc_lib = None
_fwd_tc_lib = None


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


def bind_tc(lib):
    """The same for the tensor-core backward's library
    (``csrc/lmce_sm90.cu``, bf16 and fp16)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.lmce_bwd_dh_tc, lib.lmce_bwd_dw_tc):
        fn.argtypes = [i] + [p] * 6 + [i] * 3 + [p]
        fn.restype = ctypes.c_int
    return lib


def bind_fwd_tc(lib):
    """The same for the tensor-core forward's library
    (``csrc/lmce_fwd_sm90.cu``, bf16 and fp16): ``lmce_fwd``'s signature
    with the partials' workspace and the slice count after lse."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lmce_fwd_tc.argtypes = [i] + [p] * 6 + [i] * 4 + [p]
    lib.lmce_fwd_tc.restype = ctypes.c_int
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


def _fwd_tc_kernel():
    global _fwd_tc_lib
    if _fwd_tc_lib is None:
        _fwd_tc_lib = bind_fwd_tc(_build.load(TC_FWD_KERNEL_NAME))
    return _fwd_tc_lib


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


def vocab_slices(n, v, sms):
    """How many vocabulary slices the tensor-core forward splits ``v``
    into for ``n`` rows on a card of ``sms`` SMs: enough CTAs (row
    blocks x slices) for one CTA an SM, each slice a run of whole
    64-row tiles and none empty."""
    row_blocks = -(-n // FWD_ROW_BLOCK)
    n_vt = -(-v // FWD_VOCAB_TILE)
    slices = min(max(1, sms // row_blocks), n_vt, 65535)
    per = -(-n_vt // slices)
    return -(-n_vt // per)


def lmce_fwd_partials(h, w, labels, slices):
    """The tensor-core forward's partials on whole tensors: fp32 ``[3,
    slices, N]`` of each row's max (from :data:`NEG`), sum of ``exp(S -
    max)`` and picked logit (:data:`NEG` where the label is not in the
    slice) over each slice's vocabulary columns."""
    s = _logits(h, w)
    lab = labels.to(device=s.device, dtype=torch.int64)
    n_vt = -(-w.shape[0] // FWD_VOCAB_TILE)
    per = -(-n_vt // slices) * FWD_VOCAB_TILE
    part = torch.empty((3, slices, h.shape[0]), dtype=torch.float32,
                       device=s.device)
    for k in range(slices):
        lo, hi = k * per, min((k + 1) * per, w.shape[0])
        sk = s[:, lo:hi]
        m = (sk.amax(dim=-1) if hi > lo else
             torch.full_like(s[:, 0], NEG)).clamp_min(NEG)
        part[0, k] = m
        part[1, k] = torch.exp(sk - m[:, None]).sum(-1)
        inside = (lab >= lo) & (lab < hi)
        picked = torch.gather(s, 1, lab.clamp(0, w.shape[0] - 1)[:, None])
        part[2, k] = torch.where(inside, picked[:, 0],
                                 torch.full_like(m, NEG))
    return part


def lmce_fwd_combine(part, labels):
    """``(loss, lse)`` from :func:`lmce_fwd_partials`' layout, the slices
    merged in order as the kernel's combine merges them."""
    lab = labels.to(device=part.device, dtype=torch.int64)
    m = part[0].amax(dim=0)
    l = torch.zeros_like(m)
    for k in range(part.shape[1]):
        l = l + part[1, k] * torch.exp(part[0, k] - m)
    pick = part[2].amax(dim=0)
    lse = m + torch.log(l.clamp_min(TINY))
    return torch.where(lab >= 0, lse - pick, torch.zeros_like(lse)), lse


def lmce_fwd_split_reference(h, w, labels, slices):
    """Plain mirror of the tensor-core forward: the vocabulary cut into
    ``slices`` runs of 64-row tiles, a partial per row and slice, merged
    in slice order; equals :func:`lmce_reference` up to fp32 rounding."""
    return lmce_fwd_combine(lmce_fwd_partials(h, w, labels, slices), labels)


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
        raise TypeError(f"the lmce kernels take float32, bfloat16 or "
                        f"float16, got {h.dtype}")
    d = h.shape[1]
    if d <= 0 or d > MAX_D:
        raise NotImplementedError(
            f"the lmce kernels take D from 1 to {MAX_D}, got {d}")
    if d % 8:
        raise NotImplementedError(
            f"the lmce kernels take D a positive multiple of 8 (8-element "
            f"loads; for 16-bit operands TMA's 16-byte row stride), got {d}")


def _aligned(t):
    """``t`` contiguous with a 16-byte-aligned start (the CUDA-core
    kernels load 8 elements at a time; TMA needs the aligned base)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t):
    return t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, name):
    if err in _TC_ERRORS:
        raise RuntimeError(f"{name} kernel launch failed: {_TC_ERRORS[err]}")
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


def _launch_fwd_tc(lib, stream, h, w, labels):
    N, D = h.shape
    V = w.shape[0]
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    slices = vocab_slices(N, V, sms)
    loss = torch.empty(N, dtype=torch.float32, device=h.device)
    lse = torch.empty(N, dtype=torch.float32, device=h.device)
    part = torch.empty((3, slices, N), dtype=torch.float32, device=h.device)
    _raise_on(lib.lmce_fwd_tc(
        _DTYPE_CODES[h.dtype], _ptr(h), _ptr(w), _ptr(labels), _ptr(loss),
        _ptr(lse), _ptr(part), slices, N, V, D, stream), "lmce_fwd_tc")
    return loss, lse


def _launch_bwd(lib, stream, which, h, w, labels, lse, g):
    N, D = h.shape
    like = h if which.startswith("lmce_bwd_dh") else w
    grad = torch.empty(like.shape, dtype=like.dtype, device=like.device)
    _raise_on(getattr(lib, which)(
        _DTYPE_CODES[h.dtype], _ptr(h), _ptr(w), _ptr(labels), _ptr(lse),
        _ptr(g), _ptr(grad), N, w.shape[0], D, stream), which)
    return grad


def _launch_bwd_dh(lib, stream, h, w, labels, lse, g):
    return _launch_bwd(lib, stream, "lmce_bwd_dh", h, w, labels, lse, g)


def _launch_bwd_dw(lib, stream, h, w, labels, lse, g):
    return _launch_bwd(lib, stream, "lmce_bwd_dw", h, w, labels, lse, g)


def _launch_bwd_dh_tc(lib, stream, h, w, labels, lse, g):
    return _launch_bwd(lib, stream, "lmce_bwd_dh_tc", h, w, labels, lse, g)


def _launch_bwd_dw_tc(lib, stream, h, w, labels, lse, g):
    return _launch_bwd(lib, stream, "lmce_bwd_dw_tc", h, w, labels, lse, g)


def lmce_fwd(h, w, labels):
    """Per-token cross-entropy of ``softmax(h @ w.T)``: ``(loss [N],
    lse [N])``, both fp32.  On the card bf16 and fp16 run the
    tensor-core kernel, fp32 the CUDA-core one."""
    _check(h, w, labels)
    if h.device.type == "cpu":
        lmce_fwd.plain_calls += 1
        with torch.no_grad():
            return lmce_reference(h, w, labels)
    return _forward(lmce_fwd, h.dtype in _TC_DTYPES, h, w, labels)


def _forward(counter, tc, h, w, labels):
    """Launch the forward on the card: the tensor-core body when ``tc``,
    else the CUDA-core one; counts in ``counter``."""
    _kernel_ready(h)
    if h.shape[0] == 0:
        empty = torch.empty(0, dtype=torch.float32, device=h.device)
        return empty, empty.clone()
    h, w = _aligned(h), _aligned(w)
    labels = labels.to(torch.int32).contiguous()
    lib = _fwd_tc_kernel() if tc else _kernel()
    with torch.cuda.device(h.device):
        launch = _launch_fwd_tc if tc else _launch_fwd
        res = launch(lib, _stream(h), h, w, labels)
    counter.launches += 1
    if counter is lmce_fwd:
        counter.tc_launches += tc
    return res


def _cuda_core_fwd(h, w, labels):
    """The CUDA-core forward of ``csrc/lmce.cu`` in any dtype it takes:
    the design the tensor-core kernel replaced for bf16 and fp16, kept
    for comparison on the card.  No wrapper calls it; its launches count
    in ``_cuda_core_fwd.launches``, not in the wrappers'."""
    _check(h, w, labels)
    return _forward(_cuda_core_fwd, False, h, w, labels)


def _backward(wrapper, plain, h, w, labels, lse, g, tc=None):
    """``tc`` None routes by dtype (the wrappers); True or False forces
    a body (:func:`_cuda_core_bwd`)."""
    _check(h, w, labels, rows=(("lse", lse), ("g", g)))
    if h.device.type == "cpu":
        wrapper.plain_calls += 1
        with torch.no_grad():
            return plain(h, w, labels, lse, g)
    if tc is None:
        tc = h.dtype in _TC_DTYPES
    _kernel_ready(h)
    dh = plain is lmce_bwd_dh_reference
    out_like = h if dh else w
    if h.shape[0] == 0:
        return torch.zeros(out_like.shape, dtype=out_like.dtype,
                           device=out_like.device)
    h, w = _aligned(h), _aligned(w)
    if tc:
        launch = _launch_bwd_dh_tc if dh else _launch_bwd_dw_tc
    else:
        launch = _launch_bwd_dh if dh else _launch_bwd_dw
    labels = labels.to(torch.int32).contiguous()
    lse = lse.to(torch.float32).contiguous()
    g = g.to(torch.float32).contiguous()
    lib = _tc_kernel() if tc else _kernel()
    with torch.cuda.device(h.device):
        res = launch(lib, _stream(h), h, w, labels, lse, g)
    wrapper.launches += 1
    if wrapper in TC_WRAPPERS:
        wrapper.tc_launches += tc
    return res


def lmce_bwd_dh(h, w, labels, lse, g):
    """Gradient of ``sum(g * loss)`` in ``h``: ``[N, D]`` in ``h``'s
    dtype, from the forward's ``lse`` and the cotangent ``g`` ``[N]``.
    On the card bf16 and fp16 run the tensor-core kernel, fp32 the
    CUDA-core one."""
    return _backward(lmce_bwd_dh, lmce_bwd_dh_reference, h, w, labels, lse,
                     g)


def lmce_bwd_dw(h, w, labels, lse, g):
    """Gradient of ``sum(g * loss)`` in ``w``: ``[V, D]`` in ``w``'s
    dtype; routed as :func:`lmce_bwd_dh`."""
    return _backward(lmce_bwd_dw, lmce_bwd_dw_reference, h, w, labels, lse,
                     g)


def _cuda_core_bwd(which, h, w, labels, lse, g):
    """The CUDA-core backward of ``csrc/lmce.cu`` (``which`` is
    ``"dh"`` or ``"dw"``) in any dtype it takes: the design the
    tensor-core kernels replaced for bf16 and fp16, kept for comparison
    on the card.  No wrapper calls it; its launches count in
    ``_cuda_core_bwd.launches``, not in the wrappers'."""
    plain = lmce_bwd_dh_reference if which == "dh" else lmce_bwd_dw_reference
    return _backward(_cuda_core_bwd, plain, h, w, labels, lse, g, tc=False)


WRAPPERS = (lmce_fwd, lmce_bwd_dh, lmce_bwd_dw)
#: the wrappers with a tensor-core body (``tc_launches``)
TC_WRAPPERS = (lmce_fwd, lmce_bwd_dh, lmce_bwd_dw)
#: every function that keeps launch counts (``ops/counts.py`` reads them)
COUNTED = WRAPPERS + (_cuda_core_fwd, _cuda_core_bwd)


def reset_counts():
    """Set every wrapper's ``launches``, ``tc_launches`` and
    ``plain_calls`` (and the CUDA-core comparison forward's and
    backward's launches) to 0."""
    for fn in WRAPPERS:
        fn.launches = 0
        fn.plain_calls = 0
    for fn in TC_WRAPPERS:
        fn.tc_launches = 0
    _cuda_core_bwd.launches = 0
    _cuda_core_bwd.plain_calls = 0
    _cuda_core_fwd.launches = 0


reset_counts()


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
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        # no double backward: a second-order gradient raises
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
