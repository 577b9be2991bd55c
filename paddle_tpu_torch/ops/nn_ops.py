"""Composed operators of the port (counterpart of
``paddle_tpu/ops/nn_ops.py``): the masked attention, and the vision
zoo's convolution, pooling, BatchNorm, linear, channel shuffle and
resize (``interpolate``).  None of them was a Pallas kernel in the JAX
package (XLA's convolutions and reduce-windows, composed jnp); on the
card the convolutions are cuDNN's through ``F.conv2d``."""

from __future__ import annotations

import math

import torch

from ..amp.auto_cast import cast_inputs


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


# ---------------------------------------------------------------------------
# Convolution, pooling, BatchNorm, linear (the vision zoo's operators).
# Each casts its inputs by the AMP rule first (``amp/auto_cast.py``), as
# the JAX primitive hook does.
# ---------------------------------------------------------------------------
def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _same_pads(sizes, kernel, stride, dilation):
    """XLA's "SAME": ``ceil(in / s)`` outputs, the padding split with the
    odd element on the high side."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _resolve_padding(padding, sizes, kernel, stride, dilation=(1, 1)):
    """Paddle's padding spec as ``[(lo, hi)]`` per spatial dim: an int, a
    pair, a ``[lo0, hi0, lo1, hi1]`` list, or "SAME"/"VALID"."""
    nd = len(sizes)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * nd
        if padding.upper() == "SAME":
            return _same_pads(sizes, kernel, stride, dilation)
        raise ValueError(f"bad padding {padding!r}")
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = [int(p) for p in padding]
    if len(padding) == nd:
        return [(p, p) for p in padding]
    if len(padding) == 2 * nd:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    raise ValueError(f"bad padding {padding!r}")


def _torch_pad(pads):
    """``[(lo_h, hi_h), (lo_w, hi_w)]`` as ``F.pad``'s last-dim-first
    tuple."""
    return tuple(v for lo_hi in reversed(pads) for v in lo_hi)


def _nchw_only(data_format):
    """The vision ops run NCHW, the layout every zoo model uses; a
    channel-last layout is refused until a caller needs it."""
    if data_format not in ("NCHW", "NCL", "NC"):
        raise NotImplementedError(
            f"data_format={data_format!r} is not ported yet: the vision "
            "ops are NCHW only (ROADMAP queue A, item 2: channels_last)")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution (counterpart of ``nn_ops.conv2d``): weight
    ``[out, in/groups, kh, kw]`` (torch's OIHW), Paddle's padding forms
    (asymmetric ones pad first), ``F.conv2d`` as the body (cuDNN on the
    card).  The output follows the activation's dtype; the bias is
    added after that cast, as in the JAX function."""
    _nchw_only(data_format)
    x, weight, bias = cast_inputs("conv2d", x, weight, bias)
    stride, dilation = _pair(stride), _pair(dilation)
    pads = _resolve_padding(padding, x.shape[2:], weight.shape[2:], stride,
                            dilation)
    ct = torch.promote_types(x.dtype, weight.dtype)
    xc, wc = x.to(ct), weight.to(ct)
    if all(lo == hi for lo, hi in pads):
        pad_arg = tuple(lo for lo, _ in pads)
    else:
        xc = torch.nn.functional.pad(xc, _torch_pad(pads))
        pad_arg = 0
    fuse = bias is not None and bias.dtype == ct == x.dtype
    out = torch.nn.functional.conv2d(xc, wc, bias if fuse else None,
                                     stride, pad_arg, dilation, groups)
    out = out.to(x.dtype)
    if bias is not None and not fuse:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _pool_pads(x, kernel, stride, padding, ceil_mode):
    """The JAX ``_pool``'s padding: Paddle's spec, then with ``ceil_mode``
    the high side extended until the window count rounds up."""
    pads = _resolve_padding(padding, x.shape[2:], kernel, stride)
    if ceil_mode and not isinstance(padding, str):
        pads = [(lo, hi + (-(n + lo + hi - k) % s))
                for (lo, hi), n, k, s in zip(pads, x.shape[2:], kernel,
                                             stride)]
    return pads


def _native_pads(pads, kernel):
    """The symmetric padding torch's pools take for ``pads``, or None
    (asymmetric, or wider than half a window)."""
    if all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, kernel)):
        return tuple(lo for lo, _ in pads)
    return None


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    """Max pooling as ``lax.reduce_window`` with -inf padding does it
    (counterpart of ``nn_ops.max_pool2d``): ``ceil_mode`` extends the
    high-side padding, so a last window that starts in the padding
    gives -inf where torch's pool would drop it.  Symmetric windows go
    to ``F.max_pool2d``; the rest pad with -inf first."""
    if return_mask:
        raise NotImplementedError(
            "max_pool2d(return_mask=True) is not ported yet (ROADMAP queue "
            "A, item 8: the rest of nn/functional)")
    _nchw_only(data_format)
    (x,) = cast_inputs("max_pool2d", x)
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    pads = _pool_pads(x, k, s, padding, ceil_mode)
    native = _native_pads(pads, k)
    if native is not None:
        out = torch.nn.functional.max_pool2d(x, k, s, native)
    else:
        xp = torch.nn.functional.pad(x, _torch_pad(pads),
                                     value=float("-inf"))
        out = torch.nn.functional.max_pool2d(xp, k, s)
    return out


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """Average pooling (counterpart of ``nn_ops.avg_pool2d``).  Paddle's
    ``exclusive=True`` (the default) divides each window's sum by the
    count of real elements in it, torch's ``count_include_pad=False``;
    ``exclusive=False`` and unpadded windows divide by the window size;
    ``divisor_override`` divides the sum by itself.  Padding as in
    :func:`max_pool2d`, with zeros."""
    _nchw_only(data_format)
    F = torch.nn.functional
    (x,) = cast_inputs("avg_pool2d", x)
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    pads = _pool_pads(x, k, s, padding, ceil_mode)
    padded = any(lo or hi for lo, hi in pads)
    native = _native_pads(pads, k)
    if divisor_override:
        xp = F.pad(x, _torch_pad(pads)) if padded else x
        out = F.avg_pool2d(xp, k, s, divisor_override=1) / float(
            divisor_override)
    elif native is not None:
        out = F.avg_pool2d(x, k, s, native,
                           count_include_pad=not exclusive)
    else:
        total = F.avg_pool2d(F.pad(x, _torch_pad(pads)), k, s,
                             divisor_override=1)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            cnt = F.avg_pool2d(F.pad(ones, _torch_pad(pads)), k, s,
                               divisor_override=1)
            out = total / cnt
        else:
            out = total / float(k[0] * k[1])
    return out


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Mean over the windows ``[floor(i*n/o), ceil((i+1)*n/o))``, the JAX
    function's and ``F.adaptive_avg_pool2d``'s, divisible or not."""
    _nchw_only(data_format)
    (x,) = cast_inputs("adaptive_avg_pool2d", x)
    return torch.nn.functional.adaptive_avg_pool2d(x, _pair(output_size))


def adaptive_max_pool2d(x, output_size, return_mask=False):
    """Max over the windows of :func:`adaptive_avg_pool2d` (NCHW)."""
    if return_mask:
        raise NotImplementedError(
            "adaptive_max_pool2d(return_mask=True) is not ported yet "
            "(ROADMAP queue A, item 8: the rest of nn/functional)")
    (x,) = cast_inputs("adaptive_max_pool2d", x)
    return torch.nn.functional.adaptive_max_pool2d(x, _pair(output_size))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW"):
    """BatchNorm with the JAX functions' contract (``batch_norm_train`` /
    ``batch_norm_eval``): statistics in fp32, the output in the input's
    dtype.  While ``training`` it normalises by the batch's biased
    variance and updates ``running_mean`` / ``running_var`` IN PLACE by
    Paddle's convention, ``running = momentum * running + (1 -
    momentum) * batch``, with the unbiased variance (torch's
    ``momentum`` is Paddle's ``1 - momentum``).  In place matters: a
    captured training step (``framework/dispatch.py``) replays into
    the buffers' storage."""
    _nchw_only(data_format)
    op = "batch_norm_train" if training else "batch_norm_eval"
    x, weight, bias = cast_inputs(op, x, weight, bias)
    orig = x.dtype
    out = torch.nn.functional.batch_norm(
        x.float(), running_mean, running_var,
        None if weight is None else weight.float(),
        None if bias is None else bias.float(), training, 1.0 - momentum,
        epsilon)
    return out.to(orig)


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]`` (counterpart of
    ``nn_ops.linear``); operands of two dtypes meet in the wider one."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    if x.dtype != weight.dtype:
        ct = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(ct), weight.to(ct)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def channel_shuffle(x, groups, data_format="NCHW"):
    """ShuffleNet's channel shuffle, a reshape and a transpose (NCHW)."""
    _nchw_only(data_format)
    (x,) = cast_inputs("channel_shuffle", x)
    n, c, h, w = x.shape
    out = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
    return out.reshape(n, c, h, w)


# ---------------------------------------------------------------------------
# Resize (``interpolate``): ``jax.image.resize`` in torch.  Linear and
# cubic modes contract each resized axis with a weight matrix built as
# ``jax.image.compute_weight_mat`` builds it (float64, half-pixel
# centres, the kernel widened by the scale when shrinking: anti-aliased),
# then cast to the input's dtype; nearest gathers ``floor((i + 0.5) * in
# / out)``.  Every step is a device op (no host copy), so a captured
# graph holds its resize.  The linear and cubic backward is two matmuls
# (no atomic adds); nearest's is an ``index_add`` whose atomics sum two
# terms an element at a factor of 2 (CSPPAN's), which no order changes.
# ---------------------------------------------------------------------------
def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_RESIZE_KERNELS = {"linear": _triangle, "bilinear": _triangle,
                   "trilinear": _triangle, "triangle": _triangle,
                   "area": _triangle, "cubic": _keys_cubic,
                   "bicubic": _keys_cubic, "tricubic": _keys_cubic}


def _resize_weights(m, n, kernel, device):
    """The ``[m, n]`` weights that take ``m`` input samples to ``n``
    output samples (``jax.image.compute_weight_mat`` with antialias)."""
    f64 = torch.float64
    inv_scale = 1.0 / (n / m)
    sample = (torch.arange(n, dtype=f64, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=f64, device=device)[:, None]
         ).abs() / max(inv_scale, 1.0)
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(m, n, device):
    pos = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * m / n
    return torch.floor(pos).long().clamp_max(m - 1)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW"):
    """Resize the two spatial axes of ``x`` (NCHW or NHWC) to ``size``,
    or to ``int(side * scale_factor)``, computing what the JAX function
    computes: ``jax.image.resize`` with ``mode`` "nearest", "bilinear"
    (also "linear", "area") or "bicubic", half-pixel centres, and
    anti-aliasing when an axis shrinks (the kernel widened by the
    scale; ``F.interpolate(antialias=False)`` differs there).  Like the
    JAX function it ignores ``align_corners`` and ``align_mode``.  An
    axis whose size does not change is left as it is; the output has
    ``x``'s dtype (the weights are cast to it first, as JAX casts
    them)."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"interpolate: data_format {data_format!r}")
    (x,) = cast_inputs("interpolate", x)
    xc = x if data_format == "NCHW" else x.permute(0, 3, 1, 2)
    h, w = xc.shape[2:]
    if size is None:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else (scale_factor, scale_factor))
        size = (int(h * sf[0]), int(w * sf[1]))
    size = tuple(int(s) for s in size)
    if mode != "nearest" and mode not in _RESIZE_KERNELS:
        raise NotImplementedError(
            f"interpolate(mode={mode!r}) is not ported: nearest, "
            f"{', '.join(sorted(_RESIZE_KERNELS))}")
    out = xc
    for axis, (m, n) in zip((2, 3), zip((h, w), size)):
        if m == n:
            continue
        if mode == "nearest":
            out = out.index_select(axis, _nearest_index(m, n, x.device))
            continue
        wm = _resize_weights(m, n, _RESIZE_KERNELS[mode], x.device).to(
            x.dtype)
        out = torch.matmul(out, wm) if axis == 3 else \
            torch.matmul(wm.t(), out)
    return out if data_format == "NCHW" else out.permute(0, 2, 3, 1)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, data_format="NCHW"):
    return interpolate(x, size=size, scale_factor=scale_factor, mode=mode,
                       align_corners=align_corners, data_format=data_format)
