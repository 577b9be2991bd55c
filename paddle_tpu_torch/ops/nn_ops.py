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
from ..framework import random as _random


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


def dropout_refusals(axis, mode):
    """Refuse what the port's dropout does not do yet: a mask shared
    along axes and ``downscale_in_infer``."""
    if axis is not None or mode != "upscale_in_train":
        raise NotImplementedError(
            f"dropout(axis={axis!r}, mode={mode!r}) is not ported yet "
            "(ROADMAP queue A, item 8: the rest of nn/functional)")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Paddle's ``upscale_in_train`` dropout: while ``training``, zero
    each element with probability ``p`` and scale the rest by ``1 / (1
    - p)``; ``x`` itself otherwise or at ``p == 0``.  The mask comes from
    the port's generator of ``x``'s device (which a captured step
    registers).  ``axis`` and ``mode`` take Paddle's defaults only
    (``dropout_refusals``)."""
    dropout_refusals(axis, mode)
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=_random.default_generator(x.device),
                      device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


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


# ---------------------------------------------------------------------------
# Losses (counterparts of the JAX ``nn_ops`` loss functions).  Each casts
# its floating inputs by the AMP rule, as the JAX primitives are cast,
# and computes what the JAX function computes.
# ---------------------------------------------------------------------------
def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _class_weights(weight, lbl, n, device):
    w = torch.as_tensor(weight, device=device)
    return w[lbl.clamp(0, n - 1)]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Paddle's ``F.cross_entropy``.  Soft labels (``soft_label``, or a
    floating ``label`` shaped as ``input``): ``-sum(label * log_softmax
    (input))`` over ``axis``, the label smoothed to ``label * (1 - ls) +
    ls / C`` first.  Hard labels (``[N]`` or ``[N, 1]`` along ``axis``):
    ``lse - input[label]``, with ``label_smoothing`` the mix ``(1 - ls)
    * that + ls * (lse - mean(input))``; ``use_softmax=False`` reads
    ``input`` as probabilities (``log(max(p, 1e-30))``).  A hard label's
    loss is scaled by ``weight[label]`` and 0 where the label is
    ``ignore_index``; "mean" divides by the sum of those weights (the
    count of kept labels without ``weight``).  The arithmetic is fp32
    whatever ``input``'s dtype (the JAX soft-label branch runs in the
    input's); the gradient reaches ``input`` in its own dtype."""
    (input,) = cast_inputs("cross_entropy", input)
    logits = input
    ax = axis % logits.ndim
    n = logits.shape[ax]
    hard = not (soft_label or (
        label.ndim == logits.ndim and label.shape[ax] == n
        and label.is_floating_point()))
    lf = logits.float()
    if not hard:
        logp = (torch.log_softmax(lf, dim=ax) if use_softmax
                else torch.log(lf.clamp_min(1e-30)))
        soft = label.to(device=logits.device, dtype=torch.float32)
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n
        return _reduce_loss(-(soft * logp).sum(ax), reduction)
    lbl = label.to(device=logits.device, dtype=torch.int64)
    if lbl.ndim == logits.ndim and lbl.shape[ax] == 1:
        lbl = lbl.squeeze(ax)
    safe = lbl.clamp(0, n - 1).unsqueeze(ax)
    if use_softmax:
        lse = torch.logsumexp(lf, dim=ax)
        loss = lse - torch.gather(lf, ax, safe).squeeze(ax)
        if label_smoothing > 0:
            loss = (1 - label_smoothing) * loss + label_smoothing * (
                lse - lf.mean(ax))
    else:
        logp = torch.log(lf.clamp_min(1e-30))
        loss = -torch.gather(logp, ax, safe).squeeze(ax)
        if label_smoothing > 0:
            loss = (1 - label_smoothing) * loss + label_smoothing * (
                -logp.mean(ax))
    eff = None
    if weight is not None:
        eff = _class_weights(weight, lbl, n, logits.device).float()
    if ignore_index is not None:
        valid = (lbl != ignore_index).to(torch.float32)
        eff = valid if eff is None else eff * valid
    if eff is not None:
        loss = loss * eff
        if reduction == "mean":
            return loss.sum() / eff.sum().clamp_min(1e-12)
    return _reduce_loss(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """:func:`cross_entropy` per sample (hard labels keep ``axis`` as a
    dim of 1), with the softmax beside it if ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if not soft_label:
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    """``-input[label]`` (log-probabilities in), weighted and ignored as
    :func:`cross_entropy`'s hard labels are; the class axis is the
    last when ``input`` has one dim more than ``label``, else axis 1."""
    (input,) = cast_inputs("nll_loss", input)
    lbl = label.to(device=input.device, dtype=torch.int64)
    last = input.ndim == lbl.ndim + 1
    n = input.shape[-1] if last else input.shape[1]
    safe = lbl.clamp(0, n - 1)
    if last:
        loss = -torch.gather(input, -1, safe.unsqueeze(-1))[..., 0]
    else:
        loss = -torch.gather(input, 1, safe[:, None])[:, 0]
    eff = None
    if weight is not None:
        eff = _class_weights(weight, lbl, n, input.device).to(loss.dtype)
    if ignore_index is not None:
        valid = (lbl != ignore_index).to(loss.dtype)
        eff = valid if eff is None else eff * valid
    if eff is not None:
        loss = loss * eff
        if reduction == "mean":
            return loss.sum() / eff.sum().clamp_min(1e-12)
    return _reduce_loss(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    """``-(y log p + (1 - y) log(1 - p))``, each log's argument clamped
    at 1e-12."""
    input, label, weight = cast_inputs("binary_cross_entropy", input, label,
                                       weight)
    loss = -(label * torch.log(input.clamp_min(1e-12))
             + (1 - label) * torch.log((1 - input).clamp_min(1e-12)))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """The sigmoid cross-entropy in its stable form, ``pos_weight``
    scaling the positive term."""
    logit, label, weight, pos_weight = cast_inputs(
        "binary_cross_entropy_with_logits", logit, label, weight,
        pos_weight)
    softplus_term = torch.log1p(torch.exp(-logit.abs()))
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        loss = (1.0 - label) * logit + log_w * (
            softplus_term + (-logit).clamp_min(0.0))
    else:
        loss = logit.clamp_min(0.0) - logit * label + softplus_term
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def mse_loss(input, label, reduction="mean"):
    input, label = cast_inputs("mse_loss", input, label)
    return _reduce_loss(torch.square(input - label), reduction)


def square_error_cost(input, label):
    input, label = cast_inputs("square_error_cost", input, label)
    return torch.square(input - label)


def l1_loss(input, label, reduction="mean"):
    input, label = cast_inputs("l1_loss", input, label)
    return _reduce_loss((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    """Paddle's: ``0.5 d^2 / delta`` below ``delta``, ``d - delta / 2``
    above, times ``delta``."""
    input, label = cast_inputs("smooth_l1_loss", input, label)
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce_loss(loss * delta, reduction)


def huber_loss(input, label, delta=1.0, reduction="mean"):
    input, label = cast_inputs("huber_loss", input, label)
    r = (input - label).abs()
    loss = torch.where(r <= delta, 0.5 * torch.square(r),
                       delta * (r - 0.5 * delta))
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean"):
    """``label * (log label - input)`` (``input`` log-probabilities);
    "batchmean" divides the sum by the batch size."""
    input, label = cast_inputs("kl_div", input, label)
    loss = label * (torch.log(label.clamp_min(1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce_loss(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    input, other, label = cast_inputs("margin_ranking_loss", input, other,
                                      label)
    loss = (-label * (input - other) + margin).clamp_min(0.0)
    return _reduce_loss(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    input, label = cast_inputs("hinge_embedding_loss", input, label)
    loss = torch.where(label == 1.0, input, (margin - input).clamp_min(0.0))
    return _reduce_loss(loss, reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = cast_inputs("cosine_similarity", x1, x2)
    dot = (x1 * x2).sum(axis)
    n1 = torch.sqrt(torch.square(x1).sum(axis))
    n2 = torch.sqrt(torch.square(x2).sum(axis))
    return dot / (n1 * n2).clamp_min(eps)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    """``1 - cos`` for a label of 1, ``max(cos - margin, 0)`` else, the
    cosine over the last axis."""
    sim = cosine_similarity(input1, input2, axis=-1)
    loss = torch.where(label.to(sim.device) == 1, 1.0 - sim,
                       (sim - margin).clamp_min(0.0))
    return _reduce_loss(loss, reduction)


def _minkowski(d, p, keepdim=False):
    """``|d|_p`` over the last axis; p = inf the largest, p = 0 the count
    of non-zeros."""
    a = d.abs()
    if math.isinf(p):
        return a.amax(-1, keepdim=keepdim)
    if p == 0:
        return (a != 0).to(d.dtype).sum(-1, keepdim=keepdim)
    return torch.pow(torch.pow(a, p).sum(-1, keepdim=keepdim), 1.0 / p)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    """``|x - y + epsilon|_p`` over the last axis."""
    x, y = cast_inputs("pairwise_distance", x, y)
    return _minkowski(x - y + epsilon, p, keepdim=keepdim)


def soft_margin_loss(input, label, reduction="mean"):
    """``softplus(-y x)`` as ``logaddexp(-y x, 0)``."""
    input, label = cast_inputs("soft_margin_loss", input, label)
    z = -label * input
    return _reduce_loss(torch.logaddexp(z, torch.zeros_like(z)), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean"):
    """``exp(x) - y x`` (``log_input``) or ``x - y log(x + epsilon)``, with
    ``full`` Stirling's term where ``y > 1``."""
    input, label = cast_inputs("poisson_nll_loss", input, label)
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        safe = torch.where(label > 1.0, label, torch.ones_like(label))
        stirling = (safe * torch.log(safe) - safe
                    + 0.5 * torch.log(2.0 * math.pi * safe))
        loss = loss + torch.where(label > 1.0, stirling,
                                  torch.zeros_like(stirling))
    return _reduce_loss(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean"):
    input, label, variance = cast_inputs("gaussian_nll_loss", input, label,
                                         variance)
    var = variance.clamp_min(epsilon)
    loss = 0.5 * (torch.log(var) + torch.square(input - label) / var)
    if full:
        loss = loss + 0.5 * math.log(2.0 * math.pi)
    return _reduce_loss(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    input, positive, negative = cast_inputs(
        "triplet_margin_loss", input, positive, negative)
    dp = _minkowski(input - positive + epsilon, p)
    dn = _minkowski(input - negative + epsilon, p)
    if swap:
        dn = torch.minimum(dn, _minkowski(positive - negative + epsilon, p))
    return _reduce_loss((dp - dn + margin).clamp_min(0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """The triplet loss under ``distance_function`` (by default
    ``sqrt(sum((a - b + 1e-6)^2))`` over the last axis)."""
    if distance_function is None:
        def distance_function(a, b):
            d = (a - b) + 1e-6
            return (d * d).sum(-1).sqrt()
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        dn = torch.minimum(dn, distance_function(positive, negative))
    return _reduce_loss((dp - dn + margin).clamp_min(0.0), reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean"):
    """``sum_{j != y} max(0, margin - x[y] + x[j])^p / C`` a row."""
    (input,) = cast_inputs("multi_margin_loss", input)
    c = input.shape[1]
    lbl = label.to(device=input.device, dtype=torch.int64)
    x_y = torch.gather(input, 1, lbl[:, None])
    loss = (margin - x_y + input).clamp_min(0.0) ** p
    if weight is not None:
        w = torch.as_tensor(weight, device=input.device)
        loss = loss * w[lbl][:, None]
    own = torch.gather(loss, 1, lbl[:, None])
    loss = (loss.sum(1, keepdim=True) - own) / c
    return _reduce_loss(loss[:, 0], reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean"):
    input, label, weight = cast_inputs("multi_label_soft_margin_loss",
                                       input, label, weight)
    F = torch.nn.functional
    loss = -(label * F.logsigmoid(input) + (1.0 - label) * F.logsigmoid(
        -input))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss.mean(-1), reduction)


_CTC_NEG_INF = -1e30


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss with Paddle's signature (``log_probs`` ``[T, B, C]``
    unscaled logits, time-major; ``labels`` ``[B, L]``), as the JAX
    function computes it: log-softmax in fp32, then the log-domain alpha
    recursion over the blank-extended labels, one step a frame, each
    sample's alphas frozen past its input length.  The lengths stay
    device tensors, so a captured step reads each batch's own; the
    backward is autograd's through the recursion, whose gathers
    scatter-add their gradients (atomics on the card: a fixed order
    only under ``torch.use_deterministic_algorithms``).
    ``norm_by_times`` divides each loss by its input length; "mean"
    divides each by its label length before the batch mean (warpctc's
    rule), "sum" and "none" do not."""
    T, B, _ = log_probs.shape
    dev = log_probs.device
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    labels = torch.as_tensor(labels, device=dev).long()
    L = labels.shape[1]
    S = 2 * L + 1
    in_len = torch.as_tensor(input_lengths, device=dev).long()
    lb_len = torch.as_tensor(label_lengths, device=dev).long()
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    skip_ok = torch.cat([torch.zeros((B, 2), dtype=torch.bool, device=dev),
                         (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])],
                        dim=1)
    neg = torch.full((B, 2), _CTC_NEG_INF, device=dev)
    emit0 = torch.gather(lp[0], 1, ext)
    alpha = torch.cat([emit0[:, :1],
                       torch.where(lb_len > 0, emit0[:, 1],
                                   neg[:, 0])[:, None],
                       torch.full((B, S - 2), _CTC_NEG_INF, device=dev)],
                      dim=1)
    for t in range(1, T):
        prev1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg, alpha[:, :-2]], dim=1)
        prev2 = torch.where(skip_ok, prev2, neg[:, :1])
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new = merged + torch.gather(lp[t], 1, ext)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    idx_last = (2 * lb_len - 1).clamp(0, S - 1)
    idx_blank = (2 * lb_len).clamp(0, S - 1)
    a_last = torch.gather(alpha, 1, idx_last[:, None])[:, 0]
    a_blank = torch.gather(alpha, 1, idx_blank[:, None])[:, 0]
    a_last = torch.where(lb_len > 0, a_last, neg[:, 0])
    nll = -torch.logaddexp(a_last, a_blank)
    if norm_by_times:
        nll = nll / in_len.float().clamp_min(1.0)
    if reduction == "mean":
        return (nll / lb_len.float().clamp_min(1.0)).mean()
    return _reduce_loss(nll, reduction)
