"""Composed operators of the port (counterpart of
``paddle_tpu/ops/nn_ops.py``): the masked attention; the 1-, 2- and
3-D and transposed convolutions; the pools, their masks and unpools;
the norms; the dropouts; linear, bilinear, the rearranging and sampling
functions, fold, the resize (``interpolate``) and the losses.  None of
them was a Pallas kernel in the JAX package (XLA's convolutions and
reduce-windows, composed jnp); on the card the convolutions are
cuDNN's through ``F.convNd`` / ``F.conv_transposeNd``."""

from __future__ import annotations

import math

import torch

from ..amp.auto_cast import cast_inputs
from ..framework import random as _random
from ..framework import selected_rows as _sr


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
    """The vision ops run channel-first (NCL, NCHW, NCDHW), the layout
    every zoo model uses; a channel-last layout is refused until a
    caller needs it."""
    if data_format not in ("NCHW", "NCL", "NC", "NCDHW"):
        raise NotImplementedError(
            f"data_format={data_format!r} is not ported yet: the vision "
            "ops are channel-first only (ROADMAP queue A, item 2: "
            "channels_last)")


def ignored_by_reference(what):
    """Refuse an argument that the JAX package accepts and never reads:
    there is no behaviour to port, and following the reference would
    silently do something else than the argument asks."""
    raise NotImplementedError(
        f"{what}: the JAX package accepts this argument and ignores it, so "
        "there is nothing to port (ROADMAP C, arguments the reference "
        "ignores)")


_CONV_F = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
           3: torch.nn.functional.conv3d}
_CONV_T_F = {1: torch.nn.functional.conv_transpose1d,
             2: torch.nn.functional.conv_transpose2d,
             3: torch.nn.functional.conv_transpose3d}


def _bias_shape(bias, nd):
    return bias.reshape((1, -1) + (1,) * nd)


def _conv(op, nd, x, weight, bias, stride, padding, dilation, groups,
          data_format):
    """The body of :func:`conv1d` / :func:`conv2d` / :func:`conv3d`."""
    _nchw_only(data_format)
    x, weight, bias = cast_inputs(op, x, weight, bias)
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
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
    out = _CONV_F[nd](xc, wc, bias if fuse else None, stride, pad_arg,
                      dilation, groups)
    out = out.to(x.dtype)
    if bias is not None and not fuse:
        out = out + _bias_shape(bias, nd)
    return out


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution (counterpart of ``nn_ops.conv2d``): weight
    ``[out, in/groups, kh, kw]`` (torch's OIHW), Paddle's padding forms
    (asymmetric ones pad first), ``F.conv2d`` as the body (cuDNN on the
    card).  The output follows the activation's dtype; the bias is
    added after that cast, as in the JAX function."""
    return _conv("conv2d", 2, x, weight, bias, stride, padding, dilation,
                 groups, data_format)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    """1-D convolution over ``[N, C, L]``, weight ``[out, in/groups, k]``
    (counterpart of ``nn_ops.conv1d``), as :func:`conv2d`."""
    return _conv("conv1d", 1, x, weight, bias, stride, padding, dilation,
                 groups, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    """3-D convolution over ``[N, C, D, H, W]``, weight ``[out, in/groups,
    kd, kh, kw]`` (counterpart of ``nn_ops.conv3d``), as :func:`conv2d`;
    cuDNN's on the card."""
    return _conv("conv3d", 3, x, weight, bias, stride, padding, dilation,
                 groups, data_format)


def _transpose_opad(in_sizes, k_sizes, stride, dilation, pads, opad,
                    output_size):
    """Paddle's ``output_size`` as the output padding of each dim (it
    picks among the sizes a stride leaves open), as the JAX function
    resolves it."""
    if output_size is None:
        return opad
    sizes = ([int(s) for s in output_size]
             if isinstance(output_size, (list, tuple))
             else [int(output_size)] * len(in_sizes))
    out = []
    for i, want in enumerate(sizes):
        eff_k = (k_sizes[i] - 1) * dilation[i] + 1
        base = (in_sizes[i] - 1) * stride[i] - pads[i][0] - pads[i][1] \
            + eff_k
        extra = want - base
        if not 0 <= extra < stride[i]:
            raise ValueError(
                f"output_size[{i}]={want} invalid: must be in "
                f"[{base}, {base + stride[i] - 1}]")
        out.append(extra)
    return tuple(out)


def _conv_transpose(op, nd, x, weight, bias, stride, padding,
                    output_padding, dilation, groups, output_size):
    """The transposed convolution the JAX functions compute as an
    input-dilated convolution, with ``F.conv_transposeNd`` (weight
    ``[in, out/groups, *k]``, torch's layout too).  Symmetric padding
    goes to torch as it is; an asymmetric one, or an output padding torch
    does not take, runs unpadded and is cut (or zero-extended) after.
    The output keeps the operands' common dtype; the bias is added
    after."""
    x, weight, bias = cast_inputs(op, x, weight, bias)
    if isinstance(padding, str):
        raise NotImplementedError("str padding for conv_transpose")
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    opad = _pair(output_padding, nd)
    pads = _resolve_padding(padding, x.shape[2:], weight.shape[2:], stride,
                            dilation)
    opad = _transpose_opad(x.shape[2:], weight.shape[2:], stride, dilation,
                           pads, opad, output_size)
    ct = torch.promote_types(x.dtype, weight.dtype)
    xc, wc = x.to(ct), weight.to(ct)
    native = all(lo == hi for lo, hi in pads) and all(
        o < max(s, d) for o, s, d in zip(opad, stride, dilation))
    if native:
        out = _CONV_T_F[nd](xc, wc, None, stride,
                            tuple(lo for lo, _ in pads), opad, groups,
                            dilation)
    else:
        full = _CONV_T_F[nd](xc, wc, None, stride, 0, 0, groups, dilation)
        cut = [(-lo, o - hi) for (lo, hi), o in zip(pads, opad)]
        out = torch.nn.functional.pad(full, _torch_pad(cut))
    if bias is not None:
        out = out + _bias_shape(bias, nd)
    return out


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCHW"):
    """2-D transposed convolution (counterpart of
    ``nn_ops.conv2d_transpose``): weight ``[in, out/groups, kh, kw]``,
    ``output_padding`` or ``output_size``, groups."""
    _nchw_only(data_format)
    return _conv_transpose("conv2d_transpose", 2, x, weight, bias, stride,
                           padding, output_padding, dilation, groups,
                           output_size)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCL"):
    """1-D transposed convolution (counterpart of
    ``nn_ops.conv1d_transpose``), which the JAX package runs as
    :func:`conv2d_transpose` on a height-1 image: a list ``stride``,
    ``padding``, ``output_padding`` or ``dilation`` gives its first
    element, and the AMP rule is ``conv1d_transpose``'s on the inputs,
    then ``conv2d_transpose``'s on the image, the bias added after."""
    _nchw_only(data_format)
    x, weight, bias = cast_inputs("conv1d_transpose", x, weight, bias)

    def first(v):
        return v if isinstance(v, int) else v[0]

    osz = None
    if output_size is not None:
        osz = (1, int(first(output_size)))
    out = conv2d_transpose(x[:, :, None, :], weight[:, :, None, :], None,
                           (1, first(stride)), (0, first(padding)),
                           (0, first(output_padding)), (1, first(dilation)),
                           groups, osz)[:, :, 0, :]
    if bias is not None:
        out = out + _bias_shape(bias, 1)
    return out


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     output_size=None, data_format="NCDHW"):
    """3-D transposed convolution (counterpart of
    ``nn_ops.conv3d_transpose``): weight ``[in, out, kd, kh, kw]``;
    ``groups`` 1 only, as the JAX function takes."""
    _nchw_only(data_format)
    if groups != 1:
        raise NotImplementedError(
            "conv3d_transpose groups > 1 (the JAX function refuses it too)")
    return _conv_transpose("conv3d_transpose", 3, x, weight, bias, stride,
                           padding, output_padding, dilation, groups,
                           output_size)


def _pool_pads(x, kernel, stride, padding, ceil_mode):
    """The JAX ``_pool``'s padding: Paddle's spec, then with ``ceil_mode``
    the high side extended until the window count rounds up."""
    pads = _resolve_padding(padding, x.shape[2:], kernel, stride,
                            (1,) * len(kernel))
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


_MAX_POOL_F = {1: torch.nn.functional.max_pool1d,
               2: torch.nn.functional.max_pool2d,
               3: torch.nn.functional.max_pool3d}
_AVG_POOL_F = {2: torch.nn.functional.avg_pool2d,
               3: torch.nn.functional.avg_pool3d}


def _max_pool(x, k, s, pads, return_mask):
    """Max over windows of ``x`` padded by ``pads`` with -inf, as
    ``lax.reduce_window`` does; with ``return_mask`` also each window's
    argmax as a flat index into the unpadded spatial dims (Paddle's
    mask; the first of equal values)."""
    nd = len(k)
    native = _native_pads(pads, k)
    if native is not None:
        return _MAX_POOL_F[nd](x, k, s, native, return_indices=return_mask)
    xp = torch.nn.functional.pad(x, _torch_pad(pads), value=float("-inf"))
    if not return_mask:
        return _MAX_POOL_F[nd](xp, k, s)
    out, idx = _MAX_POOL_F[nd](xp, k, s, return_indices=True)
    # flat index in the padded dims -> flat index in the unpadded ones
    padded = xp.shape[2:]
    flat = torch.zeros_like(idx)
    rest = idx
    for axis in reversed(range(nd)):
        coord = rest % padded[axis] - pads[axis][0]
        rest = rest // padded[axis]
        flat = flat + coord * math.prod(x.shape[3 + axis:])
    return out, flat


def _sum_pool(x, k, s, pads):
    """The sum over each window of ``x`` padded by ``pads`` with 0."""
    padded = any(lo or hi for lo, hi in pads)
    xp = torch.nn.functional.pad(x, _torch_pad(pads)) if padded else x
    return _AVG_POOL_F[len(k)](xp, k, s, divisor_override=1)


def _avg_pool(x, k, s, pads, exclusive, divisor_override):
    """Average pooling over ``pads``: ``exclusive`` divides each window's
    sum by the count of real elements in it (torch's
    ``count_include_pad=False``), else by the window size;
    ``divisor_override`` divides the sum by itself.  ATen's CPU 3-D pool
    has no 16-bit form: there it sums in fp32 and rounds once, as the
    card's accumulates in fp32 and rounds once."""
    if len(k) == 3 and x.device.type == "cpu" and x.dtype in (
            torch.bfloat16, torch.float16):
        return _avg_pool(x.float(), k, s, pads, exclusive,
                         divisor_override).to(x.dtype)
    F = torch.nn.functional
    native = _native_pads(pads, k)
    if divisor_override:
        return _sum_pool(x, k, s, pads) / float(divisor_override)
    if native is not None:
        return _AVG_POOL_F[len(k)](x, k, s, native,
                                   count_include_pad=not exclusive)
    total = _sum_pool(x, k, s, pads)
    if exclusive:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        return total / _sum_pool(ones, k, s, pads)
    return total / float(math.prod(k))


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    """Max pooling as ``lax.reduce_window`` with -inf padding does it
    (counterpart of ``nn_ops.max_pool2d``): ``ceil_mode`` extends the
    high-side padding, so a last window that starts in the padding
    gives -inf where torch's pool would drop it.  Symmetric windows go
    to ``F.max_pool2d``; the rest pad with -inf first.  ``return_mask``
    also returns Paddle's mask, each window's argmax as a flat index
    into ``H * W`` (int64; not with ``ceil_mode`` or a "SAME"/"VALID"
    padding, which the JAX function refuses too)."""
    _nchw_only(data_format)
    (x,) = cast_inputs("max_pool2d", x)
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    if return_mask:
        _mask_refusals("max_pool2d", ceil_mode, padding)
    pads = _pool_pads(x, k, s, padding, ceil_mode)
    return _max_pool(x, k, s, pads, return_mask)


def _mask_refusals(op, ceil_mode, padding):
    if ceil_mode:
        raise NotImplementedError(
            f"{op}: return_mask with ceil_mode is unsupported (the JAX "
            "function refuses it too)")
    if isinstance(padding, str):
        raise NotImplementedError("return_mask with str padding")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """Average pooling (counterpart of ``nn_ops.avg_pool2d``).  Paddle's
    ``exclusive=True`` (the default) divides each window's sum by the
    count of real elements in it, torch's ``count_include_pad=False``;
    ``exclusive=False`` and unpadded windows divide by the window size;
    ``divisor_override`` divides the sum by itself.  Padding as in
    :func:`max_pool2d`, with zeros."""
    _nchw_only(data_format)
    (x,) = cast_inputs("avg_pool2d", x)
    k = _pair(kernel_size)
    s = _pair(stride if stride is not None else kernel_size)
    pads = _pool_pads(x, k, s, padding, ceil_mode)
    return _avg_pool(x, k, s, pads, exclusive, divisor_override)


def _pool1d_window(kernel_size, stride):
    k = (kernel_size,) if isinstance(kernel_size, int) else \
        tuple(kernel_size)
    s = (stride,) if isinstance(stride, int) else (
        k if stride is None else tuple(stride))
    return k[:1], s[:1]


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False):
    """Max pooling over ``[N, C, L]`` (counterpart of
    ``nn_ops.max_pool1d``): -inf padding, and with ``return_mask`` the
    argmax of each window as an index into ``L``.  The JAX function
    ignores ``ceil_mode`` without a mask and refuses it with one: both
    are refused here."""
    if ceil_mode:
        ignored_by_reference("max_pool1d(ceil_mode=True)")
    (x,) = cast_inputs("max_pool1d", x)
    k, s = _pool1d_window(kernel_size, stride)
    if return_mask:
        _mask_refusals("max_pool1d", ceil_mode, padding)
    pads = _resolve_padding(padding, x.shape[2:], k, s, (1,))
    if return_mask:
        out, mask = _max_pool(x[:, :, None, :], (1,) + k, (1,) + s,
                              [(0, 0)] + pads, True)
        return out[:, :, 0, :], mask[:, :, 0, :]
    return _max_pool(x, k, s, pads, False)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False):
    """Average pooling over ``[N, C, L]`` (counterpart of
    ``nn_ops.avg_pool1d``): ``exclusive`` counts the real elements of a
    window padded by an int or a list, and a "SAME"/"VALID" padding
    divides by the window size, as the JAX function does.  It ignores
    ``ceil_mode``, which is refused here."""
    if ceil_mode:
        ignored_by_reference("avg_pool1d(ceil_mode=True)")
    (x,) = cast_inputs("avg_pool1d", x)
    k, s = _pool1d_window(kernel_size, stride)
    pads = _resolve_padding(padding, x.shape[2:], k, s, (1,))
    excl = exclusive and not isinstance(padding, str)
    out = _avg_pool(x[:, :, None, :], (1,) + k, (1,) + s, [(0, 0)] + pads,
                    excl, None)
    return out[:, :, 0, :]


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW"):
    """Max pooling over ``[N, C, D, H, W]`` (counterpart of
    ``nn_ops.max_pool3d``), as :func:`max_pool2d`; the mask indexes
    ``D * H * W``."""
    _nchw_only(data_format)
    (x,) = cast_inputs("max_pool3d", x)
    k = _pair(kernel_size, 3)
    s = _pair(stride if stride is not None else kernel_size, 3)
    if return_mask:
        _mask_refusals("max_pool3d", ceil_mode, padding)
    pads = _pool_pads(x, k, s, padding, ceil_mode)
    return _max_pool(x, k, s, pads, return_mask)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    """Average pooling over ``[N, C, D, H, W]`` (counterpart of
    ``nn_ops.avg_pool3d``), as :func:`avg_pool2d` except that a
    "SAME"/"VALID" padding divides by the window size."""
    _nchw_only(data_format)
    (x,) = cast_inputs("avg_pool3d", x)
    k = _pair(kernel_size, 3)
    s = _pair(stride if stride is not None else kernel_size, 3)
    pads = _pool_pads(x, k, s, padding, ceil_mode)
    excl = exclusive and not isinstance(padding, str)
    return _avg_pool(x, k, s, pads, excl, divisor_override)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Mean over the windows ``[floor(i*n/o), ceil((i+1)*n/o))``, the JAX
    function's and ``F.adaptive_avg_pool2d``'s, divisible or not."""
    _nchw_only(data_format)
    (x,) = cast_inputs("adaptive_avg_pool2d", x)
    return torch.nn.functional.adaptive_avg_pool2d(x, _pair(output_size))


def adaptive_max_pool2d(x, output_size, return_mask=False):
    """Max over the windows of :func:`adaptive_avg_pool2d` (NCHW).  The
    JAX function ignores ``return_mask``, which is refused here."""
    if return_mask:
        ignored_by_reference("adaptive_max_pool2d(return_mask=True)")
    (x,) = cast_inputs("adaptive_max_pool2d", x)
    return torch.nn.functional.adaptive_max_pool2d(x, _pair(output_size))


def _first(v):
    return int(v[0] if isinstance(v, (list, tuple)) else v)


def adaptive_avg_pool1d(x, output_size):
    """Mean over the windows of :func:`adaptive_avg_pool2d` along ``L``."""
    (x,) = cast_inputs("adaptive_avg_pool1d", x)
    return torch.nn.functional.adaptive_avg_pool1d(x, _first(output_size))


def adaptive_max_pool1d(x, output_size, return_mask=False):
    """Max over the windows of :func:`adaptive_avg_pool1d`;
    ``return_mask`` is refused, as the JAX function refuses it."""
    if return_mask:
        raise NotImplementedError("adaptive_max_pool1d return_mask")
    (x,) = cast_inputs("adaptive_max_pool1d", x)
    return torch.nn.functional.adaptive_max_pool1d(x, _first(output_size))


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    """Mean over adaptive windows of ``D``, ``H`` and ``W``."""
    _nchw_only(data_format)
    (x,) = cast_inputs("adaptive_avg_pool3d", x)
    return torch.nn.functional.adaptive_avg_pool3d(x, _pair(output_size, 3))


def adaptive_max_pool3d(x, output_size, return_mask=False):
    """Max over adaptive windows of ``D``, ``H`` and ``W``;
    ``return_mask`` is refused, as the JAX function refuses it."""
    if return_mask:
        raise NotImplementedError("adaptive_max_pool3d return_mask")
    (x,) = cast_inputs("adaptive_max_pool3d", x)
    return torch.nn.functional.adaptive_max_pool3d(x, _pair(output_size, 3))


def _unpool(x, indices, kernel_size, stride, padding, output_size, nd):
    """Values of ``x`` written at their ``indices`` (flat per plane) in a
    zero output, the inverse of a max pool's mask (the JAX
    ``_unpool_scatter``).  The size is ``output_size``'s last ``nd``
    dims, else ``(in - 1) * stride - 2 * padding + kernel``.  Indices
    out of range raise, checked on the host except while a graph is
    captured."""
    k = _pair(kernel_size, nd)
    s = _pair(stride if stride is not None else kernel_size, nd)
    p = _pair(padding, nd)
    if output_size is not None:
        out_sp = tuple(int(o) for o in list(output_size)[-nd:])
    else:
        out_sp = tuple((x.shape[2 + i] - 1) * s[i] - 2 * p[i] + k[i]
                       for i in range(nd))
    n, c = x.shape[:2]
    total = math.prod(out_sp)
    idx = indices.reshape(n, c, -1).long()
    capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
    if idx.numel() and not capturing:
        lo, hi = int(idx.min()), int(idx.max())
        if hi >= total or lo < 0:
            raise ValueError(
                f"max_unpool: index range [{lo}, {hi}] is out of range for "
                f"output spatial size {out_sp} ({total} elements); check "
                "kernel/stride/padding/output_size against the pooling "
                "that produced the indices")
    out = x.new_zeros((n, c, total)).scatter(2, idx, x.reshape(n, c, -1))
    return out.reshape((n, c) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    _nchw_only(data_format)
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 1)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """Inverse of ``max_pool2d(return_mask=True)`` (counterpart of
    ``nn_ops.max_unpool2d``; ``data_format`` before ``output_size`` as
    upstream)."""
    _nchw_only(data_format)
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    _nchw_only(data_format)
    return _unpool(x, indices, kernel_size, stride, padding, output_size, 3)


def _stat(t):
    """``t`` in the norms' statistics dtype: fp32, or the input's own
    when it is wider (float64 stays float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


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
        _stat(x), running_mean, running_var,
        None if weight is None else _stat(weight),
        None if bias is None else _stat(bias), training, 1.0 - momentum,
        epsilon)
    return out.to(orig)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Normalisation over the trailing ``normalized_shape`` dims
    (counterpart of ``nn_ops.layer_norm``): statistics and the affine
    step in fp32, the output in the input's dtype."""
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    out = torch.nn.functional.layer_norm(
        _stat(x), tuple(normalized_shape),
        None if weight is None else _stat(weight),
        None if bias is None else _stat(bias), epsilon)
    return out.to(x.dtype)


def _affine(out, weight, bias):
    shape = (1, -1) + (1,) * (out.ndim - 2)
    if weight is not None:
        out = out * _stat(weight).reshape(shape)
    if bias is not None:
        out = out + _stat(bias).reshape(shape)
    return out


def rms_norm(x, weight=None, bias=None, epsilon=1e-6, begin_norm_axis=-1):
    """``x / sqrt(mean(x^2) + epsilon)`` over the dims from
    ``begin_norm_axis`` on, then ``* weight + bias`` (counterpart of
    ``nn_ops.rms_norm``): fp32 statistics, the input's dtype out."""
    x, weight, bias = cast_inputs("rms_norm", x, weight, bias)
    dims = tuple(range(begin_norm_axis % x.ndim, x.ndim))
    xf = _stat(x)
    out = xf * torch.rsqrt(xf.square().mean(dims, keepdim=True) + epsilon)
    if weight is not None:
        out = out * _stat(weight)
    if bias is not None:
        out = out + _stat(bias)
    return out.to(x.dtype)


def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    """Each sample's each channel normalised over its spatial dims, the
    biased variance (counterpart of ``nn_ops.instance_norm``), then the
    per-channel affine: fp32 statistics, the input's dtype out."""
    x, weight, bias = cast_inputs("instance_norm", x, weight, bias)
    out = torch.nn.functional.instance_norm(_stat(x), eps=epsilon)
    return _affine(out, weight, bias).to(x.dtype)


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    """Normalisation over each group of ``C / num_groups`` channels and
    the spatial dims (counterpart of ``nn_ops.group_norm``), then the
    per-channel affine: fp32 statistics, the input's dtype out."""
    _nchw_only(data_format)
    x, weight, bias = cast_inputs("group_norm", x, weight, bias)
    out = torch.nn.functional.group_norm(_stat(x), num_groups, eps=epsilon)
    return _affine(out, weight, bias).to(x.dtype)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0):
    """``x / (k + alpha * mean of x^2 over a window of size channels)^beta``
    with the window zero-padded ``(size // 2, size - size // 2 - 1)``
    (counterpart of ``nn_ops.local_response_norm``): torch's function,
    which pads and averages so, in fp32 and the input's dtype out (a
    ``[N, C]`` input as ``[N, C, 1]``)."""
    (x,) = cast_inputs("local_response_norm", x)
    xf = _stat(x)
    flat = xf.ndim == 2
    out = torch.nn.functional.local_response_norm(
        xf[..., None] if flat else xf, size, alpha, beta, k)
    return (out[..., 0] if flat else out).to(x.dtype)


# ---------------------------------------------------------------------------
# Dropout.  Each draws its keep mask from the port's generator of the
# tensor's device (which a captured step registers) and applies it with a
# plain function of the mask, so a test can hand the JAX package's mask
# to that function (the two packages draw different bits by design).
# ---------------------------------------------------------------------------
def _keep_mask(x, p, shape=None):
    shape = tuple(x.shape) if shape is None else tuple(shape)
    return torch.rand(shape, generator=_random.default_generator(x.device),
                      device=x.device) >= p


def dropout_apply(x, keep, p, mode="upscale_in_train"):
    """``x`` through the keep mask ``keep`` (broadcast to ``x``): kept
    elements scaled by ``1 / (1 - p)`` in ``upscale_in_train``, as they
    are in ``downscale_in_infer``; the rest 0."""
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros_like(x))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Paddle's dropout (counterpart of ``nn_ops.dropout``): while
    ``training``, zero each element with probability ``p``, one draw
    shared along the dims not in ``axis`` when it is given, and scale
    the rest by ``1 / (1 - p)`` (``upscale_in_train``) or leave them
    (``downscale_in_infer``); outside training ``x`` itself, scaled by
    ``1 - p`` in ``downscale_in_infer``."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = None
    if axis is not None:
        ax = [axis] if isinstance(axis, int) else list(axis)
        ax = [a % x.ndim for a in ax]
        shape = [s if i in ax else 1 for i, s in enumerate(x.shape)]
    return dropout_apply(x, _keep_mask(x, p, shape), p, mode)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels dropped: one draw for each ``(n, c)`` of
    ``[N, C, H, W]`` (``[N, H, W, C]`` with ``"NHWC"``)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Whole channels of ``[N, C, D, H, W]`` dropped, as
    :func:`dropout2d`."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout_apply(x, keep, p):
    """SELU's dropout through the keep mask ``keep``: dropped elements
    set to ``-alpha * scale``, then ``a * x + b`` with the affine that
    keeps a unit normal's mean and variance."""
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    a = ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b


def alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout (counterpart of ``nn_ops.alpha_dropout``); ``x``
    itself outside training or at ``p == 0``."""
    if not training or p == 0.0:
        return x
    return alpha_dropout_apply(x, _keep_mask(x, p), p)


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` at the ids ``x`` (counterpart of
    ``nn_ops.embedding``); 0 where the id is ``padding_idx``, so that
    row's gradient is 0.

    ``sparse=True`` makes the weight's gradient a sparse COO row
    gradient (``framework/selected_rows.py``) outside a captured step,
    as the JAX ``ops.embedding_sparse`` makes a ``SelectedRows``: every
    looked-up id is a row, the padding id's included with zero values
    (so lazy Adam still counts it as touched); torch's own
    ``padding_idx=``, which drops those rows, is not used.  Inside a
    ``Model`` step under ``prepare(jit=True)`` the gradient is dense, as
    the JAX lookup's is under a trace."""
    (weight,) = cast_inputs("embedding", weight)
    out = torch.nn.functional.embedding(
        x, weight, sparse=bool(sparse) and _sr.sparse_lookup_allowed())
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out


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


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    """``[N, C*r*r, H, W]`` to ``[N, C, H*r, W*r]`` (counterpart of
    ``nn_ops.pixel_shuffle``: torch's function does the same reshape and
    transpose; NCHW, as the JAX function computes whatever
    ``data_format`` says)."""
    if data_format != "NCHW":
        ignored_by_reference(f"pixel_shuffle(data_format={data_format!r})")
    (x,) = cast_inputs("pixel_shuffle", x)
    return torch.nn.functional.pixel_shuffle(x, upscale_factor)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    """The inverse of :func:`pixel_shuffle` (NCHW)."""
    if data_format != "NCHW":
        ignored_by_reference(
            f"pixel_unshuffle(data_format={data_format!r})")
    (x,) = cast_inputs("pixel_unshuffle", x)
    return torch.nn.functional.pixel_unshuffle(x, downscale_factor)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """TSM's shift of ``[N*T, C, H, W]`` (counterpart of
    ``nn_ops.temporal_shift``): the first ``C * shift_ratio`` channels
    one segment back, the next as many one forward, zeros shifted in."""
    _nchw_only(data_format)
    (x,) = cast_inputs("temporal_shift", x)
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([xr[:, 1:, :fold], torch.zeros_like(xr[:, :1, :fold])],
                     dim=1)
    right = torch.cat([torch.zeros_like(xr[:, :1, fold:2 * fold]),
                       xr[:, :-1, fold:2 * fold]], dim=1)
    return torch.cat([left, right, xr[:, :, 2 * fold:]], dim=2).reshape(
        nt, c, h, w)


def bilinear(x1, x2, weight, bias=None):
    """``out[b, o] = x1[b]^T W[o] x2[b] + bias`` (counterpart of
    ``nn_ops.bilinear``), weight ``[out, in1, in2]``."""
    x1, x2, weight, bias = cast_inputs("bilinear", x1, x2, weight, bias)
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im, the inverse of :func:`~.manipulation.unfold`: ``[N,
    C*kh*kw, L]`` to ``[N, C, H, W]``, overlaps summed (counterpart of
    ``nn_ops.fold``; an asymmetric padding cuts after ``F.fold``)."""
    (x,) = cast_inputs("fold", x)
    oh, ow = _pair(output_sizes)
    (ph0, ph1), (pw0, pw1) = _resolve_padding(paddings, (oh, ow), (1, 1),
                                              (1, 1))
    full = torch.nn.functional.fold(
        x, (oh + ph0 + ph1, ow + pw0 + pw1), _pair(kernel_sizes),
        dilation=_pair(dilations), stride=_pair(strides))
    return full[:, :, ph0:ph0 + oh, pw0:pw0 + ow]


def affine_grid(theta, out_shape, align_corners=True):
    """The sampling grid ``[N, H, W, 2]`` of the affine maps ``theta``
    ``[N, 2, 3]`` over normalised ``[-1, 1]`` coordinates (counterpart of
    ``nn_ops.affine_grid``), in fp32 and ``theta``'s dtype out."""
    (theta,) = cast_inputs("affine_grid", theta)
    n, c, h, w = (int(v) for v in out_shape)
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) + 0.5) * 2.0 / h - 1.0
        xs = (torch.arange(w, device=dev) + 0.5) * 2.0 / w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    grid = torch.einsum("hwk,nik->nhwi", base, theta.float())
    return grid.to(theta.dtype)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """``x`` ``[N, C, H, W]`` sampled at ``grid`` ``[N, Hg, Wg, 2]`` (x, y
    in ``[-1, 1]``), bilinear or nearest, with zero, border or
    reflection padding (counterpart of ``nn_ops.grid_sample``, whose
    corners, weights and padding rules are torch's): torch's function in
    fp32, the input's dtype out."""
    x, grid = cast_inputs("grid_sample", x, grid)
    out = torch.nn.functional.grid_sample(
        _stat(x), grid.to(_stat(x).dtype), mode=mode,
        padding_mode=padding_mode, align_corners=align_corners)
    return out.to(x.dtype)


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


def check_alignment(mode, align_corners, align_mode=0):
    """Refuse ``align_corners=True``, and ``align_mode=1`` in a linear
    mode: the JAX resize reads neither and always computes half-pixel
    centres, so the port has no behaviour to give them."""
    if align_corners:
        ignored_by_reference("interpolate(align_corners=True)")
    if align_mode != 0 and mode in ("linear", "bilinear", "trilinear"):
        ignored_by_reference(f"interpolate(mode={mode!r}, "
                             f"align_mode={align_mode!r})")


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW"):
    """Resize the two spatial axes of ``x`` (NCHW or NHWC) to ``size``,
    or to ``int(side * scale_factor)``, computing what the JAX function
    computes: ``jax.image.resize`` with ``mode`` "nearest", "bilinear"
    (also "linear", "area") or "bicubic", half-pixel centres, and
    anti-aliasing when an axis shrinks (the kernel widened by the
    scale; ``F.interpolate(antialias=False)`` differs there).  The JAX
    function ignores ``align_corners`` and ``align_mode``; the port
    refuses the values that would ask for something else
    (:func:`check_alignment`).  An axis whose size does not change is
    left as it is; the output has ``x``'s dtype (the weights are cast
    to it first, as JAX casts them)."""
    check_alignment(mode, align_corners, align_mode)
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
    if label.dtype == torch.bool:
        # numpy arithmetic on a bool label, as jnp does it
        label = label.to(input.dtype)
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
