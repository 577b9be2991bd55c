"""Functional surface of the port's ``nn`` (counterpart of
``paddle_tpu/nn/functional``): re-exports of the port's ops, which take
torch tensors or Paddle ``Tensor`` s and give back the same kind.
``ring_flash_attention`` and ``ulysses_attention`` are the
context-parallel attention over the sep group
(``distributed/fleet/meta_parallel/context_parallel.py``)."""

import torch

from ...ops.activation import (celu, elu, gelu, glu, gumbel_softmax,
                               hardshrink, hardsigmoid, hardswish, hardtanh,
                               leaky_relu, log_sigmoid, log_softmax, maxout,
                               mish, prelu, relu, relu6, rrelu, selu, sigmoid,
                               silu, softmax, softplus, softshrink, softsign,
                               swish, tanh, tanhshrink, thresholded_relu)
from ...ops.manipulation import one_hot, pad, unfold
from ...ops.nn_ops import (
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
    affine_grid, alpha_dropout, avg_pool1d, avg_pool2d, avg_pool3d,
    batch_norm, bilinear, binary_cross_entropy,
    binary_cross_entropy_with_logits, channel_shuffle, conv1d,
    conv1d_transpose, conv2d, conv2d_transpose, conv3d, conv3d_transpose,
    cosine_embedding_loss, cosine_similarity, cross_entropy, ctc_loss,
    dropout, dropout2d, dropout3d, embedding, fold, gaussian_nll_loss,
    grid_sample, group_norm, hinge_embedding_loss, huber_loss, instance_norm,
    interpolate, kl_div, l1_loss, layer_norm, linear, local_response_norm,
    margin_ranking_loss, max_pool1d, max_pool2d, max_pool3d, max_unpool1d,
    max_unpool2d, max_unpool3d, mse_loss, multi_label_soft_margin_loss,
    multi_margin_loss, nll_loss, pairwise_distance, pixel_shuffle,
    pixel_unshuffle, poisson_nll_loss, rms_norm,
    scaled_dot_product_attention, smooth_l1_loss, soft_margin_loss,
    softmax_with_cross_entropy, square_error_cost, temporal_shift,
    triplet_margin_loss, triplet_margin_with_distance_loss, upsample)
from .flash_attention import flash_attention


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    norm = torch.linalg.vector_norm(x, ord=float(p), dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=epsilon)


def ring_flash_attention(query, key, value, causal=False, seq_axis="sep",
                         mesh=None, balanced=False):
    """Ring attention over the sep group on this rank's sequence slices;
    plain attention at sep 1."""
    from ...distributed.fleet.meta_parallel import context_parallel as cp
    return cp.ring_flash_attention.raw(query, key, value, causal, seq_axis,
                                       mesh, balanced)


def ulysses_attention(query, key, value, causal=False, seq_axis="sep",
                      mesh=None):
    """Ulysses (sequence-to-head all-to-all) attention over the sep
    group; plain attention at sep 1."""
    from ...distributed.fleet.meta_parallel import context_parallel as cp
    return cp.ulysses_attention.raw(query, key, value, causal, seq_axis,
                                    mesh)


def sequence_mask(x, maxlen=None, dtype="int64"):
    """``[..., maxlen]`` of ``position < length`` for the lengths ``x``;
    ``maxlen`` None reads the longest on the host."""
    from ..layer import to_torch_dtype
    if maxlen is None:
        maxlen = int(x.max())
    mask = torch.arange(maxlen, device=x.device) < x.unsqueeze(-1)
    return mask.to(to_torch_dtype(dtype))


__all__ = [
    "flash_attention", "ring_flash_attention", "ulysses_attention",
    "normalize", "sequence_mask",
    # activations
    "relu", "relu6", "leaky_relu", "prelu", "rrelu", "elu", "selu", "celu",
    "gelu", "silu", "swish", "hardswish", "sigmoid", "log_sigmoid",
    "hardsigmoid", "hardtanh", "tanhshrink", "softplus", "softsign",
    "softshrink", "hardshrink", "mish", "tanh", "softmax", "log_softmax",
    "gumbel_softmax", "glu", "maxout", "thresholded_relu",
    # conv, pool, norm, dropout
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "max_pool1d", "max_pool2d", "max_pool3d",
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
    "adaptive_avg_pool2d", "adaptive_avg_pool3d", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "adaptive_max_pool3d", "max_unpool1d",
    "max_unpool2d", "max_unpool3d", "batch_norm", "layer_norm", "rms_norm",
    "instance_norm", "group_norm", "local_response_norm", "dropout",
    "dropout2d", "dropout3d", "alpha_dropout",
    # the rest
    "embedding", "linear", "bilinear", "pad", "unfold", "fold", "one_hot",
    "interpolate", "upsample", "pixel_shuffle", "pixel_unshuffle",
    "channel_shuffle", "temporal_shift", "affine_grid", "grid_sample",
    "scaled_dot_product_attention", "cosine_similarity",
    # losses
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "mse_loss",
    "square_error_cost", "l1_loss", "smooth_l1_loss", "huber_loss", "kl_div",
    "margin_ranking_loss", "hinge_embedding_loss", "cosine_embedding_loss",
    "pairwise_distance", "soft_margin_loss", "poisson_nll_loss",
    "gaussian_nll_loss", "triplet_margin_loss",
    "triplet_margin_with_distance_loss", "multi_margin_loss",
    "multi_label_soft_margin_loss", "ctc_loss"]

# Paddle Tensors in, Paddle Tensors out; torch tensors in, torch tensors
# out (ops/_primitive.py::boundary)
from ...ops._primitive import boundary as _boundary  # noqa: E402

globals().update({_n: _boundary(globals()[_n]) for _n in __all__})
