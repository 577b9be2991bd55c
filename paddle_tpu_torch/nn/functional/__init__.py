"""Functional surface of the port's ``nn`` (counterpart of
``paddle_tpu/nn/functional``): re-exports of the port's ops."""

from ...ops.activation import (gelu, hardsigmoid, hardswish, relu, relu6,
                               sigmoid, silu, swish)
from ...ops.nn_ops import (
    adaptive_avg_pool2d, adaptive_max_pool2d, avg_pool2d, batch_norm,
    binary_cross_entropy, binary_cross_entropy_with_logits, channel_shuffle,
    conv2d, cosine_embedding_loss, cosine_similarity, cross_entropy,
    ctc_loss, dropout, gaussian_nll_loss, hinge_embedding_loss, huber_loss,
    interpolate, kl_div, l1_loss, linear, margin_ranking_loss, max_pool2d,
    mse_loss, multi_label_soft_margin_loss, multi_margin_loss, nll_loss,
    pairwise_distance, poisson_nll_loss, scaled_dot_product_attention,
    smooth_l1_loss, soft_margin_loss, softmax_with_cross_entropy,
    square_error_cost, triplet_margin_loss,
    triplet_margin_with_distance_loss, upsample)
from .flash_attention import flash_attention

__all__ = ["flash_attention", "conv2d", "max_pool2d", "avg_pool2d",
           "adaptive_avg_pool2d", "adaptive_max_pool2d", "batch_norm",
           "linear", "channel_shuffle", "relu", "relu6", "hardswish",
           "hardsigmoid", "swish", "sigmoid", "gelu", "silu", "interpolate",
           "upsample", "dropout", "scaled_dot_product_attention",
           "cross_entropy",
           "softmax_with_cross_entropy", "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "mse_loss",
           "square_error_cost", "l1_loss", "smooth_l1_loss", "huber_loss",
           "kl_div", "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_similarity", "cosine_embedding_loss", "pairwise_distance",
           "soft_margin_loss", "poisson_nll_loss", "gaussian_nll_loss",
           "triplet_margin_loss", "triplet_margin_with_distance_loss",
           "multi_margin_loss", "multi_label_soft_margin_loss", "ctc_loss"]
