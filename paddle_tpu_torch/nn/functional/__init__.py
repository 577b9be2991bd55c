"""Functional surface of the port's ``nn`` (counterpart of
``paddle_tpu/nn/functional``): re-exports of the port's ops."""

from ...ops.activation import (gelu, hardsigmoid, hardswish, relu, relu6,
                               sigmoid, silu, swish)
from ...ops.nn_ops import (adaptive_avg_pool2d, adaptive_max_pool2d,
                           avg_pool2d, batch_norm, channel_shuffle, conv2d,
                           interpolate, linear, max_pool2d, upsample)
from .flash_attention import flash_attention
from .loss import cross_entropy

__all__ = ["flash_attention", "cross_entropy", "conv2d", "max_pool2d",
           "avg_pool2d", "adaptive_avg_pool2d", "adaptive_max_pool2d",
           "batch_norm", "linear", "channel_shuffle", "relu", "relu6",
           "hardswish", "hardsigmoid", "swish", "sigmoid", "gelu", "silu",
           "interpolate", "upsample"]
