"""Layers of the port (counterpart of ``paddle_tpu/nn``):
``torch.nn.Module``s with Paddle's layouts and dtype rules."""

from . import functional, initializer, utils
from .activation_layers import (GELU, Hardsigmoid, Hardswish, ReLU, ReLU6,
                                Sigmoid, Silu, Swish)
from .clip_grad import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .common import Dropout, Embedding, Identity, Linear
from .container import LayerList, Sequential
from .conv import Conv2D
from .loss import CrossEntropyLoss
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, LayerNorm
from .param_attr import Parameter, ParamAttr
from .pooling import (AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool2D,
                      MaxPool2D)

__all__ = ["functional", "initializer", "utils", "ParamAttr", "Parameter",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "Linear", "Embedding", "Dropout",
           "Identity", "LayerNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "Conv2D", "MaxPool2D", "AvgPool2D",
           "AdaptiveAvgPool2D", "AdaptiveMaxPool2D", "ReLU", "ReLU6",
           "Hardswish", "Hardsigmoid", "Swish", "Sigmoid", "GELU", "Silu",
           "Sequential", "LayerList", "CrossEntropyLoss"]
