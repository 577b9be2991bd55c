"""Layers of the port's training slice (counterpart of
``paddle_tpu/nn``): ``torch.nn.Module``s with Paddle's layouts and
dtype rules."""

from . import functional
from .common import Dropout, Embedding, Linear
from .norm import LayerNorm

__all__ = ["functional", "Linear", "Embedding", "Dropout", "LayerNorm"]
