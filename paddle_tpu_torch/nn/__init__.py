"""Layers of the port (counterpart of ``paddle_tpu/nn``): every layer is
an :class:`~paddle_tpu_torch.nn.layer.Layer`, a ``torch.nn.Module`` with
Paddle's API, layouts and dtype rules."""

from . import functional, functional_call, initializer, utils
from .activation_layers import (GELU, Hardsigmoid, Hardswish, ReLU, ReLU6,
                                Sigmoid, Silu, Swish)
from .clip_grad import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .common import Dropout, Embedding, Identity, Linear
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import Conv2D
from .layer import Layer, LazyGuard
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, CTCLoss, GaussianNLLLoss,
                   HingeEmbeddingLoss, HuberLoss, KLDivLoss, L1Loss,
                   MarginRankingLoss, MSELoss, MultiLabelSoftMarginLoss,
                   NLLLoss, PairwiseDistance, PoissonNLLLoss, SmoothL1Loss,
                   SoftMarginLoss, TripletMarginLoss)
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, LayerNorm
from .param_attr import Parameter, ParamAttr
from .pooling import (AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool2D,
                      MaxPool2D)
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "functional_call", "initializer", "utils",
           "Layer", "LazyGuard", "ParamAttr", "Parameter",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "Linear", "Embedding", "Dropout", "Identity", "LayerNorm",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "Conv2D", "MaxPool2D",
           "AvgPool2D", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D", "ReLU",
           "ReLU6", "Hardswish", "Hardsigmoid", "Swish", "Sigmoid", "GELU",
           "Silu", "Sequential", "LayerList", "ParameterList", "LayerDict",
           "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss",
           "MarginRankingLoss", "CosineEmbeddingLoss", "HuberLoss",
           "SoftMarginLoss", "HingeEmbeddingLoss", "PoissonNLLLoss",
           "GaussianNLLLoss", "TripletMarginLoss",
           "MultiLabelSoftMarginLoss", "CTCLoss", "PairwiseDistance",
           "RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]
