"""Layers of the port (counterpart of ``paddle_tpu/nn``): every layer is
an :class:`~paddle_tpu_torch.nn.layer.Layer`, a ``torch.nn.Module`` with
Paddle's API, layouts and dtype rules."""

from . import functional, functional_call, initializer, utils
from .activation_layers import (CELU, ELU, GELU, GLU, SELU, Hardshrink,
                                Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                                LogSigmoid, LogSoftmax, Maxout, Mish, PReLU,
                                ReLU, ReLU6, RReLU, Sigmoid, Silu, Softmax,
                                Softmax2D, Softplus, Softshrink, Softsign,
                                Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .clip_grad import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .common import (AlphaDropout, Bilinear, ChannelShuffle,
                     CosineSimilarity, Dropout, Dropout2D, Dropout3D,
                     Embedding, Flatten, Fold, Identity, Linear, Pad1D, Pad2D,
                     Pad3D, PixelShuffle, PixelUnshuffle, Unflatten, Unfold,
                     Upsample, UpsamplingBilinear2D, UpsamplingNearest2D,
                     ZeroPad2D)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .layer import Layer, LazyGuard
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, CTCLoss, GaussianNLLLoss,
                   HingeEmbeddingLoss, HuberLoss, KLDivLoss, L1Loss,
                   MarginRankingLoss, MSELoss, MultiLabelSoftMarginLoss,
                   NLLLoss, PairwiseDistance, PoissonNLLLoss, SmoothL1Loss,
                   SoftMarginLoss, TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   LayerNorm, LocalResponseNorm, RMSNorm, SpectralNorm,
                   SyncBatchNorm)
from .param_attr import Parameter, ParamAttr
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D, AdaptiveMaxPool2D,
                      AdaptiveMaxPool3D, AvgPool1D, AvgPool2D, AvgPool3D,
                      MaxPool1D, MaxPool2D, MaxPool3D, MaxUnPool1D,
                      MaxUnPool2D, MaxUnPool3D)
from .rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = [
    "functional", "functional_call", "initializer", "utils", "Layer",
    "LazyGuard", "ParamAttr", "Parameter", "ClipGradByValue",
    "ClipGradByNorm", "ClipGradByGlobalNorm",
    # common
    "Linear", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
    "Embedding", "Flatten", "Identity", "Pad1D", "Pad2D", "Pad3D",
    "ZeroPad2D", "Upsample", "UpsamplingBilinear2D", "UpsamplingNearest2D",
    "PixelShuffle", "PixelUnshuffle", "ChannelShuffle", "Unflatten", "Fold",
    "Unfold", "CosineSimilarity", "Bilinear",
    # conv, pooling, norm
    "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
    "Conv3DTranspose", "MaxPool2D", "AvgPool2D", "MaxPool1D", "AvgPool1D",
    "AdaptiveAvgPool2D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "AdaptiveMaxPool2D", "AdaptiveAvgPool1D", "MaxPool3D", "AvgPool3D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool3D",
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
    "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm", "InstanceNorm1D",
    "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
    # activations
    "ReLU", "ReLU6", "LeakyReLU", "ELU", "SELU", "CELU", "GELU", "Silu",
    "Swish", "Hardswish", "Sigmoid", "LogSigmoid", "Hardsigmoid",
    "Hardtanh", "Tanh", "Tanhshrink", "Softplus", "Softsign", "Softshrink",
    "Hardshrink", "Mish", "ThresholdedReLU", "Maxout", "GLU", "Softmax",
    "LogSoftmax", "PReLU", "Softmax2D", "RReLU",
    # containers, losses, rnn, transformer
    "Sequential", "LayerList", "ParameterList", "LayerDict",
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss", "MarginRankingLoss",
    "CosineEmbeddingLoss", "HuberLoss", "SoftMarginLoss",
    "HingeEmbeddingLoss", "PoissonNLLLoss", "GaussianNLLLoss",
    "TripletMarginLoss", "MultiLabelSoftMarginLoss", "CTCLoss",
    "PairwiseDistance", "RNNCellBase", "SimpleRNNCell", "LSTMCell",
    "GRUCell", "RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU",
    "MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
    "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]
