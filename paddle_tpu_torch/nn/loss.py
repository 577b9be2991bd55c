"""Loss layers (counterpart of ``paddle_tpu/nn/loss.py``): the 18 losses
and ``PairwiseDistance``, each a :class:`~paddle_tpu_torch.nn.layer.
Layer` over its function in ``ops/nn_ops.py``."""

from __future__ import annotations

from ..ops import nn_ops
from .layer import Layer


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return nn_ops.cross_entropy(
            input, label, weight=self.weight,
            ignore_index=self.ignore_index, reduction=self.reduction,
            soft_label=self.soft_label, axis=self.axis,
            use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return nn_ops.mse_loss(input, label, reduction=self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return nn_ops.l1_loss(input, label, reduction=self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return nn_ops.nll_loss(input, label, weight=self.weight,
                            ignore_index=self.ignore_index,
                            reduction=self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return nn_ops.binary_cross_entropy(input, label, weight=self.weight,
                                        reduction=self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return nn_ops.binary_cross_entropy_with_logits(
            logit, label, weight=self.weight, reduction=self.reduction,
            pos_weight=self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return nn_ops.smooth_l1_loss(input, label, reduction=self.reduction,
                                  delta=self.delta)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return nn_ops.kl_div(input, label, reduction=self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return nn_ops.margin_ranking_loss(input, other, label,
                                       margin=self.margin,
                                       reduction=self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return nn_ops.cosine_embedding_loss(input1, input2, label,
                                         margin=self.margin,
                                         reduction=self.reduction)


class HuberLoss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return nn_ops.huber_loss(input, label, delta=self.delta,
                              reduction=self.reduction)


class SoftMarginLoss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return nn_ops.soft_margin_loss(input, label,
                                    reduction=self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):
        return nn_ops.hinge_embedding_loss(input, label,
                                        margin=self.margin,
                                        reduction=self.reduction)


class PoissonNLLLoss(Layer):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self.log_input = log_input
        self.full = full
        self.epsilon = epsilon
        self.reduction = reduction

    def forward(self, input, label):
        return nn_ops.poisson_nll_loss(
            input, label, log_input=self.log_input, full=self.full,
            epsilon=self.epsilon, reduction=self.reduction)


class GaussianNLLLoss(Layer):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self.full = full
        self.epsilon = epsilon
        self.reduction = reduction

    def forward(self, input, label, variance):
        return nn_ops.gaussian_nll_loss(
            input, label, variance, full=self.full,
            epsilon=self.epsilon, reduction=self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.p = p
        self.epsilon = epsilon
        self.swap = swap
        self.reduction = reduction

    def forward(self, input, positive, negative):
        return nn_ops.triplet_margin_loss(
            input, positive, negative, margin=self.margin, p=self.p,
            epsilon=self.epsilon, swap=self.swap,
            reduction=self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return nn_ops.multi_label_soft_margin_loss(
            input, label, weight=self.weight, reduction=self.reduction)


class CTCLoss(Layer):
    """CTC loss (upstream's warpctc wrapper): the alpha recursion of
    ``ops/nn_ops.py::ctc_loss``, lengths kept on the device."""

    def __init__(self, blank=0, reduction="mean", name=None):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return nn_ops.ctc_loss(log_probs, labels, input_lengths,
                            label_lengths, blank=self.blank,
                            reduction=self.reduction,
                            norm_by_times=norm_by_times)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return nn_ops.pairwise_distance(x, y, p=self.p,
                                     epsilon=self.epsilon,
                                     keepdim=self.keepdim)
