"""Loss layers (counterpart of ``paddle_tpu/nn/loss.py``)."""

from __future__ import annotations

from torch import nn

from .functional.loss import cross_entropy


class CrossEntropyLoss(nn.Module):
    """Softmax cross-entropy with hard labels ``[N]`` or ``[N, 1]`` over
    the last axis, in fp32 whatever the logits' dtype, 0 where the label
    is ``ignore_index``; ``reduction`` "mean" (over the kept labels),
    "sum" or "none".  ``weight=``, ``soft_label``, ``label_smoothing``,
    ``use_softmax=False`` and another ``axis`` are refused."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        if weight is not None or soft_label or label_smoothing or \
                not use_softmax or axis != -1:
            raise NotImplementedError(
                "CrossEntropyLoss(weight=, soft_label, label_smoothing, "
                "use_softmax=False, axis != -1) is not ported yet (ROADMAP "
                "queue A, item 8: nn/loss.py)")
        if reduction not in ("mean", "sum", "none"):
            raise ValueError(f"unknown reduction {reduction!r}")
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        if label.is_floating_point():
            raise NotImplementedError(
                "soft (floating) labels are not ported yet (ROADMAP queue "
                "A, item 8: nn/loss.py)")
        if label.ndim == input.ndim and label.shape[-1] == 1:
            label = label.squeeze(-1)
        return cross_entropy(input, label, self.ignore_index,
                             self.reduction)
