"""Cross-entropy of the GPT criterion (counterpart of
``ParallelCrossEntropy`` in ``paddle_tpu/distributed/fleet/meta_parallel/
mp_layers.py`` and the hard-label branch of ``paddle_tpu/ops/nn_ops.py::
cross_entropy``)."""

from __future__ import annotations

import torch


def cross_entropy(logits, label, ignore_index=-100, reduction="none"):
    """Softmax cross-entropy over the last axis with integer labels:
    ``lse(logits) - logits[label]`` in fp32 whatever the logits' dtype,
    0 where ``label == ignore_index``.  ``reduction`` "none" returns the
    per-token fp32 loss, "mean" divides the sum by the count of kept
    tokens and "sum" sums it.  The gradient reaches the logits in their
    own dtype."""
    n = logits.shape[-1]
    lbl = label.to(device=logits.device, dtype=torch.int64)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, lbl.clamp(0, n - 1).unsqueeze(-1))[..., 0]
    valid = (lbl != ignore_index).to(torch.float32)
    loss = (lse - picked) * valid
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1e-12)
    raise ValueError(f"unknown reduction {reduction!r}")
