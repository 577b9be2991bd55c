"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer``,
upstream ``python/paddle/regularizer.py``).  A regularizer is passed
either globally
(``optimizer.Momentum(..., weight_decay=L2Decay(1e-4))``) or per
parameter (``ParamAttr(regularizer=L1Decay(1e-5))``); a per-parameter
regularizer overrides the optimizer-level one (upstream precedence).

Semantics, matching upstream's grad-augmentation formulation:
- ``L2Decay(c)``: adds ``c * w`` to the gradient (coupled decay; for
  AdamW the decoupled ``weight_decay`` float is the separate,
  upstream-consistent path).
- ``L1Decay(c)``: adds ``c * sign(w)`` to the gradient.

The optimizers read them through ``_param_decay`` (the L2 coefficient)
and ``_param_l1`` (the L1 coefficient), in the eager step and in the
captured one alike (``optimizer/optimizer.py``).
"""

from __future__ import annotations

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    """Base class (upstream paddle.regularizer.WeightDecayRegularizer)."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L2Decay(WeightDecayRegularizer):
    """Adds ``coeff * param`` to the gradient."""


class L1Decay(WeightDecayRegularizer):
    """Adds ``coeff * sign(param)`` to the gradient (lasso)."""
