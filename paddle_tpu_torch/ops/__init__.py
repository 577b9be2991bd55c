"""Operators of the port whose TPU form was a Pallas kernel."""

from .flash_attention_kernel import (FlashAttnFunc, flash_attention_reference,
                                     flash_bwd_dkv, flash_bwd_dq,
                                     flash_bwd_fused, flash_fwd,
                                     flash_fwd_hpack)
from .lmce_kernel import (FusedLinearCrossEntropy, fused_linear_cross_entropy,
                          lmce_bwd_dh, lmce_bwd_dw, lmce_fwd, lmce_reference)

__all__ = ["FlashAttnFunc", "flash_attention_reference", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_hpack",
           "flash_bwd_fused", "FusedLinearCrossEntropy",
           "fused_linear_cross_entropy", "lmce_reference", "lmce_fwd",
           "lmce_bwd_dh", "lmce_bwd_dw"]
