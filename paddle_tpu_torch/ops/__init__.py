"""Operators of the port whose TPU form was a Pallas kernel."""

from .flash_attention_kernel import (FlashAttnFunc, flash_attention_reference,
                                     flash_bwd_dkv, flash_bwd_dq, flash_fwd)

__all__ = ["FlashAttnFunc", "flash_attention_reference", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv"]
