"""Mixed precision of the port (counterpart of ``paddle_tpu/amp``):
``auto_cast`` (O1/O2, read by the port's own ops), ``decorate``,
``GradScaler`` (dynamic loss scaling for fp16; bf16 needs none) and
``debugging``."""

from . import debugging
from .auto_cast import (amp_guard, amp_state, auto_cast, autocast,
                        black_list, white_list)
from .decorate import amp_decorate, decorate
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "autocast", "amp_guard", "amp_state", "decorate",
           "amp_decorate", "white_list", "black_list", "GradScaler",
           "AmpScaler", "debugging"]
