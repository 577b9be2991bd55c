"""Mixed precision of the port (counterpart of ``paddle_tpu/amp``):
``auto_cast`` (O1/O2, read by the port's own ops), ``decorate``,
``GradScaler`` (dynamic loss scaling for fp16; bf16 needs none) and
``debugging``."""

from . import debugging
from .auto_cast import amp_state, auto_cast, black_list, white_list
from .decorate import decorate
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_state", "decorate", "white_list",
           "black_list", "GradScaler", "AmpScaler", "debugging"]
