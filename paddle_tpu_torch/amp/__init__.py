"""Mixed precision of the port (counterpart of ``paddle_tpu/amp``):
``auto_cast`` (O1/O2, read by the port's own ops) and ``decorate``;
``GradScaler`` is ROADMAP queue A, item 8.  bf16 needs no loss
scaling."""

from .auto_cast import amp_state, auto_cast, black_list, white_list
from .decorate import decorate

__all__ = ["auto_cast", "amp_state", "decorate", "white_list",
           "black_list"]
