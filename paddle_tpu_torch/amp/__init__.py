"""Mixed precision of the port (counterpart of ``paddle_tpu/amp``):
``decorate`` only so far; ``auto_cast`` and ``GradScaler`` are ROADMAP
queue A, item 8.  bf16 needs no loss scaling."""

from .decorate import decorate

__all__ = ["decorate"]
