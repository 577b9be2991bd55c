"""High-level training API of the port (counterpart of
``paddle_tpu/hapi``)."""

from . import callbacks
from .model import Model

__all__ = ["Model", "callbacks"]
