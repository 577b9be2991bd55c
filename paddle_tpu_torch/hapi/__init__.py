"""High-level training API of the port (counterpart of
``paddle_tpu/hapi``)."""

from . import callbacks
from .model import Model
from .summary import flops, summary

__all__ = ["Model", "callbacks", "summary", "flops"]
