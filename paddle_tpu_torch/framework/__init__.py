"""Framework helpers of the port (lazy host views only so far)."""

from .lazy import LazyScalar, LazyStack

__all__ = ["LazyScalar", "LazyStack"]
