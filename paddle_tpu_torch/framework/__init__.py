"""Framework helpers of the port: lazy host views and random state."""

from .lazy import LazyScalar, LazyStack
from .random import default_generator, seed

__all__ = ["LazyScalar", "LazyStack", "seed", "default_generator"]
