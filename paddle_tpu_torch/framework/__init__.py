"""Framework helpers of the port: lazy host views, random state and the
environment-knob registry."""

from . import env_knobs
from .lazy import LazyScalar, LazyStack
from .random import default_generator, seed

__all__ = ["LazyScalar", "LazyStack", "seed", "default_generator",
           "env_knobs"]
