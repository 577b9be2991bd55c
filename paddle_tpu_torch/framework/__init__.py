"""Framework helpers of the port: lazy host views, random state, the
environment-knob registry and ``SelectedRows``."""

from . import env_knobs
from .lazy import LazyScalar, LazyStack
from .random import default_generator, seed
from .selected_rows import SelectedRows

__all__ = ["LazyScalar", "LazyStack", "seed", "default_generator",
           "env_knobs", "SelectedRows"]
