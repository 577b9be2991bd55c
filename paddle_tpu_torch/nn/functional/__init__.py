"""Functional surface of the port's ``nn`` (the training slice's
functions)."""

from .flash_attention import flash_attention
from .loss import cross_entropy

__all__ = ["flash_attention", "cross_entropy"]
