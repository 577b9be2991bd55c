"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``):
the schedulers under ``lr``, the update rules, ``LBFGS`` and the
historical ``L1Decay``/``L2Decay`` aliases of ``regularizer``."""

from . import lr
from ..regularizer import L1Decay, L2Decay
from .lbfgs import LBFGS
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Momentum, Optimizer, RMSProp)

__all__ = ["lr", "Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad",
           "RMSProp", "Lamb", "Adadelta", "Adamax", "LBFGS", "L1Decay",
           "L2Decay"]
