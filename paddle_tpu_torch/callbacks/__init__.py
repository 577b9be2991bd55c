"""``paddle.callbacks``: the top-level name of the ``hapi`` callback
family (counterpart of ``paddle_tpu/callbacks/__init__.py``; upstream
``python/paddle/callbacks.py`` re-exports ``paddle.hapi.callbacks``)."""

from ..hapi.callbacks import (Callback, CallbackList, EarlyStopping,
                              LRScheduler, LRSchedulerCallback,
                              ModelCheckpoint, ProgBarLogger, VisualDL,
                              config_callbacks)

__all__ = ["Callback", "CallbackList", "EarlyStopping", "LRScheduler",
           "LRSchedulerCallback", "ModelCheckpoint", "ProgBarLogger",
           "VisualDL", "config_callbacks"]
