"""Vision of the port (counterpart of ``paddle_tpu/vision``): the model
zoo (``vision.models``), the datasets (``vision.datasets``) and the
detection operators (``vision.ops``)."""

from . import datasets, models, ops

__all__ = ["datasets", "models", "ops"]
