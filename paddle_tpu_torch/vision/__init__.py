"""Vision of the port (counterpart of ``paddle_tpu/vision``): the model
zoo (``vision.models``) and the detection operators (``vision.ops``)."""

from . import models, ops

__all__ = ["models", "ops"]
