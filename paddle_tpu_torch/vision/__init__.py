"""Vision of the port (counterpart of ``paddle_tpu/vision``): the model
zoo's CNN families (``vision.models``)."""

from . import models

__all__ = ["models"]
