"""``nn.utils`` (counterpart of ``paddle_tpu/nn/utils``): parameter and
gradient helpers, and the ``weight_norm`` / ``spectral_norm``
reparametrisations."""

from . import utils  # noqa: F401
from .utils import (clip_grad_norm_, clip_grad_value_,  # noqa: F401
                    parameters_to_vector, remove_weight_norm, spectral_norm,
                    vector_to_parameters, weight_norm)

__all__ = ["parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_", "weight_norm",
           "remove_weight_norm", "spectral_norm"]
