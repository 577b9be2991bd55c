"""``nn.utils`` (counterpart of ``paddle_tpu/nn/utils``):
``weight_norm`` and ``spectral_norm`` go with the rest of ``nn``
(ROADMAP queue A, item 8, the nn half)."""

from . import utils  # noqa: F401
from .utils import (clip_grad_norm_, clip_grad_value_,  # noqa: F401
                    parameters_to_vector, vector_to_parameters)

__all__ = ["parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_"]
