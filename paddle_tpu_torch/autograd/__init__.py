"""User-facing autograd of the port (counterpart of
``paddle_tpu/autograd``): torch.autograd under Paddle's API."""

from .functional import Hessian, Jacobian, hessian, jacobian, jvp, vjp
from .py_layer import PyLayer, PyLayerContext
from .tape import (backward, enable_grad, grad, is_grad_enabled, no_grad,
                   set_grad_enabled)

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "PyLayer", "PyLayerContext", "jvp", "vjp",
           "jacobian", "hessian", "Jacobian", "Hessian"]
