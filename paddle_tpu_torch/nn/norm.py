"""LayerNorm (counterpart of ``paddle_tpu/nn/norm.py`` and
``paddle_tpu/ops/nn_ops.py::layer_norm``)."""

from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device


class LayerNorm(nn.Module):
    """Normalisation over the trailing ``normalized_shape`` dims with the
    JAX package's mixed-precision contract: statistics and the affine
    step in fp32, the output in the input's dtype.  Under AMP O2 the
    norm's weight and bias stay fp32 while the activations are bf16, so
    a bf16 activation leaves the norm as bf16 and the next matmul stays
    in bf16.  ``device=None`` means the card; pass ``device="cpu"`` for
    the CPU."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None):
        super().__init__()
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device))

    def forward(self, x):
        out = torch.nn.functional.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.epsilon)
        return out.to(x.dtype)
