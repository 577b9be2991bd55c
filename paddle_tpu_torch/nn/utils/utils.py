"""Parameter and gradient utilities (counterpart of
``paddle_tpu/nn/utils/utils.py``, upstream ``python/paddle/nn/utils``).

Eager helpers for custom training loops.  ``clip_grad_norm_`` returns
the total norm as a 0-d device tensor and reads it on the host only
with ``error_if_nonfinite``."""

from __future__ import annotations

import torch

_aten = torch.ops.aten


def _params(parameters):
    if isinstance(parameters, torch.Tensor):
        return [parameters]
    return list(parameters)     # any iterable, a generator included


def parameters_to_vector(parameters, name=None) -> torch.Tensor:
    """The values of ``parameters`` flattened into one vector (no
    gradient flows through it)."""
    return torch.cat([p.detach().reshape(-1) for p in _params(parameters)])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None) -> None:
    """Copy consecutive slices of ``vec`` into ``parameters`` in place,
    each cast to the parameter's dtype."""
    offset = 0
    for p in _params(parameters):
        n = p.numel()
        p.copy_(vec[offset:offset + n].reshape(p.shape).to(p.dtype))
        offset += n


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False) -> torch.Tensor:
    """Scale every ``p.grad`` by ``min(max_norm / max(total, 1e-6), 1)``,
    ``total`` the ``norm_type`` norm over all of them in fp32 (the
    largest |g| for ``inf``); each gradient is multiplied in fp32 and
    rounded back to its dtype.  Returns ``total``."""
    parameters = _params(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    device = grads[0].device
    if norm_type == float("inf"):
        total = torch.stack([g.detach().abs().max().float().to(device)
                             for g in grads]).max()
    else:
        norms = torch._foreach_norm(grads, float(norm_type),
                                    dtype=torch.float32)
        total = torch.stack([n.to(device) for n in norms]).pow(
            norm_type).sum().pow(1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(
            "clip_grad_norm_: total norm is non-finite; set "
            "error_if_nonfinite=False to skip this check")
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    for p in parameters:
        if p.grad is not None:
            p.grad = (p.grad.float() * scale).to(p.grad.dtype)
    return total


def clip_grad_value_(parameters, clip_value) -> None:
    """Clamp every ``p.grad`` into ``[-clip_value, clip_value]``."""
    cv = float(clip_value)
    for p in _params(parameters):
        if p.grad is not None:
            p.grad = torch.clamp(p.grad, -cv, cv)
