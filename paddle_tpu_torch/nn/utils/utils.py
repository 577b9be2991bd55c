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


# ---------------------------------------------------------------------------
# Weight reparametrisations as forward pre-hooks (the JAX package's
# ``weight_norm`` / ``spectral_norm``).  The hook recomputes the weight
# from its parameters at every forward, so it runs inside a captured
# step as it does eagerly: the graph records the recomputation and each
# replay redoes it from the parameters' current values.
# ---------------------------------------------------------------------------
def _norm_except(v, dim):
    """The fp32 2-norm of ``v`` over every dim but ``dim`` (all of them
    for ``dim == -1``), keeping the dims."""
    vf = v.float()
    if dim == -1:
        return vf.square().sum().sqrt().reshape([1] * v.ndim)
    dims = tuple(i for i in range(v.ndim) if i != dim)
    return vf.square().sum(dims, keepdim=True).sqrt()


def _weight_norm_value(g, v, dim):
    """``g * v / max(||v||, 1e-12)`` in fp32, in ``v``'s dtype."""
    return (g.float() * v.float()
            / torch.clamp(_norm_except(v, dim), min=1e-12)).to(v.dtype)


def _reparametrised(layer, name, new):
    """Replace the parameter ``name`` of ``layer`` by the parameters
    ``new`` (name -> value), each keeping its optimisation attributes
    and trainability."""
    from ..param_attr import Parameter
    w = layer._parameters[name]
    for key, value in new.items():
        p = Parameter(value, requires_grad=w.requires_grad)
        p.optimize_attr = dict(getattr(w, "optimize_attr",
                                       {"learning_rate": 1.0}))
        p.regularizer = getattr(w, "regularizer", None)
        layer.register_parameter(key, p)
    delattr(layer, name)


def weight_norm(layer, name: str = "weight", dim: int = 0):
    """Reparametrise ``layer.<name>`` as ``g * v / ||v||`` (counterpart of
    ``paddle_tpu/nn/utils/utils.py::weight_norm``): the parameters
    ``<name>_g`` (the norms over every dim but ``dim``, kept as dims of
    size 1; one norm for ``dim`` None or -1) and ``<name>_v`` take the
    weight's place, and a forward pre-hook sets ``layer.<name>`` from
    them before each forward."""
    w = getattr(layer, name)
    if dim is None:
        dim = -1
    if dim < 0:
        dim += w.ndim if dim != -1 else 0
    v0 = w.detach()
    _reparametrised(layer, name, {
        f"{name}_g": _norm_except(v0, dim).to(v0.dtype).clone(),
        f"{name}_v": v0.clone()})

    def compute(lyr, inputs):
        setattr(lyr, name, _weight_norm_value(
            lyr._parameters[f"{name}_g"], lyr._parameters[f"{name}_v"],
            dim))

    handle = layer.register_forward_pre_hook(compute)
    layer._weight_norm_hook = (handle, name, dim)
    compute(layer, None)
    return layer


def remove_weight_norm(layer, name: str = "weight"):
    """Fold ``g * v / ||v||`` (from the current ``g`` and ``v``) back into
    one parameter ``<name>`` and drop the hook."""
    from ..param_attr import Parameter
    handle, hname, dim = layer._weight_norm_hook
    if hname != name:
        raise ValueError(f"weight_norm was applied to {hname!r}, not "
                         f"{name!r}")
    handle.remove()
    with torch.no_grad():
        value = _weight_norm_value(layer._parameters[f"{name}_g"],
                                   layer._parameters[f"{name}_v"], dim)
    delattr(layer, f"{name}_g")
    delattr(layer, f"{name}_v")
    layer.__dict__.pop(name, None)
    layer.register_parameter(name, Parameter(value.clone()))
    del layer._weight_norm_hook
    return layer


def spectral_norm(layer, name: str = "weight", n_power_iterations: int = 1,
                  eps: float = 1e-12, dim: int = 0, *, generator=None):
    """Spectral normalisation of ``layer.<name>`` (counterpart of
    ``paddle_tpu/nn/utils/utils.py::spectral_norm``): the weight moves
    to the parameter ``<name>_orig``, the buffers ``<name>_u`` /
    ``<name>_v`` hold the power iteration's vectors (drawn from
    ``generator``, the port's of the weight's device when None), and a
    forward pre-hook sets ``layer.<name> = orig / max(sigma, eps)``.
    The iteration runs on the weight's values without a gradient and
    advances the buffers in place in training mode; ``sigma = u^T W v``
    carries the gradient to ``orig``.  The hook runs once at
    registration, as the JAX function's does."""
    from ..norm import power_iteration, unit_normal
    w = getattr(layer, name)
    if dim is None:
        dim = 0
    if dim < 0:
        dim += w.ndim
    h = int(w.shape[dim])
    cols = w.numel() // h
    layer.register_buffer(f"{name}_u", unit_normal(h, eps, w.device,
                                                   generator))
    layer.register_buffer(f"{name}_v", unit_normal(cols, eps, w.device,
                                                   generator))
    _reparametrised(layer, name, {f"{name}_orig": w.detach().clone()})
    perm = [dim] + [i for i in range(w.ndim) if i != dim]

    def compute(lyr, inputs):
        orig = lyr._parameters[f"{name}_orig"]
        u_buf, v_buf = lyr._buffers[f"{name}_u"], lyr._buffers[f"{name}_v"]
        with torch.no_grad():
            mat = orig.detach().permute(perm).reshape(h, cols).float()
            u, v = power_iteration(mat, u_buf.clone(), v_buf.clone(),
                                   n_power_iterations, eps)
            if lyr.training:
                u_buf.copy_(u)
                v_buf.copy_(v)
        sigma = u @ orig.permute(perm).reshape(h, cols).float() @ v
        setattr(lyr, name, (orig.float() / torch.clamp(sigma, min=eps)).to(
            orig.dtype))

    layer.register_forward_pre_hook(compute)
    compute(layer, None)
    return layer
