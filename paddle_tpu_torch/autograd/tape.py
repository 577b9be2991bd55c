"""Dygraph autograd of the port (counterpart of
``paddle_tpu/autograd/tape.py``).

The JAX package records an op tape and replays it under ``jax.vjp``;
the port has torch's autograd graph, built as the ops run on
``Tensor._value``, and maps Paddle's calls onto it:

- ``backward(tensors, grad_tensors, retain_graph)`` is
  ``torch.autograd.backward``; a non-scalar output without a given
  gradient is seeded with ones, as the tape seeds it, a given gradient
  is cast to the output's dtype (the tape's ``_ct_like``), and an
  output that requires no gradient is skipped, as the tape finds nothing
  to walk;
- leaves' ``grad`` accumulate across calls until ``clear_grad``;
- ``grad(...)`` is ``torch.autograd.grad``: it leaves ``.grad`` alone,
  keeps the graph unless ``retain_graph=False`` (the tape is kept too),
  and with ``create_graph=True`` returns gradients that differentiate
  again; an input that the outputs do not reach raises unless
  ``allow_unused``, and a sparse gradient comes back dense;
- ``no_grad`` / ``enable_grad`` / ``set_grad_enabled`` are torch's.

Departures from the JAX package, each pinned by
``tests/test_torch_autograd.py``: a second ``backward()`` through a
graph that the first freed raises (torch), where the tape, reset by the
first, silently does nothing; ``grad(create_graph=True)`` runs the
hooks registered with ``register_hook`` and differentiates through a
``PyLayer`` whose backward is made of ops, where the tape refuses both.
The custom ``autograd.Function`` s of the kernels (flash attention, the
fused lm-head cross-entropy) have no double backward: a second-order
gradient through them raises.
"""

from __future__ import annotations

import torch

from ..tensor import _wrap, unwrap

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled


def set_grad_enabled(mode):
    """Turn gradient recording on or off (also usable as a context)."""
    return torch.set_grad_enabled(bool(mode))


def _seq(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _seeds(outputs, grad_outputs):
    seeds = []
    for t, g in zip(outputs, grad_outputs):
        if g is None:
            seeds.append(torch.ones_like(t))
        else:
            g = unwrap(g)
            if not isinstance(g, torch.Tensor):
                g = torch.as_tensor(g, device=t.device)
            seeds.append(g.to(t.dtype) if g.dtype != t.dtype and
                         t.is_floating_point() else g)
    return seeds


def backward(tensors, grad_tensors=None, retain_graph: bool = False) -> None:
    """``paddle.autograd.backward`` (module docstring)."""
    tensors = [unwrap(t) for t in _seq(tensors)]
    grads = ([None] * len(tensors) if grad_tensors is None
             else _seq(grad_tensors))
    pairs = [(t, g) for t, g in zip(tensors, grads) if t.requires_grad]
    if not pairs:
        return
    outs = [t for t, _ in pairs]
    torch.autograd.backward(outs, _seeds(outs, [g for _, g in pairs]),
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad`` (module docstring): the gradients of ``outputs``
    with respect to ``inputs``, as Tensors (None for an unused input
    under ``allow_unused``)."""
    outs = [unwrap(t) for t in _seq(outputs)]
    ins = [unwrap(t) for t in _seq(inputs)]
    gos = ([None] * len(outs) if grad_outputs is None
           else _seq(grad_outputs))
    keep = [i for i, t in enumerate(outs) if t.requires_grad]
    live = [j for j, t in enumerate(ins) if t.requires_grad]
    res = [None] * len(ins)
    if keep and live:
        o = [outs[i] for i in keep]
        got = torch.autograd.grad(
            o, [ins[j] for j in live],
            grad_outputs=_seeds(o, [gos[i] for i in keep]),
            retain_graph=True if retain_graph is None else retain_graph,
            create_graph=create_graph, allow_unused=True)
        for j, g in zip(live, got):
            res[j] = g
    if any(r is None for r in res) and not allow_unused:
        raise RuntimeError(
            "One of the differentiated tensors appears unused; pass "
            "allow_unused=True to return None for it.")
    return [None if r is None else _wrap(r.to_dense() if r.is_sparse else r)
            for r in res]


__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled"]
