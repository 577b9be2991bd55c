"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip_grad.py``,
upstream ``python/paddle/nn/clip.py``).

Each clip has two forms, as in the JAX package:

- ``clip(params_grads)``: the eager form, a list of ``(param, grad)``
  pairs in, the same pairs with clipped gradients out (new tensors; a
  ``None`` gradient passes through).
- ``clip.pure_clip(grads)``: the form the optimizer's update runs
  (``Optimizer._step``, and so the captured training step): a list or
  a ``{name: grad}`` dict of gradients in, the same structure out.  It
  is device ops only, with every scalar a 0-d tensor on the gradients'
  device, so it reads nothing on the host and a CUDA graph replays it.

A sparse row gradient (``Embedding(sparse=True)``) is merged first in
every clip, and the clip acts on its values: ``ClipGradByGlobalNorm``
and ``ClipGradByNorm`` take the norms of the merged values (duplicate
rows summed before they are squared), as the JAX clips do; the dense
gradients' clip is unchanged (``_on_values``).

``ClipGradByGlobalNorm`` sums every gradient's fp32 squares
(``torch._foreach_norm`` in fp32, then the norm of the norms), scales
by ``clip_norm / max(norm, clip_norm)`` and multiplies each gradient
in fp32, rounding back to its dtype: a bf16 gradient is
``(g.float() * scale).to(bf16)``, as the JAX ``pure_clip`` rounds it.
"""

from __future__ import annotations

from typing import List

import torch

from ..framework.selected_rows import merge_rows

_aten = torch.ops.aten


def _map(grads, fn):
    """``fn`` over the gradients of a list or a dict, keeping its
    structure."""
    if isinstance(grads, dict):
        names = list(grads)
        return dict(zip(names, _on_values(fn, [grads[n] for n in names])))
    return _on_values(fn, list(grads))


def _on_values(fn, grads):
    """``fn`` over ``grads`` with each sparse row gradient merged first
    (duplicate rows summed: ``framework/selected_rows.py``) and given as
    its values, then rebuilt around the clipped values, as the JAX clips
    take a ``SelectedRows``: the norms are the merged values' norms.
    Without a sparse gradient, ``fn(grads)`` itself."""
    if not any(g.is_sparse for g in grads):
        return fn(grads)
    merged = [merge_rows(g) if g.is_sparse else None for g in grads]
    out = fn([g if m is None else m.values()
              for g, m in zip(grads, merged)])
    return [o if m is None else torch.sparse_coo_tensor(
        m.indices(), o, m.shape, check_invariants=False, is_coalesced=True)
        for o, m in zip(out, merged)]


def _scale_in_fp32(grads: List[torch.Tensor], scale) -> List[torch.Tensor]:
    """``(g.float() * scale).to(g.dtype)`` for each gradient, ``scale``
    a 0-d fp32 tensor (the foreach Tensor overload: no host read)."""
    out = _aten._foreach_mul.Tensor([g.float() for g in grads], scale)
    return [o if g.dtype == torch.float32 else o.to(g.dtype)
            for o, g in zip(out, grads)]


class ClipGradBase:
    def __call__(self, params_grads):
        pairs = list(params_grads)
        live = [i for i, (_, g) in enumerate(pairs) if g is not None]
        clipped = self.pure_clip([pairs[i][1] for i in live]) if live else []
        out = list(pairs)
        for i, g in zip(live, clipped):
            out[i] = (pairs[i][0], g)
        return out

    def pure_clip(self, grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each element into ``[min, max]`` (``min`` defaults to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def pure_clip(self, grads):
        return _map(grads, lambda gs: [torch.clamp(g, self.min, self.max)
                                       for g in gs])


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip_norm / max(|g|, 1e-12), 1)``,
    its own norm, in its dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def pure_clip(self, grads):
        def clip(gs):
            if not gs:
                return []
            norms = torch._foreach_norm(gs)
            scales = [torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                  max=1.0) for n in norms]
            return torch._foreach_mul(gs, scales)

        return _map(grads, clip)


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``clip_norm / max(global_norm,
    clip_norm)``.  ``_comm_hook``, when set, sums the squares across
    ranks first; under hybrid parallel the fleet optimizer clips by the
    whole model's norm itself (``distributed/fleet/meta_optimizers/
    dygraph_optimizer.py::HybridUpdate``)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self._comm_hook = None

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The fp32 norm over every gradient, a 0-d device tensor."""
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        device = grads[0].device
        sq = torch.stack([n.to(device) for n in norms]).square().sum()
        if self._comm_hook is not None:
            sq = self._comm_hook(sq)
        return torch.sqrt(sq)

    def pure_clip(self, grads):
        def clip(gs):
            if not gs:
                return []
            norm = self.global_norm(gs)
            scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
            return _scale_in_fp32(gs, scale)

        return _map(grads, clip)
