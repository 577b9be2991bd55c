"""Hybrid-parallel gradient and parameter helpers (counterpart of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py``).

``fused_allreduce_gradients`` averages the gradients over the data
parallel group: one flat buffer per gradient dtype (the JAX helper's
"one fused psum per dtype bucket"), summed over the group and divided by
its rank count.  Each bucket is summed in its own dtype, as the JAX
helper's psum is.  A sparse row gradient is made dense first, as the JAX
helper does.  The ``broadcast_*_parameters`` helpers start every rank of
a group from the group's first rank's values.
"""

from __future__ import annotations

import torch


def allreduce_mean(parameter_list, group) -> None:
    """Each gradient of ``parameter_list`` averaged over ``group``."""
    from ...communication import all_reduce
    if group is None or group.nranks <= 1:
        return
    buckets = {}
    for p in parameter_list:
        p = getattr(p, "_value", p)
        if p.grad is None:
            continue
        if p.grad.is_sparse:
            p.grad = p.grad.to_dense()
        buckets.setdefault(p.grad.dtype, []).append(p)
    for params in buckets.values():
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        all_reduce(flat, group=group)
        flat.div_(group.nranks)
        off = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n


def fused_allreduce_gradients(parameter_list, hcg):
    """Average the gradients over ``hcg``'s data-parallel group (module
    docstring); a no-op at dp 1."""
    group = hcg.get_data_parallel_group() if hcg is not None else None
    allreduce_mean(parameter_list, group)


def broadcast_mp_parameters(model, hcg):
    """The parameters that are not split over the mp group, from the mp
    group's first rank."""
    from ...parallel import sync_params_buffers
    g = hcg.get_model_parallel_group()
    sync_params_buffers(model, g, g.ranks[0], is_model_parallel=True)


def broadcast_dp_parameters(model, hcg):
    from ...parallel import sync_params_buffers
    g = hcg.get_data_parallel_group()
    sync_params_buffers(model, g, g.ranks[0])


def broadcast_sharding_parameters(model, hcg):
    from ...parallel import sync_params_buffers
    g = hcg.get_sharding_parallel_group()
    sync_params_buffers(model, g, g.ranks[0])
