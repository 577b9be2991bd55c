"""Hybrid-parallel optimizers (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers/dygraph_optimizer.py``:
``HybridParallelOptimizer``, ``HybridParallelGradScaler``,
``DygraphShardingOptimizer``).

One update serves the dygraph loop and ``DistributedRunner``:
:class:`HybridUpdate`.  Per step, in order:

1. the gradients averaged over the data group (dp, and sharding when
   its stage is 0), or reduced into this rank's chunks by the sharded
   update (``sharding_parallel.ShardedUpdate``, stages 1-3); under
   context parallel first averaged over the sep group (each sep rank
   saw its slice of the sequence); then the copies of a weight that
   pipeline stages share summed over each copy's group (``tied``);
2. the global-norm clip, with the norm of the whole model: the squares
   of the gradients split over mp (``is_distributed``) summed over the
   mp group, those of replicated parameters counted once, under
   sharding the total summed over the sharding group (each rank holds
   other chunks), and under pp over the pipe group, with a shared
   weight's second copies left out (``norm_skip``) -- the JAX
   ``_sq_sum_comm`` over ``mp``, ``pp`` and ``sharding``.  Gradients
   scale in fp32 and round back to their dtype, as
   ``ClipGradByGlobalNorm.pure_clip`` does;
3. the wrapped optimizer's update (its own clip off for the call);
4. under sharding, the updated chunks all-gathered into the parameters
   (stage 3: the parameters released, gathered again before the next
   forward).

A pure data-parallel model (``fleet.distributed_model`` wraps it in
``DataParallel``) has its gradients averaged at the end of backward, so
its optimizer skips step 1 there.
"""

from __future__ import annotations

import torch

from ....nn.clip_grad import (ClipGradByGlobalNorm, ClipGradByNorm,
                               _scale_in_fp32)
from ...communication import all_reduce
from ..meta_parallel.mp_layers import is_mp_split
from ..meta_parallel.sharding_parallel import ShardedUpdate
from ..utils.hybrid_parallel_util import allreduce_mean


class HybridUpdate:
    """The update of the module docstring over explicit groups: the data
    group the batch is split over, the mp group, and the sharding and dp
    groups of a sharded update (``stage`` >= 1 with more than one
    sharding rank)."""

    def __init__(self, named_params, optimizer, data_group, mp_group=None,
                 sharding_group=None, dp_group=None, stage=0, pp_group=None,
                 sep_group=None, tied=(), norm_skip=(), wire_bits=0,
                 generator=None):
        self.optimizer = optimizer
        self.named = [(n, p) for n, p in named_params]
        self.data_group = data_group
        self.mp_group = mp_group
        self.pp_group = pp_group
        self.sep_group = sep_group
        self.tied = list(tied)
        self.norm_skip = {id(p) for p in norm_skip}
        self.sharded = None
        if stage >= 1 and sharding_group is not None and \
                sharding_group.nranks > 1:
            self.sharded = ShardedUpdate(self.named, optimizer,
                                         sharding_group, dp_group, stage,
                                         wire_bits, generator)
        split = self.sharded is not None or (
            mp_group is not None and mp_group.nranks > 1)
        if split and isinstance(optimizer._grad_clip, ClipGradByNorm):
            raise NotImplementedError(
                "ClipGradByNorm under mp or sharding: a tensor's norm "
                "would span ranks; use ClipGradByGlobalNorm (the hybrid "
                "norm) or ClipGradByValue")

    @classmethod
    def from_hcg(cls, named_params, optimizer, hcg, stage=0):
        sep = hcg.get_sep_parallel_group() \
            if hcg.get_sep_parallel_world_size() > 1 else None
        return cls(named_params, optimizer, hcg._get_data_group(),
                   hcg.get_model_parallel_group(),
                   hcg.get_sharding_parallel_group(),
                   hcg.get_data_parallel_group(), stage, sep_group=sep)

    def reduce(self):
        if self.sep_group is not None and self.sep_group.nranks > 1:
            allreduce_mean([p for _, p in self.named], self.sep_group)
        self._reduce_data()
        for p, group in self.tied:
            if p.grad is not None:
                all_reduce(p.grad, group=group)

    def _reduce_data(self):
        if self.sharded is not None:
            self.sharded.reduce_grads(self.data_group,
                                      self.data_group.nranks)
        else:
            allreduce_mean([p for _, p in self.named], self.data_group)

    def _targets(self):
        if self.sharded is not None:
            return [p for p in self.sharded.shards if p.grad is not None]
        return [p for _, p in self.named
                if p.requires_grad and p.grad is not None]

    def sq_sum(self, params) -> torch.Tensor:
        """The square-sum of the whole model's gradients (step 2)."""
        counted = [p for p in params if id(p) not in self.norm_skip]
        dist_g = [p.grad for p in counted if is_mp_split(p)]
        rep_g = [p.grad for p in counted if not is_mp_split(p)]
        device = params[0].grad.device

        def sq(grads):
            if not grads:
                return torch.zeros((), dtype=torch.float32, device=device)
            norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
            return torch.stack([n.to(device) for n in norms]).square().sum()

        sq_d, sq_r = sq(dist_g), sq(rep_g)
        if self.mp_group is not None and self.mp_group.nranks > 1:
            all_reduce(sq_d, group=self.mp_group)
        total = sq_d + sq_r
        if self.sharded is not None:
            all_reduce(total, group=self.sharded.group)
        if self.pp_group is not None and self.pp_group.nranks > 1:
            all_reduce(total, group=self.pp_group)
        return total

    @torch.no_grad()
    def clip(self):
        clip = self.optimizer._grad_clip
        params = self._targets()
        if not params:
            return
        norm = torch.sqrt(self.sq_sum(params))
        scale = clip.clip_norm / torch.clamp(norm, min=clip.clip_norm)
        for p, g in zip(params, _scale_in_fp32([p.grad for p in params],
                                               scale)):
            p.grad = g

    def step(self, reduce=True):
        if reduce or self.sharded is not None:
            self.reduce()
        opt = self.optimizer
        clip = opt._grad_clip
        hybrid = isinstance(clip, ClipGradByGlobalNorm)
        if hybrid:
            self.clip()
            opt._grad_clip = None
        try:
            opt.step()
        finally:
            opt._grad_clip = clip
        if self.sharded is not None:
            if self.sharded.stage >= 3:
                self.sharded.release()
            else:
                self.sharded.gather_params()
            self.sharded.clear_shard_grads()


def _strategy_stage(hcg, strategy) -> int:
    if hcg.get_sharding_parallel_world_size() <= 1:
        return 0
    if strategy is not None and getattr(strategy, "sharding", False):
        return int(strategy.sharding_configs.get("stage", 1))
    return 1


class HybridParallelOptimizer:
    """``fleet.distributed_optimizer``'s optimizer: :class:`HybridUpdate`
    around the wrapped optimizer; everything else passes through."""

    def __init__(self, optimizer, hcg, strategy, network=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._network = network
        self._reduce = hcg.get_parallel_mode() != "data"
        self._update = None

    def _hybrid_update(self):
        if self._update is None:
            named = self._named_params()
            self._update = HybridUpdate.from_hcg(
                named, self._inner_opt, self._hcg,
                _strategy_stage(self._hcg, self._strategy))
        return self._update

    def _named_params(self):
        if self._network is not None:
            return list(self._network.named_parameters())
        names = self._inner_opt._param_names or [
            f"param_{i}" for i in range(len(self._inner_opt._params))]
        return list(zip(names, self._inner_opt._parameter_list))

    def model_parameters(self):
        """The parameters the gradients sit on (under sharding, the
        wrapped optimizer holds chunks instead)."""
        return [p for _, p in self._hybrid_update().named]

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner_opt"], item)

    def step(self):
        self._hybrid_update().step(reduce=self._reduce)

    def clear_grad(self, set_to_zero=False):
        for p in self.model_parameters():
            p.grad = None
        if self._update is not None and self._update.sharded is not None:
            self._update.sharded.clear_shard_grads()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)


class _ParamView:
    """An object with ``_parameter_list`` (what ``GradScaler.unscale_``
    reads) over the model's parameters."""

    def __init__(self, params):
        self._parameter_list = params


class HybridParallelGradScaler:
    """``fleet.distributed_scaler``: the scaler's found-inf is
    all-reduced (max) over the world before the step, so every rank
    skips or takes the same steps."""

    def __init__(self, scaler, hcg):
        self._scaler = scaler
        self._hcg = hcg

    def __getattr__(self, item):
        return getattr(self.__dict__["_scaler"], item)

    def scale(self, loss):
        return self._scaler.scale(loss)

    def step(self, optimizer):
        from ...communication import ReduceOp
        s = self._scaler
        if not s._enable:
            optimizer.step()
            return
        params = optimizer.model_parameters() if isinstance(
            optimizer, HybridParallelOptimizer) else \
            optimizer._parameter_list
        s.unscale_(_ParamView(params))
        flags = s._found_flags or []
        s._found_flags = None
        device = params[0].device
        found = torch.zeros((), dtype=torch.float32, device=device)
        for f in flags:
            found = torch.maximum(found, f.to(device).reshape(()))
        all_reduce(found, op=ReduceOp.MAX)
        s._found_inf = bool(found.item())
        if not s._found_inf:
            optimizer.step()
        s._step_called = True

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        self._scaler.update()


class DygraphShardingOptimizer(HybridParallelOptimizer):
    """Stage-1 sharding of the optimizer state over the sharding group
    (upstream's v2.6 dygraph sharding optimizer)."""

    def __init__(self, optimizer, hcg=None, network=None):
        from ..base.topology import _get_hybrid_parallel_group
        hcg = hcg or _get_hybrid_parallel_group()
        super().__init__(optimizer, hcg, None, network)

    def _hybrid_update(self):
        if self._update is None:
            self._update = HybridUpdate.from_hcg(
                self._named_params(), self._inner_opt, self._hcg, 1)
        return self._update
