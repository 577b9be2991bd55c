"""The fleet facade (counterpart of ``paddle_tpu/distributed/fleet/fleet.py``:
``fleet.init``, ``distributed_model``, ``distributed_optimizer``,
``distributed_runner`` and the worker queries).

``init`` starts the world (``init_parallel_env``), builds the topology
from ``hybrid_configs`` (a process group per axis slice) and seeds the
mp RNG tracker as the JAX fleet does: a shared global seed and a local
seed per mp rank, from ``tensor_parallel_configs["tensor_init_seed"]``
(42 when unset).

``distributed_model`` gives a ``PipelineLayer`` (or any model at pp >
1) the pipeline engine's wrapper; models built under ``sep_degree > 1``
run their attention over the sep group themselves (the GPT attention's
ring or Ulysses branch).

``distributed_runner`` hands ``quantized_allreduce`` (0, 8 or 16) and
``sharded_weight_update`` to ``DistributedRunner``'s explicit dp path.
What waits is refused with the ROADMAP item that brings it:
``enable_resilience``, A11.
"""

from __future__ import annotations

from typing import Optional

from .base.distributed_strategy import DistributedStrategy
from .base.topology import (CommunicateTopology, HybridCommunicateGroup,
                            _get_hybrid_parallel_group,
                            _set_hybrid_parallel_group)
from ..parallel import ParallelEnv, init_parallel_env

RESILIENCE_REFUSAL = ("fleet.enable_resilience (the hang watchdog, the fault "
                      "plan and the rank-elastic beacon) is not ported yet: "
                      "it comes with ROADMAP queue A, item A11 (resilience/ "
                      "and launch/)")

# knobs the port refuses rather than consumes (the JAX package's rule:
# every knob is consumed or refused, never dropped)
_REFUSED_STRATEGY_KNOBS = {
    "a_sync": "PS-era async SGD; the parameter server is not part of "
              "the port",
    "a_sync_configs": "see a_sync",
    "dgc": "deep gradient compression is not ported",
    "find_unused_parameters": "DataParallel reduces every gradient; "
                              "unused-parameter search is not ported",
    "fuse_all_reduce_ops": "the port always fuses: one flat buffer per "
                           "gradient dtype",
    "fuse_grad_merge": "gradient merge accumulates in the step",
    "fuse_grad_size_in_MB": "the buckets are per dtype, not by size",
    "heter_ccl_mode": "heterogeneous PS communication is not ported",
    "lamb": "the optimizer is the object passed in, not a strategy flag",
    "lamb_configs": "see lamb",
    "localsgd": "local SGD is not ported; dp gradients sync every step",
    "nccl_comm_num": "one communicator per group",
    "recompute_configs": "checkpoint selection is not honoured: "
                         "recompute covers the whole forward",
    "tensor_parallel": "mp is selected by hybrid_configs['mp_degree']",
    "without_graph_optimization": "the port has no graph mode",
}


class Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective=False, strategy=None,
             log_level="INFO"):
        self._strategy = strategy or DistributedStrategy()
        init_parallel_env()
        hc = self._strategy.hybrid_configs
        dims = [hc.get("dp_degree", 1), hc.get("pp_degree", 1),
                hc.get("sharding_degree", 1), hc.get("sep_degree", 1),
                hc.get("mp_degree", 1)]
        names = ["data", "pipe", "sharding", "sep", "model"]
        from ..parallel import get_rank
        self._hcg = HybridCommunicateGroup(CommunicateTopology(names, dims),
                                           get_rank())
        _set_hybrid_parallel_group(self._hcg)
        from ...framework import random as _random
        seed = self._strategy.tensor_parallel_configs.get(
            "tensor_init_seed", -1)
        if seed is None or seed < 0:
            seed = 42
        _random.model_parallel_random_seed(
            seed, self._hcg.get_model_parallel_rank())
        self._is_initialized = True
        return self

    @property
    def is_initialized(self):
        return self._is_initialized

    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        return self._hcg or _get_hybrid_parallel_group()

    def worker_index(self):
        return ParallelEnv().rank

    def worker_num(self):
        return ParallelEnv().world_size

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_endpoints(self, to_string=False):
        eps = ParallelEnv().trainer_endpoints
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        from ..communication import barrier
        barrier()

    def distributed_model(self, model):
        """The wrapper for the topology: ``PipelineParallelWrapper`` for a
        ``PipelineLayer`` or at pp > 1, ``TensorParallel`` at mp > 1,
        ``ShardingParallel`` at sharding > 1, ``DataParallel`` over the dp
        group at dp > 1, else the model."""
        hcg = self.get_hybrid_communicate_group()
        from .meta_parallel.parallel_wrappers import (
            PipelineParallelWrapper, ShardingParallel, TensorParallel)
        from .meta_parallel.pp_layers import PipelineLayer
        from ..parallel import DataParallel
        if hcg.get_pipe_parallel_world_size() > 1 or isinstance(
                model, PipelineLayer):
            return PipelineParallelWrapper(model, hcg, self._strategy)
        if hcg.get_model_parallel_world_size() > 1:
            return TensorParallel(model, hcg, self._strategy)
        if hcg.get_sharding_parallel_world_size() > 1:
            return ShardingParallel(model, hcg, self._strategy)
        if hcg.get_data_parallel_world_size() > 1:
            return DataParallel(model, group=hcg.get_data_parallel_group())
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        from .meta_optimizers.dygraph_optimizer import \
            HybridParallelOptimizer
        hcg = self.get_hybrid_communicate_group()
        if hcg is None:
            return optimizer
        return HybridParallelOptimizer(optimizer, hcg, self._strategy)

    def distributed_scaler(self, scaler):
        from .meta_optimizers.dygraph_optimizer import \
            HybridParallelGradScaler
        return HybridParallelGradScaler(scaler,
                                        self.get_hybrid_communicate_group())

    def distributed_runner(self, model, optimizer, loss_fn=None,
                           input_specs=None):
        """The per-rank train-step engine with the strategy's knobs:
        sharding -> ZeRO stage, gradient_merge -> accumulate_steps
        (``k_steps``), amp -> O1/O2 and its dtype, recompute -> remat,
        quantized_allreduce / sharded_weight_update -> the explicit dp
        path;
        at pp > 1 with a ``PipelineLayer``, ``PipelinedRunner`` (the
        pipeline engine; a sharding stage or ``input_specs`` refused
        there, as in the JAX fleet).  Refuses the knobs of
        ``_REFUSED_STRATEGY_KNOBS`` when set."""
        from ..runner import DistributedRunner, PipelinedRunner
        from .meta_parallel.pp_layers import PipelineLayer
        s = self._strategy or DistributedStrategy()
        current = s.to_dict()
        defaults = DistributedStrategy().to_dict()
        refused = {k: current.get(k) for k in _REFUSED_STRATEGY_KNOBS
                   if current.get(k) != defaults.get(k)}
        if refused:
            reasons = "; ".join(
                f"{k}={refused[k]!r} ({_REFUSED_STRATEGY_KNOBS[k]})"
                for k in sorted(refused))
            raise ValueError(
                "DistributedStrategy knobs this port refuses (set only "
                "defaults for them): " + reasons)
        stage = int(s.sharding_configs.get("stage", 1)) if s.sharding else 0
        acc = 1
        if s.gradient_merge:
            acc = int(s.gradient_merge_configs.get("k_steps", 1))
        elif s.pipeline:
            acc = int(s.pipeline_configs.get("accumulate_steps", 1))
        amp_level, amp_dtype = None, "bfloat16"
        if s.amp:
            cfg = s.amp_configs
            amp_level = "O2" if cfg.get("use_pure_fp16") else "O1"
            amp_dtype = "bfloat16" if cfg.get("use_bf16", True) \
                else "float16"
        hcg = self.get_hybrid_communicate_group()
        if hcg.get_pipe_parallel_world_size() > 1 and isinstance(
                model, PipelineLayer):
            unsupported = {}
            if stage:
                unsupported["sharding stage"] = stage
            if getattr(s, "quantized_allreduce", 0):
                unsupported["quantized_allreduce"] = s.quantized_allreduce
            if getattr(s, "sharded_weight_update", False):
                unsupported["sharded_weight_update"] = True
            if input_specs:
                unsupported["input_specs"] = input_specs
            if unsupported:
                raise ValueError(
                    "pipeline meshes run the pipeline-schedule engine, "
                    "which does not support these strategy knobs yet: "
                    f"{unsupported}.  Drop them or use pp 1.")
            return PipelinedRunner(
                model, optimizer, loss_fn, mesh=hcg,
                accumulate_steps=max(acc, 1), amp_level=amp_level,
                amp_dtype=amp_dtype,
                pipeline_configs=s.pipeline_configs if s.pipeline
                else None,
                remat=True if s.recompute else None)
        return DistributedRunner(
            model, optimizer, loss_fn,
            mesh=self.get_hybrid_communicate_group(), sharding_stage=stage,
            accumulate_steps=max(acc, 1), input_specs=input_specs,
            amp_level=amp_level, amp_dtype=amp_dtype,
            remat=bool(s.recompute),
            dp_compress_bits=getattr(s, "quantized_allreduce", 0),
            dp_shard_update=getattr(s, "sharded_weight_update", False))

    def enable_resilience(self, hang_timeout=None, on_hang=None,
                          dump_path=None):
        raise NotImplementedError(RESILIENCE_REFUSAL)

    # the parameter-server API, kept for its signatures
    def is_server(self):
        return False

    def is_worker(self):
        return True

    def init_worker(self):
        pass

    def stop_worker(self):
        pass


fleet_instance = Fleet()
