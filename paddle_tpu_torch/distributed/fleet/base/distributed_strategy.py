"""DistributedStrategy (counterpart of
``paddle_tpu/distributed/fleet/base/distributed_strategy.py``; upstream
``python/paddle/distributed/fleet/base/distributed_strategy.py``, a
protobuf there): the one config object that selects the parallelism.

The same attributes and the same merge rule: assigning a ``*_configs``
dict updates the current one key by key (``hybrid_configs`` over its
defaults), so keys left out keep their values.  ``fleet.init`` reads
``hybrid_configs`` and ``tensor_parallel_configs``;
``fleet.distributed_runner`` reads ``sharding``/``sharding_configs``,
``gradient_merge``, ``amp``/``amp_configs`` and ``recompute``, and
refuses the knobs the port does not consume (``fleet/fleet.py``).
"""

from __future__ import annotations

from typing import Any, Dict


_DEFAULT_HYBRID = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
}

_DEFAULT_AMP = {
    "init_loss_scaling": 32768.0,
    "incr_every_n_steps": 1000,
    "decr_every_n_nan_or_inf": 2,
    "incr_ratio": 2.0,
    "decr_ratio": 0.8,
    "use_dynamic_loss_scaling": True,
    "custom_white_list": [],
    "custom_black_list": [],
    "use_pure_fp16": False,
    "use_fp16_guard": True,
    "use_bf16": True,
}

_DEFAULT_RECOMPUTE = {"checkpoints": [], "enable_offload": False}

_DEFAULT_SHARDING = {
    "sharding_segment_strategy": "segment_broadcast_MB",
    "segment_broadcast_MB": 32,
    "stage": 1,
    "sharding_degree": 8,
    "mp_degree": 1,
    "pp_degree": 1,
    "dp_degree": 1,
}

_DEFAULT_PIPELINE = {
    "micro_batch_size": 1,
    "accumulate_steps": 1,
    "schedule_mode": "1F1B",
    "p2p_cache_shape": True,
}

_DEFAULT_GRADIENT_MERGE = {"k_steps": 1, "avg": True}


class DistributedStrategy:
    def __init__(self):
        self.amp = False
        self.amp_configs = dict(_DEFAULT_AMP)
        self.recompute = False
        self.recompute_configs = dict(_DEFAULT_RECOMPUTE)
        self.sharding = False
        self.sharding_configs = dict(_DEFAULT_SHARDING)
        self.pipeline = False
        self.pipeline_configs = dict(_DEFAULT_PIPELINE)
        self.gradient_merge = False
        self.gradient_merge_configs = dict(_DEFAULT_GRADIENT_MERGE)
        self.hybrid_configs = dict(_DEFAULT_HYBRID)
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1,
                                        "tensor_init_seed": -1}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01,
                             "exclude_from_weight_decay": []}
        # the compressed dp gradient path (distributed/compressed.py):
        # the wire width of the explicit dp reduction (0, 8 or 16) and
        # the sharded weight update, handed to DistributedRunner
        self.quantized_allreduce = 0
        self.sharded_weight_update = False
        self.localsgd = False
        self.dgc = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.find_unused_parameters = False
        self.heter_ccl_mode = False
        self.without_graph_optimization = False
        self.fuse_grad_merge = False
        self.a_sync = False
        self.a_sync_configs = {}

    def __setattr__(self, key, value):
        if key == "hybrid_configs" and hasattr(self, "hybrid_configs"):
            merged = dict(_DEFAULT_HYBRID)
            merged.update(value)
            object.__setattr__(self, key, merged)
            return
        if key.endswith("_configs") and hasattr(self, key):
            cur = dict(getattr(self, key))
            cur.update(value)
            object.__setattr__(self, key, cur)
            return
        object.__setattr__(self, key, value)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()}

    def __repr__(self):
        lines = ["DistributedStrategy("]
        for k, v in self.__dict__.items():
            lines.append(f"  {k}={v},")
        lines.append(")")
        return "\n".join(lines)
