"""``paddle.distributed.fleet`` (counterpart of
``paddle_tpu/distributed/fleet/__init__.py``)."""

from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .base.topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup)
from .fleet import Fleet, fleet_instance as _fleet  # noqa: F401
from . import meta_optimizers, meta_parallel, utils  # noqa: F401
from .recompute import (  # noqa: F401
    recompute, recompute_hybrid, recompute_sequential)

# the module-level singleton API (upstream's fleet.init(...) etc.)
init = _fleet.init
get_hybrid_communicate_group = _fleet.get_hybrid_communicate_group
distributed_model = _fleet.distributed_model
distributed_optimizer = _fleet.distributed_optimizer
distributed_scaler = _fleet.distributed_scaler
distributed_runner = _fleet.distributed_runner
enable_resilience = _fleet.enable_resilience
worker_index = _fleet.worker_index
worker_num = _fleet.worker_num
is_first_worker = _fleet.is_first_worker
worker_endpoints = _fleet.worker_endpoints
barrier_worker = _fleet.barrier_worker
init_worker = _fleet.init_worker
stop_worker = _fleet.stop_worker
is_server = _fleet.is_server
is_worker = _fleet.is_worker
