"""``paddle.distributed`` of the port (counterpart of
``paddle_tpu/distributed/__init__.py``): the process world
(``init_parallel_env``, ``spawn``), the collectives on
``torch.distributed`` (``communication``, ``stream``), Fleet's hybrid
topology with data, tensor (mp) and sharding parallelism and
recompute (``fleet``, ``sharding``), pipeline parallel
(``fleet.meta_parallel.PipelineLayer``, ``PipelineParallel``,
``PipelinedRunner``) and context parallel (ring and Ulysses attention
over the sep group), ``DistributedRunner`` with the compressed dp path
(``compressed``: the int8 and exact rings, the sharded weight update),
the distributed checkpoint with reshard-on-load and its manager
(``checkpoint``), fault injection and the retry policy
(``resilience.faults``, ``resilience.retry``).  Auto-parallel and MoE
come with the next A10 slices; the launcher and the rest of
``resilience/`` with A11.
"""

from . import resilience  # noqa: F401
from .parallel import (  # noqa: F401
    DataParallel, ParallelEnv, get_backend, get_rank, get_world_size,
    init_parallel_env, is_initialized)
from .communication import (  # noqa: F401
    Group, ReduceOp, all_gather, all_gather_object, all_reduce, all_to_all,
    alltoall, alltoall_single, barrier, broadcast, broadcast_object_list,
    destroy_process_group, gather, get_group, irecv, isend, new_group, recv,
    reduce, reduce_scatter, scatter, scatter_object_list, send, wait)
from . import stream  # noqa: F401
from . import fleet  # noqa: F401
from . import sharding  # noqa: F401
from .collective import get_mesh, set_mesh, split  # noqa: F401
from .runner import DistributedRunner, PipelinedRunner  # noqa: F401
from . import checkpoint, compressed  # noqa: F401
from .spawn import spawn  # noqa: F401
from .fleet.recompute import recompute  # noqa: F401

__all__ = ["resilience", "DataParallel", "ParallelEnv", "get_backend",
           "get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "Group", "ReduceOp", "all_gather",
           "all_gather_object", "all_reduce", "all_to_all", "alltoall",
           "alltoall_single", "barrier", "broadcast",
           "broadcast_object_list", "destroy_process_group", "gather",
           "get_group", "irecv", "isend", "new_group", "recv", "reduce",
           "reduce_scatter", "scatter", "scatter_object_list", "send",
           "wait", "stream", "fleet", "sharding", "get_mesh", "set_mesh",
           "split", "DistributedRunner", "PipelinedRunner", "spawn",
           "recompute", "checkpoint", "compressed"]
