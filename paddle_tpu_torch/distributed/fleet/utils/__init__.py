"""Fleet utilities (counterpart of ``paddle_tpu/distributed/fleet/utils``)."""

from . import hybrid_parallel_util, sequence_parallel_utils  # noqa: F401
from .hybrid_parallel_util import (  # noqa: F401
    broadcast_dp_parameters, broadcast_mp_parameters,
    broadcast_sharding_parameters, fused_allreduce_gradients)
from ..recompute import recompute  # noqa: F401
