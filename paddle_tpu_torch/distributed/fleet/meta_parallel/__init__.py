"""The parallel layers and wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel``).  Pipeline parallel
(``PipelineLayer``, ``pp_layers``) and context parallel
(``ring_flash_attention``, ``ulysses_attention``) come with the next
A10 slices."""

from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, is_mp_split,
    mark_as_sequence_parallel_parameter)
from .parallel_wrappers import (  # noqa: F401
    PipelineParallelWrapper, ShardingParallel, TensorParallel)
from .sharding_parallel import (  # noqa: F401
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3)
from . import mp_ops  # noqa: F401
