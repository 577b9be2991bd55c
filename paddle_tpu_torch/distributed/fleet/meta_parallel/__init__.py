"""The parallel layers and wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel``): tensor parallel
(``mp_layers``, ``mp_ops``), sharding, pipeline parallel (``pp_layers``,
``pipeline_parallel``) and context parallel (``context_parallel``)."""

from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, is_mp_split,
    mark_as_sequence_parallel_parameter)
from .parallel_wrappers import (  # noqa: F401
    PipelineParallelWrapper, ShardingParallel, TensorParallel)
from .sharding_parallel import (  # noqa: F401
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3)
from .pp_layers import (  # noqa: F401
    LayerDesc, PipelineLayer, SharedLayerDesc)
from .pipeline_parallel import (  # noqa: F401
    PipelineParallel, pipeline_spmd, pipeline_spmd_interleaved,
    split_pipeline_sections)
from .context_parallel import (  # noqa: F401
    ring_flash_attention, split_sequence, ulysses_attention,
    zigzag_indices, zigzag_merge_sequence, zigzag_split_sequence)
from . import context_parallel, mp_ops  # noqa: F401
