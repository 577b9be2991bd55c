"""The dygraph meta-optimizers (counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers``; the static-graph ones
wait for ROADMAP queue A, item A12)."""

from .dygraph_optimizer import (  # noqa: F401
    DygraphShardingOptimizer, HybridParallelGradScaler,
    HybridParallelOptimizer, HybridUpdate)
