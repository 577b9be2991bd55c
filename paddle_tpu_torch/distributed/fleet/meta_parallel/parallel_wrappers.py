"""Model wrappers that ``fleet.distributed_model`` picks (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_wrappers.py``;
upstream ``meta_parallel/tensor_parallel.py``,
``sharding_parallel.py``, ``pipeline_parallel.py``).

``TensorParallel`` starts every rank from its group's first rank: the
parameters that are not split over mp from the mp group's first rank,
then every parameter from the dp group's and the sharding group's first
rank (upstream's ``broadcast_*_parameters``).  The gradients are
reduced by the hybrid optimizer (``fleet.distributed_optimizer``).
``PipelineParallelWrapper`` gives a ``PipelineLayer`` the pipeline
engine's ``train_batch`` / ``eval_batch``
(``pipeline_parallel.PipelineParallel``).
"""

from __future__ import annotations

from ...parallel import LayerWrapper
from ..utils.hybrid_parallel_util import (broadcast_dp_parameters,
                                          broadcast_mp_parameters,
                                          broadcast_sharding_parameters)
from .sharding_parallel import materialize_params

class MetaParallelBase(LayerWrapper):
    def __init__(self, layers, hcg, strategy):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy

    def forward(self, *inputs, **kwargs):
        materialize_params(self._layers)
        return self._layers(*inputs, **kwargs)


class TensorParallel(MetaParallelBase):
    """mp (with dp / sharding beside it)."""

    def __init__(self, layers, hcg, strategy):
        super().__init__(layers, hcg, strategy)
        broadcast_mp_parameters(layers, hcg)
        broadcast_dp_parameters(layers, hcg)
        broadcast_sharding_parameters(layers, hcg)


class ShardingParallel(MetaParallelBase):
    """The sharding axis without mp: every rank from the sharding and dp
    groups' first ranks."""

    def __init__(self, layers, hcg, strategy):
        super().__init__(layers, hcg, strategy)
        broadcast_sharding_parameters(layers, hcg)
        broadcast_dp_parameters(layers, hcg)


class PipelineParallelWrapper(MetaParallelBase):
    """pp: the engine's ``train_batch`` / ``eval_batch`` (upstream's
    ``PipelineParallel`` API)."""

    def __init__(self, layers, hcg, strategy):
        super().__init__(layers, hcg, strategy)
        from .pipeline_parallel import PipelineParallel
        self._engine = PipelineParallel(layers, hcg, strategy)
        self.accumulate_steps = self._engine.accumulate_steps

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        return self._engine.train_batch(data, optimizer, lr_scheduler,
                                        scaler)

    def eval_batch(self, data, compute_loss=True):
        return self._engine.eval_batch(data, compute_loss)
