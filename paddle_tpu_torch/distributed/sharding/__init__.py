"""``paddle.distributed.sharding`` (counterpart of
``paddle_tpu/distributed/sharding/__init__.py``; upstream
``python/paddle/distributed/sharding/group_sharded.py``)."""

from __future__ import annotations

import os

from ..fleet.meta_parallel.sharding_parallel import (  # noqa: F401
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3,
    materialize_params)

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model, optimizer, level, scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """``level``: ``"os"`` (stage 1: optimizer state sharded), ``"os_g"``
    (stage 2: and gradients reduce-scattered) or ``"p_g_os"`` (stage 3:
    and parameters gathered for use).  Returns the model (wrapped at
    stages 2 and 3), the sharded optimizer and ``scaler``."""
    if level not in _LEVELS:
        raise ValueError(f"unknown level {level!r}; use os | os_g | p_g_os")
    stage = _LEVELS[level]
    opt = GroupShardedOptimizerStage2(model.parameters(), optimizer,
                                      group=group, offload=offload,
                                      stage=stage)
    if stage == 1:
        opt._network = model
        return model, opt, scaler
    wrap = GroupShardedStage2 if stage == 2 else GroupShardedStage3
    wrapped = wrap(model, opt, group=group, sync_buffers=sync_buffers)
    return wrapped, opt, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """The whole model's state dict to ``output/model.pdparams`` (stage
    3's parameters gathered first), and the optimizer's to
    ``model.pdopt``."""
    from ...framework.io import save
    os.makedirs(output, exist_ok=True)
    target = model._layers if hasattr(model, "_layers") else model
    materialize_params(target)
    save(target.state_dict(), os.path.join(output, "model.pdparams"))
    if optimizer is not None:
        save(optimizer.state_dict(), os.path.join(output, "model.pdopt"))
