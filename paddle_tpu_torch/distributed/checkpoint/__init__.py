"""Distributed checkpoint (counterpart of
``paddle_tpu/distributed/checkpoint/``; upstream
``python/paddle/distributed/checkpoint/``).

``save_state_dict`` / ``load_state_dict`` keep upstream's signatures
(``process_group``, ``coordinator_rank``, ``async_save``, ``offload``);
``reshard.py`` writes each rank's pieces and an index, and loads each
template leaf from the pieces its own layout covers, so a checkpoint
written at dp2 x mp2 loads at dp4, at dp1 or under a sharding stage
(``layout.py`` says where each rank's tensor sits in the whole).
``save_runner_state`` / ``load_runner_state`` carry a
``DistributedRunner``; :class:`CheckpointManager` adds the interval,
retention, async saves, the verified commit and preemption.

The format is the port's own (rank files of ``torch.save``, JSON
fragments and index), not the JAX package's orbax layout: a checkpoint
written by one package is not read by the other.  The wire format both
packages share is ``.pdparams`` / ``.pdopt`` through
``paddle_tpu_torch/framework/io.py`` (``paddle.save`` / ``paddle.load``).
"""

from __future__ import annotations

from typing import Any, Dict

from .layout import Layout, ShardedTensor, param_layout
from .reshard import (load_runner_state, optimizer_state_from_jax,
                      save_runner_state, load_state_dict as _load,
                      save_state_dict as _save)


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    async_save: bool = False):
    """Save a (possibly sharded) state dict; every rank of the group
    calls it.  ``async_save`` returns a handle whose ``wait()`` every
    rank calls before the checkpoint is read."""
    return _save(state_dict, path, process_group, coordinator_rank,
                 async_save)


def load_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    offload: bool = False) -> Dict[str, Any]:
    """Load into ``state_dict`` in place (Paddle's convention), each leaf
    resharded to its own layout."""
    return _load(state_dict, path, process_group, coordinator_rank,
                 offload)


from .manager import CheckpointManager  # noqa: E402

__all__ = ["save_state_dict", "load_state_dict", "save_runner_state",
           "load_runner_state", "optimizer_state_from_jax",
           "CheckpointManager", "Layout",
           "ShardedTensor", "param_layout"]
