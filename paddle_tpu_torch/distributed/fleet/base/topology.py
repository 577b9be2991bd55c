"""Hybrid-parallel topology (counterpart of
``paddle_tpu/distributed/fleet/base/topology.py``: ``CommunicateTopology``
and ``HybridCommunicateGroup``).

The rank arithmetic and the axis order are the JAX package's: the ranks
``0 .. world-1`` laid out row-major over the axes ``data, pipe,
sharding, sep, model`` (``model`` innermost, so an mp group is
consecutive ranks).  Where the JAX package binds each axis to a mesh
axis name, the port makes a real process group per axis slice: every
rank calls ``new_group`` for every slice of every axis in one order (as
``torch.distributed`` requires) and keeps the groups it belongs to.
Without a world of the topology's size (one process, or rank arithmetic
alone) the groups carry their ranks and no process group.

One group beyond the JAX package's serves the eager step: the data
group (``_get_data_group``: the ranks that share this rank's pipe, sep
and model coordinates, over which the batch is split, data-major as the
JAX runner shards it on ``("dp", "sharding")``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as dist

from ...communication import Group, new_group


class CommunicateTopology:
    def __init__(self, hybrid_group_names=None, dims=None):
        self._parallel_names = list(hybrid_group_names or
                                    ["data", "pipe", "sharding", "sep",
                                     "model"])
        self._dims = list(dims or [1] * len(self._parallel_names))
        self.coordinate = None
        self._world_size = int(np.prod(self._dims))
        self._rank_array = np.arange(self._world_size).reshape(self._dims)

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        coords = [kwargs[n] for n in self._parallel_names]
        return int(self._rank_array[tuple(coords)])

    def get_coord(self, rank):
        coords = np.unravel_index(rank, self._dims)
        return dict(zip(self._parallel_names, (int(c) for c in coords)))

    def get_axis_list(self, axis_name, index):
        """All ranks whose coordinate on ``axis_name`` is ``index``."""
        ax = self._parallel_names.index(axis_name)
        taken = np.take(self._rank_array, index, axis=ax)
        return sorted(int(r) for r in taken.reshape(-1))

    def get_comm_list(self, axis_name):
        """The rank groups along ``axis_name`` (one per slice)."""
        ax = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._rank_array, ax, -1)
        flat = moved.reshape(-1, self._dims[ax])
        return [list(map(int, row)) for row in flat]

    def get_fused_comm_list(self, axis_names):
        """The rank groups spanning every axis of ``axis_names`` (one per
        slice of the others), each in rank order."""
        axes = [self._parallel_names.index(a) for a in axis_names]
        moved = np.moveaxis(self._rank_array, axes,
                            range(-len(axes), 0))
        size = int(np.prod([self._dims[a] for a in axes]))
        return [sorted(map(int, row)) for row in moved.reshape(-1, size)]


class HybridCommunicateGroup:
    def __init__(self, topology: CommunicateTopology, rank: int = 0):
        self._topo = topology
        self.global_rank = rank
        coord = topology.get_coord(rank)
        names = topology.get_hybrid_group_names()
        self._dp_degree = topology.get_dim("data")
        self._pp_degree = topology.get_dim("pipe")
        self._sharding_degree = topology.get_dim("sharding")
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1
        self._mp_degree = topology.get_dim("model")
        self._dp_rank = coord["data"]
        self._pp_rank = coord["pipe"]
        self._sharding_rank = coord["sharding"]
        self._sep_rank = coord.get("sep", 0)
        self._mp_rank = coord["model"]

        live = dist.is_initialized()
        if live and dist.get_world_size() != topology.world_size():
            raise ValueError(
                f"the topology spans {topology.world_size()} ranks but the "
                f"world has {dist.get_world_size()}")
        self._live = live and topology.world_size() > 1

        self._dp_group = self._make_group(["data"], "dp")
        self._pp_group = self._make_group(["pipe"], "pp")
        self._sharding_group = self._make_group(["sharding"], "sharding")
        self._sep_group = self._make_group(["sep"], "sep") \
            if "sep" in names else None
        self._mp_group = self._make_group(["model"], "mp")
        # the JAX package's check group: the mp ranks and the pp ranks
        self._check_group = self._mp_group if self._pp_degree == 1 else \
            Group(sorted(set(self._mp_group.ranks) |
                         set(self._pp_group.ranks)), axis_name=("pp", "mp"))
        self._data_group = self._make_group(["data", "sharding"],
                                            ("dp", "sharding"))

    def _make_group(self, axes, axis_name) -> Group:
        """This rank's group along ``axes``; with a live world every rank
        makes every slice's process group, in the same order."""
        mine = None
        for ranks in self._topo.get_fused_comm_list(axes):
            if self._live:
                g = new_group(ranks, axis_name=axis_name)
            else:
                g = Group(ranks, axis_name=axis_name)
            if self.global_rank in ranks:
                mine = g
        return mine

    # -- accessors ----------------------------------------------------------
    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    def get_parallel_mode(self):
        """"data" when only the data axis is split, "sharding" when the
        sharding axis is (and no model or pipe axis), else "model" /
        "pipeline" (upstream's ParallelMode by name)."""
        if self._pp_degree > 1:
            return "pipeline"
        if self._mp_degree > 1:
            return "model"
        if self._sharding_degree > 1:
            return "sharding"
        return "data"

    # data parallel
    def get_data_parallel_rank(self):
        return self._dp_rank

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._dp_group.ranks[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._mp_rank

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return self._mp_group.ranks[0]

    # pipeline
    def get_stage_id(self):
        return self._pp_rank

    def get_pipe_parallel_rank(self):
        return self._pp_rank

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    def is_first_stage(self):
        return self._pp_rank == 0

    def is_last_stage(self):
        return self._pp_rank == self._pp_degree - 1

    # sharding
    def get_sharding_parallel_rank(self):
        return self._sharding_rank

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return self._sharding_group.ranks[0]

    # sep (sequence / context parallel)
    def get_sep_parallel_rank(self):
        return self._sep_rank

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_group(self):
        return self._sep_group

    def get_check_parallel_group(self, sharding=False):
        return self._check_group

    def get_rank_from_stage(self, stage_id, **kwargs):
        coord = self._topo.get_coord(self.global_rank)
        coord["pipe"] = stage_id
        coord.update(kwargs)
        return self._topo.get_rank(**coord)

    # the batch replicas: data x sharding
    def _get_data_group(self):
        return self._data_group

    def _data_rank(self):
        """This rank's replica index: data-major over data x sharding."""
        return self._dp_rank * self._sharding_degree + self._sharding_rank


def _set_hybrid_parallel_group(hcg: Optional[HybridCommunicateGroup]):
    """Register ``hcg`` (the one registry: ``collective.set_mesh``)."""
    from ... import collective as coll
    coll.set_mesh(hcg)


def _get_hybrid_parallel_group() -> Optional[HybridCommunicateGroup]:
    from ... import collective as coll
    return coll.get_mesh()
