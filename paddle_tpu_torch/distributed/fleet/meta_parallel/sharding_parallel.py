"""ZeRO stages (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sharding_parallel.py``:
``GroupShardedStage2``, ``GroupShardedStage3``,
``GroupShardedOptimizerStage2``; upstream ``fleet/meta_parallel/
sharding/``).

The JAX package places state, gradients and parameters with a
``sharding`` PartitionSpec and lets XLA emit the collectives.  Here
:class:`ShardedUpdate` does it by hand over the sharding group: each
trainable parameter is flattened, padded to a multiple of the group's
rank count and cut into one equal chunk a rank; the optimizer updates
only this rank's chunks (its moments and fp32 masters are chunk-sized),
then the updated chunks are all-gathered into the parameters.

- stage 1 (``os``): the gradients arrive averaged over the whole data
  group; each rank takes its chunks of them;
- stage 2 (``os_g``): the gradients are reduce-scattered over the
  sharding group (one flat buffer per dtype), all-reduced over the dp
  group, then divided by the data group's rank count; at a wire width
  (``wire_bits`` 8 or 16) the reduce-scatter is the encoded ring of
  ``distributed/compressed.py`` (``DistributedRunner``'s sharded weight
  update runs stage 2 over the dp group so);
- stage 3 (``p_g_os``): stage 2, and between steps each rank keeps only
  its chunks: ``release()`` empties the parameters after the update and
  ``materialize()`` gathers them before the next forward.

Padding is zero and stays zero (a zero gradient moves no moment), so it
adds nothing to a norm.  Each chunk carries its place in the whole
parameter (``_global_layout``, a flat range of the parameter's layout),
so the optimizer's ``state_dict()`` and the distributed checkpoint
present its moments as slices of the whole-shape tensors.
"""

from __future__ import annotations

import math

import torch

from ....nn.param_attr import Parameter
from ...parallel import LayerWrapper
from ...checkpoint.layout import param_layout
from .mp_layers import is_mp_split


class ShardedUpdate:
    """Chunks of ``named_params`` (trainable ones) owned by this rank of
    ``group``; ``optimizer`` is rebound to them (module docstring)."""

    def __init__(self, named_params, optimizer, group, dp_group, stage,
                 wire_bits=0, generator=None):
        from ...communication import get_group
        self.group = get_group(group)
        self.dp_group = dp_group
        self.stage = int(stage)
        self.wire_bits = int(wire_bits)
        self.generator = generator
        n = self.group.nranks
        r = max(self.group.rank, 0)
        self.entries = []
        shards, names = [], []
        for name, p in named_params:
            if not p.requires_grad:
                continue
            numel = p.numel()
            chunk = math.ceil(numel / n)
            flat = torch.zeros(chunk * n, dtype=p.dtype, device=p.device)
            flat[:numel] = p.detach().reshape(-1)
            shard = Parameter(flat[r * chunk:(r + 1) * chunk].clone(),
                              name=getattr(p, "name", None) if isinstance(
                                  getattr(p, "name", None), str) else name)
            shard.optimize_attr = dict(getattr(p, "optimize_attr", None)
                                       or {"learning_rate": 1.0})
            shard.regularizer = getattr(p, "regularizer", None)
            shard.is_distributed = is_mp_split(p)
            shard._global_layout = param_layout(p).flat_range(
                r * chunk, min(numel, (r + 1) * chunk), local_len=chunk)
            self.entries.append((name, p, numel, chunk, shard,
                                 tuple(p.shape)))
            p._sharded_owner = self
            shards.append(shard)
            names.append(name)
        optimizer._params = shards
        optimizer._param_names = names
        optimizer._state = {}
        self.optimizer = optimizer
        self._released = False

    @property
    def shards(self):
        return [e[4] for e in self.entries]

    def _buckets(self):
        by = {}
        for e in self.entries:
            by.setdefault(e[1].dtype, []).append(e)
        return by

    @torch.no_grad()
    def reduce_grads(self, data_group, data_ranks):
        """Each shard's ``grad``: this rank's chunk of the gradient
        averaged over ``data_group`` (``data_ranks`` ranks)."""
        from ...communication import all_reduce, reduce_scatter
        from ...compressed import ring_reduce_scatter
        n = self.group.nranks
        r = max(self.group.rank, 0)
        for dtype, ents in self._buckets().items():
            rows = []
            for _, p, numel, chunk, _, _ in ents:
                g = torch.zeros(chunk * n, dtype=dtype, device=p.device)
                if p.grad is not None:
                    g[:numel] = p.grad.reshape(-1)
                rows.append(g.view(n, chunk))
            full = torch.cat(rows, dim=1)
            if self.stage == 1:
                all_reduce(full, group=data_group)
                mine = full[r]
            elif self.wire_bits:
                # the encoded ring: this rank's row of the sum
                mine = ring_reduce_scatter(
                    full, self.group, 0, bits=self.wire_bits,
                    generator=self.generator).reshape(-1)
                all_reduce(mine, group=self.dp_group)
            else:
                # the JAX form: ``full`` (one row a rank) becomes its row
                reduce_scatter(full, group=self.group)
                mine = full.reshape(-1)
                all_reduce(mine, group=self.dp_group)
            mine.div_(data_ranks)
            off = 0
            for _, p, _, chunk, shard, _ in ents:
                shard.grad = mine[off:off + chunk].clone()
                off += chunk

    def _gather(self, chunk_of):
        """``(entry, whole flat value)`` for every parameter, from the
        chunk ``chunk_of(entry)`` of every rank (one all-gather per
        dtype)."""
        from ...communication import all_gather
        for dtype, ents in self._buckets().items():
            mine = torch.cat([chunk_of(e).reshape(-1).to(dtype)
                              for e in ents])
            rows = []
            all_gather(rows, mine, self.group)
            full = torch.stack(rows)
            off = 0
            for e in ents:
                chunk = e[3]
                yield e, full[:, off:off + chunk].reshape(-1)[:e[2]]
                off += chunk

    @torch.no_grad()
    def gather_params(self):
        """Every parameter from the updated chunks of every rank."""
        for (_, p, _, _, _, shape), value in self._gather(
                lambda e: e[4].detach()):
            if self._released:
                p.data = value.view(shape).clone()
            else:
                p.data.copy_(value.view(shape))
        self._released = False

    @torch.no_grad()
    def gather_grads(self) -> dict:
        """``{name: gradient}``: the whole reduced gradients, joined from
        every rank's chunk gradients (after :meth:`reduce_grads`)."""
        return {e[0]: value.view(e[5]).clone() for e, value in self._gather(
            lambda e: e[4].grad)}

    @torch.no_grad()
    def refresh_shards(self):
        """Each chunk from its (whole) parameter, after the parameters
        were written from outside (a checkpoint load)."""
        r = max(self.group.rank, 0)
        for _, p, numel, chunk, shard, _ in self.entries:
            flat = p.detach().reshape(-1)
            lo, hi = min(r * chunk, numel), min((r + 1) * chunk, numel)
            shard.zero_()
            shard[:hi - lo].copy_(flat[lo:hi])

    def release(self):
        """Stage 3: drop the gathered parameters until
        :meth:`materialize`."""
        for _, p, _, _, _, _ in self.entries:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            p.grad = None
        self._released = True

    def materialize(self):
        if self._released:
            self.gather_params()

    def clear_shard_grads(self):
        for e in self.entries:
            e[4].grad = None


def materialize_params(layer):
    """Gather the released (stage-3) parameters of ``layer`` before its
    forward."""
    owners = {id(o): o for o in (getattr(p, "_sharded_owner", None)
                                 for p in layer.parameters())
              if o is not None}
    for owner in owners.values():
        owner.materialize()


def _sharding_group(group):
    """``group``, else the registered topology's sharding group, else
    the world's."""
    from ..base.topology import _get_hybrid_parallel_group
    from ...communication import get_group
    hcg = _get_hybrid_parallel_group()
    if group is None and hcg is not None:
        return hcg.get_sharding_parallel_group()
    return get_group(group)


class GroupShardedOptimizerStage2:
    """The optimizer of a sharded model (``group_sharded_parallel``): its
    ``step`` is the hybrid update (``meta_optimizers/
    dygraph_optimizer.py::HybridUpdate``) with a sharded update of
    ``stage`` over ``group`` (the registered topology's sharding group,
    else the world)."""

    def __init__(self, params, optim, group=None, offload=False,
                 device="gpu", stage=2, **kwargs):
        if offload:
            raise NotImplementedError("offload: the optimizer state stays "
                                      "on the rank's device in the port")
        self._optim = optim
        self._params = list(params)
        self._group = group
        self._stage = stage
        self._network = None
        self._update = None

    def __getattr__(self, item):
        return getattr(self.__dict__["_optim"], item)

    def _hybrid_update(self):
        from ..base.topology import _get_hybrid_parallel_group
        from ..meta_optimizers.dygraph_optimizer import HybridUpdate
        from ...communication import Group
        if self._update is None:
            named = (list(self._network.named_parameters())
                     if self._network is not None else
                     [(f"param_{i}", p) for i, p in enumerate(self._params)])
            hcg = _get_hybrid_parallel_group()
            if self._group is None and hcg is not None:
                self._update = HybridUpdate.from_hcg(named, self._optim, hcg,
                                                     self._stage)
            else:
                g = _sharding_group(self._group)
                self._update = HybridUpdate(named, self._optim, g, None, g,
                                            Group([g.ranks[0]]), self._stage)
        return self._update

    def step(self):
        self._hybrid_update().step()

    def clear_grad(self, set_to_zero=False):
        for _, p in self._hybrid_update().named:
            p.grad = None

    clear_gradients = clear_grad


class GroupShardedStage2(LayerWrapper):
    """A model under stage 2: its optimizer (a
    :class:`GroupShardedOptimizerStage2`) updates chunks after a
    reduce-scatter of the gradients (module docstring)."""

    _stage = 2

    def __init__(self, layer, sharding_optimizer, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23, **kwargs):
        super().__init__()
        from ...parallel import sync_params_buffers
        self._layers = layer
        self._sharding_optimizer = sharding_optimizer
        if sharding_optimizer is not None:
            sharding_optimizer._stage = self._stage
            sharding_optimizer._network = layer
        sync_params_buffers(layer, _sharding_group(group))

    def forward(self, *inputs, **kwargs):
        materialize_params(self._layers)
        return self._layers(*inputs, **kwargs)


class GroupShardedStage3(GroupShardedStage2):
    _stage = 3

    def __init__(self, layer, optimizer=None, group=None,
                 sync_buffers=False, segment_size=2 ** 20, **kwargs):
        super().__init__(layer, optimizer, group, sync_buffers)

    def get_all_parameters(self, convert2cpu=False):
        return self._layers.parameters()
