"""The process world (counterpart of ``paddle_tpu/distributed/parallel.py``:
``ParallelEnv``, ``init_parallel_env``, ``DataParallel``).

The env contract is Paddle's: ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_MASTER`` and
``FLAGS_selected_gpus`` (``distributed.spawn`` and the launcher set
them).  ``init_parallel_env`` starts ``torch.distributed`` on it:

- the rank's device is the current place's kind (``set_device``): the
  card ``FLAGS_selected_gpus`` names (else ``rank % cards``), or the
  CPU.  A rank asked for a card that finds none raises;
- the backend is ``PADDLE_DISTRI_BACKEND`` (upstream Paddle's variable)
  when set; otherwise NCCL when every rank has a card of its own and
  gloo when ranks share a card or run on the CPU.  NCCL refuses two
  ranks on one card, so that combination raises;
- at world 1 it starts nothing, as the JAX package's does, unless
  ``PADDLE_DISTRI_BACKEND`` asks for a backend (a world of one rank
  over NCCL is the one NCCL world a single card allows).

``DataParallel`` broadcasts the parameters and buffers from the group's
first rank, then averages each gradient over the group at the end of
every backward (``fleet/utils/hybrid_parallel_util.py::
fused_allreduce_gradients``: one flat buffer per dtype, summed, divided
by the rank count); ``no_sync()`` skips it.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from ..nn.layer import Layer


class ParallelEnv:
    """Reads the Paddle launch env contract."""

    def __init__(self):
        self._rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        sel = os.environ.get("FLAGS_selected_gpus", "")
        self._device_id = int(sel.split(",")[0]) if sel else 0
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints = eps.split(",") if eps else []
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT",
                                                "")

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def device_id(self):
        return self._device_id

    @property
    def local_rank(self):
        return self._rank

    @property
    def nranks(self):
        return self._world_size

    @property
    def trainer_endpoints(self):
        return self._trainer_endpoints

    @property
    def current_endpoint(self):
        return self._current_endpoint

    @property
    def dev_id(self):
        return self._device_id


_parallel_env_initialized = [False]


def _choose(env: ParallelEnv):
    """(backend, device) for this rank (module docstring)."""
    from ..places import _expected_place, set_device
    asked = os.environ.get("PADDLE_DISTRI_BACKEND", "").strip().lower()
    if _expected_place().is_cpu_place():
        if asked and asked != "gloo":
            raise ValueError(f"PADDLE_DISTRI_BACKEND={asked!r} on the CPU: "
                             "only gloo runs there")
        return "gloo", torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {env.rank}: a card was asked for (the current place is "
            "the GPU) but torch.cuda.is_available() is False; call "
            "paddle.set_device('cpu') to run the world on the CPU")
    cards = torch.cuda.device_count()
    sel = os.environ.get("FLAGS_selected_gpus", "")
    idx = int(sel.split(",")[0]) if sel else env.rank % cards
    device = torch.device("cuda", idx)
    torch.cuda.set_device(device)
    set_device(f"gpu:{idx}")
    backend = asked or ("nccl" if env.world_size <= cards else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"PADDLE_DISTRI_BACKEND={asked!r}: expected nccl "
                         "or gloo")
    if backend == "nccl" and env.world_size > cards:
        raise ValueError(
            f"NCCL refuses two ranks on one card: world {env.world_size} on "
            f"{cards} card(s); set PADDLE_DISTRI_BACKEND=gloo")
    return backend, device


def init_parallel_env():
    """Start the world from the env contract (module docstring); a
    second call returns the same env."""
    env = ParallelEnv()
    if _parallel_env_initialized[0]:
        return env
    asked = os.environ.get("PADDLE_DISTRI_BACKEND", "").strip()
    if env.world_size > 1 or asked:
        backend, device = _choose(env)
        master = os.environ.get("PADDLE_MASTER")
        if not master and env.trainer_endpoints:
            master = env.trainer_endpoints[0]
        if not master:
            raise ValueError("init_parallel_env: set PADDLE_MASTER (or "
                             "PADDLE_TRAINER_ENDPOINTS) to host:port")
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://{master}",
                                rank=env.rank, world_size=env.world_size,
                                **kw)
    from . import communication
    communication._reset_default_group()
    _parallel_env_initialized[0] = True
    return env


def get_rank(group=None) -> int:
    if group is not None:
        return group.get_group_rank(get_rank())
    if dist.is_initialized():
        return dist.get_rank()
    return ParallelEnv().rank


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    if dist.is_initialized():
        return dist.get_world_size()
    return ParallelEnv().world_size


def get_backend(group=None):
    """The backend of ``group`` (the world's when None), or None before
    a world was started."""
    from .communication import get_group
    g = get_group(group)
    return g.backend


def is_initialized() -> bool:
    return _parallel_env_initialized[0]


def sync_params_buffers(model, group=None, src_rank=None,
                        is_model_parallel=False):
    """Broadcast ``model``'s parameters (those not split over the mp
    group when ``is_model_parallel``) and buffers from ``src_rank`` (the
    group's first rank when None)."""
    from .communication import broadcast, get_group
    from .fleet.meta_parallel.mp_layers import is_mp_split
    g = get_group(group)
    if g.nranks <= 1:
        return
    src = g.ranks[0] if src_rank is None else src_rank
    with torch.no_grad():
        for p in model.parameters():
            if is_model_parallel and is_mp_split(p):
                continue
            broadcast(p.data, src=src, group=g)
        for b in model.buffers():
            broadcast(b, src=src, group=g)


class LayerWrapper(Layer):
    """A layer around ``self._layers`` whose names and state dict are
    the wrapped layer's (no ``_layers.`` prefix), as the JAX wrappers
    delegate them."""

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, *, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        if not rec:
            return iter(())
        return self._layers.named_parameters(
            prefix, True, remove_duplicate)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)


class DataParallel(LayerWrapper):
    """``paddle.DataParallel`` (module docstring)."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        from .communication import get_group
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self._grad_sync_enabled = True
        self._group = get_group(group)
        self._queued = False
        if self._group.nranks > 1:
            sync_params_buffers(layers, self._group)
            for p in layers.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._on_grad)

    def _on_grad(self, _param):
        if self._grad_sync_enabled and not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._sync)

    def _sync(self):
        from .fleet.utils.hybrid_parallel_util import allreduce_mean
        self._queued = False
        allreduce_mean(list(self._layers.parameters()), self._group)

    @contextlib.contextmanager
    def no_sync(self):
        prev = self._grad_sync_enabled
        self._grad_sync_enabled = False
        try:
            yield
        finally:
            self._grad_sync_enabled = prev
