"""``DistributedRunner`` (counterpart of ``paddle_tpu/distributed/runner.py``).

The JAX runner compiles one SPMD step over the mesh.  The port runs an
eager step on every rank, each with its part of the model and of the
batch:

- ``train_step(inputs, labels)`` takes the **global** batch, as the JAX
  one does, and each rank takes its rows: the batch is split over the
  data group (dp x sharding, dp-major, the JAX ``("dp", "sharding")``
  batch axis); with ``accumulate_steps = k`` the global batch is cut
  into ``k`` microbatches first (the JAX scan's order) and the gradients
  of the microbatch losses averaged;
- the forward runs under ``auto_cast(amp_level, amp_dtype)`` when
  ``amp_level`` is set (O2's parameter cast is ``amp.decorate``'s, up
  front), and under ``recompute`` when ``remat``;
- the update is ``fleet/meta_optimizers/dygraph_optimizer.py::
  HybridUpdate``: gradients averaged over the data group (or reduced
  into chunks at ``sharding_stage`` 1-3), the hybrid global-norm clip,
  the optimizer, the chunks gathered;
- the loss returned is the global batch's mean (all-reduced over the
  data group), the same float on every rank;
- at sep > 1 (context parallel, the JAX ``_data_pspecs``): each rank
  takes its contiguous slice of the sequence (dim 1) of its rows, of
  every input and label whose dim 1 divides by sep; the model built
  under the topology attends over the sep group with global positions
  (``models/gpt.py``); the gradients are averaged over the sep group
  before the data group (each rank's loss is the mean over its slice,
  so the sum over sep of the slices' gradients over sep is the
  gradient of the global token mean), and the loss is averaged over
  both.

Every rank starts from the same weights: the parameters not split over
mp from the mp group's first rank, then all from the data group's first
rank.  At pp > 1 the model is a ``PipelineLayer`` trained by
``PipelinedRunner`` (the pipeline engine's runner duck-type, below).
Refused, each with the ROADMAP item that brings it: the compressed dp
knobs (``dp_compress_bits``, ``dp_shard_update`` and their env
overrides) and ``PipelinedRunner.train_steps_folded``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np
import torch

from . import collective as coll
from .communication import all_reduce
from .fleet.base.topology import CommunicateTopology, HybridCommunicateGroup
from .fleet.fleet import COMPRESS_REFUSAL
from .fleet.meta_optimizers.dygraph_optimizer import HybridUpdate
from .fleet.meta_parallel.sharding_parallel import materialize_params
from .fleet.utils.hybrid_parallel_util import broadcast_mp_parameters
from .parallel import get_rank, get_world_size, sync_params_buffers

_DP_COMPRESS_ENV = "PADDLE_TPU_DP_COMPRESS"
_DP_SHARD_ENV = "PADDLE_TPU_DP_SHARD_UPDATE"
FOLD_REFUSAL = (
    "PipelinedRunner.train_steps_folded: the port has no fold engine on a "
    "distributed topology yet; it waits in ROADMAP queue A, item A10 (the "
    "mesh branch of the fold engine with Model.fit's mesh runner)")


def _refuse_compressed(dp_compress_bits, dp_shard_update):
    bits = os.environ.get(_DP_COMPRESS_ENV, "").strip().lower()
    shard = os.environ.get(_DP_SHARD_ENV, "").strip().lower()
    if dp_compress_bits or dp_shard_update or \
            bits not in ("", "0", "off", "none") or \
            shard not in ("", "0", "false"):
        raise NotImplementedError(COMPRESS_REFUSAL)


def _default_hcg():
    world = get_world_size()
    return HybridCommunicateGroup(
        CommunicateTopology(dims=[world, 1, 1, 1, 1]), get_rank())


class DistributedRunner:
    def __init__(self, network, optimizer, loss_fn=None, mesh=None,
                 sharding_stage: int = 0, accumulate_steps: int = 1,
                 input_specs=None, amp_level: Optional[str] = None,
                 amp_dtype: str = "bfloat16", capture_outputs: bool = False,
                 remat: bool = False, dp_compress_bits: Optional[int] = None,
                 dp_shard_update: Optional[bool] = None):
        hcg = mesh if mesh is not None else coll.get_mesh()
        if hcg is None:
            hcg = _default_hcg()
        if hcg.get_pipe_parallel_world_size() > 1:
            raise ValueError(
                "DistributedRunner runs pp 1; at pp > 1 train a "
                "PipelineLayer through PipelinedRunner (or "
                "fleet.distributed_model(...).train_batch)")
        _refuse_compressed(dp_compress_bits, dp_shard_update)
        if input_specs:
            raise NotImplementedError(
                "input_specs: every input is split on its batch dim over "
                "the data group in the port")
        self.network = network
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.hcg = hcg
        self.sharding_stage = int(sharding_stage)
        self.accumulate_steps = max(int(accumulate_steps), 1)
        self.amp_level = amp_level
        self.amp_dtype = amp_dtype
        self.capture_outputs = capture_outputs
        self.remat = bool(remat)
        self.last_outputs = None
        broadcast_mp_parameters(network, hcg)
        data = hcg._get_data_group()
        sync_params_buffers(network, data, data.ranks[0])
        self._sep = hcg.get_sep_parallel_group() \
            if hcg.get_sep_parallel_world_size() > 1 else None
        if self._sep is not None:
            sync_params_buffers(network, self._sep, self._sep.ranks[0])
        self._update = HybridUpdate.from_hcg(
            list(network.named_parameters()), optimizer, hcg,
            self.sharding_stage)
        self._data = data

    # -- the step -----------------------------------------------------------
    def _device(self):
        return next(iter(self.network.parameters())).device

    def _rows(self, arrays, lo, hi, device):
        """Rows ``lo:hi`` of each array; at sep > 1 this rank's slice of
        dim 1 where it divides by sep."""
        out = []
        for a in arrays:
            t = getattr(a, "_value", a)
            t = t if isinstance(t, torch.Tensor) else torch.as_tensor(
                np.asarray(t))
            t = t[lo:hi]
            sep = self._sep
            if sep is not None and t.dim() >= 2 and \
                    t.shape[1] % sep.nranks == 0:
                k = t.shape[1] // sep.nranks
                t = t[:, sep.rank * k:(sep.rank + 1) * k]
            out.append(t.to(device))
        return out

    def _forward_loss(self, xs, ys):
        amp = contextlib.nullcontext()
        if self.amp_level:
            from ..amp import auto_cast
            amp = auto_cast(level=self.amp_level, dtype=self.amp_dtype)

        def loss_of(*xs):
            with amp:
                out = self.network(*xs)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            loss = self.loss_fn(*outs, *ys) if self.loss_fn is not None \
                else outs[0]
            if self.capture_outputs:
                self.last_outputs = [o.detach() for o in outs]
            return loss

        if self.remat:
            from .fleet.recompute import recompute
            return recompute(loss_of, *xs)
        return loss_of(*xs)

    def _split(self, inputs, labels):
        inputs, labels = list(inputs), list(labels)
        b = int(inputs[0].shape[0])
        n = self._data.nranks
        acc = self.accumulate_steps
        if b % (acc * n):
            raise ValueError(f"global batch {b} does not split into "
                             f"{acc} microbatches over {n} data ranks")
        return inputs, labels, b // acc, self.hcg._data_rank(), n

    def train_step(self, inputs, labels) -> float:
        inputs, labels, mb, r, n = self._split(inputs, labels)
        materialize_params(self.network)
        self.network.train()
        device = self._device()
        part = mb // n
        total = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(self.accumulate_steps):
            lo = i * mb + r * part
            xs = self._rows(inputs, lo, lo + part, device)
            ys = self._rows(labels, lo, lo + part, device)
            loss = self._forward_loss(xs, ys)
            (loss / self.accumulate_steps).backward()
            total += loss.detach().float()
        self._update.step(reduce=True)
        for _, p in self._update.named:
            p.grad = None
        all_reduce(total, group=self._data)
        if self._sep is not None:
            all_reduce(total, group=self._sep)
            n *= self._sep.nranks
        return float(total) / (self.accumulate_steps * n)

    def sync_to_layers(self):
        """The layers hold the whole parameters again (stage 3 gathers
        them; the other stages always do)."""
        materialize_params(self.network)


class _PipeStrategy:
    """The strategy a runner-built pipeline engine reads."""

    def __init__(self, pipeline_configs):
        self.pipeline_configs = pipeline_configs


class PipelinedRunner:
    """The runner duck-type over the pipeline engine
    (``fleet.meta_parallel.pipeline_parallel.PipelineParallel``), the JAX
    ``PipelinedRunner``'s: ``train_step`` / ``eval_step`` /
    ``sync_to_layers`` / ``compile_stats``.  ``accumulate_steps`` is the
    schedule's micro-batch count; ``pipeline_configs`` pass through
    (``remat_stage`` from ``remat`` where the caller left it unset).
    ``amp_level`` warns and trains in the parameters' dtype, as the JAX
    runner does: the engine has no AMP.  ``train_steps_folded`` refuses
    (:data:`FOLD_REFUSAL`)."""

    def __init__(self, network, optimizer, loss_fn=None, mesh=None,
                 accumulate_steps: int = 1, amp_level: Optional[str] = None,
                 amp_dtype: str = "bfloat16", remat: Optional[bool] = None,
                 pipeline_configs: Optional[dict] = None):
        from .fleet.meta_parallel.pipeline_parallel import PipelineParallel
        from .fleet.meta_parallel.pp_layers import PipelineLayer
        if not isinstance(network, PipelineLayer):
            raise TypeError("PipelinedRunner trains a PipelineLayer (e.g. "
                            "GPTForCausalLMPipe), got "
                            f"{type(network).__name__}")
        self.network = network
        self.optimizer = optimizer
        self.mesh = mesh if mesh is not None else coll.get_mesh()
        if self.mesh is None:
            self.mesh = _default_hcg()
        self.accumulate_steps = max(int(accumulate_steps), 1)
        if amp_level:
            import warnings
            warnings.warn(
                "PipelinedRunner: amp_level is not supported by the "
                "pipeline-schedule engine yet; training runs full "
                "precision")
        cfg = dict(pipeline_configs or {})
        cfg["accumulate_steps"] = self.accumulate_steps
        if remat is not None and "remat_stage" not in cfg:
            cfg["remat_stage"] = bool(remat)
        self._engine = PipelineParallel(
            network, self.mesh, _PipeStrategy(cfg), optimizer=optimizer,
            loss_fn=loss_fn)

    def train_step(self, inputs, labels):
        """One train batch through the schedule; returns ``(loss,
        out_vals)``, the last stage's outputs (an empty list on the other
        stages), as the JAX runner's captured step does."""
        return self._engine.train_step(inputs, labels)

    def train_steps_folded(self, groups, metric_fns=(), metric_acc=None):
        raise NotImplementedError(FOLD_REFUSAL)

    def eval_step(self, inputs, labels):
        """The batch's forward and loss; returns ``(loss, out_vals)``."""
        ins = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        lbs = labels[0] if isinstance(labels, (list, tuple)) else labels
        loss = self._engine.eval_batch((ins, lbs), compute_loss=True)
        return float(loss), []

    def sync_to_layers(self):
        self._engine.sync_to_layers()

    def compile_stats(self):
        return self._engine.compile_stats()
