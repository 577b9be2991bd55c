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

The explicit dp path (the JAX ``_dp_explicit_step_math``), on when
``dp_compress_bits`` (0, 8 or 16) or ``dp_shard_update`` is set and dp
> 1, every other axis 1 (the env overrides ``PADDLE_TPU_DP_COMPRESS``
and ``PADDLE_TPU_DP_SHARD_UPDATE`` win over the constructor, with the
JAX names and messages): after the backward each gradient leaf, in
``named_parameters`` order, is

- without the sharded update: summed over dp by
  ``compressed.quantized_all_reduce`` at the wire width (the plain
  all-reduce at 0) and divided by dp; then the usual clip and update;
- with it: reduced and updated by the sharding stage 2 of
  ``fleet/meta_parallel/sharding_parallel.py::ShardedUpdate`` over the
  dp group, at the wire width: every trainable leaf flattened into one
  buffer a dtype, which is reduce-scattered (``ring_reduce_scatter``, or the plain
  reduce-scatter at 0) and divided by dp; the optimizer updates this
  rank's flat chunk of each parameter with only that chunk's moments
  (and fp32 master under O2); the global-norm clip's square-sum is
  summed over dp; the updated chunks are all-gathered exactly (never
  quantized), one all-gather a dtype.  The JAX path slices each leaf
  on its first dim that dp divides and reduces a leaf without one
  whole; the port's flat chunks shard every leaf.

Then the loss is the dp mean and float buffers take the dp mean.  The
dropout streams differ by dp rank there (the JAX body folds the rank
into the step's key).  ``dp_allreduce_bytes_total`` /
``dp_compress_ratio`` on the observability registry count the JAX
byte model a step.  ``PipelinedRunner.train_steps_folded`` is refused
(:data:`FOLD_REFUSAL`).
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


def _resolve_dp_knobs(dp_compress_bits, dp_shard_update):
    """``(bits, shard_update)`` after the env overrides; bits in {0, 8,
    16} (the JAX function, its messages)."""
    env_bits = os.environ.get(_DP_COMPRESS_ENV, "").strip().lower()
    if env_bits:
        dp_compress_bits = {"0": 0, "off": 0, "none": 0,
                            "8": 8, "int8": 8,
                            "16": 16, "exact16": 16}.get(env_bits)
        if dp_compress_bits is None:
            raise ValueError(
                f"{_DP_COMPRESS_ENV}={env_bits!r}: expected 0, 8 or 16")
    bits = int(dp_compress_bits or 0)
    if bits not in (0, 8, 16):
        raise ValueError(
            f"dp_compress_bits / DistributedStrategy.quantized_allreduce"
            f" must be 0 (off), 8 (int8 ring) or 16 (exact ring), got "
            f"{dp_compress_bits!r}")
    env_sh = os.environ.get(_DP_SHARD_ENV, "").strip().lower()
    if env_sh:
        if env_sh not in ("0", "1", "true", "false"):
            raise ValueError(
                f"{_DP_SHARD_ENV}={env_sh!r}: expected 0 or 1")
        dp_shard_update = env_sh in ("1", "true")
    return bits, bool(dp_shard_update)


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
        self._dp_compress_bits, self._dp_shard_update = \
            _resolve_dp_knobs(dp_compress_bits, dp_shard_update)
        self._dp_world = hcg.get_data_parallel_world_size()
        self._dp_explicit = bool(
            (self._dp_compress_bits or self._dp_shard_update)
            and self._dp_world > 1)
        self.optimizer = optimizer
        self.hcg = hcg
        self._validate_dp_knobs()
        if input_specs:
            raise NotImplementedError(
                "input_specs: every input is split on its batch dim over "
                "the data group in the port")
        self.network = network
        self.loss_fn = loss_fn
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
        named = list(network.named_parameters())
        if optimizer._param_names is None and \
                len(optimizer._params) == len(named):
            # the optimizer's slots by parameter name, as the JAX runner's
            # state tree keys them (the checkpoint reads them so)
            optimizer.set_param_names([n for n, _ in named])
        self._data = data
        self._dp_gen = None
        if self._dp_explicit:
            self._dp_group = hcg.get_data_parallel_group()
            self._fold_rank_into_dropout()
        if self._dp_explicit and self._dp_shard_update:
            # the sharded weight update: stage 2 over the dp group
            self._update = HybridUpdate(
                named, optimizer, data, hcg.get_model_parallel_group(),
                self._dp_group, hcg.get_sharding_parallel_group(), 2,
                wire_bits=self._dp_compress_bits, generator=self._dp_gen)
        else:
            self._update = HybridUpdate.from_hcg(named, optimizer, hcg,
                                                 self.sharding_stage)
        self._compute_dp_comm_info(named)

    def _validate_dp_knobs(self):
        """Refuse, never drop, a dp knob the explicit path cannot honour
        (the JAX checks and messages)."""
        if not (self._dp_compress_bits or self._dp_shard_update):
            return
        hcg = self.hcg
        sizes = {"mp": hcg.get_model_parallel_world_size(),
                 "pp": hcg.get_pipe_parallel_world_size(),
                 "sep": hcg.get_sep_parallel_world_size(),
                 "sharding": hcg.get_sharding_parallel_world_size()}
        busy = {ax: n for ax, n in sizes.items() if n > 1}
        if busy:
            raise ValueError(
                "quantized_allreduce / sharded_weight_update run the "
                "step through an explicit shard_map over the dp axis "
                "and currently require every other mesh axis to be "
                f"size 1; got {busy}.  Use the implicit path (knobs "
                "off) for hybrid dp x mp/pp/sep/ZeRO meshes.")
        if self._dp_shard_update and self._dp_world > 1:
            clip = getattr(self.optimizer, "_grad_clip", None)
            if clip is not None and hasattr(clip, "pure_clip"):
                from ..nn.clip_grad import (ClipGradByGlobalNorm,
                                            ClipGradByValue)
                if not isinstance(clip, (ClipGradByGlobalNorm,
                                         ClipGradByValue)):
                    raise ValueError(
                        "sharded_weight_update supports "
                        "ClipGradByGlobalNorm (cross-shard psum of the "
                        "norm) and ClipGradByValue (elementwise); got "
                        f"{type(clip).__name__}")

    def _fold_rank_into_dropout(self):
        """Per-replica dropout streams (the JAX body folds the dp rank
        into the step's key): this rank's generator of the model's
        device reseeded from its own seed and the dp rank."""
        from ..framework import random as _random
        r = self.hcg.get_data_parallel_rank()
        if r:
            gen = _random.default_generator(self._device())
            gen.manual_seed(gen.initial_seed() + 1000003 * r)
        self._dp_gen = torch.Generator(device=self._device())
        self._dp_gen.manual_seed(0x51ED5EED + r)

    def _compute_dp_comm_info(self, named):
        """The JAX byte model (``compressed.dp_comm_bytes_per_step`` per
        leaf, every leaf sharded under the sharded update): modeled dp
        bytes a rank a step and the ratio to the plain all-reduce's."""
        from .compressed import dp_comm_bytes_per_step
        w = self._dp_world
        self._dp_comm_info = None
        if w <= 1:
            return
        bits = self._dp_compress_bits if self._dp_explicit else 0
        sharded = self._dp_explicit and self._dp_shard_update
        n_elems = bytes_step = 0
        for _, p in named:
            if not p.requires_grad:
                continue
            leaf = p.numel()
            n_elems += leaf
            bytes_step += dp_comm_bytes_per_step(leaf, w, bits, sharded)
        baseline = dp_comm_bytes_per_step(n_elems, w, 0, False)
        self._dp_comm_info = {
            "bytes_per_step": bytes_step,
            "ratio": (baseline / bytes_step) if bytes_step else 1.0,
            "grad_elems": n_elems}

    def _observe_dp_comm(self, n_steps: int):
        info = self._dp_comm_info
        if not info:
            return
        from ..observability import metrics as _obs_metrics
        reg = _obs_metrics.registry()
        reg.counter(
            "dp_allreduce_bytes_total",
            "modeled per-device bytes moved over the dp axis by the "
            "gradient path (reduce-scatter + all-gather wire bytes)"
            ).inc(info["bytes_per_step"] * n_steps)
        reg.gauge(
            "dp_compress_ratio",
            "uncompressed-allreduce bytes / actual dp gradient-path "
            "bytes (1.0 = no compression)").set(info["ratio"])

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

    def _amp(self):
        """A fresh ``auto_cast`` context for each forward (recompute runs
        the forward a second time in backward)."""
        if not self.amp_level:
            return contextlib.nullcontext()
        from ..amp import auto_cast
        return auto_cast(level=self.amp_level, dtype=self.amp_dtype)

    def _forward_loss(self, xs, ys):
        def loss_of(*xs):
            with self._amp():
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
        if self._dp_explicit:
            self._explicit_update()
        else:
            self._update.step(reduce=True)
        for _, p in self._update.named:
            p.grad = None
        self._observe_dp_comm(1)
        all_reduce(total, group=self._data)
        if self._sep is not None:
            all_reduce(total, group=self._sep)
            n *= self._sep.nranks
        return float(total) / (self.accumulate_steps * n)

    @torch.no_grad()
    def _explicit_update(self):
        """The explicit dp update (module docstring)."""
        w = self._dp_world
        if self._update.sharded is None:
            from .compressed import quantized_all_reduce
            for _, p in self._update.named:
                if p.grad is not None:
                    p.grad = quantized_all_reduce(
                        p.grad, self._dp_group, bits=self._dp_compress_bits,
                        generator=self._dp_gen) / w
            self._update.step(reduce=False)
        else:
            self._update.step(reduce=True)
        for b in self.network.buffers():
            if b.is_floating_point():
                all_reduce(b, group=self._dp_group)
                b.div_(w)

    def sync_to_layers(self):
        """The layers hold the whole parameters again (stage 3 gathers
        them; the other stages always do)."""
        materialize_params(self.network)

    def optimizer_state_bytes(self) -> int:
        """Bytes of this rank's optimizer state tensors (a quarter of the
        whole at dp4 under the sharded update)."""
        return sum(v.numel() * v.element_size()
                   for st in self.optimizer._state.values()
                   for v in st.values() if isinstance(v, torch.Tensor))


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
