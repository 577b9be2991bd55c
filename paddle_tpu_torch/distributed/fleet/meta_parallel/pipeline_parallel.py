"""Pipeline parallelism (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``;
upstream ``fleet/meta_parallel/pipeline_parallel.py``).

The JAX package compiles the whole schedule into one SPMD program: a
GPipe tick loop over stacked stages, with the embedding and the head
replicated outside it.  The port runs one process per stage, each
holding its stage's layers only (``pp_layers.PipelineLayer``), and moves
activations forward and gradients back over the pipe group with the
port's ``isend`` / ``irecv`` (host-staged on gloo over CUDA tensors):

- :func:`pipeline_spmd` / :func:`pipeline_spmd_interleaved`: the JAX
  functional forms.  Each rank passes its own stage's parameters (its
  ``V`` chunks, virtual stage ``v * P + d`` in slot ``v``, for the
  interleaved form); the micro-batches go through the stages in order,
  the last stage's outputs reach every rank, and an autograd
  ``Function`` runs the reverse sweep (each stage recomputed when
  ``remat_stage``).  Every rank's loss is the same, and a replicated
  input's gradient reaches every rank;
- :func:`split_pipeline_sections`: the JAX pre / uniform body / post
  split and its checks;
- :class:`PipelineParallel`: the engine behind
  ``fleet.distributed_model(PipelineLayer).train_batch``.

The engine, per ``train_batch((x, y), optimizer)``:

- the batch is cut into ``accumulate_steps`` micro-batches on dim 0 and
  each micro-batch's rows over the data group (dp x sharding,
  data-major), as the JAX engine's ``dspec`` splits them;
- the schedule is 1F1B (upstream's, PipeDream-flush): stage ``s`` runs
  ``P - s - 1`` forwards ahead, then one forward and one backward in
  turn, then the remaining backwards; a stage holds at most ``P - s``
  micro-batches' activations, and the last stage one micro-batch's
  logits.  Every send is posted without waiting and every receive
  waited on, so no stage waits on a send; the gradients accumulate in
  the order 0..M-1 on every stage;
- with ``remat_stage`` (default on, as in the JAX engine) the stage's
  run of body layers is recomputed in its backward
  (``fleet.recompute``); the first stage's embedding and the last
  stage's head run outside it, as the JAX engine runs them outside the
  tick loop;
- the loss is the mean over the whole batch's tokens (each micro-batch
  loss over ``M``, the data group averaged), broadcast from the last
  stage, so every rank returns it as a Paddle ``Tensor``;
- the update (``HybridUpdate``): the gradients averaged over the data
  group, the copies of a weight two stages share (GPT's tied word
  embedding) summed over each (first, last) pair, the global-norm clip
  summed over mp and pp with the shared weight counted once, the
  optimizer.  Both copies take the same update and stay bit-equal.

At pp 1 the engine runs the micro-batch loop inline on the whole model
(``PipelineLayer.forward``, with its ``recompute_interval``), as the JAX
engine's ``_train_batch_inline`` does.  There is no AMP in the engine,
as there is none in the JAX engine: it trains in the parameters' dtype.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree

from ...communication import all_reduce, broadcast, irecv, isend, new_group
from ...parallel import sync_params_buffers
from ..recompute import recompute
from .pp_layers import (LayerDesc, PipelineLayer,  # noqa: F401
                        SharedLayerDesc)

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32]
_META_LEN = 8


def _group_of(group):
    if group is not None:
        return group
    from ... import collective as coll
    hcg = coll.get_mesh()
    return None if hcg is None else hcg.get_pipe_parallel_group()


def _rank_of(group, i):
    return group.ranks[i % group.nranks]


# ---------------------------------------------------------------------------
# the functional forms
# ---------------------------------------------------------------------------
class _Sweep(torch.autograd.Function):
    """Micro-batches through virtual stages ``chunks`` of this rank (slot
    ``v`` runs virtual stage ``v * P + d``), the last one's outputs on
    every rank; backward runs the reverse sweep (module docstring)."""

    @staticmethod
    def forward(ctx, x_micro, spec, stage_fn, group, V, remat, *leaves):
        P, d = group.nranks, group.rank
        S = P * V
        chunks = [_pytree.tree_unflatten(list(leaves[v * len(leaves) // V:
                                                     (v + 1) * len(leaves)
                                                     // V]), spec)
                  for v in range(V)]
        M = x_micro.shape[0]
        saved, outs, pending = {}, [], []
        for m in range(M):
            h = x_micro[m]
            for k in range(S):
                if k % P != d:
                    continue
                if k > 0:
                    h = torch.empty_like(x_micro[m])
                    irecv(h, src=_rank_of(group, k - 1), group=group).wait()
                with torch.enable_grad() if not remat else \
                        torch.no_grad():
                    inp = h.detach().requires_grad_(not remat)
                    y = stage_fn(chunks[k // P], inp)
                saved[(m, k)] = (inp, None if remat else y)
                if k < S - 1:
                    pending.append(isend(y.detach(),
                                         dst=_rank_of(group, k + 1),
                                         group=group))
                else:
                    outs.append(y.detach())
        for t in pending:
            t.wait()
        last = _rank_of(group, S - 1)
        out = torch.stack(outs) if outs else torch.empty_like(x_micro)
        broadcast(out, src=last, group=group)
        ctx.saved = saved
        ctx.spec, ctx.stage_fn, ctx.group, ctx.V = spec, stage_fn, group, V
        ctx.remat, ctx.M = remat, M
        ctx.save_for_backward(*leaves)
        return out

    @staticmethod
    def backward(ctx, g_out):
        group, V, M = ctx.group, ctx.V, ctx.M
        P, d = group.nranks, group.rank
        S = P * V
        leaves = list(ctx.saved_tensors)
        if ctx.remat:
            leaves = [t.detach().requires_grad_(t.requires_grad)
                      for t in leaves]
        n = len(leaves) // V
        chunks = [_pytree.tree_unflatten(leaves[v * n:(v + 1) * n],
                                         ctx.spec) for v in range(V)]
        grads = [None] * len(leaves)
        dx = torch.zeros_like(g_out)
        pending = []
        for m in range(M):
            for k in reversed(range(S)):
                if k % P != d:
                    continue
                inp, y = ctx.saved.pop((m, k))
                if k == S - 1:
                    g = g_out[m]
                else:
                    g = torch.empty_like(g_out[m])
                    irecv(g, src=_rank_of(group, k + 1), group=group).wait()
                with torch.enable_grad():
                    if y is None:
                        inp = inp.detach().requires_grad_(True)
                        y = ctx.stage_fn(chunks[k // P], inp)
                    wrt = [inp] + [t for t in leaves[(k // P) * n:
                                                     (k // P + 1) * n]
                                   if t.requires_grad]
                    got = torch.autograd.grad(y, wrt, g, allow_unused=True)
                j = 0
                for i in range((k // P) * n, (k // P + 1) * n):
                    if leaves[i].requires_grad:
                        gi = got[1 + j]
                        j += 1
                        if gi is not None:
                            grads[i] = gi if grads[i] is None \
                                else grads[i] + gi
                if k > 0:
                    pending.append(isend(got[0], dst=_rank_of(group, k - 1),
                                         group=group))
                else:
                    dx[m] = got[0]
        for t in pending:
            t.wait()
        broadcast(dx, src=_rank_of(group, 0), group=group)
        return (dx, None, None, None, None, None, *grads)


def _sweep(stage_fn, chunks, x_micro, group, remat):
    leaves, spec = [], None
    for c in chunks:
        flat, spec = _pytree.tree_flatten(c)
        leaves += flat
    return _Sweep.apply(x_micro, spec, stage_fn, group, len(chunks), remat,
                        *leaves)


def pipeline_spmd(stage_fn: Callable, stage_params: Any, x_micro,
                  num_stages: int, group=None, remat_stage: bool = True):
    """A uniform pipeline over the pipe group (module docstring).

    ``stage_fn(params, x) -> y`` (the same shape in and out);
    ``stage_params``: this rank's stage's parameters (a tensor or a
    pytree of them); ``x_micro``: ``[num_micro, ...]``, the same on
    every rank.  Returns the last stage's ``[num_micro, ...]`` outputs on
    every rank."""
    group = _group_of(group)
    if group is None or group.nranks == 1:
        if num_stages != 1:
            raise ValueError(f"pipeline_spmd: {num_stages} stages need a "
                             "pipe group of as many ranks")
        return torch.stack([stage_fn(stage_params, x) for x in x_micro])
    if group.nranks != num_stages:
        raise ValueError(f"pipeline_spmd: {num_stages} stages over a pipe "
                         f"group of {group.nranks} ranks")
    return _sweep(stage_fn, [stage_params], x_micro, group,
                  bool(remat_stage))


def pipeline_spmd_interleaved(stage_fn: Callable, stage_params, x_micro,
                              num_stages: int, vpp_degree: int, group=None,
                              remat_stage: bool = True):
    """The interleaved (virtual pipeline) form: ``stage_params`` is this
    rank's ``vpp_degree`` chunks (a sequence; chunk ``v`` is virtual
    stage ``v * num_stages + rank``, the Megatron assignment), and each
    micro-batch runs the ``num_stages * vpp_degree`` virtual stages in
    order, wrapping from the last rank to the first's next chunk."""
    group = _group_of(group)
    chunks = list(stage_params)
    if len(chunks) != vpp_degree:
        raise ValueError(f"pipeline_spmd_interleaved: {len(chunks)} chunks "
                         f"for vpp_degree {vpp_degree}")
    if group is None or group.nranks == 1:
        if num_stages != 1:
            raise ValueError("pipeline_spmd_interleaved: a pipe group of "
                             f"{num_stages} ranks is needed")
        outs = []
        for x in x_micro:
            for c in chunks:
                x = stage_fn(c, x)
            outs.append(x)
        return torch.stack(outs)
    if group.nranks != num_stages:
        raise ValueError(f"pipeline_spmd_interleaved: {num_stages} stages "
                         f"over a pipe group of {group.nranks} ranks")
    return _sweep(stage_fn, chunks, x_micro, group, bool(remat_stage))


# ---------------------------------------------------------------------------
# the sections
# ---------------------------------------------------------------------------
def _type_key(layer):
    """Structural identity of a built layer: type + parameter shapes."""
    shapes = tuple((n, tuple(p.shape))
                   for n, p in sorted(layer.named_parameters()))
    return (type(layer).__name__, shapes)


def _desc_key(d):
    """Structural identity of an item from its description (a rank does
    not build the other stages' layers)."""
    if isinstance(d, LayerDesc):
        return ("desc", d.layer_func, d.inputs,
                tuple(sorted(d.kwargs.items(), key=lambda kv: kv[0])))
    return ("layer", _type_key(d))


def _section_bounds(net, pattern: Optional[str] = None):
    """``(lo, hi)`` of the body (see :func:`split_pipeline_sections`)."""
    descs = net._descs
    layers = [d if isinstance(d, (LayerDesc, torch.nn.Module)) else None
              for d in descs]
    whole = net._stage is None
    if pattern:
        from .pp_layers import _item_name
        idx = [i for i, d in enumerate(layers)
               if d is not None and pattern in (_item_name(d) or "")]
    else:
        def key(i):
            return _type_key(net.run_function[i]) if whole \
                else _desc_key(layers[i])
        best = (0, 0)
        i, n = 0, len(layers)
        while i < n:
            if layers[i] is None:
                i += 1
                continue
            k = key(i)
            j = i
            while j < n and layers[j] is not None and key(j) == k:
                j += 1
            if j - i > best[0]:
                best = (j - i, i)
            i = j
        idx = list(range(best[1], best[1] + best[0])) if best[0] else []
    if not idx:
        raise ValueError(
            "pipeline body not found: no contiguous run of identical "
            "layers to shard over 'pp' (seg_method pattern matched "
            "nothing)")
    lo, hi = idx[0], idx[-1] + 1
    if idx != list(range(lo, hi)):
        raise ValueError(
            "pipeline body must be contiguous; matched layer indices "
            f"{idx} have gaps")
    if whole:
        keys = {_type_key(net.run_function[i]) for i in range(lo, hi)}
    else:
        keys = {repr(_desc_key(layers[i])[:2]) for i in range(lo, hi)}
    if len(keys) != 1:
        raise ValueError(
            "pipeline body layers are not structurally identical: "
            f"{sorted(str(k[0]) for k in keys)}")
    return lo, hi


def split_pipeline_sections(net, pattern: Optional[str] = None):
    """Split a ``PipelineLayer``'s items into ``(pre, body, post)`` (the
    JAX function): ``body`` is the contiguous run of structurally
    identical layers (or of the layers whose class name holds
    ``pattern``), ``pre`` / ``post`` the items around it.  Items are
    ``(layer, fn)`` pairs; a layer another rank builds is None."""
    lo, hi = _section_bounds(net, pattern)
    items = list(zip(net.run_function, net._funcs))
    return items[:lo], [l for l, _ in items[lo:hi]], items[hi:]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class PipelineParallel:
    """``train_batch`` / ``eval_batch`` over a ``PipelineLayer`` (module
    docstring)."""

    def __init__(self, layers, hcg, strategy, optimizer=None,
                 loss_fn=None):
        from ... import collective as coll
        self._layers = layers
        self._hcg = hcg if hcg is not None else coll.get_mesh()
        if self._hcg is None:
            raise ValueError("PipelineParallel needs the topology: call "
                             "fleet.init first")
        self._strategy = strategy
        cfg = dict(strategy.pipeline_configs if strategy else {})
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.micro_batch_size = cfg.get("micro_batch_size", 1)
        self.remat_stage = bool(cfg.get("remat_stage", True))
        mode = str(cfg.get("schedule_mode", "1F1B"))
        if mode != "1F1B":
            raise ValueError(f"schedule_mode {mode!r}: the port runs 1F1B")
        self._optimizer = optimizer
        self._loss_override = loss_fn
        self._update = None
        self._update_opt = None
        hcg = self._hcg
        self.P = hcg.get_pipe_parallel_world_size()
        if hcg.get_sep_parallel_world_size() > 1 and self.P > 1:
            raise NotImplementedError(
                "pipeline parallel beside context parallel (pp > 1 and "
                "sep > 1) is not ported yet (ROADMAP queue A, item A10)")
        if self.P > 1 and layers._num_stages != self.P:
            raise ValueError(f"a PipelineLayer of {layers._num_stages} "
                             f"stages under pp degree {self.P}")
        self.stage = hcg.get_stage_id()
        self._pipe = hcg.get_pipe_parallel_group()
        self._data = hcg._get_data_group()
        if self.P > 1:
            seg = getattr(layers, "_seg_method", "uniform") or "uniform"
            pat = seg.split("layer:", 1)[1] if seg.startswith("layer:") \
                else None
            blo, bhi = _section_bounds(layers, pat)
            if (bhi - blo) % self.P:
                raise ValueError(
                    f"pipeline body has {bhi - blo} layers, not divisible "
                    f"by pp degree {self.P}")
            self._body = (blo, bhi)
        self._ties = self._tie_groups()
        self._sync_start()

    # -- set-up ---------------------------------------------------------------
    def _tie_groups(self):
        """``[(this rank's copy, its group)]`` for every weight held by
        several stages: one group per slice of the other axes, made by
        every rank in the same order."""
        out = []
        topo = self._hcg.topology()
        for key, (stages, param) in sorted(
                self._layers.tied_weights().items()):
            mine = None
            for ranks in topo.get_comm_list("pipe"):
                members = [ranks[s] for s in stages]
                g = new_group(members, axis_name="pp_tied")
                if self._hcg.get_global_rank() in members:
                    mine = g
            if param is not None:
                out.append((param, mine, stages[0] == self.stage))
        return out

    def _sync_start(self):
        """Every rank from its groups' first ranks: the weights not split
        over mp from the mp group's, all from the data group's, and a
        shared weight's copies from its first stage."""
        from ..utils.hybrid_parallel_util import broadcast_mp_parameters
        broadcast_mp_parameters(self._layers, self._hcg)
        sync_params_buffers(self._layers, self._data, self._data.ranks[0])
        with torch.no_grad():
            for p, g, _ in self._ties:
                broadcast(p.data, src=g.ranks[0], group=g)

    def _loss_layer(self):
        return self._loss_override or getattr(self._layers, "_loss_fn",
                                              None)

    def _hybrid_update(self, optimizer):
        from ..meta_optimizers.dygraph_optimizer import HybridUpdate
        if self._update is None or self._update_opt is not optimizer:
            hcg = self._hcg
            self._update = HybridUpdate(
                list(self._layers.named_parameters()), optimizer,
                self._data, hcg.get_model_parallel_group(),
                pp_group=self._pipe,
                tied=[(p, g) for p, g, _ in self._ties],
                norm_skip=[p for p, _, first in self._ties if not first])
            self._update_opt = optimizer
        return self._update

    # -- the batch ------------------------------------------------------------
    def _check_group(self, inputs, labels):
        ins = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        lbs = list(labels) if isinstance(labels, (list, tuple)) \
            else [labels]
        if len(ins) != 1 or len(lbs) != 1:
            raise ValueError(
                "the pipeline engine takes exactly one input and one "
                f"label tensor, got {len(ins)} inputs / {len(lbs)} "
                "labels")
        M = max(self.accumulate_steps, 1)
        x, y = (self._as_tensor(t) for t in (ins[0], lbs[0]))
        if x.shape[0] % M != 0:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by "
                f"accumulate_steps {M}")
        return x, y

    @staticmethod
    def _as_tensor(t):
        t = getattr(t, "_value", t)
        return t if isinstance(t, torch.Tensor) else torch.as_tensor(
            np.asarray(t))

    def _device(self):
        return next(iter(self._layers.parameters())).device

    def _micro(self, t, m):
        """This rank's rows of micro-batch ``m``."""
        M = max(self.accumulate_steps, 1)
        mb = t.shape[0] // M
        n, r = self._data.nranks, self._hcg._data_rank()
        if mb % n:
            raise ValueError(f"micro-batch {mb} does not split over "
                             f"{n} data ranks")
        part = mb // n
        lo = m * mb + r * part
        return t[lo:lo + part].to(self._device())

    # -- one stage ------------------------------------------------------------
    def _run_stage(self, x):
        lo, hi = self._layers.stage_range()
        blo, bhi = max(self._body[0], lo), min(self._body[1], hi)
        layers = self._layers
        if blo >= bhi:
            return layers._run_items(x, lo, hi)
        x = layers._run_items(x, lo, blo)
        if self.remat_stage and torch.is_grad_enabled():
            x = recompute(lambda h: layers._run_items(h, blo, bhi), x)
        else:
            x = layers._run_items(x, blo, bhi)
        return layers._run_items(x, bhi, hi)

    def _prev(self):
        return self._hcg.get_rank_from_stage(self.stage - 1)

    def _next(self):
        return self._hcg.get_rank_from_stage(self.stage + 1)

    def _send_meta(self, t):
        meta = torch.zeros(_META_LEN, dtype=torch.int64)
        meta[0] = t.dim()
        meta[1:1 + t.dim()] = torch.tensor(t.shape)
        meta[-1] = _DTYPES.index(t.dtype)
        return isend(meta, dst=self._next(), group=self._pipe)

    def _recv_meta(self):
        meta = torch.zeros(_META_LEN, dtype=torch.int64)
        irecv(meta, src=self._prev(), group=self._pipe).wait()
        nd = int(meta[0])
        return tuple(int(v) for v in meta[1:1 + nd]), \
            _DTYPES[int(meta[-1])]

    def _schedule(self, x, y, train: bool, capture: bool = False):
        """The 1F1B sweep of the batch's micro-batches on this stage;
        returns ``(loss sum over the micro-batches / M, outputs)`` on the
        last stage (``(None, [])`` elsewhere)."""
        M = max(self.accumulate_steps, 1)
        first, last = self.stage == 0, self.stage == self.P - 1
        loss_layer = self._loss_layer()
        warm = min(self.P - self.stage - 1, M) if train else M
        saved = collections.deque()
        pending, outs = [], []
        total = None
        meta = [None]

        def fwd(m):
            nonlocal total
            if first:
                inp = self._micro(x, m)
            else:
                if meta[0] is None:
                    meta[0] = self._recv_meta()
                shape, dtype = meta[0]
                inp = torch.empty(shape, dtype=dtype, device=self._device())
                irecv(inp, src=self._prev(), group=self._pipe).wait()
                inp.requires_grad_(train)
            with torch.set_grad_enabled(train):
                out = self._run_stage(inp)
                if last:
                    if capture:
                        outs.append(out.detach())
                    out = loss_layer(out, self._micro(y, m)) \
                        if loss_layer is not None else out
                    v = out.detach().float()
                    total = v if total is None else total + v
            if not last:
                if m == 0:
                    pending.append(self._send_meta(out))
                pending.append(isend(out.detach(), dst=self._next(),
                                     group=self._pipe))
            if train:
                saved.append((inp, out))

        def bwd(_m):
            inp, out = saved.popleft()
            if last:
                (out / M).backward()
            else:
                g = torch.empty_like(out)
                irecv(g, src=self._next(), group=self._pipe).wait()
                torch.autograd.backward(out, g)
            if not first:
                pending.append(isend(inp.grad, dst=self._prev(),
                                     group=self._pipe))

        for m in range(warm):
            fwd(m)
        for i in range(M - warm):
            fwd(warm + i)
            bwd(i)
        if train:
            for i in range(M - warm, M):
                bwd(i)
        for t in pending:
            t.wait()
        return (total / M if total is not None else None), outs

    def _broadcast_loss(self, total):
        """The batch's mean loss on every rank: averaged over the data
        group on the last stage, sent to the other stages."""
        loss = torch.zeros((), dtype=torch.float32, device=self._device())
        if total is not None:
            loss.copy_(total)
            all_reduce(loss, group=self._data)
            loss.div_(self._data.nranks)
        if self.P > 1:
            broadcast(loss, src=self._hcg.get_rank_from_stage(self.P - 1),
                      group=self._pipe)
        return loss

    # -- the inline case (pp 1) -----------------------------------------------
    def _inline(self, x, y, train: bool, capture: bool = False):
        M = max(self.accumulate_steps, 1)
        loss_layer = self._loss_layer()
        total, outs = None, []
        for m in range(M):
            with torch.set_grad_enabled(train):
                out = self._layers(self._micro(x, m))
                if capture:
                    outs.append(out.detach())
                loss = loss_layer(out, self._micro(y, m)) \
                    if loss_layer is not None else out
            if train:
                (loss / M).backward()
            v = loss.detach().float()
            total = v if total is None else total + v
        return total / M, outs

    # -- public API -----------------------------------------------------------
    def _step(self, x, y, optimizer, capture=False):
        if optimizer is None:
            optimizer = self._optimizer
        if optimizer is None:
            raise ValueError(
                "PipelineParallel needs an optimizer: pass one to "
                "train_batch/train_step or bind it at construction")
        self._optimizer = optimizer
        update = self._hybrid_update(optimizer)
        self._layers.train()
        run = self._inline if self.P == 1 else self._schedule
        total, outs = run(x, y, True, capture)
        update.step(reduce=True)
        for _, p in update.named:
            p.grad = None
        return self._broadcast_loss(total), outs

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """``data``: ``(inputs, labels)``, the whole batch on every rank;
        returns the batch's mean loss as a Paddle ``Tensor`` on every
        rank."""
        if scaler is not None:
            raise ValueError(
                "the pipeline engine trains in the parameters' dtype (no "
                "AMP, as in the JAX engine): it takes no GradScaler")
        from ....tensor import Tensor
        x, y = self._check_group(*data)
        loss, _ = self._step(x, y, optimizer)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return Tensor(loss)

    def train_step(self, inputs, labels):
        """The runner entry: ``(loss float, out_vals)``, ``out_vals`` the
        last stage's outputs of the micro-batches (an empty list on the
        other stages)."""
        x, y = self._check_group(inputs, labels)
        loss, outs = self._step(x, y, None, True)
        return float(loss), ([torch.cat(outs)] if outs else [])

    def eval_batch(self, data, compute_loss=True):
        """The forward of the batch: with ``compute_loss`` the mean loss
        as a Paddle ``Tensor`` on every rank, else the last stage's
        outputs (a ``Tensor`` there, None on the other stages).  At pp 1
        the whole batch in one forward, as the JAX engine runs it."""
        from ....tensor import Tensor
        inputs, labels = data
        x, y = (self._as_tensor(t) for t in (inputs, labels))
        self._layers.eval()
        try:
            if self.P == 1:
                with torch.no_grad():
                    out = self._layers(x.to(self._device()))
                    loss_layer = self._loss_layer()
                    if compute_loss and loss_layer is not None:
                        return Tensor(loss_layer(out, y.to(out.device)))
                return Tensor(out)
            saved = self.accumulate_steps
            self.accumulate_steps = 1
            try:
                total, outs = self._schedule(
                    x, y, False, capture=not compute_loss)
            finally:
                self.accumulate_steps = saved
            if compute_loss:
                return Tensor(self._broadcast_loss(total))
            return Tensor(outs[0]) if outs else None
        finally:
            self._layers.train()

    def sync_to_layers(self):
        """The layers are the engine's store in the port: nothing to
        write back."""

    def compile_stats(self):
        """Nothing is compiled in the port (eager schedule)."""
        return {"entries": 0, "traces": 0}
