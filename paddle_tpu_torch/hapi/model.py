"""``paddle.Model`` (counterpart of ``paddle_tpu/hapi/model.py``).

The JAX package compiles forward, loss, gradients and the optimizer
update into one XLA program per step.  The port's step is the same
work on PyTorch: forward through the network (whose attention is the
flash kernel on the card), ``loss.backward()``, the optimizer update,
``optimizer.clear_grad()``.  Before the update, every trainable
parameter of the optimizer that got no gradient is given a zero one,
since the JAX step differentiates all of them and AdamW then decays
each.  The step's loss rides the callbacks as a :class:`~paddle_tpu_
torch.framework.LazyScalar` of the device tensor, so the loop itself
never waits for the device: only a callback that formats a loss does.

``fit`` runs the step through the fold engine
(``framework/dispatch.py``), as the JAX ``fit`` does: with
``steps_per_dispatch=K`` (K >= 1) it groups K logical steps, and on
the card each step of a group is a replay of one CUDA graph of the
training step, captured once per batch signature after one eager
warm-up step; on the CPU the same step body runs eagerly.  Every K
gives the same end state.  ``steps_per_dispatch=0`` (or
``prepare(jit=False)``) runs each step through
:meth:`Model.train_batch`, eagerly, which stays the public single-step
entry.  :meth:`Model.prepare_serving` hands the network to a warmed
continuous-batching ``LLMServer``.

Metrics (``prepare(metrics=)``, ``paddle_tpu_torch/metric``): each
metric's stat is computed inside the step, and so inside its graph on
the card, from the first output and the first label; the step adds it
into the model's accumulator for that metric, a static buffer zeroed
in place at each epoch's start, and the runner copies it into the
group's ``[K, ...]`` stack for the per-step logs.  ``accumulate()`` at
the epoch's end is the one sync.  A metric without a device path turns
folding off, with a warning.

Evaluation (:meth:`eval_batch`, :meth:`evaluate`, ``fit(eval_data=)``)
runs on the card as one captured graph per batch signature, in
``eval()`` mode, without gradients, inside ``auto_cast`` at the
prepared level, with the metric stats in the graph; on the CPU the
same body runs eagerly.  :meth:`predict_batch` and :meth:`predict`
return numpy arrays (a bf16 output as fp32).

Learning-rate schedules: the update reads the optimizer's learning
rate from a 0-d device tensor that ``refresh_lr`` fills outside the
graph before every group; a by-step ``LRSchedulerCallback`` steps the
scheduler after each step and makes every group one step long, so each
replay runs at its step's rate (a folded group would hold one rate for
all its steps).

Checkpoints: :meth:`save` writes ``.pdparams`` and ``.pdopt`` in the
JAX package's format (``framework/io.py``; the scheduler's state rides
the ``.pdopt`` under ``LR_Scheduler``), and :meth:`load` copies them
into the live parameters, buffers and optimizer states in place, so
every captured graph of the model stays valid.
``accumulate_grad_batches=k`` concatenates k batches on the host and
runs one step on the result, as the JAX loop does on one device.

``prepare(amp_configs=...)`` ("O1"/"O2", or a dict with ``level`` and
``dtype``) runs the network's forward inside ``amp.auto_cast``, as the
JAX ``_forward_with_loss`` does (the loss outside it); the AMP level
and dtype are part of every graph's key.

The JAX package's ``hapi/train_state.py`` has no counterpart: it
exists because XLA donates a device-resident copy of the parameters
and optimizer state into each step, which the Layer tree re-syncs from
at boundaries.  The port's parameters and optimizer states are live
tensors updated in place, so there is nothing to sync.

Not ported yet: training on a device mesh (``_mesh_runner``, the mesh
branch of ROADMAP queue A, item A10; ``distributed.DistributedRunner``
trains over ranks meanwhile); the fit watchdog and the elastic and
``train.step`` fault-site hooks (item 11); ``save(training=False)``,
which is ``jit.save`` (item 12).
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Any, Dict, List

import numpy as np
import torch

from .. import resolve_device
from ..amp.auto_cast import auto_cast
from ..framework import env_knobs
from ..framework.dispatch import (AutoFoldTuner, GroupDispatcher,
                                  build_folded_step)
from ..framework.io import load as _load, save as _save
from ..framework.lazy import LazyScalar, LazyStack
from ..framework.selected_rows import dense_lookups
from ..io import DataLoader, Dataset
from ..io.staging import as_tensor, stack_to_device, to_device_values
from ..metric import Metric
from ..nn import layer as _layer
from ..observability import metrics as _obs_metrics
from ..observability import trace as _obs_trace
from ..ops import counts as _counts
from . import callbacks as cbk_mod

#: the environment knobs the training step reads while it runs (and a
#: CUDA graph therefore freezes): part of every graph's key
STEP_KNOBS = ("PADDLE_TORCH_FLASH_NO_PACKED", "PADDLE_TORCH_FLASH_HEADPACK",
              "PADDLE_TORCH_FLASH_FUSED_BWD")
#: the callback hooks that consume per-step events
_STEP_HOOKS = ("on_batch_begin", "on_batch_end", "on_train_batch_begin",
               "on_train_batch_end")


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue A, item {item})")


def _host_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Model:
    """``device=None`` means the card and raises without one; pass
    ``device="cpu"`` for the CPU.  The network is moved there.  The
    model owns its CUDA graphs (one per batch signature and step knobs,
    and one per evaluation signature) and their memory pool:
    :meth:`release_graphs` frees them, and :meth:`prepare` drops
    them."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None,
                 device=None):
        self.device = resolve_device(device)
        self.network = network.to(self.device)
        self._structure_version = _layer.structure_version()
        self._tree_ids = {id(m) for m in network.modules()}
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._macc: List[torch.Tensor] = []
        self._use_jit = True
        self._accumulate = 1
        self._in_fit = False
        self._zero_grads: Dict[int, torch.Tensor] = {}
        self.stop_training = False
        self._graphs: Dict[tuple, Any] = {}
        self._eval_graphs: Dict[tuple, Any] = {}
        self._graph_pool = None
        self._fold = 0
        self._fold_tuner = None
        self._amp_level, self._amp_dtype = None, "bfloat16"

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=True):
        """``metrics``: :class:`~paddle_tpu_torch.metric.Metric` s;
        ``jit=False`` selects the eager route for training and
        evaluation, as ``steps_per_dispatch=0`` does for training."""
        metrics = _to_list(metrics)
        for m in metrics:
            if not isinstance(m, Metric):
                raise TypeError("metrics must be paddle_tpu_torch.metric."
                                f"Metric instances, got {type(m)}")
        self._amp_level, self._amp_dtype = None, "bfloat16"
        if isinstance(amp_configs, str):
            self._amp_level = amp_configs
        elif isinstance(amp_configs, dict):
            self._amp_level = amp_configs.get("level", "O1")
            self._amp_dtype = amp_configs.get("dtype", "bfloat16")
        elif amp_configs:
            raise TypeError(f"amp_configs must be a level string or a "
                            f"dict, got {amp_configs!r}")
        self.release_graphs()
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics
        # one accumulator per device metric, at a fixed address that
        # every captured step adds to
        self._macc = [m.device_acc_init(self.device) for m in metrics
                      if m.supports_device_update]
        self._use_jit = bool(jit)
        self._zero_grads = {}
        if optimizer is not None:
            names = {id(p): n for n, p in self.network.named_parameters()}
            optimizer.set_param_names(
                names.get(id(p), f"param_{i}")
                for i, p in enumerate(optimizer.parameters()))

    def parameters(self, *args, **kwargs) -> List[torch.nn.Parameter]:
        return list(self.network.parameters(*args, **kwargs))

    def _amp(self):
        return (auto_cast(level=self._amp_level, dtype=self._amp_dtype)
                if self._amp_level else contextlib.nullcontext())

    def _forward_loss(self, ins, lbs):
        """``(loss, outputs)``: the forward inside ``auto_cast`` at the
        prepared level, the loss outside it (the first output when the
        model has no loss)."""
        with self._amp():
            outs = _to_list(self.network(*ins))
        loss = self._loss(*(outs + lbs)) if self._loss is not None \
            else outs[0]
        return loss, outs

    def _device_metrics(self) -> bool:
        return bool(self._metrics) and all(
            m.supports_device_update for m in self._metrics)

    @torch.no_grad()
    def _batch_stats(self, outs, lbs):
        """Each device metric's stat of this batch (none without labels
        or outputs)."""
        if not (self._device_metrics() and outs and lbs):
            return ()
        pred = outs[0].detach()
        return tuple(m.device_batch_stats()(pred, lbs[0])
                     for m in self._metrics)

    def _apply_metrics(self, stats, outs, lbs):
        """The metric values of one batch outside a fold group: device
        metrics adopt the step's stats (a host list append), host-only
        metrics run their numpy update."""
        if not self._metrics:
            return []
        if stats:
            return [m.update_device_stats(s)
                    for m, s in zip(self._metrics, stats)]
        if not (outs and lbs):
            return []
        return [m.update(m.compute(outs[0], lbs[0])) for m in self._metrics]

    # -- single batches -----------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One eager step on one batch: forward, loss, backward and
        (with ``update``) the optimizer step.  Returns ``([loss],
        metrics)`` with the loss as a lazy fp32 device scalar and each
        metric's value of this batch.  ``update=False`` leaves the
        parameters and the gradients as they were, as the JAX package's
        discarded step does."""
        self._check_structure()
        self.network.train()
        ins = to_device_values(_to_list(inputs), self.device)
        lbs = to_device_values(_to_list(labels), self.device)
        if update:
            self._optimizer.refresh_lr()
            loss, stats, outs = self._train_step(ins, lbs, outputs=True)
            if self._in_fit:
                self._observe_fit_steps(1)
                self._observe_loss(loss)
        else:
            with torch.no_grad():
                loss, outs = self._forward_loss(ins, lbs)
            loss = loss.detach().float()
            stats = self._batch_stats(outs, lbs)
        return [LazyScalar(loss)], self._apply_metrics(stats, outs, lbs)

    def _train_step(self, ins, lbs, outputs=False):
        """The training step on device tensors, the body that the fold
        engine captures: forward, loss, the metric stats, backward, the
        zero gradients, the update (reading the optimizer's
        learning-rate scalar as it stands) and ``clear_grad``.  Returns
        the loss (fp32, 0-d) and the stats (and the outputs).  Under
        ``prepare(jit=True)`` (the JAX package compiles that step) a
        ``sparse=True`` lookup gives a dense gradient, as under the JAX
        trace; with ``jit=False`` it gives the sparse one."""
        with dense_lookups() if self._use_jit else contextlib.nullcontext():
            loss, outs = self._forward_loss(ins, lbs)
        stats = self._batch_stats(outs, lbs)
        loss.backward()
        self._zero_missing_grads()
        self._optimizer._step()
        self._optimizer.clear_grad()
        loss = loss.detach().float()
        return (loss, stats, outs) if outputs else (loss, stats)

    def _zero_missing_grads(self):
        """Give each trainable parameter of the optimizer that got no
        gradient a zero one, as the JAX step (``jax.value_and_grad``
        over every parameter) does, so AdamW's decoupled decay still
        applies to it.  Each zero tensor is allocated once (in the fold
        engine, by the warm-up step, before any capture) and reused; no
        update writes into a gradient."""
        for i, p in enumerate(self._optimizer.parameters()):
            if p.requires_grad and p.grad is None:
                zero = self._zero_grads.get(i)
                if zero is None:
                    zero = self._zero_grads[i] = torch.zeros_like(p)
                p.grad = zero

    def eval_batch(self, inputs, labels=None):
        """The loss and metric values of one batch in ``eval()`` mode,
        without gradients.  On the card (with a loss and device
        metrics) one captured graph per batch signature computes them;
        otherwise the body runs eagerly."""
        self._check_structure()
        self.network.eval()
        ins = to_device_values(_to_list(inputs), self.device)
        lbs = to_device_values(_to_list(labels), self.device)
        if (self.device.type == "cuda" and self._use_jit
                and self._loss is not None
                and (not self._metrics or self._device_metrics())):
            vals = ins + lbs
            runner = self._eval_runner(vals, len(ins))
            loss = torch.empty(1, dtype=torch.float32, device=self.device)
            stacks = ([torch.empty((1,) + tuple(a.shape), dtype=a.dtype,
                                   device=self.device) for a in self._macc]
                      if lbs else [])
            runner.run([v.unsqueeze(0) for v in vals], loss, stacks)
            stats = tuple(s[0] for s in stacks)
            return ([LazyScalar(loss[0])],
                    self._apply_metrics(stats, None, lbs))
        with torch.no_grad():
            loss, outs = self._forward_loss(ins, lbs)
        stats = self._batch_stats(outs, lbs)
        return ([LazyScalar(loss.detach().float())],
                self._apply_metrics(stats, outs, lbs))

    def _eval_step(self, ins, lbs):
        with torch.no_grad():
            loss, outs = self._forward_loss(ins, lbs)
            return loss.detach().float(), self._batch_stats(outs, lbs)

    def predict_batch(self, inputs):
        """The network's outputs of one batch in ``eval()`` mode, without
        gradients, inside ``auto_cast`` at the prepared level: a list of
        numpy arrays (bf16 as fp32)."""
        self.network.eval()
        ins = to_device_values(_to_list(inputs), self.device)
        with torch.no_grad(), self._amp():
            outs = _to_list(self.network(*ins))
        return [_host_array(o) for o in outs]

    def _check_structure(self):
        """Before a step: if a parameter or sub-layer of the network was
        added, removed or replaced since the last look (the structure
        version of ``nn/layer.py`` moved and the log names a layer of
        this tree), drop every captured graph (each reads the storage of
        the parameters it was captured with) and the zero gradients, and
        hand each replaced parameter to the optimizer under its name,
        with fresh state, as the JAX ``TrainState`` re-reads the tree.
        Otherwise one integer compare."""
        ver = _layer.structure_version()
        if ver == self._structure_version:
            return
        touched = _layer.mutations_since(self._structure_version)
        self._structure_version = ver
        if touched is not None and not self._tree_ids.intersection(touched):
            return
        self._tree_ids = {id(m) for m in self.network.modules()}
        self.release_graphs()
        self._zero_grads = {}
        if self._optimizer is not None:
            self._optimizer._adopt_parameters(
                dict(self.network.named_parameters()))

    # -- the fold engine ---------------------------------------------------
    def _key(self, batches, n_in):
        return ((n_in,) + tuple((tuple(b.shape[1:]), b.dtype)
                                for b in batches)
                + tuple(env_knobs.get_raw(k) for k in STEP_KNOBS)
                + (self._amp_level, self._amp_dtype))

    def _pool(self):
        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _runner(self, batches, n_in):
        """The step runner of this batch signature, these step knobs and
        this AMP level and dtype, built (and on the card captured at its
        first group) once."""
        key = self._key(batches, n_in)
        runner = self._graphs.get(key)
        if runner is None:
            opt = self._optimizer
            accs = self._macc

            def per_step(values):
                loss, stats = self._train_step(values[:n_in], values[n_in:])
                for acc, stat in zip(accs, stats):
                    acc.add_(stat)
                return loss, stats

            runner = self._graphs[key] = build_folded_step(
                per_step, self.device, self._pool(),
                ledgers=((_counts.read, _counts.write),
                         (opt._bookkeeping, opt._set_bookkeeping)))
        return runner

    def _eval_runner(self, values, n_in):
        """The evaluation runner of this batch signature: one graph of
        :meth:`_eval_step`, captured at its first batch."""
        key = self._key([v.unsqueeze(0) for v in values], n_in)
        runner = self._eval_graphs.get(key)
        if runner is None:
            runner = self._eval_graphs[key] = build_folded_step(
                lambda vals: self._eval_step(vals[:n_in], vals[n_in:]),
                self.device, self._pool(),
                ledgers=((_counts.read, _counts.write),))
        return runner

    def _train_batch_folded(self, groups):
        """``len(groups)`` logical steps, one runner call: on the card
        (warm-up and capture at a signature's first group, then) one
        graph replay per step.  Returns the losses and each metric's
        stats as :class:`LazyStack` s of the group's ``[K, ...]``
        buffers, fetched once when a callback formats one of them."""
        self._check_structure()
        self.network.train()
        batches = stack_to_device(
            [list(ins) + list(lbs) for ins, lbs in groups], self.device)
        n_in = len(groups[0][0])
        runner = self._runner(batches, n_in)
        self._optimizer.refresh_lr()
        k = len(groups)
        losses = torch.empty(k, dtype=torch.float32, device=self.device)
        stacks = ([torch.empty((k,) + tuple(a.shape), dtype=a.dtype,
                               device=self.device) for a in self._macc]
                  if len(batches) > n_in else [])
        runner.run(batches, losses, stacks)
        if stacks:
            for m, acc in zip(self._metrics, self._macc):
                m.adopt_device_acc(acc)
        stack = LazyStack(losses)
        self._observe_fit_steps(k)
        self._observe_loss(stack)
        return stack, [LazyStack(s) for s in stacks]

    def compile_stats(self) -> Dict[str, int]:
        """``graphs``: the step runners built, one per batch signature
        and step knobs; ``captures``: the CUDA graphs captured (on the
        CPU, the bodies built), one per runner whatever K is; once an
        evaluation built one, ``eval_graphs`` and ``eval_captures`` the
        same for the evaluation runners.  Growth on a fixed workload
        means a signature that keeps changing."""
        out = {"graphs": len(self._graphs),
               "captures": sum(r.captures for r in self._graphs.values())}
        if self._eval_graphs:
            out["eval_graphs"] = len(self._eval_graphs)
            out["eval_captures"] = sum(r.captures for r in
                                       self._eval_graphs.values())
        return out

    def release_graphs(self) -> None:
        """Free every CUDA graph of this model and drop its pool."""
        for runner in (*self._graphs.values(), *self._eval_graphs.values()):
            runner.close()
        self._graphs = {}
        self._eval_graphs = {}
        self._graph_pool = None

    # -- the registry -------------------------------------------------------
    def _observe_fit_steps(self, steps):
        """``fit_steps_total``: committed logical train steps."""
        _obs_metrics.registry().counter(
            "fit_steps_total", "committed logical train steps "
            "(Model.fit, all dispatch paths)").inc(steps)

    def _observe_loss(self, losses):
        """``fit_loss``: a lazy view of the last committed loss, fetched
        when the registry is scraped, never by the loop."""
        _obs_metrics.registry().gauge(
            "fit_loss", "last committed train-step loss "
            "(lazy; synced at scrape)").set(
                LazyScalar(losses, post=lambda a: (
                    a if getattr(a, "ndim", 0) == 0 else a[-1])))

    # -- serving export -----------------------------------------------------
    def prepare_serving(self, prompt_lengths=None, warmup=True, start=True,
                        **server_kwargs):
        """The trained network as a continuous-batching generation server
        (``paddle_tpu_torch.inference.serving.LLMServer``) on this
        model's device, in one call: the server serves a copy of the
        live parameters in the decode layout (``extract_decode_params``),
        so no training graph of this model aliases them; ``warmup``
        captures the decode step and the prefill programs that
        ``prompt_lengths`` reach before any traffic (the record stays in
        ``server.stats()["warmup"]``), and ``start`` starts its pump.
        ``server_kwargs`` go to the engine (``max_batch``,
        ``block_size``, ``num_blocks``, ``eos_id``, ...).  Returns the
        server."""
        from ..inference.serving import LLMServer
        server = LLMServer(self.network, auto_start=False,
                           device=self.device, **server_kwargs)
        if warmup:
            server.warmup(prompt_lengths)
        if start:
            server.start()
        return server

    # -- loops --------------------------------------------------------------
    def _loader(self, data, batch_size, num_workers, shuffle=False,
                drop_last=False):
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers)
        return data

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None,
            steps_per_dispatch=None):
        """Train for ``epochs`` passes over ``train_data`` (a
        :class:`~paddle_tpu_torch.io.Dataset`, batched here, or any
        iterable of batches), at most ``num_iters`` loader batches per
        epoch.  Each batch is ``inputs + labels``; with a loss the last
        item is the label.  ``eval_data`` is evaluated after every
        ``eval_freq``-th epoch (its logs join the epoch's as
        ``eval_<name>``); ``save_dir`` installs a
        :class:`ModelCheckpoint` (``<epoch>`` every ``save_freq`` epochs,
        and ``final``).

        ``steps_per_dispatch=K`` (step folding): K >= 1 runs groups of K
        logical steps through the fold engine (on the card, one graph
        replay per step; see the module docstring), and every K gives
        the same end state, trailing partial groups included; callbacks
        still fire per logical step, after their group ran, with lazy
        views of the group's losses and metric values.  ``0`` runs each
        step through :meth:`train_batch`.  ``None`` resolves as the JAX
        package's ``_resolve_fold`` does (:meth:`_resolve_fold`).
        ``accumulate_grad_batches=k`` makes each logical step of k
        loader batches, concatenated; a trailing group of fewer is
        dropped with a warning.  ``stop_training``, set by a callback,
        is read at the end of each epoch, which is a group boundary."""
        if self._optimizer is None:
            raise RuntimeError("call Model.prepare(optimizer, loss) first")
        self._accumulate = max(int(accumulate_grad_batches), 1)
        train_loader = self._loader(train_data, batch_size, num_workers,
                                    shuffle, drop_last)
        eval_loader = self._loader(eval_data, batch_size, num_workers)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbks = cbk_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            log_freq=log_freq, save_freq=save_freq, save_dir=save_dir,
            verbose=verbose, metrics=self._metrics_name())
        self._fold = self._resolve_fold(steps_per_dispatch, cbks)
        loaders = [l for l in (train_loader, eval_loader)
                   if isinstance(l, DataLoader)]
        if isinstance(train_loader, DataLoader):
            # above a fold of 1 (or with accumulation) the batches stay on
            # the host: the fold engine's stacked copy is the one
            # host-to-device point.  Under auto-K the tuner's bound
            # stands in until it decides
            hint = (self._fold_tuner.max_fold
                    if self._fold_tuner is not None else self._fold)
            if self._accumulate > 1:
                hint = max(hint, 2)
            train_loader._fold_hint = max(hint, 1)
        for l in loaders:
            l._stage_device = self.device
        self.stop_training = False
        self._in_fit = True
        try:
            cbks.on_begin("train")
            with _obs_trace.span(
                    "fit", args=({"epochs": epochs}
                                 if _obs_trace.enabled() else None)):
                for epoch in range(epochs):
                    sampler = getattr(train_loader, "batch_sampler", None)
                    if hasattr(sampler, "set_epoch"):
                        sampler.set_epoch(epoch)
                    cbks.on_epoch_begin(epoch)
                    with _obs_trace.span(
                            "fit.epoch",
                            args=({"epoch": epoch}
                                  if _obs_trace.enabled() else None)):
                        logs = self._run_one_epoch(train_loader, cbks,
                                                   "train", num_iters)
                    _obs_metrics.registry().counter(
                        "fit_epochs_total", "completed train epochs").inc()
                    cbks.on_epoch_end(epoch, logs)
                    if eval_loader is not None and epoch % eval_freq == 0:
                        eval_logs = self.evaluate(eval_loader, verbose=0,
                                                  _callbacks=cbks)
                        logs.update({"eval_" + k: v
                                     for k, v in eval_logs.items()})
                    if self.stop_training:
                        break
        finally:
            self._in_fit = False
            for l in loaders:
                l._fold_hint = 1
                l._stage_device = None
            if self._fold_tuner is not None and self._fold_tuner.decided:
                self._fold = self._fold_tuner.fold
        cbks.on_end("train")

    def _resolve_fold(self, requested, cbks):
        """``steps_per_dispatch`` as the JAX ``_resolve_fold`` resolves
        it: 0 for an explicit 0 or less, for ``prepare(jit=False)`` and,
        with a warning, when a metric has no device path (the eager
        route); 1, with a warning when more was asked, when a by-step LR
        scheduler callback needs a fresh rate each step; K for an
        explicit K; else 1 when a callback consumes per-step events and
        otherwise 1 with an :class:`AutoFoldTuner` that picks K during
        the first groups."""
        self._fold_tuner = None
        if requested is not None and int(requested) <= 0:
            return 0
        if not self._use_jit:
            return 0
        if any(not m.supports_device_update for m in self._metrics):
            warnings.warn(
                "fit(steps_per_dispatch) requires every metric to support "
                "device-side accumulation; running unfolded (the eager "
                "route)")
            return 0
        if any(isinstance(c, cbk_mod.LRSchedulerCallback) and c.by_step
               for c in cbks.callbacks):
            if requested is not None and int(requested) > 1:
                warnings.warn(
                    "fit(steps_per_dispatch>1): a by-step LR scheduler "
                    "needs a fresh learning rate every step; running "
                    "steps_per_dispatch=1")
            return 1
        if requested is not None:
            return int(requested)
        base = cbk_mod.Callback
        for c in cbks.callbacks:
            if isinstance(c, cbk_mod.LRSchedulerCallback):
                continue
            if isinstance(c, cbk_mod.ProgBarLogger):
                if c.verbose:
                    return 1      # per-step console cadence expected
                continue
            if any(getattr(type(c), h) is not getattr(base, h)
                   for h in _STEP_HOOKS):
                return 1          # a user hook consumes per-step events
        self._fold_tuner = AutoFoldTuner()
        return 1

    def _split(self, data):
        data = _to_list(data)
        n_label = 0
        if self._loss is not None:
            n_label = len(_to_list(self._labels)) if self._labels else 1
        return data[:len(data) - n_label], data[len(data) - n_label:]

    def _run_one_epoch(self, loader, cbks, mode, num_iters=None):
        self._reset_metrics()
        logs: Dict[str, Any] = {}
        k = self._accumulate if mode == "train" else 1
        fold = self._fold if mode == "train" else 0
        pending: List[Any] = []
        names = self._metrics_name()[1:]

        def cat(parts):
            return [torch.cat([as_tensor(p[i]) for p in parts])
                    for i in range(len(parts[0]))]

        def emit(step, loss, metrics, inputs):
            logs["loss"] = loss
            for name, val in zip(names, self._flat(metrics)):
                logs[name] = val
            logs["batch_size"] = inputs[0].shape[0] if inputs else 0
            logs["step"] = step
            cbks.on_batch_end(mode, step, logs)

        def emit_group(entries, losses, mstacks):
            """Replay a group's per-step callbacks in order with lazy
            views; an accumulate intermediate (no inputs) carries no
            compute."""
            gi = 0
            for step, ins, _ in entries:
                cbks.on_batch_begin(mode, step, logs)
                if ins is None:
                    logs["step"] = step
                    cbks.on_batch_end(mode, step, logs)
                    continue
                metrics = [m.device_step_result(mstacks[j], gi)
                           for j, m in enumerate(self._metrics)] \
                    if mstacks else []
                emit(step, [losses.view(gi)], metrics, ins)
                gi += 1

        engine = None
        if fold >= 1:
            engine = GroupDispatcher(self._train_batch_folded, emit_group,
                                     fold=fold, tuner=self._fold_tuner)
        # under auto-K fit primed the loader's fold hint with the
        # tuner's bound; once it decides, point the hint at the real K
        hint_loader = (loader if engine is not None
                       and self._fold_tuner is not None
                       and isinstance(loader, DataLoader)
                       and k == 1 else None)
        for step, data in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            inputs, labels = self._split(data)
            if mode != "train":
                cbks.on_batch_begin(mode, step, logs)
                loss, metrics = self.eval_batch(inputs, labels)
                emit(step, loss, metrics, inputs)
                continue
            if k > 1:
                pending.append((inputs, labels))
                if len(pending) < k:
                    if engine is not None and engine.pending:
                        engine.feed_marker(step)
                    else:
                        cbks.on_batch_begin(mode, step, logs)
                        logs["step"] = step
                        cbks.on_batch_end(mode, step, logs)
                    continue
                inputs = cat([p[0] for p in pending])
                labels = cat([p[1] for p in pending])
                pending = []
            if engine is not None:
                engine.feed(step, inputs, labels)
                if hint_loader is not None and self._fold_tuner.decided:
                    hint_loader._fold_hint = max(1, self._fold_tuner.fold)
                    hint_loader = None
                continue
            cbks.on_batch_begin(mode, step, logs)
            loss, metrics = self.train_batch(inputs, labels)
            emit(step, loss, metrics, inputs)
        if engine is not None:
            engine.flush()
        if pending:
            warnings.warn(
                f"fit(accumulate_grad_batches={k}): dropping trailing "
                f"group of {len(pending)} batch(es) smaller than k")
        self._merge_metric_logs(logs)
        return logs

    @staticmethod
    def _flat(values):
        out = []
        for v in values:
            out.extend(v if isinstance(v, list) else [v])
        return out

    def _merge_metric_logs(self, logs):
        for m in self._metrics:
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = res if isinstance(res, list) else [res]
            for n, v in zip(names, vals):
                logs[n] = v

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None,
                 _callbacks=None):
        """One pass over ``eval_data`` (at most ``num_iters`` batches)
        through :meth:`eval_batch`: ``{"loss": last batch's loss, <metric
        names>: accumulated values}``."""
        loader = self._loader(eval_data, batch_size, num_workers)
        staged = isinstance(loader, DataLoader) and \
            loader._stage_device is None
        if staged:
            loader._stage_device = self.device
        cbks = _callbacks or cbk_mod.config_callbacks(
            callbacks, model=self, log_freq=log_freq, verbose=verbose,
            metrics=self._metrics_name())
        try:
            cbks.on_begin("eval")
            logs = self._run_one_epoch(loader, cbks, "eval",
                                       num_iters=num_iters)
            cbks.on_end("eval", logs)
        finally:
            if staged:
                loader._stage_device = None
        out = {"loss": logs.get("loss")}
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            for n in names:
                if n in logs:
                    out[n] = logs[n]
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """:meth:`predict_batch` over ``test_data`` (its last item is the
        label when the model has a loss): one list of numpy arrays a
        network output, concatenated with ``stack_outputs``."""
        loader = self._loader(test_data, batch_size, num_workers)
        outputs = []
        for data in loader:
            data = _to_list(data)
            n_label = 1 if self._loss is not None else 0
            inputs = data[:len(data) - n_label] if n_label else data
            outputs.append(self.predict_batch(inputs))
        if not outputs:
            return []
        result = [[b[i] for b in outputs] for i in range(len(outputs[0]))]
        if stack_outputs:
            result = [np.concatenate(r) for r in result]
        return result

    # -- persistence --------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and, with an
        optimizer, ``path.pdopt`` (its state dict), in the JAX package's
        format."""
        if not training:
            raise _not_ported("Model.save(training=False) (jit.save)", 12)
        _save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    @torch.no_grad()
    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Copy ``path.pdparams`` into the network's parameters and
        buffers in place, and, unless ``reset_optimizer``, ``path.pdopt``
        into the optimizer's states; every captured graph stays valid.
        ``skip_mismatch`` drops entries whose shape differs, with a
        warning; names that match nothing are reported with a warning.
        An fp32 master is refreshed from its loaded parameter before the
        optimizer file, if any, overwrites it."""
        state = _load(path + ".pdparams")
        own = self.network.state_dict()
        if skip_mismatch:
            bad = sorted(k for k, v in state.items() if k in own and
                         tuple(v.shape) != tuple(own[k].shape))
            if bad:
                warnings.warn(f"Model.load: skipping entries whose shape "
                              f"differs: {bad}")
                state = {k: v for k, v in state.items() if k not in bad}
        result = self.network.load_state_dict(state, strict=False)
        if result.missing_keys or result.unexpected_keys:
            warnings.warn(f"Model.load: missing {result.missing_keys}, "
                          f"unexpected {result.unexpected_keys}")
        opt = self._optimizer
        if opt is None:
            return
        for i, st in opt._state.items():
            if "master_weight" in st:
                st["master_weight"].copy_(opt._parameter_list[i])
        opt_path = path + ".pdopt"
        if not reset_optimizer and os.path.exists(opt_path):
            opt.set_state_dict(_load(opt_path))

    def summary(self, input_size=None, dtype=None):
        """The parameter table of the network (``hapi/summary.py``)."""
        from .summary import summary as _summary
        return _summary(self.network, input_size=input_size)

    # -- helpers ------------------------------------------------------------
    def _metrics_name(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def _reset_metrics(self):
        """Each metric's host state, and its device accumulator zeroed in
        place (outside any graph; the graphs keep its address)."""
        for m in self._metrics:
            m.reset()
        for acc in self._macc:
            acc.zero_()
