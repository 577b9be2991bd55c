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
gives the same end state.  ``steps_per_dispatch=0`` runs each step
through :meth:`Model.train_batch`, eagerly, which stays the public
single-step entry.  :meth:`Model.prepare_serving` hands the network to
a warmed continuous-batching ``LLMServer``.

``prepare(amp_configs=...)`` ("O1"/"O2", or a dict with ``level`` and
``dtype``) runs the network's forward inside ``amp.auto_cast``, as the
JAX ``_forward_with_loss`` does (the loss outside it); the AMP level
and dtype are part of every graph's key.

Not ported yet, and refused with ``NotImplementedError``: metrics,
evaluation and checkpoints inside ``fit``, and gradient accumulation.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import numpy as np
import torch

from .. import resolve_device
from ..amp.auto_cast import auto_cast
from ..framework import env_knobs
from ..framework.dispatch import (AutoFoldTuner, GroupDispatcher,
                                  build_folded_step)
from ..framework.lazy import LazyScalar, LazyStack
from ..io import DataLoader, Dataset
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


class Model:
    """``device=None`` means the card and raises without one; pass
    ``device="cpu"`` for the CPU.  The network is moved there.  The
    model owns its CUDA graphs (one per batch signature and step knobs)
    and their memory pool: :meth:`release_graphs` frees them, and
    :meth:`prepare` drops them."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None,
                 device=None):
        self.device = resolve_device(device)
        self.network = network.to(self.device)
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._zero_grads: Dict[int, torch.Tensor] = {}
        self.stop_training = False
        self._graphs: Dict[tuple, Any] = {}
        self._graph_pool = None
        self._fold = 0
        self._fold_tuner = None
        self._amp_level, self._amp_dtype = None, "bfloat16"

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if metrics:
            raise _not_ported("Model.prepare(metrics=)", 9)
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
        self._zero_grads = {}

    def parameters(self, *args, **kwargs) -> List[torch.nn.Parameter]:
        return list(self.network.parameters(*args, **kwargs))

    def _to_device(self, values, device):
        out = []
        for v in values:
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            out.append(v.to(device, non_blocking=True))
        return out

    def train_batch(self, inputs, labels=None, update=True):
        """One eager step on one batch: forward, loss, backward and
        (with ``update``) the optimizer step.  Returns ``([loss], [])``
        with the loss as a lazy fp32 device scalar.  ``update=False``
        leaves the parameters and the gradients as they were, as the JAX
        package's discarded step does."""
        self.network.train()
        ins = self._to_device(_to_list(inputs), self.device)
        lbs = self._to_device(_to_list(labels), self.device)
        if update:
            self._optimizer.refresh_lr()
            return [LazyScalar(self._train_step(ins, lbs))], []
        loss = self._forward_loss(ins, lbs)
        return [LazyScalar(loss.detach().float())], []

    def _forward_loss(self, ins, lbs):
        ctx = (auto_cast(level=self._amp_level, dtype=self._amp_dtype)
               if self._amp_level else contextlib.nullcontext())
        with ctx:
            outs = _to_list(self.network(*ins))
        return self._loss(*(outs + lbs)) if self._loss is not None \
            else outs[0]

    def _train_step(self, ins, lbs):
        """The training step on device tensors, the body that the fold
        engine captures: forward, loss, backward, the zero gradients,
        the update (reading the optimizer's learning-rate scalar as it
        stands) and ``clear_grad``.  Returns the loss, fp32, 0-d."""
        loss = self._forward_loss(ins, lbs)
        loss.backward()
        self._zero_missing_grads()
        self._optimizer._step()
        self._optimizer.clear_grad()
        return loss.detach().float()

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

    # -- the fold engine ---------------------------------------------------
    def _stage_group(self, groups):
        """The group's batches as ``[K, ...]`` device tensors, one per
        input and label: stacked on the host (in pinned memory when the
        model is on the card) and copied once, without waiting."""
        out = []
        for col in zip(*[list(ins) + list(lbs) for ins, lbs in groups]):
            vals = [v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v)) for v in col]
            if self.device.type == "cpu" or vals[0].device == self.device:
                out.append(torch.stack([v.to(self.device) for v in vals]))
                continue
            host = torch.empty((len(vals),) + tuple(vals[0].shape),
                               dtype=vals[0].dtype, pin_memory=True)
            torch.stack([v.cpu() for v in vals], out=host)
            out.append(host.to(self.device, non_blocking=True))
        return out

    def _runner(self, batches, n_in):
        """The step runner of this batch signature, these step knobs and
        this AMP level and dtype, built (and on the card captured at its
        first group) once."""
        key = ((n_in,) + tuple((tuple(b.shape[1:]), b.dtype)
                               for b in batches)
               + tuple(env_knobs.get_raw(k) for k in STEP_KNOBS)
               + (self._amp_level, self._amp_dtype))
        runner = self._graphs.get(key)
        if runner is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            opt = self._optimizer

            def per_step(values):
                return self._train_step(values[:n_in], values[n_in:])

            runner = self._graphs[key] = build_folded_step(
                per_step, self.device, self._graph_pool,
                ledgers=((_counts.read, _counts.write),
                         (opt._bookkeeping, opt._set_bookkeeping)))
        return runner

    def _train_batch_folded(self, groups):
        """``len(groups)`` logical steps, one runner call: on the card
        (warm-up and capture at a signature's first group, then) one
        graph replay per step.  Returns the losses as a
        :class:`LazyStack` of the group's ``[K]`` fp32 buffer, fetched
        once when a callback formats one of them."""
        self.network.train()
        batches = self._stage_group(groups)
        runner = self._runner(batches, len(groups[0][0]))
        self._optimizer.refresh_lr()
        losses = torch.empty(len(groups), dtype=torch.float32,
                             device=self.device)
        runner.run(batches, losses)
        return LazyStack(losses), []

    def compile_stats(self) -> Dict[str, int]:
        """``graphs``: the step runners built, one per batch signature
        and step knobs; ``captures``: the CUDA graphs captured (on the
        CPU, the bodies built), one per runner whatever K is.  Growth on
        a fixed workload means a signature that keeps changing."""
        return {"graphs": len(self._graphs),
                "captures": sum(r.captures for r in self._graphs.values())}

    def release_graphs(self) -> None:
        """Free every CUDA graph of this model and drop its pool."""
        for runner in self._graphs.values():
            runner.close()
        self._graphs = {}
        self._graph_pool = None

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
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None,
            steps_per_dispatch=None):
        """Train for ``epochs`` passes over ``train_data`` (a
        :class:`~paddle_tpu_torch.io.Dataset`, batched here, or any
        iterable of batches), at most ``num_iters`` steps per epoch.
        Each batch is ``inputs + labels``; with a loss the last item is
        the label.

        ``steps_per_dispatch=K`` (step folding): K >= 1 runs groups of K
        logical steps through the fold engine (on the card, one graph
        replay per step; see the module docstring), and every K gives
        the same end state, trailing partial groups included; callbacks
        still fire per logical step, after their group ran, with lazy
        views of the group's losses.  ``0`` runs each step through
        :meth:`train_batch`.  ``None`` resolves as the JAX package's
        ``_resolve_fold`` does: 1 when a callback consumes per-step
        events (a verbose :class:`ProgBarLogger`, any ``on_*batch_*``
        hook), else an :class:`AutoFoldTuner` picks K.  (Its branches
        for metrics, by-step LR schedulers and the device mesh do not
        apply: the port refuses metrics and schedulers and has no mesh
        yet.)  ``stop_training``, set by a callback, is read at the end
        of each epoch, which is a group boundary."""
        if eval_data is not None:
            raise _not_ported("Model.fit(eval_data=) / Model.evaluate", 9)
        if save_dir is not None:
            raise _not_ported("Model.fit(save_dir=) / Model.save", 9)
        if int(accumulate_grad_batches) != 1:
            raise _not_ported("Model.fit(accumulate_grad_batches>1)", 9)
        if self._optimizer is None:
            raise RuntimeError("call Model.prepare(optimizer, loss) first")
        if isinstance(train_data, Dataset):
            loader = DataLoader(train_data, batch_size=batch_size,
                                shuffle=shuffle, drop_last=drop_last,
                                num_workers=num_workers)
        else:
            loader = train_data
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = cbk_mod.config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            log_freq=log_freq, verbose=verbose)
        self._fold = self._resolve_fold(steps_per_dispatch, cbks)
        self.stop_training = False
        try:
            cbks.on_begin("train")
            for epoch in range(epochs):
                cbks.on_epoch_begin(epoch)
                logs = self._run_one_epoch(loader, cbks, num_iters)
                cbks.on_epoch_end(epoch, logs)
                if self.stop_training:
                    break
        finally:
            if self._fold_tuner is not None and self._fold_tuner.decided:
                self._fold = self._fold_tuner.fold
        cbks.on_end("train")

    def _resolve_fold(self, requested, cbks):
        """``steps_per_dispatch`` as the JAX ``_resolve_fold`` resolves
        it: 0 for an explicit 0 or less (the eager route), K for an
        explicit K, else 1 when a callback consumes per-step events and
        otherwise 1 with an :class:`AutoFoldTuner` that picks K during
        the first groups."""
        self._fold_tuner = None
        if requested is not None:
            return max(int(requested), 0)
        base = cbk_mod.Callback
        for c in cbks.callbacks:
            if isinstance(c, cbk_mod.ProgBarLogger):
                if c.verbose:
                    return 1      # per-step console cadence expected
                continue
            if any(getattr(type(c), h) is not getattr(base, h)
                   for h in _STEP_HOOKS):
                return 1          # a user hook consumes per-step events
        self._fold_tuner = AutoFoldTuner()
        return 1

    def _run_one_epoch(self, loader, cbks, num_iters=None):
        logs: Dict[str, Any] = {}
        n_label = 0
        if self._loss is not None:
            n_label = len(_to_list(self._labels)) if self._labels else 1

        def emit(step, loss, inputs):
            logs["loss"] = loss
            logs["batch_size"] = inputs[0].shape[0] if inputs else 0
            logs["step"] = step
            cbks.on_batch_end("train", step, logs)

        def emit_group(entries, losses, _mstacks):
            for i, (step, inputs, _) in enumerate(entries):
                cbks.on_batch_begin("train", step, logs)
                emit(step, [losses.view(i)], inputs)

        engine = None
        if self._fold >= 1:
            engine = GroupDispatcher(self._train_batch_folded, emit_group,
                                     fold=self._fold,
                                     tuner=self._fold_tuner)
        for step, data in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            data = _to_list(data)
            inputs = data[:len(data) - n_label]
            labels = data[len(data) - n_label:]
            if engine is not None:
                engine.feed(step, inputs, labels)
                continue
            cbks.on_batch_begin("train", step, logs)
            loss, _ = self.train_batch(inputs, labels)
            emit(step, loss, inputs)
        if engine is not None:
            engine.flush()
        return logs
