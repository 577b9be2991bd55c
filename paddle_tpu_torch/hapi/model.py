"""``paddle.Model`` (counterpart of ``paddle_tpu/hapi/model.py``).

The JAX package compiles forward, loss, gradients and the optimizer
update into one XLA program per step.  The port runs the same step
eagerly on PyTorch: forward through the network (whose attention is the
flash kernel on the card), ``loss.backward()``, ``optimizer.step()``,
``optimizer.clear_grad()``.  Before the update, every trainable
parameter of the optimizer that got no gradient is given a zero one,
since the JAX step differentiates all of them and AdamW then decays
each.  Every launch is asynchronous; the step's
loss rides the callbacks as a :class:`~paddle_tpu_torch.framework.
LazyScalar` of the device tensor, so the loop itself never waits for
the device: only a callback that formats a loss does.

Not ported yet, and refused with ``NotImplementedError``: metrics,
``amp_configs`` (``auto_cast``; use ``amp.decorate(level="O2")``),
evaluation and checkpoints inside ``fit``, gradient accumulation, and
step folding (``steps_per_dispatch > 1``, whose torch form is a
CUDA-graph capture of K steps).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .. import resolve_device
from ..framework.lazy import LazyScalar
from ..io import DataLoader, Dataset
from . import callbacks as cbk_mod


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue A, item {item})")


class Model:
    """``device=None`` means the card and raises without one; pass
    ``device="cpu"`` for the CPU.  The network is moved there."""

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

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if metrics:
            raise _not_ported("Model.prepare(metrics=)", 7)
        if amp_configs:
            raise _not_ported(
                "Model.prepare(amp_configs=) (auto_cast O1/O2); use "
                "amp.decorate(model, optimizer, level='O2') instead,", 6)
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
        """One step on one batch: forward, loss, backward and (with
        ``update``) the optimizer step.  Returns ``([loss], [])`` with
        the loss as a lazy fp32 device scalar.  ``update=False`` leaves
        the parameters and the gradients as they were, as the JAX
        package's discarded step does."""
        self.network.train()
        ins = self._to_device(_to_list(inputs), self.device)
        lbs = self._to_device(_to_list(labels), self.device)
        outs = _to_list(self.network(*ins))
        loss = self._loss(*(outs + lbs)) if self._loss is not None \
            else outs[0]
        if update:
            loss.backward()
            self._zero_missing_grads()
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [LazyScalar(loss.detach().float())], []

    def _zero_missing_grads(self):
        """Give each trainable parameter of the optimizer that got no
        gradient a zero one, as the JAX step (``jax.value_and_grad``
        over every parameter) does, so AdamW's decoupled decay still
        applies to it.  Each zero tensor is allocated once and reused;
        no update writes into a gradient."""
        for i, p in enumerate(self._optimizer.parameters()):
            if p.requires_grad and p.grad is None:
                zero = self._zero_grads.get(i)
                if zero is None:
                    zero = self._zero_grads[i] = torch.zeros_like(p)
                p.grad = zero

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None,
            steps_per_dispatch=None):
        """Train for ``epochs`` passes over ``train_data`` (a
        :class:`~paddle_tpu_torch.io.Dataset`, batched here, or any
        iterable of batches), at most ``num_iters`` steps per epoch.
        Each batch is ``inputs + labels``; with a loss the last item is
        the label.  ``steps_per_dispatch`` may be None, 0 or 1 (one
        step per dispatch); larger values raise."""
        if eval_data is not None:
            raise _not_ported("Model.fit(eval_data=) / Model.evaluate", 7)
        if save_dir is not None:
            raise _not_ported("Model.fit(save_dir=) / Model.save", 7)
        if int(accumulate_grad_batches) != 1:
            raise _not_ported("Model.fit(accumulate_grad_batches>1)", 7)
        if steps_per_dispatch is not None and int(steps_per_dispatch) > 1:
            raise _not_ported(
                "Model.fit(steps_per_dispatch>1) (step folding; its torch "
                "form is a CUDA-graph capture of K steps)", 7)
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
        self.stop_training = False
        cbks.on_begin("train")
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            logs = self._run_one_epoch(loader, cbks, num_iters)
            cbks.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        cbks.on_end("train")

    def _run_one_epoch(self, loader, cbks, num_iters=None):
        logs: Dict[str, Any] = {}
        n_label = 0
        if self._loss is not None:
            n_label = len(_to_list(self._labels)) if self._labels else 1
        for step, data in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            data = _to_list(data)
            inputs = data[:len(data) - n_label]
            labels = data[len(data) - n_label:]
            cbks.on_batch_begin("train", step, logs)
            loss, _ = self.train_batch(inputs, labels)
            logs["loss"] = loss
            logs["batch_size"] = inputs[0].shape[0] if inputs else 0
            logs["step"] = step
            cbks.on_batch_end("train", step, logs)
        return logs
