"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``):
the callback protocol and the list that fans events out, the progress
logger that ``Model.fit(verbose=, log_freq=)`` installs,
``ModelCheckpoint`` (``fit(save_dir=, save_freq=)``), ``EarlyStopping``,
``LRSchedulerCallback`` and ``VisualDL`` (JSON lines)."""

from __future__ import annotations

import json
import os
import time
from typing import List

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin",
                lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end",
                lambda s, l=None: None)(step, logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def on_begin(self, mode, logs=None):
        for c in self.callbacks:
            c.on_begin(mode, logs)

    def on_end(self, mode, logs=None):
        for c in self.callbacks:
            c.on_end(mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for c in self.callbacks:
            c.on_batch_begin(mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            c.on_batch_end(mode, step, logs)


class ProgBarLogger(Callback):
    """Prints the epoch and, every ``log_freq`` steps, the step's logs
    (loss and metrics), and evaluation's.  Formatting a lazy value is
    where the host waits for the device, so the loop syncs at this
    cadence and not every step."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = max(int(log_freq), 1)
        self.verbose = verbose
        self.epoch = 0
        self._start = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._start = time.time()
        if self.verbose:
            total = self.params.get("epochs")
            print(f"Epoch {epoch + 1}/{total}")

    def _fmt(self, logs):
        items = []
        for k, v in (logs or {}).items():
            if k in ("batch_size", "step"):
                continue
            if isinstance(v, (list, np.ndarray)):
                v = np.asarray(v).reshape(-1)
                v = float(v[0]) if v.size else 0.0
            elif hasattr(v, "_materialize"):
                v = float(v)
            if isinstance(v, float):
                items.append(f"{k}: {v:.4f}")
            else:
                items.append(f"{k}: {v}")
        return " - ".join(items)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            steps = self.params.get("steps")
            print(f"step {step + 1}/{steps} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dur = time.time() - self._start
            print(f"Epoch {epoch + 1} done in {dur:.1f}s - "
                  f"{self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if not isinstance(cur, (int, float)):
            # lists, arrays and LazyScalar all materialize here — the
            # early-stop decision is an epoch-boundary sync point
            cur = float(np.asarray(cur).reshape(-1)[0])
        better = (self.best is None
                  or (self.mode == "min" and cur < self.best -
                      self.min_delta)
                  or (self.mode == "max" and cur > self.best +
                      self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRSchedulerCallback(Callback):
    """Steps the optimizer's LRScheduler per epoch (paddle default) or
    per batch."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        """The optimizer's scheduler.  The port's optimizers take a float
        rate until ``optimizer/lr.py`` is ported (ROADMAP queue A, item
        8), so there is none yet and the callback does nothing; ``fit``
        reads ``by_step`` all the same."""
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()


LRScheduler = LRSchedulerCallback


def config_callbacks(callbacks=None, model=None, batch_size=None,
                     epochs=None, steps=None, log_freq=2, verbose=2,
                     save_freq=1, save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks) if callbacks else []
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRSchedulerCallback) for c in cbks):
        cbks = cbks + [LRSchedulerCallback()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({"batch_size": batch_size, "epochs": epochs,
                   "steps": steps, "verbose": verbose,
                   "metrics": metrics or ["loss"]})
    return cl


class VisualDL(Callback):
    """Scalar-logging callback (parity: paddle.callbacks.VisualDL).

    The visualdl package is not a dependency, so scalars are
    written as JSON-lines under ``log_dir`` (``vdlrecords.*.jsonl`` —
    one record per logged scalar: {tag, step, value, wall_time}).  The
    logged TAGS and cadence match upstream (train/<metric> per
    ``log_freq`` batches, eval/<metric> per epoch end), so scripts that
    attach the callback run unchanged and the scalars stay greppable /
    plottable without the viewer."""

    def __init__(self, log_dir="./log", log_freq: int = 1):
        super().__init__()
        self.log_dir = log_dir
        self.log_freq = max(int(log_freq), 1)
        self._f = None
        self._epoch = 0
        self._steps_seen = 0
        self._eval_count = 0
        self._in_fit = False

    def _writer(self):
        if self._f is None:
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(
                self.log_dir, f"vdlrecords.{int(time.time())}.jsonl")
            self._f = open(path, "a")
        return self._f

    def _add_scalars(self, prefix, logs, step):
        if not logs:
            return
        w = self._writer()
        for k, v in logs.items():
            if k in ("batch_size", "num_steps"):
                continue
            try:
                val = float(v[0] if isinstance(v, (list, tuple)) else v)
            except (TypeError, ValueError):
                continue
            w.write(json.dumps({"tag": f"{prefix}/{k}", "step": step,
                                "value": val,
                                "wall_time": time.time()}) + "\n")
        w.flush()

    def on_train_begin(self, logs=None):
        self._in_fit = True

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        self._steps_seen += 1
        if self._steps_seen % self.log_freq == 0:
            self._add_scalars("train", logs, self._steps_seen)

    def on_epoch_end(self, epoch, logs=None):
        self._add_scalars("train", logs, self._steps_seen)

    def on_eval_end(self, logs=None):
        # inside fit: x-axis is the epoch; standalone evaluate() calls
        # get their own monotonically increasing counter
        step = self._epoch if self._in_fit else self._eval_count
        self._eval_count += 1
        self._add_scalars("eval", logs, step)

    def on_train_end(self, logs=None):
        self._in_fit = False
        if self._f is not None:
            self._f.close()
            self._f = None
