"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``):
the callback protocol, the list that fans events out, and the progress
logger that ``Model.fit(verbose=, log_freq=)`` installs."""

from __future__ import annotations

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

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = callbacks

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
    """Prints the epoch and, every ``log_freq`` steps, the step's logs.
    Formatting a lazy loss is where the host waits for the device, so
    the loop syncs at this cadence and not every step."""

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
            print(f"Epoch {epoch + 1}/{self.params.get('epochs')}")

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
            items.append(f"{k}: {v:.4f}" if isinstance(v, float)
                         else f"{k}: {v}")
        return " - ".join(items)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            print(f"step {step + 1}/{self.params.get('steps')} - "
                  f"{self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1} done in {time.time() - self._start:.1f}"
                  f"s - {self._fmt(logs)}")


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2):
    """The callback list of one ``fit``: the caller's callbacks, with a
    :class:`ProgBarLogger` in front when ``verbose`` and none was
    given."""
    cbks = list(callbacks) if callbacks else []
    if verbose and not any(isinstance(c, ProgBarLogger) for c in cbks):
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                   "metrics": ["loss"]})
    return cl
