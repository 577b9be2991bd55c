"""``GradScaler`` / ``AmpScaler`` (counterpart of
``paddle_tpu/amp/grad_scaler.py``, upstream
``python/paddle/amp/grad_scaler.py``): dynamic loss scaling for fp16.

The loop it serves, as PaddleNLP writes it::

    with paddle.amp.auto_cast(level="O2", dtype="float16"):
        loss = criterion(model(x), y)
    scaler.scale(loss).backward()
    scaler.step(opt)          # unscale, and skip the step on inf/NaN
    scaler.update()
    opt.clear_grad()

``unscale_`` multiplies every gradient by ``1 / scale`` in place (a
power of two while the scale stays one: exact unless a value
underflows) and tests all of them for a non-finite value on the device
(``torch._amp_foreach_non_finite_check_and_unscale_``); ``step`` reads
that flag on the host once, the one sync a step, as the JAX scaler's
``bool(jnp.any(~jnp.isfinite(g)))`` does, and on a non-finite gradient
does not call ``optimizer.step()`` at all: no moment, beta power, master,
step count or ``_global_step`` moves.  ``update`` then halves the scale
(``decr_ratio``, at most down to 1) after ``decr_every_n_nan_or_inf``
bad steps, and doubles it (``incr_ratio``) after
``incr_every_n_steps`` good ones.  A sparse row gradient
(``Embedding(sparse=True)``) is unscaled and checked in its values, as
the JAX scaler's ``SelectedRows`` branch does; a skipped step moves no
row and no moment.
"""

from __future__ import annotations

from typing import Dict

import torch


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        self._step_called = False
        self._found_flags = None

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self) -> torch.Tensor:
        return torch.tensor(self._scale, dtype=torch.float32)

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient of ``optimizer`` by the scale, in place,
        and note whether any is inf or NaN (read by :meth:`step`)."""
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        by_device: Dict[torch.device, list] = {}
        for p in optimizer._parameter_list:
            g = p.grad
            if g is not None:
                # a sparse gradient's values, in place (an alias)
                by_device.setdefault(g.device, []).append(
                    g._values() if g.is_sparse else g)
        found = []
        for device, grads in by_device.items():
            flag = torch.zeros(1, dtype=torch.float32, device=device)
            inv = torch.full((1,), 1.0 / self._scale, dtype=torch.float32,
                             device=device)
            torch._amp_foreach_non_finite_check_and_unscale_(grads, flag, inv)
            found.append(flag)
        self._found_flags = found

    def _read_found(self) -> bool:
        flags, self._found_flags = self._found_flags or [], None
        return any(bool(f) for f in flags)     # the host read

    def step(self, optimizer):
        """Unscale, then ``optimizer.step()`` unless a gradient is not
        finite.  The scale moves in :meth:`update`, which must come
        before the next ``step``."""
        if not self._enable:
            optimizer.step()
            return
        if self._step_called:
            raise RuntimeError(
                "scaler.step() has already been called since the last "
                "update(); call scaler.update() after each step")
        self.unscale_(optimizer)
        self._found_inf = self._read_found()
        if not self._found_inf:
            optimizer.step()
        self._step_called = True

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        self._unscaled = False
        self._step_called = False
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._unscaled = False

    def state_dict(self) -> Dict:
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)


AmpScaler = GradScaler
