"""``LBFGS`` (counterpart of ``paddle_tpu/optimizer/lbfgs.py``, upstream
``python/paddle/optimizer/lbfgs.py``).

Closure-style quasi-Newton optimizer: ``opt.step(closure)`` runs up to
``max_iter`` L-BFGS iterations, re-running the closure (which clears
the gradients, computes the loss, calls ``backward()`` and returns the
loss) wherever the line search probes a point.

The JAX package drives optax's ``lbfgs`` (``scale_by_lbfgs``, then
``-learning_rate``, then with ``line_search_fn="strong_wolfe"`` the
zoom line search, ``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy="one")``).  The port writes the same algorithm
itself, over the trainable parameters flattened into one fp32 vector on
their device:

- the memory of the last ``history_size`` parameter and gradient
  differences with weights ``1 / <dg, dw>`` (0 where that is 0), the
  two-loop recursion from the newest pair back, and the identity scale
  ``<dg, dw> / |dg|^2`` (1 where ``|dg| = 0``; ``min(1, 1/|g|)`` at the
  first iteration);
- the zoom line search of Nocedal and Wright (3.5, 3.6) with optax's
  criteria (sufficient decrease with the approximate Wolfe variant,
  ``slope_rtol=1e-4``, ``curv_rtol=0.9``, ``approx_dec_rtol=1e-6``),
  its interval search doubling from 1, cubic then quadratic then
  bisection steps inside the interval, and its fall-back to the best
  step with sufficient decrease.  As in the JAX package the line
  search sees the closure's own loss and gradient, while the direction
  uses the gradient after ``grad_clip`` and the regularizers.

Eager only: the line search decides on the host, so each probe reads
its loss and slope there.  ``max_eval`` counts the closure's runs,
every probe included (the JAX package counts a line search's probes
as two, however many it ran).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .optimizer import Optimizer


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa) with slope fpa
    at a, (b, fb) and (c, fc); NaN where there is none."""
    with np.errstate(all="ignore"):
        C = fpa
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        r1, r2 = fb - fa - C * db, fc - fa - C * dc
        A = (dc ** 2 * r1 - db ** 2 * r2) / denom
        B = (-(dc ** 3) * r1 + db ** 3 * r2) / denom
        radical = B * B - 3.0 * A * C
        return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa) with slope
    fpa at a and (b, fb)."""
    with np.errstate(all="ignore"):
        B = (fb - fa - fpa * (b - a)) / ((b - a) ** 2)
        return a - fpa / (2.0 * B)


class _ZoomLinesearch:
    """optax's ``zoom_linesearch`` with its defaults (``tol=0``,
    ``increase_factor=2``, no largest step), run on the host.  Scalars
    are float64 numpy values, so a division by zero gives inf/NaN as the
    JAX version's does and every comparison with NaN is False."""

    SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
    INTERVAL_THRESHOLD, INCREASE, MAX_STEPS = 1e-5, 2.0, 20

    def __init__(self, value_and_grad, params, updates, value, grad):
        self.f = value_and_grad         # point -> (float, grad vector)
        self.params, self.updates = params, updates
        slope = np.float64(torch.dot(updates, grad).item())
        value = np.float64(value)
        zero = np.float64(0.0)
        self.count = 0
        self.stepsize, self.value, self.slope = zero, value, slope
        self.value_init, self.slope_init = value, slope
        self.decrease_error = np.float64(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = zero, value, slope
        self.high, self.value_high, self.slope_high = zero, value, slope
        self.cubic_ref, self.value_cubic_ref = zero, value
        self.safe_stepsize, self.safe_value = zero, value

    def _on_line(self, stepsize):
        """The value and the slope along the direction at ``stepsize``."""
        value, grad = self.f(self.params + float(stepsize) * self.updates)
        return np.float64(value), np.float64(torch.dot(grad,
                                                       self.updates).item())

    def _errors(self, stepsize, value, slope):
        with np.errstate(all="ignore"):
            dec = value - self.value_init - \
                self.SLOPE_RTOL * stepsize * self.slope_init
            # np.maximum / np.minimum carry a NaN through, as jnp's do
            approx = np.maximum(slope - (2 * self.SLOPE_RTOL - 1.0) *
                                self.slope_init,
                                value - self.value_init -
                                self.APPROX_DEC_RTOL * abs(self.value_init))
            dec = np.maximum(np.minimum(approx, dec), 0.0)
            dec = np.float64(np.inf) if np.isnan(dec) else np.float64(dec)
            curv = np.maximum(abs(slope) - self.CURV_RTOL *
                              abs(self.slope_init), 0.0)
            curv = np.float64(np.inf) if np.isnan(curv) else np.float64(curv)
        return dec, curv

    def _search_interval(self):
        prev = (self.stepsize, self.value, self.slope)
        new = np.float64(1.0) if self.count == 0 else \
            self.INCREASE * self.stepsize
        value, slope = self._on_line(new)
        dec, curv = self._errors(new, value, slope)
        error = np.maximum(dec, curv)
        if dec <= 0.0:
            self.safe_stepsize, self.safe_value = new, value
        set_high = dec > 0.0 or (value >= prev[1] and self.count > 0)
        set_low = slope >= 0.0 and not set_high
        if set_low:
            (self.low, self.value_low, self.slope_low, self.high,
             self.value_high, self.slope_high) = (new, value, slope) + prev
        else:
            (self.low, self.value_low, self.slope_low, self.high,
             self.value_high, self.slope_high) = prev + (new, value, slope)
        self.interval_found = set_high or set_low or error <= 0.0
        self.done = bool(error <= 0.0)
        self.failed = self.count + 1 >= self.MAX_STEPS and not self.done
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self.stepsize, self.value, self.slope = new, value, slope
        self.decrease_error = dec
        self.count += 1

    def _zoom(self):
        low, high = self.low, self.high
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        too_small = delta <= self.INTERVAL_THRESHOLD
        cubic = _cubicmin(low, self.value_low, self.slope_low, high,
                          self.value_high, self.cubic_ref,
                          self.value_cubic_ref)
        use_cubic = left + 0.2 * delta < cubic < right - 0.2 * delta
        quad = _quadmin(low, self.value_low, self.slope_low, high,
                        self.value_high)
        use_quad = not use_cubic and \
            left + 0.1 * delta < quad < right - 0.1 * delta
        middle = cubic if use_cubic else quad if use_quad else \
            (low + high) / 2.0
        value, slope = self._on_line(middle)
        dec, curv = self._errors(middle, value, slope)
        error = np.maximum(dec, curv)
        if dec <= 0.0 and value < self.safe_value:
            self.safe_stepsize, self.safe_value = middle, value
        self.done = bool(error <= 0.0)
        set_high_mid = dec > 0.0 or value >= self.value_low
        set_high_low = slope * (high - low) >= 0.0 and not set_high_mid
        new_high = (middle, value, slope) if set_high_mid else \
            (self.high, self.value_high, self.slope_high)
        if set_high_low:
            new_high = (self.low, self.value_low, self.slope_low)
        new_low = (self.low, self.value_low, self.slope_low) \
            if set_high_mid else (middle, value, slope)
        self.cubic_ref, self.value_cubic_ref = (
            (self.high, self.value_high) if set_high_mid or set_high_low
            else (self.low, self.value_low))
        self.high, self.value_high, self.slope_high = new_high
        self.low, self.value_low, self.slope_low = new_low
        failed = (self.count + 1 >= self.MAX_STEPS or
                  (too_small and self.safe_stepsize > 0.0))
        self.failed = failed and not self.done
        self.stepsize, self.value, self.slope = middle, value, slope
        self.decrease_error = dec
        self.count += 1

    def run(self) -> float:
        """The accepted step size."""
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom()
            else:
                self._search_interval()
            if self.failed and (self.safe_stepsize > 0.0 or
                                np.isinf(self.decrease_error)):
                self.stepsize = self.safe_stepsize
        return float(self.stepsize)


class LBFGS(Optimizer):
    """L-BFGS over the trainable parameters (module docstring)."""

    def __init__(self, learning_rate: float = 1.0, max_iter: int = 20,
                 max_eval: Optional[int] = None,
                 tolerance_grad: float = 1e-7,
                 tolerance_change: float = 1e-9,
                 history_size: int = 100,
                 line_search_fn: Optional[str] = None,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate=learning_rate, parameters=parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         name=name)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(
                f"line_search_fn must be None or 'strong_wolfe', got "
                f"{line_search_fn!r}")
        self._max_iter = int(max_iter)
        self._max_eval = (int(max_eval) if max_eval is not None
                          else self._max_iter * 5 // 4)
        self._tol_grad = float(tolerance_grad)
        self._tol_change = float(tolerance_change)
        self._history = int(history_size)
        self._line_search = line_search_fn
        self._mem = None      # the curvature memory, kept across steps

    def _update_group(self, works, grads, states, lr, decay):
        raise RuntimeError(
            "LBFGS has no per-tensor update rule; call opt.step(closure) "
            "with a loss closure")

    # -- closure plumbing --------------------------------------------------
    def _trainable(self):
        return [(i, p) for i, p in enumerate(self._parameter_list)
                if p.requires_grad]

    @torch.no_grad()
    def _set_params(self, flat):
        offset = 0
        for _, p in self._trainable():
            n = p.numel()
            p.copy_(flat[offset:offset + n].view(p.shape).to(p.dtype))
            offset += n

    def _flat(self, tensors):
        return torch.cat([t.detach().reshape(-1).float() for t in tensors])

    def _raw(self, closure):
        """The closure's loss and gradient at the current parameters (a
        missing gradient counts as 0): what the line search sees."""
        with torch.enable_grad():
            loss = closure()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in self._trainable()]
        return loss, self._flat(grads)

    def _eval(self, closure):
        """The closure's loss and the gradient the direction uses: the
        clip, then ``+ decay * w`` and ``+ l1 * sign(w)`` per parameter,
        as the JAX package's ``_eval``."""
        with torch.enable_grad():
            loss = closure()
        trainable = self._trainable()
        pairs = [(p, p.grad) for _, p in trainable if p.grad is not None]
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        got = {id(p): g for p, g in pairs}
        grads = []
        with torch.no_grad():
            for i, p in trainable:
                g = got.get(id(p))
                g = torch.zeros_like(p) if g is None else g
                decay = self._param_decay(i, p)
                if decay:
                    g = g + decay * p
                l1 = self._param_l1(i, p)
                if l1:
                    g = g + l1 * torch.sign(p)
                grads.append(g)
        return loss, self._flat(grads)

    # -- the two-loop recursion (optax scale_by_lbfgs) ---------------------
    def _precondition(self, params, grads):
        m, n = self._history, params.numel()
        if self._mem is None:
            z = torch.zeros((m, n), dtype=torch.float32, device=params.device)
            self._mem = {"count": 0, "params": torch.zeros_like(params),
                         "updates": torch.zeros_like(params),
                         "dw": z, "du": z.clone(),
                         "rho": torch.zeros(m, dtype=torch.float32,
                                            device=params.device)}
        mem = self._mem
        count = mem["count"]
        idx, prev = count % m, (count - 1) % m
        if count > 0:
            dw, du = params - mem["params"], grads - mem["updates"]
            inner = torch.dot(du, dw)
            weight = torch.where(inner == 0.0, torch.zeros_like(inner),
                                 1.0 / inner)
            den = torch.dot(du, du)
            gamma = torch.where(den > 0.0, inner / den,
                                torch.ones_like(inner))
        else:
            dw = du = torch.zeros_like(params)
            weight = torch.zeros((), device=params.device)
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grads),
                                max=1.0)
        mem["dw"][prev], mem["du"][prev], mem["rho"][prev] = dw, du, weight
        order = [(idx + k) % m for k in range(m)]
        vec, alphas = grads.clone(), {}
        for j in reversed(order):
            alphas[j] = mem["rho"][j] * torch.dot(mem["dw"][j], vec)
            vec = vec - alphas[j] * mem["du"][j]
        vec = gamma * vec
        for j in order:
            beta = mem["rho"][j] * torch.dot(mem["du"][j], vec)
            vec = vec + (alphas[j] - beta) * mem["dw"][j]
        mem["count"] = count + 1
        mem["params"], mem["updates"] = params.clone(), grads.clone()
        return vec

    @torch.no_grad()
    def step(self, closure: Callable = None):
        """Run up to ``max_iter`` L-BFGS iterations and return the last
        loss evaluated at an iterate.  ``closure`` must clear the
        gradients, compute the loss, call ``backward()`` and return the
        loss; the line search runs it again at each probe."""
        if closure is None:
            raise ValueError(
                "LBFGS.step requires a closure: step(lambda: "
                "(opt.clear_grad(), loss:=compute(), loss.backward(), "
                "loss)[-1])")
        trainable = self._trainable()
        names = [self._decay_name(i, p) for i, p in trainable]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(
                f"LBFGS: duplicate parameter names {dup}; give the "
                "parameters distinct names")
        lr = float(self.get_lr())
        params = self._flat([p for _, p in trainable])
        evals = [0]

        def value_and_grad(point):
            evals[0] += 1
            self._set_params(point)
            loss, g = self._raw(closure)
            return float(loss), g

        loss = None
        for _ in range(self._max_iter):
            if evals[0] >= self._max_eval:
                break
            self._set_params(params)
            loss, grads = self._eval(closure)
            evals[0] += 1
            if float(grads.abs().max()) <= self._tol_grad:
                break
            updates = -lr * self._precondition(params, grads)
            if self._line_search == "strong_wolfe":
                ls = _ZoomLinesearch(value_and_grad, params, updates,
                                     float(loss), grads)
                updates = ls.run() * updates
            new_params = params + updates
            change = float((new_params - params).abs().max())
            params = new_params
            if change <= self._tol_change:
                break
        self._set_params(params)
        self._global_step += 1
        return None if loss is None else loss.detach()
