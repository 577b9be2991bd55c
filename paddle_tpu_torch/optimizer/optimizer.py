"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``):
the ``Optimizer`` base with fp32 master weights for bf16 parameters,
and ``Adam``/``AdamW`` with Paddle's exact update.

Paddle's Adam step, as the JAX package writes it::

    m1 = b1*m1 + (1-b1)*g;  m2 = b2*m2 + (1-b2)*g^2
    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    w = w - lr_t * m1 / (sqrt(m2) + eps*sqrt(1 - b2^t))
    w = w - lr*decay*w_old                       (AdamW, decoupled)

The per-step scalars (``b1^t``, ``b2^t``, ``lr_t``, the epsilon term,
``lr*decay``) are computed in float32 as the JAX package computes them;
the tensor updates run as ``torch._foreach_*`` ops over every parameter
that shares a device, a step count and a working dtype, in place.
With ``multi_precision``, a bf16/fp16 parameter keeps an fp32 master
copy in its state: the update runs on the master and the parameter
receives its rounding.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

_LOW = (torch.bfloat16, torch.float16)


class Optimizer:
    """Base: the parameter list, the learning rate, the fp32 masters and
    ``step``/``clear_grad``.  Subclasses give ``_init_state`` and
    ``_update_group``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported yet (ROADMAP "
                "queue A, item 6: optimizer/lr.py); pass a float")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet (ROADMAP queue A, item 6: "
                "nn/clip_grad.py)")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(
                "regularizer objects (L1Decay/L2Decay) are not ported yet "
                "(ROADMAP queue A, item 6); pass a float")
        self._parameter_list = list(parameters)
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        self._multi_precision = bool(multi_precision)
        self._state: Dict[int, dict] = {}   # by position in the list
        self._global_step = 0

    def get_lr(self) -> float:
        return self._learning_rate

    def parameters(self) -> List[torch.nn.Parameter]:
        return list(self._parameter_list)

    def _init_state(self, value: torch.Tensor) -> dict:
        return {}

    def _ensure_state(self, i: int, p: torch.Tensor) -> dict:
        st = self._state.get(i)
        if st is None:
            master = self._multi_precision and p.dtype in _LOW
            work = p.detach().float() if master else p.detach()
            st = self._init_state(work)
            st["steps"] = 0
            if master:
                st["master_weight"] = work   # a copy, fp32
            self._state[i] = st
        return st

    @torch.no_grad()
    def step(self) -> None:
        """Apply one update to every parameter that has a gradient."""
        lr = self.get_lr()
        self._global_step += 1
        groups: Dict[tuple, list] = {}
        for i, p in enumerate(self._parameter_list):
            if not p.requires_grad or p.grad is None:
                continue
            st = self._ensure_state(i, p)
            work = st.get("master_weight", p)
            key = (work.device, work.dtype, st["steps"])
            groups.setdefault(key, []).append((p, st))
        for (_, _, steps), items in groups.items():
            works = [st.get("master_weight", p) for p, st in items]
            grads = [p.grad.to(w.dtype) for (p, _), w in zip(items, works)]
            self._update_group(works, grads, [st for _, st in items], lr)
            for p, st in items:
                st["steps"] = steps + 1
                if "master_weight" in st:
                    p.copy_(st["master_weight"])

    def _update_group(self, works, grads, states, lr):
        raise NotImplementedError

    def clear_grad(self) -> None:
        for p in self._parameter_list:
            p.grad = None


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        if lazy_mode or amsgrad:
            raise NotImplementedError(
                "Adam lazy_mode/amsgrad are not ported yet (ROADMAP queue "
                "A, item 6)")
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._decoupled = False

    def _init_state(self, value):
        return {"moment1": torch.zeros_like(value),
                "moment2": torch.zeros_like(value),
                "beta1_pow": np.float32(1.0), "beta2_pow": np.float32(1.0)}

    def _scalars(self, states, lr):
        """Advance the beta powers and form this step's scalars in
        float32, as the JAX package does: ``(lr_t, eps_t, lr*decay)``.
        Every state of a group has taken the same number of steps, so
        they share their powers."""
        f = np.float32
        b1p = f(states[0]["beta1_pow"] * f(self._beta1))
        b2p = f(states[0]["beta2_pow"] * f(self._beta2))
        for st in states:
            st["beta1_pow"], st["beta2_pow"] = b1p, b2p
        lr32 = f(lr)
        lr_t = f(lr32 * np.sqrt(f(1) - b2p, dtype=f) / (f(1) - b1p))
        eps_t = f(f(self._epsilon) * np.sqrt(f(1) - b2p, dtype=f))
        return float(lr_t), float(eps_t), float(f(lr32 * f(self._weight_decay)))

    def _update_group(self, works, grads, states, lr):
        b1, b2 = self._beta1, self._beta2
        lr_t, eps_t, lr_decay = self._scalars(states, lr)
        m1 = [st["moment1"] for st in states]
        m2 = [st["moment2"] for st in states]
        if self._weight_decay and not self._decoupled:
            grads = torch._foreach_add(grads, works,
                                       alpha=self._weight_decay)
        torch._foreach_mul_(m1, b1)
        torch._foreach_add_(m1, grads, alpha=1 - b1)
        torch._foreach_mul_(m2, b2)
        torch._foreach_addcmul_(m2, grads, grads, value=1 - b2)
        decayed = (torch._foreach_mul(works, lr_decay)
                   if self._weight_decay and self._decoupled else None)
        denom = torch._foreach_sqrt(m2)
        torch._foreach_add_(denom, eps_t)
        torch._foreach_addcdiv_(works, m1, denom, value=-lr_t)
        if decayed is not None:
            torch._foreach_sub_(works, decayed)


class AdamW(Adam):
    """Adam with decoupled weight decay on the pre-step value
    (``weight_decay`` default 0.01, applied to every parameter)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        if lr_ratio is not None or apply_decay_param_fun is not None:
            raise NotImplementedError(
                "AdamW lr_ratio/apply_decay_param_fun are not ported yet "
                "(ROADMAP queue A, item 6)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         float(weight_decay) if weight_decay else 0.0,
                         grad_clip, lazy_mode, multi_precision, name,
                         amsgrad)
        self._decoupled = True
