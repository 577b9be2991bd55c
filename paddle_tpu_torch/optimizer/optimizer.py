"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``):
the ``Optimizer`` base with fp32 master weights for bf16 parameters,
``Adam``/``AdamW`` and ``Momentum`` with Paddle's exact updates.

Paddle's Adam step, as the JAX package writes it::

    m1 = b1*m1 + (1-b1)*g;  m2 = b2*m2 + (1-b2)*g^2
    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    w = w - lr_t * m1 / (sqrt(m2) + eps*sqrt(1 - b2^t))
    w = w - lr*decay*w_old                       (AdamW, decoupled)

The per-step scalars live on the parameters' device, so that a CUDA
graph of the training step (``Model.fit(steps_per_dispatch=K)``,
``framework/dispatch.py``) replays them as an eager step computes them:
the beta powers ``b1^t``, ``b2^t`` are 0-d fp32 tensors in each state,
advanced in place, and ``lr_t``, the epsilon term and ``lr*decay`` are
formed from them by tensor ops in float32, in the JAX package's order.
The learning rate is a 0-d fp32 tensor per device too
(:meth:`Optimizer.refresh_lr` writes ``get_lr()`` into it: ``step``
does so, the fold engine once a group, as the JAX engine passes ``lr``
per dispatch).  The tensor updates run as ``torch._foreach_*`` ops over
every parameter that shares a device, a step count and a working
dtype, in place.  ``steps`` in each state and ``_global_step`` are host
bookkeeping, which the fold engine advances by the number of replays.
With ``multi_precision``, a bf16/fp16 parameter keeps an fp32 master
copy in its state: the update runs on the master and the parameter
receives its rounding.  Without one, ``Adam``/``AdamW`` still keep its
moments in fp32, as the JAX package does: the update (decoupled decay
included) runs on an fp32 copy of the value, which is rounded back
into the parameter once (``Adam._moments_low``).
"""

from __future__ import annotations

import math
import re
import warnings
from typing import Dict, List

import numpy as np
import torch

_LOW = (torch.bfloat16, torch.float16)
_aten = torch.ops.aten


def _as_tensor(v) -> torch.Tensor:
    """A checkpoint value (tensor, numpy array or number) as a tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    if isinstance(v, np.ndarray):
        from ..framework.io import array_to_tensor
        return array_to_tensor(v)
    return torch.as_tensor(np.asarray(v))


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
                "queue A, item 8: optimizer/lr.py); pass a float")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet (ROADMAP queue A, item 8: "
                "nn/clip_grad.py)")
        if weight_decay is not None and not isinstance(weight_decay,
                                                       (int, float)):
            raise NotImplementedError(
                "regularizer objects (L1Decay/L2Decay) are not ported yet "
                "(ROADMAP queue A, item 8); pass a float")
        self._parameter_list = list(parameters)
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        self._multi_precision = bool(multi_precision)
        self._state: Dict[int, dict] = {}   # by position in the list
        self._param_names = None            # set_param_names
        self._global_step = 0
        self._lr_dev: Dict[torch.device, torch.Tensor] = {}
        self._lr_held: Dict[torch.device, float] = {}

    def get_lr(self) -> float:
        return self._learning_rate

    def _lr_scalar(self, device) -> torch.Tensor:
        """The learning rate the update reads: a 0-d fp32 tensor on
        ``device``, made on first use with ``get_lr()``."""
        t = self._lr_dev.get(device)
        if t is None:
            lr = self.get_lr()
            t = torch.full((), lr, dtype=torch.float32, device=device)
            self._lr_dev[device], self._lr_held[device] = t, lr
        return t

    def refresh_lr(self) -> None:
        """Write ``get_lr()`` into each device's learning-rate scalar
        that holds another value (one fill per device, no sync)."""
        lr = self.get_lr()
        for device, t in self._lr_dev.items():
            if self._lr_held[device] != lr:
                t.fill_(lr)
                self._lr_held[device] = lr

    def _bookkeeping(self) -> Dict[object, int]:
        """The host step counts: ``_global_step`` under ``None`` and each
        state's ``steps`` under its position."""
        books = {i: st["steps"] for i, st in self._state.items()}
        books[None] = self._global_step
        return books

    def _set_bookkeeping(self, books: Dict[object, int]) -> None:
        for i, n in books.items():
            if i is None:
                self._global_step = n
            else:
                self._state[i]["steps"] = n

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

    def step(self) -> None:
        """Apply one update to every parameter that has a gradient."""
        self.refresh_lr()
        self._step()

    @torch.no_grad()
    def _step(self) -> None:
        """:meth:`step` without the learning-rate refresh: the body the
        fold engine captures, whose learning rate it refreshes per
        group."""
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
            lr = self._lr_scalar(works[0].device)
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

    # -- checkpoint ---------------------------------------------------------
    def _param_name(self, i: int) -> str:
        names = self._param_names
        return names[i] if names is not None else f"param_{i}"

    def set_param_names(self, names) -> None:
        """Name the parameters for :meth:`state_dict` (``Model`` hands
        over the network's ``named_parameters()`` names); unnamed, a
        parameter is ``param_<position>``, as the JAX package's auto
        names are."""
        names = list(names)
        if len(names) != len(self._parameter_list):
            raise ValueError(f"{len(names)} names for "
                             f"{len(self._parameter_list)} parameters")
        self._param_names = names

    def state_dict(self) -> Dict[str, object]:
        """``<param name>.<slot>`` for every slot of every state (the
        moments, the beta powers, ``master_weight``), as CPU copies, and
        ``global_step``: the JAX package's keys and only those.  The host
        step counts are not written; :meth:`set_state_dict` rebuilds
        them."""
        out: Dict[str, object] = {}
        for i in sorted(self._state):
            name = self._param_name(i)
            for k, v in self._state[i].items():
                if k != "steps":
                    out[f"{name}.{k}"] = v.detach().cpu().clone()
        out["global_step"] = self._global_step
        return out

    # upstream .pdopt accumulator keys: "<param>_<slot>_<ordinal>"
    # (e.g. "linear_0.w_0_moment1_0"); the map translates the slot
    # vocabulary into the JAX package's
    _UPSTREAM_SLOT_MAP = {
        "moment1": "moment1", "moment2": "moment2",
        "moment2_max": "moment2_max",
        "beta1_pow_acc": "beta1_pow", "beta2_pow_acc": "beta2_pow",
        "velocity": "velocity", "mean_square": "mean_square",
        "mean_grad": "mean_grad", "momentum": "momentum_acc",
        "moment": "moment",
    }
    _UPSTREAM_KEY = re.compile(
        r"^(?P<p>.+)_(?P<slot>moment1|moment2|moment2_max|"
        r"beta1_pow_acc|beta2_pow_acc|velocity|mean_square|"
        r"mean_grad|momentum|moment)_(?P<i>\d+)$")

    def _maybe_import_upstream(self, sd: Dict[str, object]):
        """An upstream Paddle ``.pdopt`` (keys in the accumulator grammar
        above) translated into the JAX package's keys, its slot groups
        mapped onto the parameters by position (their first appearance
        is creation order), as ``paddle_tpu/optimizer/optimizer.py::
        _maybe_import_upstream`` does.  Any other dict is returned as it
        is."""
        pat = self._UPSTREAM_KEY
        if not any(isinstance(k, str) and pat.match(k) for k in sd):
            return sd
        groups: Dict[str, dict] = {}
        for k, v in sd.items():
            m = pat.match(k) if isinstance(k, str) else None
            if m is None:
                continue
            slot = self._UPSTREAM_SLOT_MAP[m.group("slot")]
            t = _as_tensor(v)
            if slot.endswith("_pow") and t.numel() == 1:
                t = t.reshape(())
            groups.setdefault(m.group("p"), {})[slot] = t
        if len(groups) != len(self._parameter_list):
            warnings.warn(
                "optimizer.set_state_dict: upstream checkpoint has "
                f"{len(groups)} slot groups, this optimizer has "
                f"{len(self._parameter_list)} parameters; importing the "
                "common prefix by position")
        out: Dict[str, object] = {}
        mw = sd.get("master_weights")
        for i, (upname, slots) in enumerate(
                list(groups.items())[:len(self._parameter_list)]):
            name = self._param_name(i)
            for slot, t in slots.items():
                out[f"{name}.{slot}"] = t
            if isinstance(mw, dict) and upname in mw:
                out[f"{name}.master_weight"] = _as_tensor(mw[upname])
        if "global_step" in sd:
            out["global_step"] = sd["global_step"]
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict: Dict[str, object]) -> None:
        """Restore :meth:`state_dict`'s (or the JAX package's, or an
        upstream ``.pdopt``'s) slots, matched by name and shape, else,
        when no group matches by name and the counts agree, by position
        (``paddle_tpu/optimizer/optimizer.py::set_state_dict``).

        Every slot is **copied into** the existing state tensor, never
        rebound: a captured training step (``framework/dispatch.py``)
        reads the moments, the beta powers and ``master_weight`` at fixed
        addresses.  A state that does not exist yet is created as the
        first step would create it, then filled; an fp32 master that the
        file lacks is refreshed from the parameter.  Each state's host
        step count is rebuilt from its beta powers (from ``global_step``
        where it has none)."""
        sd = self._maybe_import_upstream(state_dict)
        self._global_step = int(sd.get("global_step", 0))
        groups: Dict[str, dict] = {}
        for key, v in sd.items():
            if key in ("LR_Scheduler", "global_step") or \
                    not isinstance(key, str):
                continue
            name, _, slot = key.rpartition(".")
            if name:
                groups.setdefault(name, {})[slot] = _as_tensor(v)
        params = self._parameter_list
        index = {self._param_name(i): i for i in range(len(params))}

        def fits(i, st):
            return all(t.ndim == 0 or tuple(t.shape) == tuple(params[i].shape)
                       for t in st.values())

        matched = {index[n]: st for n, st in groups.items()
                   if n in index and fits(index[n], st)}
        if groups and not matched and len(groups) == len(params):
            warnings.warn(
                "optimizer.set_state_dict: no saved slot group matches "
                "this optimizer's parameters by name+shape; remapping "
                "all groups by position (cross-process checkpoint).")

            def ordinal(n):
                tail = n.rsplit("_", 1)[-1]
                return (0, int(tail)) if tail.isdigit() else (1, n)

            remapped = dict(enumerate(groups[k] for k in sorted(
                groups, key=ordinal)))
            matched = {i: st for i, st in remapped.items() if fits(i, st)}
            if len(matched) != len(remapped):
                warnings.warn(
                    "optimizer.set_state_dict: positional remap dropped "
                    f"{len(remapped) - len(matched)} slot group(s) whose "
                    "shapes do not fit the target parameters.")
        else:
            dropped = sorted(n for n in groups
                             if n not in index or index[n] not in matched)
            if dropped:
                warnings.warn(
                    "optimizer.set_state_dict: ignoring slot groups "
                    "that match no current parameter by name+shape: "
                    f"{dropped}")
        for i, saved in matched.items():
            p = params[i]
            st = self._ensure_state(i, p)
            for slot, t in saved.items():
                if slot in st:
                    st[slot].copy_(t.reshape(st[slot].shape))
            if "master_weight" in st and "master_weight" not in saved:
                st["master_weight"].copy_(p)
            st["steps"] = self._steps_of(st)

    def _steps_of(self, st) -> int:
        """A state's step count: the ``t`` of its ``beta1^t`` while that
        power is a normal fp32 value, else ``global_step``."""
        b1 = getattr(self, "_beta1", None)
        if "beta1_pow" in st and b1 is not None and 0.0 < b1 < 1.0:
            pw = float(st["beta1_pow"])
            if 1e-30 <= pw <= 1.0:      # a normal fp32, log exact enough
                return int(round(math.log(pw) / math.log(b1)))
        return self._global_step


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
                "A, item 8)")
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._decoupled = False

    def _init_state(self, value):
        one = torch.ones((), dtype=torch.float32, device=value.device)
        acc = torch.float32 if value.dtype in _LOW else value.dtype
        return {"moment1": torch.zeros_like(value, dtype=acc),
                "moment2": torch.zeros_like(value, dtype=acc),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _scalars(self, states, lr):
        """Advance the beta powers in place and form this step's scalars
        as 0-d fp32 tensors, in the JAX package's order: ``(lr_t, eps_t,
        lr*decay)``.  Every state of a group has taken the same number
        of steps, so the first state's powers serve them all."""
        torch._foreach_mul_([st["beta1_pow"] for st in states], self._beta1)
        torch._foreach_mul_([st["beta2_pow"] for st in states], self._beta2)
        b1p, b2p = states[0]["beta1_pow"], states[0]["beta2_pow"]
        root = torch.sqrt(1 - b2p)
        lr_t = lr * root / (1 - b1p)
        eps_t = self._epsilon * root
        return lr_t, eps_t, lr * self._weight_decay

    def _update_group(self, works, grads, states, lr):
        b1, b2 = self._beta1, self._beta2
        lr_t, eps_t, lr_decay = self._scalars(states, lr)
        m1 = [st["moment1"] for st in states]
        m2 = [st["moment2"] for st in states]
        low = works[0].dtype in _LOW
        if low:
            self._moments_low(works, grads, m1, m2)
            wide = [w.float() for w in works]
        else:
            if self._weight_decay and not self._decoupled:
                grads = torch._foreach_add(grads, works,
                                           alpha=self._weight_decay)
            torch._foreach_mul_(m1, b1)
            torch._foreach_add_(m1, grads, alpha=1 - b1)
            torch._foreach_mul_(m2, b2)
            torch._foreach_addcmul_(m2, grads, grads, value=1 - b2)
            wide = works
        # the 0-d tensor scalars go through the foreach ops' Tensor
        # overloads by name: bound to a Scalar overload (which Python
        # picks for ``_foreach_add_(tensors, t)``), a 0-d tensor is read
        # with ``.item()``, a host sync that a CUDA graph refuses
        decayed = None
        if self._weight_decay and self._decoupled:
            # a 16-bit value's decay product is rounded in its dtype, as
            # the reference's weakly typed ``lr * decay * value`` is
            scale = lr_decay.to(works[0].dtype) if low else lr_decay
            decayed = _aten._foreach_mul.Tensor(works, scale)
        denom = torch._foreach_sqrt(m2)
        _aten._foreach_add_.Tensor(denom, eps_t)
        upd = torch._foreach_div(m1, denom)
        del denom
        _aten._foreach_mul_.Tensor(upd, lr_t)
        torch._foreach_sub_(wide, upd)
        if decayed is not None:
            torch._foreach_sub_(wide, decayed)
        if low:
            torch._foreach_copy_(works, wide)

    def _moments_low(self, works, grads, m1, m2):
        """The fp32 moments of a 16-bit value that has no fp32 master,
        in the JAX package's dtypes: its Python-float factors multiply
        the 16-bit gradient in that dtype (each product rounded there),
        and the moments add it in fp32.  The value's step then runs on
        an fp32 copy, which the caller rounds into the value once."""
        dt = works[0].dtype

        def rounded(x):
            return float(torch.tensor(x, dtype=dt))

        if self._weight_decay and not self._decoupled:
            grads = torch._foreach_add(
                grads, torch._foreach_mul(works, rounded(self._weight_decay)))
        g1 = torch._foreach_mul(grads, rounded(1 - self._beta1))
        g2 = torch._foreach_mul(torch._foreach_mul(grads, grads),
                                rounded(1 - self._beta2))
        torch._foreach_mul_(m1, self._beta1)
        torch._foreach_add_(m1, [g.float() for g in g1])
        torch._foreach_mul_(m2, self._beta2)
        torch._foreach_add_(m2, [g.float() for g in g2])


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
                "(ROADMAP queue A, item 8)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         float(weight_decay) if weight_decay else 0.0,
                         grad_clip, lazy_mode, multi_precision, name,
                         amsgrad)
        self._decoupled = True


class Momentum(Optimizer):
    """Paddle's momentum step, as the JAX package writes it::

        g = g + decay*w                  (coupled decay)
        v = momentum*v + g
        w = w - lr * (g + momentum*v)    (use_nesterov)
        w = w - lr * v                   (otherwise)

    The velocity is fp32 for a bf16/fp16 value.  With
    ``multi_precision`` the update runs on the fp32 master; without it
    a 16-bit value's decay product is rounded in its dtype (the
    reference's weakly typed ``decay * value``), the step runs on an
    fp32 copy and is rounded into the value once.  The learning rate
    is the device scalar the captured step replays (module
    docstring)."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _init_state(self, value):
        acc = torch.float32 if value.dtype in _LOW else value.dtype
        return {"velocity": torch.zeros_like(value, dtype=acc)}

    def _update_group(self, works, grads, states, lr):
        vel = [st["velocity"] for st in states]
        decay = self._weight_decay
        low = works[0].dtype in _LOW
        if decay:
            # the product rounded, then added, as the reference's
            # ``grad + decay * value`` (a 16-bit value's in its dtype)
            factor = float(torch.tensor(decay, dtype=works[0].dtype))
            grads = torch._foreach_add(grads,
                                       torch._foreach_mul(works, factor))
        if low:
            grads = [g.float() for g in grads]
            wide = [w.float() for w in works]
        else:
            wide = works
        torch._foreach_mul_(vel, self._momentum)
        torch._foreach_add_(vel, grads)
        if self._nesterov:
            upd = torch._foreach_add(grads, vel, alpha=self._momentum)
        else:
            upd = vel
        # the 0-d learning rate through the Tensor overload by name (see
        # Adam._update_group)
        torch._foreach_sub_(wide, _aten._foreach_mul.Tensor(upd, lr))
        if low:
            torch._foreach_copy_(works, wide)
