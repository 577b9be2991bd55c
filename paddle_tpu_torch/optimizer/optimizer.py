"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``):
the ``Optimizer`` base with fp32 master weights for bf16 parameters,
learning-rate schedulers, gradient clips, L1/L2 regularizers and the
per-parameter ``ParamAttr`` coefficients; ``SGD``, ``Momentum``,
``Adam``/``AdamW`` (``amsgrad``, ``apply_decay_param_fun``),
``Adagrad``, ``RMSProp``, ``Lamb``, ``Adadelta`` and ``Adamax`` with
Paddle's exact updates.

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
per dispatch; under a scheduler it changes between replays, never
inside one).  The tensor updates run as ``torch._foreach_*`` ops over
every parameter that shares a device, a step count, a working dtype
and its coefficients (L2, L1, learning-rate scale), in place.  The
global-norm clip is device ops too (``nn/clip_grad.py``), so nothing
in a step reads a device value on the host.  ``steps`` in each state
and ``_global_step`` are host bookkeeping, which the fold engine
advances by the number of replays.
With ``multi_precision``, a bf16/fp16 parameter keeps an fp32 master
copy in its state: the update runs on the master and the parameter
receives its rounding.  Without one, ``Adam``/``AdamW`` still keep its
moments in fp32, as the JAX package does: the update (decoupled decay
included) runs on an fp32 copy of the value, which is rounded back
into the parameter once (``Adam._moments_low``).

A sparse row gradient (``Embedding(sparse=True)``, eager steps only;
``framework/selected_rows.py``) is merged and taken out before the
foreach groups, which stay as they are: ``SGD`` and ``Adam``/``AdamW``
with ``lazy_mode`` update its rows by index ops, every other rule (and
any parameter under an L1 decay) gets it dense, as the JAX package's
``_sparse_step`` does.  Merging reads the row count on the host, one
sync per sparse table per step.
"""

from __future__ import annotations

import math
import re
import warnings
from typing import Dict, List

import numpy as np
import torch

from ..framework.selected_rows import merge_rows
from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler

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
    """Base: the parameter list, the learning rate (a float or an
    :class:`~paddle_tpu_torch.optimizer.lr.LRScheduler`), the weight
    decay (a float, ``L1Decay`` or ``L2Decay``), the gradient clip, the
    fp32 masters and ``step``/``clear_grad``.  Subclasses give
    ``_init_state`` and ``_update_group``.

    Per parameter, in the JAX package's order
    (``paddle_tpu/optimizer/optimizer.py::apply_gradients_tree``): the
    clip over every gradient (in its own dtype), then an L1 term
    ``l1 * sign(w)`` rounded to the gradient's dtype, then the cast to
    the working dtype (the fp32 master's), then the update with the
    parameter's L2 coefficient and its rate ``lr * lr_scale``, formed
    on the device in float32.  A parameter's coefficients come from
    ``apply_decay_param_fun(p.name)`` (False: none), then its own
    ``regularizer`` (``ParamAttr``), then the optimizer's; its scale
    from ``optimize_attr["learning_rate"]``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, apply_decay_param_fun=None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate)}")
        # the handles as given: a Paddle Tensor leaf swaps its torch
        # tensor on an in-place write (tensor.py), so it is read at use
        self._params = list(parameters)
        self._learning_rate = (learning_rate
                               if isinstance(learning_rate, LRScheduler)
                               else float(learning_rate))
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._l1_decay = 0.0
        if isinstance(weight_decay, L1Decay):
            # L1 is a gradient term (coeff * sign(w)), not an L2 one
            self._weight_decay, self._l1_decay = 0.0, weight_decay.coeff
            self._decoupled = False
        elif isinstance(weight_decay, L2Decay):
            self._weight_decay, self._decoupled = weight_decay.coeff, False
        elif weight_decay is None or isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay or 0.0)
            self._decoupled = self._default_decoupled()
        else:
            self._weight_decay = float(getattr(weight_decay, "coeff", 0.0))
            self._decoupled = False
        self._state: Dict[int, dict] = {}   # by position in the list
        self._param_names = None            # set_param_names
        self._global_step = 0
        self._lr_dev: Dict[torch.device, torch.Tensor] = {}
        self._lr_held: Dict[torch.device, float] = {}

    def _default_decoupled(self) -> bool:
        return False

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate.get_lr())
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("set_lr not allowed with an LRScheduler")
        self._learning_rate = float(value)

    def _lr_scalar(self, device) -> torch.Tensor:
        """The learning rate the update reads: a 0-d fp32 tensor on
        ``device``, made on first use with ``get_lr()``."""
        t = self._lr_dev.get(device)
        if t is None:
            lr = self.get_lr()
            t = torch.full((), lr, dtype=torch.float32, device=device)
            self._lr_dev[device], self._lr_held[device] = t, lr
        return t

    def _scaled_lr(self, device, scale: float) -> torch.Tensor:
        """The rate of a parameter whose learning-rate scale is
        ``scale``: the device scalar, times ``scale`` unless it is 1."""
        lr = self._lr_scalar(device)
        return lr if scale == 1.0 else lr * scale

    def refresh_lr(self) -> None:
        """Write ``get_lr()`` into each device's learning-rate scalar
        that holds another value (one fill per device, no sync).  A
        captured step reads the scalar, so this runs outside the graph,
        before each replay whose rate may have moved."""
        lr = self.get_lr()
        for device, t in self._lr_dev.items():
            if self._lr_held[device] != lr:
                t.fill_(lr)
                self._lr_held[device] = lr

    # -- per-parameter coefficients ----------------------------------------
    def _decay_name(self, i: int, p) -> str:
        """The name ``apply_decay_param_fun`` sees: the parameter's own
        ``name`` (a port ``Parameter``'s), else its checkpoint name."""
        name = getattr(p, "name", None)
        return name if isinstance(name, str) else self._param_name(i)

    def _param_decay(self, i: int, p) -> float:
        """The L2 coefficient of parameter ``i`` (its regularizer wins
        over the optimizer's)."""
        fn = self._apply_decay_param_fun
        if fn is not None and not fn(self._decay_name(i, p)):
            return 0.0
        reg = getattr(p, "regularizer", None)
        if reg is not None:
            if isinstance(reg, L1Decay):
                return 0.0
            return float(getattr(reg, "coeff", self._weight_decay))
        return self._weight_decay

    def _param_l1(self, i: int, p) -> float:
        """The L1 coefficient of parameter ``i``."""
        fn = self._apply_decay_param_fun
        if fn is not None and not fn(self._decay_name(i, p)):
            return 0.0
        reg = getattr(p, "regularizer", None)
        if reg is not None:
            return float(reg.coeff) if isinstance(reg, L1Decay) else 0.0
        return self._l1_decay

    @staticmethod
    def _lr_scale(p) -> float:
        attr = getattr(p, "optimize_attr", None)
        return float(attr.get("learning_rate", 1.0)) if attr else 1.0

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

    @property
    def _parameter_list(self) -> List[torch.Tensor]:
        """The parameters as torch tensors, read now: a Paddle Tensor
        leaf by its current ``_value``."""
        return [getattr(p, "_value", p) for p in self._params]

    def parameters(self) -> List[torch.nn.Parameter]:
        return self._parameter_list

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

    def _clip(self, items, grads):
        """The clipped gradients: ``grad_clip.pure_clip`` (device ops,
        no sync: the form a captured step runs), else the clip called
        on ``(param, grad)`` pairs."""
        clip = self._grad_clip
        if hasattr(clip, "pure_clip"):
            return list(clip.pure_clip(grads))
        return [g for _, g in clip([(p, g) for (_, p), g in
                                    zip(items, grads)])]

    @torch.no_grad()
    def _step(self) -> None:
        """:meth:`step` without the learning-rate refresh: the body the
        fold engine captures, whose learning rate it refreshes per
        group.  Every gradient is read, never written."""
        self._global_step += 1
        items = [(i, p) for i, p in enumerate(self._parameter_list)
                 if p.requires_grad and p.grad is not None]
        if not items:
            return
        grads = [p.grad for _, p in items]
        if self._grad_clip is not None:
            grads = self._clip(items, grads)
        groups: Dict[tuple, list] = {}
        for (i, p), g in zip(items, grads):
            st = self._ensure_state(i, p)
            if g.is_sparse:
                g = self._sparse_step(i, p, st, g)
                if g is None:
                    continue
            work = st.get("master_weight", p)
            key = (work.device, work.dtype, st["steps"],
                   self._param_decay(i, p), self._param_l1(i, p),
                   self._lr_scale(p))
            groups.setdefault(key, []).append((p, st, g))
        for (device, _, steps, decay, l1, scale), members in groups.items():
            works = [st.get("master_weight", p) for p, st, _ in members]
            grads = [g for _, _, g in members]
            if l1:
                # l1 * sign(w) in the value's dtype, rounded to the
                # gradient's, added there (before the master cast)
                term = torch._foreach_sign(works)
                torch._foreach_mul_(term, l1)
                grads = torch._foreach_add(
                    grads, [t.to(g.dtype) for t, g in zip(term, grads)])
            grads = [g.to(w.dtype) for g, w in zip(grads, works)]
            lr = self._scaled_lr(device, scale)
            states = [st for _, st, _ in members]
            self._update_group(works, grads, states, lr, decay)
            for p, st, _ in members:
                st["steps"] = steps + 1
                if "master_weight" in st:
                    p.copy_(st["master_weight"])

    def _update_group(self, works, grads, states, lr, decay):
        """Update ``works`` (the values, or their fp32 masters) in place
        from ``grads`` (in their dtype) with the group's rate ``lr`` (a
        0-d fp32 device tensor) and L2 coefficient ``decay``."""
        raise NotImplementedError

    # -- sparse row gradients (framework/selected_rows.py) -----------------
    def _rowwise(self) -> bool:
        """Whether this optimizer updates a sparse gradient's rows only
        (:meth:`_update_rows`); the base densifies it."""
        return False

    def _sparse_step(self, i, p, st, grad):
        """A sparse row gradient of parameter ``i``, merged first (its
        duplicate rows summed, ``paddle_tpu/optimizer/optimizer.py::
        step``): applied to its rows by :meth:`_update_rows` (returns
        None), or returned dense for the dense update: by the base rule
        (``_sparse_step`` densifies), and under an L1 decay, which moves
        every weight."""
        grad = merge_rows(grad)
        if not self._rowwise() or self._param_l1(i, p):
            return grad.to_dense()
        work = st.get("master_weight", p)
        rows = grad.indices()[0]
        self._update_rows(work, rows, grad.values(), st,
                          self._scaled_lr(work.device, self._lr_scale(p)),
                          self._param_decay(i, p))
        st["steps"] += 1
        if "master_weight" in st:
            p.index_copy_(0, rows, work.index_select(0, rows).to(p.dtype))
        return None

    def _update_rows(self, work, rows, values, state, lr, decay):
        """Update rows ``rows`` (unique) of ``work`` from their gradient
        ``values``; the optimizers with a row rule give it."""
        raise NotImplementedError

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()``, :meth:`step`, :meth:`clear_grad`."""
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

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

    def _adopt_parameters(self, named) -> None:
        """Take ``named[name]`` (name -> parameter, the network's) in place
        of each parameter of this optimizer whose name (
        :meth:`set_param_names`) now holds another object, with fresh
        state: a replaced parameter must not train on its predecessor's
        moments."""
        if self._param_names is None:
            return
        current = self._parameter_list
        for i, name in enumerate(self._param_names):
            new = named.get(name)
            if new is not None and new is not current[i]:
                self._params[i] = new
                self._state.pop(i, None)

    def slots(self, layout_of, copy: bool = True) -> Dict[str, object]:
        """``<param name>.<slot>`` for every slot of every state but the
        host step count, as CPU copies when ``copy`` (else the live
        tensors); a slot of its parameter's shape is presented as a
        ``ShardedTensor`` of ``layout_of(param)`` where that is a
        layout (not None)."""
        out: Dict[str, object] = {}
        params = self._parameter_list
        for i in sorted(self._state):
            name = self._param_name(i)
            layout = layout_of(params[i])
            for k, v in self._state[i].items():
                if k == "steps":
                    continue
                if copy:
                    v = v.detach().cpu().clone()
                if layout is not None and v.dim() and \
                        tuple(v.shape) == tuple(params[i].shape):
                    v = layout.wrap(v)
                out[f"{name}.{k}"] = v
        return out

    def state_dict(self) -> Dict[str, object]:
        """:meth:`slots` (the moments, the beta powers,
        ``master_weight``), ``LR_Scheduler`` (the scheduler's
        ``state_dict``, Python scalars) under a scheduler, and
        ``global_step``: the JAX package's keys and only those.  The
        host step counts are not written; :meth:`set_state_dict`
        rebuilds them.  A parameter that is a chunk of a whole one (a
        sharding stage's or the sharded weight update's: its
        ``_global_layout``) presents its slots as ``ShardedTensor`` s:
        the chunk and its place in the whole-shape tensor."""
        out = self.slots(lambda p: getattr(p, "_global_layout", None))
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
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
        for k in ("LR_Scheduler", "global_step"):
            if k in sd:
                out[k] = sd[k]
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
        where it has none).  ``LR_Scheduler`` restores the scheduler
        (the next :meth:`refresh_lr` writes its rate)."""
        sd = self._maybe_import_upstream(state_dict)
        self._global_step = int(sd.get("global_step", 0))
        if "LR_Scheduler" in sd and isinstance(self._learning_rate,
                                               LRScheduler):
            self._learning_rate.set_state_dict(sd["LR_Scheduler"])
        params = self._parameter_list
        index = {self._param_name(i): i for i in range(len(params))}
        groups: Dict[str, dict] = {}
        for key, v in sd.items():
            if key in ("LR_Scheduler", "global_step") or \
                    not isinstance(key, str):
                continue
            name, _, slot = key.rpartition(".")
            if getattr(v, "is_sharded_tensor", False):
                # a slice of a whole-shape slot, as this optimizer's piece
                i = index.get(name)
                p = params[i] if i is not None else None
                v = v.local_for(getattr(p, "_global_layout", None),
                                tuple(p.shape)) if p is not None \
                    else v.local
            elif isinstance(v, (torch.Tensor, np.ndarray)) and name in index:
                # a whole-shape slot into a piece of it
                p = params[index[name]]
                layout = getattr(p, "_global_layout", None)
                t = _as_tensor(v)
                if layout is not None and t.dim() and \
                        tuple(t.shape) != tuple(p.shape) and \
                        t.numel() == math.prod(layout.global_shape):
                    v = layout.take(t.reshape(layout.global_shape))
            if name:
                groups.setdefault(name, {})[slot] = _as_tensor(v)

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


def _with_decay(grads, works, decay):
    """``grad + decay * value``, the product rounded first (the JAX
    package's coupled L2 term)."""
    return torch._foreach_add(grads, torch._foreach_mul(works, decay))


def _widen(works, grads):
    """``(values, grads, low)``: fp32 copies of a 16-bit group (updated
    there and rounded back once by :func:`_narrow`), else the values
    and gradients as they are."""
    if works[0].dtype in _LOW:
        return [w.float() for w in works], [g.float() for g in grads], True
    return works, grads, False


def _narrow(works, wide, low):
    if low:
        torch._foreach_copy_(works, wide)


def _fp32_like(value, fill=0.0):
    """A state slot of ``value``'s shape: fp32 for a 16-bit value."""
    dt = torch.float32 if value.dtype in _LOW else value.dtype
    return torch.full_like(value, fill, dtype=dt)


def _one(value):
    return torch.ones((), dtype=torch.float32, device=value.device)


class Adam(Optimizer):
    """Adam as the module docstring writes it; ``amsgrad`` keeps
    ``moment2_max = max(moment2_max, moment2)`` and divides by its root.
    ``lazy_mode`` updates only the rows of a sparse gradient
    (``Embedding(sparse=True)``): their moments and weights, while the
    beta powers advance as in every step (``_update_rows``, the JAX
    ``Adam._sparse_step``); on a dense gradient, or with ``amsgrad``,
    it is plain Adam."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._adam_init(beta1, beta2, epsilon, lazy_mode, amsgrad)

    def _adam_init(self, beta1, beta2, epsilon, lazy_mode, amsgrad):
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._amsgrad = bool(amsgrad)
        self._lazy_mode = bool(lazy_mode)

    def _rowwise(self):
        return self._lazy_mode and not self._amsgrad

    def _update_rows(self, work, rows, values, state, lr, decay):
        """Lazy Adam on the rows ``rows``, in the JAX package's order and
        dtypes: the gradient in fp32 (plus the coupled L2 term), the
        gathered moments updated and written back, the value's rows
        less the rounded step (and AdamW's ``lr*decay*value`` of the
        pre-step rows)."""
        b1, b2 = self._beta1, self._beta2
        vr = work.index_select(0, rows)
        g = values.float()
        if decay and not self._decoupled:
            g = g + decay * vr.float()
        lr_t, eps_t, lr_decay = self._scalars([state], lr, decay)
        m1 = state["moment1"].index_select(0, rows)
        m2 = state["moment2"].index_select(0, rows)
        m1.mul_(b1).add_(g, alpha=1 - b1)
        m2.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = m1 / (m2.sqrt() + eps_t) * lr_t
        new = vr - upd.to(vr.dtype)
        if decay and self._decoupled:
            new = new - vr * lr_decay.to(vr.dtype)
        work.index_copy_(0, rows, new)
        state["moment1"].index_copy_(0, rows, m1)
        state["moment2"].index_copy_(0, rows, m2)

    def _init_state(self, value):
        st = {"moment1": _fp32_like(value), "moment2": _fp32_like(value),
              "beta1_pow": _one(value), "beta2_pow": _one(value)}
        if self._amsgrad:
            st["moment2_max"] = _fp32_like(value)
        return st

    def _scalars(self, states, lr, decay):
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
        return lr_t, eps_t, lr * decay

    def _update_group(self, works, grads, states, lr, decay):
        b1, b2 = self._beta1, self._beta2
        lr_t, eps_t, lr_decay = self._scalars(states, lr, decay)
        m1 = [st["moment1"] for st in states]
        m2 = [st["moment2"] for st in states]
        low = works[0].dtype in _LOW
        if low:
            self._moments_low(works, grads, m1, m2, decay)
            wide = [w.float() for w in works]
        else:
            if decay and not self._decoupled:
                grads = torch._foreach_add(grads, works, alpha=decay)
            torch._foreach_mul_(m1, b1)
            torch._foreach_add_(m1, grads, alpha=1 - b1)
            torch._foreach_mul_(m2, b2)
            torch._foreach_addcmul_(m2, grads, grads, value=1 - b2)
            wide = works
        if self._amsgrad:
            m2h = [st["moment2_max"] for st in states]
            torch._foreach_maximum_(m2h, m2)
        else:
            m2h = m2
        # the 0-d tensor scalars go through the foreach ops' Tensor
        # overloads by name: bound to a Scalar overload (which Python
        # picks for ``_foreach_add_(tensors, t)``), a 0-d tensor is read
        # with ``.item()``, a host sync that a CUDA graph refuses
        decayed = None
        if decay and self._decoupled:
            # a 16-bit value's decay product is rounded in its dtype, as
            # the reference's weakly typed ``lr * decay * value`` is
            scale = lr_decay.to(works[0].dtype) if low else lr_decay
            decayed = _aten._foreach_mul.Tensor(works, scale)
        denom = torch._foreach_sqrt(m2h)
        _aten._foreach_add_.Tensor(denom, eps_t)
        upd = torch._foreach_div(m1, denom)
        del denom
        _aten._foreach_mul_.Tensor(upd, lr_t)
        torch._foreach_sub_(wide, upd)
        if decayed is not None:
            torch._foreach_sub_(wide, decayed)
        _narrow(works, wide, low)

    def _moments_low(self, works, grads, m1, m2, decay):
        """The fp32 moments of a 16-bit value that has no fp32 master,
        in the JAX package's dtypes: its Python-float factors multiply
        the 16-bit gradient in that dtype (each product rounded there),
        and the moments add it in fp32.  The value's step then runs on
        an fp32 copy, which the caller rounds into the value once."""
        dt = works[0].dtype

        def rounded(x):
            return float(torch.tensor(x, dtype=dt))

        if decay and not self._decoupled:
            grads = torch._foreach_add(
                grads, torch._foreach_mul(works, rounded(decay)))
        g1 = torch._foreach_mul(grads, rounded(1 - self._beta1))
        g2 = torch._foreach_mul(torch._foreach_mul(grads, grads),
                                rounded(1 - self._beta2))
        torch._foreach_mul_(m1, self._beta1)
        torch._foreach_add_(m1, [g.float() for g in g1])
        torch._foreach_mul_(m2, self._beta2)
        torch._foreach_add_(m2, [g.float() for g in g2])


class AdamW(Adam):
    """Adam with decoupled weight decay on the pre-step value
    (``weight_decay`` default 0.01), on the parameters for whose
    ``name`` ``apply_decay_param_fun`` is true (all without one).
    ``lr_ratio`` is refused: the JAX package accepts it and applies it
    nowhere, so the port has no reference for it.  ``lazy_mode`` is
    Adam's, the decay on the updated rows only (the JAX ``AdamW`` never
    stores it, so its ``Adam._sparse_step`` fails on a sparse gradient;
    ROADMAP C)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        if lr_ratio is not None:
            raise NotImplementedError(
                "AdamW lr_ratio: the JAX package (the reference) accepts "
                "it and applies it nowhere, so the port refuses it rather "
                "than guess (ROADMAP, the areas not comparable)")
        Optimizer.__init__(self, learning_rate, parameters, None, grad_clip,
                           name, multi_precision, apply_decay_param_fun)
        self._adam_init(beta1, beta2, epsilon, lazy_mode, amsgrad)
        self._weight_decay = float(weight_decay) if weight_decay else 0.0

    def _default_decoupled(self):
        return True


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
        return {"velocity": _fp32_like(value)}

    def _update_group(self, works, grads, states, lr, decay):
        vel = [st["velocity"] for st in states]
        low = works[0].dtype in _LOW
        if decay:
            # the product rounded, then added, as the reference's
            # ``grad + decay * value`` (a 16-bit value's in its dtype)
            factor = float(torch.tensor(decay, dtype=works[0].dtype))
            grads = _with_decay(grads, works, factor)
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
        _narrow(works, wide, low)


# The optimizers below run each group's update as foreach ops in place,
# in the JAX package's order of operations; a 16-bit value without an
# fp32 master keeps fp32 state and is updated on an fp32 copy, rounded
# back once (the JAX package keeps their state in the value's dtype).


class SGD(Optimizer):
    """``w = w - lr * (g + decay*w)``; a sparse gradient updates its
    rows only."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _rowwise(self):
        return True

    def _update_rows(self, work, rows, values, state, lr, decay):
        vals = values.to(work.dtype)
        if decay:
            vals = vals + decay * work.index_select(0, rows)
        work.index_add_(0, rows, vals * lr, alpha=-1)

    def _update_group(self, works, grads, states, lr, decay):
        wide, grads, low = _widen(works, grads)
        if decay:
            grads = _with_decay(grads, wide, decay)
        torch._foreach_sub_(wide, _aten._foreach_mul.Tensor(grads, lr))
        _narrow(works, wide, low)


class Adagrad(Optimizer):
    """``m = m + g^2;  w = w - lr*g / (sqrt(m) + eps)``, ``m`` starting
    at ``initial_accumulator_value``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, value):
        return {"moment": _fp32_like(value, self._init_acc)}

    def _update_group(self, works, grads, states, lr, decay):
        wide, grads, low = _widen(works, grads)
        if decay:
            grads = _with_decay(grads, wide, decay)
        m = [st["moment"] for st in states]
        torch._foreach_add_(m, torch._foreach_mul(grads, grads))
        num = _aten._foreach_mul.Tensor(grads, lr)
        den = torch._foreach_sqrt(m)
        torch._foreach_add_(den, self._epsilon)
        torch._foreach_div_(num, den)
        torch._foreach_sub_(wide, num)
        _narrow(works, wide, low)


class RMSProp(Optimizer):
    """``ms = rho*ms + (1-rho)*g^2``; centered: ``mg = rho*mg +
    (1-rho)*g``, ``denom = sqrt(ms - mg^2 + eps)``, else ``sqrt(ms +
    eps)``; ``mom = momentum*mom + lr*g/denom;  w = w - mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, value):
        st = {"mean_square": _fp32_like(value),
              "momentum_acc": _fp32_like(value)}
        if self._centered:
            st["mean_grad"] = _fp32_like(value)
        return st

    def _update_group(self, works, grads, states, lr, decay):
        wide, grads, low = _widen(works, grads)
        if decay:
            grads = _with_decay(grads, wide, decay)
        rho = self._rho
        ms = [st["mean_square"] for st in states]
        mom = [st["momentum_acc"] for st in states]
        torch._foreach_mul_(ms, rho)
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - rho)
        torch._foreach_add_(ms, sq)
        if self._centered:
            mg = [st["mean_grad"] for st in states]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, torch._foreach_mul(grads, 1 - rho))
            inner = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
            torch._foreach_add_(inner, self._epsilon)
        else:
            inner = torch._foreach_add(ms, self._epsilon)
        denom = torch._foreach_sqrt(inner)
        step = _aten._foreach_mul.Tensor(grads, lr)
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, step)
        torch._foreach_sub_(wide, mom)
        _narrow(works, wide, low)


class Lamb(Optimizer):
    """``r = m1hat / (sqrt(m2hat) + eps) + decay*w``, ``w = w - lr *
    trust * r`` with ``trust = |w| / |r|`` per tensor where both norms
    are positive, else 1 (``torch.where`` on the device).  The decay
    (``lamb_weight_decay``) skips the parameters for whose ``name``
    ``exclude_from_weight_decay_fn`` is true."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        apply_fn = None
        if exclude_from_weight_decay_fn is not None:
            def apply_fn(pname, _ex=exclude_from_weight_decay_fn):
                return not _ex(pname)
        super().__init__(learning_rate, parameters, float(lamb_weight_decay),
                         grad_clip, name, multi_precision,
                         apply_decay_param_fun=apply_fn)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._decoupled = False

    def _init_state(self, value):
        return {"moment1": _fp32_like(value), "moment2": _fp32_like(value),
                "beta1_pow": _one(value), "beta2_pow": _one(value)}

    def _update_group(self, works, grads, states, lr, decay):
        wide, grads, low = _widen(works, grads)
        b1, b2 = self._beta1, self._beta2
        torch._foreach_mul_([st["beta1_pow"] for st in states], b1)
        torch._foreach_mul_([st["beta2_pow"] for st in states], b2)
        b1p, b2p = states[0]["beta1_pow"], states[0]["beta2_pow"]
        m1 = [st["moment1"] for st in states]
        m2 = [st["moment2"] for st in states]
        torch._foreach_mul_(m1, b1)
        torch._foreach_add_(m1, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(m2, b2)
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_add_(m2, sq)
        m1h = _aten._foreach_div.Tensor(m1, 1 - b1p)
        m2h = _aten._foreach_div.Tensor(m2, 1 - b2p)
        r = torch._foreach_sqrt(m2h)
        torch._foreach_add_(r, self._epsilon)
        r = torch._foreach_div(m1h, r)
        if decay:
            torch._foreach_add_(r, torch._foreach_mul(wide, decay))
        wn = torch.stack(torch._foreach_norm(wide))
        rn = torch.stack(torch._foreach_norm(r))
        trust = torch.where((wn > 0) & (rn > 0), wn / rn,
                            torch.ones_like(wn))
        scale = lr * trust
        torch._foreach_sub_(wide, torch._foreach_mul(r, list(scale.unbind(0))))
        _narrow(works, wide, low)


class Adadelta(Optimizer):
    """``asg = rho*asg + (1-rho)*g^2``, ``upd = g * sqrt(asu + eps) /
    sqrt(asg + eps)``, ``asu = rho*asu + (1-rho)*upd^2``, ``w = w -
    lr*upd``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon

    def _init_state(self, value):
        return {"avg_squared_grad": _fp32_like(value),
                "avg_squared_update": _fp32_like(value)}

    def _update_group(self, works, grads, states, lr, decay):
        wide, grads, low = _widen(works, grads)
        if decay:
            grads = _with_decay(grads, wide, decay)
        rho, eps = self._rho, self._epsilon
        asg = [st["avg_squared_grad"] for st in states]
        asu = [st["avg_squared_update"] for st in states]
        torch._foreach_mul_(asg, rho)
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - rho)
        torch._foreach_add_(asg, sq)
        num = torch._foreach_add(asu, eps)
        torch._foreach_sqrt_(num)
        upd = torch._foreach_mul(grads, num)
        den = torch._foreach_add(asg, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(asu, rho)
        sq = torch._foreach_mul(upd, upd)
        torch._foreach_mul_(sq, 1 - rho)
        torch._foreach_add_(asu, sq)
        torch._foreach_sub_(wide, _aten._foreach_mul.Tensor(upd, lr))
        _narrow(works, wide, low)


class Adamax(Optimizer):
    """``m = b1*m + (1-b1)*g``, ``u = max(b2*u, |g|)``, ``w = w - lr /
    (1 - b1^t) * m / (u + eps)``, with ``b1^t`` a device scalar."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, value):
        return {"moment": _fp32_like(value), "inf_norm": _fp32_like(value),
                "beta1_pow": _one(value)}

    def _update_group(self, works, grads, states, lr, decay):
        wide, grads, low = _widen(works, grads)
        if decay:
            grads = _with_decay(grads, wide, decay)
        b1 = self._beta1
        torch._foreach_mul_([st["beta1_pow"] for st in states], b1)
        b1p = states[0]["beta1_pow"]
        m = [st["moment"] for st in states]
        u = [st["inf_norm"] for st in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(u, self._beta2)
        torch._foreach_maximum_(u, torch._foreach_abs(grads))
        step = _aten._foreach_mul.Tensor(m, lr / (1 - b1p))
        torch._foreach_div_(step, torch._foreach_add(u, self._epsilon))
        torch._foreach_sub_(wide, step)
        _narrow(works, wide, low)
