"""``ParamAttr`` and the port's ``Parameter`` (counterparts of
``paddle_tpu/nn/param_attr.py`` and ``paddle_tpu/tensor.py::Parameter``).

A :class:`Parameter` is a ``torch.nn.Parameter`` that carries Paddle's
attributes: ``name`` (a process-wide ``param_<n>`` unless given, as the
JAX package names its parameters), ``optimize_attr["learning_rate"]``
(the parameter's learning-rate scale), ``regularizer`` (an
``L1Decay``/``L2Decay`` that overrides the optimizer's) and
``trainable`` (``requires_grad``).  The layers of the port create their
parameters as :class:`Parameter` s, from their ``weight_attr`` /
``bias_attr`` through :func:`~paddle_tpu_torch.nn.initializer.
make_parameter`; the optimizers read the attributes with defaults, so a
plain ``torch.nn.Parameter`` trains as one with none set.
"""

from __future__ import annotations

import copy
import itertools
from typing import Optional

import torch

_counter = itertools.count(1)


def auto_name(prefix: str = "param") -> str:
    """``<prefix>_<n>`` from one process-wide counter."""
    return f"{prefix}_{next(_counter)}"


class Parameter(torch.nn.Parameter):
    """``torch.nn.Parameter`` with Paddle's ``name``, ``optimize_attr``,
    ``regularizer`` and ``trainable``."""

    def __new__(cls, data=None, requires_grad=True, name=None):
        p = super().__new__(cls, data, requires_grad)
        p._name = name or auto_name("param")
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        return p

    # ``torch.Tensor.name`` is a read-only slot; the property takes its place
    @property
    def name(self) -> str:
        return self._name

    @name.setter
    def name(self, value: str) -> None:
        self._name = value

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool) -> None:
        self.requires_grad_(bool(value))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad, name=self._name)
        out.optimize_attr = dict(self.optimize_attr)
        out.regularizer = copy.deepcopy(self.regularizer, memo)
        memo[id(self)] = out
        return out

    def __repr__(self):
        return f"Parameter {self._name} containing:\n" + \
            torch.Tensor.__repr__(self.data)


class ParamAttr:
    """The attributes of a parameter a layer creates: ``name``,
    ``initializer`` (an initializer of ``paddle_tpu_torch.nn.
    initializer``), ``learning_rate`` (the scale of the optimizer's
    rate for it), ``regularizer``, ``trainable``; ``do_model_average``
    and ``need_clip`` are kept and read nowhere, as in the JAX
    package."""

    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, do_model_average: bool = True,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None -> the default attributes; False -> None (no parameter,
        the caller's no-bias marker); a str -> the name; an initializer
        -> wrapped; a ParamAttr as it is."""
        if attr is None:
            return ParamAttr()
        if attr is False:
            return None
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if not callable(attr):
            raise TypeError(
                f"weight_attr/bias_attr {attr!r}: expected None, False, a "
                "name, a ParamAttr or an initializer")
        return ParamAttr(initializer=attr)
