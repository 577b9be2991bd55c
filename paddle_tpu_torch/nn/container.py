"""Containers (counterpart of ``paddle_tpu/nn/container.py``): torch's
containers with the port's :class:`~paddle_tpu_torch.nn.layer.Layer`
API, named as the JAX containers name their members."""

from __future__ import annotations

from collections import OrderedDict

from torch import nn

from .layer import Layer


class Sequential(nn.Sequential, Layer):
    """Layers run in turn, named "0", "1", ... when given positionally,
    or by name from an ``OrderedDict`` or ``(name, layer)`` pairs."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            super().__init__(layers[0])
        elif layers and isinstance(layers[0], tuple) and \
                isinstance(layers[0][0], str):
            super().__init__(OrderedDict(layers))
        else:
            super().__init__(*layers)


class LayerList(nn.ModuleList, Layer):
    """Layers held in a list, named "0", "1", ... as the JAX layer names
    them (state-dict keys ``blocks.0.…``): indexing (negative too),
    slicing (a new ``LayerList``), iteration, ``len``, ``append``,
    ``insert`` and ``extend``."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(nn.ParameterList, Layer):
    """Parameters held in a list, named "0", "1", ...: indexing,
    iteration, ``len`` and ``append``."""

    def __init__(self, parameters=None):
        super().__init__(parameters)


class LayerDict(nn.ModuleDict, Layer):
    """Layers held by name, in insertion order: ``d[key]``, assignment,
    ``del``, ``in``, ``len``, iteration over the keys, ``keys``,
    ``values``, ``items``, ``update`` (a dict or ``(name, layer)``
    pairs), ``pop`` and ``clear``."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)
