"""Containers (counterpart of ``paddle_tpu/nn/container.py``)."""

from __future__ import annotations

from collections import OrderedDict

from torch import nn


class Sequential(nn.Sequential):
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


class LayerList(nn.ModuleList):
    """Layers held in a list, named "0", "1", ... as the JAX layer names
    them (state-dict keys ``blocks.0.…``): indexing (negative too),
    slicing (a new ``LayerList``), iteration, ``len``, ``append``,
    ``insert`` and ``extend``."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)
