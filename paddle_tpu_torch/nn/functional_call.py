"""Functional execution of a Layer (counterpart of ``paddle_tpu/nn/
functional_call.py``): run a layer's forward with other values in place
of its parameters and buffers, over ``torch.func.functional_call``.

The JAX package needs this to trace a step with ``jax.jit``; here it is
for users who differentiate or vectorise over parameters
(``torch.func.grad``, ``vmap``) without touching the layer.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch
from torch.nn.utils import stateless

from ..framework import random as _random


def param_dict(layer) -> Dict[str, Any]:
    """name -> tensor for every trainable parameter."""
    return {n: p for n, p in layer.named_parameters() if p.requires_grad}


def frozen_dict(layer) -> Dict[str, Any]:
    """name -> tensor for every parameter that is not trainable."""
    return {n: p for n, p in layer.named_parameters()
            if not p.requires_grad}


def buffer_dict(layer) -> Dict[str, Any]:
    return {n: b for n, b in layer.named_buffers() if b is not None}


@contextlib.contextmanager
def bind(layer, params: Dict[str, Any] = None,
         buffers: Dict[str, Any] = None, frozen: Dict[str, Any] = None):
    """Put ``params``, ``buffers`` and ``frozen`` (name -> tensor) in
    place of the layer's own for the block, then the originals back.
    Yields a dict whose ``"buffers"`` holds, after the block, every
    buffer's value at its end (what forward wrote, e.g. BatchNorm's
    running statistics)."""
    values = {**(params or {}), **(frozen or {}), **(buffers or {})}
    holder: Dict[str, Any] = {}
    with stateless._reparametrize_module(layer, values):
        yield holder
        holder["buffers"] = buffer_dict(layer)


@contextlib.contextmanager
def _seeded(key, device):
    """With ``key`` (an int), the port's generator of ``device`` reseeded
    to it for the block and restored after; nothing without one."""
    if key is None:
        yield
        return
    gen = _random.default_generator(device)
    saved = gen.get_state()
    gen.manual_seed(int(key))
    try:
        yield
    finally:
        gen.set_state(saved)


def functional_call(layer, params, buffers, args, kwargs=None, key=None,
                    frozen=None):
    """``layer(*args, **kwargs)`` with ``params``, ``buffers`` and
    ``frozen`` in place of its own (``torch.func.functional_call``);
    ``key`` seeds the device's generator for its dropout.  Returns
    ``(outputs, new_buffers)``, the buffers' values after the call."""
    values = {**(params or {}), **(frozen or {}), **(buffers or {})}
    device = next(iter(values.values())).device if values else \
        torch.device("cpu")
    with _seeded(key, device):
        out = torch.func.functional_call(layer, values, tuple(args),
                                         kwargs or {})
    # a buffer forward replaced comes back into ``values``
    new = {n: values.get(n, b) for n, b in buffer_dict(layer).items()}
    return out, new
