"""Recompute, activation checkpointing (counterpart of
``paddle_tpu/distributed/fleet/recompute/__init__.py``; upstream
``fleet/recompute/recompute.py``).

``recompute(function, *args)`` runs ``function`` without keeping its
activations for backward and runs it again inside backward
(``torch.utils.checkpoint``, non-reentrant).  The replay draws the same
random numbers as the first run: torch keeps its own generators' states
(``preserve_rng_state``), and the port keeps those of its generators
(``framework/random.py``: the per-device defaults and the mp tracker's),
restored around the replay and put back after it, so the first run still
advances them as the JAX package's key splitting does.  Gradients are
bit-equal to the plain run's.  Paddle ``Tensor`` arguments go in as
their torch tensors and the results come back as ``Tensor`` s.
"""

from __future__ import annotations

from typing import Callable

from torch.utils.checkpoint import checkpoint

from ....framework import random as _random
from ....ops._primitive import has_tensor, unwrap_args, wrap_out


def _generator_states():
    gens = dict(_random._registry._gens)
    for key, g in _random.get_rng_state_tracker()._gens.items():
        gens[key] = g
    return {k: (g, g.get_state()) for k, g in gens.items()}


def _restore(states):
    for g, s in states.values():
        g.set_state(s)


def recompute(function: Callable, *args, **kwargs):
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    wrapped = has_tensor(args, kwargs)
    if wrapped:
        args, kwargs = unwrap_args(args, kwargs)
    before = _generator_states() if preserve else None
    runs = [0]

    def run(*a):
        runs[0] += 1
        if before is None or runs[0] == 1:
            return function(*a, **kwargs)
        after = _generator_states()
        _restore(before)
        try:
            return function(*a, **kwargs)
        finally:
            _restore(after)

    out = checkpoint(run, *args, use_reentrant=False,
                     preserve_rng_state=preserve)
    return wrap_out(out) if wrapped else out


def recompute_sequential(ctx, functions, *args, **kwargs):
    """``functions`` (a Sequential or a list of layers) in
    ``ctx["segments"]`` recomputed segments."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    seg_size = max(len(layers) // max(segments, 1), 1)

    def run_segment(start, end):
        def fn(x):
            for layer in layers[start:end]:
                x = layer(x)
            return x
        return fn

    x = args[0]
    i = 0
    while i < len(layers):
        end = min(i + seg_size, len(layers))
        x = recompute(run_segment(i, end), x)
        i = end
    return x


def recompute_hybrid(ctx, function, *args, **kwargs):
    """Recompute under hybrid parallel: the mp layers' collectives run
    again in the replay, so it is :func:`recompute`."""
    return recompute(function, *args, **kwargs)
