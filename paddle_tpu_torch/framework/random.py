"""Random state of the port (counterpart of
``paddle_tpu/framework/random.py``).

Paddle keeps one generator per device, reseeded by ``paddle.seed``.
The port keeps one ``torch.Generator`` per device in a
:class:`GeneratorRegistry`; initialisers, shuffling and dropout take a
generator explicitly and default to the registry's.  The JAX package
derives its keys with threefry and torch draws with Philox, so the two
packages give different numbers from one seed: tests that compare them
make their inputs with numpy.
"""

from __future__ import annotations

import threading

import torch

_DEFAULT_SEED = 0


class GeneratorRegistry:
    """One ``torch.Generator`` per device, all seeded from one seed."""

    def __init__(self, seed: int = _DEFAULT_SEED):
        self._lock = threading.Lock()
        self._seed = int(seed)
        self._gens = {}

    def seed(self, value: int) -> None:
        with self._lock:
            self._seed = int(value)
            for gen in self._gens.values():
                gen.manual_seed(self._seed)

    def get(self, device) -> torch.Generator:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            gen = self._gens.get(dev)
            if gen is None:
                gen = torch.Generator(device=dev)
                gen.manual_seed(self._seed)
                self._gens[dev] = gen
            return gen


_registry = GeneratorRegistry()


def seed(value: int) -> None:
    """Reseed the default generator of every device (``paddle.seed``)."""
    _registry.seed(value)


def default_generator(device="cpu") -> torch.Generator:
    """The default generator of ``device``."""
    return _registry.get(device)
