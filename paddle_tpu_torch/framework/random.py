"""Random state of the port (counterpart of
``paddle_tpu/framework/random.py``).

Paddle keeps one generator per device, reseeded by ``paddle.seed``.
The port keeps one ``torch.Generator`` per device in a
:class:`GeneratorRegistry`; initialisers, shuffling and dropout take a
generator explicitly and default to the registry's.  The JAX package
derives its keys with threefry and torch draws with Philox, so the two
packages give different numbers from one seed: tests that compare them
make their inputs with numpy.

Under a CUDA graph (``Model.fit(steps_per_dispatch=K)``) the step draws
from the device's generator only if the graph was told of it:
:func:`register_with_graph` does that before the capture, and each
replay then advances the generator's Philox offset by what one eager
step takes (the JAX engine's ``gen._counter += fold``).
"""

from __future__ import annotations

import contextlib
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


def register_with_graph(graph, device) -> torch.Generator:
    """Register the default generator of ``device`` with ``graph`` (a
    ``torch.cuda.CUDAGraph`` not captured yet) and return it.  Raises
    ``NotImplementedError`` where the installed PyTorch has no
    ``CUDAGraph.register_generator_state``: a capture would then freeze
    the step's random draws."""
    register = getattr(graph, "register_generator_state", None)
    if register is None:
        raise NotImplementedError(
            f"torch {torch.__version__} cannot register a generator with "
            "a CUDA graph (CUDAGraph.register_generator_state), so a "
            "captured step would repeat one dropout mask: train with "
            "dropout 0 or fit(steps_per_dispatch=0) on this PyTorch")
    gen = default_generator(device)
    register(gen)
    return gen


def get_rng_state(device=None):
    """The state of the default generator of ``device`` (the current
    place's by default), as a one-element list as Paddle returns it."""
    from ..places import expected_device
    dev = expected_device() if device is None else device
    return [default_generator(dev).get_state()]


def set_rng_state(state, device=None):
    from ..places import expected_device
    dev = expected_device() if device is None else device
    default_generator(dev).set_state(
        state[0] if isinstance(state, (list, tuple)) else state)


get_cuda_rng_state = get_rng_state
set_cuda_rng_state = set_rng_state


class RNGStatesTracker:
    """The model-parallel RNG tracker (``get_rng_state_tracker``; the
    JAX package's ``RNGStatesTracker``): named seeds, ``global_seed``
    shared by the ranks of an mp group and ``local_seed`` distinct per mp
    rank.  ``rng_state(name)`` makes the named state the default
    generator of ``device`` inside the context (one ``torch.Generator``
    per name and device, seeded with the name's seed)."""

    def __init__(self):
        self.seeds_ = {}
        self._gens = {}

    def reset(self):
        self.seeds_ = {}
        self._gens = {}

    def add(self, name: str, seed: int):
        if seed in self.seeds_.values():
            raise ValueError(f"seed {seed} already exists")
        if name in self.seeds_:
            raise ValueError(f"state {name} already exists")
        self.seeds_[name] = int(seed)

    def _generator(self, name, device) -> torch.Generator:
        dev = torch.device(device)
        gen = self._gens.get((name, dev))
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.seeds_[name])
            self._gens[(name, dev)] = gen
        return gen

    def get_states_tracker(self):
        return {key: g.get_state() for key, g in self._gens.items()}

    def set_states_tracker(self, states):
        for (name, dev), s in states.items():
            self._generator(name, dev).set_state(s)

    @contextlib.contextmanager
    def rng_state(self, name: str = "global_seed", device="cpu"):
        if name not in self.seeds_:
            raise ValueError(f"state {name} does not exist")
        dev = torch.device(device)
        gen = self._generator(name, dev)
        with _registry._lock:
            orig = _registry._gens.get(dev)
            _registry._gens[dev] = gen
        try:
            yield
        finally:
            with _registry._lock:
                if orig is None:
                    _registry._gens.pop(dev, None)
                else:
                    _registry._gens[dev] = orig


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_random_seed(seed_: int, mp_rank: int = 0):
    """Seed the tracker as fleet does: a shared global seed and a local
    seed offset by the mp rank (the JAX package's offsets)."""
    _tracker.reset()
    _tracker.add("global_seed", seed_ + 100003)
    _tracker.add("local_seed", seed_ + 2048 + mp_rank * 1024)
