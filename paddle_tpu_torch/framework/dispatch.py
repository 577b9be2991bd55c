"""Step folding: the dispatch engine of ``Model.fit(steps_per_dispatch=K)``
(counterpart of ``paddle_tpu/framework/dispatch.py``).

The JAX engine compiles one rolled ``lax.scan`` of the training step
and runs a group of K logical steps as one dispatch; the scan body
compiles once for every fold length, so every K gives the same end
state.  The torch form of that body is one CUDA graph of ONE training
step, replayed once per logical step of a group:

- :func:`build_folded_step` builds the per-step runner of one batch
  signature: a :class:`CapturedStep` on a CUDA device, an
  :class:`EagerStep` (the same body run eagerly, batch after batch) on
  the CPU.
- :class:`GroupDispatcher` buffers logical steps into groups of K,
  splits a group where the batch shapes change, runs each group
  through the caller's ``run_group`` and replays the per-step
  callbacks with lazy views of the group's ``[K]`` loss buffer.
- :class:`AutoFoldTuner` picks K from the host and device time it
  measures over the first groups, as the JAX tuner does.
- :class:`CapturedCall` is what a captured step is made of (warm-up,
  capture with ledgers, replay); the serving engine's decode step
  (``inference/serving/engine.py``) is built on it too.

The contract of a captured step:

- **Warm-up.** The first logical step of a signature that has no graph
  yet runs eagerly on a side stream and counts as a real step: it
  builds the kernels, sets their shared-memory limits, resolves the
  tensor-map encoder, warms cuBLAS and the allocator, and creates the
  optimizer's state, the fp32 masters and the zero gradients.  The
  graph is captured right after it, on the same stream, and replayed
  for the group's next step.  K = 1, K = 4 and auto-K thus run the same
  sequence: one eager step, then replays.
- **Per replay** the host enqueues, on its current stream, the copy of
  batch *i* of the group into the graph's static inputs, the replay,
  and the copy of the graph's static loss into slot *i* of the group's
  ``[K]`` fp32 buffer.  The group's ``[K, ...]`` batch is staged to the
  device once.
- **What the graph holds.** The tensor maps of the tensor-core kernels
  are encoded while the graph is captured and baked into it, as are
  every other pointer: the static inputs, the parameters, the
  optimizer's state and the graph pool's intermediates.  Replays are
  right only because they reuse exactly those storages; anything that
  swaps a parameter's storage (``p.data = ...``, ``amp.decorate``)
  after a capture must be followed by ``Model.prepare``, which drops
  the graphs.
- **Host bookkeeping.** A replay runs no Python of the step, so the
  host counters the step moves (the kernel wrappers' launch counts,
  the optimizer's step counts) are read before and after the capture,
  put back, and moved by the capture's change once per replay.
- **Random draws.** If the warm-up drew from the device's generator,
  the generator is registered with the graph before the capture, so
  each replay advances its Philox offset as an eager step does (the
  JAX engine's ``gen._counter += fold``); a PyTorch that cannot
  register it raises.
- **No fallback.** A capture that fails raises with the CUDA error; the
  engine never carries on eagerly.  ``fit(steps_per_dispatch=0)`` is
  the one eager route.

- **Metrics.** A step body may return ``(loss, stats)``: one fp32 stat
  tensor per metric (``paddle_tpu_torch/metric``), computed in the step
  and so inside its graph.  The runner copies each step's stats into
  slot *i* of the group's ``[K, ...]`` stat stacks, as it does the loss;
  the body itself adds them into the model's accumulators, static
  buffers that the graph writes in place and that the model zeroes
  outside the graph at each epoch's start.

Knobs (``framework/env_knobs.py``): ``PADDLE_TORCH_FOLD_MAX`` (auto-K's
bound, 32), ``PADDLE_TORCH_FOLD_OVERHEAD_TARGET`` (host time a step may
take as a share of its device time, 0.05) and
``PADDLE_TORCH_FOLD_CALIB_GROUPS`` (groups measured at K=1 after the
first, 3).

Registry (``observability/metrics.py``), as the JAX engine writes it:
every group counts into ``dispatch_groups_total`` and
``dispatch_steps_total`` and its host wall time into the
``dispatch_wall_s`` histogram (host floats only, no device value); the
tuner's decision sets the ``dispatch_auto_fold``,
``dispatch_host_ms_per_step`` and ``dispatch_device_ms_per_step``
gauges.  Each group runs inside a ``dispatch.group`` span.  The JAX
engine's retrace counter goes with its retrace sentinel (ROADMAP queue
A, item 14).
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import env_knobs
from . import random as _random
from .lazy import LazyStack
from ..observability import metrics as _obs_metrics
from ..observability import trace as _obs_trace

logger = logging.getLogger("paddle_tpu_torch.dispatch")


def _observe_dispatch(n_steps: int, wall_s: float):
    """Count one group and its host wall time into the registry (host
    floats only, so the loop never waits for the device).  The
    instruments are fetched per call, so a ``registry().reset()`` cannot
    orphan them."""
    reg = _obs_metrics.registry()
    reg.counter("dispatch_groups_total",
                "dispatch groups issued").inc()
    reg.counter("dispatch_steps_total",
                "logical train steps dispatched").inc(n_steps)
    reg.histogram("dispatch_wall_s",
                  "host wall time per dispatch group (enqueue + callback "
                  "replay; device work is async)").observe(wall_s)


def _split(out):
    """A step body's result as ``(loss, stats)``."""
    if isinstance(out, tuple):
        return out[0], tuple(out[1])
    return out, ()

#: ``(read, write)`` of host counters a step moves: ``read()`` returns a
#: ``{key: int}`` table, ``write(table)`` sets the keys it names
Ledger = Tuple[Callable[[], Dict[Any, int]], Callable[[Dict[Any, int]], None]]


class EagerStep:
    """The CPU runner: the step body on each batch of a group in turn.
    ``captures`` is 1 from the start (the body built for its
    signature), as a :class:`CapturedStep` counts its one capture."""

    captures = 1

    def __init__(self, per_step: Callable):
        self._step = per_step

    def run(self, batches: Sequence[torch.Tensor], losses: torch.Tensor,
            mstacks: Sequence[torch.Tensor] = ()) -> None:
        """Run one step per slot of ``losses`` on ``[b[i] for b in
        batches]`` and write each step's loss, and each of its metric
        stats, into its slot."""
        for i in range(losses.shape[0]):
            loss, stats = _split(self._step([b[i] for b in batches]))
            losses[i].copy_(loss)
            for stack, stat in zip(mstacks, stats):
                stack[i].copy_(stat)

    def close(self) -> None:
        pass


class CapturedCall:
    """One CUDA graph of one callable, the pieces every captured engine
    shares (the fold engine's :class:`CapturedStep`, the serving
    engine's decode step): :meth:`warm_up` runs the callable eagerly on
    the graph's own stream, :meth:`capture` records it there into a
    graph in ``pool`` with the ``ledgers`` put back, and :meth:`replay`
    launches the graph on the current stream and moves the ledgers by
    the capture's change.  A capture that fails raises with its CUDA
    error.  ``stream`` (default: a new one) is the graph's stream:
    graphs captured into one pool reuse each other's freed blocks only
    when they were captured on the same stream (the caching allocator
    keys its free blocks by stream)."""

    def __init__(self, device: torch.device, pool,
                 ledgers: Sequence[Ledger] = (),
                 capture_error_mode: str = "global",
                 stream: Optional[torch.cuda.Stream] = None):
        self.device = device
        self._pool = pool
        self._ledgers = list(ledgers)
        self._mode = capture_error_mode
        self._stream = (stream if stream is not None
                        else torch.cuda.Stream(device))
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.generator: Optional[torch.Generator] = None
        self.captures = 0
        self.capture_s: Optional[float] = None
        self._draws = False
        self._deltas: List[Dict[Any, int]] = []

    def warm_up(self, fn: Callable[[], Any]) -> None:
        """``fn()`` once, eagerly, on the graph's stream after the
        current stream's work (the current stream then waits for it);
        notes whether it drew from the device's generator.  ``fn``
        leaves its results in tensors that outlive it."""
        current = torch.cuda.current_stream(self.device)
        gen = _random.default_generator(self.device)
        offset = gen.get_offset()
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            fn()
        current.wait_stream(self._stream)
        self._draws = gen.get_offset() != offset

    def capture(self, fn: Callable[[], Any]) -> Any:
        """Record ``fn()`` into the graph (nothing runs on the device);
        returns what ``fn`` returned, whose storage the graph owns."""
        graph = torch.cuda.CUDAGraph()
        if self._draws:
            self.generator = _random.register_with_graph(graph, self.device)
        before = [read() for read, _ in self._ledgers]
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode=self._mode):
            out = fn()
        self.capture_s = time.perf_counter() - t0
        for (read, write), old in zip(self._ledgers, before):
            new = read()
            self._deltas.append({k: n - old.get(k, 0) for k, n in new.items()
                                 if n != old.get(k, 0)})
            write(old)
        self.graph = graph
        self.captures += 1
        return out

    def replay(self) -> None:
        self.graph.replay()
        for (read, write), delta in zip(self._ledgers, self._deltas):
            if delta:
                now = read()
                write({k: now[k] + d for k, d in delta.items()})

    def close(self) -> None:
        """Free the graph (its pool's memory returns when every graph
        of the pool is gone)."""
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


class CapturedStep(CapturedCall):
    """One CUDA graph of one training step of one batch signature (see
    the module docstring): the first :meth:`run` warms up on its first
    slot and captures, every later slot replays."""

    def __init__(self, per_step: Callable, device: torch.device, pool,
                 ledgers: Sequence[Ledger] = ()):
        # thread-local: a DataLoader's worker threads pin host memory
        # (cudaHostAlloc) while the step captures, which a global capture
        # would count as an error of its own
        super().__init__(device, pool, ledgers,
                         capture_error_mode="thread_local")
        self._step = per_step
        # the graph's static inputs and output: their addresses are baked
        # into the graph (with the tensor maps the tensor-core kernels
        # encoded from them while it was captured, and the parameters'
        # and optimizer state's), so they are written in place and never
        # replaced while the graph lives
        self._inputs: Optional[List[torch.Tensor]] = None
        self.loss: Optional[torch.Tensor] = None
        self.stats: Tuple[torch.Tensor, ...] = ()

    def run(self, batches: Sequence[torch.Tensor], losses: torch.Tensor,
            mstacks: Sequence[torch.Tensor] = ()) -> None:
        """As :meth:`EagerStep.run`; everything is enqueued on the
        current stream and nothing waits for the device."""
        first = 0
        if self.graph is None:
            self._stage(batches, 0)

            def warm():
                loss, stats = _split(self._step(self._inputs))
                losses[0].copy_(loss)
                for stack, stat in zip(mstacks, stats):
                    stack[0].copy_(stat)

            self.warm_up(warm)
            self.loss, self.stats = _split(
                self.capture(lambda: self._step(self._inputs)))
            first = 1
        for i in range(first, losses.shape[0]):
            self._stage(batches, i)
            self.replay()
            self._take_loss(losses, i)
            self._take_stats(mstacks, i)

    def _stage(self, batches, i):
        if self._inputs is None:
            self._inputs = [torch.empty_like(b[0]) for b in batches]
        for dst, b in zip(self._inputs, batches):
            dst.copy_(b[i], non_blocking=True)

    def _take_loss(self, losses, i):
        losses[i].copy_(self.loss)

    def _take_stats(self, mstacks, i):
        for stack, stat in zip(mstacks, self.stats):
            stack[i].copy_(stat)

    def close(self) -> None:
        super().close()
        self._inputs = self.loss = None
        self.stats = ()


def build_folded_step(per_step: Callable, device: torch.device, pool=None,
                      ledgers: Sequence[Ledger] = ()):
    """The per-step runner of one batch signature.  ``per_step(values)``
    takes the step's device tensors (inputs, then labels) and returns
    its loss as a 0-d fp32 tensor, or ``(loss, stats)`` with one fp32
    metric stat per metric; on a CUDA device the runner captures
    it into a graph in ``pool`` (``torch.cuda.graph_pool_handle()``,
    shared by a model's graphs) and keeps ``ledgers`` moving per replay;
    on the CPU it runs it eagerly."""
    if device.type == "cuda":
        return CapturedStep(per_step, device, pool, ledgers)
    return EagerStep(per_step)


# -- auto-K ---------------------------------------------------------------


class AutoFoldTuner:
    """Pick the fold factor K from measured host and device time
    (``paddle_tpu/framework/dispatch.py::AutoFoldTuner``).

    Protocol: the :class:`GroupDispatcher` runs its first
    ``1 + calib_groups`` groups at K = 1.  The first (warm-up and
    capture) is discarded; for each of the rest the dispatcher reports
    ``observe(n_steps, host_s, wait_s)``: the host time spent enqueuing
    the group and replaying its callbacks, and the device time it then
    waited for.  K is then frozen at::

        K = clamp(ceil(host_per_step / (target * device_per_step)),
                  1, max_fold)

    the smallest K whose host time per step is at most ``target`` of
    the device time per step.  A host-bound loop saturates at
    ``max_fold``; a device-bound one stays at 1.  The decision is
    logged and kept in ``self.decision``.
    """

    def __init__(self, target: Optional[float] = None,
                 max_fold: Optional[int] = None,
                 calib_groups: Optional[int] = None):
        self.target = (target if target is not None else
                       env_knobs.get_float(
                           "PADDLE_TORCH_FOLD_OVERHEAD_TARGET", 0.05))
        self.max_fold = max(1, max_fold if max_fold is not None else
                            env_knobs.get_int("PADDLE_TORCH_FOLD_MAX", 32))
        self.calib_groups = max(1, calib_groups if calib_groups
                                is not None else
                                env_knobs.get_int(
                                    "PADDLE_TORCH_FOLD_CALIB_GROUPS", 3))
        self.fold = 1
        self.decided = False
        self.decision: Optional[dict] = None
        self._host: List[float] = []
        self._wait: List[float] = []
        self._seen_first = False

    def observe(self, n_steps: int, host_s: float, wait_s: float):
        if self.decided or n_steps <= 0:
            return
        if not self._seen_first:
            # the first group warms up and captures: its time says
            # nothing about the steady state
            self._seen_first = True
            return
        self._host.append(host_s / n_steps)
        self._wait.append(wait_s / n_steps)
        if len(self._host) >= self.calib_groups:
            self._decide()

    @staticmethod
    def _median(xs: List[float]) -> float:
        s = sorted(xs)
        return s[len(s) // 2]

    def _decide(self):
        host = self._median(self._host)
        step = self._median(self._wait)
        if step <= 0.0 or host > self.target * step * self.max_fold:
            k = self.max_fold     # host-bound, or device time unmeasurable
        else:
            k = max(1, math.ceil(host / (self.target * step)))
        self.fold = min(self.max_fold, k)
        self.decided = True
        self.decision = {
            "fold": self.fold,
            "host_ms_per_step": round(host * 1e3, 4),
            "device_ms_per_step": round(step * 1e3, 4),
            "overhead_target": self.target,
            "max_fold": self.max_fold,
            "calib_groups": self.calib_groups,
        }
        logger.info("auto-fold: host %.3f ms/step, device %.3f ms/step "
                    "-> steps_per_dispatch=%d (target %.0f%%, max %d)",
                    host * 1e3, step * 1e3, self.fold,
                    self.target * 100, self.max_fold)
        reg = _obs_metrics.registry()
        reg.gauge("dispatch_auto_fold",
                  "auto-tuned steps_per_dispatch K").set(self.fold)
        reg.gauge("dispatch_host_ms_per_step",
                  "measured host overhead per step (calibration)"
                  ).set(round(host * 1e3, 4))
        reg.gauge("dispatch_device_ms_per_step",
                  "measured device time per step (calibration)"
                  ).set(round(step * 1e3, 4))


# -- host-side grouping ---------------------------------------------------


class GroupDispatcher:
    """Buffer logical train steps into fold groups and run each group
    through ``run_group`` (``paddle_tpu/framework/dispatch.py::
    GroupDispatcher``).

    ``run_group(groups)`` receives ``[(inputs, labels), ...]`` and
    returns ``(losses, mstacks)``: a :class:`LazyStack` of the group's
    losses and one of each metric's ``[K, ...]`` stat stack.
    ``emit_group(entries, losses, mstacks)`` replays the buffered
    per-step callbacks in order; an entry whose inputs are ``None`` is
    an accumulate intermediate (:meth:`feed_marker`), which carries no
    compute.

    A batch-shape change (an uneven last batch, a bucketed loader)
    closes the open group, which runs as a shorter group of the same
    step; grouping never changes the numbers.  With an
    :class:`AutoFoldTuner` the first groups run at K = 1 and carry its
    calibration wait; its K applies from the moment it decides.
    """

    def __init__(self, run_group: Callable, emit_group: Callable,
                 fold: int = 1, tuner: Optional[AutoFoldTuner] = None):
        self._run = run_group
        self._emit = emit_group
        self._fold = max(1, int(fold))
        self.tuner = tuner
        self._group: List[Tuple[int, Any, Any]] = []
        self._sig = None

    @property
    def fold(self) -> int:
        return self.tuner.fold if self.tuner is not None else self._fold

    @property
    def pending(self) -> bool:
        return bool(self._group)

    @staticmethod
    def _group_sig(inputs, labels):
        return tuple((tuple(v.shape), str(getattr(v, "dtype", None)))
                     for v in (*inputs, *labels))

    def feed(self, step: int, inputs, labels):
        sig = self._group_sig(inputs, labels)
        n_logical = sum(1 for _, i, _l in self._group if i is not None)
        if self._group and sig != self._sig:
            self.flush()          # shape change: run the prefix now
            n_logical = 0
        if not self._group:
            self._sig = sig
        self._group.append((step, inputs, labels))
        if n_logical + 1 >= self.fold:
            self.flush()

    def feed_marker(self, step: int):
        """Buffer an accumulate intermediate between logical steps, so
        that its callbacks replay in step order at the next flush."""
        self._group.append((step, None, None))

    def flush(self):
        """Run the buffered group, then replay its per-step callbacks
        with index-sliced lazy values."""
        if not self._group:
            return
        entries, self._group = self._group, []
        logical = [(i, l) for _, i, l in entries if i is not None]
        if not logical:
            self._emit(entries, None, [])
            return
        tuner = self.tuner
        sp = _obs_trace.span(
            "dispatch.group",
            args=({"steps": len(logical), "fold": self.fold}
                  if _obs_trace.enabled() else None))
        if tuner is not None and not tuner.decided:
            with sp:
                t0 = time.perf_counter()
                losses, mstacks = self._run(logical)
                t1 = time.perf_counter()
                self._calibration_block(losses)
                t2 = time.perf_counter()
                self._emit(entries, losses, mstacks)
                t3 = time.perf_counter()
            tuner.observe(len(logical), (t1 - t0) + (t3 - t2), t2 - t1)
            _observe_dispatch(len(logical), t3 - t0)
            return
        t0 = time.perf_counter()
        with sp:
            losses, mstacks = self._run(logical)
            self._emit(entries, losses, mstacks)
        _observe_dispatch(len(logical), time.perf_counter() - t0)

    @staticmethod
    def _calibration_block(losses: LazyStack):
        """The engine's one device wait: during the first
        ``calib_groups`` groups of an auto-tuned fit only, so the tuner
        can split host time from device time."""
        losses.block()
