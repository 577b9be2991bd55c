"""LLMServer — the serving front door (counterpart of
``paddle_tpu/inference/serving/api.py``).

    weights = params_from_numpy(tree, device="cuda")
    server = LLMServer(params=weights, gpt_config=gpt2_small(),
                       max_batch=8, block_size=16, num_blocks=512,
                       prefill_chunk=512, prefix_cache=True,
                       auto_start=False)
    server.warmup([16, 64])          # build kernels, capture the step
    server.start()
    fut = server.submit(prompt_ids, max_tokens=64)
    result = fut.result()            # GenerationResult

One daemon pump thread owns the engine and issues all of its device
work on the current stream; ``submit`` only touches the (locked)
admission queue and wakes the pump, so it is safe from any thread and
never touches the device.  ``warmup`` captures the decode step's graphs
before the pump starts; an engine that was not warmed captures on its
first dispatches, in the pump thread, in "thread_local" capture mode,
so other threads' CUDA calls (a consumer reading a token) do not
invalidate it.  Streaming callbacks receive ``LazyScalar``
token views; reading one is the consumer's device sync.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

from .engine import DecodeEngine
from .scheduler import QueueFull  # noqa: F401  (re-export: caller API)


class LLMServer:
    """Continuous-batching generation server.  Keyword arguments other
    than ``auto_start``/``idle_wait_s`` go to :class:`DecodeEngine`
    (``prefill_chunk=``, ``prefix_cache=``, ``prefix_reserve_discount=``
    among them)."""

    def __init__(self, network=None, *, auto_start: bool = True,
                 idle_wait_s: float = 0.005, **engine_kwargs):
        self.engine = DecodeEngine(network, **engine_kwargs)
        self._idle_wait_s = float(idle_wait_s)
        self._cond = threading.Condition()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._warmup_record: Optional[Dict] = None
        if auto_start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "LLMServer":
        if self.running:
            return self
        self._closed = False
        self._thread = threading.Thread(target=self._pump,
                                        name="paddle-torch-llm-server",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self):
        """Stop the pump.  In-flight and queued requests get their
        futures failed with RuntimeError."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        self.engine.release_all(
            RuntimeError("server closed before completion"))
        self.engine.release_graphs()

    def __enter__(self) -> "LLMServer":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _pump(self):
        while True:
            with self._cond:
                if self._closed:
                    return
            try:
                busy = self.engine.step()
            except Exception as e:  # noqa: BLE001 — a dead pump must
                # not strand callers on futures that never resolve
                self.engine.release_all(RuntimeError(
                    f"serving engine failed: {type(e).__name__}: {e}"))
                raise
            if not busy:
                with self._cond:
                    if self._closed:
                        return
                    self._cond.wait(self._idle_wait_s)

    # -- traffic -------------------------------------------------------------
    def submit(self, prompt_ids, max_tokens: int, stream_cb=None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed=None):
        """Enqueue a request; returns its ``concurrent.futures.Future``
        resolving to a :class:`~.engine.GenerationResult`.  Raises
        :class:`QueueFull` under backpressure."""
        req = self.engine.submit(prompt_ids, max_tokens,
                                 stream_cb=stream_cb,
                                 temperature=temperature, top_k=top_k,
                                 top_p=top_p, seed=seed)
        with self._cond:
            self._cond.notify_all()
        return req.future

    def warmup(self, prompt_lengths: Optional[Sequence[int]] = None):
        """Warm the serving path BEFORE traffic, with the pump stopped
        (construct with ``auto_start=False``)."""
        if self.running:
            raise RuntimeError(
                "warmup() needs exclusive engine access: construct "
                "LLMServer(auto_start=False), warmup(), then start()")
        self._warmup_record = self.engine.warmup(prompt_lengths)
        return self._warmup_record

    def stats(self) -> Dict[str, object]:
        st = dict(self.engine.stats())
        if self._warmup_record is not None:
            st["warmup"] = self._warmup_record
        return st
