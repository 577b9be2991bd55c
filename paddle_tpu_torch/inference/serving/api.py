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

One daemon pump thread owns the engine, which issues all of its device
work on its own stream (``engine.stream``); ``submit`` only touches the
(locked) admission queue and wakes the pump, so it is safe from any
thread and never touches the device.  ``warmup`` captures the decode step's graphs
before the pump starts; an engine that was not warmed captures on its
first dispatches, in the pump thread, in "thread_local" capture mode,
so other threads' CUDA calls (a consumer reading a token) do not
invalidate it.  Streaming callbacks receive ``LazyScalar``
token views; reading one is the consumer's device sync.

    server = LLMServer(net, draft=net, spec_k=4, max_batch=8)

A speculative server (``draft=`` or ``draft_params=``) streams a fixed
``k+1`` views a lane per decode dispatch: the host does not know the
accepted count without a sync, so positions past it read as the
negative :data:`SPEC_SENTINEL`, and up to ``k`` tokens past
``max_tokens`` may stream before the device's stop is polled (the
resolved result is always sentinel-free and cut).
:func:`filter_spec_stream` turns such a stream into plain in-order
tokens.

    dec = LLMServer(params=w, gpt_config=cfg, role="decode")
    pre = LLMServer(params=w, gpt_config=cfg, role="prefill",
                    on_handoff=dec.submit_migration)

A prefill-role server's pump hands every ticket its engine staged out
(:class:`~.migration.PageMigration`) to ``on_handoff`` (the
``DisaggRouter`` installs its own with :meth:`LLMServer.
set_handoff_handler`), or parks it for :meth:`LLMServer.pop_handoffs`;
a handler that raises fails that request's future, not the pump.  A
decode-role server takes tickets through :meth:`LLMServer.
submit_migration`.  ``metrics_port=`` (0: an ephemeral port, read back
from :attr:`LLMServer.metrics_port`) serves the process-wide registry,
the trace and the decision ring over HTTP on 127.0.0.1
(``observability/http.py``) until :meth:`LLMServer.close`.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

from .decode_model import extract_decode_params
from .engine import DecodeEngine
from .scheduler import QueueFull  # noqa: F401  (re-export: caller API)
from .spec_decode import SPEC_SENTINEL  # noqa: F401  (re-export)


def filter_spec_stream(cb, max_tokens: Optional[int] = None):
    """Adapt a plain ``cb(request_id, index, int_token)`` callback to a
    speculative engine's stream: drops :data:`SPEC_SENTINEL`
    placeholders, numbers the surviving tokens densely, and (given
    ``max_tokens``) drops the last window's tokens past the cap.
    Reading each lazy view to decide is a device sync, the consumer's;
    a consumer that needs the sync-free stream keeps the raw callback
    and skips negative values where it reads them."""
    counts: Dict[object, int] = {}

    def wrapped(request_id, index, lazy_tok):
        tok = int(lazy_tok)
        if tok == SPEC_SENTINEL:
            return
        n = counts.get(request_id, 0)
        if max_tokens is not None and n >= max_tokens:
            return
        counts[request_id] = n + 1
        cb(request_id, n, tok)

    return wrapped


class LLMServer:
    """Continuous-batching generation server.  ``network`` is the
    port's ``GPTForCausalLM`` (its weights copied at construction; see
    :meth:`refresh_weights`), or pass ``params=``/``gpt_config=``.
    Keyword arguments other than ``auto_start``, ``idle_wait_s``,
    ``metrics_port`` and ``on_handoff`` go to :class:`DecodeEngine`
    (``role=``, ``prefill_chunk=``, ``prefix_cache=``,
    ``prefix_reserve_discount=``, ``draft=``, ``spec_k=`` among
    them)."""

    def __init__(self, network=None, *, auto_start: bool = True,
                 idle_wait_s: float = 0.005,
                 metrics_port: Optional[int] = None,
                 on_handoff=None, **engine_kwargs):
        self.engine = DecodeEngine(network, **engine_kwargs)
        self._on_handoff = on_handoff
        self._handoffs: list = []
        self._idle_wait_s = float(idle_wait_s)
        self._cond = threading.Condition()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._warmup_record: Optional[Dict] = None
        self._metrics_server = None
        if metrics_port is not None:
            from ...observability import http as _obs_http
            self._metrics_server = _obs_http.serve(int(metrics_port))
        if auto_start:
            self.start()

    @property
    def metrics_port(self) -> Optional[int]:
        """The bound scrape port (None when not serving one)."""
        return (None if self._metrics_server is None
                else self._metrics_server.port)

    @property
    def role(self) -> str:
        """The engine's phase role ("both", "prefill" or "decode")."""
        return self.engine.role

    def set_handoff_handler(self, fn) -> "LLMServer":
        """Install or replace the handoff hook; the pump reads it each
        round, so a running server may take it."""
        self._on_handoff = fn
        return self

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

    def stop(self, timeout: float = 30.0):
        """Stop the pump and keep the rest: queued requests stay queued,
        seated ones seated, the captured decode steps captured;
        :meth:`start` resumes.  Raises ``RuntimeError`` if the pump is
        still inside a step after ``timeout`` seconds; the server then
        stays :attr:`running`, so :meth:`warmup` and
        :meth:`refresh_weights` keep refusing."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"the serving pump did not stop within {timeout} s: "
                    "a step is still in flight")
            self._thread = None

    def close(self, unregister_metrics: bool = False):
        """Stop the pump.  In-flight, queued and migrating requests get
        their futures failed with RuntimeError, the captured steps are
        freed and the scrape endpoint closes.  The engine's registry
        children stay (a later scrape still answers) unless
        ``unregister_metrics``."""
        self.stop()
        self._fail_all(RuntimeError("server closed before completion"))
        self.engine.release_graphs()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        if unregister_metrics:
            self.engine.unregister_metrics()

    def _fail_all(self, exc: Exception):
        """Fail every request this server holds, tickets included, and
        release its pool state."""
        for mig in self.engine.drain_all_migrations() + self.pop_handoffs():
            if not mig.request.future.done():
                mig.request.future.set_exception(exc)
        self.engine.release_all(exc)

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
                busy = self._dispatch_handoffs() or busy
            except Exception as e:  # noqa: BLE001 — a dead pump must
                # not strand callers on futures that never resolve
                self._fail_all(RuntimeError(
                    f"serving engine failed: {type(e).__name__}: {e}"))
                raise
            if not busy:
                with self._cond:
                    if self._closed:
                        return
                    self._cond.wait(self._idle_wait_s)

    def _dispatch_handoffs(self) -> bool:
        """Hand the tickets the engine staged out to the hook (pump
        thread), or park them for :meth:`pop_handoffs`."""
        migs = self.engine.pop_ready_migrations()
        for mig in migs:
            if self._on_handoff is None:
                self._handoffs.append(mig)
                continue
            try:
                self._on_handoff(mig)
            except Exception as e:  # noqa: BLE001 — one bad handoff
                # fails its request, not the pump and every other one
                if not mig.request.future.done():
                    mig.request.future.set_exception(RuntimeError(
                        "prefill→decode handoff failed: "
                        f"{type(e).__name__}: {e}"))
        return bool(migs)

    def pop_handoffs(self) -> list:
        """Take the tickets parked for want of a handoff hook."""
        out, self._handoffs = self._handoffs, []
        return out

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

    def submit_migration(self, mig) -> None:
        """Give a migrated request to this (decode-role) server's engine
        and wake the pump; the engine's refusals propagate
        (:class:`QueueFull`: try another replica)."""
        self.engine.submit_migration(mig)
        with self._cond:
            self._cond.notify_all()

    def warmup(self, prompt_lengths: Optional[Sequence[int]] = None):
        """Warm the serving path BEFORE traffic, with the pump stopped
        (construct with ``auto_start=False``)."""
        if self.running:
            raise RuntimeError(
                "warmup() needs exclusive engine access: construct "
                "LLMServer(auto_start=False), warmup(), then start()")
        self._warmup_record = self.engine.warmup(prompt_lengths)
        return self._warmup_record

    def refresh_weights(self, network, draft=None):
        """Take new weights from a (re)trained network, with the pump
        stopped (:meth:`stop`, as for :meth:`warmup`).  A speculative
        server takes the draft's too; refreshing the target alone is
        allowed (a stale draft lowers the accept rate, never a
        token).  The values are
        copied IN PLACE into the served weights, whose addresses the
        captured decode steps hold: the next replay reads them and
        nothing is captured again.  Shapes and dtypes must match the
        served ones (``ValueError``)."""
        if self.running:
            raise RuntimeError("stop the server before refreshing "
                               "weights")
        dev = self.engine.device
        self.engine.load_params(
            extract_decode_params(network, device=dev),
            None if draft is None else extract_decode_params(draft,
                                                             device=dev))

    def stats(self) -> Dict[str, object]:
        st = dict(self.engine.stats())
        if self._warmup_record is not None:
            st["warmup"] = self._warmup_record
        return st
