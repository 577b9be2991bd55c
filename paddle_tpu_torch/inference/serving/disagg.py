"""Disaggregated prefill/decode serving: two phase-pinned pools, one
front door (counterpart of ``paddle_tpu/inference/serving/disagg.py``).

Chunked prefill shortens a running stream's gaps while a long prompt is
admitted, but its chunks still share the decode engine's loop and
stream.  Disaggregation removes the sharing: prefill-role replicas own
admission and prefill, decode-role replicas own the steady batch, and a
finished prompt crosses between them as a
:class:`~.migration.PageMigration`, token for token (the noise is a
function of (seed, position)).  On one card both pools share its SMs;
each engine issues its work on a stream of its own (``engine.py``).

:class:`DisaggRouter` composes two :class:`~.router.ServingRouter`
pools and owns the transition between them:

- **submit** routes to the prefill pool and returns an OUTER future;
  the engine's future is tracked so the router can re-admit.
- **handoff**: each prefill replica's pump hands its tickets to
  :meth:`DisaggRouter._handoff`, which places them on the least-loaded
  decode replica; a full decode pool parks the ticket for the retry
  loop (:meth:`DisaggRouter.pump_pending`).
- **failover**: a prefill replica that dies mid-prompt fails its
  engine futures; the tracker sees a failure before the handoff and
  re-admits the prompt from scratch (seeds are resolved at the outer
  door, so a re-admitted sampled request samples the same tokens).
- **scaling** stays per pool and per signal: the prefill router on
  admission queue depth, the decode router on the windowed inter-token
  p99 (``phase="decode"``).
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

from ...observability import events as _obs_events
from .migration import PageMigration
from .router import Overloaded, ServingRouter

__all__ = ["DisaggRouter"]


class _Tracked:
    """One client request's crossing state: the outer future the
    client holds, the submission args needed to re-admit it, and
    whether its ticket ever reached the decode pool."""

    __slots__ = ("outer", "prompt", "kwargs", "handed_off", "retries")

    def __init__(self, outer: Future, prompt, kwargs: Dict[str, Any]):
        self.outer = outer
        self.prompt = list(prompt)
        self.kwargs = kwargs
        self.handed_off = False
        self.retries = 0


class DisaggRouter:
    """Phase-disaggregated serving front door over two replica pools.

    ``prefill_factory`` / ``decode_factory`` are zero-argument callables
    returning RUNNING ``LLMServer`` instances with ``role="prefill"``
    and ``role="decode"`` (another role is refused at spawn).
    ``prefill_pool`` / ``decode_pool`` go to the two routers
    (``min_replicas``, ``slo_p99_s``, …; ``phase`` is this class's and
    refused).  ``retry_interval_s=0`` disables the background retry
    thread; the caller drives :meth:`pump_pending` or
    :meth:`control_round`.
    """

    def __init__(self, prefill_factory: Callable[[], Any],
                 decode_factory: Callable[[], Any], *,
                 prefill_pool: Optional[Dict[str, Any]] = None,
                 decode_pool: Optional[Dict[str, Any]] = None,
                 retry_interval_s: float = 0.02,
                 max_readmissions: int = 3):
        prefill_pool = dict(prefill_pool or {})
        decode_pool = dict(decode_pool or {})
        for pool, name in ((prefill_pool, "prefill_pool"),
                           (decode_pool, "decode_pool")):
            if "phase" in pool:
                raise ValueError(
                    f"{name}['phase'] is owned by DisaggRouter")
        self.max_readmissions = int(max_readmissions)
        self._lock = threading.Lock()
        self._by_future: Dict[int, _Tracked] = {}
        self._pending: List[PageMigration] = []
        # seeds resolve at THIS door: the engine's default (the request
        # id) would change on re-admission, and with it a sampled
        # request's tokens; a counter fixed into the tracked arguments
        # keeps them while unseeded requests still differ
        self._auto_seed = itertools.count(0x5EED)
        self._closed = False

        def build_prefill():
            server = prefill_factory()
            hook = getattr(server, "set_handoff_handler", None)
            if hook is not None:
                hook(self._handoff)
            return server

        # decode pool first: a prefill replica can finish a prompt
        # (and call _handoff) the moment its pump starts
        self.decode = ServingRouter(decode_factory, phase="decode",
                                    **decode_pool)
        try:
            self.prefill = ServingRouter(build_prefill,
                                         phase="prefill",
                                         **prefill_pool)
        except Exception:
            self.decode.close()
            raise
        self.retry_interval_s = float(retry_interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.retry_interval_s > 0:
            self._thread = threading.Thread(
                target=self._retry_loop,
                name="paddle-torch-disagg-router", daemon=True)
            self._thread.start()

    # -- front door --------------------------------------------------------
    def submit(self, prompt_ids, max_tokens: int, stream_cb=None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed=None) -> Future:
        """Route one request through the disaggregated pipeline;
        returns a future resolving to the usual
        :class:`~.engine.GenerationResult`.  Raises
        :class:`~.router.Overloaded` when the prefill pool sheds."""
        if self._closed:
            raise RuntimeError("router closed")
        if seed is None and temperature > 0.0:
            seed = next(self._auto_seed)
        kwargs = {"max_tokens": max_tokens, "stream_cb": stream_cb,
                  "temperature": temperature, "top_k": top_k,
                  "top_p": top_p, "seed": seed}
        entry = _Tracked(Future(), prompt_ids, kwargs)
        self._admit(entry)
        return entry.outer

    def _admit(self, entry: _Tracked):
        inner = self.prefill.submit(entry.prompt, **entry.kwargs)
        with self._lock:
            self._by_future[id(inner)] = entry
        inner.add_done_callback(self._on_inner_done)

    def _on_inner_done(self, inner: Future):
        with self._lock:
            entry = self._by_future.pop(id(inner), None)
        if entry is None:
            return
        exc = inner.exception()
        if exc is None:
            entry.outer.set_result(inner.result())
            return
        # prefill-death failover: a failure BEFORE the handoff means the
        # pages died with the replica; the prompt is all it takes, and
        # the decode pool never saw it, so nothing races a re-admission
        if (self._closed or entry.handed_off
                or entry.retries >= self.max_readmissions):
            entry.outer.set_exception(exc)
            return
        entry.retries += 1
        _obs_events.record("prompt_readmitted",
                           retries=entry.retries,
                           error=f"{type(exc).__name__}")
        try:
            self._admit(entry)
        except Exception as e:  # noqa: BLE001 — re-admission door
            # shut too: the client gets the truth, not a hang
            entry.outer.set_exception(e)

    # -- the prefill→decode transition -------------------------------------
    def _handoff(self, mig: PageMigration):
        """Runs on a prefill replica's pump thread for every staged
        ticket (host only: the decode engine's locked inbox).  Marks
        the crossing BEFORE placement: once the ticket exists a
        re-admission would generate twice, so later failures surface
        on the future."""
        with self._lock:
            entry = self._by_future.get(id(mig.request.future))
        if entry is not None:
            entry.handed_off = True
        try:
            self.decode.submit_migration(mig)
        except Overloaded:
            # every decode replica full: park and retry (a prompt that
            # paid for its prefill is not failed for admission pressure)
            with self._lock:
                self._pending.append(mig)

    def pump_pending(self) -> int:
        """Retry parked tickets against the decode pool (the retry
        thread, or the caller).  Returns how many were placed."""
        with self._lock:
            pend, self._pending = self._pending, []
        placed = 0
        for mig in pend:
            if mig.consumed:
                continue
            try:
                self.decode.submit_migration(mig)
                placed += 1
            except Overloaded:
                with self._lock:
                    self._pending.append(mig)
            except Exception as e:  # noqa: BLE001 — geometry/consumed
                # refusals are terminal for this ticket
                if not mig.request.future.done():
                    mig.request.future.set_exception(e)
        return placed

    @property
    def pending_handoffs(self) -> int:
        with self._lock:
            return len(self._pending)

    def _retry_loop(self):
        while not self._stop.wait(self.retry_interval_s):
            try:
                self.pump_pending()
            except Exception as e:  # noqa: BLE001
                _obs_events.record("handoff_retry_failed",
                                   error=f"{type(e).__name__}: {e}")

    # -- control / observability -------------------------------------------
    def control_round(self) -> Dict[str, Any]:
        """One decision round over both pools and a pass over the
        parked tickets (each pool also runs its own loop when its
        ``decision_interval_s > 0``)."""
        return {"prefill": self.prefill.control_round(),
                "decode": self.decode.control_round(),
                "handoffs_placed": self.pump_pending()}

    def stats(self) -> Dict[str, Any]:
        return {
            "prefill_replicas": self.prefill.num_replicas,
            "decode_replicas": self.decode.num_replicas,
            "prefill_shedding": self.prefill.shedding,
            "decode_shedding": self.decode.shedding,
            "prefill_p99_s": self.prefill.windowed_p99_s(),
            "decode_intertoken_p99_s": self.decode.windowed_p99_s(),
            "pending_handoffs": self.pending_handoffs,
            "tracked_in_flight": len(self._by_future),
        }

    def to_config(self) -> Dict[str, Any]:
        """Both pools' knob profiles (see
        :meth:`~.router.ServingRouter.to_config`)."""
        return {"prefill_pool": self.prefill.to_config(),
                "decode_pool": self.decode.to_config(),
                "retry_interval_s": self.retry_interval_s,
                "max_readmissions": self.max_readmissions}

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        """Close both pools (prefill first, so no ticket is cut while
        the decode pool closes) and fail what is still parked."""
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.prefill.close()
        self.decode.close()
        with self._lock:
            pend, self._pending = self._pending, []
        exc = RuntimeError("router closed before completion")
        for mig in pend:
            if not mig.request.future.done():
                mig.request.future.set_exception(exc)

    def __enter__(self) -> "DisaggRouter":
        return self

    def __exit__(self, *a):
        self.close()
        return False
