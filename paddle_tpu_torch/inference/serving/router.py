"""SLO-aware serving router: replica autoscaling and admission
shedding (counterpart of ``paddle_tpu/inference/serving/router.py``).

The engines export queue depth, latency histograms and KV
fragmentation on the process-wide metrics registry;
:class:`ServingRouter` turns them into capacity and admission
decisions:

- **Routing.**  ``submit`` goes to the least-loaded live replica (queue
  depth + running batch); a replica answering
  :class:`~.scheduler.QueueFull` fails over to the next.  A replica is
  an ordinary ``LLMServer`` built by the caller's ``replica_factory``.
- **Scaling.**  A control loop samples the signals every
  ``decision_interval_s`` with hysteresis: the overload signal (queue
  depth per replica above ``scale_up_queue_depth``, admissions shed
  since the last round, or the windowed p99 above ``slo_p99_s``) must
  hold for ``windows_up`` consecutive rounds before a spawn, the
  underload signal for ``windows_down`` before a retire, and each
  action starts a ``cooldown_s`` lockout.  A retired replica drains
  (no admissions; it closes when its batch is done, its registry
  children reclaimed).
- **Shedding.**  Overloaded with capacity that cannot grow (at
  ``max_replicas`` or in cooldown), the router sheds at the door:
  ``submit`` raises :class:`Overloaded`.  Each shed consults the
  droppable ``router.shed`` fault site, so a chaos plan can suppress
  the relief.
- **p99 over a window.**  Registry histograms are cumulative; the loop
  diffs consecutive snapshots and estimates the p99 of the
  observations inside the window (``router_p99_s``).

Every decision lands on the registry (``serving_replicas``,
``router_scale_ups_total``, ``router_scale_downs_total``,
``router_shed_total``) and on the decision ring
(``observability/events.py``, ``/events`` over ``metrics_port=``).

The control loop reads host state only (queue depths, host-float
histograms, ``collect(materialize=False)``): it never waits for the
device, and ``control_round`` runs under
``torch.cuda.set_sync_debug_mode("error")`` (``chip_smoke.py``,
``[serve router]``).  A decode pool's SLO signal is
``serving_intertoken_s``, the host's gap between decode dispatches: on
the card that is the host's enqueue pace while the launch queue is not
full, not the device's pace, and nothing here syncs to make it one.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ...distributed.resilience import faults as _faults
from ...observability import events as _obs_events
from ...observability import metrics as _obs_metrics
from .scheduler import QueueFull

__all__ = ["ServingRouter", "Overloaded", "ROUTER_PHASES"]

#: the phase a router's pool can be pinned to: None is a pool of
#: "both"-role replicas; "prefill"/"decode" pools refuse replicas of
#: any other role at spawn and judge their own signal, prefill on the
#: admission queue and request latency, decode on the windowed
#: inter-token p99 (``serving_intertoken_s``)
ROUTER_PHASES = (None, "prefill", "decode")


class Overloaded(QueueFull):
    """The router is shedding admissions: every replica's queue is
    full, or the SLO policy turned shedding on.  Subclasses
    :class:`QueueFull` so existing backpressure handling upstream of
    ``LLMServer`` covers the router unchanged."""


def _window_cum(prev, cur):
    """Cumulative bucket counts of the observations BETWEEN two
    cumulative histogram snapshots (``Histogram.collect()`` shape) —
    a diff of cumulatives is itself cumulative."""
    cur_cum = [c for _, c in cur.get("buckets", [])]
    prev_cum = ([c for _, c in prev.get("buckets", [])]
                if prev else [])
    if len(prev_cum) != len(cur_cum):
        prev_cum = [0] * len(cur_cum)
    return [max(c - p, 0) for p, c in zip(prev_cum, cur_cum)]


def _quantile_from_cum(edges: List[float], cum: List[float],
                       q: float) -> Optional[float]:
    """q-quantile from cumulative bucket counts with linear
    interpolation inside the landing bucket, exactly like
    ``Histogram.quantile`` (the +Inf bucket clamps to the top finite
    edge).  None when the window saw no observations — absence of
    traffic is not a latency."""
    n = cum[-1] if cum else 0
    if n <= 0:
        return None
    rank = q * n
    prev_c = 0.0
    for i, c in enumerate(cum):
        if c >= rank and c > prev_c:
            lo = 0.0 if i == 0 else float(edges[i - 1])
            hi = float(edges[i] if i < len(edges) - 1 else edges[-2])
            frac = (rank - prev_c) / (c - prev_c)
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        prev_c = c
    return float(edges[-2]) if len(edges) > 1 else None


def _delta_quantile(prev, cur, q: float) -> Optional[float]:
    """q-quantile of one histogram's observations between two
    snapshots (unit-tested; ``_signals`` runs the same math over the
    replica-merged window)."""
    return _quantile_from_cum([e for e, _ in cur.get("buckets", [])],
                              _window_cum(prev, cur), q)


class _Replica:
    """One managed ``LLMServer`` plus the router's view of it."""

    _seq = 0

    def __init__(self, server):
        _Replica._seq += 1
        self.name = f"replica-{_Replica._seq}"
        self.server = server
        self.draining = False
        # last cumulative latency snapshot, for the windowed p99 diff
        self.last_latency: Optional[Dict[str, Any]] = None

    # -- host-only signal reads (materialize=False everywhere) ------------
    @property
    def alive(self) -> bool:
        """Pump thread still running (a crashed replica must stop
        receiving admissions and be reaped; stub servers without the
        property count as alive)."""
        return bool(getattr(self.server, "running", True))

    @property
    def queue_depth(self) -> int:
        # accepted-but-unseated migrations ARE queue depth on a
        # decode replica: same admission backlog, different door
        eng = self.server.engine
        return (eng.scheduler.queue_depth
                + int(getattr(eng, "pending_migrations", 0)))

    @property
    def active(self) -> int:
        return self.server.engine.active_count

    @property
    def load(self) -> int:
        return self.queue_depth + self.active

    def signal_snapshot(self, hist_attr: str) -> Dict[str, Any]:
        """Cumulative snapshot of this replica's SLO histogram:
        ``_h_latency`` (pools of "both" and prefill replicas) or
        ``_h_intertoken`` (decode pools)."""
        return getattr(self.server.engine, hist_attr).collect(
            materialize=False)


class ServingRouter:
    """Admission router + SLO-driven autoscaler over ``LLMServer``
    replicas.

    ``replica_factory`` is a zero-argument callable returning a
    RUNNING ``LLMServer`` (a factory that warms it makes spawns cheap).
    ``decision_interval_s=0`` disables the background loop; the caller
    drives :meth:`control_round`.  ``metrics_port`` serves the registry
    and ``/events`` over HTTP on 127.0.0.1 (0: an ephemeral port, read
    back from :attr:`metrics_port`).
    """

    #: the knobs :meth:`to_config` exports and :meth:`from_config`
    #: takes back (an unknown key is refused)
    CONFIG_KNOBS = ("phase", "min_replicas", "max_replicas",
                    "slo_p99_s", "scale_up_queue_depth",
                    "scale_down_queue_depth", "windows_up",
                    "windows_down", "cooldown_s",
                    "decision_interval_s", "drain_relief_rate",
                    "predictive_scale_rate")

    def __init__(self, replica_factory: Callable[[], Any], *,
                 phase: Optional[str] = None,
                 min_replicas: int = 1, max_replicas: int = 2,
                 slo_p99_s: Optional[float] = None,
                 scale_up_queue_depth: float = 4.0,
                 scale_down_queue_depth: float = 0.5,
                 windows_up: int = 2, windows_down: int = 8,
                 cooldown_s: float = 5.0,
                 decision_interval_s: float = 0.25,
                 drain_relief_rate: float = 0.0,
                 predictive_scale_rate: float = 0.0,
                 metrics_port: Optional[int] = None):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if phase not in ROUTER_PHASES:
            raise ValueError(
                f"phase {phase!r} is not one of {ROUTER_PHASES}")
        self.phase = phase
        # decode pools judge the SLO on the inter-token gap (the
        # steady-state jitter disaggregation exists to protect);
        # everything else judges request latency
        self._hist_attr = ("_h_intertoken" if phase == "decode"
                           else "_h_latency")
        self._factory = replica_factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.slo_p99_s = (None if slo_p99_s is None
                          else float(slo_p99_s))
        self.scale_up_queue_depth = float(scale_up_queue_depth)
        self.scale_down_queue_depth = float(scale_down_queue_depth)
        self.windows_up = max(int(windows_up), 1)
        self.windows_down = max(int(windows_down), 1)
        self.cooldown_s = float(cooldown_s)
        self.decision_interval_s = float(decision_interval_s)
        # drain relief: a per-replica queue FALLING at >= this rate
        # (requests per round) discounts the depth and shed evidence (a
        # burst already draining should not latch shedding); 0 = off;
        # an SLO violation always counts
        self.drain_relief_rate = float(drain_relief_rate)
        # predictive scale-up: a queue RISING at >= this rate (requests
        # per replica per round) is overload evidence before the level
        # crosses scale_up_queue_depth; 0 = off; windows_up and the
        # cooldown still gate the spawn
        self.predictive_scale_rate = float(predictive_scale_rate)
        self._prev_queue: Optional[int] = None
        self._lock = threading.Lock()
        self._replicas: List[_Replica] = []
        self._shedding = False
        self._sheds_in_window = 0   # queue-full sheds since last round
        self._up_streak = 0
        self._down_streak = 0
        self._last_scale_t: float = -float("inf")
        self._last_p99: Optional[float] = None
        self._closed = False
        reg = _obs_metrics.registry()
        # phase-pinned pools label their children, so the two routers
        # of a disaggregated deployment never share one child
        labels = {"phase": phase} if phase is not None else None
        self._obs_labels = labels
        self._g_replicas = reg.gauge(
            "serving_replicas",
            "live (non-draining) LLMServer replicas behind the "
            "router", labels=labels)
        self._g_p99 = reg.gauge(
            "router_p99_s",
            "windowed p99 of the pool's SLO signal (request latency; "
            "inter-token gap for decode pools); absent when the "
            "window saw no observations", labels=labels)
        self._g_queue = reg.gauge(
            "router_queue_depth",
            "waiting requests summed across replicas "
            "(pending migrations included)", labels=labels)
        self._c_requests = reg.counter(
            "router_requests_total", "admissions routed to a replica",
            labels=labels)
        self._c_shed = reg.counter(
            "router_shed_total",
            "admissions shed at the router door (Overloaded)",
            labels=labels)
        self._c_up = reg.counter(
            "router_scale_ups_total", "replicas spawned by the SLO "
            "control loop", labels=labels)
        self._c_down = reg.counter(
            "router_scale_downs_total", "replicas retired by the SLO "
            "control loop", labels=labels)
        for _ in range(self.min_replicas):
            self._spawn_replica(reason="min_replicas")
        self._g_replicas.set(len(self._replicas))
        self._metrics_server = None
        if metrics_port is not None:
            from ...observability import http as _obs_http
            self._metrics_server = _obs_http.serve(int(metrics_port))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.decision_interval_s > 0:
            self._thread = threading.Thread(
                target=self._control_loop,
                name="paddle-torch-serving-router", daemon=True)
            self._thread.start()

    # -- capacity ----------------------------------------------------------
    def _spawn_replica(self, reason: str) -> _Replica:
        """Build one replica through the factory; the ``replica.spawn``
        fault site runs FIRST so chaos can fail the spawn path itself
        (the control loop survives and retries after cooldown)."""
        _faults.fault_point("replica.spawn",
                            n=len(self._replicas) + 1, reason=reason)
        server = self._factory()
        if self.phase is not None:
            # a replica of another role is refused: a "decode pool" of
            # both-role replicas would let prefill back into the steady
            # batch this tier exists to protect
            role = getattr(server, "role", "both")
            if role != self.phase:
                try:
                    server.close(unregister_metrics=True)
                except Exception:  # noqa: BLE001
                    pass
                raise ValueError(
                    f"router phase {self.phase!r} refused: "
                    f"replica_factory built a {role!r}-role server "
                    f"(pass role={self.phase!r} to the LLMServer)")
        rep = _Replica(server)
        with self._lock:
            self._replicas.append(rep)
        return rep

    def _live(self) -> List["_Replica"]:
        """Routable replicas (lock held by caller NOT required —
        takes it): not draining, pump alive, least-loaded first."""
        with self._lock:
            reps = [r for r in self._replicas
                    if not r.draining and r.alive]
        return sorted(reps, key=lambda r: r.load)

    @property
    def replicas(self) -> List[Any]:
        """Live (non-draining) replica servers, least-loaded first."""
        return [r.server for r in self._live()]

    @property
    def num_replicas(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas
                       if not r.draining and r.alive)

    @property
    def shedding(self) -> bool:
        return self._shedding

    def windowed_p99_s(self) -> Optional[float]:
        """p99 over the completions of the last decision window (None
        when that window saw none)."""
        return self._last_p99

    # -- front door --------------------------------------------------------
    def submit(self, prompt_ids, max_tokens: int, stream_cb=None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed=None):
        """Route one request to the least-loaded replica; returns its
        future.  Sampling arguments go to ``LLMServer.submit`` (the
        noise is a function of (seed, position), so the replica does
        not change a token).  Raises :class:`Overloaded` when the router
        is shedding or every replica's queue is full."""
        if self._closed:
            raise RuntimeError("router closed")
        if self.phase == "decode":
            raise ValueError(
                "decode-phase router admits only migrations "
                "(submit_migration); route prompts to the prefill "
                "pool")
        reps = self._live()
        if not reps:
            raise RuntimeError("router has no live replicas")
        if self._shedding and not _faults.should_drop(
                "router.shed", depth=sum(r.queue_depth for r in reps)):
            # a POLICY shed is the state doing its job, not fresh
            # overload evidence — feeding it back into the signal
            # would latch shedding on for as long as clients retry
            self._c_shed.inc()
            raise Overloaded(
                "router is shedding: SLO policy is on and capacity "
                "cannot grow — retry with backoff upstream")
        last_exc: Optional[Exception] = None
        for rep in reps:
            try:
                fut = rep.server.submit(prompt_ids, max_tokens,
                                        stream_cb=stream_cb,
                                        temperature=temperature,
                                        top_k=top_k, top_p=top_p,
                                        seed=seed)
            except QueueFull as e:
                last_exc = e
                continue
            self._c_requests.inc()
            return fut
        # every queue full: this IS a shed, whatever the policy state
        self._note_shed()
        raise Overloaded(
            f"all {len(reps)} replica queues full "
            f"({last_exc})") from last_exc

    def submit_migration(self, mig) -> Any:
        """Route one prefill→decode migration to the least-loaded
        replica that takes it (a full one fails over to the next; all
        full: :class:`Overloaded`, counted as a shed, and the caller
        parks the ticket and retries).  Returns the accepting server."""
        if self._closed:
            raise RuntimeError("router closed")
        if self.phase == "prefill":
            raise ValueError(
                "prefill-phase router cannot accept migrations: its "
                "replicas never decode")
        reps = self._live()
        if not reps:
            raise RuntimeError("router has no live replicas")
        last_exc: Optional[Exception] = None
        for rep in reps:
            try:
                rep.server.submit_migration(mig)
            except QueueFull as e:
                last_exc = e
                continue
            self._c_requests.inc()
            return rep.server
        self._note_shed()
        raise Overloaded(
            f"all {len(reps)} decode replicas full "
            f"({last_exc})") from last_exc

    def _note_shed(self):
        """Count a queue-full shed on the registry and as overload
        evidence for the next round: a burst that fills and drains the
        queues between two rounds never shows in the sampled depth, but
        the rejections it forced did happen."""
        self._c_shed.inc()
        with self._lock:
            self._sheds_in_window += 1

    # -- control loop ------------------------------------------------------
    def _signals(self) -> Dict[str, Any]:
        """One host-only sample of the registry-backed signals the
        policy judges on (no device syncs — materialize=False)."""
        with self._lock:
            reps = [r for r in self._replicas
                    if not r.draining and r.alive]
            shed_delta, self._sheds_in_window = \
                self._sheds_in_window, 0
        queue = sum(r.queue_depth for r in reps)
        active = sum(r.active for r in reps)
        # windowed p99: diff every live replica's cumulative SLO
        # histogram (latency; inter-token for decode pools) against
        # its previous snapshot and merge the window counts (bucket
        # edges are shared — one registry name, one fixed grid, so
        # cumulative diffs add elementwise)
        merged_cum: Optional[List[float]] = None
        edges: Optional[List[float]] = None
        for r in reps:
            cur = r.signal_snapshot(self._hist_attr)
            prev, r.last_latency = r.last_latency, cur
            cum = _window_cum(prev, cur)
            if merged_cum is None:
                merged_cum = cum
                edges = [e for e, _ in cur.get("buckets", [])]
            elif len(cum) == len(merged_cum):
                merged_cum = [a + b for a, b in zip(merged_cum, cum)]
        p99 = (_quantile_from_cum(edges, merged_cum, 0.99)
               if merged_cum and edges else None)
        self._last_p99 = p99
        # queue-depth derivative: requests gained (+) or drained (-)
        # since the previous sample — the drain-relief policy's
        # evidence; first sample has no baseline, so delta 0
        prev, self._prev_queue = self._prev_queue, queue
        return {"replicas": len(reps), "queue_depth": queue,
                "active": active, "p99_s": p99,
                "shed_delta": shed_delta,
                "queue_delta": (0 if prev is None else queue - prev)}

    def control_round(self) -> Dict[str, Any]:
        """ONE policy decision over one signal sample (the background
        loop calls this every ``decision_interval_s``; tests call it
        directly).  Returns the sample it judged, with the decision
        annotated."""
        sig = self._signals()
        n = sig["replicas"]
        self._g_queue.set(sig["queue_depth"])
        self._g_p99.set(sig["p99_s"])
        per_rep = sig["queue_depth"] / max(n, 1)
        slo_violated = (self.slo_p99_s is not None
                        and sig["p99_s"] is not None
                        and sig["p99_s"] > self.slo_p99_s)
        # sheds since the last round are overload evidence too: a
        # burst that fills AND drains every queue between two rounds
        # never shows up in the sampled depth, but the rejections it
        # forced did happen.  Drain relief scales that evidence with
        # the depth DERIVATIVE: a queue already falling faster than
        # drain_relief_rate per replica per round is a burst on its
        # way out, and holding shed latched against it rejects
        # traffic the pool is about to absorb anyway — only a live
        # SLO violation overrides the relief
        draining = (self.drain_relief_rate > 0
                    and sig["queue_delta"] < 0
                    and (-sig["queue_delta"]) / max(n, 1)
                    >= self.drain_relief_rate)
        # predictive scale-up: the same derivative read the other way
        # — a steep enough RISE is overload evidence before the level
        # is (rising and draining are mutually exclusive by sign, so
        # the relief conjunct below never cancels it)
        rising = (self.predictive_scale_rate > 0
                  and sig["queue_delta"] > 0
                  and sig["queue_delta"] / max(n, 1)
                  >= self.predictive_scale_rate)
        overloaded = (((per_rep > self.scale_up_queue_depth
                        or sig["shed_delta"] > 0 or rising)
                       and not draining)
                      or slo_violated)
        idle = (per_rep <= self.scale_down_queue_depth
                and not slo_violated and sig["shed_delta"] == 0
                and not rising)
        self._up_streak = self._up_streak + 1 if overloaded else 0
        self._down_streak = self._down_streak + 1 if idle else 0
        now = time.monotonic()
        cooled = now - self._last_scale_t >= self.cooldown_s
        decision = "hold"
        if (overloaded and self._up_streak >= self.windows_up
                and n < self.max_replicas and cooled):
            decision = self._scale_up(sig)
        elif (idle and self._down_streak >= self.windows_down
                and n > self.min_replicas and cooled):
            decision = self._scale_down(sig)
        # shedding state: overload that capacity can't absorb (maxed
        # out or mid-cooldown) sheds at the door; any non-overloaded
        # round turns it back off
        want_shed = (overloaded and self._up_streak >= self.windows_up
                     and (n >= self.max_replicas or not cooled))
        if want_shed and not self._shedding:
            self._shedding = True
            _obs_events.record("shed_on", queue_depth=sig["queue_depth"],
                               p99_s=sig["p99_s"], replicas=n,
                               shed_recent=sig["shed_delta"])
        elif self._shedding and not overloaded:
            self._shedding = False
            _obs_events.record("shed_off",
                               queue_depth=sig["queue_depth"],
                               p99_s=sig["p99_s"], replicas=n)
        self._reap_draining()
        self._reap_dead()
        self._g_replicas.set(self.num_replicas)
        sig["decision"] = decision
        return sig

    def _scale_up(self, sig: Dict[str, Any]) -> str:
        try:
            self._spawn_replica(reason="overload")
        except Exception as e:  # noqa: BLE001 — injected or OOM: the
            # router survives on current capacity and retries after
            # cooldown (shedding covers the gap)
            self._last_scale_t = time.monotonic()
            _obs_events.record("scale_up_failed",
                               error=f"{type(e).__name__}: {e}")
            return "scale_up_failed"
        self._last_scale_t = time.monotonic()
        self._up_streak = 0
        self._c_up.inc()
        _obs_events.record("scale_up", replicas=self.num_replicas,
                           queue_depth=sig["queue_depth"],
                           p99_s=sig["p99_s"])
        return "scale_up"

    def _scale_down(self, sig: Dict[str, Any]) -> str:
        with self._lock:
            live = [r for r in self._replicas if not r.draining]
            victim = min(live, key=lambda r: r.load)
            victim.draining = True
        self._last_scale_t = time.monotonic()
        self._down_streak = 0
        self._c_down.inc()
        _obs_events.record("scale_down", victim=victim.name,
                           replicas=self.num_replicas,
                           queue_depth=sig["queue_depth"])
        return "scale_down"

    def _reap_draining(self):
        """Close drained victims once their in-flight work finishes
        (no new admissions reach a draining replica, so load only
        falls).  Registry children are reclaimed — replica churn is
        the router's normal operation, and unbounded dead-engine
        series would bloat every scrape."""
        with self._lock:
            done = [r for r in self._replicas
                    if r.draining and r.load == 0]
            self._replicas = [r for r in self._replicas
                              if r not in done]
        for r in done:
            try:
                r.server.close(unregister_metrics=True)
            except Exception:  # noqa: BLE001 — a wedged close must
                # not stall the control loop
                pass
            _obs_events.record("replica_retired", victim=r.name)

    def _reap_dead(self):
        """Remove replicas whose pump died (their futures failed with
        it) and spawn back up to ``min_replicas``: a prefill replica
        that died mid-prompt must not leave the pool short (the
        ``DisaggRouter`` re-admits its lost prompts there)."""
        with self._lock:
            dead = [r for r in self._replicas
                    if not r.draining and not r.alive]
            self._replicas = [r for r in self._replicas
                              if r not in dead]
        for r in dead:
            try:
                r.server.close(unregister_metrics=True)
            except Exception:  # noqa: BLE001
                pass
            _obs_events.record("replica_died", victim=r.name)
        while dead and self.num_replicas < self.min_replicas:
            try:
                self._spawn_replica(reason="replace_dead")
            except Exception as e:  # noqa: BLE001 — chaos-injected
                # spawn failure: stay short, retry next round
                _obs_events.record("respawn_failed",
                                   error=f"{type(e).__name__}: {e}")
                break

    def _control_loop(self):
        while not self._stop.wait(self.decision_interval_s):
            try:
                self.control_round()
            except Exception as e:  # noqa: BLE001 — one bad round
                # (mid-close races included) must not kill the loop
                _obs_events.record(
                    "control_round_failed",
                    error=f"{type(e).__name__}: {e}")

    # -- profile round-trip ------------------------------------------------
    def to_config(self) -> Dict[str, Any]:
        """This router's policy knobs as a plain dict; round-trips
        through :meth:`from_config`."""
        return {k: getattr(self, k) for k in self.CONFIG_KNOBS}

    @classmethod
    def from_config(cls, config: Dict[str, Any],
                    replica_factory: Callable[[], Any],
                    **kwargs) -> "ServingRouter":
        """Build a router from an exported profile.  An unknown key
        raises (a misspelt SLO must fail the deployment, not ship a
        router that never scales)."""
        unknown = sorted(set(config) - set(cls.CONFIG_KNOBS))
        if unknown:
            raise ValueError(
                f"unknown router knob(s) {unknown} refused; known "
                f"knobs: {sorted(cls.CONFIG_KNOBS)}")
        merged = dict(config)
        merged.update(kwargs)
        return cls(replica_factory, **merged)

    # -- lifecycle ---------------------------------------------------------
    @property
    def metrics_port(self) -> Optional[int]:
        return (None if self._metrics_server is None
                else self._metrics_server.port)

    def close(self):
        """Stop the control loop and close every replica (their
        pending futures fail per ``LLMServer.close``)."""
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._lock:
            reps, self._replicas = list(self._replicas), []
        for r in reps:
            try:
                r.server.close(unregister_metrics=True)
            except Exception:
                pass
        self._g_replicas.set(0)
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None

    def __enter__(self) -> "ServingRouter":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
