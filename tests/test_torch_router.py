"""The port's SLO router (``paddle_tpu_torch/inference/serving/
router.py``) case for case against ``tests/test_router.py``: least-
loaded routing and QueueFull failover, shedding (state transitions,
the droppable ``router.shed`` fault site), scale-up/down hysteresis and
cooldown with deterministic stub replicas, an injected
``replica.spawn`` failure, the windowed-p99 math against the JAX
functions on the same inputs (equal, no tolerance), real ``LLMServer``
replicas token for token against the JAX ``reference_decode``, and a
burst against real replicas that must spawn, shed and put every
decision on ``/events`` over 127.0.0.1.
"""

import itertools
import json
import math
import threading
import types
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest

import jax
import paddle_tpu as paddle
from paddle_tpu.inference.serving import decode_model as jdm
from paddle_tpu.inference.serving import router as jrouter
from paddle_tpu.models import GPTForCausalLM, gpt_tiny

from paddle_tpu_torch.distributed.resilience import FaultPlan, clear, install
from paddle_tpu_torch.inference.serving import (
    LLMServer, Overloaded, QueueFull, ServingRouter, params_from_numpy)
from paddle_tpu_torch.inference.serving.router import (_delta_quantile,
                                                       _quantile_from_cum,
                                                       _window_cum)
from paddle_tpu_torch.observability import events as obs_events
from paddle_tpu_torch.observability import metrics as obs_metrics
from torch_parity_helpers import torch_one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean():
    clear()
    obs_events._reset_for_tests()
    yield
    clear()
    obs_events._reset_for_tests()


# ---------------------------------------------------------------------------
# deterministic stub replicas: the exact surface the router reads
# ---------------------------------------------------------------------------
_stub_ids = itertools.count()


class _StubServer:
    """Mimics the LLMServer surface the router uses: ``submit``,
    ``close``, and the engine's host-only signals (queue depth,
    active count, the cumulative latency histogram child)."""

    def __init__(self):
        self._label = {"engine": f"stub{next(_stub_ids)}"}
        reg = obs_metrics.registry()
        h = reg.histogram("serving_latency_s", "request latency",
                          labels=self._label)
        self.engine = types.SimpleNamespace(
            scheduler=types.SimpleNamespace(queue_depth=0),
            active_count=0, _h_latency=h)
        self.queue_full = False
        self.submitted = []
        self.closed = False
        self.unregistered = False

    def set_load(self, queue=0, active=0):
        self.engine.scheduler.queue_depth = queue
        self.engine.active_count = active

    def observe_latency(self, *vals):
        for v in vals:
            self.engine._h_latency.observe(v)

    def submit(self, prompt_ids, max_tokens, stream_cb=None, **kw):
        if self.queue_full:
            raise QueueFull("stub queue full")
        self.submitted.append(list(prompt_ids))
        return Future()

    def close(self, unregister_metrics=False):
        self.closed = True
        if unregister_metrics:
            self.unregistered = True
            obs_metrics.registry().unregister("serving_latency_s",
                                              labels=self._label)


def _stub_router(n=1, factory_log=None, **kw):
    made = factory_log if factory_log is not None else []

    def factory():
        s = _StubServer()
        made.append(s)
        return s

    kw.setdefault("min_replicas", n)
    kw.setdefault("max_replicas", max(n, 2))
    kw.setdefault("decision_interval_s", 0)   # tests drive rounds
    kw.setdefault("cooldown_s", 0.0)
    return ServingRouter(factory, **kw), made


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def test_submit_routes_to_least_loaded_and_fails_over():
    router, made = _stub_router(n=2, max_replicas=2)
    try:
        a, b = made
        a.set_load(queue=3, active=2)
        b.set_load(queue=0, active=1)
        router.submit([1, 2], 4)
        assert b.submitted and not a.submitted
        # failover: the light replica refuses, the heavy one admits
        b.queue_full = True
        router.submit([3], 4)
        assert a.submitted
    finally:
        router.close()


def test_all_queues_full_sheds_with_counter():
    router, made = _stub_router(n=2, max_replicas=2)
    shed0 = router._c_shed.collect()
    try:
        for s in made:
            s.queue_full = True
        with pytest.raises(Overloaded):
            router.submit([1], 4)
        assert router._c_shed.collect() == shed0 + 1
        # Overloaded IS QueueFull: upstream backpressure handling
        # written against LLMServer covers the router unchanged
        with pytest.raises(QueueFull):
            router.submit([1], 4)
    finally:
        router.close()


def test_draining_replica_gets_no_admissions():
    router, made = _stub_router(n=2, max_replicas=2)
    try:
        victim = router._replicas[0]
        victim.draining = True
        router.submit([1], 4)
        assert not made[0].submitted and made[1].submitted
    finally:
        router.close()


def test_replica_count_validation():
    with pytest.raises(ValueError):
        _stub_router(n=0)
    with pytest.raises(ValueError):
        _stub_router(n=2, max_replicas=1)


# ---------------------------------------------------------------------------
# scaling policy (hysteresis, cooldown, chaos)
# ---------------------------------------------------------------------------
def test_scale_up_needs_consecutive_windows_then_cooldown():
    router, made = _stub_router(n=1, max_replicas=3, windows_up=3,
                                cooldown_s=60.0,
                                scale_up_queue_depth=4.0)
    ups0 = router._c_up.collect()
    try:
        made[0].set_load(queue=10)
        assert router.control_round()["decision"] == "hold"
        assert router.control_round()["decision"] == "hold"
        # third consecutive overloaded window spawns
        assert router.control_round()["decision"] == "scale_up"
        assert router.num_replicas == 2 and len(made) == 2
        assert router._c_up.collect() == ups0 + 1
        # still overloaded, but cooldown holds capacity; the overload
        # capacity can't absorb turns shedding ON instead
        made[1].set_load(queue=10)
        for _ in range(3):
            router.control_round()
        assert router.num_replicas == 2
        assert router.shedding
        kinds = [e["kind"] for e in obs_events.snapshot()]
        assert "scale_up" in kinds and "shed_on" in kinds
        # load drains: shedding turns back off, with the transition
        # on the ring
        for s in made:
            s.set_load(queue=0)
        router.control_round()
        assert not router.shedding
        assert obs_events.snapshot()[-1]["kind"] == "shed_off"
    finally:
        router.close()


def test_one_healthy_window_resets_the_up_streak():
    router, made = _stub_router(n=1, windows_up=2,
                                scale_up_queue_depth=4.0)
    try:
        made[0].set_load(queue=10)
        router.control_round()
        made[0].set_load(queue=0)      # healthy window in between
        router.control_round()
        made[0].set_load(queue=10)
        router.control_round()
        assert router.num_replicas == 1   # streak restarted at 1
    finally:
        router.close()


def test_injected_spawn_failure_survives_and_retries():
    """replica.spawn is chaos surface: an injected failure aborts ONE
    spawn (capacity unchanged, decision on the ring) and the next
    overloaded round retries."""
    router, made = _stub_router(n=1, max_replicas=2, windows_up=1,
                                scale_up_queue_depth=1.0)
    try:
        made[0].set_load(queue=10)
        # the injector counts from install time, so the scale-up
        # spawn is site call #1 here (init's spawn predates the plan)
        install(FaultPlan.from_json(
            '[{"site":"replica.spawn","action":"error","at":1,'
            '"count":1}]'))
        assert router.control_round()["decision"] == "scale_up_failed"
        assert router.num_replicas == 1
        clear()
        assert router.control_round()["decision"] == "scale_up"
        assert router.num_replicas == 2
        kinds = [e["kind"] for e in obs_events.snapshot()]
        assert "scale_up_failed" in kinds and "scale_up" in kinds
    finally:
        clear()
        router.close()


def test_scale_down_drains_then_retires_idle_replica():
    router, made = _stub_router(n=1, max_replicas=2,
                                windows_down=3,
                                scale_down_queue_depth=0.5)
    downs0 = router._c_down.collect()
    try:
        router._spawn_replica(reason="test")   # 2 live, floor is 1
        router.control_round()
        router.control_round()
        assert router.num_replicas == 2
        # third consecutive idle window retires one replica; with
        # zero in-flight load it is reaped (closed + metrics
        # reclaimed) in the same round
        assert router.control_round()["decision"] == "scale_down"
        assert router.num_replicas == 1
        assert router._c_down.collect() == downs0 + 1
        retired = [s for s in made if s.closed]
        assert len(retired) == 1 and retired[0].unregistered
        kinds = [e["kind"] for e in obs_events.snapshot()]
        assert "scale_down" in kinds and "replica_retired" in kinds
        # min_replicas floor: it never drains the last one
        for _ in range(10):
            router.control_round()
        assert router.num_replicas == 1
    finally:
        router.close()


def test_scale_down_waits_for_inflight_work():
    router, made = _stub_router(n=1, max_replicas=2, windows_down=1)
    try:
        router._spawn_replica(reason="test")
        made[0].set_load(queue=0, active=0)
        made[1].set_load(queue=0, active=2)   # busy
        assert router.control_round()["decision"] == "scale_down"
        # the idle one was picked and reaped immediately
        assert made[0].closed and not made[1].closed
        # a busy victim would have drained first: simulate by marking
        # the survivor draining with load, then finishing its work
        rep = router._replicas[0]
        rep.draining = True
        made[1].set_load(queue=0, active=1)
        router._reap_draining()
        assert not made[1].closed           # still in flight
        made[1].set_load(queue=0, active=0)
        router._reap_draining()
        assert made[1].closed
    finally:
        router.close()


# ---------------------------------------------------------------------------
# shedding: SLO policy + droppable chaos site
# ---------------------------------------------------------------------------
def test_shed_state_sheds_at_the_door_and_chaos_can_suppress_it():
    router, made = _stub_router(n=1, max_replicas=1)
    shed0 = router._c_shed.collect()
    try:
        router._shedding = True
        with pytest.raises(Overloaded):
            router.submit([1], 4)
        assert router._c_shed.collect() == shed0 + 1
        assert not made[0].submitted
        # a drop rule on router.shed suppresses the relief — the
        # request is admitted as if the policy were off (the chaos
        # model for "test the cliff")
        install(FaultPlan.from_json(
            '[{"site":"router.shed","action":"drop","at":1,'
            '"count":-1}]'))
        fut = router.submit([1], 4)
        assert fut is not None and made[0].submitted
        assert router._c_shed.collect() == shed0 + 1   # no shed tick
    finally:
        clear()
        router.close()


def test_queue_full_burst_between_rounds_counts_as_overload():
    """A burst that fills AND drains the queues
    between two decision rounds is invisible to the sampled queue
    depth — the rejections it forced are the overload evidence."""
    router, made = _stub_router(n=1, max_replicas=2, windows_up=2)
    try:
        made[0].queue_full = True
        for _ in range(3):
            with pytest.raises(Overloaded):
                router.submit([1], 4)
        made[0].queue_full = False     # burst over: depth samples 0
        sig = router.control_round()
        assert sig["shed_delta"] == 3
        assert sig["decision"] == "hold"       # hysteresis: streak 1
        made[0].queue_full = True
        with pytest.raises(Overloaded):
            router.submit([1], 4)
        made[0].queue_full = False
        assert router.control_round()["decision"] == "scale_up"
        # POLICY sheds are the state working, not fresh evidence —
        # they must not latch shedding on while capacity is healthy
        router._shedding = True
        with pytest.raises(Overloaded):
            router.submit([1], 4)
        router.control_round()
        assert not router.shedding
    finally:
        router.close()


def test_slo_violation_counts_as_overload():
    """p99 above the knob arms scale-up even with shallow queues —
    the SLO half of the overload signal."""
    router, made = _stub_router(n=1, max_replicas=2, windows_up=1,
                                slo_p99_s=0.5,
                                scale_up_queue_depth=1e9)
    try:
        made[0].observe_latency(*([2.0] * 10))   # all above SLO
        assert router.control_round()["decision"] == "scale_up"
        assert router.num_replicas == 2
    finally:
        router.close()


def test_drain_rate_relief_discounts_depth_and_shed_evidence():
    """With ``drain_relief_rate`` armed, a
    deep queue whose depth is FALLING faster than the rate (per
    replica, per round) is a burst already draining — its depth and
    shed-count evidence must not advance the scale-up streak or latch
    shedding.  A stalled or growing queue counts again immediately,
    and an SLO violation is never discounted (latency debt is real
    even while the queue shortens)."""
    router, made = _stub_router(n=1, max_replicas=3, windows_up=2,
                                scale_up_queue_depth=4.0,
                                drain_relief_rate=2.0)
    try:
        made[0].set_load(queue=20)     # static deep queue: overload
        sig = router.control_round()
        assert sig["queue_delta"] == 0 and sig["decision"] == "hold"
        for q in (14, 10, 7):          # draining ≥ 2 req/round
            made[0].set_load(queue=q)
            sig = router.control_round()
            assert sig["queue_delta"] < 0
            assert sig["decision"] == "hold"
        assert router.num_replicas == 1   # streak never reached 2
        # the drain stalls: depth evidence counts again, streak
        # rebuilds from zero and the second window scales up
        router.control_round()
        assert router.control_round()["decision"] == "scale_up"
        assert router.num_replicas == 2
    finally:
        router.close()


def test_drain_rate_relief_never_discounts_slo_and_defaults_off():
    router, made = _stub_router(n=1, max_replicas=1, windows_up=1,
                                slo_p99_s=0.5,
                                scale_up_queue_depth=4.0,
                                drain_relief_rate=2.0)
    try:
        # draining hard, but p99 is blown: shedding must still latch
        # (capacity is maxed, so shed is the only lever left)
        made[0].set_load(queue=20)
        router.control_round()
        made[0].set_load(queue=10)
        made[0].observe_latency(*([2.0] * 10))
        router.control_round()
        assert router.shedding
    finally:
        router.close()
    # a draining-shaped load with the knob at its 0.0 default is
    # plain overload — the relief is strictly opt-in
    router, made = _stub_router(n=1, max_replicas=1, windows_up=1,
                                scale_up_queue_depth=4.0)
    try:
        made[0].set_load(queue=20)
        router.control_round()
        made[0].set_load(queue=10)     # delta -10: no relief knob
        router.control_round()
        assert router.shedding
    finally:
        router.close()
    # the knob rides the config surface like every other policy knob
    router, _ = _stub_router(n=1, drain_relief_rate=3.5)
    cfg = router.to_config()
    router.close()
    assert cfg["drain_relief_rate"] == 3.5
    r2 = ServingRouter.from_config(cfg, lambda: _StubServer(),
                                   decision_interval_s=0)
    assert r2.drain_relief_rate == 3.5
    r2.close()


def test_predictive_scale_up_arms_on_queue_rise_before_the_level():
    """With ``predictive_scale_rate`` armed, a
    queue RISING faster than the rate (per replica, per round) is
    overload evidence while the sampled depth is still far below
    ``scale_up_queue_depth`` — capacity spins up on the ramp, not the
    cliff.  Hysteresis still applies: one steep sample never scales."""
    router, made = _stub_router(n=1, max_replicas=3, windows_up=2,
                                scale_up_queue_depth=1e9,
                                predictive_scale_rate=2.0)
    try:
        made[0].set_load(queue=3)      # first sample: no baseline
        sig = router.control_round()
        assert sig["queue_delta"] == 0 and sig["decision"] == "hold"
        made[0].set_load(queue=6)      # +3/round >= 2.0: streak 1
        sig = router.control_round()
        assert sig["queue_delta"] == 3 and sig["decision"] == "hold"
        made[0].set_load(queue=9)      # streak 2: spawn
        assert router.control_round()["decision"] == "scale_up"
        assert router.num_replicas == 2
        # a rising queue also blocks the idle half of the policy: the
        # shallow absolute depth must not retire the fresh replica
        made[0].set_load(queue=14)
        for _ in range(12):
            assert router.control_round()["decision"] != "scale_down"
            made[0].set_load(queue=made[0].engine.scheduler
                             .queue_depth + 5)
    finally:
        router.close()


def test_predictive_scale_up_defaults_off_and_rides_config():
    # the same ramp with the knob at its 0.0 default is invisible:
    # the level-only policy is bit-identical to before
    router, made = _stub_router(n=1, max_replicas=3, windows_up=2,
                                scale_up_queue_depth=1e9)
    try:
        for q in (3, 6, 9, 12):
            made[0].set_load(queue=q)
            assert router.control_round()["decision"] == "hold"
        assert router.num_replicas == 1
    finally:
        router.close()
    # the knob rides the config surface like every other policy knob
    router, _ = _stub_router(n=1, predictive_scale_rate=1.5)
    cfg = router.to_config()
    router.close()
    assert cfg["predictive_scale_rate"] == 1.5
    r2 = ServingRouter.from_config(cfg, lambda: _StubServer(),
                                   decision_interval_s=0)
    assert r2.predictive_scale_rate == 1.5
    r2.close()


# ---------------------------------------------------------------------------
# windowed p99: cumulative-histogram diff math
# ---------------------------------------------------------------------------
def test_delta_quantile_window_math():
    prev = {"buckets": [[0.1, 5], [1.0, 5], [math.inf, 5]]}
    cur = {"buckets": [[0.1, 5], [1.0, 15], [math.inf, 15]]}
    # the 10 new observations all landed in (0.1, 1.0]
    assert _window_cum(prev, cur) == [0, 10, 10]
    p99 = _delta_quantile(prev, cur, 0.99)
    assert 0.1 < p99 <= 1.0
    # p50 interpolates midway through the landing bucket
    assert abs(_delta_quantile(prev, cur, 0.5) - 0.55) < 1e-9
    # empty window: None, never 0.0 (absence of traffic has no p99)
    assert _delta_quantile(cur, cur, 0.99) is None
    # no prev snapshot = everything is in the window
    assert _delta_quantile(None, cur, 0.99) is not None
    # +Inf landings clamp to the top finite edge
    hi = {"buckets": [[0.1, 0], [1.0, 0], [math.inf, 7]]}
    assert _delta_quantile(None, hi, 0.99) == 1.0


def test_windowed_p99_resets_each_round():
    router, made = _stub_router(n=1)
    try:
        made[0].observe_latency(0.2, 0.2, 0.2)
        router.control_round()
        first = router.windowed_p99_s()
        assert first is not None and 0.1 < first <= 1.0
        # next round saw no completions: p99 goes absent, and so does
        # the exported gauge (None scrapes absent, not stale)
        router.control_round()
        assert router.windowed_p99_s() is None
        assert router._g_p99.collect(materialize=False) is None
    finally:
        router.close()


def test_window_math_equals_the_jax_functions():
    rng = np.random.RandomState(7)
    edges = [0.001, 0.01, 0.1, 1.0, math.inf]
    for _ in range(50):
        prev_counts = np.sort(rng.randint(0, 50, 5))
        cur_counts = prev_counts + np.sort(rng.randint(0, 30, 5))
        prev = {"buckets": [[e, int(c)] for e, c in zip(edges, prev_counts)]}
        cur = {"buckets": [[e, int(c)] for e, c in zip(edges, cur_counts)]}
        for p in (prev, None, cur, {}):
            assert _window_cum(p, cur) == jrouter._window_cum(p, cur)
            for q in (0.0, 0.5, 0.9, 0.99, 1.0):
                assert _delta_quantile(p, cur, q) == \
                    jrouter._delta_quantile(p, cur, q)
    cum = [0, 3, 3, 10, 12]
    for q in (0.1, 0.5, 0.99):
        assert _quantile_from_cum(edges, cum, q) == \
            jrouter._quantile_from_cum(edges, cum, q)
    assert _quantile_from_cum(edges, [0] * 5, 0.5) is None


# ---------------------------------------------------------------------------
# real servers: routing end to end, token for token against JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    paddle.seed(0)
    cfg = gpt_tiny(use_flash_attention=False)
    net = GPTForCausalLM(cfg)
    net.eval()
    jparams = jdm.extract_decode_params(net)
    tparams = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float32), jparams), device="cpu")
    scfg = jdm.ServingModelConfig.from_gpt_config(cfg)

    def oracle(prompt, n):
        toks, _ = jdm.reference_decode(jparams, scfg, prompt, n)
        return [int(t) for t in toks]
    return cfg, tparams, oracle


def _factory(cfg, tparams, made, gate=None, **kw):
    """Replica factory; with ``gate`` (a ``threading.Event``) each
    replica's pump waits for it before every engine step, so its queue
    fills deterministically."""
    base = dict(params=tparams, gpt_config=cfg, max_batch=2, block_size=8,
                num_blocks=64, device="cpu", auto_start=False)
    base.update(kw)

    def make():
        s = LLMServer(**base)
        if gate is not None:
            step = s.engine.step
            s.engine.step = lambda: gate.wait(60) and step()
        made.append(s)
        return s.start()
    return make


def test_router_over_real_llmservers_token_exact(tiny):
    cfg, tparams, oracle = tiny
    made = []
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).tolist()
               for n in (5, 9, 14, 3)]
    with ServingRouter(_factory(cfg, tparams, made), min_replicas=2,
                       max_replicas=2, decision_interval_s=0) as router:
        futs = [router.submit(p, 6) for p in prompts]
        got = [f.result(timeout=120).tokens for f in futs]
    for p, toks in zip(prompts, got):
        assert toks == oracle(p, 6)
    assert all(not s.running for s in made)
    assert all(s.engine.stats()["completed"] >= 1 for s in made)
    assert router.num_replicas == 0


def test_router_burst_scales_sheds_and_serves_events(tiny):
    """A burst against one real replica with a short queue: the door
    sheds (Overloaded, counted), the next rounds see the sheds as
    overload, spawn the second replica and turn shedding on at
    max_replicas; every decision is on ``/events`` over 127.0.0.1 and on
    the registry, and every admitted request completes."""
    cfg, tparams, oracle = tiny
    made, gate = [], threading.Event()
    router = ServingRouter(
        _factory(cfg, tparams, made, gate=gate, max_queue=2),
        min_replicas=1, max_replicas=2, windows_up=1, cooldown_s=0.0,
        scale_up_queue_depth=1.0, decision_interval_s=0, metrics_port=0)
    reg = obs_metrics.registry()
    shed0, ups0 = router._c_shed.collect(), router._c_up.collect()
    prompt = [3, 1, 4, 1, 5]
    try:
        futs, sheds = [], 0
        for _ in range(6):
            try:
                futs.append(router.submit(prompt, 4))
            except Overloaded:
                sheds += 1
        assert len(futs) == 2 and sheds == 4
        assert router.control_round()["decision"] == "scale_up"
        assert router.num_replicas == 2
        for _ in range(6):
            try:
                futs.append(router.submit(prompt, 4))
            except Overloaded:
                sheds += 1
        sig = router.control_round()
        assert sig["shed_delta"] > 0 and router.shedding
        with pytest.raises(Overloaded):
            router.submit(prompt, 4)
        payload = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{router.metrics_port}/events", timeout=30))
        kinds = [e["kind"] for e in payload["events"]]
        assert kinds == ["scale_up", "shed_on"]
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{router.metrics_port}/metrics",
            timeout=30).read().decode()
        assert f"router_scale_ups_total {int(ups0) + 1}\n" in text
        assert router._c_shed.collect() == shed0 + sheds + 1
        gate.set()
        for f in futs:
            assert f.result(timeout=120).tokens == oracle(prompt, 4)
        router.control_round()
        assert not router.shedding
        assert obs_events.snapshot()[-1]["kind"] == "shed_off"
        assert reg.gauge("serving_replicas").collect() == 2.0
    finally:
        gate.set()
        router.close()
    assert router.num_replicas == 0
    assert reg.gauge("serving_replicas").collect() == 0.0
