"""The port's observability core and fault sites against the JAX
package's (``paddle_tpu/observability``, ``distributed/resilience/
faults.py``).

The same sequence of observations goes into a fresh registry of each
package: the ``snapshot`` dicts and the Prometheus texts must be EQUAL
(host arithmetic on the same floats, no tolerance).  A device value
(a 0-d tensor, a ``LazyScalar``, a counting stand-in) stays unread
until ``collect(materialize=True)``.  The same ``FaultPlan`` must fire
the same sequence of rules in both packages.  The decision ring, the
span recorder, ``unregister`` and the HTTP endpoint are held on their
own, against the JAX module's behaviour where it has one.
"""

import json
import math
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.resilience import faults as jfaults
from paddle_tpu.observability import events as jevents
from paddle_tpu.observability import export as jexport
from paddle_tpu.observability import metrics as jmetrics

from paddle_tpu_torch import observability
from paddle_tpu_torch.distributed.resilience import faults as tfaults
from paddle_tpu_torch.framework.lazy import LazyScalar, LazyStack
from paddle_tpu_torch.observability import events as tevents
from paddle_tpu_torch.observability import export as texport
from paddle_tpu_torch.observability import http as thttp
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import trace as ttrace
from torch_parity_helpers import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    tfaults.clear()
    jfaults.clear()
    tevents._reset_for_tests()
    jevents._reset_for_tests()
    yield
    tfaults.clear()
    jfaults.clear()
    tevents._reset_for_tests()
    jevents._reset_for_tests()
    ttrace.disable()
    ttrace.clear()


def _observe(reg, rng):
    """One fixed sequence of observations into ``reg`` (either
    package's registry)."""
    c = reg.counter("serving_tokens_total", "generated tokens",
                    labels={"engine": "e0", "phase": "both"})
    c.inc()
    c.inc(41)
    c.inc(np.int64(7))
    c.inc(2.5)
    reg.counter("router_shed_total", "sheds").inc(3)
    g = reg.gauge("serving_queue_depth", "waiting",
                  labels={"engine": 'e"1\\', "phase": "decode"})
    g.set(5)
    g.inc(2)
    reg.gauge("router_p99_s", "absent").set(None)
    reg.gauge("serving_active", "fn").set_function(lambda: 3)
    reg.gauge("serving_dead", "dead engine").set_function(lambda: None)
    h = reg.histogram("serving_latency_s", "latency",
                      labels={"engine": "e0", "phase": "both"})
    for v in rng.exponential(0.05, 200):
        h.observe(float(v))
    h.observe(1e9)                                  # the +Inf bucket
    h2 = reg.histogram("serving_spec_tokens_per_dispatch", "tpd",
                       edges=(0.5, 1.0, 2.0, 4.0))
    for v in (0.25, 1.0, 1.5, 3.0, 5.0, 4.0):
        h2.observe(v)
    return h


def test_snapshot_and_prometheus_text_equal_the_jax_registrys():
    jreg, treg = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    jh = _observe(jreg, np.random.RandomState(0))
    th = _observe(treg, np.random.RandomState(0))
    for mat in (True, False):
        assert texport.snapshot(treg, materialize=mat) == \
            jexport.snapshot(jreg, materialize=mat)
        assert texport.to_prometheus_text(treg, materialize=mat) == \
            jexport.to_prometheus_text(jreg, materialize=mat)
    assert texport.to_prometheus_text(treg, extra_labels={"rank": "1"}) \
        == jexport.to_prometheus_text(jreg, extra_labels={"rank": "1"})
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    snap = texport.snapshot(treg)
    assert texport.json_safe(snap) == jexport.json_safe(snap)
    assert json.loads(json.dumps(texport.json_safe(
        {"a": [math.inf, -math.inf, math.nan, 1.5]}))) == \
        {"a": ["+Inf", "-Inf", "NaN", 1.5]}


def test_device_values_stay_unread_until_materialize():
    class Counting:
        reads = 0

        def __float__(self):
            Counting.reads += 1
            return 2.0

    reg = tmetrics.MetricsRegistry()
    c = reg.counter("x_total")
    h = reg.histogram("x_s")
    g = reg.gauge("x_g")
    c.inc(1)
    c.inc(Counting())
    c.inc(torch.tensor(3.0))                        # a 0-d tensor
    stack = LazyStack(torch.tensor([0.25, 4.0]))
    h.observe(LazyScalar(stack, post=lambda a: a[0]))
    h.observe(Counting())
    g.set(LazyScalar(stack, post=lambda a: a[1]))
    assert c.collect(materialize=False) == 1.0
    assert h.collect(materialize=False)["count"] == 0
    assert g.collect(materialize=False) is None
    assert stack._host is None and Counting.reads == 0
    assert texport.snapshot(reg, materialize=False)["x_total"]["value"] == 1
    assert Counting.reads == 0 and stack._host is None
    assert c.collect() == 6.0 and Counting.reads == 1
    d = h.collect()
    assert d["count"] == 2 and d["sum"] == 2.25 and Counting.reads == 2
    assert g.collect() == 4.0
    # a value whose read fails is counted and skipped, not fatal
    bad = reg.counter("bad_total")

    class Broken:
        def __float__(self):
            raise RuntimeError("device fault")
    bad.inc(Broken())
    bad.inc(1)
    assert bad.collect() == 1.0 and bad.materialize_errors == 1


def test_pending_values_are_bounded_and_function_gauges_skip_host_mode():
    reg = tmetrics.MetricsRegistry()
    c = reg.counter("many_total")
    for _ in range(tmetrics._MAX_PENDING + 5):
        c.inc(torch.tensor(1.0))
    assert c.pending_dropped == 5
    assert c.collect() == tmetrics._MAX_PENDING
    calls = []
    g = reg.gauge("fn_g")
    g.set_function(lambda: calls.append(1) or 7)
    assert g.collect(materialize=False) is None and not calls
    assert g.collect() == 7.0 and calls == [1]


def test_registry_identity_conflicts_and_unregister_match_jax():
    for mod in (tmetrics, jmetrics):
        reg = mod.MetricsRegistry()
        a = reg.counter("n_total", labels={"engine": "e0"})
        assert reg.counter("n_total", labels={"engine": "e0"}) is a
        with pytest.raises(TypeError):
            reg.gauge("n_total", labels={"engine": "e0"})
        reg.histogram("h_s", edges=(1.0, 2.0))
        with pytest.raises(ValueError):
            reg.histogram("h_s", edges=(1.0, 3.0))
        assert reg.histogram("h_s").edges == (1.0, 2.0)
        with pytest.raises(ValueError):
            reg.histogram("bad_s", edges=(2.0, 1.0))
        assert reg.unregister("n_total", labels={"engine": "e0"})
        assert not reg.unregister("n_total", labels={"engine": "e0"})
        a.inc()                          # an orphan still records
        assert [i.key() for i in reg.instruments()] == ["h_s"]


def test_engine_children_and_unregister_metrics():
    from paddle_tpu_torch.inference.serving import (DecodeEngine,
                                                    params_from_numpy)
    from paddle_tpu_torch.models import gpt_tiny, init_decode_weights_numpy
    cfg = gpt_tiny()
    params = params_from_numpy(init_decode_weights_numpy(cfg, 0),
                               device="cpu")
    eng = DecodeEngine(params=params, gpt_config=cfg, max_batch=2,
                       block_size=8, num_blocks=32, device="cpu",
                       role="decode")
    want = f'{{engine="{eng._obs_id}",phase="decode"}}'
    keys = [k for k in observability.scrape() if k.endswith(want)]
    assert len(keys) == len(eng._obs_metric_names) == 23
    snap = observability.scrape(materialize=False)
    assert snap["serving_active" + want]["value"] is None   # fn gauge
    assert observability.scrape()["serving_active" + want]["value"] == 0
    assert observability.scrape()["serving_prefix_blocks" + want][
        "value"] is None                                     # cache off
    text = observability.scrape_prometheus()
    assert f"serving_dispatches_total{want} 0" in text
    eng.unregister_metrics()
    assert not [k for k in observability.scrape() if k.endswith(want)]


def test_event_ring_matches_jax_semantics():
    for mod in (tevents, jevents):
        mod._reset_for_tests(capacity=3)
        for i in range(5):
            e = mod.record("scale_up", replicas=i, reason="test")
            assert e["kind"] == "scale_up" and isinstance(e["ts"], float)
        snap = mod.snapshot()
        assert [e["replicas"] for e in snap] == [2, 3, 4]
        snap[0]["replicas"] = 99                   # copies
        assert mod.snapshot()[0]["replicas"] == 2
        assert mod.capacity() == 3
        mod._reset_for_tests()
        assert mod.snapshot() == [] and mod.capacity() == 256


def test_event_capacity_knob_in_a_fresh_process():
    code = ("from paddle_tpu_torch.observability import events, trace\n"
            "print(events.capacity(), trace.enabled(), "
            "trace._ring.maxlen)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, PADDLE_TORCH_EVENTS_CAPACITY="7",
               PADDLE_TORCH_TRACE="1", PADDLE_TORCH_TRACE_CAPACITY="99")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["7", "True", "99"]


FAULT_PLAN = json.dumps([
    {"site": "replica.spawn", "action": "error", "at": 2, "count": 2},
    {"site": "router.shed", "action": "drop", "at": 1, "count": 3},
    {"site": "router.shed", "action": "latency", "latency_s": 0.0,
     "match": {"depth": 4}},
    {"site": "replica.spawn", "action": "drop", "match": {"n": 5}},
])


def _drive_faults(mod):
    """One fixed sequence of site calls; returns what each did."""
    mod.install(mod.FaultPlan.from_json(FAULT_PLAN))
    out = []
    for i in range(6):
        try:
            mod.fault_point("replica.spawn", n=i)
            out.append(("spawn", i, "ok"))
        except mod.InjectedFault as e:
            out.append(("spawn", i, "error", str(e)))
        out.append(("shed", i, mod.should_drop("router.shed", depth=i)))
    inj = mod.active_plan()
    return out, inj.fired, inj.call_count("router.shed")


def test_same_fault_plan_fires_the_same_sequence_in_both_packages():
    got, want = _drive_faults(tfaults), _drive_faults(jfaults)
    assert got == want
    assert got[1] == [
        "router.shed#1:drop", "replica.spawn#2:error", "router.shed#2:drop",
        "replica.spawn#3:error", "router.shed#3:drop",
        "router.shed#5:latency", "replica.spawn#6:drop"]
    plan = tfaults.FaultPlan.from_json(FAULT_PLAN)
    assert plan.to_json() == jfaults.FaultPlan.from_json(FAULT_PLAN).to_json()
    with pytest.raises(ValueError):
        tfaults.FaultRule.from_dict({"site": "x", "bogus": 1})
    with pytest.raises(ValueError):
        tfaults.FaultRule.from_dict({"action": "drop"})


def test_fault_plan_from_the_ports_environment_knob(tmp_path):
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(FAULT_PLAN)
    for val in (FAULT_PLAN, f"@{plan_file}"):
        plan = tfaults.FaultPlan.from_env({"PADDLE_TORCH_FAULT_PLAN": val})
        assert [r.site for r in plan.rules] == [
            "replica.spawn", "router.shed", "router.shed", "replica.spawn"]
    # the JAX package's variable is not the port's
    assert tfaults.FaultPlan.from_env({"PADDLE_FAULT_PLAN": FAULT_PLAN}) \
        is None


def test_every_fault_site_in_the_port_is_known():
    sites = set()
    pat = re.compile(r"(?:fault_point|should_drop)\(\s*\"([^\"]+)\"")
    for root, _, files in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f), encoding="utf-8") as fh:
                    sites |= set(pat.findall(fh.read()))
    assert sites == set(tfaults.KNOWN_SITES) == {
        "router.shed", "replica.spawn", "checkpoint.save",
        "checkpoint.commit", "checkpoint.restore"}
    assert tfaults.KNOWN_SITES <= jfaults.KNOWN_SITES


def test_span_recorder(tmp_path):
    assert not ttrace.enabled()
    assert ttrace.span("x") is ttrace.span("y")      # shared no-op
    with ttrace.span("off"):
        pass
    ttrace.instant("off")
    assert ttrace.events() == []
    ttrace.enable(capacity=8)
    with ttrace.span("serving.dispatch", args={"active": 2}):
        with ttrace.span("inner"):
            pass
    ttrace.instant("mark")
    ttrace.counter("queue", 3)
    ttrace.add_span("request", 1.0, 1.5, tid=77, args={"request_id": 1})
    ttrace.add_span("backwards", 2.0, 1.0)           # dropped
    ttrace.set_track_name(77, "serving-e0-slot0")
    kinds = [e[0] for e in ttrace.events()]
    assert kinds == ["X", "X", "i", "C", "X"]
    summ = ttrace.summary()
    assert summ["request"]["count"] == 1
    assert abs(summ["request"]["total"] - 500.0) < 1e-6
    doc = ttrace.to_chrome_trace()
    names = {e["name"]: e for e in doc["traceEvents"]}
    assert names["serving.dispatch"]["args"] == {"active": 2}
    assert any(e["ph"] == "M" and e["args"]["name"] == "serving-e0-slot0"
               for e in doc["traceEvents"])
    path = ttrace.dump_chrome_trace(str(tmp_path / "t" / "trace.json"))
    with open(path) as fh:
        assert json.load(fh)["traceEvents"]
    for _ in range(20):
        ttrace.instant("flood")
    assert len(ttrace.events()) == 8                 # bounded
    ttrace.disable()
    ttrace.instant("after")
    assert len(ttrace.events()) == 8
    out = texport.dump_json(str(tmp_path / "obs.json"),
                            tmetrics.MetricsRegistry())
    with open(out) as fh:
        assert set(json.load(fh)) == {"metrics", "trace_summary"}


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_http_endpoint_routes():
    reg = tmetrics.MetricsRegistry()
    reg.counter("serving_tokens_total", "tokens",
                labels={"engine": "e0", "phase": "both"}).inc(5)
    reg.histogram("serving_latency_s").observe(0.01)
    tevents.record("scale_up", replicas=2)
    assert thttp.active_server() is None
    with thttp.serve(0, registry=reg) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        status, ctype, body = _get(base + "/metrics")
        assert status == 200 and ctype == thttp.PROM_CONTENT_TYPE
        assert body.decode() == texport.to_prometheus_text(reg)
        status, _, body = _get(base + "/metrics.json")
        payload = json.loads(body)
        assert payload["metrics"]['serving_tokens_total{engine="e0",'
                                  'phase="both"}']["value"] == 5
        assert payload["metrics"]["serving_latency_s"]["buckets"][-1][0] \
            == "+Inf"
        status, _, body = _get(base + "/events")
        ev = json.loads(body)
        assert ev["capacity"] == 256
        assert [e["kind"] for e in ev["events"]] == ["scale_up"]
        assert json.loads(_get(base + "/trace")[2])["traceEvents"] == []
        assert json.loads(_get(base + "/healthz")[2])["status"] == "ok"
        assert _get(base + "/nope")[0] == 404
        srv.add_route("/boom", lambda: 1 / 0)
        status, _, body = _get(base + "/boom")
        assert status == 500 and b"ZeroDivisionError" in body
        assert _get(base + "/healthz")[0] == 200
    thttp._reset_for_tests()
