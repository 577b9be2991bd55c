"""Deterministic fault injection (counterpart of
``paddle_tpu/distributed/resilience/faults.py``).

A :class:`FaultPlan` is a list of rules, each bound to a named
injection *site*.  Sites are wired into the code as
``fault_point(site, **ctx)`` or ``should_drop(site, **ctx)`` calls;
with no plan installed they do nothing.  The port wires the serving
router's two (:data:`KNOWN_SITES`): ``replica.spawn`` before a replica
is built and ``router.shed`` before an admission is shed; and the
checkpoint manager's three: ``checkpoint.save`` before a step's files
are written, ``checkpoint.commit`` before its manifest and
``checkpoint.restore`` before a step is read.

Rules match by **call count** at the site (``at``/``count``: "calls
N..N+count-1") or by **context** (``match``: "fire when ctx['n'] ==
2"), so every chaos test reproduces exactly.  Actions:

``error``     raise :class:`InjectedFault`
``latency``   sleep ``latency_s``, then go on
``drop``      tell the caller to skip the operation (``should_drop``)
``crash``     ``os._exit(exit_code)``: no cleanup, as a SIGKILL

Plans come from code (:func:`install`) or from the environment
(``PADDLE_TORCH_FAULT_PLAN``: JSON, or ``@/path/to/plan.json``), read
the first time a site is consulted.  The rest of the JAX package's
``resilience/`` (retry, watchdog, failure detection, elastic ranks)
waits for the distributed launcher (ROADMAP.md queue A, item A11).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ...framework import env_knobs

FAULT_PLAN_ENV = "PADDLE_TORCH_FAULT_PLAN"

#: The injection sites wired into the port: every literal site of a
#: ``fault_point``/``should_drop`` call in ``paddle_tpu_torch/`` is one
#: of these (held by ``tests/test_torch_observability.py``).
KNOWN_SITES = frozenset({
    "router.shed",         # droppable: serving router sheds an admission
    "replica.spawn",       # serving router spawns a new replica
    "checkpoint.save",     # a checkpoint step's write
    "checkpoint.commit",   # its manifest, strictly after the data
    "checkpoint.restore",  # a checkpoint step's read
})


class InjectedFault(ConnectionError):
    """Raised by an ``error`` rule.  A ConnectionError, as a transport
    failure would be."""


@dataclass
class FaultRule:
    site: str
    action: str = "error"            # error | latency | drop | crash
    at: int = 1                      # 1-based call number the rule arms at
    count: int = 1                   # consecutive calls affected; -1 = forever
    match: Optional[Dict[str, Any]] = None   # ctx equality match instead
    latency_s: float = 0.1
    exit_code: int = 143
    message: str = ""
    # once-across-processes guard: a marker file touched when the rule
    # fires; a rule whose marker exists is disarmed (a relaunched
    # process that re-runs the matching call does not die again)
    once_marker: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultRule":
        known = {f for f in cls.__dataclass_fields__}  # noqa: C401
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"FaultRule: unknown keys {sorted(unknown)}")
        if "site" not in d:
            raise ValueError("FaultRule: 'site' is required")
        return cls(**d)

    def hits(self, n_call: int, ctx: Dict[str, Any]) -> bool:
        if self.match is not None:
            return all(ctx.get(k) == v for k, v in self.match.items())
        if n_call < self.at:
            return False
        return self.count < 0 or n_call < self.at + self.count


@dataclass
class FaultPlan:
    rules: List[FaultRule] = field(default_factory=list)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        if isinstance(data, dict):
            data = data.get("rules", [])
        return cls([FaultRule.from_dict(r) for r in data])

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None
                 ) -> Optional["FaultPlan"]:
        val = (env_knobs.get_raw(FAULT_PLAN_ENV, "", env=env)
               or "").strip()
        if not val:
            return None
        if val.startswith("@"):
            with open(val[1:]) as f:
                val = f.read()
        return cls.from_json(val)

    def to_json(self) -> str:
        return json.dumps([{k: v for k, v in r.__dict__.items()
                            if v is not None} for r in self.rules])


class FaultInjector:
    """Per-process registry: counts calls per site, fires matching
    rules.  Deterministic — same plan + same call sequence → same
    faults."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._counts: Dict[str, int] = {}
        self._fired: List[str] = []
        self._lock = threading.Lock()

    def _tick(self, site: str) -> int:
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            return n

    def call_count(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    @property
    def fired(self) -> List[str]:
        with self._lock:
            return list(self._fired)

    def _record(self, rule: FaultRule, n: int, ctx: Dict[str, Any]):
        with self._lock:
            self._fired.append(f"{rule.site}#{n}:{rule.action}")

    def fire(self, site: str, **ctx) -> bool:
        """Run the site's matching rules.  Returns True iff a ``drop``
        rule matched (callers of drop-capable sites must skip the
        operation); raises/sleeps/exits for the other actions."""
        n = self._tick(site)
        dropped = False
        for rule in self.plan.rules:
            if rule.site != site or not rule.hits(n, ctx):
                continue
            if rule.once_marker:
                if os.path.exists(rule.once_marker):
                    continue  # already fired in some incarnation
                with open(rule.once_marker, "w") as f:
                    f.write(f"{site}#{n}\n")
            self._record(rule, n, ctx)
            if rule.action == "latency":
                time.sleep(rule.latency_s)
            elif rule.action == "drop":
                dropped = True
            elif rule.action == "crash":
                sys.stderr.write(
                    f"[faults] injected crash at {site}#{n} ctx={ctx}\n")
                sys.stderr.flush()
                os._exit(rule.exit_code)
            elif rule.action == "error":
                raise InjectedFault(
                    rule.message or f"injected fault at {site}#{n}")
            else:
                raise ValueError(f"unknown fault action {rule.action!r}")
        return dropped


# -- process-global injector -------------------------------------------------
_injector: Optional[FaultInjector] = None
_env_checked = False


def install(plan: Optional[FaultPlan]) -> Optional[FaultInjector]:
    """Install (or, with None, clear) the process-global injector."""
    global _injector, _env_checked
    _env_checked = True
    _injector = FaultInjector(plan) if plan is not None else None
    return _injector


def clear():
    """Remove any installed plan AND re-arm env discovery (tests)."""
    global _injector, _env_checked
    _injector = None
    _env_checked = False


def install_from_env() -> Optional[FaultInjector]:
    plan = FaultPlan.from_env()
    return install(plan) if plan is not None else install(None)


def active_plan() -> Optional[FaultInjector]:
    """The installed injector, picking up PADDLE_TORCH_FAULT_PLAN the
    first time any site is consulted."""
    global _env_checked
    if not _env_checked:
        _env_checked = True
        plan = FaultPlan.from_env()
        if plan is not None:
            install(plan)
    return _injector


def fault_point(site: str, **ctx) -> None:
    """Injection point for error/latency/crash sites (no-op without a
    plan)."""
    inj = active_plan()
    if inj is not None:
        inj.fire(site, **ctx)


def should_drop(site: str, **ctx) -> bool:
    """Injection point for droppable operations (an admission shed)."""
    inj = active_plan()
    return inj.fire(site, **ctx) if inj is not None else False
