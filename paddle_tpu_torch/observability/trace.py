"""Span recorder: one host-side timeline for the process (counterpart
of ``paddle_tpu/observability/trace.py``).

The serving engines open spans around prefill, the decode dispatch,
the poll and a migration's export and import; a finished request adds
its lifecycle spans retroactively (:func:`add_span`).  All of them land
in one process-wide ring.

- **About nothing when disabled.**  :func:`span` returns a shared no-op
  object without allocating; the disabled path is one global check.
  Arm with ``PADDLE_TORCH_TRACE=1`` (read when
  ``paddle_tpu_torch.observability`` is imported) or :func:`enable`.
- **Host only.**  The recorder reads ``time.monotonic_ns`` and appends
  to a deque; it never touches a device value.  A span times the
  host's enqueue of the work inside it, not the device's execution.
- **Bounded.**  ``deque(maxlen=capacity)``, default 65536 events
  (``PADDLE_TORCH_TRACE_CAPACITY``).

The clock is ``time.monotonic`` (the serving ``RequestStats``
milestones use it too).  :func:`to_chrome_trace` /
:func:`dump_chrome_trace` give Chrome/Perfetto ``trace_event`` JSON;
:func:`summary` gives count/total/avg/max ms per span name.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["enable", "disable", "enabled", "span", "instant", "counter",
           "add_span", "set_track_name", "events", "clear",
           "to_chrome_trace", "dump_chrome_trace", "summary"]

_DEFAULT_CAPACITY = 1 << 16

# plain globals, so the disabled path is one LOAD_GLOBAL and a test
_enabled: bool = False
_ring: deque = deque(maxlen=_DEFAULT_CAPACITY)
_epoch_ns: int = time.monotonic_ns()
_epoch_unix_ns: int = time.time_ns()
# display names of synthetic tracks (the engine's per-slot lanes)
_track_names: Dict[int, str] = {}
_lock = threading.Lock()

# record shapes:
# ("X", name, tid, t0_ns, dur_ns, args)     complete span
# ("i", name, tid, t_ns, None, args)        instant event
# ("C", name, tid, t_ns, value, None)       counter sample


class _Span:
    """A live span, recorded at ``__exit__`` (only while enabled)."""

    __slots__ = ("_name", "_args", "_t0")

    def __init__(self, name: str, args):
        self._name = name
        self._args = args
        self._t0 = time.monotonic_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _ring.append(("X", self._name, threading.get_ident(), self._t0,
                      time.monotonic_ns() - self._t0, self._args))
        return False


class _NullSpan:
    """The shared disabled-mode span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, args: Optional[Dict[str, Any]] = None):
    """Context manager recording one complete span; a shared no-op
    while disabled.  Build ``args`` only when :func:`enabled`."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, args)


def instant(name: str, args: Optional[Dict[str, Any]] = None):
    """Zero-duration marker (Chrome ``i`` event)."""
    if not _enabled:
        return
    _ring.append(("i", name, threading.get_ident(), time.monotonic_ns(),
                  None, args))


def counter(name: str, value: float):
    """Timeline counter sample (Chrome ``C`` event)."""
    if not _enabled:
        return
    _ring.append(("C", name, threading.get_ident(), time.monotonic_ns(),
                  float(value), None))


def add_span(name: str, t0_s: float, t1_s: float,
             tid: Optional[int] = None,
             args: Optional[Dict[str, Any]] = None):
    """Record a span after the fact from ``time.monotonic()`` seconds
    (a finished request's queued/prefill/decode milestones), on track
    ``tid`` (default: the calling thread)."""
    if not _enabled or t1_s < t0_s:
        return
    _ring.append(("X", name,
                  tid if tid is not None else threading.get_ident(),
                  int(t0_s * 1e9), int((t1_s - t0_s) * 1e9), args))


def set_track_name(tid: int, name: str):
    """Display name of a synthetic track (Perfetto thread_name)."""
    with _lock:
        _track_names[int(tid)] = str(name)


def enable(capacity: Optional[int] = None):
    """Arm the recorder (idempotent); ``capacity`` resizes the ring,
    dropping what it held."""
    global _enabled, _ring
    with _lock:
        if capacity is not None and capacity != _ring.maxlen:
            _ring = deque(maxlen=int(capacity))
        _enabled = True


def disable():
    """Stop recording; the ring is kept for export."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def clear():
    _ring.clear()
    with _lock:
        _track_names.clear()


def events() -> List[tuple]:
    """The raw ring, oldest first."""
    return list(_ring)


def to_chrome_trace() -> Dict[str, Any]:
    """Chrome/Perfetto ``trace_event`` JSON: microsecond timestamps
    from the recorder's epoch and ``M`` thread-name records."""
    pid = os.getpid()
    trace_events: List[Dict[str, Any]] = []
    tids = set()
    for kind, name, tid, t_ns, extra, args in list(_ring):
        tids.add(tid)
        ev: Dict[str, Any] = {"name": name, "pid": pid, "tid": tid,
                              "cat": "paddle_tpu_torch",
                              "ts": (t_ns - _epoch_ns) / 1e3}
        if kind == "X":
            ev["ph"] = "X"
            ev["dur"] = extra / 1e3
            if args:
                ev["args"] = args
        elif kind == "i":
            ev["ph"] = "i"
            ev["s"] = "t"
            if args:
                ev["args"] = args
        else:
            ev["ph"] = "C"
            ev["args"] = {"value": extra}
        trace_events.append(ev)
    names = {t.ident: t.name for t in threading.enumerate()}
    with _lock:
        names.update(_track_names)
    for tid in sorted(tids):
        trace_events.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": tid, "args": {
                                 "name": names.get(tid, f"thread-{tid}")}})
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "epochUnixNs": _epoch_unix_ns}


def dump_chrome_trace(path: str) -> str:
    """Write :func:`to_chrome_trace` to ``path``; returns it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_chrome_trace(), f)
    return path


def summary() -> Dict[str, Dict[str, float]]:
    """Per span name: count, total, avg and max milliseconds."""
    stats: Dict[str, Dict[str, float]] = {}
    for kind, name, _tid, _t0, dur_ns, _args in list(_ring):
        if kind != "X":
            continue
        s = stats.setdefault(name, {"count": 0, "total": 0.0, "max": 0.0})
        ms = dur_ns / 1e6
        s["count"] += 1
        s["total"] += ms
        s["max"] = max(s["max"], ms)
    for s in stats.values():
        s["avg"] = s["total"] / s["count"]
    return stats
