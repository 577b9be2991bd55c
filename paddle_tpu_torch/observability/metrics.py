"""Process-wide metrics registry (counterpart of
``paddle_tpu/observability/metrics.py``, of which the port keeps its
own copy).

Counters, gauges and fixed-bucket histograms with Prometheus-shaped
semantics, shared by the serving engines and routers, so one
``paddle_tpu_torch.observability.scrape()`` answers for the process.

The hot-path contract:

- **Instruments accept device values.**  A value that is not a plain
  ``int``/``float``/``bool``/numpy number (a 0-d ``torch.Tensor`` on
  the card, a :class:`~paddle_tpu_torch.framework.lazy.LazyScalar`) is
  held as it is and read to the host only by ``collect(materialize=
  True)``, at scrape time, never when it is observed.  Pending values
  are bounded (``_MAX_PENDING``): past the bound the oldest are dropped
  and counted, so a registry nobody scrapes does not grow.
- **Gauges can be function-backed** (:meth:`Gauge.set_function`): the
  callable runs at scrape time only, so "queue depth" and "KV-pool
  fragmentation" cost the serving loop nothing.
- **Locks are per instrument and held for an add or a bisect**: no
  instrument waits for the device.

Naming: ``<subsystem>_<quantity>_<unit>[_total]``.  Labels are a frozen
set fixed at creation (one ``engine="e0"`` child per serving engine);
the registry keys children by (name, labels).
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "DEFAULT_TIME_BUCKETS"]

# Default latency bucket edges (seconds): 100us .. ~2min, roughly
# log-spaced.  Chosen once so every duration histogram in the process
# aggregates and compares on the same grid.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

_MAX_PENDING = 4096


def _is_host_number(v) -> bool:
    # np.number covers np.float32/np.int64 etc. — host-cheap scalars
    # that are NOT int/float subclasses and must not be deferred as
    # "lazy device values" (deferred values can be evicted unscraped)
    return isinstance(v, (int, float, bool, np.number))


def _escape_label_value(v: str) -> str:
    """Prometheus exposition escaping for label VALUES — an unescaped
    quote/backslash/newline in one label corrupts the whole payload."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _materialize(v) -> float:
    """Deferred-value finisher, called at scrape time only: a device
    value (a 0-d ``torch.Tensor``, a ``LazyScalar``, anything
    float()-able) pays its device→host copy HERE, never on the
    instrumented loop."""
    return float(v)


class _Instrument:
    __slots__ = ("name", "help", "labels", "_lock", "_pending",
                 "pending_dropped", "materialize_errors")

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = threading.Lock()
        # deferred (lazy device) values, materialized at scrape
        self._pending: List[Any] = []
        self.pending_dropped = 0
        self.materialize_errors = 0

    def _push_pending(self, v):
        with self._lock:
            if len(self._pending) >= _MAX_PENDING:
                self._pending.pop(0)
                self.pending_dropped += 1
            self._pending.append(v)

    def _drain_pending(self) -> List[Any]:
        with self._lock:
            out, self._pending = self._pending, []
        return out

    def _materialize_safe(self, v) -> Optional[float]:
        """Guarded ``float(v)``: a lazy value whose device work FAILED
        (an asynchronous CUDA error surfacing at the copy) must not take
        down every scrape, nor discard the other drained observations
        — count it and move on."""
        try:
            return _materialize(v)
        except Exception:
            self.materialize_errors += 1
            return None

    def labels_suffix(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                         for k, v in self.labels)
        return "{" + inner + "}"

    def key(self) -> str:
        return self.name + self.labels_suffix()


class Counter(_Instrument):
    """Monotonically increasing count.  ``inc`` with a host number is
    an add under a lock; a lazy device value is deferred to scrape."""

    __slots__ = ("_value",)

    kind = "counter"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._value = 0.0

    def inc(self, n=1):
        if _is_host_number(n):
            with self._lock:
                self._value += n
        else:
            self._push_pending(n)

    def collect(self, materialize: bool = True) -> float:
        if materialize:
            for v in self._drain_pending():
                m = self._materialize_safe(v)  # sync OUTSIDE the lock
                if m is None:
                    continue
                with self._lock:
                    self._value += m
        with self._lock:
            return self._value


class Gauge(_Instrument):
    """Last-write-wins sample.  ``set`` stores host numbers AND lazy
    device values as-is (the device read happens at scrape);
    ``set_function`` makes the gauge collect-time-computed — zero
    hot-path cost, always fresh."""

    __slots__ = ("_value", "_fn")

    kind = "gauge"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._value: Any = None
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            base = self._value if _is_host_number(self._value) else 0.0
            self._value = base + n

    def set_function(self, fn: Callable[[], float]):
        """Collect-time-computed gauge.  ``fn`` must read HOST state
        only (it is skipped under ``materialize=False``, the mode a
        control loop reads in); return None to scrape as absent."""
        with self._lock:
            self._fn = fn

    def collect(self, materialize: bool = True) -> Optional[float]:
        with self._lock:
            fn, v = self._fn, self._value
        if fn is not None:
            if not materialize:
                # host-only mode runs no callable: it is the mode a
                # control loop reads in, beside a running pump
                return None
            try:
                val = fn()
                # weakref-backed fns return None once their owner is
                # dead: absent, not a NaN-forever series
                return None if val is None else float(val)
            except Exception:
                return None
        if v is None:
            return None
        if _is_host_number(v):
            return float(v)
        if not materialize:
            return None
        m = self._materialize_safe(v)
        if m is None:                 # failed lazy: scrape as absent
            return None
        with self._lock:
            # cache the materialized value only if no newer write won
            if self._value is v:
                self._value = m
        return m


class Histogram(_Instrument):
    """Fixed-bucket-edge histogram: ``observe`` of a host number is a
    bisect + two adds under a lock; a lazy device value defers its
    bucketing to scrape.  Export is Prometheus-shaped (cumulative
    ``le`` buckets incl. ``+Inf``, plus sum and count);
    :meth:`quantile` interpolates within the landing bucket, which is
    how the serving stats adapter keeps its p50/p99 shape."""

    __slots__ = ("edges", "_counts", "_sum", "_count")

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[Tuple[str, str], ...] = (),
                 edges: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help, labels)
        es = tuple(float(e) for e in edges)
        if not es or any(b <= a for a, b in zip(es, es[1:])):
            raise ValueError("histogram edges must be strictly "
                             f"increasing and non-empty: {es}")
        self.edges = es
        self._counts = [0] * (len(es) + 1)      # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        if not _is_host_number(v):
            self._push_pending(v)
            return
        i = bisect.bisect_left(self.edges, v)   # v <= edges[i] lands i
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def _flush(self):
        for v in self._drain_pending():
            m = self._materialize_safe(v)
            if m is not None:
                self.observe(m)

    def collect(self, materialize: bool = True) -> Dict[str, Any]:
        if materialize:
            self._flush()
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._count
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return {"buckets": [[e, c] for e, c in zip(
                    (*self.edges, math.inf), cum)],
                "sum": total, "count": n}

    def quantile(self, q: float, materialize: bool = True) -> float:
        """Estimated q-quantile (q in [0,1]) with linear interpolation
        inside the landing bucket; 0.0 when empty.  Monotone in q by
        construction.  The +Inf bucket clamps to the top edge."""
        if materialize:
            self._flush()
        with self._lock:
            counts = list(self._counts)
            n = self._count
        if n == 0:
            return 0.0
        rank = q * n
        acc = 0
        for i, c in enumerate(counts):
            if acc + c >= rank and c > 0:
                lo = 0.0 if i == 0 else self.edges[i - 1]
                hi = (self.edges[i] if i < len(self.edges)
                      else self.edges[-1])
                frac = (rank - acc) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            acc += c
        return float(self.edges[-1])


class MetricsRegistry:
    """Get-or-create instrument registry keyed by (name, labels).
    Same name + labels returns the SAME instrument (so module-level
    and per-engine call sites converge); same name with a different
    kind raises — a name means one thing process-wide."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, Tuple], _Instrument] = {}

    @staticmethod
    def _label_key(labels: Optional[Dict[str, str]]):
        if not labels:
            return ()
        return tuple(sorted((str(k), str(v))
                            for k, v in labels.items()))

    def _get_or_create(self, cls, name, help, labels, edges=None):
        lk = self._label_key(labels)
        with self._lock:
            inst = self._instruments.get((name, lk))
            if inst is None:
                kw = {} if edges is None else {"edges": edges}
                inst = cls(name, help=help, labels=lk, **kw)
                self._instruments[(name, lk)] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{inst.kind}, requested {cls.kind}")
            elif (edges is not None
                  and tuple(float(e) for e in edges) != inst.edges):
                # silently returning the first-created edges would
                # bucket the second site's observations nonsensically
                raise ValueError(
                    f"histogram {name!r} already registered with "
                    f"edges {inst.edges}, requested "
                    f"{tuple(float(e) for e in edges)}")
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        """``edges=None`` means "default buckets if creating, accept
        whatever an existing instrument has"; EXPLICIT edges that
        conflict with an existing instrument raise ValueError."""
        return self._get_or_create(Histogram, name, help, labels,
                                   edges=edges)

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    def unregister(self, name: str,
                   labels: Optional[Dict[str, str]] = None) -> bool:
        """Drop one instrument (e.g. a retired engine's labeled
        child).  Cached references keep recording into the orphan;
        it just stops appearing in scrapes.  Returns True if found."""
        with self._lock:
            return self._instruments.pop(
                (name, self._label_key(labels)), None) is not None

    def reset(self):
        """Drop every instrument (tests; a fresh registry for a fresh
        scenario).  Call sites that cached instrument objects keep
        recording into orphans — re-create after reset."""
        with self._lock:
            self._instruments.clear()


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """THE process-wide registry every subsystem records into."""
    return _default
