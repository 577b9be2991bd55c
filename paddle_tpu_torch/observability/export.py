"""Metric and trace export (counterpart of
``paddle_tpu/observability/export.py``).

- :func:`snapshot`: one dict over every registered instrument, keyed
  ``name{label="v"}``; ``paddle_tpu_torch.observability.scrape()``
  returns it.  ``materialize=True`` (the default) reads the deferred
  device values to the host HERE, at scrape time; ``False`` reads
  host state only.
- :func:`to_prometheus_text`: Prometheus text exposition
  (``# HELP``/``# TYPE``, cumulative ``le`` buckets).
- :func:`dump_json`: the snapshot and the trace summary in one file.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional

from . import trace as _trace
from .metrics import Histogram, MetricsRegistry
from .metrics import _escape_label_value
from .metrics import registry as _registry

__all__ = ["snapshot", "to_prometheus_text", "dump_json",
           "json_safe"]


def json_safe(obj):
    """Recursively replace non-finite floats with their Prometheus
    spellings (``"+Inf"``/``"-Inf"``/``"NaN"``): ``json.dumps`` would
    emit bare ``Infinity``, which RFC-8259 parsers refuse, and every
    histogram carries a ``+Inf`` bucket edge.  ``float("+Inf")``
    round-trips.  The HTTP endpoints and :func:`dump_json` use it."""
    if isinstance(obj, float):
        if obj != obj:
            return "NaN"
        if obj == math.inf:
            return "+Inf"
        if obj == -math.inf:
            return "-Inf"
        return obj
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def snapshot(reg: Optional[MetricsRegistry] = None,
             materialize: bool = True) -> Dict[str, Dict[str, Any]]:
    """Scrape every instrument into one plain dict.

    ``materialize=True`` reads the deferred device values (the one
    device→host copy of the metrics pipeline); ``materialize=False``
    reads host state only."""
    reg = reg or _registry()
    out: Dict[str, Dict[str, Any]] = {}
    for inst in reg.instruments():
        entry: Dict[str, Any] = {"type": inst.kind, "help": inst.help}
        if isinstance(inst, Histogram):
            entry.update(inst.collect(materialize=materialize))
        else:
            entry["value"] = inst.collect(materialize=materialize)
        if inst.pending_dropped:
            entry["pending_dropped"] = inst.pending_dropped
        out[inst.key()] = entry
    return out


def _prom_num(v) -> str:
    """Prometheus number rendering; accepts the :func:`json_safe`
    spellings ("+Inf"/"-Inf"/"NaN"), which ``float`` round-trips."""
    if v is None:
        return "NaN"
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if f != f:
        return "NaN"
    if f == math.inf:
        return "+Inf"
    if f == -math.inf:
        return "-Inf"
    return str(int(f)) if f == int(f) else repr(f)


def _label_suffix(labels: Dict[str, str]) -> str:
    """``{k="v",...}`` rendering (sorted, escaped); empty string for
    no labels."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def to_prometheus_text(reg: Optional[MetricsRegistry] = None,
                       materialize: bool = True,
                       extra_labels: Optional[Dict[str, str]] = None
                       ) -> str:
    """Prometheus text exposition of the registry.

    ``extra_labels`` are merged into every sample's label set."""
    reg = reg or _registry()
    lines = []
    seen_header = set()
    for inst in sorted(reg.instruments(), key=lambda i: i.key()):
        if inst.name not in seen_header:
            seen_header.add(inst.name)
            if inst.help:
                lines.append(f"# HELP {inst.name} {inst.help}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
        base = dict(inst.labels)
        if extra_labels:
            base.update(extra_labels)
        suffix = _label_suffix(base)
        if isinstance(inst, Histogram):
            data = inst.collect(materialize=materialize)
            for le, cum in data["buckets"]:
                lbl = ",".join(
                    [f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(base.items())]
                    + [f'le="{_prom_num(le)}"'])
                lines.append(
                    f"{inst.name}_bucket{{{lbl}}} {cum}")
            lines.append(f"{inst.name}_sum{suffix} "
                         f"{_prom_num(data['sum'])}")
            lines.append(f"{inst.name}_count{suffix} {data['count']}")
        else:
            v = inst.collect(materialize=materialize)
            if v is None:
                # valueless (dead-engine fn, unset, failed lazy):
                # absent sample, not a NaN series forever
                continue
            lines.append(f"{inst.name}{suffix} {_prom_num(v)}")
    return "\n".join(lines) + "\n"


def dump_json(path: str, reg: Optional[MetricsRegistry] = None) -> str:
    """Metrics snapshot + per-span trace summary in one JSON file."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    payload = {"metrics": snapshot(reg),
               "trace_summary": _trace.summary()}
    with open(path, "w") as f:
        json.dump(json_safe(payload), f, indent=1, allow_nan=False,
                  default=str)
    return path
