"""paddle_tpu_torch.observability — metrics, spans, the decision ring
and their export (counterpart of ``paddle_tpu/observability``).

- :mod:`.metrics`: the process-wide registry of counters, gauges and
  histograms; device values are held until a scrape reads them.
- :mod:`.trace`: the span recorder (about nothing while disabled; arm
  with ``PADDLE_TORCH_TRACE=1`` or ``trace.enable()``).
- :mod:`.events`: the bounded ring of control-loop decisions.
- :mod:`.export`: JSON snapshot and Prometheus text.
- :mod:`.http`: the scrape endpoint behind ``metrics_port=``.

::

    from paddle_tpu_torch import observability
    observability.trace.enable()
    ...                                   # serve
    print(observability.scrape())         # every metric, one dict

Importing this package opens no socket and starts no thread.  The
fleet aggregation (``aggregate.py``) and the profiler of the JAX
package are not ported yet (ROADMAP.md queue A, item A12).
"""

from __future__ import annotations

from ..framework import env_knobs as _env_knobs
from . import events, export, http, metrics, trace  # noqa: F401
from .metrics import registry  # noqa: F401

__all__ = ["trace", "metrics", "export", "events", "http", "registry",
           "scrape", "scrape_prometheus"]


def scrape(materialize: bool = True):
    """One dict over every metric of the process-wide registry;
    ``materialize=True`` reads the deferred device values here."""
    return export.snapshot(materialize=materialize)


def scrape_prometheus() -> str:
    """The registry in Prometheus text exposition format."""
    return export.to_prometheus_text()


# PADDLE_TORCH_TRACE=1 arms the recorder at import, before any engine
# records, so "trace this run" is an environment variable
if _env_knobs.get_bool("PADDLE_TORCH_TRACE"):
    _cap = _env_knobs.get_int("PADDLE_TORCH_TRACE_CAPACITY", 0)
    trace.enable(capacity=_cap if _cap > 0 else None)
    del _cap
