"""Control-loop decision ring (counterpart of
``paddle_tpu/observability/events.py``).

Counters say *how often* a control loop acted; this ring says *what it
decided and why*, decision by decision, so an operator can audit the
serving router after the fact::

    >>> events.record("scale_up", replicas=2, queue_depth=9)
    >>> events.snapshot()
    [{"ts": 1754300000.123, "kind": "scale_up", "replicas": 2,
      "queue_depth": 9}]

- **Bounded.**  A ``deque(maxlen=capacity)`` (default 256, knob
  ``PADDLE_TORCH_EVENTS_CAPACITY``): a chatty loop evicts its own
  oldest decisions.  Callers record decisions (scale, shed-state
  transitions), not per-request outcomes (those are counters).
- **Host only.**  ``record`` stamps ``time.time()`` and stores plain
  dicts; nothing here touches the device.
- **Always on**: a decision is rare and cheap to keep.

The HTTP endpoint (``observability/http.py``) serves the ring at
``/events``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..framework import env_knobs

__all__ = ["record", "snapshot", "capacity", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 256


def _env_capacity() -> int:
    cap = env_knobs.get_int("PADDLE_TORCH_EVENTS_CAPACITY", 0)
    return cap if cap > 0 else DEFAULT_CAPACITY


_lock = threading.Lock()
_ring: deque = deque(maxlen=_env_capacity())


def record(kind: str, **detail: Any) -> Dict[str, Any]:
    """Append one decision: ``kind`` (``scale_up``, ``shed_on`` …) and
    the context it was made on (host scalars and strings: they go to
    JSON as they are).  Returns the stored entry, timestamp included."""
    entry = {"ts": time.time(), "kind": str(kind), **detail}
    with _lock:
        _ring.append(entry)
    return entry


def snapshot() -> List[Dict[str, Any]]:
    """The ring, oldest first (copies)."""
    with _lock:
        return [dict(e) for e in _ring]


def capacity() -> int:
    return _ring.maxlen or DEFAULT_CAPACITY


def _reset_for_tests(capacity: Optional[int] = None):
    """Empty the ring, resized to ``capacity`` (default: the knob's)."""
    global _ring
    with _lock:
        _ring = deque(maxlen=capacity or _env_capacity())
