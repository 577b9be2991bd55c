"""Exponential backoff with jitter and a deadline (counterpart of
``paddle_tpu/distributed/resilience/retry.py``, the same policy and
counters): ``retry_call`` for a call site, ``retryable`` as a
decorator.  The checkpoint manager's writes, manifest commits and reads
go through it.

Backoff: ``delay_k = min(max_delay, base_delay * 2**k) * (1 + U*jitter)``
with U drawn from a module RNG — seed it via ``PADDLE_RETRY_SEED`` for
bit-reproducible chaos runs.  A ``deadline`` (seconds, wall clock from
the first attempt) bounds total time even when ``max_attempts`` is
generous; the *next* sleep is clipped so the final attempt still lands
inside the deadline window.
"""

from __future__ import annotations

import functools
import os
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Type

from .faults import InjectedFault  # noqa: F401  (re-export convenience)

# transport-ish failures retried by default; InjectedFault is a
# ConnectionError subclass so chaos plans ride the same policy
DEFAULT_RETRY_ON: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, OSError)


class RetryExhausted(RuntimeError):
    """All attempts failed (or the deadline expired); ``__cause__``
    carries the last underlying exception."""

    def __init__(self, msg: str, attempts: int):
        super().__init__(msg)
        self.attempts = attempts


_rng = random.Random(int(os.environ.get("PADDLE_RETRY_SEED", "0") or 0)
                     if os.environ.get("PADDLE_RETRY_SEED") else None)

# site label → {"attempts": n, "retries": n, "exhausted": n}
_stats: Dict[str, Dict[str, int]] = {}
_stats_lock = threading.Lock()


def _bump(label: str, key: str, by: int = 1):
    with _stats_lock:
        d = _stats.setdefault(
            label, {"attempts": 0, "retries": 0, "exhausted": 0})
        d[key] += by
    # mirrored onto the observability registry (one scrape answers
    # "how degraded are we"); the names are literals, one per key
    try:
        from ...observability import metrics as _obs_metrics
        reg = _obs_metrics.registry()
        site = {"site": label}
        if key == "attempts":
            reg.counter("resilience_retry_attempts_total",
                        "retry-layer attempts by call-site label",
                        labels=site).inc(by)
        elif key == "retries":
            reg.counter("resilience_retry_retries_total",
                        "retry-layer retries by call-site label",
                        labels=site).inc(by)
        else:
            reg.counter("resilience_retry_exhausted_total",
                        "retry-layer exhaustions by call-site label",
                        labels=site).inc(by)
    except Exception:
        pass  # a metrics failure must never break the retry path


def retry_stats(label: Optional[str] = None):
    """Counters for observability and the chaos suite."""
    with _stats_lock:
        if label is not None:
            return dict(_stats.get(
                label, {"attempts": 0, "retries": 0, "exhausted": 0}))
        return {k: dict(v) for k, v in _stats.items()}


def reset_retry_stats():
    with _stats_lock:
        _stats.clear()


def retry_call(fn: Callable, *args,
               max_attempts: int = 5,
               base_delay: float = 0.05,
               max_delay: float = 2.0,
               deadline: Optional[float] = 30.0,
               jitter: float = 0.5,
               retry_on: Tuple[Type[BaseException], ...] = DEFAULT_RETRY_ON,
               giveup: Optional[Callable[[BaseException], bool]] = None,
               on_retry: Optional[Callable[[int, BaseException], None]]
               = None,
               label: Optional[str] = None,
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying ``retry_on`` failures.

    ``giveup(exc) -> True`` short-circuits (e.g. HTTP 4xx is not
    transient).  Raises ``RetryExhausted`` (cause = last error) when
    attempts or the deadline run out.
    """
    label = label or getattr(fn, "__qualname__", repr(fn))
    start = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(max_attempts):
        _bump(label, "attempts")
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if giveup is not None and giveup(e):
                raise
            last = e
            if attempt == max_attempts - 1:
                break
            delay = min(max_delay, base_delay * (2.0 ** attempt))
            delay *= 1.0 + _rng.random() * jitter
            if deadline is not None:
                left = deadline - (time.monotonic() - start)
                if left <= 0:
                    break
                delay = min(delay, max(left, 0.0))
            if on_retry is not None:
                on_retry(attempt + 1, e)
            _bump(label, "retries")
            time.sleep(delay)
    _bump(label, "exhausted")
    raise RetryExhausted(
        f"{label}: {max_attempts} attempts failed "
        f"(last: {type(last).__name__}: {last})",
        attempts=max_attempts) from last


def retryable(**policy):
    """Decorator form of :func:`retry_call` with a fixed policy."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args,
                              label=policy.get(
                                  "label", getattr(fn, "__qualname__",
                                                   repr(fn))),
                              **{k: v for k, v in policy.items()
                                 if k != "label"},
                              **kwargs)
        wrapped.__wrapped_by_retry__ = True
        return wrapped

    return deco
