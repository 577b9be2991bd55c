"""The observability HTTP endpoint (counterpart of the part of
``paddle_tpu/observability/http.py`` that ``metrics_port=`` needs).

A stdlib ``ThreadingHTTPServer`` on a loopback port serving

- ``/metrics``: Prometheus text exposition of the registry;
- ``/metrics.json``: the :func:`~.export.dump_json` shape (the metrics
  snapshot and the trace summary);
- ``/trace``: Chrome/Perfetto ``trace_event`` JSON of the span ring;
- ``/events``: the control-loop decision ring, host state only;
- ``/healthz``: liveness from host state only, so it answers while a
  ``/metrics`` scrape waits on a device value (each request runs on a
  daemon thread of its own).

``LLMServer(metrics_port=)`` and ``ServingRouter(metrics_port=)`` call
:func:`serve` (port 0 binds an ephemeral port; the caller closes it).
Nothing here opens a socket on import.  The environment-armed,
per-rank endpoint of the JAX module (``PADDLE_TPU_METRICS_PORT``,
``resolve_port``, ``maybe_serve_from_env``, ``serve_for_rank``) waits
for the port of the distributed launcher (ROADMAP.md queue A, items
A11/A12), so :func:`active_server` is None until then.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from . import events as _events
from . import export as _export
from . import trace as _trace
from .export import json_safe
from .metrics import MetricsRegistry

__all__ = ["ObservabilityHTTPServer", "serve", "active_server",
           "json_safe"]

# route handler: () -> (status, content_type, body_bytes)
RouteFn = Callable[[], Tuple[int, str, bytes]]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
JSON_CONTENT_TYPE = "application/json; charset=utf-8"


class ObservabilityHTTPServer:
    """One scrape endpoint.  ``port=0`` binds an ephemeral port;
    ``registry=None`` serves the process-wide registry;
    ``extra_routes`` (or :meth:`add_route`) mounts more GET paths."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 extra_labels: Optional[Dict[str, str]] = None,
                 extra_routes: Optional[Dict[str, RouteFn]] = None):
        self.registry = registry
        self.extra_labels = dict(extra_labels or {})
        self._routes: Dict[str, RouteFn] = {
            "/metrics": self._metrics,
            "/metrics.json": self._metrics_json,
            "/trace": self._trace,
            "/events": self._events,
            "/healthz": self._healthz,
        }
        self._routes.update(extra_routes or {})
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):       # machine traffic: quiet
                pass

            def do_GET(self):
                fn = outer._routes.get(self.path.split("?", 1)[0])
                if fn is None:
                    status, ctype, body = 404, "text/plain", b"not found\n"
                else:
                    try:
                        status, ctype, body = fn()
                    except Exception as e:  # noqa: BLE001 — one bad
                        # scrape answers 500 and the server lives on
                        status, ctype = 500, "text/plain"
                        body = (f"{type(e).__name__}: {e}\n"
                                ).encode("utf-8", "replace")
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        # a handler waiting on a device value never blocks close() or
        # the process's exit
        self._httpd.daemon_threads = True
        self._httpd.block_on_close = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"paddle-torch-metrics-{self.port}", daemon=True)
        self._thread.start()

    def _metrics(self):
        text = _export.to_prometheus_text(
            self.registry, extra_labels=self.extra_labels or None)
        return 200, PROM_CONTENT_TYPE, text.encode("utf-8")

    def _metrics_json(self):
        payload = {"metrics": _export.snapshot(self.registry),
                   "trace_summary": _trace.summary()}
        return (200, JSON_CONTENT_TYPE,
                json.dumps(json_safe(payload), allow_nan=False,
                           default=str).encode("utf-8"))

    def _trace(self):
        return (200, JSON_CONTENT_TYPE,
                json.dumps(_trace.to_chrome_trace()).encode("utf-8"))

    def _events(self):
        payload = {"events": _events.snapshot(),
                   "capacity": _events.capacity()}
        return (200, JSON_CONTENT_TYPE,
                json.dumps(json_safe(payload), allow_nan=False,
                           default=str).encode("utf-8"))

    def _healthz(self):
        payload = {"status": "ok", "pid": os.getpid()}
        rank = self.extra_labels.get("rank")
        if rank is not None:
            payload["rank"] = rank
        return (200, JSON_CONTENT_TYPE, json.dumps(payload).encode("utf-8"))

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    def add_route(self, path: str, fn: RouteFn):
        """Mount an extra GET route on the running server."""
        self._routes[str(path)] = fn

    def close(self):
        """Stop accepting and release the socket; handler threads are
        daemons and are not joined."""
        try:
            self._httpd.shutdown()
        finally:
            self._httpd.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def serve(port: int, host: str = "127.0.0.1",
          registry: Optional[MetricsRegistry] = None,
          extra_labels: Optional[Dict[str, str]] = None,
          extra_routes: Optional[Dict[str, RouteFn]] = None
          ) -> ObservabilityHTTPServer:
    """Start an endpoint (``port=0``: ephemeral); the caller closes
    it."""
    return ObservabilityHTTPServer(port, host=host, registry=registry,
                                   extra_labels=extra_labels,
                                   extra_routes=extra_routes)


_active: Optional[ObservabilityHTTPServer] = None
_active_lock = threading.Lock()


def active_server() -> Optional[ObservabilityHTTPServer]:
    """The process's environment-armed endpoint: None until the
    environment arming is ported (module docstring)."""
    return _active


def _reset_for_tests():
    """Close and forget the environment-armed endpoint."""
    global _active
    with _active_lock:
        if _active is not None:
            _active.close()
            _active = None
