"""Stdlib HTTP exposition: ``/metrics``, ``/healthz``, ``/readyz`` — and
the mux the network-facing serving front-end mounts onto (counterpart of
``deepspeed_tpu/observability/exposition.py``).

Beyond the scrape endpoints, :meth:`ObservabilityServer.mount` registers
extra ``(method, path)`` routes (the serving front-end adds
``POST /v1/generate`` and ``GET /v1/state`` here), so the API and the
probes share ONE port: an orchestrator scrapes ``/metrics`` and probes
``/readyz`` on the same address it routes traffic to. No third-party
dependency — ``http.server`` on a daemon thread, speaking HTTP/1.1 so a
mounted route can stream a chunked response (SSE token events).

Probe semantics (mapped from the batcher's health state machine):

=========  ==================  ==================
state      ``/healthz`` (live)  ``/readyz`` (ready)
=========  ==================  ==================
starting   200                 503 (do not route yet)
ready      200                 200
degraded   200                 200 (reduced capacity is still capacity)
draining   200 (let it finish) 503 (stop routing; don't kill)
=========  ==================  ==================

A DRAINING replica is deliberately live-but-not-ready: an orchestrator
that kills on liveness would destroy the in-flight sequences the drain
exists to finish, while readiness-503 makes the router move new traffic
away — exactly the ROADMAP's drain-aware rebalancing contract.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from deepspeed_tpu_torch.observability.registry import (MetricsRegistry,
                                                        get_registry)
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["READY_STATES", "LIVE_STATES", "ObservabilityServer",
           "probe_status"]

#: batcher health states that answer 200 on /readyz
READY_STATES = frozenset({"ready", "degraded"})
#: batcher health states that answer 200 on /healthz (all of them — a
#: process that answers HTTP at all is live; liveness fails by not answering)
LIVE_STATES = frozenset({"starting", "ready", "degraded", "draining"})

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def probe_status(health: Optional[str]) -> dict:
    """(live, ready) booleans for a health state string (None = no health
    source wired → both probes pass; a bare metrics sidecar is never the
    reason a pod gets rescheduled)."""
    if health is None:
        return {"health": None, "live": True, "ready": True}
    h = str(health).lower()
    return {"health": h, "live": h in LIVE_STATES, "ready": h in READY_STATES}


class _Handler(BaseHTTPRequestHandler):
    server_version = "dstpu-obs/1"
    # HTTP/1.1 so mounted routes can stream chunked responses; every
    # response therefore carries Content-Length or chunked framing
    protocol_version = "HTTP/1.1"
    #: a response (status line + headers) is on the wire for the current
    #: request — writing a second one would corrupt a committed chunked
    #: body, so error paths must close the connection instead
    _committed = False

    def _send(self, code: int, body: str, ctype: str,
              headers: Optional[dict] = None) -> None:
        data = body.encode("utf-8")
        self._committed = True
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(data)

    def _dispatch(self, method: str) -> bool:
        """Run a mounted route if one matches; True if handled."""
        path = self.path.split("?", 1)[0]
        fn = getattr(self.server, "routes", {}).get((method, path))
        if fn is None:
            return False
        try:
            fn(self)
        except (BrokenPipeError, ConnectionResetError):
            pass                       # client went away mid-response
        except Exception as e:         # route bug ≠ serving-process death
            logger.warning(f"observability: route {method} {path} "
                           f"failed: {e}")
            if self._committed:
                # the route already sent a status line (possibly mid
                # chunked stream): a second response would be injected
                # into the body — drop the connection instead
                self.close_connection = True
                return True
            # the route may have died before consuming the request body;
            # its unread bytes would desync a kept-alive connection
            self.close_connection = True
            try:
                self._send(500, json.dumps(
                    {"error": {"type": "internal", "detail": str(e)}}),
                    "application/json")
            except OSError:
                pass
        return True

    def do_POST(self):  # noqa: N802 (http.server API)
        self._committed = False
        if not self._dispatch("POST"):
            # the unread request body would desync a kept-alive HTTP/1.1
            # connection (its bytes parse as the next request line)
            self.close_connection = True
            self._send(404, "not found\n", "text/plain")

    def do_GET(self):  # noqa: N802 (http.server API)
        self._committed = False
        srv = self.server
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._send(200, srv.registry.render_prometheus(),
                           PROM_CONTENT_TYPE)
            elif path == "/metrics.json":
                self._send(200, srv.registry.render_json(),
                           "application/json")
            elif path == "/v1/trace":
                # causal event trace (Chrome trace-event JSON): open the
                # download in Perfetto / chrome://tracing. Served on every
                # ObservabilityServer, so the trace rides the same port as
                # /metrics and the serving API
                from deepspeed_tpu_torch.observability.trace import trace_export

                self._send(200, json.dumps(trace_export(), default=str),
                           "application/json",
                           headers={"Content-Disposition":
                                    'attachment; filename="trace.json"'})
            elif path in ("/healthz", "/readyz"):
                st = probe_status(srv.health_fn()
                                  if srv.health_fn is not None else None)
                ok = st["live"] if path == "/healthz" else st["ready"]
                self._send(200 if ok else 503, json.dumps(st),
                           "application/json")
            elif not self._dispatch("GET"):
                self._send(404, "not found\n", "text/plain")
        except Exception as e:  # never take the serving process down
            if self._committed:
                logger.warning(f"observability: GET {path} failed after "
                               f"response commit: {e}")
                self.close_connection = True
                return
            try:
                self._send(500, f"scrape error: {e}\n", "text/plain")
            except OSError:
                pass

    # ------------------------------------------------------------------
    # chunked streaming helpers for mounted routes (SSE token events)
    # ------------------------------------------------------------------
    def begin_chunked(self, code: int = 200,
                      ctype: str = "text/event-stream",
                      headers: Optional[dict] = None) -> None:
        self._committed = True
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()

    def write_chunk(self, data: bytes) -> None:
        if not data:
            return                     # a zero chunk would end the stream
        self.wfile.write(f"{len(data):X}\r\n".encode("ascii") + data
                         + b"\r\n")
        self.wfile.flush()             # tokens must not sit in the buffer

    def end_chunked(self) -> None:
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        pass


class ObservabilityServer:
    """Threaded exposition server bound to ``host:port`` (port 0 = ephemeral).

    ``health_fn`` is any zero-arg callable returning the current health
    state string; :meth:`for_batcher` wires it to a ``ContinuousBatcher``.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 health_fn: Optional[Callable[[], str]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry if registry is not None else get_registry()
        self.health_fn = health_fn
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.registry = self.registry
        self._httpd.health_fn = health_fn
        self._routes: dict = {}
        self._httpd.routes = self._routes
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    def mount(self, method: str, path: str, fn: Callable) -> None:
        """Register an extra route on this mux. ``fn(handler)`` receives the
        live ``BaseHTTPRequestHandler`` and owns the whole exchange (read
        the body, send the response — ``handler._send`` for unary JSON,
        ``begin_chunked``/``write_chunk``/``end_chunked`` for streams).
        The built-in ``/metrics`` + probe paths cannot be shadowed."""
        self._routes[(method.upper(), path)] = fn

    @classmethod
    def for_batcher(cls, batcher, registry=None, **kw) -> "ObservabilityServer":
        """Probes track the batcher's STARTING/READY/DEGRADED/DRAINING."""
        srv = cls(registry=registry, health_fn=lambda: batcher.health, **kw)
        return srv

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def closed(self) -> bool:
        return self._closed

    def start(self) -> "ObservabilityServer":
        if self._closed:
            raise RuntimeError("ObservabilityServer already closed; build "
                               "a new one instead of rebinding")
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="dstpu-obs-http",
                daemon=True)
            self._thread.start()
            logger.info(f"observability: /metrics /healthz /readyz at "
                        f"{self.url}")
        return self

    def close(self) -> None:
        """Idempotent: stops the accept loop, joins the server thread, and
        releases the listening socket; safe to call any number of times."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
