"""Network serving front-end: ``POST /v1/generate`` over the probe mux
(counterpart of ``deepspeed_tpu/serving/frontend.py``).

:class:`ServingFrontend` is the piece that makes the engine reachable —
the reproduction's MII/FastGen product layer. It mounts the generate API
on the SAME :class:`~deepspeed_tpu_torch.observability.ObservabilityServer` mux
that serves ``/metrics`` / ``/healthz`` / ``/readyz``, so one port carries
the whole story: an orchestrator scrapes, probes, and routes traffic to a
single address, and the readiness flip on drain is visible on the very
socket the traffic uses.

Request plane (all contracts defined in
:mod:`~deepspeed_tpu_torch.serving.protocol`):

* unary — ``POST /v1/generate`` with a JSON body; the handler thread
  submits through the backend (a
  :class:`~deepspeed_tpu_torch.serving.router.Replica` or
  :class:`~deepspeed_tpu_torch.serving.router.ReplicaRouter`) and waits on the
  request's event stream for the terminal record;
* streaming — ``"stream": true`` switches the response to chunked SSE:
  one ``event: token`` per generated token as the batcher's steps complete
  it, ``event: migrated`` if the router re-homed it off a draining
  replica, and a final ``event: end`` with the terminal record;
* backpressure — submit-time retryable sheds → ``429`` +
  ``Retry-After: <load-aware hint>``; terminal refusals → ``413``;
  deadline expiry → ``504``; a mid-flight client disconnect cancels the
  request (its KV comes back through the normal flush path).

``GET /v1/state`` returns the backend's report (the router's pool view or
one replica's ``serving_report()``) for dashboards and drills.
"""

from __future__ import annotations

import json
import queue
import select
import socket
import time
from typing import Dict, Optional

from deepspeed_tpu_torch.observability.events import SAMPLED_OUT, get_bus
from deepspeed_tpu_torch.serving import protocol
from deepspeed_tpu_torch.serving.protocol import (GENERATE_PATH, STATE_PATH,
                                                  GenerateRequest,
                                                  ProtocolError,
                                                  parse_generate_request,
                                                  response_for_record,
                                                  shed_response, sse_event)
from deepspeed_tpu_torch.serving.request import ShedError
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["ServingFrontend"]

_EVENT_POLL_S = 1.0                    # wait granularity on the event queue
_DEADLINE_GRACE_S = 10.0               # server waits past the request
                                       # deadline so expiry resolves cleanly


class ServingFrontend:
    """HTTP front-end over a replica or router backend.

    ``backend`` duck-types ``submit(prompt, *, max_new_tokens, deadline_s,
    priority, events) -> uid``, ``cancel(uid)``, ``health`` and
    ``report()`` — both :class:`Replica` and :class:`ReplicaRouter`
    qualify, so one replica and a fleet mount identically.
    """

    def __init__(self, backend, config=None, registry=None,
                 host: Optional[str] = None, port: Optional[int] = None):
        from deepspeed_tpu_torch.config.config import FrontendConfig
        from deepspeed_tpu_torch.observability import (ObservabilityServer,
                                                       get_registry)

        self.backend = backend
        self.cfg = config if config is not None else FrontendConfig()
        self._registry = registry if registry is not None else get_registry()
        self.server = ObservabilityServer(
            registry=self._registry,
            health_fn=lambda: self.backend.health,
            host=host if host is not None else self.cfg.host,
            port=port if port is not None else self.cfg.port)
        self.server.mount("POST", GENERATE_PATH, self._handle_generate)
        self.server.mount("GET", STATE_PATH, self._handle_state)
        self._closed = False
        self._codes: Dict[int, object] = {}

    @classmethod
    def from_deepspeed_config(cls, backend, config, **kw):
        """Build from a full ``DeepSpeedTpuConfig`` — consumer of the
        ``serving.frontend`` section (requires ``serving.frontend.enabled``
        so a config merely carrying the block cannot open a port)."""
        serving = getattr(config, "serving", None)
        fe = getattr(serving, "frontend", None)
        if fe is None or not fe.enabled:
            raise ValueError("serving.frontend.enabled must be true to "
                             "build a ServingFrontend from a "
                             "DeepSpeedTpuConfig (or pass a FrontendConfig"
                             " directly)")
        return cls(backend, fe, **kw)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    @property
    def url(self) -> str:
        return self.server.url

    def start(self) -> "ServingFrontend":
        self.server.start()
        logger.info(f"serving: frontend POST {GENERATE_PATH} at "
                    f"{self.url} (shared with /metrics /healthz /readyz)")
        return self

    def close(self) -> None:
        """Idempotent: the HTTP mux goes down exactly once (thread joined,
        socket released); the backend stays up — its owner closes it."""
        if self._closed:
            return
        self._closed = True
        self.server.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # routes
    # ------------------------------------------------------------------
    def _count(self, code: int) -> None:
        c = self._codes.get(code)
        if c is None:
            c = self._codes[code] = self._registry.counter(
                "frontend/http_requests", "front-end responses by status",
                labels={"code": str(code)})
        c.inc()

    def _send_json(self, handler, code: int, body: Dict,
                   headers: Optional[Dict] = None) -> None:
        self._count(code)
        handler._send(code, json.dumps(body), "application/json",
                      headers=headers)

    def _handle_state(self, handler) -> None:
        self._send_json(handler, 200, self.backend.report())

    def _read_body(self, handler) -> bytes:
        try:
            length = int(handler.headers.get("Content-Length", 0) or 0)
        except ValueError:
            handler.close_connection = True
            raise ProtocolError(400, "bad_content_length",
                                "Content-Length must be an integer")
        if length <= 0:
            # an unread (possibly chunked) body would desync keep-alive
            handler.close_connection = True
            raise ProtocolError(411, "length_required",
                                "Content-Length is required")
        if length > self.cfg.max_body_bytes:
            # don't read it; the connection is no longer framable
            handler.close_connection = True
            raise ProtocolError(413, "body_too_large",
                                f"{length} > {self.cfg.max_body_bytes}")
        return handler.rfile.read(length)

    def _handle_generate(self, handler) -> None:
        try:
            preq = parse_generate_request(self._read_body(handler),
                                          handler.headers, self.cfg)
        except ProtocolError as e:
            self._send_json(handler, e.status, e.body())
            return
        events: "queue.Queue" = queue.Queue()
        # mint the request's causal trace id HERE — the front door — so
        # the same track links frontend -> router -> batcher -> engine ->
        # KV tier (the manager adopts it instead of minting its own)
        bus = get_bus()
        trace_id = bus.mint_trace() if bus.enabled else None
        # trace_id rides the submit chain ONLY when tracing is on: with
        # tracing off the backend duck-type contract stays the pre-tracing
        # one (submit(prompt, *, max_new_tokens, deadline_s, priority,
        # events)). A sampled-out request passes the SAMPLED_OUT sentinel
        # so the manager does not mint again (each request gets exactly
        # one 1-in-N draw, at the front door).
        extra = ({} if not bus.enabled else
                 {"trace_id": trace_id if trace_id is not None
                  else SAMPLED_OUT})
        if preq.tier is not None:
            # only when the client chose one: an absent tier keeps the
            # pre-SLO submit contract and the backend's configured default
            extra["tier"] = preq.tier
        try:
            uid = self.backend.submit(
                preq.prompt, max_new_tokens=preq.max_new_tokens,
                deadline_s=preq.deadline_s, priority=preq.priority,
                events=events, **extra)
        except ShedError as e:
            if trace_id is not None:
                bus.instant("frontend", "rejected",
                            trace_id=trace_id,
                            args={"reason": e.reason,
                                  "retryable": e.retryable})
            status, headers, body = shed_response(e)
            self._send_json(handler, status, body, headers=headers)
            return
        if trace_id is not None:
            # async instant on the request track: the admit hop is now
            # causally pinned to this HTTP exchange
            bus.async_instant("request", "request", trace_id,
                              args={"subsys": "frontend",
                                    "what": "http_admit", "uid": uid,
                                    "stream": preq.stream})
        if preq.stream:
            self._stream_response(handler, uid, events, preq)
        else:
            self._unary_response(handler, uid, events, preq)
        if trace_id is not None:
            bus.async_instant("request", "request", trace_id,
                              args={"subsys": "frontend",
                                    "what": "http_done", "uid": uid})

    # ------------------------------------------------------------------
    # response modes
    # ------------------------------------------------------------------
    def _wait_deadline(self, preq: GenerateRequest) -> float:
        wait = (preq.deadline_s + _DEADLINE_GRACE_S
                if preq.deadline_s is not None
                else self.cfg.request_timeout_s)
        return time.monotonic() + wait

    def _client_gone(self, handler) -> bool:
        """EOF-peek the connection: while a handler waits on the event
        queue it never touches the socket, so a client disconnect is
        otherwise invisible until the terminal send. Pipelined bytes on a
        kept-alive connection read as data (not gone); FIN/RST read as
        EOF/error (gone)."""
        try:
            r, _, _ = select.select([handler.connection], [], [], 0)
            if not r:
                return False
            return handler.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    def _cancel_quiet(self, uid) -> None:
        """Best-effort cancel: a hung/closed backend raising must not
        crash the handler (mid-stream that would write a raw 500 into a
        committed chunked body)."""
        try:
            self.backend.cancel(uid)
        except Exception:
            pass

    def _unary_response(self, handler, uid, events, preq) -> None:
        deadline = self._wait_deadline(preq)
        while True:
            try:
                ev = events.get(timeout=_EVENT_POLL_S)
            except queue.Empty:
                if self._client_gone(handler):
                    # nobody is waiting for the answer: stop generating
                    self._cancel_quiet(uid)
                    handler.close_connection = True
                    return
                if time.monotonic() < deadline:
                    continue
                # the pump stalled past any reasonable resolution point:
                # resolve the request loudly rather than hang the client
                self._cancel_quiet(uid)
                self._send_json(handler, 504, {
                    "id": uid,
                    "error": {"type": "server_timeout", "retryable": True,
                              "detail": "request did not resolve in time"}})
                return
            if ev.get("event") == "end":
                break                  # token/migrated events are interim
        status, headers, body = response_for_record(uid, {
            k: v for k, v in ev.items() if k != "event"})
        self._send_json(handler, status, body, headers=headers)

    def _stream_response(self, handler, uid, events, preq) -> None:
        self._count(200)               # status is committed at first byte
        handler.begin_chunked(200, protocol.SSE_CONTENT_TYPE,
                              headers={"X-Request-Id": str(uid)})
        deadline = self._wait_deadline(preq)
        try:
            while True:
                try:
                    ev = events.get(timeout=_EVENT_POLL_S)
                except queue.Empty:
                    if self._client_gone(handler):
                        # a silent wait (e.g. still queued) hides the
                        # disconnect from the write path — peek for it
                        self._cancel_quiet(uid)
                        handler.close_connection = True
                        return
                    if time.monotonic() < deadline:
                        continue
                    self._cancel_quiet(uid)
                    handler.write_chunk(sse_event(
                        {"id": uid, "state": "cancelled",
                         "finish_reason": "server_timeout", "tokens": [],
                         "error": {"reason": "server_timeout",
                                   "retryable": True}}, event="end"))
                    break
                name = ev.pop("event", None)
                if name == "end":
                    handler.write_chunk(sse_event({"id": uid, **ev},
                                                  event="end"))
                    break
                handler.write_chunk(sse_event(ev, event=name or "message"))
            handler.end_chunked()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # client hung up mid-stream: stop generating for it — its KV
            # comes back through the normal cancel/flush path
            self._cancel_quiet(uid)
