"""Wire protocol for the network serving front-end (counterpart of
``deepspeed_tpu/serving/protocol.py``; stdlib JSON and SSE framing).

One module owns the whole HTTP-facing contract so the server
(:mod:`~deepspeed_tpu_torch.serving.frontend`), the client
(:mod:`~deepspeed_tpu_torch.serving.client`), and the tests all speak from the
same source:

* **request schema** — ``POST /v1/generate`` JSON body:
  ``{"prompt": [int token ids], "max_new_tokens"?, "deadline_s"?,
  "priority"?, "tier"?, "stream"?}``. Prompts are token ids (the engine
  has no tokenizer); a string prompt is a 400, an over-long one a 413.
  ``tier`` is the SLO class — ``"latency"`` / ``"throughput"`` /
  ``"batch"`` — driving per-tier admission budgets, preemption victim
  order, and tier-scaled ``Retry-After``; anything else is a 400
  ``invalid_tier``, and an absent tier takes the replica's configured
  default.
* **tenant priority** — ``x-api-key`` maps through the configured
  ``serving.frontend.api_keys`` table onto the RequestManager's integer
  admission priorities; ``x-priority`` (or body ``priority``) is honored
  when ``allow_priority_header`` is set, clamped to
  ``max_header_priority`` so an anonymous header can never outrank the
  keyed tenants. These are the SAME priorities the batcher sheds by — a
  tenant's key literally buys shed-later placement.
* **backpressure mapping** — a retryable
  :class:`~deepspeed_tpu_torch.serving.request.ShedError` (queue_full,
  draining, capacity, shed_storm, ...) becomes ``429`` with a
  ``Retry-After`` header carrying the manager's load-aware hint; terminal
  refusals (``oversize``) become ``413``; deadline expiry becomes
  ``504``; client cancellation ``499`` (the nginx convention).
* **streaming framing** — Server-Sent Events over chunked
  transfer-encoding: ``event: token`` per generated token, a final
  ``event: end`` carrying the full terminal record, ``event: migrated``
  when the router moved the request to a sibling replica — off a
  draining replica's queue, or mid-flight through the shared KV tier
  after a crash or a voluntary rebalance (the terminal record then
  carries ``migrated_from``).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Iterator, List, Optional, Tuple

from deepspeed_tpu_torch.serving.request import (COMPLETED, EXPIRED, SHED,
                                                 TIERS, ServeRequest,
                                                 ShedError)

__all__ = ["GENERATE_PATH", "STATE_PATH", "API_KEY_HEADER",
           "PRIORITY_HEADER", "ProtocolError", "GenerateRequest",
           "parse_generate_request", "terminal_record",
           "response_for_record", "shed_response", "sse_event", "iter_sse"]

GENERATE_PATH = "/v1/generate"
STATE_PATH = "/v1/state"
API_KEY_HEADER = "x-api-key"
PRIORITY_HEADER = "x-priority"
SSE_CONTENT_TYPE = "text/event-stream"


class ProtocolError(ValueError):
    """A request the front-end refuses before it touches the queue;
    carries the HTTP status and a machine-readable error body."""

    def __init__(self, status: int, err_type: str, detail: str = ""):
        self.status = int(status)
        self.err_type = err_type
        self.detail = detail
        super().__init__(f"{status} {err_type}: {detail}")

    def body(self) -> Dict:
        return {"error": {"type": self.err_type, "detail": self.detail,
                          "retryable": False}}


@dataclasses.dataclass
class GenerateRequest:
    """A validated ``/v1/generate`` request, ready for ``submit()``."""

    prompt: List[int]
    max_new_tokens: Optional[int] = None
    deadline_s: Optional[float] = None
    priority: int = 0
    #: SLO tier (latency/throughput/batch); None = backend default
    tier: Optional[str] = None
    stream: bool = False


def resolve_priority(headers, body_priority, cfg) -> int:
    """Tenant priority: api-key table first, then the explicit
    header/body override (when allowed), else the default."""
    key = headers.get(API_KEY_HEADER) if headers is not None else None
    if cfg.require_api_key and (key is None or key not in cfg.api_keys):
        raise ProtocolError(401, "unauthorized",
                            "a known x-api-key is required")
    if key is not None and key in cfg.api_keys:
        return int(cfg.api_keys[key])
    override = None
    if headers is not None and headers.get(PRIORITY_HEADER) is not None:
        override = headers.get(PRIORITY_HEADER)
    elif body_priority is not None:
        override = body_priority
    if override is not None and cfg.allow_priority_header:
        try:
            p = int(override)
        except (TypeError, ValueError):
            raise ProtocolError(400, "invalid_priority",
                                f"priority must be an int, got {override!r}")
        # clamped both ways: the cap keeps an anonymous header from
        # outranking the api_keys tenants, the floor keeps it from
        # minting unbounded per-priority metric label values
        return max(int(cfg.min_header_priority),
                   min(p, int(cfg.max_header_priority)))
    return int(cfg.default_priority)


def parse_generate_request(raw: bytes, headers, cfg) -> GenerateRequest:
    """Validate a request body + headers into a :class:`GenerateRequest`;
    raises :class:`ProtocolError` with the right 4xx for anything else."""
    if len(raw) > cfg.max_body_bytes:
        raise ProtocolError(413, "body_too_large",
                            f"{len(raw)} > {cfg.max_body_bytes} bytes")
    try:
        body = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(400, "invalid_json", str(e))
    if not isinstance(body, dict):
        raise ProtocolError(400, "invalid_request",
                            "body must be a JSON object")
    prompt = body.get("prompt")
    if isinstance(prompt, str):
        raise ProtocolError(400, "prompt_not_tokenized",
                            "prompt must be a list of int token ids "
                            "(the engine carries no tokenizer)")
    if not isinstance(prompt, list) or not prompt \
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt):
        raise ProtocolError(400, "invalid_prompt",
                            "prompt must be a non-empty list of ints")
    if len(prompt) > cfg.max_prompt_tokens:
        raise ProtocolError(413, "prompt_too_long",
                            f"{len(prompt)} > {cfg.max_prompt_tokens} "
                            f"tokens")
    max_new = body.get("max_new_tokens")
    if max_new is not None:
        if not isinstance(max_new, int) or isinstance(max_new, bool) \
                or max_new < 1:
            raise ProtocolError(400, "invalid_max_new_tokens",
                                "max_new_tokens must be a positive int")
    deadline = body.get("deadline_s", body.get("timeout_s"))
    if deadline is not None:
        if not isinstance(deadline, (int, float)) \
                or isinstance(deadline, bool) or deadline <= 0:
            raise ProtocolError(400, "invalid_deadline",
                                "deadline_s must be a positive number")
        deadline = float(deadline)
    tier = body.get("tier")
    if tier is not None and tier not in TIERS:
        raise ProtocolError(400, "invalid_tier",
                            f"tier must be one of {list(TIERS)}, "
                            f"got {tier!r}")
    return GenerateRequest(
        prompt=[int(t) for t in prompt],
        max_new_tokens=max_new,
        deadline_s=deadline,
        priority=resolve_priority(headers, body.get("priority"), cfg),
        tier=tier,
        stream=bool(body.get("stream", False)))


# ---------------------------------------------------------------------------
# responses
# ---------------------------------------------------------------------------

def _retry_after_headers(retry_after_s: Optional[float]) -> Dict[str, str]:
    # Retry-After is integer seconds on the wire; never advertise 0
    return {"Retry-After": str(max(1, math.ceil(retry_after_s or 1.0)))}


def shed_response(e: ShedError) -> Tuple[int, Dict[str, str], Dict]:
    """A submit-time :class:`ShedError` → (status, headers, JSON body)."""
    if e.retryable:
        return (429, _retry_after_headers(e.retry_after_s),
                {"error": {"type": "overloaded", "reason": e.reason,
                           "retryable": True,
                           "retry_after_s": e.retry_after_s}})
    return (413, {}, {"error": {"type": "rejected", "reason": e.reason,
                                "retryable": False}})


def terminal_record(req: ServeRequest, *, state: Optional[str] = None,
                    finish_reason: Optional[str] = None) -> Dict:
    """JSON-safe snapshot of a terminal request — the ``end`` event body
    and the unary response payload are both built from this. ``state`` /
    ``finish_reason`` overrides let a shutdown path resolve a still-live
    request with a TERMINAL state without forking the record shape."""
    err = req.error
    return {
        "state": state if state is not None else req.state,
        "finish_reason": (finish_reason if finish_reason is not None
                          else req.finish_reason or None),
        "tokens": [int(t) for t in req.generated],
        "usage": {"prompt_tokens": req.prompt_len,
                  "completion_tokens": len(req.generated)},
        "span": req.span(),
        # donor replica when the request was re-homed here (crash or
        # rebalance migration); None for a request that never moved
        "migrated_from": req.migrated_from,
        "error": None if err is None else {
            "reason": err.reason, "retryable": err.retryable,
            "retry_after_s": err.retry_after_s},
    }


def response_for_record(uid: int, record: Dict
                        ) -> Tuple[int, Dict[str, str], Dict]:
    """A terminal record → the unary HTTP response triple. Admitted-then-
    shed requests surface exactly like submit-time sheds (429/413) so a
    client needs ONE backpressure code path."""
    state = record.get("state")
    body = {"id": uid, "object": "generation", **record}
    if state == COMPLETED:
        return 200, {}, body
    if state == SHED:
        err = record.get("error") or {}
        if err.get("retryable", True):
            return (429, _retry_after_headers(err.get("retry_after_s")),
                    body)
        return 413, {}, body
    if state == EXPIRED:
        body["error"] = {"reason": "deadline", "retryable": True,
                         "retry_after_s": None}
        return 504, {}, body
    # cancelled (client went away / server shutdown) — nginx's 499
    return 499, {}, body


# ---------------------------------------------------------------------------
# SSE framing
# ---------------------------------------------------------------------------

def sse_event(data: Dict, event: Optional[str] = None) -> bytes:
    """One Server-Sent Event frame: optional ``event:`` line, one
    ``data:`` line of JSON, blank-line terminator."""
    out = []
    if event:
        out.append(f"event: {event}")
    out.append(f"data: {json.dumps(data)}")
    return ("\n".join(out) + "\n\n").encode("utf-8")


def iter_sse(fp) -> Iterator[Dict]:
    """Parse an SSE byte stream from a file-like object into event dicts
    ``{"event": name-or-None, "data": parsed-json}``. Used by the client
    and by the wire-format tests (the two must agree with
    :func:`sse_event` by construction)."""
    event, data_lines = None, []
    while True:
        line = fp.readline()
        if not line:
            break
        line = line.decode("utf-8") if isinstance(line, bytes) else line
        line = line.rstrip("\r\n")
        if line == "":
            if data_lines:
                yield {"event": event,
                       "data": json.loads("\n".join(data_lines))}
            event, data_lines = None, []
            continue
        if line.startswith("event:"):
            event = line[len("event:"):].strip()
        elif line.startswith("data:"):
            data_lines.append(line[len("data:"):].strip())
        # comment lines (":") and unknown fields are ignored per SSE spec
    if data_lines:
        yield {"event": event, "data": json.loads("\n".join(data_lines))}
