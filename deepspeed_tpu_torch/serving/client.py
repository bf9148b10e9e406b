"""Minimal stdlib HTTP client for the serving front-end (counterpart of
``deepspeed_tpu/serving/client.py``).

``http.client`` only — the client exists so drills and tests exercise the
wire protocol through REAL sockets (no mocked transport), and so users get
a reference implementation of the backpressure contract: honor ``429`` +
``Retry-After`` by backing off exactly as long as the server's load-aware
hint says, instead of hammering an overloaded pool.
"""

from __future__ import annotations

import http.client
import json
import time
from typing import Dict, Iterator, List, Optional
from urllib.parse import urlsplit

from deepspeed_tpu_torch.serving.protocol import (API_KEY_HEADER,
                                                  GENERATE_PATH,
                                                  PRIORITY_HEADER, STATE_PATH,
                                                  iter_sse)

__all__ = ["FrontendError", "GenerateClient"]


class FrontendError(RuntimeError):
    """A non-2xx front-end response; carries the status, parsed body, and
    the ``Retry-After`` hint when the server sent one."""

    def __init__(self, status: int, body: Dict,
                 retry_after_s: Optional[float] = None):
        self.status = int(status)
        self.body = body
        self.retry_after_s = retry_after_s
        err = (body or {}).get("error", {})
        super().__init__(f"HTTP {status}: {err.get('type', 'error')} "
                         f"({err.get('reason', err.get('detail', ''))})")

    @property
    def retryable(self) -> bool:
        return bool(((self.body or {}).get("error") or {})
                    .get("retryable", self.status == 429))


class GenerateClient:
    """One front-end endpoint; a fresh connection per request (the server
    is threaded — connection reuse buys nothing and keeps sockets alive
    across drains)."""

    def __init__(self, base_url: str, api_key: Optional[str] = None,
                 timeout_s: float = 60.0):
        parts = urlsplit(base_url)
        self.host = parts.hostname or "127.0.0.1"
        self.port = parts.port or 80
        self.api_key = api_key
        self.timeout_s = float(timeout_s)

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------
    def _headers(self, priority: Optional[int]) -> Dict[str, str]:
        h = {"Content-Type": "application/json", "Connection": "close"}
        if self.api_key is not None:
            h[API_KEY_HEADER] = self.api_key
        if priority is not None:
            h[PRIORITY_HEADER] = str(int(priority))
        return h

    def _post(self, payload: Dict, priority: Optional[int]):
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        conn.request("POST", GENERATE_PATH, body=json.dumps(payload),
                     headers=self._headers(priority))
        return conn, conn.getresponse()

    @staticmethod
    def _error(resp) -> FrontendError:
        retry_after = resp.getheader("Retry-After")
        try:
            body = json.loads(resp.read().decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            body = {}
        return FrontendError(resp.status, body,
                             None if retry_after is None
                             else float(retry_after))

    # ------------------------------------------------------------------
    # API
    # ------------------------------------------------------------------
    def generate(self, prompt: List[int], *,
                 max_new_tokens: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 priority: Optional[int] = None,
                 max_retries: int = 0,
                 max_backoff_s: float = 30.0) -> Dict:
        """Unary generate. ``max_retries > 0`` resubmits after a 429,
        sleeping the server's ``Retry-After`` (capped) — the reference
        client-side half of the backpressure contract."""
        payload: Dict = {"prompt": [int(t) for t in prompt]}
        if max_new_tokens is not None:
            payload["max_new_tokens"] = int(max_new_tokens)
        if deadline_s is not None:
            payload["deadline_s"] = float(deadline_s)
        attempts = 0
        while True:
            conn, resp = self._post(payload, priority)
            try:
                if resp.status == 200:
                    return json.loads(resp.read().decode("utf-8"))
                err = self._error(resp)
            finally:
                conn.close()
            if err.status == 429 and attempts < max_retries:
                attempts += 1
                time.sleep(min(err.retry_after_s or 1.0, max_backoff_s))
                continue
            raise err

    def stream(self, prompt: List[int], *,
               max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None,
               priority: Optional[int] = None) -> Iterator[Dict]:
        """Streaming generate: yields the SSE events as dicts
        (``{"event": "token"|"migrated"|"end", "data": {...}}``); the
        final event is always ``end`` with the terminal record. Raises
        :class:`FrontendError` on a non-200 (e.g. 429 before the stream
        opened)."""
        payload: Dict = {"prompt": [int(t) for t in prompt],
                         "stream": True}
        if max_new_tokens is not None:
            payload["max_new_tokens"] = int(max_new_tokens)
        if deadline_s is not None:
            payload["deadline_s"] = float(deadline_s)
        conn, resp = self._post(payload, priority)
        try:
            if resp.status != 200:
                raise self._error(resp)
            for ev in iter_sse(resp):
                yield ev
                if ev.get("event") == "end":
                    break
        finally:
            conn.close()

    def state(self) -> Dict:
        """``GET /v1/state`` — the backend's report."""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        try:
            conn.request("GET", STATE_PATH,
                         headers={"Connection": "close"})
            resp = conn.getresponse()
            if resp.status != 200:
                raise self._error(resp)
            return json.loads(resp.read().decode("utf-8"))
        finally:
            conn.close()
