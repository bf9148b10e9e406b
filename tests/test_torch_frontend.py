"""The port's network serving layer (``deepspeed_tpu_torch/serving``:
protocol, front-end, router, client) against the JAX package's, on the
CPU: the scenarios of the reference's ``tests/unit/test_frontend.py``
that need no fleet.

* wire protocol (no engine, no sockets): request parsing and its typed
  4xx, tenant priority, the 429/``Retry-After`` / 413 / 504 / 499 mapping
  and SSE framing give the same results from both packages' functions;
* HTTP over real sockets: unary and SSE ``POST /v1/generate`` on the
  probe mux, 429 on a full queue, 504 on a deadline, cancellation on a
  server timeout or a client that goes away (stub backends), a 400 on a
  bad ``Content-Length``, the router routing away from a DRAINING replica
  and failing over, and the storm + SIGTERM drain of a two-replica pool.
  Each scenario runs once per package through the same code (fp32
  ``tiny`` engines built once per process, see
  ``tests/test_torch_serving.py``) and the outcome records (statuses,
  states, token counts, greedy tokens where a request runs alone) must be
  equal.

Every join, ``Future.result``, queue wait and socket has a time limit, so
a hang fails the test instead of the suite.
"""

import http.client
import io
import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_serving import (_whole_pools, both,  # noqa: F401
                                      pool_whole, sides)
from tests._torch_threads import one_torch_thread  # noqa: F401

TERMINAL = ("completed", "shed", "expired", "cancelled")
JOIN_S = 120.0


def _wait(cond, timeout=60.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError("condition not reached in time")


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


def batcher(s, kind="a", **kw):
    cfg = s.cfg(**{"prefill_chunk": 32, "default_max_new_tokens": 4, **kw})
    return s.ContinuousBatcher(s.engine(kind), cfg)


def fe_cfg(s, **kw):
    return s.config.FrontendConfig(**kw)


# ---------------------------------------------------------------------------
# wire protocol (no engine, no sockets)
# ---------------------------------------------------------------------------

BAD_BODIES = [
    b"{not json", json.dumps({"prompt": "a string"}).encode(),
    json.dumps({"prompt": []}).encode(),
    json.dumps({"prompt": [1, "x"]}).encode(),
    json.dumps({"prompt": [1], "max_new_tokens": 0}).encode(),
    json.dumps({"prompt": [1], "max_new_tokens": True}).encode(),
    json.dumps({"prompt": [1], "deadline_s": -1}).encode(),
    json.dumps({"prompt": [1], "tier": "gold"}).encode(),
    json.dumps({"prompt": list(range(9000))}).encode(),
]


def _parse(s):
    P = s.protocol
    cfg = fe_cfg(s)
    ok = P.parse_generate_request(json.dumps(
        {"prompt": [1, 2, 3], "max_new_tokens": 7, "deadline_s": 2.5,
         "stream": True, "tier": "batch"}).encode(), {}, cfg)
    bad = []
    for body in BAD_BODIES:
        with pytest.raises(P.ProtocolError) as ei:
            P.parse_generate_request(body, {}, cfg)
        bad.append((ei.value.status, ei.value.body()["error"]["type"]))
    assert [b[0] for b in bad] == [400] * 8 + [413]
    return vars(ok), bad


def _priority(s):
    P = s.protocol
    cfg = fe_cfg(s, api_keys={"gold": 9}, default_priority=1,
                 max_header_priority=5, min_header_priority=-2)
    body = json.dumps({"prompt": [1]}).encode()
    got = [P.parse_generate_request(body, h, cfg).priority for h in (
        {"x-api-key": "gold", "x-priority": "3"}, {"x-priority": "3"},
        {"x-priority": "999"}, {"x-priority": "-2"}, {"x-priority": "-999"},
        {})]
    got.append(P.parse_generate_request(
        json.dumps({"prompt": [1], "priority": 4}).encode(), {},
        cfg).priority)
    off = fe_cfg(s, allow_priority_header=False, default_priority=1)
    got.append(P.parse_generate_request(body, {"x-priority": "3"},
                                        off).priority)
    gated = fe_cfg(s, api_keys={"gold": 9}, require_api_key=True)
    with pytest.raises(P.ProtocolError) as ei:
        P.parse_generate_request(body, {"x-api-key": "wrong"}, gated)
    assert got == [9, 3, 5, -2, -2, 1, 4, 1] and ei.value.status == 401
    return got


def _status_mapping(s):
    P = s.protocol
    out = [P.shed_response(s.ShedError("queue_full", retryable=True,
                                       retry_after_s=2.3)),
           P.shed_response(s.ShedError("oversize", retryable=False))]
    for rec in ({"state": "completed", "tokens": [1, 2], "error": None},
                {"state": "shed", "tokens": [], "error": {
                    "reason": "kv_pressure", "retryable": True,
                    "retry_after_s": 5.0}},
                {"state": "expired"}, {"state": "cancelled"}):
        out.append(P.response_for_record(7, rec))
    assert [o[0] for o in out] == [429, 413, 200, 429, 504, 499]
    assert out[0][1]["Retry-After"] == "3" and out[3][1]["Retry-After"] == "5"
    req = s.request.ServeRequest(uid=3, prompt=s.request.as_prompt([1, 2]),
                                 max_new_tokens=4, submitted_at=1.0)
    req.generated = [5, 6]
    out.append(P.terminal_record(req, state="cancelled",
                                 finish_reason="server_shutdown"))
    return out


def _sse(s):
    P = s.protocol
    frames = (P.sse_event({"token": 5, "index": 0}, event="token")
              + P.sse_event({"note": "no event name"})
              + P.sse_event({"state": "completed"}, event="end"))
    assert frames.startswith(b"event: token\ndata: ")
    assert frames.endswith(b"\n\n")
    evs = list(P.iter_sse(io.BytesIO(frames)))
    assert [e["event"] for e in evs] == ["token", None, "end"]
    return frames, evs


@pytest.mark.parametrize("scenario", [_parse, _priority, _status_mapping,
                                      _sse],
                         ids=lambda f: f.__name__.strip("_"))
def test_protocol_matches_reference(sides, scenario):
    both(sides, scenario)


def test_frontend_config_block_consumed():
    """``serving.frontend`` / ``serving.router`` ride the root config; the
    front-end builder needs the explicit enable."""
    from deepspeed_tpu_torch.config import from_config
    from deepspeed_tpu_torch.serving import ServingFrontend

    class _Backend:
        health = "ready"

        def report(self):
            return {}

    cfg = from_config({"train_batch_size": 8, "serving": {
        "enabled": True, "frontend": {"enabled": True, "api_keys": {"k": 3}},
        "router": {"failover_attempts": 2}}})
    assert cfg.serving.router.failover_attempts == 2
    assert cfg.serving.router.migrate_on_drain
    fe = ServingFrontend.from_deepspeed_config(_Backend(), cfg)
    try:
        assert fe.cfg.api_keys == {"k": 3}
    finally:
        fe.close()
    with pytest.raises(ValueError, match="serving.frontend.enabled"):
        ServingFrontend.from_deepspeed_config(
            _Backend(), from_config({"train_batch_size": 8}))


# ---------------------------------------------------------------------------
# HTTP over real sockets (tiny engines)
# ---------------------------------------------------------------------------

def _unary_on_shared_mux(s):
    reg = s.obs.MetricsRegistry()
    b = s.ContinuousBatcher(s.engine("a"), s.cfg(
        prefill_chunk=32, default_max_new_tokens=4), registry=reg)
    rep = s.Replica("solo", b).start()
    try:
        with s.ServingFrontend(rep, fe_cfg(s), registry=reg) as fe:
            cli = s.GenerateClient(fe.url, timeout_s=60)
            out = cli.generate(list(range(1, 17)), max_new_tokens=3)
            assert out["span"]["ttft_ms"] is not None
            conn = http.client.HTTPConnection(fe.server.host,
                                              fe.server.port, timeout=10)
            conn.request("GET", "/metrics")
            scrape = conn.getresponse()
            text = scrape.read().decode()
            conn.request("GET", "/readyz")
            ready = conn.getresponse()
            ready.read()
            conn.close()
            assert "serving_queue_depth" in text
            state = cli.state()
            return (out["state"], out["tokens"], out["usage"], scrape.status,
                    'frontend_http_requests_total{code="200"} 1' in text,
                    ready.status, state["health"])
    finally:
        rep.close()


def _queue_full_429(s):
    b = batcher(s, max_queue_depth=2, retry_after_s=0.5)
    rep = s.Replica("solo", b).start()
    rep.paused = True
    try:
        with s.ServingFrontend(rep, fe_cfg(s)) as fe:
            for _ in range(2):
                rep.submit(list(range(8)), max_new_tokens=2)
            with pytest.raises(s.FrontendError) as ei:
                s.GenerateClient(fe.url, timeout_s=30).generate(
                    list(range(8)), max_new_tokens=2)
            e = ei.value
        rep.paused = False
        _wait(lambda: rep.stats["active"] == 0
              and rep.stats["queue_depth"] == 0)
        assert e.retry_after_s >= 1 and e.body["error"]["retry_after_s"] > 0.5
        return (e.status, e.retryable, e.retry_after_s,
                e.body["error"]["reason"], e.body["error"]["retry_after_s"])
    finally:
        rep.close()


def _streaming_sse(s):
    rep = s.Replica("solo", batcher(s)).start()
    try:
        with s.ServingFrontend(rep, fe_cfg(s)) as fe:
            conn = http.client.HTTPConnection(fe.server.host, fe.server.port,
                                              timeout=60)
            conn.request("POST", s.protocol.GENERATE_PATH, body=json.dumps(
                {"prompt": list(range(1, 13)), "max_new_tokens": 3,
                 "stream": True}),
                headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            head = (resp.status, resp.getheader("Content-Type"),
                    resp.getheader("Transfer-Encoding"))
            evs = list(s.protocol.iter_sse(resp))
            conn.close()
        tokens = [e["data"]["token"] for e in evs if e["event"] == "token"]
        end = evs[-1]
        assert head[0] == 200 and head[2] == "chunked"
        assert end["event"] == "end" and end["data"]["tokens"] == tokens
        return head, [e["event"] for e in evs], tokens, end["data"]["state"]
    finally:
        rep.close()


def _deadline_504(s):
    rep = s.Replica("solo", batcher(s)).start()
    try:
        with s.ServingFrontend(rep, fe_cfg(s)) as fe:
            with pytest.raises(s.FrontendError) as ei:
                s.GenerateClient(fe.url, timeout_s=60).generate(
                    list(range(1, 97)), max_new_tokens=8, deadline_s=0.001)
        _wait(lambda: rep.stats["active"] == 0
              and rep.stats["queue_depth"] == 0)
        return ei.value.status, ei.value.body["error"]["reason"], \
            ei.value.body["state"]
    finally:
        rep.close()


def _routes_away_from_draining(s):
    r0 = s.Replica("r0", batcher(s, "a", max_queue_depth=2))
    r1 = s.Replica("r1", batcher(s, "b", max_queue_depth=2))
    router = s.ReplicaRouter([r0, r1], s.config.RouterConfig()).start()
    try:
        router.drain_replica("r1", "test")
        _wait(lambda: r1.stats["health"] == s.DRAINING)
        routable = r1.routable
        with s.ServingFrontend(router, fe_cfg(s)) as fe:
            out = s.GenerateClient(fe.url, timeout_s=60).generate(
                list(range(1, 9)), max_new_tokens=2)
            _wait(lambda: router.health == "ready")
            r0.paused = True
            for _ in range(2):
                r0.submit(list(range(8)), max_new_tokens=2)
            with pytest.raises(s.FrontendError) as ei:
                s.GenerateClient(fe.url, timeout_s=30).generate(
                    list(range(8)), max_new_tokens=2)
            r0.paused = False
            _wait(lambda: r0.stats["active"] == 0
                  and r0.stats["queue_depth"] == 0)
        assert not routable and ei.value.retry_after_s is not None
        return (routable, out["state"], out["tokens"], ei.value.status,
                dict(router.counters))
    finally:
        router.close()


def _storm_and_sigterm_drain(s):
    """N concurrent mixed-priority clients against a 2-replica router: >= 1
    429 + Retry-After under an induced shed_storm, then a SIGTERM drain of
    r0 migrates its queued requests to r1; every admitted uid resolves."""
    b0 = batcher(s, "a", max_queue_depth=8, default_max_new_tokens=3)
    b1 = batcher(s, "b", max_queue_depth=8, default_max_new_tokens=3)
    r0, r1 = s.Replica("r0", b0), s.Replica("r1", b1)
    router = s.ReplicaRouter([r0, r1], s.config.RouterConfig()).start()
    fe = s.ServingFrontend(router, fe_cfg(
        s, api_keys={"gold": 5}, max_header_priority=4)).start()
    results, lock = [], threading.Lock()

    def unary(i, key=None):
        cli = s.GenerateClient(fe.url, api_key=key, timeout_s=JOIN_S)
        try:
            out = cli.generate(list(range(1, 10 + i % 3)), max_new_tokens=3,
                               priority=(i % 2) * 3 if key is None
                               else None)
            with lock:
                results.append(("ok", out))
        except s.FrontendError as e:
            with lock:
                results.append(("err", e))

    def streamer(i):
        try:
            evs = list(s.GenerateClient(fe.url, timeout_s=JOIN_S).stream(
                list(range(1, 12)), max_new_tokens=3))
            with lock:
                results.append(("stream", evs))
        except s.FrontendError as e:
            with lock:
                results.append(("err", e))

    try:
        r0.paused = r1.paused = True
        storm = [threading.Thread(target=unary, args=(i, None))
                 for i in range(20)]
        for t in storm:
            t.start()
        _wait(lambda: r0.stats["queue_depth"] + r1.stats["queue_depth"]
              + sum(1 for r in results if r[0] == "err") >= 20)
        s.injector([{"kind": "shed_storm", "times": 2}])
        r0.paused = r1.paused = False
        _join(storm)
        s.injector(None)
        errs = [r[1] for r in results if r[0] == "err"]
        reasons = {(e.body.get("error") or {}).get("reason") for e in errs}
        assert errs and all(e.status == 429 and e.retry_after_s >= 1
                            for e in errs)
        assert "shed_storm" in reasons
        for e in errs:
            if "id" in e.body:
                assert router.resolve(e.body["id"]) in TERMINAL
        phase1 = (len(errs), len(results))

        results.clear()
        r0.paused = r1.paused = True
        wave = ([threading.Thread(target=unary, args=(i, "gold"))
                 for i in range(4)]
                + [threading.Thread(target=streamer, args=(i,))
                   for i in range(4)])
        for t in wave:
            t.start()
        _wait(lambda: r0.stats["queue_depth"] + r1.stats["queue_depth"]
              >= 8)
        queued_r0 = r0.stats["queue_depth"]
        assert queued_r0 >= 1
        router.install_signal_handlers(drain="r0")
        os.kill(os.getpid(), signal.SIGTERM)
        _wait(lambda: router.counters["migrated"]
              + router.counters["migration_failed"] >= queued_r0)
        r0.paused = r1.paused = False
        _join(wave)
        oks = [r[1] for r in results if r[0] == "ok"]
        streams = [r[1] for r in results if r[0] == "stream"]
        assert len(oks) == 4 and len(streams) == 4
        for out in oks:
            assert out["state"] == "completed" and len(out["tokens"]) == 3
            assert router.resolve(out["id"]) == "completed"
        for evs in streams:
            assert evs[-1]["event"] == "end"
            assert evs[-1]["data"]["state"] == "completed"
        conn = http.client.HTTPConnection(fe.server.host, fe.server.port,
                                          timeout=10)
        conn.request("GET", "/readyz")
        ready = conn.getresponse().status
        conn.close()
        _wait(lambda: r1.stats["active"] == 0
              and r1.stats["queue_depth"] == 0)
        return (phase1[1], router.counters["migrated"] >= 1, ready,
                r0.stats["health"], len(oks), len(streams))
    finally:
        s.injector(None)
        router.restore_signal_handlers()
        fe.close()
        fe.close()
        router.close()
        router.close()


@pytest.mark.parametrize("scenario", [
    _unary_on_shared_mux, _queue_full_429, _streaming_sse, _deadline_504,
    _routes_away_from_draining, _storm_and_sigterm_drain],
    ids=lambda f: f.__name__.strip("_"))
def test_http_matches_reference(sides, scenario):
    both(sides, scenario)


# ---------------------------------------------------------------------------
# cancellation: server timeout and client disconnect reach backend.cancel
# ---------------------------------------------------------------------------

class _StallBackend:
    """Admits and never resolves; ``cancel`` records the uid and can be
    armed to raise."""
    health = "ready"

    def __init__(self, cancel_raises=None):
        self.cancelled = []
        self.submitted = []
        self._raise = cancel_raises

    def submit(self, prompt, *, max_new_tokens=None, deadline_s=None,
               priority=0, events=None, trace_id=None):
        self.submitted.append(prompt)
        return 42

    def cancel(self, uid):
        self.cancelled.append(uid)
        if self._raise is not None:
            raise self._raise
        return True

    def report(self):
        return {}


class _ChattyBackend(_StallBackend):
    """Streams token events until cancelled."""

    def submit(self, prompt, *, max_new_tokens=None, deadline_s=None,
               priority=0, events=None, trace_id=None):
        def pump():
            i = 0
            while not self.cancelled and i < 100_000:
                events.put({"event": "token", "token": 1, "index": i})
                i += 1
                time.sleep(0.001)

        threading.Thread(target=pump, daemon=True).start()
        return 42


def _unary_server_timeout(s):
    be = _StallBackend()
    with s.ServingFrontend(be, fe_cfg(s, request_timeout_s=0.1)) as fe:
        with pytest.raises(s.FrontendError) as ei:
            s.GenerateClient(fe.url, timeout_s=30).generate([1, 2, 3])
    return ei.value.status, ei.value.body["error"]["type"], be.cancelled


def _stream_timeout_cancel_raises(s):
    be = _StallBackend(cancel_raises=RuntimeError("backend gone"))
    with s.ServingFrontend(be, fe_cfg(s, request_timeout_s=0.1)) as fe:
        conn = http.client.HTTPConnection(fe.server.host, fe.server.port,
                                          timeout=30)
        conn.request("POST", s.protocol.GENERATE_PATH,
                     body=json.dumps({"prompt": [1], "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        evs = list(s.protocol.iter_sse(resp))
        conn.close()
    return resp.status, be.cancelled, evs[-1]["event"], \
        evs[-1]["data"]["finish_reason"]


def _unary_client_disconnect(s):
    be = _StallBackend()
    with s.ServingFrontend(be, fe_cfg(s)) as fe:
        conn = http.client.HTTPConnection(fe.server.host, fe.server.port,
                                          timeout=30)
        conn.request("POST", s.protocol.GENERATE_PATH,
                     body=json.dumps({"prompt": [1]}),
                     headers={"Content-Type": "application/json"})
        time.sleep(0.2)
        conn.sock.close()
        conn.close()
        _wait(lambda: be.cancelled == [42], timeout=30)
    return be.cancelled


def _bad_content_length(s):
    be = _StallBackend()
    with s.ServingFrontend(be, fe_cfg(s)) as fe:
        sock = socket.create_connection((fe.server.host, fe.server.port),
                                        timeout=10)
        sock.sendall(b"POST " + s.protocol.GENERATE_PATH.encode()
                     + b" HTTP/1.1\r\nHost: x\r\nContent-Length: abc\r\n\r\n")
        status = sock.recv(4096).split(b"\r\n", 1)[0]
        sock.close()
    assert b" 400 " in status, status
    return status, be.submitted, be.cancelled


def _stream_client_disconnect(s):
    be = _ChattyBackend()
    with s.ServingFrontend(be, fe_cfg(s)) as fe:
        conn = http.client.HTTPConnection(fe.server.host, fe.server.port,
                                          timeout=30)
        conn.request("POST", s.protocol.GENERATE_PATH,
                     body=json.dumps({"prompt": [1], "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read(64)
        conn.sock.close()
        conn.close()
        _wait(lambda: be.cancelled == [42], timeout=30)
    return resp.status, be.cancelled


def _route_reads_hold_the_lock(s):
    class _StubReplica:
        def __init__(self, name):
            self.name = name
            self.incarnation = 0
            self.cancelled = []
            self.resolved = []

        def cancel(self, uid):
            self.cancelled.append(uid)
            return True

        def resolve(self, uid):
            self.resolved.append(uid)
            return "completed"

    rep = _StubReplica("r0")
    router = s.ReplicaRouter([rep], s.config.RouterConfig())

    class _LockAssertingRoutes(dict):
        def get(self, key, default=None):
            assert router._lock.locked()
            return super().get(key, default)

    routes = _LockAssertingRoutes()
    routes[7] = s.router._Route("r0", rep.incarnation, 42, None)
    router._routes = routes
    out = (router.cancel(7), rep.cancelled, router.resolve(7), rep.resolved,
           router.cancel(999), router.resolve(999))
    assert out == (True, [42], "completed", [42], False, None)
    return out


@pytest.mark.parametrize("scenario", [
    _unary_server_timeout, _stream_timeout_cancel_raises,
    _unary_client_disconnect, _bad_content_length,
    _stream_client_disconnect, _route_reads_hold_the_lock],
    ids=lambda f: f.__name__.strip("_"))
def test_cancellation_matches_reference(sides, scenario):
    both(sides, scenario)


@pytest.mark.parametrize("scenario", ["deadline-storm", "sigterm-drain",
                                      "frontend-storm", "slo-storm"])
def test_serve_drill_passes_on_the_cpu(scenario, tmp_path):
    """The port's drill tool (``deepspeed_tpu_torch/tools/serve_drill.py``)
    holds its invariants on the CPU."""
    from deepspeed_tpu_torch.tools.serve_drill import run_scenario

    verdict = run_scenario(scenario, workdir=str(tmp_path), device="cpu")
    assert verdict["ok"], verdict


# ---------------------------------------------------------------------------
# chip_smoke's phase 11 (the serving stack) at a tiny width on the CPU
# ---------------------------------------------------------------------------

SERVING_TINY = dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                    intermediate_size=128, vocab_size=512, dtype="float32",
                    param_dtype="float32")


@pytest.fixture
def tiny_serving(monkeypatch):
    """Phase 11 on the CPU: launches are counted on the card only, and the
    traffic is cut to keep the suite's time (prompts of 40-120 tokens in
    32-token chunks, max_seq_len 512, 4 new tokens; the held requests of
    (b) and (d) keep 12, more than the 4 steps a replica's later prompt
    prefills while its earlier one decodes, so both still decode when the
    replica freezes)."""
    import chip_smoke

    for name, value in (("SERVING_KERNELS", ()), ("SERVING_MAX_SEQ", 512),
                        ("SERVING_CHUNK", 32), ("SERVING_PROMPTS", (40, 120)),
                        ("SERVING_NEW", 4), ("SERVING_HELD_NEW", 12),
                        ("SERVING_JOIN_S", 120.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


def _tiny_model():
    from deepspeed_tpu_torch import TransformerLM, get_preset

    model = TransformerLM(get_preset("llama3-8b", **SERVING_TINY))
    return model, model.init(seed=0, device="cpu")


def test_serving_phase_runs_on_a_tiny_cpu_model(tiny_serving):
    """Every gate of phase 11 that runs off the card passes: tokens over
    HTTP within the teacher-forced gate, SSE tokens equal to the end
    record's, a paused batch request resumed and completed, 429 with
    Retry-After and 504, a SIGTERM drain whose in-flight requests finish
    on the draining replica and whose queued ones move to the other,
    nothing leaked after a part."""
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    from deepspeed_tpu_torch.ops import paged_attention as tpa

    model, tree = _tiny_model()
    counts = tiny_serving.serving(torch, tpa, tfa, _build.KERNELS,
                                  _build.reset_counts, model, tree,
                                  device="cpu")
    assert counts == {}


def test_serving_gap_gate_sees_a_wrong_token(tiny_serving):
    """The least likely token in place of a served one reads far past
    ``SPEC_GAP_SD``; the served tokens themselves read 0."""
    from deepspeed_tpu_torch import InferenceEngineV2

    model, tree = _tiny_model()
    eng = InferenceEngineV2(model, tree, max_sequences=8, max_seq_len=256,
                            block_size=16, device="cpu")
    prompt = np.arange(1, 60, dtype=np.int32)
    out = eng.put([0], [prompt])[0]
    toks = [int(np.argmax(out))]
    for _ in range(5):
        toks.append(int(np.argmax(eng.put([0], [np.asarray(
            [toks[-1]], np.int32)])[0])))
    eng.flush([0])
    gaps = tiny_serving.teacher_forced_gaps(eng, {"ok": (prompt, toks)})
    assert gaps["ok"] <= 1e-4
    lg = eng.put([1], [np.concatenate([prompt, toks[:2]]).astype(
        np.int32)])[1]
    eng.flush([1])
    bad = toks[:2] + [int(np.argmin(lg))] + toks[3:]
    gaps = tiny_serving.teacher_forced_gaps(eng, {"bad": (prompt, bad)})
    assert gaps["bad"] > 4 * tiny_serving.SPEC_GAP_SD
    assert pool_whole(eng)
