"""The port's metrics registry, ``/metrics`` exposition, profile trigger,
registry-to-monitor bridge, comms logger and timers
(``deepspeed_tpu_torch.observability``, ``comm.logger``, ``utils.timer``)
against the JAX package's on the CPU.

Each case runs one call sequence through both packages with the same
injected clock and requires the same result: the registry's JSON snapshot
and Prometheus text, the bridge's events, the trigger's capture lifecycle
and counters, the comms logger's registry families. The cases of the
reference's ``tests/unit/test_observability.py`` run on the port
(including its Prometheus grammar validator), the HTTP server binds
127.0.0.1 on port 0, and the trigger's default ``torch.profiler`` capture
runs once on the CPU and writes its Chrome trace.
"""

import http.client
import json
import math
import os
import re
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import deepspeed_tpu.comm.logger as ref_comm
import deepspeed_tpu.observability as ref_obs
import deepspeed_tpu_torch.comm.logger as port_comm
import deepspeed_tpu_torch.observability as port_obs
from tests._torch_threads import one_torch_thread  # noqa: F401

PKGS = {"ref": ref_obs, "port": port_obs}


# ---------------------------------------------------------------------------
# the reference test file's Prometheus text-format (0.0.4) validator
# ---------------------------------------------------------------------------

_METRIC = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE_RE = re.compile(
    rf'^({_METRIC})'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:\\.|[^"\\])*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:\\.|[^"\\])*")*\})?'
    r' (-?[0-9.eE+-]+|\+Inf|-Inf|NaN)$')
_HELP_RE = re.compile(rf"^# HELP ({_METRIC}) .*$")
_TYPE_RE = re.compile(rf"^# TYPE ({_METRIC}) "
                      r"(counter|gauge|histogram|summary|untyped)$")


def validate_prometheus(text: str) -> dict:
    """Parse exposition text into {metric: [(labels, value)]}; any grammar
    break, non-monotone histogram bucket or +Inf bucket != _count fails."""
    samples: dict = {}
    typed: dict = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            m = _HELP_RE.match(line) or _TYPE_RE.match(line)
            assert m, f"bad comment line: {line!r}"
            if line.startswith("# TYPE"):
                tm = _TYPE_RE.match(line)
                typed[tm.group(1)] = tm.group(2)
            continue
        m = _SAMPLE_RE.match(line)
        assert m, f"bad sample line: {line!r}"
        samples.setdefault(m.group(1), []).append((m.group(2) or "",
                                                   m.group(4)))
    for fam, kind in typed.items():
        if kind != "histogram":
            continue
        buckets = samples.get(f"{fam}_bucket", [])
        counts = samples.get(f"{fam}_count", [])
        assert buckets and counts and f"{fam}_sum" in samples, fam
        by_series: dict = {}
        for labels, value in buckets:
            le = re.search(r'le="([^"]*)"', labels).group(1)
            rest = re.sub(r'le="[^"]*",?', "", labels).strip("{},")
            by_series.setdefault(rest, []).append((le, float(value)))
        for rest, bs in by_series.items():
            vals = [v for _le, v in bs]
            assert vals == sorted(vals), f"{fam} buckets not monotone"
            assert bs[-1][0] == "+Inf", f"{fam} missing +Inf bucket"
            total = [float(v) for labels, v in counts
                     if labels.strip("{}") == rest]
            assert total and total[0] == vals[-1], fam
    return samples


# ---------------------------------------------------------------------------
# registry: one call sequence through both packages
# ---------------------------------------------------------------------------

def _registry_script(obs, clock):
    """Counters, gauges and histograms (default and custom bounds, label
    sets, overflow into +Inf, a rolled window) on a fresh registry whose
    creation time comes from ``clock``."""
    import deepspeed_tpu.observability.registry as rr
    import deepspeed_tpu_torch.observability.registry as pr

    mod = rr if obs is ref_obs else pr
    real = mod.time.time
    mod.time.time = clock
    try:
        r = obs.MetricsRegistry()
    finally:
        mod.time.time = real
    c = r.counter("serving/shed_total", "sheds by reason",
                  labels={"reason": "kv"})
    c.inc(2)
    r.counter("serving/shed_total", labels={"reason": 'q"u\\ote\n'}).inc()
    r.counter("x/n").inc(0.5)
    g = r.gauge("serving/kv_occupancy", "pool occupancy [0, 1]")
    g.set(0.5)
    g.inc(0.125)
    r.gauge("9lead/digit").set(-3)
    h = r.histogram("serving/ttft_ms", "ttft")
    xs = np.random.default_rng(0).lognormal(2.0, 1.5, 500)
    for v in list(xs) + [1e9, 0.0]:
        h.observe(float(v))
    hb = r.histogram("x/lat_ms", bounds=obs.exponential_bounds(1.0, 2.0, 10),
                     labels={"tier": "host"})
    for v in (1.0, 3.0, 1000.0, 5.5):
        hb.observe(v)
    w = obs.HistogramWindow(h)
    w.roll()
    for _ in range(40):
        h.observe(77.0)
    window = [w.count, w.percentile(50), w.percentile(99)]
    w.roll()
    window += [w.count, w.percentile(90)]
    out = {
        "snapshot": r.snapshot(),
        "json": r.render_json(),
        "prometheus": r.render_prometheus(),
        "percentiles": [h.percentile(q) for q in (0, 1, 50, 90, 99, 100)],
        "window": window,
        "created_at": r.created_at,
        "families": [f.name for f in r.collect()],
    }
    for bad in (lambda: c.inc(-1), lambda: r.gauge("x/n"),
                lambda: r.counter("x/bad", labels={"a-b": 1}),
                lambda: r.histogram("x/h2", bounds=[2.0, 1.0])):
        try:
            bad()
            out.setdefault("errors", []).append(None)
        except ValueError as e:
            out.setdefault("errors", []).append(str(e))
    return out


def test_registry_snapshot_and_prometheus_equal_reference():
    got = {k: _registry_script(m, lambda: 1234.5) for k, m in PKGS.items()}
    assert got["port"] == got["ref"]
    validate_prometheus(got["port"]["prometheus"])
    json.loads(got["port"]["json"])
    assert got["port"]["created_at"] == 1234.5


def test_process_registry_swap_matches_reference():
    """``set_registry(None)`` installs a fresh registry, ``get_registry``
    returns it, and an explicit registry is installed as given."""
    for obs in PKGS.values():
        old = obs.get_registry()
        try:
            fresh = obs.set_registry(None)
            assert fresh is obs.get_registry() and fresh is not old
            assert list(fresh.collect()) == []
            mine = obs.MetricsRegistry()
            assert obs.set_registry(mine) is mine is obs.get_registry()
        finally:
            obs.set_registry(old)
    assert port_obs.exponential_bounds() == ref_obs.exponential_bounds()
    assert port_obs.exponential_bounds(0.5, 3.0, 7) == \
        ref_obs.exponential_bounds(0.5, 3.0, 7)


# ---------------------------------------------------------------------------
# the reference's registry cases, on the port
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_counter_monotonic_and_labeled_series(self):
        r = port_obs.MetricsRegistry()
        c = r.counter("x/reqs", "requests", labels={"kind": "a"})
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        with pytest.raises(ValueError):
            c.inc(-1)
        assert r.counter("x/reqs", labels={"kind": "b"}).value == 0.0
        assert r.counter("x/reqs", labels={"kind": "a"}) is c

    def test_type_conflict_raises(self):
        r = port_obs.MetricsRegistry()
        r.counter("x/n")
        with pytest.raises(ValueError, match="already registered"):
            r.gauge("x/n")

    def test_histogram_percentiles_bounded_by_min_max(self):
        r = port_obs.MetricsRegistry()
        h = r.histogram("x/lat_ms",
                        bounds=port_obs.exponential_bounds(1.0, 2.0, 10))
        xs = np.random.default_rng(0).lognormal(2.0, 0.8, 2000)
        for x in xs:
            h.observe(float(x))
        assert h.count == 2000
        assert math.isclose(h.sum, float(np.sum(xs)), rel_tol=1e-9)
        p50, p95, p99 = (h.percentile(q) for q in (50, 95, 99))
        assert xs.min() <= p50 <= p95 <= p99 <= xs.max()
        assert abs(p50 - float(np.percentile(xs, 50))) \
            <= 0.5 * float(np.percentile(xs, 50))

    def test_empty_histogram_is_zero(self):
        h = port_obs.MetricsRegistry().histogram("x/empty")
        assert h.percentile(99) == 0.0 and h.count == 0

    def test_histogram_window_sees_a_fresh_regression(self):
        h = port_obs.MetricsRegistry().histogram("x/lat_ms")
        for _ in range(10_000):
            h.observe(2.0)
        w = port_obs.HistogramWindow(h)
        w.roll()
        w.roll()
        for _ in range(100):
            h.observe(20.0)
        assert h.percentile(50) < 4.0
        assert w.percentile(50) > 10.0 and w.count == 100
        w2 = port_obs.HistogramWindow(h)
        assert w2.count == 0 and w2.percentile(99) == 0.0

    def test_render_prometheus_parses_and_sanitizes_names(self):
        r = port_obs.MetricsRegistry()
        r.counter("serving/shed_total", "s", labels={"reason": "kv"}).inc(2)
        r.gauge("serving/kv_occupancy").set(0.5)
        h = r.histogram("serving/ttft_ms", "ttft")
        for v in (1.0, 3.0, 1000.0, 1e9):
            h.observe(v)
        samples = validate_prometheus(r.render_prometheus())
        assert samples["serving_shed_total_total"] == [('{reason="kv"}',
                                                        "2")]
        assert "serving_ttft_ms_bucket" in samples
        snap = r.snapshot()
        json.dumps(snap)
        assert snap["serving/ttft_ms"]["series"][0]["count"] == 4


def test_serving_metrics_families_equal_reference():
    """``ServingMetrics`` builds the same families, children and values."""
    snaps = {}
    for k, obs in PKGS.items():
        r = obs.MetricsRegistry()
        m = obs.ServingMetrics(r)
        m.record_spec_round(4, 3)
        m.record_spec_round(0, 0)
        m.terminal("completed").inc()
        m.shed("kv").inc(2)
        m.rejected("queue_full").inc()
        m.preemption("batch").inc()
        m.migration("drain").inc()
        m.ttft_tier("interactive").observe(12.0)
        m.tpot_tier("batch").observe(3.0)
        m.set_health("degraded")
        m.set_queue_depths({0: 3, 2: 1})
        m.set_queue_depths({0: 1})
        m.set_queue_depth_tiers({"batch": 4})
        m.set_queue_depth_tiers({})
        snaps[k] = (r.snapshot(), r.render_prometheus())
        assert obs.HEALTH_CODES == {"starting": 0, "ready": 1,
                                    "degraded": 2, "draining": 3}
    assert snaps["port"] == snaps["ref"]


def test_package_exports_the_reference_names():
    assert sorted(port_obs.__all__) == sorted(ref_obs.__all__)
    for name in port_obs.__all__:
        assert getattr(port_obs, name) is not getattr(ref_obs, name)


# ---------------------------------------------------------------------------
# exposition + probes (127.0.0.1, port 0)
# ---------------------------------------------------------------------------

def _get(url):
    try:
        resp = urllib.request.urlopen(url, timeout=5)
        return resp.status, resp.read().decode(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers


class TestExposition:
    def test_probe_mapping_equals_reference(self):
        for h in (None, "ready", "degraded", "starting", "draining",
                  "READY", "bogus"):
            assert port_obs.probe_status(h) == ref_obs.probe_status(h)
        assert port_obs.READY_STATES == ref_obs.READY_STATES
        assert port_obs.LIVE_STATES == ref_obs.LIVE_STATES

    def test_http_endpoints_flip_with_health_and_serve_the_registry(self):
        r = port_obs.MetricsRegistry()
        r.gauge("x/g").set(1.0)
        r.histogram("x/h").observe(2.0)
        state = ["starting"]
        with port_obs.ObservabilityServer(r, health_fn=lambda: state[0]) \
                as srv:
            assert srv.host == "127.0.0.1" and srv.port > 0
            assert _get(srv.url + "/healthz")[0] == 200
            assert _get(srv.url + "/readyz")[0] == 503
            for st, code in (("ready", 200), ("degraded", 200),
                             ("draining", 503)):
                state[0] = st
                assert _get(srv.url + "/readyz")[0] == code
            assert _get(srv.url + "/healthz")[0] == 200
            code, body, headers = _get(srv.url + "/metrics")
            assert code == 200 and body == r.render_prometheus()
            assert headers["Content-Type"].startswith("text/plain; "
                                                      "version=0.0.4")
            validate_prometheus(body)
            code, body, _ = _get(srv.url + "/metrics.json")
            assert code == 200 and json.loads(body) == json.loads(
                r.render_json())
            code, body, _ = _get(srv.url + "/v1/trace")
            assert code == 200 and port_obs.validate_trace(
                json.loads(body)) == []
            assert _get(srv.url + "/nope")[0] == 404
        assert srv.closed
        srv.close()                           # idempotent
        with pytest.raises(RuntimeError, match="already closed"):
            srv.start()

    def test_route_error_before_commit_maps_to_500(self):
        srv = port_obs.ObservabilityServer(port_obs.MetricsRegistry())
        srv.mount("GET", "/boom", lambda h: 1 / 0)
        with srv:
            code, body, _ = _get(srv.url + "/boom")
            assert code == 500
            assert json.loads(body)["error"]["type"] == "internal"

    def test_route_error_after_commit_drops_connection(self):
        srv = port_obs.ObservabilityServer(port_obs.MetricsRegistry())

        def boom(handler):
            handler.begin_chunked(200, "text/event-stream")
            handler.write_chunk(b"data: one\n\n")
            raise RuntimeError("mid-stream failure")

        srv.mount("GET", "/boom", boom)
        with srv:
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=10)
            conn.request("GET", "/boom")
            resp = conn.getresponse()
            assert resp.status == 200
            try:
                raw = resp.read()
            except (http.client.IncompleteRead, ConnectionError) as e:
                raw = getattr(e, "partial", b"")
            conn.close()
            assert b"data: one" in raw
            assert b"500" not in raw and b"internal" not in raw

    def test_mounted_post_route_and_unknown_post(self):
        srv = port_obs.ObservabilityServer(port_obs.MetricsRegistry())

        def echo(handler):
            n = int(handler.headers["Content-Length"])
            handler._send(200, handler.rfile.read(n).decode(),
                          "application/json")

        srv.mount("post", "/v1/echo", echo)
        with srv:
            req = urllib.request.Request(srv.url + "/v1/echo",
                                         data=b'{"a": 1}', method="POST")
            with urllib.request.urlopen(req, timeout=5) as resp:
                assert json.loads(resp.read()) == {"a": 1}
            req = urllib.request.Request(srv.url + "/v1/none", data=b"x",
                                         method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=5)
            assert e.value.code == 404


# ---------------------------------------------------------------------------
# profile trigger: the lifecycle against the reference's, one clock
# ---------------------------------------------------------------------------

def _trigger_script(obs, tmp_path, tag):
    """Arm, warm-up hold, capture, rate limit, trigger file, a failed start
    and a failed stop. Returns the lifecycle with paths made relative."""
    root = os.path.join(str(tmp_path), tag)
    now = [0.0]
    events = []
    fail = {"start": False, "stop": False}

    def start(d):
        if fail["start"]:
            raise OSError("no profiler")
        events.append(("start", os.path.relpath(d, root)))

    def stop():
        if fail["stop"]:
            raise OSError("stop failed")
        events.append(("stop",))

    t = obs.ProfileTrigger(root, capture_steps=2, rate_limit_s=100.0,
                           warmup_steps=2, clock=lambda: now[0],
                           start_fn=start, stop_fn=stop)
    log = []
    t.arm()
    for step in range(1, 7):
        cap = t.check(step)
        log.append((step, t.capturing, cap and os.path.relpath(cap, root)))
    t.arm()
    log.append(("limited", t.check(7)))
    limited = dict(t.counters)
    now[0] = 150.0
    open(t.trigger_file, "w").close()
    log.append(("file", t.check(8), os.path.exists(t.trigger_file),
                t.capturing))
    fail["stop"] = True
    log.append(("stop-fails", t.check(10), t.capturing))
    fail["stop"] = False
    now[0] = 400.0
    fail["start"] = True
    t.arm()
    log.append(("start-fails", t.check(11), t.capturing))
    fail["start"] = False
    now[0] = 600.0
    t.arm()
    t.check(12)
    t.close()                                  # stops the open capture
    log.append(("closed", t.capturing))
    rep = t.report()
    rep["output_dir"] = os.path.relpath(rep["output_dir"], root)
    rep["trigger_file"] = os.path.relpath(rep["trigger_file"], root)
    return events, log, rep, limited


def test_profile_trigger_lifecycle_equals_reference(tmp_path):
    got = {k: _trigger_script(m, tmp_path, k) for k, m in PKGS.items()}
    assert got["port"] == got["ref"]
    events, log, rep, limited = got["port"]
    assert [e[0] for e in events] == ["start", "stop", "start", "start",
                                      "stop"]
    assert limited["suppressed_rate_limit"] == 1
    assert rep["counters"] == {"captures": 2, "suppressed_rate_limit": 1,
                               "capture_errors": 2}


class TestProfileTrigger:
    def _trigger(self, tmp_path, **kw):
        events = []
        t = port_obs.ProfileTrigger(
            str(tmp_path), start_fn=lambda d: events.append(("start", d)),
            stop_fn=lambda: events.append(("stop",)), **kw)
        return t, events

    def test_capture_spans_n_steps_and_is_rate_limited(self, tmp_path):
        now = [0.0]
        t, events = self._trigger(tmp_path, capture_steps=3, warmup_steps=0,
                                  rate_limit_s=100.0, clock=lambda: now[0])
        t.arm()
        assert t.check(1) is None and t.capturing
        t.check(2)
        t.check(3)
        cap = t.check(4)
        assert cap and cap.startswith(str(tmp_path))
        assert [e[0] for e in events] == ["start", "stop"]
        assert t.counters["captures"] == 1
        t.arm()
        t.check(5)
        assert not t.capturing and t.counters["suppressed_rate_limit"] == 1
        now[0] = 200.0
        t.arm()
        t.check(6)
        assert t.capturing

    def test_warmup_holds_the_arm_instead_of_dropping_it(self, tmp_path):
        t, _ = self._trigger(tmp_path, capture_steps=1, warmup_steps=3,
                             rate_limit_s=0.0)
        t.arm()
        for s in (1, 2, 3):
            t.check(s)
            assert not t.capturing
        t.check(4)
        assert t.capturing

    def test_trigger_file_is_consumed(self, tmp_path):
        t, _ = self._trigger(tmp_path, capture_steps=1, warmup_steps=0,
                             rate_limit_s=0.0)
        open(t.trigger_file, "w").close()
        t.check(1)
        assert t.capturing and not os.path.exists(t.trigger_file)

    def test_start_failure_is_contained(self, tmp_path):
        t = port_obs.ProfileTrigger(str(tmp_path), warmup_steps=0,
                                    start_fn=lambda d: 1 / 0,
                                    stop_fn=lambda: None)
        t.arm()
        assert t.check(1) is None and not t.capturing
        assert t.counters["capture_errors"] == 1

    def test_signal_arms_a_capture(self, tmp_path):
        import signal

        t, events = self._trigger(tmp_path, capture_steps=1, warmup_steps=0,
                                  rate_limit_s=0.0)
        t.install_signal_handler(signal.SIGUSR2)
        try:
            os.kill(os.getpid(), signal.SIGUSR2)
            t.check(1)
            assert t.capturing
        finally:
            t.close()
        assert signal.getsignal(signal.SIGUSR2) is not None

    def test_from_config_reads_the_port_section(self, tmp_path):
        from deepspeed_tpu_torch.config import ProfileTriggerConfig

        cfg = ProfileTriggerConfig.build(
            {"enabled": True, "output_dir": str(tmp_path),
             "capture_steps": 3, "rate_limit_s": 9.0, "warmup_steps": 1},
            "profile")
        t = port_obs.ProfileTrigger.from_config(cfg)
        assert (t.capture_steps, t.rate_limit_s, t.warmup_steps) == (3, 9.0,
                                                                     1)
        assert t.trigger_file == os.path.join(str(tmp_path), "TRIGGER")


def test_default_capture_writes_a_torch_profiler_trace(tmp_path):
    """The trigger's own start/stop: a ``torch.profiler`` session over two
    steps of CPU work, exported as a Chrome trace into the capture
    directory, naming the ops the steps ran."""
    from deepspeed_tpu_torch.observability.profiler import TRACE_FILE

    t = port_obs.ProfileTrigger(str(tmp_path), capture_steps=2,
                                warmup_steps=1, rate_limit_s=0.0)
    open(t.trigger_file, "w").close()
    x = torch.randn(64, 64)
    cap = None
    for step in range(1, 6):
        torch.mm(x, x)
        cap = t.check(step) or cap
    assert cap is not None and t.counters["captures"] == 1
    doc = json.load(open(os.path.join(cap, TRACE_FILE)))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "aten::mm" in names
    t.close()


# ---------------------------------------------------------------------------
# bridge, comms logger, timers
# ---------------------------------------------------------------------------

class _SinkMonitor:
    def __init__(self):
        self.events = []

    def write_events(self, events):
        self.events.extend(events)


def _bridge_script(obs):
    r = obs.MetricsRegistry()
    sink = _SinkMonitor()
    bridge = obs.MonitorBridge(sink, r, prefix="s/")
    other = obs.MonitorBridge(sink, r, exclude=("s/",))
    c = r.counter("s/n")
    r.counter("other/ignored").inc()
    h = r.histogram("s/lat_ms")
    lab = r.gauge("s/g", labels={"tier": "host", "a": "1"})
    c.inc(2)
    h.observe(4.0)
    lab.set(3.0)
    n = [bridge.flush(step=1), bridge.flush(step=2), other.flush(step=2)]
    c.inc()
    n += [bridge.flush(step=3)]
    h.observe(9.0)
    n += [bridge.flush(step=4), len(bridge.collect_events(5))]
    return sink.events, n


def test_bridge_flushes_only_changed_series_like_reference():
    got = {k: _bridge_script(m) for k, m in PKGS.items()}
    assert got["port"] == got["ref"]
    events, n = got["port"]
    tags = {t for t, _v, _s in events}
    assert ("s/n", 2.0, 1) in events
    assert {"s/lat_ms_count", "s/lat_ms_p50", "s/lat_ms_p95",
            "s/lat_ms_p99", "s/g.a=1.tier=host"} <= tags
    assert ("other/ignored", 1.0, 2) in events
    assert n[1] == 0 and n[3] == 1 and n[5] == 0


def test_comms_logger_exports_per_op_totals_like_reference():
    got = {}
    for k, (mod, obs) in {"ref": (ref_comm, ref_obs),
                          "port": (port_comm, port_obs)}.items():
        r = obs.MetricsRegistry()
        cl = mod.CommsLogger(enabled=True, prof_all=False,
                             prof_ops=["all_reduce", "all_gather_into_tensor"])
        cl.append("all_reduce", 1024, 0.001)
        cl.append("all_reduce", 1024)
        cl.append("broadcast", 99, 0.5)          # not profiled
        cl.append("all_gather_into_tensor", 512, 0.002)
        cl.export_to_registry(r)
        cl.export_to_registry(r)                  # deltas, not totals
        cl.append("all_reduce", 8)
        cl.export_to_registry(r)
        lat = cl.total_latency_s()
        summary = cl.log_summary()
        cl.reset()
        got[k] = (r.snapshot(), lat, summary, cl.total_latency_s(),
                  mod.comms_logger.enabled)
    assert got["port"] == got["ref"]
    snap = got["port"][0]
    assert snap["comm/all_reduce_calls"]["series"][0]["value"] == 3
    assert snap["comm/all_reduce_bytes"]["series"][0]["value"] == 2056
    assert got["port"][1] == pytest.approx(0.003)
    from deepspeed_tpu_torch.comm import comms_logger

    assert comms_logger is port_comm.comms_logger


def test_timers_measure_host_time_and_log(monkeypatch):
    """The wall-clock timers on the CPU (nothing to synchronise): elapsed,
    records, mean and reset; a ``ThroughputTimer`` over a fake clock counts
    only the steps after ``start_step`` (the reference's arithmetic)."""
    import deepspeed_tpu.utils.timer as rt
    import deepspeed_tpu_torch.utils.timer as pt

    got = {}
    for k, mod in (("ref", rt), ("port", pt)):
        clock = iter(float(i) for i in range(100))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        monkeypatch.setattr(mod, "_synchronize", lambda *a: None)
        w = mod.SynchronizedWallClockTimer()
        w("fwd").start()
        w("fwd").start()                      # no restart while running
        w("fwd").stop()
        w("fwd").start(synchronize=False)
        w("fwd").stop(record=False)
        rec = (w("fwd").elapsed(reset=False), list(w("fwd").records),
               w("fwd").mean(), w.has("fwd"), w.has("bwd"))
        w.log(["fwd", "bwd"], normalizer=2.0)
        tt = mod.ThroughputTimer(batch_size=8, start_step=2,
                                 steps_per_output=2)
        for _ in range(6):
            tt.start()
            tt.stop()
        got[k] = rec + (tt.global_step_count, tt.avg_samples_per_sec(),
                        w("fwd").elapsed())
    assert got["port"] == got["ref"]


def test_timer_synchronises_the_given_device(monkeypatch):
    import deepspeed_tpu_torch.utils.timer as pt

    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None:
                        seen.append(d))
    w = pt.SynchronizedWallClockTimer(torch.device("cpu"))
    w("a").start()
    w("a").stop()
    assert seen == []                         # the CPU runs eagerly
    w = pt.SynchronizedWallClockTimer("cuda:0")
    w("a").start()
    w("a").stop(synchronize=False)
    assert seen == ["cuda:0"]


# ---------------------------------------------------------------------------
# the config sections
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("section", [
    {}, {"enabled": False, "http_server": True, "http_port": 9100,
         "train_breakdown": True, "flush_interval_steps": 5},
    {"profile": {"enabled": True, "capture_steps": 3, "rate_limit_s": 10,
                 "trigger_file": "/tmp/t", "warmup_steps": 0},
     "tracing": {"enabled": True, "ring_size": 64, "sample": 4,
                 "dump_dir": "/tmp/d", "retain_terminal": 0}}])
def test_observability_section_equals_reference(section):
    """``from_config`` builds the ``observability`` section with the
    reference's fields and defaults (``wall_clock_breakdown`` too)."""
    from deepspeed_tpu.config import from_config as ref_from_config
    from deepspeed_tpu_torch.config import from_config

    base = {"train_batch_size": 8, "wall_clock_breakdown": True}
    port = from_config({**base, "observability": section})
    ref = ref_from_config({**base, "observability": section})
    assert port.wall_clock_breakdown is ref.wall_clock_breakdown is True
    want = ref.observability.model_dump()
    got = {k: getattr(port.observability, k) for k in want}
    for sub in ("profile", "tracing"):
        got[sub] = {k: getattr(got[sub], k) for k in want[sub]}
    assert got == want


@pytest.mark.parametrize("bad", [{"ring_size": 8}, {"sample": 0},
                                 {"retain_terminal": -1}])
def test_tracing_validator_equals_reference(bad):
    from deepspeed_tpu.config import from_config as ref_from_config
    from deepspeed_tpu_torch.config import from_config

    raw = {"train_batch_size": 8, "observability": {"tracing": bad}}
    with pytest.raises(ValueError) as e:
        from_config(raw)
    with pytest.raises(ValueError) as r:
        ref_from_config(raw)
    assert str(e.value) in str(r.value)
