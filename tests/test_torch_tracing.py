"""The port's event bus, Chrome-trace export and flight recorder
(``deepspeed_tpu_torch.observability.events`` / ``trace``) against the JAX
package's on the CPU.

One call sequence goes through both packages' buses with the same injected
clock: the recorded events, the exported trace (orphaned halves repaired
the same way), the validator's verdicts and the flight recorder's dump
must be equal. The cases of the reference's ``tests/unit/test_tracing.py``
(event bus, export grammar, flight recorder) run on the port.
"""

import itertools
import json
import os
import threading

import pytest

import deepspeed_tpu.observability as ref_obs
import deepspeed_tpu.observability.events as ref_events
import deepspeed_tpu.observability.trace as ref_trace
import deepspeed_tpu_torch.observability as port_obs
import deepspeed_tpu_torch.observability.events as port_events
import deepspeed_tpu_torch.observability.trace as port_trace
from tests._torch_threads import one_torch_thread  # noqa: F401

PKGS = {"ref": (ref_obs, ref_events, ref_trace),
        "port": (port_obs, port_events, port_trace)}


@pytest.fixture()
def clock(monkeypatch):
    """Both buses stamp events from one counter (µs 10, 20, ...)."""
    ticks = {}
    for k, (_, ev, _) in PKGS.items():
        it = itertools.count(10, 10)
        ticks[k] = it
        monkeypatch.setattr(ev.EventBus, "now_us",
                            staticmethod(lambda it=it: next(it)))
    return ticks


def _bus_script(obs, ev):
    """Sampling, spans (one raising), instants, async tracks, orphans on a
    bounded ring; returns the events and the exported document."""
    bus = ev.EventBus(enabled=True, ring_size=16, sample=3)
    minted = [bus.mint_trace() for _ in range(7)]
    ids = [bus.new_id() for _ in range(3)]
    t = minted[2]
    bus.async_begin("request", "request", t, parent_id=5, args={"uid": 1})
    with bus.span("engine", "put", args={"uids": [1]}):
        bus.instant("engine", "prefix_attach", args={"hit_tokens": 64})
        bus.async_instant("request", "first_token", t)
    try:
        with bus.span("engine", "decode_batch"):
            raise ValueError("boom")
    except ValueError:
        pass
    bus.end("engine", "stray")                 # E without B: dropped
    bus.begin("engine", "open")                # B without E: closed
    bus.async_end("kv_tier", "kv_fetch", 99)   # e without b: dropped
    bus.async_begin("kv_tier", "kv_fetch", ids[0])   # b without e: closed
    bus.async_end("request", "request", t, args={"state": "done"})
    for i in range(20):                        # overflow one ring
        bus.instant("storm", "evt", args={"i": i})
    off = ev.EventBus(enabled=False)
    off.instant("c", "n")
    with off.span("c", "s"):
        pass
    doc = obs.trace_export(bus)
    return {"minted": minted, "ids": ids,
            "events": [tuple(e) for e in bus.events()],
            "categories": bus.categories(), "stats": bus.stats(),
            "total": bus.total_events(), "trace": doc["traceEvents"],
            "other": {k: v for k, v in doc["otherData"].items()
                      if k != "source"},
            "valid": obs.validate_trace(doc),
            "off": (off.total_events(), off.mint_trace(),
                    off.span("c", "s") is off.span("c", "t"))}


def test_bus_events_and_export_equal_reference(clock):
    got = {k: _bus_script(obs, ev) for k, (obs, ev, _) in PKGS.items()}
    assert got["port"] == got["ref"]
    p = got["port"]
    assert p["valid"] == []
    assert p["minted"] == [None, None, 6, None, None, 12, None]
    assert p["total"] == len(p["events"]) and p["stats"]["events"][
        "storm"] == 16
    synth = [e for e in p["trace"]
             if e.get("args", {}).get("synthetic_end")]
    assert sorted(e["name"] for e in synth) == ["kv_fetch", "open"]
    assert not any(e["name"] == "stray" for e in p["trace"])
    assert p["off"] == (0, None, True)


def _validator_cases():
    base = {"cat": "c", "name": "n", "ts": 1, "pid": 1, "tid": 1}
    ok = [{**base, "ph": "B"}, {**base, "ph": "E", "ts": 2},
          {**base, "ph": "b", "id": 1}, {**base, "ph": "n", "id": 1},
          {**base, "ph": "e", "id": 1, "ts": 3},
          {"ph": "M", "name": "process_name"}]
    return [{}, {"traceEvents": {}},
            {"traceEvents": [{**base, "ph": "E"}]},
            {"traceEvents": [{**base, "ph": "b"}]},
            {"traceEvents": [{**base, "ph": "b", "id": 2}]},
            {"traceEvents": [{**base, "ph": "e", "id": 2}]},
            {"traceEvents": [{**base, "ph": "Z"}]},
            {"traceEvents": [{**base, "ph": "i", "ts": -5}]},
            {"traceEvents": [{**base, "ph": "i", "ts": "x"}]},
            {"traceEvents": [{"ph": "i"}, 7]},
            {"traceEvents": [{**base, "ph": "B"}, {**base, "ph": "B",
                                                   "tid": 2}]},
            {"traceEvents": ok}]


def test_validator_verdicts_equal_reference():
    for doc in _validator_cases():
        want = ref_obs.validate_trace(doc)
        assert port_obs.validate_trace(doc) == want
    assert port_obs.validate_trace(_validator_cases()[-1]) == []


def _recorder_script(obs, ev, tr, out_dir):
    bus = ev.EventBus(enabled=True)
    rec = tr.FlightRecorder(bus, out_dir, retain_terminal=3)
    bus.instant("resilience", "bad_step", args={"step": 3})
    with bus.span("train", "step"):
        pass
    for uid in range(5):
        rec.record_terminal(("m0", uid), {"uid": uid, "state": "completed"})
    p1 = rec.dump("abort/step 5", extra={"why": "test"}, key="abort-5")
    p2 = rec.dump("abort", key="abort-5")
    rec.reconfigure(retain_terminal=2)
    p3 = rec.dump("other")
    doc = json.load(open(p1))
    for k in ("wall_time", "pid"):
        doc.pop(k)
    doc["trace"].pop("otherData")
    return {"names": [os.path.basename(p).rsplit("_", 3)[0]
                      for p in (p1, p3)],
            "p2": p2, "dumps": rec.dumps, "doc": doc,
            "spans": sorted(rec.terminal_spans()),
            "lookup": [rec.terminal_trace(("m0", 4)),
                       rec.terminal_trace(("m0", 0))],
            "last": rec.last_path == p3}


def test_flight_recorder_dump_equals_reference(clock, tmp_path):
    got = {k: _recorder_script(obs, ev, tr, str(tmp_path / k))
           for k, (obs, ev, tr) in PKGS.items()}
    assert got["port"] == got["ref"]
    p = got["port"]
    assert p["p2"] is None and p["dumps"] == 2 and p["last"]
    assert p["names"] == ["flight_abort_step_5", "flight_other"]
    assert p["doc"]["reason"] == "abort/step 5"
    assert set(p["doc"]["terminal_spans"]) == {"('m0', 2)", "('m0', 3)",
                                               "('m0', 4)"}
    assert p["spans"] == [("m0", 3), ("m0", 4)]


def test_configure_tracing_mutates_the_process_bus_like_reference(
        tmp_path):
    """``configure_tracing`` applies a config block in place: a cached bus
    sees it, its rings resize keeping the newest events, the flight
    recorder comes up (and survives a re-configure) and goes with
    tracing."""
    from deepspeed_tpu_torch.config import TracingConfig

    cfg = TracingConfig.build({"enabled": True, "ring_size": 32,
                               "sample": 2, "dump_dir": str(tmp_path),
                               "retain_terminal": 5}, "tracing")
    got = {}
    for k, (obs, ev, tr) in PKGS.items():
        cached = obs.get_bus()
        assert cached.enabled is False
        try:
            obs.configure_tracing(cfg)
            for i in range(40):
                cached.instant("c", "e", args={"i": i})
            rec = tr.get_flight_recorder()
            obs.configure_tracing(ring_size=16, dump_dir=str(tmp_path / k))
            same = tr.get_flight_recorder() is rec
            got[k] = (cached.enabled, cached.ring_size, cached.sample,
                      [e.args["i"] for e in cached.events()], same,
                      rec.retain_terminal,
                      os.path.relpath(rec.out_dir, str(tmp_path / k)))
        finally:
            obs.configure_tracing(enabled=False, ring_size=4096, sample=1)
            cached.clear()
        assert obs.get_bus() is cached and not cached.enabled
        assert tr.get_flight_recorder() is None
        assert obs.flight_dump("nothing") is None
    assert got["port"] == got["ref"]
    assert got["port"][:4] == (True, 16, 2, list(range(24, 40)))


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------

class TestEventBus:
    def test_disabled_records_nothing(self):
        bus = port_events.EventBus(enabled=False)
        bus.instant("c", "n")
        bus.begin("c", "n")
        with bus.span("c", "s"):
            pass
        assert bus.total_events() == 0 and bus.mint_trace() is None

    def test_enabled_records_typed_events(self):
        bus = port_events.EventBus(enabled=True, ring_size=64)
        t = bus.mint_trace()
        bus.async_begin("request", "request", t, args={"uid": 1})
        bus.instant("c", "mark")
        bus.async_end("request", "request", t)
        evs = bus.events()
        assert [e.ph for e in evs] == ["b", "i", "e"]
        assert evs[0].trace_id == t and evs[0].tid == threading.get_ident()
        assert evs[0].ts <= evs[1].ts <= evs[2].ts

    def test_sampling_is_deterministic(self):
        bus = port_events.EventBus(enabled=True, sample=4)
        kept = [t for t in (bus.mint_trace() for _ in range(16))
                if t is not None]
        assert len(kept) == 4 and all(t % 4 == 0 for t in kept)

    def test_span_closes_on_exception(self):
        bus = port_events.EventBus(enabled=True)
        with pytest.raises(ValueError):
            with bus.span("c", "op"):
                raise ValueError("boom")
        evs = bus.events()
        assert [e.ph for e in evs] == ["B", "E"]
        assert "boom" in evs[1].args["error"]

    def test_ring_bounded_under_10k_storm(self):
        bus = port_events.EventBus(enabled=True, ring_size=256)
        for i in range(10_000):
            bus.instant("storm", "evt", args={"i": i})
        assert bus.total_events() == 256
        assert bus.events()[-1].args["i"] == 9_999
        assert bus.events()[0].args["i"] == 10_000 - 256

    def test_cross_thread_appends_and_snapshot(self):
        bus = port_events.EventBus(enabled=True, ring_size=4096)
        stop = threading.Event()

        def writer(k):
            i = 0
            while not stop.is_set():
                bus.instant("t", "evt", args={"k": k, "i": i})
                i += 1

        threads = [threading.Thread(target=writer, args=(k,))
                   for k in range(4)]
        [t.start() for t in threads]
        try:
            for _ in range(50):
                assert all(e.cat == "t" for e in bus.events())
        finally:
            stop.set()
            [t.join(timeout=5) for t in threads]
        assert bus.total_events() <= 4096

    def test_configure_mutates_in_place(self, tmp_path):
        cached = port_obs.get_bus()
        assert cached.enabled is False
        port_obs.configure_tracing(enabled=True, ring_size=128,
                                   dump_dir=str(tmp_path))
        try:
            assert cached.enabled is True and cached.ring_size == 128
            assert port_obs.get_flight_recorder() is not None
        finally:
            port_obs.configure_tracing(enabled=False, ring_size=4096)
        assert cached.enabled is False
        assert port_obs.get_flight_recorder() is None
        cached.clear()


class TestTraceExport:
    def test_export_is_grammar_valid(self):
        bus = port_events.EventBus(enabled=True)
        t = bus.mint_trace()
        bus.async_begin("request", "request", t)
        with bus.span("batcher", "step"):
            bus.instant("engine", "mark")
        bus.async_end("request", "request", t)
        doc = port_obs.trace_export(bus)
        assert port_obs.validate_trace(doc) == []
        assert len(doc["traceEvents"]) == 5
        assert doc["otherData"]["enabled"] is True
        assert doc["otherData"]["source"] == "deepspeed_tpu_torch." \
                                             "observability"

    def test_orphans_are_repaired(self):
        bus = port_events.EventBus(enabled=True)
        bus.end("c", "stray")
        bus.begin("c", "open")
        bus.async_end("a", "x", 7)
        bus.async_begin("a", "y", 8)
        doc = port_obs.trace_export(bus)
        assert port_obs.validate_trace(doc) == []
        assert sorted(e["ph"] for e in doc["traceEvents"]) == ["B", "E",
                                                               "b", "e"]
        assert len([e for e in doc["traceEvents"]
                    if e.get("args", {}).get("synthetic_end")]) == 2


class TestFlightRecorder:
    def test_dump_carries_events_and_terminals(self, tmp_path):
        bus = port_events.EventBus(enabled=True)
        rec = port_trace.FlightRecorder(bus, str(tmp_path),
                                        retain_terminal=4)
        bus.instant("resilience", "bad_step", args={"step": 3})
        rec.record_terminal(11, {"uid": 11, "state": "completed"})
        path = rec.dump("unit", extra={"why": "test"})
        doc = json.load(open(path))
        assert doc["reason"] == "unit" and doc["extra"] == {"why": "test"}
        assert port_obs.validate_trace(doc["trace"]) == []
        assert doc["terminal_spans"]["11"]["state"] == "completed"
        assert "bad_step" in [e["name"] for e in doc["trace"]["traceEvents"]]

    def test_key_dedups_one_incident(self, tmp_path):
        rec = port_trace.FlightRecorder(port_events.EventBus(enabled=True),
                                        str(tmp_path))
        p1 = rec.dump("abort", key="abort-step5")
        p2 = rec.dump("abort", key="abort-step5")
        p3 = rec.dump("abort", key="abort-step6")
        assert p1 and p2 is None and p3 and rec.dumps == 2

    def test_terminal_retention_is_bounded(self, tmp_path):
        rec = port_trace.FlightRecorder(port_events.EventBus(),
                                        str(tmp_path), retain_terminal=3)
        for uid in range(10):
            rec.record_terminal(uid, {"uid": uid})
        assert rec.terminal_trace(0) is None
        assert sorted(rec.terminal_spans()) == [7, 8, 9]

    def test_flight_dump_helper(self, tmp_path):
        port_obs.set_flight_recorder(None)
        assert port_obs.flight_dump("nothing") is None
        rec = port_obs.set_flight_recorder(port_trace.FlightRecorder(
            port_events.EventBus(enabled=True), str(tmp_path)))
        try:
            path = port_obs.flight_dump("helper", key="k")
            assert path and port_obs.flight_dump("helper", key="k") is None
            rec.out_dir = "/proc/no/such/dir"   # a failing dump never raises
            assert port_obs.flight_dump("helper2") is None
        finally:
            port_obs.set_flight_recorder(None)
