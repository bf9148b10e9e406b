"""Trace export (Chrome trace-event JSON) + the crash flight recorder
(counterpart of ``deepspeed_tpu/observability/trace.py``).

Two consumers of the :class:`~deepspeed_tpu_torch.observability.events.EventBus`:

* :func:`trace_export` — the bus rings rendered as Chrome
  trace-event-format JSON (the ``chrome://tracing`` / Perfetto "JSON
  Array Format" with the ``traceEvents`` envelope). Duration ``B``/``E``
  pairs are *repaired* before export: ring eviction can orphan one half of
  a pair, and an unbalanced document renders as garbage — stray ``E``\\ s
  are dropped, unclosed ``B``\\ s get a synthetic ``E`` stamped
  ``{"synthetic_end": true}`` at the trace horizon, and async ``b``/``e``
  tracks get the same treatment per ``(cat, id, name)``. The exported
  document therefore always satisfies :func:`validate_trace` — the grammar
  ``tools/trace_drill.py`` enforces.
* :class:`FlightRecorder` — the always-on black box. The bus rings ARE the
  recording; ``dump()`` writes them (plus the retained last-K terminal
  request spans and a caller-supplied context dict) to a timestamped JSON
  file. Wired to StepGuard abort, HangWatchdog escalation,
  CoordinatedAbort, SIGTERM emergency saves, and batcher DEGRADED
  transitions via :func:`flight_dump` — so every crash artifact ships the
  events that led up to it. ``key=`` de-duplicates a trigger that can fire
  from several layers for one incident ("exactly one dump per abort" is a
  drill invariant).

The recorder also retains the last-K **terminal request spans** evicted
from the serving ledger (:meth:`record_terminal`), so ``request_trace(uid)``
still resolves for a post-mortem after the bounded ledger dropped the uid.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from deepspeed_tpu_torch.observability.events import (PHASES, EventBus,
                                                      TraceEvent, get_bus)
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["trace_export", "validate_trace", "FlightRecorder",
           "get_flight_recorder", "set_flight_recorder", "flight_dump"]

TRACE_SCHEMA = 1


# ---------------------------------------------------------------------------
# Chrome trace export
# ---------------------------------------------------------------------------
def _balance(events: List[TraceEvent]) -> List[dict]:
    """Transcribe bus events to trace-event dicts with the pairing
    invariants restored (see module docstring). ``events`` must be
    time-sorted."""
    out: List[dict] = []
    horizon = events[-1].ts if events else 0
    open_b: Dict[int, List[dict]] = {}          # tid -> stack of B dicts
    open_async: Dict[tuple, int] = {}           # (cat, id, name) -> depth
    pid = os.getpid()
    for ev in events:
        d = ev.to_json()
        d["pid"] = pid
        if ev.ph == "B":
            open_b.setdefault(ev.tid, []).append(d)
            out.append(d)
        elif ev.ph == "E":
            stack = open_b.get(ev.tid)
            if not stack:
                continue                        # begin evicted from the ring
            stack.pop()
            out.append(d)
        elif ev.ph == "b":
            key = (ev.cat, ev.trace_id, ev.name)
            open_async[key] = open_async.get(key, 0) + 1
            out.append(d)
        elif ev.ph == "e":
            key = (ev.cat, ev.trace_id, ev.name)
            if open_async.get(key, 0) <= 0:
                continue                        # begin evicted from the ring
            open_async[key] -= 1
            out.append(d)
        elif ev.ph == "i":
            d["s"] = "t"                        # thread-scoped instant
            out.append(d)
        else:                                   # "n": async instant
            out.append(d)
    for tid, stack in open_b.items():
        for d in reversed(stack):               # innermost closes first
            out.append({"ph": "E", "cat": d["cat"], "name": d["name"],
                        "ts": horizon, "tid": tid, "pid": pid,
                        "args": {"synthetic_end": True}})
    for (cat, tid_, name), depth in open_async.items():
        for _ in range(depth):
            out.append({"ph": "e", "cat": cat, "name": name, "ts": horizon,
                        "tid": 0, "pid": pid, "id": tid_,
                        "args": {"synthetic_end": True}})
    return out


def trace_export(bus: Optional[EventBus] = None,
                 cats: Optional[List[str]] = None) -> dict:
    """The bus rings as a Chrome-trace document (dict; ``json.dumps`` it
    for the wire). Always grammar-valid per :func:`validate_trace`."""
    bus = bus if bus is not None else get_bus()
    events = bus.events(cats)
    return {
        "traceEvents": _balance(events),
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": TRACE_SCHEMA,
            "source": "deepspeed_tpu_torch.observability",
            "enabled": bus.enabled,
            "categories": bus.categories(),
            "clock": "perf_counter_us",
        },
    }


def validate_trace(doc: dict) -> List[str]:
    """Grammar check for an exported trace document; returns a list of
    violations (empty = valid). The rules ``tools/trace_drill.py`` and the
    tier-1 tests enforce:

    * the ``traceEvents`` envelope exists and is a list;
    * every event carries ``ph``/``cat``/``name``/``ts``/``pid``/``tid``
      with a known phase and a numeric non-negative ``ts``;
    * ``B``/``E`` balance as a stack per ``tid`` (every B has a matching E
      on the same tid, nothing closes an empty stack);
    * async ``b``/``e`` balance per ``(cat, id, name)`` and ``b``/``e``/
      ``n`` events carry an ``id``.
    """
    errors: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    depth: Dict[int, int] = {}
    async_depth: Dict[tuple, int] = {}
    for i, d in enumerate(evs):
        if not isinstance(d, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = d.get("ph")
        if ph == "M":
            continue                            # metadata records are free-form
        for k in ("ph", "cat", "name", "ts", "pid", "tid"):
            if k not in d:
                errors.append(f"event {i}: missing {k!r}")
        if ph not in PHASES:
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        ts = d.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i}: bad ts {ts!r}")
        tid = d.get("tid")
        if ph == "B":
            depth[tid] = depth.get(tid, 0) + 1
        elif ph == "E":
            if depth.get(tid, 0) <= 0:
                errors.append(f"event {i}: E with no open B on tid {tid}")
            else:
                depth[tid] -= 1
        elif ph in ("b", "e", "n"):
            if "id" not in d:
                errors.append(f"event {i}: async {ph!r} without id")
                continue
            key = (d.get("cat"), d["id"], d.get("name"))
            if ph == "b":
                async_depth[key] = async_depth.get(key, 0) + 1
            elif ph == "e":
                if async_depth.get(key, 0) <= 0:
                    errors.append(f"event {i}: async e with no open b "
                                  f"for {key}")
                else:
                    async_depth[key] -= 1
    for tid, n in depth.items():
        if n:
            errors.append(f"{n} unclosed B event(s) on tid {tid}")
    for key, n in async_depth.items():
        if n:
            errors.append(f"{n} unclosed async b event(s) for {key}")
    return errors


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
class FlightRecorder:
    """Always-on black box over an :class:`EventBus` (see module doc)."""

    def __init__(self, bus: EventBus, out_dir: str,
                 retain_terminal: int = 256):
        self.bus = bus
        self.out_dir = os.path.abspath(out_dir)
        self.retain_terminal = max(0, int(retain_terminal))
        # last-K terminal request spans evicted from the serving ledger,
        # keyed opaquely (serving uses (manager_ns, uid)); written by the
        # batcher worker, read by dump()/query threads
        self._terminal: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()
        # FIFO-bounded dedup keys: the set exists to collapse the layers
        # of ONE incident (a guard abort and its coordinated-abort echo
        # land within the same window), so old keys can age out — an
        # unbounded set is a slow leak on a flapping long-lived process
        self._dumped_keys: "OrderedDict" = OrderedDict()  #: guarded_by: _lock
        self._max_dumped_keys = 4096
        self._seq = 0                    #: guarded_by: _lock
        self.dumps = 0
        self.last_path: Optional[str] = None

    def reconfigure(self, out_dir: Optional[str] = None,
                    retain_terminal: Optional[int] = None) -> None:
        """Apply new settings WITHOUT replacing the recorder: the
        dump-dedup keys and retained terminal spans must survive a
        re-configuration (a fresh recorder would re-dump an already
        black-boxed incident and forget every evicted span)."""
        if out_dir is not None:
            self.out_dir = os.path.abspath(out_dir)
        if retain_terminal is not None:
            self.retain_terminal = max(0, int(retain_terminal))
            with self._lock:
                while len(self._terminal) > self.retain_terminal:
                    self._terminal.popitem(last=False)

    # -- terminal-span retention (the ledger-eviction fallback) --------
    def record_terminal(self, key, span: dict) -> None:
        """Retain one evicted terminal span under an opaque ``key``. The
        serving layer keys by ``(manager_namespace, uid)`` — bare uids
        collide across co-resident replicas (each manager numbers from
        0), and a collision would answer one replica's post-mortem with
        another replica's request."""
        if self.retain_terminal <= 0:
            return
        with self._lock:
            self._terminal[key] = span
            self._terminal.move_to_end(key)
            while len(self._terminal) > self.retain_terminal:
                self._terminal.popitem(last=False)

    def terminal_trace(self, key) -> Optional[dict]:
        with self._lock:
            return self._terminal.get(key)

    def terminal_spans(self) -> Dict:
        with self._lock:
            return dict(self._terminal)

    # -- dumping --------------------------------------------------------
    def dump(self, reason: str, extra: Optional[dict] = None,
             key: Optional[str] = None) -> Optional[str]:
        """Write the black box to ``<out_dir>/flight_<reason>_<stamp>.json``
        and return the path. ``key`` de-duplicates multi-layer triggers of
        one incident: the second dump for the same key is a no-op (returns
        None) — one abort, one artifact."""
        with self._lock:
            if key is not None:
                if key in self._dumped_keys:
                    return None
                self._dumped_keys[key] = True
                while len(self._dumped_keys) > self._max_dumped_keys:
                    self._dumped_keys.popitem(last=False)
            self._seq += 1
            seq = self._seq
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:64]
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(self.out_dir,
                            f"flight_{safe}_{stamp}_{os.getpid()}_{seq}.json")
        doc = {
            "schema": TRACE_SCHEMA,
            "reason": reason,
            "wall_time": time.time(),
            "pid": os.getpid(),
            "bus": self.bus.stats(),
            "trace": trace_export(self.bus),
            "terminal_spans": {str(k): v
                               for k, v in self.terminal_spans().items()},
            "extra": extra,
        }
        os.makedirs(self.out_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        self.dumps += 1
        self.last_path = path
        logger.warning(f"flight recorder: dumped {self.bus.total_events()} "
                       f"events to {path} (reason: {reason})")
        return path


_RECORDER: Optional[FlightRecorder] = None


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def set_flight_recorder(rec: Optional[FlightRecorder]
                        ) -> Optional[FlightRecorder]:
    global _RECORDER
    _RECORDER = rec
    return rec


def flight_dump(reason: str, extra: Optional[dict] = None,
                key: Optional[str] = None) -> Optional[str]:
    """Dump the black box if a recorder is configured; never raises — the
    dump rides abort/escalation paths that must keep propagating their
    original failure."""
    rec = _RECORDER
    if rec is None:
        return None
    try:
        return rec.dump(reason, extra=extra, key=key)
    except Exception as e:
        logger.warning(f"flight recorder: dump for {reason!r} failed: {e}")
        return None
