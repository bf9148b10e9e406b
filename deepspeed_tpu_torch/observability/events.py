"""Causal event tracing: a lock-cheap structured event bus (counterpart of
``deepspeed_tpu/observability/events.py``).

Histograms answer "how slow"; they cannot answer "what was this request
doing between admit and TTFT" or "what was in flight when the watchdog
fired". This module is the substrate for both questions: every async seam
the stack has grown — AIO completion tickets, KV tier demote/promote
fences, speculative decode rounds, drain-time queue migration — emits
typed events with monotonic timestamps, thread ids, and a
``trace_id``/``parent_id`` causal chain into one process-wide
:class:`EventBus`. Two consumers sit on top
(:mod:`~deepspeed_tpu_torch.observability.trace`):

* ``trace_export()`` — Chrome-trace/Perfetto JSON (``GET /v1/trace`` on
  the :class:`~deepspeed_tpu_torch.observability.ObservabilityServer`);
* :class:`~deepspeed_tpu_torch.observability.trace.FlightRecorder` — the rings
  themselves ARE the always-on black box, dumped to a timestamped JSON
  file on StepGuard abort, HangWatchdog escalation, CoordinatedAbort,
  SIGTERM emergency save, and batcher DEGRADED transitions.

Event phases mirror the Chrome trace-event format so export is a
transcription, not a translation:

=====  ==============================================================
``B``  duration begin (thread-scoped; nest like a call stack per tid)
``E``  duration end (closes the most recent open ``B`` on its tid)
``i``  thread-scoped instant
``b``  async begin — starts the track keyed by ``(cat, trace_id)``
``e``  async end
``n``  async instant — a stamp on an existing async track
=====  ==============================================================

Concurrency model: event rings are ``collections.deque(maxlen=...)`` —
``append`` is GIL-atomic, so the hot path takes **no lock** (the only
lock guards first-touch ring creation, a handful of times per process).
Bounded by construction: the ring drops the oldest event, never grows,
never blocks. Disabled cost is one attribute check per ``emit`` (and the
instrumented call sites guard on ``bus.enabled`` before building args, so
a disabled bus costs an attribute load + branch — measured ~0 in
``obs_drill --scenario tracing-overhead``).

Sampling is per-*trace* and deterministic: :meth:`EventBus.mint_trace`
keeps every ``sample``-th minted trace id (count-based, no wall clock), so
drills can assert exact behavior. Events without a trace id (step spans,
swap tickets, resilience instants) are not sampled away — they are the
flight recorder's context and individually cheap.

``configure_tracing`` mutates the process bus **in place** so call sites
that cached ``get_bus()`` at construction time observe the new state.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, NamedTuple, Optional

__all__ = ["TraceEvent", "EventBus", "get_bus", "set_bus",
           "configure_tracing", "PHASES", "SAMPLED_OUT"]

#: phases understood by the exporter/validator (Chrome trace-event subset)
PHASES = frozenset({"B", "E", "i", "b", "e", "n"})

#: sentinel a trace-minting layer passes DOWN the submit chain when its
#: deterministic sample decided "emit nothing for this request" — distinct
#: from None ("nobody decided yet"), which would make the next layer mint
#: again and give every request a second 1-in-N chance. Real ids start at 1.
SAMPLED_OUT = 0


class TraceEvent(NamedTuple):
    """One structured event. ``ts`` is microseconds of
    ``time.perf_counter_ns`` — one monotonic clock domain for the whole
    process, every thread."""

    ph: str
    cat: str
    name: str
    ts: int                       # µs, perf_counter clock domain
    tid: int                      # threading.get_ident()
    trace_id: Optional[int]       # causal chain / async track id
    parent_id: Optional[int]
    args: Optional[dict]

    def to_json(self) -> dict:
        out = {"ph": self.ph, "cat": self.cat, "name": self.name,
               "ts": self.ts, "tid": self.tid}
        if self.trace_id is not None:
            out["id"] = self.trace_id
        args = dict(self.args) if self.args else {}
        if self.parent_id is not None:
            args["parent_id"] = self.parent_id
        if args:
            out["args"] = args
        return out


class _NoopSpan:
    """Returned by :meth:`EventBus.span` when tracing is off — one shared
    instance, so a disabled span costs no allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    """Context manager pairing ``B``/``E`` on the calling thread. The
    ``finally`` semantics of ``with`` guarantee the ``E`` lands on every
    exit path — the exact lifecycle discipline the dslint ``event-span``
    rule enforces on hand-rolled begin/end pairs."""

    __slots__ = ("bus", "cat", "name", "trace_id", "parent_id", "args")

    def __init__(self, bus: "EventBus", cat: str, name: str,
                 trace_id: Optional[int], parent_id: Optional[int],
                 args: Optional[dict]):
        self.bus = bus
        self.cat = cat
        self.name = name
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.args = args

    def __enter__(self):
        self.bus.emit("B", self.cat, self.name, trace_id=self.trace_id,
                      parent_id=self.parent_id, args=self.args)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.bus.emit("E", self.cat, self.name, trace_id=self.trace_id,
                      args=({"error": repr(exc)[:200]}
                            if exc_type is not None else None))
        return False


class EventBus:
    """Process-wide structured event sink (see module docstring)."""

    def __init__(self, enabled: bool = False, ring_size: int = 4096,
                 sample: int = 1):
        self.enabled = bool(enabled)
        self.ring_size = int(ring_size)
        self.sample = max(1, int(sample))
        # per-category bounded rings; appends are GIL-atomic (lock-free hot
        # path), the lock below guards only first-touch ring creation
        self._rings: Dict[str, deque] = {}
        self._ring_lock = threading.Lock()
        # itertools.count.__next__ is atomic under the GIL — ids are unique
        # across threads without a lock. Request traces draw from their
        # OWN counter: sampling is `seq % sample`, and interleaved
        # new_id() draws (KV fetches, swap tickets) on a shared counter
        # would make "every Nth request" arbitrary under load. Odd ids
        # for tickets, even for traces — the two sequences never collide.
        self._ids = itertools.count(1, 2)
        self._trace_seq = itertools.count(2, 2)

    # ------------------------------------------------------------------
    # ids + sampling
    # ------------------------------------------------------------------
    def new_id(self) -> int:
        """A fresh unique id (async-track key for tickets/fetches)."""
        return next(self._ids)

    def mint_trace(self) -> Optional[int]:
        """Mint a request trace id, or None when tracing is disabled or
        this trace falls outside the deterministic 1-in-``sample`` keep
        set (count-based over REQUESTS minted, independent of ticket-id
        traffic). A None trace id means: emit nothing for this request."""
        if not self.enabled:
            return None
        tid = next(self._trace_seq)
        if self.sample > 1 and (tid // 2) % self.sample != 0:
            return None
        return tid

    @staticmethod
    def now_us() -> int:
        return time.perf_counter_ns() // 1000

    # ------------------------------------------------------------------
    # emission
    # ------------------------------------------------------------------
    def _ring(self, cat: str) -> deque:
        ring = self._rings.get(cat)
        if ring is None:
            with self._ring_lock:
                ring = self._rings.get(cat)
                if ring is None:
                    ring = deque(maxlen=self.ring_size)
                    self._rings[cat] = ring
        return ring

    def emit(self, ph: str, cat: str, name: str, *,
             trace_id: Optional[int] = None,
             parent_id: Optional[int] = None,
             args: Optional[dict] = None,
             ts: Optional[int] = None) -> None:
        if not self.enabled:
            return
        self._ring(cat).append(TraceEvent(
            ph, cat, name,
            self.now_us() if ts is None else ts,
            threading.get_ident(), trace_id, parent_id, args))

    # convenience wrappers — call-site readability, same hot path
    def instant(self, cat: str, name: str, *, trace_id=None, args=None
                ) -> None:
        self.emit("i", cat, name, trace_id=trace_id, args=args)

    def begin(self, cat: str, name: str, *, trace_id=None, parent_id=None,
              args=None) -> None:
        self.emit("B", cat, name, trace_id=trace_id, parent_id=parent_id,
                  args=args)

    def end(self, cat: str, name: str, *, trace_id=None, args=None) -> None:
        self.emit("E", cat, name, trace_id=trace_id, args=args)

    def async_begin(self, cat: str, name: str, trace_id: int, *,
                    parent_id=None, args=None) -> None:
        self.emit("b", cat, name, trace_id=trace_id, parent_id=parent_id,
                  args=args)

    def async_end(self, cat: str, name: str, trace_id: int, *,
                  args=None) -> None:
        self.emit("e", cat, name, trace_id=trace_id, args=args)

    def async_instant(self, cat: str, name: str, trace_id: int, *,
                      args=None) -> None:
        self.emit("n", cat, name, trace_id=trace_id, args=args)

    def span(self, cat: str, name: str, *, trace_id=None, parent_id=None,
             args=None):
        """``with bus.span(...):`` — a B/E pair that closes on every exit
        path. Returns a shared no-op when tracing is disabled."""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, cat, name, trace_id, parent_id, args)

    # ------------------------------------------------------------------
    # reading
    # ------------------------------------------------------------------
    @staticmethod
    def _snapshot(ring: deque) -> List[TraceEvent]:
        # a concurrent append during list() raises RuntimeError ("deque
        # mutated during iteration"); exports are rare, appends constant —
        # retry instead of locking the hot path
        for _ in range(16):
            try:
                return list(ring)
            except RuntimeError:
                continue
        return []

    def _rings_snapshot(self) -> List:
        # the dict itself mutates on a first-touch category insert; a
        # bare iteration racing that raises "dictionary changed size
        # during iteration" — which would lose the flight dump of the
        # very abort it was recording. Readers take the (rare-path)
        # creation lock for the dict walk only; ring contents stay
        # lock-free.
        with self._ring_lock:
            return list(self._rings.items())

    def events(self, cats: Optional[Iterable[str]] = None
               ) -> List[TraceEvent]:
        """Snapshot of the rings (all categories or ``cats``), time-sorted."""
        pairs = self._rings_snapshot()
        if cats is not None:
            wanted = set(cats)
            pairs = [(c, r) for c, r in pairs if c in wanted]
        out: List[TraceEvent] = []
        for _cat, ring in pairs:
            out.extend(self._snapshot(ring))
        out.sort(key=lambda e: e.ts)
        return out

    def categories(self) -> List[str]:
        return sorted(c for c, _ in self._rings_snapshot())

    def total_events(self) -> int:
        return sum(len(r) for _, r in self._rings_snapshot())

    def clear(self) -> None:
        for _, ring in self._rings_snapshot():
            ring.clear()

    def stats(self) -> Dict:
        return {"enabled": self.enabled, "ring_size": self.ring_size,
                "sample": self.sample,
                "events": {cat: len(r)
                           for cat, r in sorted(self._rings_snapshot())}}


# ---------------------------------------------------------------------------
# process singleton
# ---------------------------------------------------------------------------
_BUS = EventBus(enabled=False)


def get_bus() -> EventBus:
    """The process event bus. Safe to cache at construction time:
    :func:`configure_tracing` mutates this object in place, so cached
    references observe enable/disable."""
    return _BUS


def set_bus(bus: EventBus) -> EventBus:
    """Swap the process bus (tests). Call sites that cached the previous
    bus keep emitting into it — prefer :func:`configure_tracing` unless
    isolation from cached references is the point."""
    global _BUS
    _BUS = bus
    return bus


def configure_tracing(config=None, *, enabled: Optional[bool] = None,
                      ring_size: Optional[int] = None,
                      sample: Optional[int] = None,
                      dump_dir: Optional[str] = None,
                      retain_terminal: Optional[int] = None) -> EventBus:
    """Apply an ``observability.tracing`` config block (or explicit
    kwargs) to the process bus, in place, and stand up / tear down the
    flight recorder to match. ``config`` duck-types the
    :class:`~deepspeed_tpu_torch.config.config.TracingConfig` attributes, so
    drills can pass a plain namespace."""
    if config is not None:
        enabled = config.enabled if enabled is None else enabled
        ring_size = (getattr(config, "ring_size", None)
                     if ring_size is None else ring_size)
        sample = getattr(config, "sample", None) if sample is None else sample
        dump_dir = (getattr(config, "dump_dir", None)
                    if dump_dir is None else dump_dir)
        retain_terminal = (getattr(config, "retain_terminal", None)
                           if retain_terminal is None else retain_terminal)
    bus = _BUS
    if ring_size is not None and int(ring_size) != bus.ring_size:
        bus.ring_size = int(ring_size)
        with bus._ring_lock:
            # resize applies to every ring, keeping the newest events
            for cat, ring in list(bus._rings.items()):
                bus._rings[cat] = deque(bus._snapshot(ring),
                                        maxlen=bus.ring_size)
    if sample is not None:
        bus.sample = max(1, int(sample))
    if enabled is not None:
        bus.enabled = bool(enabled)
    from deepspeed_tpu_torch.observability.trace import (FlightRecorder,
                                                         get_flight_recorder,
                                                         set_flight_recorder)

    if bus.enabled:
        rec = get_flight_recorder()
        if rec is None:
            set_flight_recorder(FlightRecorder(
                bus, dump_dir if dump_dir is not None else "./flight_dumps",
                retain_terminal=(retain_terminal
                                 if retain_terminal is not None else 256)))
        else:
            # keep the live recorder: replacing it would drop the
            # dump-dedup keys (a re-config between two layers surfacing
            # ONE abort would double-dump it) and the retained terminal
            # spans the bounded ledger already handed over
            rec.reconfigure(out_dir=dump_dir,
                            retain_terminal=retain_terminal)
    elif enabled is not None:
        set_flight_recorder(None)
    return bus
