"""Typed metrics instruments and the process-wide registry (counterpart of
``deepspeed_tpu/observability/registry.py``).

The reference DeepSpeed scatters its numbers across ``MonitorMaster``
backends, ``CommsLogger`` tables, and ad-hoc ``*_report()`` dicts; this
module gives the reproduction ONE substrate: a :class:`MetricsRegistry` of
named :class:`Counter` / :class:`Gauge` / :class:`Histogram` instruments
that every layer (serving, engine, resilience, comm) writes into, and that
renders as both the Prometheus text exposition format
(:meth:`MetricsRegistry.render_prometheus`) and a JSON snapshot
(:meth:`MetricsRegistry.snapshot`).

Design constraints, in order:

* **cheap on the hot path** — an instrument update is a couple of float ops
  under one uncontended lock (no allocation, no device sync, no string
  work); all string/formatting cost is paid at scrape/flush time;
* **bounded memory** — histograms hold fixed exponential bucket counts,
  never raw samples, so a week of serving traffic costs the same bytes as
  a minute (this replaces the bespoke 256-sample latency deque the batcher
  hand-rolled);
* **deterministic percentiles** — p50/p95/p99 are interpolated from the
  bucket counts (log-linear within a bucket, clamped to the observed
  min/max), so two scrapes of the same state agree exactly.

Canonical metric names use ``/`` as the namespace separator
(``serving/ttft_ms``, ``train/step_ms``, ``comm/all_reduce_bytes``) —
matching the existing monitor-event tags — and are sanitized to the
Prometheus grammar (``serving_ttft_ms``) only at render time.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "HistogramWindow",
           "MetricsRegistry", "exponential_bounds", "get_registry",
           "set_registry"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def prom_name(name: str) -> str:
    """Canonical ``ns/metric`` name → Prometheus metric name."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def exponential_bounds(start: float = 0.25, factor: float = 2.0,
                       count: int = 18) -> List[float]:
    """Fixed exponential bucket boundaries: ``start * factor**i``.

    The default (0.25 → ~32768 in 18 steps) spans 250 µs to ~33 s when the
    unit is milliseconds — wide enough for TTFT on a cold prefill and tight
    enough that p99 interpolation stays within a factor-2 bucket.
    """
    return [start * factor ** i for i in range(count)]


class _Instrument:
    """Shared identity: canonical name + frozen label set."""

    kind = "untyped"

    def __init__(self, name: str, labels: Dict[str, str], lock):
        self.name = name
        self.labels = dict(labels)
        self._lock = lock


class Counter(_Instrument):
    """Monotonically increasing count (renders with the ``_total`` suffix)."""

    kind = "counter"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({amount}))")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Instrument):
    """Point-in-time value that can go up and down."""

    kind = "gauge"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Histogram(_Instrument):
    """Fixed-boundary exponential histogram with streaming percentiles.

    ``observe()`` is O(log nbuckets) (bisect) and allocation-free; the
    distribution state is ``len(bounds)+1`` integer counts plus sum/min/max.
    ``percentile(q)`` interpolates within the bucket that holds the q-rank
    sample: log-linear between the bucket's bounds (exponential buckets are
    uniform in log space), clamped to the observed min/max so the open
    first/last buckets cannot invent mass outside the data.
    """

    kind = "histogram"

    def __init__(self, name, labels, lock, bounds: Optional[List[float]] = None):
        super().__init__(name, labels, lock)
        bs = list(bounds) if bounds is not None else exponential_bounds()
        if not bs or any(b <= 0 for b in bs) or \
                any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"histogram {name}: bounds must be positive "
                             f"and strictly increasing, got {bs}")
        self.bounds = bs
        self._counts = [0] * (len(bs) + 1)   # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        # branchless-ish bisect over a small static list
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        """Streaming percentile estimate (``q`` in [0, 100])."""
        with self._lock:
            return _percentile_from_counts(self._counts, self.bounds, q,
                                           self._min, self._max)

    def percentiles(self, qs=(50.0, 95.0, 99.0)) -> Dict[str, float]:
        return {f"p{q:g}": self.percentile(q) for q in qs}


def _percentile_from_counts(counts, bounds, q: float, lo_clamp: float,
                            hi_clamp: float) -> float:
    """Interpolated percentile over bucket ``counts`` (len(bounds)+1, last
    = overflow): log-linear within the holding bucket, clamped to
    [lo_clamp, hi_clamp]."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = max(1.0, q / 100.0 * total)
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank:
            lower = bounds[i - 1] if i > 0 else lo_clamp
            upper = bounds[i] if i < len(bounds) else hi_clamp
            lower = max(min(lower, hi_clamp), lo_clamp)
            upper = max(min(upper, hi_clamp), lo_clamp)
            if upper <= lower:
                return float(upper)
            frac = (rank - cum) / c
            # exponential buckets: interpolate in log space
            if lower > 0:
                return float(lower * (upper / lower) ** frac)
            return float(lower + (upper - lower) * frac)
        cum += c
    return float(hi_clamp)


class HistogramWindow:
    """Recent-window percentiles over a cumulative :class:`Histogram`.

    A lifetime histogram hides a fresh latency regression behind millions
    of old fast samples; this view computes percentiles over only the
    observations since one-to-two :meth:`roll` calls ago (the bucket-delta
    equivalent of a fixed-size sample deque, in O(nbuckets) state). The
    window base starts at the histogram's CURRENT counts, so a window on a
    shared registry histogram sees only samples observed after its
    creation. Clamps are [0, lifetime max] — the per-window extrema are
    not tracked, which only widens the open first/last buckets slightly.
    """

    def __init__(self, hist: Histogram):
        self.hist = hist
        with hist._lock:
            snap, cnt = list(hist._counts), hist._count
        self._old, self._old_count = snap, cnt
        self._recent, self._recent_count = list(snap), cnt

    def roll(self) -> None:
        """Advance the window (call on a fixed step/time cadence)."""
        with self.hist._lock:
            snap, cnt = list(self.hist._counts), self.hist._count
        self._old, self._old_count = self._recent, self._recent_count
        self._recent, self._recent_count = snap, cnt

    @property
    def count(self) -> int:
        return self.hist._count - self._old_count

    def percentile(self, q: float) -> float:
        h = self.hist
        with h._lock:
            delta = [c - o for c, o in zip(h._counts, self._old)]
            hi = h._max if h._max > 0 else (h.bounds[-1] if h.bounds
                                            else 0.0)
            return _percentile_from_counts(delta, h.bounds, q, 0.0, hi)


class _Family:
    """All series of one metric name (same type, help; distinct label sets)."""

    def __init__(self, name: str, kind: str, help_text: str):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.series: Dict[Tuple[Tuple[str, str], ...], _Instrument] = {}


class MetricsRegistry:
    """Process-wide instrument store; get-or-create by (name, labels)."""

    _CLASSES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.Lock()        # registry structure
        self._value_lock = threading.Lock()  # instrument updates
        self._families: Dict[str, _Family] = {}  #: guarded_by: _lock
        self.created_at = time.time()

    # ------------------------------------------------------------------
    # instrument factories
    # ------------------------------------------------------------------
    def _get(self, kind: str, name: str, help_text: str,
             labels: Optional[Dict[str, str]], **kw) -> _Instrument:
        labels = {str(k): str(v) for k, v in (labels or {}).items()}
        for k in labels:
            if _LABEL_RE.search(k):
                raise ValueError(f"invalid label name {k!r} on {name}")
        key = tuple(sorted(labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help_text)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            inst = fam.series.get(key)
            if inst is None:
                inst = self._CLASSES[kind](name, labels, self._value_lock,
                                           **kw)
                fam.series[key] = inst
            if help_text and not fam.help:
                fam.help = help_text
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  bounds: Optional[List[float]] = None,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get("histogram", name, help, labels, bounds=bounds)

    # ------------------------------------------------------------------
    # introspection / exposition
    # ------------------------------------------------------------------
    def collect(self) -> Iterable[_Family]:
        with self._lock:
            fams = list(self._families.values())
        return sorted(fams, key=lambda f: f.name)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def _label_str(self, inst: _Instrument,
                   extra: Optional[Tuple[str, str]] = None) -> str:
        pairs = sorted(inst.labels.items())
        if extra is not None:
            pairs = pairs + [extra]
        if not pairs:
            return ""
        body = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                        for k, v in pairs)
        return "{" + body + "}"

    @staticmethod
    def _fmt(v: float) -> str:
        if v == math.inf:
            return "+Inf"
        if v == -math.inf:
            return "-Inf"
        if v != v:
            return "NaN"
        if float(v).is_integer() and abs(v) < 1e15:
            return str(int(v))
        return repr(float(v))

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: List[str] = []
        for fam in self.collect():
            pname = prom_name(fam.name)
            base = pname + ("_total" if fam.kind == "counter" else "")
            if fam.help:
                out.append(f"# HELP {base} "
                           f"{fam.help.replace(chr(10), ' ')}")
            out.append(f"# TYPE {base} {fam.kind}")
            for inst in fam.series.values():
                if fam.kind == "histogram":
                    cum = 0
                    with self._value_lock:
                        counts = list(inst._counts)
                        hsum, hcount = inst._sum, inst._count
                    for bound, c in zip(inst.bounds, counts):
                        cum += c
                        le = self._fmt(bound)
                        out.append(f"{pname}_bucket"
                                   f"{self._label_str(inst, ('le', le))} "
                                   f"{cum}")
                    cum += counts[-1]
                    out.append(f"{pname}_bucket"
                               f"{self._label_str(inst, ('le', '+Inf'))} "
                               f"{cum}")
                    out.append(f"{pname}_sum{self._label_str(inst)} "
                               f"{self._fmt(hsum)}")
                    out.append(f"{pname}_count{self._label_str(inst)} "
                               f"{hcount}")
                else:
                    out.append(f"{base}{self._label_str(inst)} "
                               f"{self._fmt(inst.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict:
        """JSON-serializable view: every series with its current state."""
        snap: Dict[str, Dict] = {}
        for fam in self.collect():
            series = []
            for inst in fam.series.values():
                rec: Dict = {"labels": dict(inst.labels)}
                if fam.kind == "histogram":
                    with self._value_lock:
                        rec.update(count=inst._count, sum=inst._sum,
                                   counts=list(inst._counts))
                    rec["bounds"] = list(inst.bounds)
                    rec.update({k: round(v, 6) for k, v in
                                inst.percentiles().items()})
                else:
                    rec["value"] = inst.value
                series.append(rec)
            snap[fam.name] = {"type": fam.kind, "help": fam.help,
                              "series": series}
        return snap

    def render_json(self) -> str:
        return json.dumps(self.snapshot(), default=str)


# ---------------------------------------------------------------------------
# process-wide default registry
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (what ``/metrics`` exposes)."""
    return _REGISTRY


def set_registry(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Swap the default registry (tests isolate with a fresh one); returns
    the new active registry. ``None`` installs a fresh empty registry."""
    global _REGISTRY
    _REGISTRY = registry if registry is not None else MetricsRegistry()
    return _REGISTRY
