"""Registry → MonitorMaster bridge (counterpart of
``deepspeed_tpu/observability/bridge.py``).

The registry is the source of truth; the monitor backends
(CSV/TensorBoard/wandb/comet) are sinks that predate it and must keep
working unchanged. :class:`MonitorBridge` periodically walks the registry
and writes one monitor event per *changed* series — counters and gauges as
their current value, histograms as ``_count``/``_p50``/``_p95``/``_p99``
derived series — so dashboards built on the CSV/TensorBoard streams pick
up every new registry metric without those backends learning anything new.

Delta semantics: a series is flushed only when its value (or, for
histograms, its sample count) changed since the last flush. A quiet
counter costs nothing in the CSV files; a hot one produces exactly one row
per flush, not per increment.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.observability.registry import (MetricsRegistry,
                                                        get_registry)

__all__ = ["MonitorBridge"]

Event = Tuple[str, float, int]


class MonitorBridge:
    def __init__(self, monitor, registry: Optional[MetricsRegistry] = None,
                 prefix: Optional[str] = None,
                 exclude: Tuple[str, ...] = ()):
        """``monitor`` is anything with ``write_events([(tag, value, step)])``
        (a :class:`~deepspeed_tpu_torch.monitor.MonitorMaster`); ``prefix``
        restricts the flush to one namespace (e.g. ``"serving/"``) and
        ``exclude`` skips namespaces owned by another bridge — two bridges
        on one process (a training engine next to a serving batcher, each
        with its own step axis) must never write the same tag."""
        self.monitor = monitor
        self.registry = registry if registry is not None else get_registry()
        self.prefix = prefix
        self.exclude = tuple(exclude)
        self._last: Dict[str, float] = {}

    def _tag(self, fam, inst) -> str:
        if not inst.labels:
            return fam.name
        return fam.name + "." + ".".join(
            f"{k}={v}" for k, v in sorted(inst.labels.items()))

    def collect_events(self, step: int) -> List[Event]:
        """The changed-series events; does not write (tests use this)."""
        events: List[Event] = []
        for fam in self.registry.collect():
            if self.prefix and not fam.name.startswith(self.prefix):
                continue
            if any(fam.name.startswith(p) for p in self.exclude):
                continue
            for inst in fam.series.values():
                tag = self._tag(fam, inst)
                if fam.kind == "histogram":
                    count = inst.count
                    if self._last.get(tag) == count:
                        continue
                    self._last[tag] = count
                    events.append((f"{tag}_count", float(count), step))
                    for pk, pv in inst.percentiles().items():
                        events.append((f"{tag}_{pk}", float(pv), step))
                else:
                    value = float(inst.value)
                    if self._last.get(tag) == value:
                        continue
                    self._last[tag] = value
                    events.append((tag, value, step))
        return events

    def flush(self, step: int) -> int:
        """Write every changed series through the monitor; returns the
        number of events written."""
        events = self.collect_events(step)
        if events and self.monitor is not None:
            self.monitor.write_events(events)
        return len(events)
