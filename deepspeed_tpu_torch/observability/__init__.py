"""Unified observability layer: metrics registry, request tracing,
``/metrics`` exposition, and on-demand ``torch.profiler`` capture
(counterpart of ``deepspeed_tpu/observability``).

The reference DeepSpeed ships a real observability surface (monitor
backends, ``CommsLogger``, flops profiler, ``SynchronizedWallClockTimer``);
this package is the reproduction's equivalent substrate, designed for the
serving stack the ROADMAP grows next:

* :mod:`~deepspeed_tpu_torch.observability.registry` —
  :class:`MetricsRegistry` of typed Counter/Gauge/Histogram instruments
  (fixed exponential buckets + streaming p50/p95/p99), rendered as
  Prometheus text format and JSON;
* :mod:`~deepspeed_tpu_torch.observability.exposition` —
  :class:`ObservabilityServer`: stdlib HTTP ``/metrics`` + ``/healthz`` /
  ``/readyz`` probes mapped from the batcher's
  STARTING/READY/DEGRADED/DRAINING health;
* :mod:`~deepspeed_tpu_torch.observability.tracing` — per-request serving spans
  feeding the ``serving/ttft_ms`` / ``serving/tpot_ms`` /
  ``serving/queue_wait_ms`` SLO histograms;
* :mod:`~deepspeed_tpu_torch.observability.profiler` — :class:`ProfileTrigger`:
  trigger-file / SIGUSR2 → N-step ``torch.profiler`` capture, rate-limited
  and warm-up-exempt, so a live slowdown can be profiled without a
  restart;
* :mod:`~deepspeed_tpu_torch.observability.bridge` — :class:`MonitorBridge`:
  periodic registry-delta flush through the existing ``MonitorMaster`` so
  CSV/TensorBoard/wandb/comet dashboards keep working unchanged;
* :mod:`~deepspeed_tpu_torch.observability.events` — the causal event bus:
  typed begin/end/instant/async events with monotonic timestamps, thread
  ids, and a ``trace_id`` chain, emitted from every async seam into
  bounded per-category rings (``observability.tracing`` config);
* :mod:`~deepspeed_tpu_torch.observability.trace` — the bus's consumers:
  ``trace_export()`` (Chrome-trace/Perfetto JSON, served at
  ``GET /v1/trace``) and the :class:`FlightRecorder` black box dumped on
  StepGuard aborts, watchdog escalations, coordinated aborts, emergency
  saves, and DEGRADED transitions.

Metric name schema: ``serving/*`` (request lifecycle + SLOs),
``train/*`` (per-step breakdown), ``resilience/*`` (checkpoint/guard),
``comm/*`` (collective volume), ``inference/*`` (engine put path).
"""

from deepspeed_tpu_torch.observability.bridge import MonitorBridge
from deepspeed_tpu_torch.observability.events import (
    EventBus, TraceEvent, configure_tracing, get_bus, set_bus)
from deepspeed_tpu_torch.observability.exposition import (
    LIVE_STATES, READY_STATES, ObservabilityServer, probe_status)
from deepspeed_tpu_torch.observability.profiler import ProfileTrigger
from deepspeed_tpu_torch.observability.registry import (
    Counter, Gauge, Histogram, HistogramWindow, MetricsRegistry,
    exponential_bounds, get_registry, set_registry)
from deepspeed_tpu_torch.observability.trace import (
    FlightRecorder, flight_dump, get_flight_recorder, set_flight_recorder,
    trace_export, validate_trace)
from deepspeed_tpu_torch.observability.tracing import (HEALTH_CODES,
                                                       ServingMetrics)

__all__ = [
    "Counter", "EventBus", "FlightRecorder", "Gauge", "HEALTH_CODES",
    "Histogram", "HistogramWindow", "LIVE_STATES", "MetricsRegistry",
    "MonitorBridge", "ObservabilityServer", "ProfileTrigger",
    "READY_STATES", "ServingMetrics", "TraceEvent", "configure_tracing",
    "exponential_bounds", "flight_dump", "get_bus", "get_flight_recorder",
    "get_registry", "probe_status", "set_bus", "set_flight_recorder",
    "set_registry", "trace_export", "validate_trace",
]
