"""Serving request tracing: per-request spans → SLO histograms (counterpart
of ``deepspeed_tpu/observability/tracing.py``).

Every admitted request carries a span (timestamps stamped on its
:class:`~deepspeed_tpu_torch.serving.request.ServeRequest` by the manager and
batcher): submit → admit (queue wait) → first prefill → first token (TTFT)
→ per-token decode (TPOT) → terminal. :class:`ServingMetrics` is the
bundle of registry instruments those spans feed — created once per batcher
so the hot path holds direct instrument references (no name lookups per
token).

Metric schema (all under ``serving/``):

* ``serving/ttft_ms`` (histogram) — submit → first generated token;
* ``serving/tpot_ms`` (histogram) — inter-token gap while decoding;
* ``serving/queue_wait_ms`` (histogram) — submit → admission;
* ``serving/step_ms`` (histogram) — one batcher step wall clock (replaces
  the bespoke 256-sample deque);
* ``serving/e2e_ms`` (histogram) — submit → terminal, completed only;
* ``serving/requests`` (counter, label ``terminal=``) — terminal rates;
* ``serving/shed_total`` (counter, label ``reason=``) — shed rate by cause;
* ``serving/rejected_total`` (counter, label ``reason=``) — admission
  refusals (queue_full / draining);
* ``serving/preemptions_total`` (counter, label ``tier=``) — SLO
  preemptions (pause-through-the-tier-store), by victim tier;
* ``serving/pause_ms`` / ``serving/resume_ms`` (histograms) — KV demote /
  promote wall clock for one preemption cycle;
* per-tier SLO children: ``serving/ttft_ms{tier=}`` /
  ``serving/tpot_ms{tier=}`` — the latency/throughput/batch breakdown of
  the headline histograms;
* gauges: ``serving/health`` (0=starting 1=ready 2=degraded 3=draining),
  ``serving/queue_depth`` (total, plus per-``{priority=}`` and
  per-``{tier=}`` children — the router's balancing signal and the fleet
  autoscaler's, respectively), ``serving/active_requests``,
  ``serving/paused_requests``, ``serving/kv_occupancy``.
"""

from __future__ import annotations

from typing import Dict, Optional

from deepspeed_tpu_torch.observability.registry import (MetricsRegistry,
                                                        exponential_bounds,
                                                        get_registry)

__all__ = ["ServingMetrics", "HEALTH_CODES"]

HEALTH_CODES = {"starting": 0, "ready": 1, "degraded": 2, "draining": 3}

# ms-unit latency bounds: 0.25 ms … ~33 s
_LAT_BOUNDS = exponential_bounds(0.25, 2.0, 18)


class ServingMetrics:
    """Instrument handles for the serving layer (one per batcher)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        r = registry if registry is not None else get_registry()
        self.registry = r
        # gates the per-token span histograms (ttft/tpot/queue_wait/e2e)
        # only — lifecycle counters always record (one bump per terminal
        # transition is not hot-path work)
        self.spans_enabled = True
        self.ttft_ms = r.histogram(
            "serving/ttft_ms", "submit -> first generated token (ms)",
            bounds=_LAT_BOUNDS)
        self.tpot_ms = r.histogram(
            "serving/tpot_ms", "inter-token decode gap (ms)",
            bounds=_LAT_BOUNDS)
        self.queue_wait_ms = r.histogram(
            "serving/queue_wait_ms", "submit -> admission (ms)",
            bounds=_LAT_BOUNDS)
        self.step_ms = r.histogram(
            "serving/step_ms", "one serving step wall clock (ms)",
            bounds=_LAT_BOUNDS)
        self.e2e_ms = r.histogram(
            "serving/e2e_ms", "submit -> completion (ms, completed only)",
            bounds=_LAT_BOUNDS)
        self.health = r.gauge(
            "serving/health",
            "0=starting 1=ready 2=degraded 3=draining")
        self.queue_depth = r.gauge("serving/queue_depth",
                                   "requests waiting for admission")
        self.active_requests = r.gauge("serving/active_requests",
                                       "requests on the engine")
        self.kv_occupancy = r.gauge("serving/kv_occupancy",
                                    "paged KV pool occupancy [0, 1]")
        # SLO preemption (pause/resume through the KV tier store)
        self.paused_requests = r.gauge(
            "serving/paused_requests",
            "requests preempted and parked in the KV tier store")
        self.pause_ms = r.histogram(
            "serving/pause_ms", "preempt: KV demote wall clock (ms)",
            bounds=_LAT_BOUNDS)
        self.resume_ms = r.histogram(
            "serving/resume_ms", "resume: KV promote wall clock (ms)",
            bounds=_LAT_BOUNDS)
        # speculative decoding (n-gram draft + batched verify): acceptance
        # rate is the headline — accepted/drafted over the process lifetime
        self.spec_rounds = r.counter(
            "serving/spec_rounds", "draft-verify rounds run")
        self.spec_draft_tokens = r.counter(
            "serving/spec_draft_tokens", "tokens drafted by n-gram lookup")
        self.spec_accepted_tokens = r.counter(
            "serving/spec_accepted_tokens",
            "drafted tokens the model confirmed")
        self.spec_acceptance_rate = r.gauge(
            "serving/spec_acceptance_rate",
            "lifetime accepted/drafted draft tokens")
        # cross-replica migration (durable manifests on the shared tier)
        self.migration_ms = r.histogram(
            "serving/migration_ms",
            "donor capture -> sibling adoption wall clock (ms)",
            bounds=_LAT_BOUNDS)
        self.reprefill_fallbacks = r.counter(
            "serving/reprefill_fallbacks_total",
            "migrated requests recovered by re-prefill (durable KV "
            "missing or unreadable)")
        self._terminals: Dict[str, object] = {}
        self._migrations: Dict[str, object] = {}
        self._sheds: Dict[str, object] = {}
        self._rejects: Dict[str, object] = {}
        self._qdepth_prio: Dict[str, object] = {}
        self._qdepth_tier: Dict[str, object] = {}
        self._preempts: Dict[str, object] = {}
        self._ttft_tier: Dict[str, object] = {}
        self._tpot_tier: Dict[str, object] = {}

    def record_spec_round(self, drafted: int, accepted: int) -> None:
        self.spec_rounds.inc()
        if drafted:
            self.spec_draft_tokens.inc(float(drafted))
        if accepted:
            self.spec_accepted_tokens.inc(float(accepted))
        total_d = self.spec_draft_tokens.value
        if total_d:
            self.spec_acceptance_rate.set(
                self.spec_accepted_tokens.value / total_d)

    # label-set children are created on first use and cached: terminal
    # states and shed reasons are small closed sets, so the dict stays tiny
    def terminal(self, state: str):
        c = self._terminals.get(state)
        if c is None:
            c = self._terminals[state] = self.registry.counter(
                "serving/requests", "requests by terminal state",
                labels={"terminal": state})
        return c

    def shed(self, reason: str):
        c = self._sheds.get(reason)
        if c is None:
            c = self._sheds[reason] = self.registry.counter(
                "serving/shed_total", "sheds by reason",
                labels={"reason": reason})
        return c

    def rejected(self, reason: str):
        c = self._rejects.get(reason)
        if c is None:
            c = self._rejects[reason] = self.registry.counter(
                "serving/rejected_total", "admission refusals by reason",
                labels={"reason": reason})
        return c

    def preemption(self, tier: str):
        c = self._preempts.get(tier)
        if c is None:
            c = self._preempts[tier] = self.registry.counter(
                "serving/preemptions_total",
                "SLO preemptions (pause through the KV tier store)",
                labels={"tier": tier})
        return c

    def migration(self, cause: str):
        c = self._migrations.get(cause)
        if c is None:
            c = self._migrations[cause] = self.registry.counter(
                "serving/migrations_total",
                "requests re-homed onto a sibling replica",
                labels={"cause": cause})
        return c

    def ttft_tier(self, tier: str):
        h = self._ttft_tier.get(tier)
        if h is None:
            h = self._ttft_tier[tier] = self.registry.histogram(
                "serving/ttft_ms", "submit -> first generated token (ms)",
                bounds=_LAT_BOUNDS, labels={"tier": tier})
        return h

    def tpot_tier(self, tier: str):
        h = self._tpot_tier.get(tier)
        if h is None:
            h = self._tpot_tier[tier] = self.registry.histogram(
                "serving/tpot_ms", "inter-token decode gap (ms)",
                bounds=_LAT_BOUNDS, labels={"tier": tier})
        return h

    def set_health(self, health: str) -> None:
        self.health.set(float(HEALTH_CODES.get(health, -1)))

    def set_queue_depths(self, by_priority: Dict[int, int]) -> None:
        """Per-priority breakdown as ``serving/queue_depth{priority=}``
        gauge children (the router's balancing signal). A priority class
        that empties out is zeroed, not left at its last value — a scrape
        must never show ghost backlog."""
        seen = set()
        for prio, depth in by_priority.items():
            key = str(int(prio))
            seen.add(key)
            g = self._qdepth_prio.get(key)
            if g is None:
                g = self._qdepth_prio[key] = self.registry.gauge(
                    "serving/queue_depth",
                    "requests waiting for admission",
                    labels={"priority": key})
            g.set(float(depth))
        for key, g in self._qdepth_prio.items():
            if key not in seen:
                g.set(0.0)

    def set_queue_depth_tiers(self, by_tier: Dict[str, int]) -> None:
        """Per-SLO-tier breakdown as ``serving/queue_depth{tier=}`` gauge
        children — the fleet autoscaler's pressure signal (batch-tier
        backlog alone must not scale the fleet up). Empty tiers zero out,
        same ghost-backlog rule as the priority children."""
        seen = set()
        for tier, depth in by_tier.items():
            key = str(tier)
            seen.add(key)
            g = self._qdepth_tier.get(key)
            if g is None:
                g = self._qdepth_tier[key] = self.registry.gauge(
                    "serving/queue_depth",
                    "requests waiting for admission",
                    labels={"tier": key})
            g.set(float(depth))
        for key, g in self._qdepth_tier.items():
            if key not in seen:
                g.set(0.0)
