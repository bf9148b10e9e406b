"""Request admission, deadlines, and shedding bookkeeping (counterpart of
``deepspeed_tpu/serving/manager.py``).

:class:`RequestManager` owns everything about a request EXCEPT the device
step: the bounded admission queue, per-request deadlines (absolute, checked
against an injectable clock so tests are deterministic), cancellation, and
the terminal ledger. KV/slot reclamation is delegated to ``release_fn`` —
the :class:`~deepspeed_tpu_torch.serving.batcher.ContinuousBatcher` points it
at ``InferenceEngineV2.flush``, so expiring or shedding an in-flight request
releases its blocks through the same path a completed request does (no
second accounting scheme to leak through).

The admitted-uid resolution invariant lives here: every uid that ever left
the queue lands in exactly one of ``completed | shed | expired | cancelled``,
and :meth:`resolve` answers for any uid ever submitted.
"""

from __future__ import annotations

import itertools
import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

from deepspeed_tpu_torch.observability.events import SAMPLED_OUT, get_bus
from deepspeed_tpu_torch.serving.request import (CANCELLED, COMPLETED,
                                                 DECODING, EXPIRED, PAUSED,
                                                 PREFILLING, QUEUED, SHED,
                                                 TIER_THROUGHPUT, TIERS,
                                                 ServeRequest, ShedError,
                                                 as_prompt)
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["RequestManager"]

# per-manager namespace for flight-recorder terminal-span keys: every
# manager numbers uids from 0, so a co-resident replica's uid 5 must not
# answer for THIS manager's uid 5 in the process-global recorder
_LEDGER_NS = itertools.count(1)


class RequestManager:
    def __init__(self, max_queue_depth: int = 64,
                 default_max_new_tokens: int = 128,
                 default_deadline_s: Optional[float] = None,
                 retry_after_s: float = 1.0,
                 release_fn: Optional[Callable[[Sequence[int]], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None, max_done_history: int = 65536,
                 default_tier: str = TIER_THROUGHPUT,
                 retry_after_tier_factor: Optional[Dict[str, float]] = None):
        self.max_queue_depth = int(max_queue_depth)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.default_deadline_s = default_deadline_s
        self.default_tier = (default_tier if default_tier in TIERS
                             else TIER_THROUGHPUT)
        # per-tier Retry-After multiplier (serving.slo.retry_after_factor):
        # batch-tier 429s are told to back off harder than latency-tier
        # ones under the same pressure — spot traffic yields first
        self.retry_after_tier_factor = dict(retry_after_tier_factor or {})
        # BASE back-off hint; what a ShedError actually carries is
        # current_retry_after() — this base scaled by live pressure
        self.retry_after_s = float(retry_after_s)
        # sliding window of recent outcomes (1.0 = shed/reject, 0.0 =
        # accepted/completed) — the shed-rate half of the load-aware hint
        self._pressure: Deque[float] = deque(maxlen=64)
        self.release_fn = release_fn
        self.clock = clock
        # optional ServingMetrics: terminal/shed/reject counters + the
        # queue-wait and end-to-end SLO histograms ride the same lifecycle
        # transitions that keep the ledger, so the two can never disagree
        self.metrics = metrics
        self.queue: Deque[ServeRequest] = deque()
        self.active: Dict[int, ServeRequest] = {}   # admitted, on the engine
        # terminal ledger, BOUNDED: oldest terminals are evicted past
        # max_done_history with their span handed to the flight recorder
        # (when tracing is on) so request_trace(uid) still answers for a
        # post-mortem — an unbounded ledger was a slow per-request leak on
        # a long-running replica
        self.done: "OrderedDict[int, ServeRequest]" = OrderedDict()
        self.max_done_history = max(1, int(max_done_history))
        # uid membership mirror of `queue`: the router's route-eviction
        # sweep probes liveness cross-thread with GIL-atomic set/dict
        # reads (scanning the deque from another thread can raise on
        # concurrent mutation). A live uid is ALWAYS in at least one of
        # _queued_uids / active / done — transitions insert into the next
        # home before removing from the previous one.
        self._queued_uids: set = set()
        # the causal event bus (observability.tracing); configure_tracing
        # mutates the singleton in place, so this cached ref stays live
        self._ebus = get_bus()
        self._ledger_ns = next(_LEDGER_NS)
        self._next_uid = 0
        self._closed_reason: Optional[str] = None
        self.counters: Dict[str, int] = {
            "submitted": 0, "rejected": 0, "admitted": 0, "completed": 0,
            "shed": 0, "expired": 0, "cancelled": 0, "paused": 0,
            "resumed": 0, "adopted": 0, "rebalanced": 0, "reprefills": 0,
        }
        self.shed_reasons: Dict[str, int] = {}

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None,
               priority: int = 0, tier: Optional[str] = None,
               trace_id: Optional[int] = None) -> int:
        """Enqueue a request; returns its uid. Raises :class:`ShedError`
        (``reason=queue_full`` or ``draining``, both retryable) instead of
        growing the queue without bound — admission control IS the refusal.
        ``tier`` (latency|throughput|batch, default ``default_tier``) is
        the request's SLO class; the Retry-After a refusal carries is
        scaled by the tier's back-off factor."""
        if tier is None or tier not in TIERS:
            tier = self.default_tier
        self.counters["submitted"] += 1
        if self._closed_reason is not None:
            self.counters["rejected"] += 1
            self._pressure.append(1.0)
            if self.metrics is not None:
                self.metrics.rejected("draining").inc()
            raise ShedError("draining", retryable=True,
                            retry_after_s=self.current_retry_after(tier),
                            detail=self._closed_reason)
        if len(self.queue) >= self.max_queue_depth:
            self.counters["rejected"] += 1
            self._pressure.append(1.0)
            if self.metrics is not None:
                self.metrics.rejected("queue_full").inc()
            raise ShedError("queue_full", retryable=True,
                            retry_after_s=self.current_retry_after(tier),
                            detail=f"depth {len(self.queue)} >= "
                                   f"{self.max_queue_depth}")
        self._pressure.append(0.0)
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        now = self.clock()
        bus = self._ebus
        if trace_id == SAMPLED_OUT:
            trace_id = None          # a minting layer upstream (frontend)
        elif trace_id is None and bus.enabled:  # already decided: nothing
            trace_id = bus.mint_trace()     # sampled: None = emit nothing
        req = ServeRequest(
            uid=self._next_uid, prompt=as_prompt(prompt),
            max_new_tokens=int(max_new_tokens
                               if max_new_tokens is not None
                               else self.default_max_new_tokens),
            priority=int(priority), tier=tier,
            deadline=None if deadline_s is None else now + float(deadline_s),
            submitted_at=now, trace_id=trace_id)
        self._next_uid += 1
        self._queued_uids.add(req.uid)      # membership BEFORE visibility
        self.queue.append(req)
        if req.trace_id is not None and bus.enabled:
            # the request's async track opens here; every later subsystem
            # stamps the same (cat="request", id=trace_id) track
            bus.async_begin("request", "request", req.trace_id, args={
                "subsys": "serving", "what": "submit", "uid": req.uid,
                "prompt_tokens": req.prompt_len, "priority": req.priority,
                "tier": req.tier})
        return req.uid

    def close(self, reason: str = "draining") -> None:
        """Stop admitting new requests (graceful-drain entry)."""
        self._closed_reason = reason

    def current_retry_after(self, tier: Optional[str] = None) -> float:
        """Load-aware back-off hint: the configured base scaled by queue
        fullness and the recent shed/reject rate, so the ``Retry-After`` a
        429 carries actually reflects pressure — an idle server says
        "come back in ``retry_after_s``", a saturated one up to ~4x that.
        ``tier`` additionally applies the per-tier back-off factor (batch
        4x latency by default) so spot traffic is told to yield hardest
        under the same pressure. Deterministic (count-based windows, no
        wall clock) so drills can assert on it."""
        qfrac = min(1.0, len(self.queue) / max(1, self.max_queue_depth))
        p = self._pressure
        sfrac = (sum(p) / len(p)) if p else 0.0
        base = self.retry_after_s * (1.0 + qfrac + 2.0 * sfrac)
        if tier is not None:
            base *= float(self.retry_after_tier_factor.get(tier, 1.0))
        return base

    @property
    def closed(self) -> bool:
        return self._closed_reason is not None

    # ------------------------------------------------------------------
    # lifecycle transitions (called by the batcher)
    # ------------------------------------------------------------------
    def admit(self, req: ServeRequest) -> None:
        req.state = PREFILLING
        req.admitted_at = self.clock()
        self.active[req.uid] = req          # next home before leaving queue
        self.queue.remove(req)
        self._queued_uids.discard(req.uid)
        self.counters["admitted"] += 1
        if self.metrics is not None and self.metrics.spans_enabled:
            self.metrics.queue_wait_ms.observe(
                (req.admitted_at - req.submitted_at) * 1e3)
        if req.trace_id is not None and self._ebus.enabled:
            self._ebus.async_instant("request", "request", req.trace_id,
                                     args={"subsys": "serving",
                                           "what": "admit", "uid": req.uid})

    def _finish(self, req: ServeRequest, state: str) -> None:
        req.state = state
        req.finished_at = self.clock()
        self.done[req.uid] = req            # next home before leaving others
        if req.uid in self.active:
            del self.active[req.uid]
            if self.release_fn is not None:
                # in-flight: give back KV blocks + slot through the engine's
                # own flush path, whatever the terminal state
                self.release_fn([req.uid])
        elif req in self.queue:
            self.queue.remove(req)
        self._queued_uids.discard(req.uid)
        if req.trace_id is not None and self._ebus.enabled:
            self._ebus.async_end("request", "request", req.trace_id, args={
                "subsys": "serving", "what": "terminal", "uid": req.uid,
                "state": state, "finish_reason": req.finish_reason or None,
                "generated": len(req.generated)})
        self._evict_done()

    def _evict_done(self) -> None:
        """FIFO-evict terminal requests past ``max_done_history``. The
        evicted span is retained in the flight recorder's last-K terminal
        ring (when tracing is on) so ``trace()``/``resolve()`` still
        answer for it — the post-mortem fix for spans vanishing with the
        ledger entry."""
        if len(self.done) <= self.max_done_history:
            return
        from deepspeed_tpu_torch.observability.trace import get_flight_recorder

        rec = get_flight_recorder()
        while len(self.done) > self.max_done_history:
            uid, req = self.done.popitem(last=False)
            if rec is not None:
                rec.record_terminal((self._ledger_ns, uid), req.span())

    def complete(self, req: ServeRequest, finish_reason: str = "length"
                 ) -> None:
        self._pressure.append(0.0)      # healthy outcome decays the hint
        req.finish_reason = finish_reason
        self._finish(req, COMPLETED)
        self.counters["completed"] += 1
        if self.metrics is not None:
            self.metrics.terminal(COMPLETED).inc()
            if self.metrics.spans_enabled:
                self.metrics.e2e_ms.observe(
                    (req.finished_at - req.submitted_at) * 1e3)

    def shed(self, req: ServeRequest, reason: str, retryable: bool = True
             ) -> None:
        self._pressure.append(1.0)
        req.error = ShedError(reason, uid=req.uid, retryable=retryable,
                              retry_after_s=self.current_retry_after(
                                  req.tier))
        req.finish_reason = reason
        self._finish(req, SHED)
        self.counters["shed"] += 1
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1
        if self.metrics is not None:
            self.metrics.terminal(SHED).inc()
            self.metrics.shed(reason).inc()
        logger.warning(f"serving: shed uid={req.uid} ({reason}, "
                       f"prefilled={req.prefilled}/{req.prompt_len}, "
                       f"generated={len(req.generated)})")

    def pause(self, req: ServeRequest) -> None:
        """PREEMPT an in-flight request: mark it PAUSED. The uid STAYS in
        ``active`` — a paused request is live (the router's liveness probes
        and ``resolve()`` must keep answering for it); it simply stops
        appearing in the decode/prefill plans until :meth:`resume_admit`.
        KV demotion is the engine's job (``pause_request``) and happens
        before this transition; the manager only keeps the ledger."""
        req.state = PAUSED
        req.pause_count += 1
        req.progress_at_last_pause = req.progress
        req.paused_at = self.clock()
        self.counters["paused"] += 1
        if req.trace_id is not None and self._ebus.enabled:
            self._ebus.async_instant("request", "request", req.trace_id,
                                     args={"subsys": "serving",
                                           "what": "pause", "uid": req.uid,
                                           "tier": req.tier,
                                           "progress": req.progress})

    def resume_admit(self, req: ServeRequest) -> None:
        """Un-pause: the engine restored the request's KV (promote queued
        under the fence), so it rejoins the decode/prefill plans. State
        returns to DECODING when the prompt is fully in KV, else
        PREFILLING (a request paused mid-chunked-prefill)."""
        req.state = (DECODING if req.prefilled >= req.prompt_len
                     else PREFILLING)
        req.paused_at = None
        self.counters["resumed"] += 1
        if req.trace_id is not None and self._ebus.enabled:
            self._ebus.async_instant("request", "request", req.trace_id,
                                     args={"subsys": "serving",
                                           "what": "resume", "uid": req.uid,
                                           "tier": req.tier,
                                           "pauses": req.pause_count})

    # ------------------------------------------------------------------
    # cross-replica migration transitions
    # ------------------------------------------------------------------
    def adopt(self, donor: ServeRequest, *,
              deadline_s: Optional[float] = None,
              migrated_from: Optional[str] = None,
              paused: bool = True) -> ServeRequest:
        """Register a request migrated from a sibling replica under a
        FRESH local uid (uid namespaces overlap across managers; the
        router-scoped ruid is what survives the move). ``paused=True``
        lands the request directly in ``active`` as PAUSED — its durable
        KV was adopted by the engine, and the normal budget-gated resume
        path promotes it. ``paused=False`` arms the re-prefill fallback
        (:meth:`ServeRequest.prepare_replay`) and queues the request for
        ordinary admission — recompute, never zero-fill; raises
        ``queue_full``/``draining`` like :meth:`submit` so the router can
        try the next sibling. Donor span timestamps are kept (one
        monotonic clock domain per host) so e2e latency stays honest
        across the move."""
        if not paused and self._closed_reason is not None:
            raise ShedError("draining", retryable=True,
                            retry_after_s=self.current_retry_after(
                                donor.tier),
                            detail=self._closed_reason)
        if not paused and len(self.queue) >= self.max_queue_depth:
            raise ShedError("queue_full", retryable=True,
                            retry_after_s=self.current_retry_after(
                                donor.tier),
                            detail=f"depth {len(self.queue)} >= "
                                   f"{self.max_queue_depth}")
        now = self.clock()
        req = ServeRequest(
            uid=self._next_uid, prompt=donor.prompt,
            max_new_tokens=int(donor.max_new_tokens),
            priority=int(donor.priority),
            tier=donor.tier if donor.tier in TIERS else self.default_tier,
            deadline=(None if deadline_s is None
                      else now + float(deadline_s)),
            submitted_at=donor.submitted_at or now,
            trace_id=donor.trace_id)
        self._next_uid += 1
        req.prefilled = int(donor.prefilled)
        req.generated = list(donor.generated)
        req.next_token = donor.next_token
        req.admitted_at = donor.admitted_at
        req.first_token_at = donor.first_token_at
        req.last_token_at = donor.last_token_at
        req.pause_count = int(donor.pause_count)
        req.progress_at_last_pause = int(donor.progress_at_last_pause)
        req.migrated_from = migrated_from
        self.counters["submitted"] += 1
        self.counters["adopted"] += 1
        if paused:
            req.state = PAUSED
            req.paused_at = donor.paused_at or now
            self.active[req.uid] = req
            self.counters["admitted"] += 1
        else:
            req.prepare_replay()
            req.state = QUEUED
            self._queued_uids.add(req.uid)  # membership BEFORE visibility
            self.queue.append(req)
        if req.trace_id is not None and self._ebus.enabled:
            # the donor's track ended at its shed; the SAME id re-opens
            # here so one /v1/trace chain shows export→adopt→resume
            self._ebus.async_begin("request", "request", req.trace_id,
                                   args={"subsys": "serving",
                                         "what": "adopt", "uid": req.uid,
                                         "from": migrated_from,
                                         "replay": req.replay is not None})
        return req

    def drop_adopted(self, req: ServeRequest) -> None:
        """Unwind a failed adopt registration (the engine rejected the
        manifest's durable entries): the uid was never exposed outside
        the worker thread, so it simply vanishes — no terminal record;
        the caller falls down the re-prefill ladder instead."""
        self.active.pop(req.uid, None)
        if req in self.queue:
            self.queue.remove(req)
        self._queued_uids.discard(req.uid)

    def migrate_out(self, req: ServeRequest) -> None:
        """A live PAUSED request leaves this manager for a sibling
        (voluntary rebalance): terminal locally as a silent ``rebalanced``
        shed — WITHOUT the overload pressure signal a real shed feeds the
        Retry-After hint — while the router rewrites the route so the
        client-facing ruid resolves through the adopting sibling."""
        req.finish_reason = "rebalanced"
        self._finish(req, SHED)
        self.counters["rebalanced"] += 1
        self.shed_reasons["rebalanced"] = \
            self.shed_reasons.get("rebalanced", 0) + 1

    def requeue_for_replay(self, req: ServeRequest) -> None:
        """Fall a live (active) request back to re-prefill: its KV is
        unrecoverable (migrate/resume tier read failed after adoption)
        but its token history is intact. The request re-enters the queue
        HEAD with the replay stream armed — it already held capacity
        once, so it re-admits before newcomers."""
        req.prepare_replay()
        req.state = QUEUED
        req.paused_at = None
        self._queued_uids.add(req.uid)      # next home before leaving
        self.queue.appendleft(req)
        self.active.pop(req.uid, None)
        self.counters["reprefills"] += 1
        if req.trace_id is not None and self._ebus.enabled:
            self._ebus.async_instant("request", "request", req.trace_id,
                                     args={"subsys": "serving",
                                           "what": "reprefill",
                                           "uid": req.uid,
                                           "generated":
                                               len(req.generated)})

    def paused(self) -> List[ServeRequest]:
        """Paused requests in resume order: latency tier first, earliest
        pause first — the request that has waited longest in the most
        latency-sensitive tier gets the freed capacity."""
        out = [r for r in self.active.values() if r.state == PAUSED]
        out.sort(key=lambda r: (TIERS.index(r.tier) if r.tier in TIERS
                                else len(TIERS), r.paused_at or 0.0))
        return out

    def cancel(self, uid: int, reason: str = "cancelled") -> bool:
        """User-initiated cancellation; True if the request was still live."""
        req = self.active.get(uid)
        if req is None:
            req = next((r for r in self.queue if r.uid == uid), None)
        if req is None:
            return False
        req.finish_reason = reason
        self._finish(req, CANCELLED)
        self.counters["cancelled"] += 1
        if self.metrics is not None:
            self.metrics.terminal(CANCELLED).inc()
        return True

    def expire(self, now: Optional[float] = None) -> List[ServeRequest]:
        """Expire every queued or in-flight request past its deadline.
        In-flight expiry reclaims KV/slot via ``release_fn`` — a prompt
        half-prefilled when its deadline lands must not leak a single
        block."""
        if now is None:
            now = self.clock()
        victims = [r for r in list(self.queue) if r.expired(now)]
        victims += [r for r in list(self.active.values()) if r.expired(now)]
        for req in victims:
            req.finish_reason = "deadline"
            self._finish(req, EXPIRED)
            self.counters["expired"] += 1
            if self.metrics is not None:
                self.metrics.terminal(EXPIRED).inc()
            logger.warning(f"serving: deadline expired uid={req.uid} "
                           f"(prefilled={req.prefilled}/{req.prompt_len}, "
                           f"generated={len(req.generated)})")
        return victims

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def resolve(self, uid: int) -> Optional[str]:
        """Terminal/current state for any uid ever submitted, or None for an
        unknown uid. Drills assert every admitted uid resolves terminal.
        A uid evicted from the bounded ledger resolves through the flight
        recorder's retained terminal spans."""
        if uid in self.done:
            return self.done[uid].state
        if uid in self.active:
            return self.active[uid].state
        if any(r.uid == uid for r in self.queue):
            return QUEUED
        span = self._evicted_span(uid)
        return None if span is None else span.get("state")

    def _evicted_span(self, uid: int) -> Optional[Dict]:
        from deepspeed_tpu_torch.observability.trace import get_flight_recorder

        rec = get_flight_recorder()
        return (None if rec is None
                else rec.terminal_trace((self._ledger_ns, uid)))

    def result(self, uid: int) -> Optional[ServeRequest]:
        return self.done.get(uid) or self.active.get(uid) or next(
            (r for r in self.queue if r.uid == uid), None)

    def trace(self, uid: int) -> Optional[Dict]:
        """The request's span record (queue-wait/TTFT/TPOT/e2e ms) — see
        :meth:`ServeRequest.span`. Falls back to the flight recorder's
        retained terminal spans for a uid the bounded ledger has already
        evicted; None only for a uid this process never knew."""
        req = self.result(uid)
        if req is not None:
            return req.span()
        return self._evicted_span(uid)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def queue_depth_by_priority(self) -> Dict[int, int]:
        """Queued requests broken down by admission priority — the router's
        balancing signal (also ``serving/queue_depth{priority=}``)."""
        out: Dict[int, int] = {}
        for r in self.queue:
            out[r.priority] = out.get(r.priority, 0) + 1
        return out

    def queue_depth_by_tier(self) -> Dict[str, int]:
        """Queued requests broken down by SLO tier — the fleet autoscaler's
        signal (batch-tier backlog alone must not trigger scale-up)."""
        out: Dict[str, int] = {}
        for r in self.queue:
            out[r.tier] = out.get(r.tier, 0) + 1
        return out

    def queued_by_shed_order(self) -> List[ServeRequest]:
        return sorted(self.queue, key=ServeRequest.shed_key)

    def active_by_shed_order(self) -> List[ServeRequest]:
        return sorted(self.active.values(), key=ServeRequest.shed_key)

    def decoding(self) -> List[ServeRequest]:
        return [r for r in self.active.values() if r.state == DECODING]

    def prefilling(self) -> List[ServeRequest]:
        return [r for r in self.active.values() if r.state == PREFILLING]

    def report(self) -> Dict:
        return {"queue_depth": self.queue_depth,
                "queue_depth_by_priority": self.queue_depth_by_priority(),
                "queue_depth_by_tier": self.queue_depth_by_tier(),
                "active": len(self.active),
                "paused": sum(1 for r in self.active.values()
                              if r.state == PAUSED),
                "closed": self.closed,
                "retry_after_s": round(self.current_retry_after(), 3),
                "counters": dict(self.counters),
                "shed_reasons": dict(self.shed_reasons)}
