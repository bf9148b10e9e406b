"""Continuous batching with admission control, backpressure, and drain
(counterpart of ``deepspeed_tpu/serving/batcher.py``; the engine is the
port's :class:`~deepspeed_tpu_torch.inference.InferenceEngineV2`, whose
``put`` returns fp32 numpy logits, so the batcher's work stays on the
host).

:class:`ContinuousBatcher` composes the pieces into one serving step
(`step()`), the FastGen/MII scheduling loop shape on top of
``InferenceEngineV2.put``:

1. **deadline sweep** — queued and in-flight requests past their deadline
   are expired; in-flight expiry releases every KV block through
   ``engine.flush`` (a prompt half-way through chunked prefill must not
   leak pool blocks).
2. **load shedding** — when aggregate KV occupancy or queue depth crosses
   the configured watermarks (or a ``shed_storm`` fault forces it), the
   lowest-priority / newest requests are shed with a typed
   :class:`~deepspeed_tpu_torch.serving.request.ShedError` — *before* the
   engine step, so ``put()`` never throws mid-batch on a planned schedule.
3. **admission** — queued requests are admitted oldest-first while the
   projected KV demand (prompt + max_new_tokens) stays under the admission
   watermark and the active-set cap. In DEGRADED health both caps shrink by
   ``degraded_capacity_factor`` (capacity reduction, not active eviction).
4. **one engine step** — decode tokens (1-token chunks) and the next
   prefill chunk of every prefilling request ride ONE ``put()`` batch; the
   engine's packed ragged layout does the rest. Greedy argmax on the
   returned chunk-end logits advances each sequence.

Health is STARTING → READY, with a sliding window of step outcomes driving
READY ⇄ DEGRADED, and SIGTERM (or ``begin_drain``) entering DRAINING:
admission closes, queued requests are shed retryably, in-flight sequences
finish (or are abandoned at ``drain_timeout_s``), then the loop exits —
the serving analog of the training engine's preemption-safe shutdown.

Observability: every request carries a span (admit → queue-wait → TTFT →
per-token decode → terminal) feeding the ``serving/ttft_ms`` /
``serving/tpot_ms`` / ``serving/queue_wait_ms`` SLO histograms in the
process :class:`~deepspeed_tpu_torch.observability.MetricsRegistry` (scrapeable
at ``/metrics`` via :meth:`serve_metrics_http`, with ``/healthz`` /
``/readyz`` probes mapped from the health state machine); counters and
queue/KV occupancy also stream through the monitor backends under
``serving/*``; :meth:`serving_report` mirrors the training engine's
``resilience_report()``.
"""

from __future__ import annotations

import itertools
import os
import signal
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.kv_tier import sweep_manifests
from deepspeed_tpu_torch.inference.ragged import CapacityError
from deepspeed_tpu_torch.observability import (HEALTH_CODES, HistogramWindow,
                                               MonitorBridge, ServingMetrics)
from deepspeed_tpu_torch.observability.events import get_bus
from deepspeed_tpu_torch.observability.trace import flight_dump
from deepspeed_tpu_torch.resilience.faults import InjectedIOError, get_injector
from deepspeed_tpu_torch.serving.manager import RequestManager
from deepspeed_tpu_torch.serving.request import (DECODING, PAUSED, PREFILLING,
                                                 TIER_BATCH, TIERS,
                                                 ServeRequest)
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["STARTING", "READY", "DEGRADED", "DRAINING", "ContinuousBatcher"]

STARTING, READY, DEGRADED, DRAINING = ("starting", "ready", "degraded",
                                       "draining")

#: default migration-tag uniqueness for standalone batchers (no Replica
#: wrapper to stamp name+incarnation): pid + process-lifetime sequence
_MIG_SEQ = itertools.count()

#: manifest TTL sweep cadence, in serving steps — the sweep is cheap
#: (one listdir) but not free, and abandonment is measured in seconds
_SWEEP_EVERY = 64


class ContinuousBatcher:
    #: flight dumps written for DEGRADED entries, lifetime cap (see
    #: _update_health — a health flap must not become a disk-filler)
    MAX_DEGRADED_DUMPS = 8

    def __init__(self, engine, config=None, monitor=None,
                 clock: Callable[[], float] = time.monotonic,
                 manager: Optional[RequestManager] = None,
                 registry=None):
        """``engine`` is an :class:`InferenceEngineV2` (packed+paged);
        ``config`` a :class:`~deepspeed_tpu_torch.config.config.ServingConfig`
        (None = defaults); ``monitor`` an optional object with
        ``write_events(events)`` (the reference's ``MonitorMaster``; the
        port's ``monitor/`` is not ported yet) for the ``serving/*``
        stream; ``registry`` an optional
        :class:`~deepspeed_tpu_torch.observability.MetricsRegistry` (None = the
        process-wide default that ``/metrics`` exposes). ``clock`` is
        injectable so deadline tests are deterministic."""
        if not getattr(engine, "packed", False):
            raise ValueError("ContinuousBatcher needs the packed paged "
                             "engine (InferenceEngineV2(packed=True))")
        from deepspeed_tpu_torch.config.config import ServingConfig

        self.engine = engine
        self.cfg = config if config is not None else ServingConfig()
        self.monitor = monitor
        self.clock = clock
        self.metrics = ServingMetrics(registry)
        # trace_requests gates ONLY the per-token span histograms
        # (ttft/tpot/queue_wait/e2e); lifecycle counters — terminals,
        # sheds, rejects — are one bump per transition and must keep
        # recording, or an overload incident goes invisible on /metrics
        self._trace = bool(self.cfg.trace_requests)
        self.metrics.spans_enabled = self._trace
        if manager is not None:
            self.manager = manager
            if manager.metrics is None:
                manager.metrics = self.metrics
        else:
            self.manager = RequestManager(
                max_queue_depth=self.cfg.max_queue_depth,
                default_max_new_tokens=self.cfg.default_max_new_tokens,
                default_deadline_s=self.cfg.default_deadline_s,
                retry_after_s=self.cfg.retry_after_s,
                clock=clock, metrics=self.metrics,
                max_done_history=self.cfg.max_done_history,
                default_tier=self.cfg.slo.default_tier,
                retry_after_tier_factor=dict(self.cfg.slo.retry_after_factor))
        # paused KV parks in the engine's tier store; size its host budget
        # from the serving config before the first pause forces creation
        if hasattr(self.engine, "pause_store_mb"):
            self.engine.pause_store_mb = float(self.cfg.slo.pause_host_mb)
        # cross-replica migration: point the pause store's NVMe spill at
        # the SHARED namespace (before the first pause forces creation, or
        # late-attached if the store already exists host-only) so a paused
        # request's KV is exportable to siblings
        mig = getattr(self.cfg, "migration", None)
        self._mig = mig if (mig is not None and mig.enabled) else None
        if self._mig is not None \
                and hasattr(self.engine, "migration_nvme_path"):
            self.engine.migration_nvme_path = self._mig.shared_nvme_path
        # fleet-unique donor tag prefix; a Replica overwrites this with
        # "<name>-<incarnation>" so manifests survive its own restarts
        self.migration_tag = f"solo{os.getpid()}n{next(_MIG_SEQ)}"
        # causal event bus (observability.tracing) — cached ref; the
        # singleton is mutated in place by configure_tracing
        self._ebus = get_bus()
        self.manager.release_fn = lambda uids: self.engine.flush(uids)
        self.health = STARTING
        self.drained = False
        self.drain_reason = ""
        self.steps = 0
        self._drain_requested = threading.Event()
        self._prev_sigterm = None
        # arm via trigger-file/SIGUSR2 for a live torch.profiler capture
        # (ProfileTrigger; checked once per step when set)
        self.profile_trigger = None
        self._http_server = None       # serve_metrics_http singleton
        # the bridge flushes the registry-native families; the four gauges
        # _serving_events already streams under the same tags are excluded
        # so one flush never writes a tag twice
        self._bridge = (MonitorBridge(
            monitor, self.metrics.registry, prefix="serving/",
            exclude=("serving/health", "serving/queue_depth",
                     "serving/active_requests", "serving/kv_occupancy"))
            if monitor is not None else None)
        # sliding window of step outcomes (True = failed) drives DEGRADED
        self._failures: Deque[bool] = deque(maxlen=self.cfg.failure_window)
        # recent-window view of step latency for the report/monitor stream:
        # lifetime percentiles over a long-lived replica would bury a fresh
        # regression under millions of old fast samples (the /metrics
        # histogram stays cumulative — Prometheus windows it with rate())
        self._step_window = HistogramWindow(self.metrics.step_ms)
        self.counters: Dict[str, int] = {
            "engine_steps": 0, "idle_steps": 0, "step_failures": 0,
            "decode_tokens": 0, "prefill_tokens": 0, "degraded_entries": 0,
            "prefix_hit_requests": 0, "prefix_hit_tokens": 0,
            "tier_hit_requests": 0, "tier_promoted_blocks": 0,
            "spec_rounds": 0, "spec_draft_tokens": 0,
            "spec_accepted_tokens": 0, "resume_failures": 0,
            "pause_exports": 0, "reprefill_fallbacks": 0,
            "manifests_swept": 0,
        }
        # uids paused during the CURRENT step: a pause must hold for at
        # least one full step, or the same-step resume pass would undo the
        # demote it just paid for (and re-arm the starvation guard through
        # a pointless tier-store round-trip)
        self._just_paused: set = set()
        # manifest TTL sweep tick — counts ALL steps (idle included: an
        # idle replica is exactly the one with time to collect garbage)
        self._sweep_tick = 0

    @classmethod
    def from_deepspeed_config(cls, engine, config, monitor=None, **kw):
        """Build from a full :class:`~deepspeed_tpu_torch.config.config.
        DeepSpeedTpuConfig` — the consumer of its ``serving`` section.
        Requires ``serving.enabled`` so a config that merely carries the
        block cannot silently stand up a server."""
        serving = getattr(config, "serving", None)
        if serving is None or not serving.enabled:
            raise ValueError(
                "serving.enabled must be true to build a ContinuousBatcher "
                "from a DeepSpeedTpuConfig (or pass a ServingConfig "
                "directly)")
        return cls(engine, serving, monitor=monitor, **kw)

    # ------------------------------------------------------------------
    # intake passthrough
    # ------------------------------------------------------------------
    def submit(self, prompt, **kw) -> int:
        return self.manager.submit(prompt, **kw)

    # ------------------------------------------------------------------
    # capacity accounting
    # ------------------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        return self.engine.state.allocator.num_blocks

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.engine.state.allocator.free_blocks

    @property
    def reclaimable_blocks(self) -> int:
        """Blocks held ONLY by the prefix tree: evictable on demand."""
        pc = getattr(self.engine, "prefix_cache", None)
        return pc.evictable_blocks() if pc is not None else 0

    @property
    def cache_blocks(self) -> int:
        """Blocks the prefix tree references, whether or not a live
        sequence also shares them."""
        pc = getattr(self.engine, "prefix_cache", None)
        return pc.held_blocks if pc is not None else 0

    @property
    def kv_occupancy(self) -> float:
        """Occupancy that counts against watermarks: pool space NOT
        available for new work = used minus cache blocks that are evictable
        on demand (refcount 1). A shared prefix a live sequence pins counts
        ONCE — it genuinely consumes headroom (and shedding its sharers
        would return it to evictable) — while a merely-warm cache is free
        capacity in waiting, not load."""
        return ((self.used_blocks - self.reclaimable_blocks)
                / max(1, self.num_blocks))

    def _blocks_for(self, tokens: int) -> int:
        bs = self.engine.state.allocator.block_size
        return -(-int(tokens) // bs)

    def _blocks_needed(self, req) -> int:
        """Worst-case NEW blocks a queued request needs: its full demand
        minus whatever prompt prefix is already RESIDENT in the cache — a
        90%-cached request is nearly free and should admit as such. (The
        peeked blocks can be evicted before the request reaches the engine;
        admission is worst-case-projection math already, and the engine
        re-matches at attach time.)

        Demoted-but-promotable blocks are warm capacity, not free
        capacity: a promote allocates a pool block per matched entry, so
        they stay in the block demand — but the request pays only the
        promote-latency tax for them (an async host/NVMe fetch overlapped
        under the step), never the cold prefill compute. That is exactly
        how they are costed: blocks yes, prefill no."""
        demand = req.total_token_demand
        pc = getattr(self.engine, "prefix_cache", None)
        if pc is not None and req.prompt_len > 1:
            info = pc.peek_tiers(req.prompt,
                                 max_tokens=req.prompt_len - 1)
            demand -= info["resident_tokens"]
        return self._blocks_for(demand)

    def _spec_enabled(self) -> bool:
        cfgs = getattr(self.engine, "spec_cfg", None)
        return bool(cfgs is not None and cfgs.enabled)

    def _capacity_factor(self) -> float:
        return (self.cfg.degraded_capacity_factor
                if self.health == DEGRADED else 1.0)

    def _max_active_eff(self) -> int:
        cap = self.cfg.max_active_requests or self.engine.state.max_sequences
        cap = min(cap, self.engine.state.max_sequences)
        return max(1, int(cap * self._capacity_factor()))

    def _queue_high_eff(self) -> int:
        high = (self.cfg.queue_high_watermark
                if self.cfg.queue_high_watermark is not None
                else self.cfg.max_queue_depth)
        return max(1, int(high * self._capacity_factor()))

    # ------------------------------------------------------------------
    # phases of one step
    # ------------------------------------------------------------------
    def _shed_over_watermarks(self, forced: bool,
                              storm: bool = False) -> None:
        mgr = self.manager
        if forced:
            # shed_storm drill: drop the whole queue this step, retryably
            for req in mgr.queued_by_shed_order():
                mgr.shed(req, "shed_storm")
        overflow = mgr.queue_depth - self._queue_high_eff()
        if overflow > 0:
            for req in mgr.queued_by_shed_order()[:overflow]:
                mgr.shed(req, "queue_pressure")
        slo = self.cfg.slo
        if slo.enabled and slo.preempt:
            self._preempt_over_watermarks(forced, storm)
            return
        if forced or self.kv_occupancy > self.cfg.kv_high_watermark:
            # free real blocks: evict in-flight lowest-priority/newest until
            # under the low watermark, but never the last survivor — the
            # oldest/highest-priority request must keep making progress
            victims = mgr.active_by_shed_order()
            while len(victims) > 1 \
                    and self.kv_occupancy > self.cfg.kv_low_watermark:
                mgr.shed(victims.pop(0), "kv_pressure")

    def _preempt_over_watermarks(self, forced: bool, storm: bool) -> None:
        """SLO replacement for the kv_pressure shed: under block pressure
        (or a ``preempt_storm`` drill), victims are PAUSED — their KV
        demoted into the tier store through the engine — and only shed when
        they cannot pause (no KV on device yet, store full, or the
        starvation guard / ``max_pauses`` says no). Victim order is
        :meth:`ServeRequest.preempt_key`: batch tier before throughput
        before latency, no-deadline before deadlined, most-remaining-work
        first. The last survivor is never preempted, and a ``preempt_storm``
        with slack occupancy pauses exactly one victim per step without
        shedding anyone — the drill forces the pause path, not data loss."""
        over = forced or self.kv_occupancy > self.cfg.kv_high_watermark
        if not (over or storm):
            return
        mgr = self.manager
        victims = [r for r in mgr.active.values()
                   if r.state in (PREFILLING, DECODING)]
        victims.sort(key=ServeRequest.preempt_key)
        must = 1 if storm else 0
        while len(victims) > 1 and (
                must > 0
                or (over and self.kv_occupancy > self.cfg.kv_low_watermark)):
            victim = victims.pop(0)
            if self._try_pause(victim):
                must = 0
                continue
            if storm and not over:
                continue       # storm never sheds; try the next candidate
            mgr.shed(victim, "kv_pressure")
            must = 0

    def _try_pause(self, req: ServeRequest) -> bool:
        """Demote ``req``'s KV through the tier store and park it PAUSED.
        False (caller falls back to shedding) when the starvation guard or
        pause budget refuses, or the engine cannot extract/park the blocks —
        in which case the engine guarantees no side effects."""
        slo = self.cfg.slo
        if not req.pause_allowed() or req.pause_count >= slo.max_pauses:
            return False
        t0 = self.clock()
        if not self.engine.pause_request(req.uid):
            return False
        self.manager.pause(req)
        self._just_paused.add(req.uid)
        self.metrics.preemption(req.tier).inc()
        if self._trace:
            self.metrics.pause_ms.observe((self.clock() - t0) * 1e3)
        if self._mig is not None:
            self._export_manifest(req)
        return True

    # ------------------------------------------------------------------
    # cross-replica migration (durable manifests on the shared tier)
    # ------------------------------------------------------------------
    def _export_manifest(self, req: ServeRequest) -> None:
        """Donor-side crash backup: write the portable resume manifest for
        a freshly paused request onto the shared namespace. Best-effort —
        a failed export (IO error, injected crash/tear) leaves the pause
        itself intact, and a later crash falls down the re-prefill ladder
        instead of resuming from durable KV."""
        try:
            path = self.engine.export_paused(
                req.uid, f"{self.migration_tag}-{req.uid}",
                self._mig.shared_nvme_path)
        except Exception as e:
            logger.warning(
                f"serving: pause export failed uid={req.uid}: {e}")
            return
        if path is not None:
            self.counters["pause_exports"] += 1

    def adopt_inflight(self, donor: ServeRequest, payload=None,
                       manifest_path: Optional[str] = None, *,
                       deadline_s: Optional[float] = None,
                       migrated_from: Optional[str] = None) -> ServeRequest:
        """Adopt a request severed from (or exported by) another replica,
        under a FRESH local uid.

        With a manifest ``payload`` the donor's durable tier entries are
        registered into this engine's pause store and the request lands
        PAUSED — the normal resume pass promotes KV this replica never
        produced, greedy tokens bit-identical. Without one it lands QUEUED
        with the replay stream armed (re-prefill: recompute lost KV from
        token history, never zero-fill). Raises
        :class:`~deepspeed_tpu_torch.serving.request.ShedError` when the queue
        path refuses (draining / full); an engine-adopt failure unwinds
        the manager ledger so the new uid is never exposed half-built."""
        if payload is None:
            return self.manager.adopt(donor, deadline_s=deadline_s,
                                      migrated_from=migrated_from,
                                      paused=False)
        req = self.manager.adopt(donor, deadline_s=deadline_s,
                                 migrated_from=migrated_from, paused=True)
        try:
            self.engine.adopt_paused(req.uid, payload,
                                     manifest_path=manifest_path)
        except BaseException:
            self.manager.drop_adopted(req)
            raise
        return req

    def export_paused_for_rebalance(
            self, max_requests: int = 0) -> List[Tuple[ServeRequest, str]]:
        """Voluntarily hand off paused batch-tier work: export each
        candidate's manifest with ownership transferred (``keep=False``),
        resolve it locally as silently rebalanced (no backpressure
        signal), and return ``(request, manifest_path)`` pairs for the
        router to adopt on an idle sibling. A request whose export fails
        stays paused here — rebalance never loses work to hand it off."""
        if self._mig is None:
            return []
        out: List[Tuple[ServeRequest, str]] = []
        for req in self.manager.paused():
            if req.tier != TIER_BATCH:
                continue
            if max_requests and len(out) >= max_requests:
                break
            if req.uid in self._just_paused:
                continue       # same one-full-step hold as the resume pass
            try:
                path = self.engine.export_paused(
                    req.uid, f"{self.migration_tag}-{req.uid}",
                    self._mig.shared_nvme_path, keep=False)
            except Exception as e:
                logger.warning(f"serving: rebalance export failed "
                               f"uid={req.uid}: {e}")
                continue
            if path is None:
                continue
            self.manager.migrate_out(req)
            out.append((req, path))
        return out

    def _resume_paused(self) -> None:
        """Rejoin paused requests when capacity allows — they are warm
        capacity, not cold queue: their KV promotes back from the tier
        store (no prefill recompute) under the same projection budget
        admission charges new work. Latency tier first, earliest pause
        first, up to ``slo.resume_max_per_step`` per step. A resume whose
        demoted entries were lost (tier spill, injected IO error) is shed
        retryably as ``resume_io_error`` — never silently zero-filled; a
        MIGRATED request falls back to re-prefill from token history
        instead, so a sibling's bad tier read costs recompute, not the
        request."""
        slo = self.cfg.slo
        if not (slo.enabled and slo.preempt):
            return
        mgr = self.manager
        plist = mgr.paused()
        if not plist:
            return
        budget = self.num_blocks * self.cfg.kv_high_watermark \
            * self._capacity_factor()
        proj = self._projected_blocks()
        # nothing queued and nothing runnable: the pool is idle, so the
        # budget gate must not strand the last paused requests forever
        idle_pool = not mgr.queue and all(
            r.state == PAUSED for r in mgr.active.values())
        resumed = 0
        for req in plist:
            if resumed >= slo.resume_max_per_step:
                break
            if req.uid in self._just_paused:
                continue       # paused THIS step; hold at least one step
            full = self._blocks_for(req.total_token_demand)
            if not idle_pool and proj + full > budget:
                continue       # over budget now; later (smaller) may fit
            if not self.engine.can_resume(req.uid):
                continue       # no slot/blocks this step; stays parked
            t0 = self.clock()
            ok = self.engine.resume_request(req.uid)
            # force the promote now so a lost/unreadable entry surfaces
            # BEFORE the request rejoins the plan
            lost = self.engine.flush_resumes()
            if req.uid in lost:
                self.counters["resume_failures"] += 1
                if req.migrated_from is not None:
                    # adopted KV unreadable mid-promote: the engine already
                    # unwound the resume and dropped the adopted entries —
                    # recompute from token history instead of shedding work
                    # a sibling already paid for (recompute, never zero-fill)
                    mgr.requeue_for_replay(req)
                    self.counters["reprefill_fallbacks"] += 1
                    self.metrics.reprefill_fallbacks.inc()
                else:
                    mgr.shed(req, "resume_io_error")
                continue
            if not ok:
                continue       # capacity race; still parked, retried later
            mgr.resume_admit(req)
            proj += full
            resumed += 1
            idle_pool = False
            if self._trace:
                self.metrics.resume_ms.observe((self.clock() - t0) * 1e3)

    def _projected_blocks(self) -> int:
        """Worst-case pool demand of everything already admitted: blocks
        held now plus what each active request may still need to reach
        prompt + max_new_tokens. Admission budgets against THIS, not live
        occupancy — otherwise several admissions in one sweep would each
        see the same pre-admission pool and jointly overcommit it, only to
        strand each other mid-generation under kv_pressure sheds."""
        seqs = self.engine.state.sequences
        # evictable (refcount-1) cache blocks are not load; blocks pinned
        # by live sharers count once — subtracting ALL tree blocks would
        # hide pinned KV from the budget and overcommit the pool
        proj = self.used_blocks - self.reclaimable_blocks
        for r in self.manager.active.values():
            if r.state == PAUSED:
                # parked: holds no pool blocks, and counting its comeback
                # here would keep the HBM the pause just freed unusable —
                # resume re-budgets it through _resume_paused instead
                continue
            held = len(seqs[r.uid].blocks) if r.uid in seqs else 0
            proj += max(0, self._blocks_for(r.total_token_demand) - held)
        return proj

    def _tier_projection(self) -> Dict[str, int]:
        """Worst-case pool demand per SLO tier (paused requests excluded,
        same as :meth:`_projected_blocks`) — the denominator the per-tier
        admission budgets are checked against."""
        out: Dict[str, int] = {}
        for r in self.manager.active.values():
            if r.state == PAUSED:
                continue
            out[r.tier] = out.get(r.tier, 0) \
                + self._blocks_for(r.total_token_demand)
        return out

    def _admit(self) -> None:
        mgr = self.manager
        budget = self.num_blocks * self.cfg.kv_high_watermark \
            * self._capacity_factor()
        proj = self._projected_blocks()
        slo = self.cfg.slo
        slo_on = bool(slo.enabled)
        tier_proj = self._tier_projection() if slo_on else {}
        # snapshot: with tiers on, an over-budget tier's head WAITS without
        # blocking requests from other tiers queued behind it
        for req in list(mgr.queue):
            if len(mgr.active) >= self._max_active_eff():
                break
            # prefix-aware: only the UNCACHED share of the demand counts
            need = self._blocks_needed(req)
            full = self._blocks_for(req.total_token_demand)
            if req.total_token_demand > self.engine.max_seq_len \
                    or full \
                    > self.num_blocks * self.cfg.kv_high_watermark:
                # can never fit, at any load (the cache is transient, so
                # oversize is judged on the full demand) — terminal
                mgr.shed(req, "oversize", retryable=False)
                continue
            if slo_on:
                frac = float(slo.budgets.get(req.tier, 1.0))
                if frac < 1.0 \
                        and tier_proj.get(req.tier, 0) + full \
                        > frac * budget:
                    # the tier is over its admission share: WAIT (never a
                    # terminal shed) and let other tiers admit past it
                    continue
            if proj + need > budget:
                if not mgr.active:
                    # nothing in flight will ever free blocks for this head
                    # (a DEGRADED budget squeeze, or an externally occupied
                    # pool): shed retryably instead of leaving the loop to
                    # spin forever on an unadmittable head
                    mgr.shed(req, "capacity")
                    continue
                break          # FIFO head-of-line: don't starve big requests
            mgr.admit(req)
            if slo_on:
                tier_proj[req.tier] = tier_proj.get(req.tier, 0) + full
            if getattr(self.engine, "prefix_cache", None) is not None:
                pc = self.engine.prefix_cache
                promoted0 = pc.counters["promoted_blocks"]
                hit = self.engine.prefix_attach(req.uid, req.prompt)
                if hit:
                    # the cached prefix is already in KV: prefill starts at
                    # the suffix, and TTFT shrinks by the cached fraction
                    req.prefilled = hit
                    self.counters["prefix_hit_requests"] += 1
                    self.counters["prefix_hit_tokens"] += hit
                    promoted = pc.counters["promoted_blocks"] - promoted0
                    if promoted > 0:
                        # warm-but-demoted share: served from host/NVMe via
                        # async promote instead of recompute — the "nearly
                        # free" hit the tier projection priced in
                        self.counters["tier_hit_requests"] += 1
                        self.counters["tier_promoted_blocks"] += promoted
            # O(1) exact projection update for hit and miss alike: the
            # admitted request's remaining need plus the blocks its attach
            # just pinned out of the reclaimable set sum to its full
            # worst-case footprint (the attach is full-block granular). A
            # prefix another ACTIVE request already pinned double-counts
            # until the next sweep's fresh _projected_blocks() — the
            # conservative direction
            proj += self._blocks_for(req.total_token_demand)

    def _plan(self) -> List[ServeRequest]:
        """The step's participants: every decoding request (1 token) and
        every prefilling request (next prompt chunk), trimmed by the joint
        schedulability check — over-demand sheds lowest-priority/newest
        BEFORE put() so the engine never throws mid-batch."""
        chunk = self.cfg.prefill_chunk
        batch = self.manager.decoding() + self.manager.prefilling()
        if not batch:
            return []
        spec = self._spec_enabled()

        def demand(r):
            if r.state == DECODING:
                # a spec round schedules up to 1 + K tokens (drafts verify
                # into KV even when rejected) — plan for the worst case
                return 1 + self._spec_cap(r) if spec else 1
            return min(chunk, r.feed_len - r.prefilled)

        while batch and not self.engine.state.can_schedule_batch(
                [r.uid for r in batch], [demand(r) for r in batch]):
            victim = max(batch, key=lambda r: (
                -r.priority, r.submitted_at))  # lowest priority, then newest
            batch.remove(victim)
            self.manager.shed(victim, "capacity")
        return batch

    def _spec_cap(self, req: ServeRequest) -> int:
        """Max drafts worth verifying for this request: never draft past
        ``max_new_tokens`` (emitted per round ≤ drafts + 1)."""
        cap = req.max_new_tokens - len(req.generated) - 1
        return max(0, min(int(self.engine.spec_cfg.max_draft), cap))

    def _emit_token(self, req: ServeRequest, nxt: int) -> bool:
        """Record one generated token; returns True if the request reached a
        terminal state (eos / length)."""
        req.generated.append(nxt)
        if len(req.generated) == 1 and req.trace_id is not None \
                and self._ebus.enabled:
            self._ebus.async_instant(
                "request", "request", req.trace_id,
                args={"subsys": "batcher", "what": "first_token",
                      "uid": req.uid})
        if self._trace:
            now = self.clock()
            if req.first_token_at is None:
                req.first_token_at = now
                v = (now - req.submitted_at) * 1e3
                self.metrics.ttft_ms.observe(v)
                self.metrics.ttft_tier(req.tier).observe(v)
            else:
                v = (now - req.last_token_at) * 1e3
                self.metrics.tpot_ms.observe(v)
                self.metrics.tpot_tier(req.tier).observe(v)
            req.last_token_at = now
        if self.cfg.eos_token_id is not None \
                and nxt == self.cfg.eos_token_id:
            self.manager.complete(req, "eos")
            return True
        if len(req.generated) >= req.max_new_tokens:
            self.manager.complete(req, "length")
            return True
        req.next_token = nxt
        return False

    def _advance(self, req: ServeRequest, fed: int, logits) -> None:
        """Commit one put()'s outcome for one request. The argmax of this
        step's logits IS a generated token, counted and completion-checked
        immediately — a request's last token never rides an extra decode
        step (whose logits would be discarded) just to be recorded."""
        if req.state == PREFILLING:
            req.prefilled += fed
            self.counters["prefill_tokens"] += fed
            if req.prefilled < req.feed_len:
                return
            if req.replay is not None:
                # re-prefill complete: the lost KV is recomputed. These
                # final logits predict the already-known last generated
                # token — DISCARD them (nothing is re-emitted to the
                # client) and continue decoding from that token
                req.replay = None
                req.prefilled = req.prompt_len
                req.state = DECODING
                if req.trace_id is not None and self._ebus.enabled:
                    self._ebus.async_instant(
                        "request", "request", req.trace_id,
                        args={"subsys": "batcher", "what": "replay_done",
                              "uid": req.uid,
                              "generated": len(req.generated)})
                return
            req.state = DECODING
            if req.trace_id is not None and self._ebus.enabled:
                self._ebus.async_instant(
                    "request", "request", req.trace_id,
                    args={"subsys": "batcher", "what": "prefill_done",
                          "uid": req.uid, "prefilled": req.prefilled})
        else:
            self.counters["decode_tokens"] += 1
        self._emit_token(req, int(np.argmax(np.asarray(logits))))

    def _advance_spec(self, req: ServeRequest, emitted) -> None:
        """Commit a spec round's emitted tokens (1..K+1). An eos inside the
        accepted run truncates there; the extra KV the verify step committed
        is reclaimed by the terminal flush like any other over-allocation."""
        for tok in emitted:
            self.counters["decode_tokens"] += 1
            if self._emit_token(req, int(tok)):
                return

    def step(self) -> bool:
        """One serving iteration; returns True if an engine step ran."""
        bus = self._ebus
        if not bus.enabled:
            return self._step_impl()
        # the span's with-block guarantees the E lands on every exit path
        # (the dslint event-span discipline); engine put/spec spans nest
        # inside it on this thread, giving the per-step causal stack
        with bus.span("batcher", "step", args={"step": self.steps,
                                               "health": self.health}):
            return self._step_impl()

    def _step_impl(self) -> bool:
        t0 = self.clock()
        if self._drain_requested.is_set() and self.health != DRAINING:
            self.begin_drain("SIGTERM")
        inj = get_injector()
        self.manager.expire()
        self._just_paused.clear()
        self._sweep_tick += 1
        if self._mig is not None and self._mig.manifest_ttl_s > 0 \
                and self._sweep_tick % _SWEEP_EVERY == 0:
            try:
                self.counters["manifests_swept"] += sweep_manifests(
                    self._mig.shared_nvme_path, self._mig.manifest_ttl_s)
            except OSError as e:
                logger.warning(f"serving: manifest sweep failed: {e}")
        if self.health != DRAINING:
            self._shed_over_watermarks(
                forced=bool(inj) and inj.shed_forced(),
                storm=bool(inj) and inj.preempt_forced())
            self._admit()
        # resumes run even while DRAINING: a paused request is in-flight
        # work the drain must finish, not queue to shed
        self._resume_paused()
        batch = self._plan()
        if not batch:
            self.counters["idle_steps"] += 1
            if self.health == DRAINING and not self.manager.active:
                self.drained = True
            return False
        chunk = self.cfg.prefill_chunk
        # with speculation on, DECODING requests WITH a draft leave the
        # put() batch for a draft-verify round (multiple tokens per step);
        # draft-less decodes and prefill chunks keep riding the one packed
        # put() — no second dispatch unless there is something to verify
        spec_on = self._spec_enabled()
        spec_batch, spec_drafts = [], []
        if spec_on:
            decoding = [r for r in batch if r.state == DECODING]
            if decoding:
                drafts = self.engine.draft_tokens(
                    [r.uid for r in decoding],
                    [r.next_token for r in decoding],
                    [self._spec_cap(r) for r in decoding])
                for r, d in zip(decoding, drafts):
                    if len(d):
                        spec_batch.append(r)
                        spec_drafts.append(d)
        spec_set = {r.uid for r in spec_batch}
        put_batch = [r for r in batch if r.uid not in spec_set]
        uids, chunks = [], []
        for r in put_batch:
            uids.append(r.uid)
            chunks.append(np.asarray([r.next_token], np.int32)
                          if r.state == DECODING
                          else r.feed_source[r.prefilled:r.prefilled
                                             + chunk])
        failed = None
        try:
            inj.on_serving_step(
                "decode" if any(r.state == DECODING for r in batch)
                else "prefill")
            results = self.engine.put(uids, chunks) if put_batch else {}
        except CapacityError as e:
            # backstop only — _plan() pre-checks joint schedulability; a race
            # (or an engine-internal reject) sheds one victim and yields
            victim = max(batch, key=lambda r: (-r.priority, r.submitted_at))
            self.manager.shed(victim, "capacity")
            failed = f"capacity: {e}"
        except (InjectedIOError, OSError) as e:
            # environmental (cache IO, transport): the step never committed,
            # every request keeps its position and retries next step
            failed = f"io: {e}"
        if failed is None:
            for r, c in zip(put_batch, chunks):
                logits = inj.maybe_poison_logits(results[r.uid]) if inj \
                    else results[r.uid]
                if not np.all(np.isfinite(np.asarray(logits, np.float32))):
                    # the engine committed this token/chunk to KV, so there
                    # is no clean retry point — resolve the request loudly
                    self.manager.shed(r, "decode_failure")
                    failed = f"non-finite logits uid={r.uid}"
                    continue
                self._advance(r, len(c), logits)
        if failed is None and spec_batch:
            # the put() above already committed — run the spec round second
            # so a failure here never strands put()'s advanced requests
            try:
                res, info = self.engine.spec_decode_round(
                    [r.uid for r in spec_batch],
                    [r.next_token for r in spec_batch],
                    drafts=spec_drafts)
            except CapacityError as e:
                victim = max(spec_batch,
                             key=lambda r: (-r.priority, r.submitted_at))
                self.manager.shed(victim, "capacity")
                failed = f"capacity: {e}"
            except (InjectedIOError, OSError) as e:
                failed = f"io: {e}"   # round uncommitted; retried next step
            else:
                self.counters["spec_rounds"] += 1
                self.counters["spec_draft_tokens"] += info["drafted"]
                self.counters["spec_accepted_tokens"] += info["accepted"]
                self.metrics.record_spec_round(info["drafted"],
                                               info["accepted"])
                bad = set(info.get("nonfinite_uids", ()))
                for r in spec_batch:
                    if r.uid in bad:
                        # mirror of the put() non-finite guard: the verify
                        # forward committed KV, so there is no clean retry
                        # point — resolve loudly instead of streaming an
                        # argmax-of-NaN token
                        self.manager.shed(r, "decode_failure")
                        failed = f"non-finite logits uid={r.uid}"
                        continue
                    self._advance_spec(r, res[r.uid])
        self.steps += 1
        self.counters["engine_steps"] += 1
        self.metrics.step_ms.observe((self.clock() - t0) * 1e3)
        if self.steps % 256 == 0:      # same horizon as the old 256-deque
            self._step_window.roll()
        if failed is not None:
            self.counters["step_failures"] += 1
            logger.warning(f"serving: step {self.steps} failed ({failed})")
        self._failures.append(failed is not None)
        self._update_health()
        self._update_gauges()
        if self.profile_trigger is not None:
            self.profile_trigger.check(self.steps)
        if self.monitor is not None \
                and self.steps % max(1, self.cfg.monitor_interval) == 0:
            self.monitor.write_events(self._serving_events())
            self._bridge.flush(self.steps)
        return True

    def pump(self, max_steps: Optional[int] = None) -> int:
        """Step until no work remains (or drain completes / ``max_steps``).
        Returns the number of engine steps executed."""
        ran = 0
        while max_steps is None or ran < max_steps:
            if self.drained:
                break
            progressed = self.step()
            if progressed:
                ran += 1
                continue
            if self.health == DRAINING or (
                    not self.manager.queue and not self.manager.active):
                break
        return ran

    # ------------------------------------------------------------------
    # health + drain
    # ------------------------------------------------------------------
    def _update_health(self) -> None:
        if self.health == DRAINING:
            return
        window = self._failures
        ratio = (sum(window) / len(window)) if window else 0.0
        if self.health == STARTING and window and not window[-1]:
            self.health = READY
        if len(window) == window.maxlen:
            if self.health == READY \
                    and ratio >= self.cfg.degrade_failure_ratio:
                self.health = DEGRADED
                self.counters["degraded_entries"] += 1
                logger.warning(
                    f"serving: DEGRADED (failure ratio {ratio:.2f} over "
                    f"last {len(window)} steps); capacity reduced to "
                    f"{self.cfg.degraded_capacity_factor:.0%}")
                if self._ebus.enabled:
                    self._ebus.instant("batcher", "degraded",
                                       args={"step": self.steps,
                                             "failure_ratio": ratio})
                # black-box the window that degraded us: the last N steps'
                # events are exactly what the operator needs to see. Capped:
                # a replica flapping READY<->DEGRADED on borderline load
                # must not fill the disk with a dump per oscillation — the
                # first few black boxes tell the story, the counters and
                # the degraded instant keep telling it after
                if self.counters["degraded_entries"] \
                        <= self.MAX_DEGRADED_DUMPS:
                    flight_dump(
                        "batcher_degraded",
                        extra={"step": self.steps, "failure_ratio": ratio},
                        key=f"degraded-{self.counters['degraded_entries']}")
            elif self.health == DEGRADED \
                    and ratio <= self.cfg.degrade_failure_ratio / 2:
                self.health = READY
                logger.warning("serving: recovered to READY "
                               f"(failure ratio {ratio:.2f})")

    def install_signal_handlers(self) -> None:
        """SIGTERM → graceful drain at the next step boundary (preemption
        parity with the training engine's emergency save)."""
        def _on_sigterm(signum, frame):
            logger.warning("serving: SIGTERM — draining")
            self._drain_requested.set()
        self._prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)

    def restore_signal_handlers(self) -> None:
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    def begin_drain(self, reason: str = "drain") -> None:
        """Stop admitting; shed the queue retryably; in-flight work keeps
        stepping until done (or :meth:`drain`'s timeout abandons it)."""
        if self.health == DRAINING:
            return
        self.health = DRAINING
        self.drain_reason = reason
        if self._ebus.enabled:
            self._ebus.instant("batcher", "drain_begin",
                               args={"reason": reason, "step": self.steps,
                                     "in_flight": len(self.manager.active)})
        self.manager.close(reason)
        for req in list(self.manager.queue):
            self.manager.shed(req, "draining")
        logger.warning(f"serving: draining ({reason}); "
                       f"{len(self.manager.active)} in flight")

    def drain(self, timeout_s: Optional[float] = None) -> Dict:
        """Run the drain to completion: finish in-flight sequences, abandon
        whatever outlives ``timeout_s`` (KV reclaimed, requests resolved as
        shed ``drain_timeout``), then mark the batcher drained."""
        if self.health != DRAINING:
            self.begin_drain()
        deadline = self.clock() + (timeout_s if timeout_s is not None
                                   else self.cfg.drain_timeout_s)
        while self.manager.active and self.clock() < deadline:
            self.step()
        for req in list(self.manager.active.values()):
            self.manager.shed(req, "drain_timeout")
        self.drained = True
        self._update_gauges()
        if self.monitor is not None:
            self.monitor.write_events(self._serving_events())
            self._bridge.flush(self.steps)
        logger.warning(f"serving: drained ({self.drain_reason}); "
                       f"completed={self.manager.counters['completed']} "
                       f"shed={self.manager.counters['shed']} "
                       f"expired={self.manager.counters['expired']}")
        return self.serving_report()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def _update_gauges(self) -> None:
        """Registry gauges refreshed once per step (host floats only)."""
        mx = self.metrics
        mx.set_health(self.health)
        mx.queue_depth.set(float(self.manager.queue_depth))
        mx.set_queue_depths(self.manager.queue_depth_by_priority())
        mx.set_queue_depth_tiers(self.manager.queue_depth_by_tier())
        mx.active_requests.set(float(len(self.manager.active)))
        mx.kv_occupancy.set(float(self.kv_occupancy))
        mx.paused_requests.set(float(len(self.manager.paused())))

    def _latency_pct(self, q: float) -> float:
        return float(self._step_window.percentile(q))

    def serve_metrics_http(self, host: str = "127.0.0.1", port: int = 0):
        """Mount ``/metrics`` + ``/healthz`` / ``/readyz`` for this batcher
        (readiness follows READY/DEGRADED; a DRAINING replica reports
        not-ready but stays live). Returns the started
        :class:`~deepspeed_tpu_torch.observability.ObservabilityServer`; the
        serving front-end (:mod:`deepspeed_tpu_torch.serving.frontend`) mounts
        its API routes on the same mux. Idempotent: a second call returns
        the already-running server instead of binding a second socket —
        the first server must not leak unclosable behind the second. A
        cached server closed externally is replaced, not returned dead. A
        repeat call asking for a DIFFERENT bind address than the running
        server's gets the running server back with a loud warning — the
        requested address is not silently honoured."""
        if self._http_server is not None and not self._http_server.closed:
            import socket

            srv = self._http_server

            def _resolves_to_bound(h: str) -> bool:
                if h == srv.host or srv.host in ("0.0.0.0", "::"):
                    return True        # wildcard bind serves any host
                try:                   # "localhost" vs the resolved
                    return socket.gethostbyname(h) == srv.host
                except OSError:
                    return False

            if not _resolves_to_bound(host) or (port != 0
                                                and port != srv.port):
                logger.warning(
                    f"serving: metrics server already bound at {srv.url}; "
                    f"ignoring requested bind {host}:{port} — close() it "
                    f"first to rebind")
            return srv
        from deepspeed_tpu_torch.observability import ObservabilityServer

        self._http_server = ObservabilityServer.for_batcher(
            self, registry=self.metrics.registry, host=host,
            port=port).start()
        return self._http_server

    def close(self) -> None:
        """Idempotent teardown of everything the batcher stood up outside
        itself: the metrics HTTP server (joined, socket released) and the
        SIGTERM handler. Does NOT drain — call :meth:`drain` first when
        in-flight work matters."""
        if self._http_server is not None:
            self._http_server.close()
            self._http_server = None
        self.restore_signal_handlers()

    def request_trace(self, uid: int) -> Optional[Dict]:
        """Span record for any uid ever submitted (see ServeRequest.span)."""
        return self.manager.trace(uid)

    def serving_report(self) -> Dict:
        """The serving mirror of the training engine's
        ``resilience_report()`` — everything a drill or dashboard needs in
        one dict."""
        m = self.manager
        slo = {
            name: {"p50": round(h.percentile(50), 3),
                   "p95": round(h.percentile(95), 3),
                   "p99": round(h.percentile(99), 3),
                   "samples": h.count}
            for name, h in (("ttft", self.metrics.ttft_ms),
                            ("tpot", self.metrics.tpot_ms),
                            ("queue_wait", self.metrics.queue_wait_ms))
        }
        pc = getattr(self.engine, "prefix_cache", None)
        spec = (dict(self.engine.spec_stats)
                if self._spec_enabled() else None)
        return {
            "health": self.health,
            "drained": self.drained,
            "drain_reason": self.drain_reason,
            "steps": self.steps,
            "counters": {**m.counters, **self.counters},
            "shed_reasons": dict(m.shed_reasons),
            "queue_depth": m.queue_depth,
            "queue_depth_by_priority": m.queue_depth_by_priority(),
            "queue_depth_by_tier": m.queue_depth_by_tier(),
            "retry_after_s": round(m.current_retry_after(), 3),
            "retry_after_by_tier": {
                t: round(m.current_retry_after(t), 3) for t in TIERS},
            "active_requests": len(m.active),
            "paused_requests": len(m.paused()),
            "kv": {"num_blocks": self.num_blocks,
                   "used_blocks": self.used_blocks,
                   "free_blocks": self.num_blocks - self.used_blocks,
                   "cache_blocks": self.cache_blocks,
                   "reclaimable_blocks": self.reclaimable_blocks,
                   "occupancy": round(self.kv_occupancy, 4),
                   "tiers": (self.engine.tier_report()
                             if hasattr(self.engine, "tier_report")
                             else None)},
            "prefix_cache": pc.report() if pc is not None else None,
            "speculative": spec,
            "decode_kernel": {
                "kernel": getattr(self.engine, "decode_kernel", None),
                "mode": getattr(self.engine, "decode_kernel_mode", None),
                "fallback_reason":
                    getattr(self.engine, "decode_kernel_reason", "") or None,
            },
            "latency_ms": {"p50": round(self._latency_pct(50), 3),
                           "p99": round(self._latency_pct(99), 3),
                           "samples": self._step_window.count},
            "slo_ms": slo,
        }

    # one health encoding for the monitor stream AND the registry gauge —
    # observability.tracing.HEALTH_CODES is the single source of truth
    _HEALTH_CODES = HEALTH_CODES

    def _serving_events(self):
        """The ``serving/*`` monitor stream (one gauge per counter), keyed
        by serving step the way training events key on samples."""
        s = self.steps
        m = self.manager
        events = [("serving/health", float(HEALTH_CODES[self.health]),
                   s),
                  ("serving/queue_depth", float(m.queue_depth), s),
                  ("serving/active_requests", float(len(m.active)), s),
                  ("serving/kv_occupancy", float(self.kv_occupancy), s),
                  ("serving/step_p50_ms", self._latency_pct(50), s),
                  ("serving/step_p99_ms", self._latency_pct(99), s)]
        events.append(("serving/paused_requests",
                       float(len(m.paused())), s))
        for k in ("submitted", "rejected", "admitted", "completed", "shed",
                  "expired", "cancelled", "paused", "resumed"):
            events.append((f"serving/{k}", float(m.counters[k]), s))
        for k in ("engine_steps", "step_failures", "decode_tokens",
                  "prefill_tokens", "degraded_entries", "resume_failures",
                  "reprefill_fallbacks"):
            events.append((f"serving/{k}", float(self.counters[k]), s))
        return events
