"""Multi-replica serving: replica workers and the load-spreading router
(counterpart of ``deepspeed_tpu/serving/router.py``).

Two pieces turn N single-process :class:`ContinuousBatcher` instances into
one request plane (the FastGen/MII product-layer shape above
``InferenceEngineV2``):

* :class:`Replica` — owns ONE batcher and the only thread that ever
  touches it. The batcher is deliberately not thread-safe (its step loop
  is the concurrency model), so every cross-thread operation — submit,
  cancel, drain-capture, report — travels through an inbox queue into the
  worker loop, which interleaves command handling with ``batcher.step()``
  and publishes per-step completions (token by token) to each request's
  subscriber queue. That publication stream is what the HTTP front-end
  frames as SSE events.

* :class:`ReplicaRouter` — spreads submits across replicas
  **least-loaded-first** (queue depth + active set + projected worst-case
  KV, the same numbers ``serving_report()`` exposes), skips DRAINING
  replicas per the readiness semantics (``/readyz`` 503 ⇒ don't route),
  retries retryable sheds on siblings before surfacing the 429, and — the
  drain contract — migrates a draining replica's queued-but-unstarted
  requests onto siblings instead of letting them die with it. A migrated
  request keeps its router uid, priority, remaining deadline, and its
  event stream; the client never learns its replica died.

SIGTERM parity with the single-replica batcher: ``install_signal_handlers``
maps SIGTERM onto a drain (of one named replica or the whole pool) with
migration, run from a helper thread so the signal handler itself stays
async-safe.

Elastic lifecycle (the hooks of :class:`~deepspeed_tpu_torch.serving.
fleet.FleetController`): every
:class:`Replica` carries a process-unique ``incarnation`` token, and routes
remember the incarnation that minted their uid. A crashed replica's queued
requests are captured post-mortem (:meth:`Replica.capture_dead`) and
re-homed by :meth:`ReplicaRouter.fail_over`; the respawn
rejoins through :meth:`ReplicaRouter.readmit`, which retires the dead
incarnation's terminal ledger so pool-level ``resolve()`` keeps answering
for uids minted before the crash — a respawned replica numbers its uids
from 0 again, and without the incarnation check uid 5 of the NEW batcher
would answer for uid 5 of the dead one.
"""

from __future__ import annotations

import itertools
import os
import queue
import signal
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.inference.kv_tier import (ManifestError,
                                                   claim_manifest,
                                                   load_manifest)
from deepspeed_tpu_torch.observability.events import SAMPLED_OUT, get_bus
from deepspeed_tpu_torch.observability.trace import flight_dump
from deepspeed_tpu_torch.resilience.faults import get_injector
from deepspeed_tpu_torch.serving.batcher import DEGRADED, DRAINING, READY
from deepspeed_tpu_torch.serving.protocol import terminal_record
from deepspeed_tpu_torch.serving.request import (CANCELLED, PAUSED, QUEUED,
                                                 TIER_BATCH, ServeRequest,
                                                 ShedError)
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["Replica", "ReplicaRouter"]

# process-unique replica incarnation tokens: a respawn under the SAME name
# must never be mistaken for the batcher that died (uids restart from 0)
_INCARNATIONS = itertools.count()



class _Sub:
    """One request's event subscription: the consumer queue plus how many
    generated tokens have already been published to it."""

    __slots__ = ("events", "sent")

    def __init__(self, events: "queue.Queue"):
        self.events = events
        self.sent = 0


class Replica:
    """A named serving replica: one batcher + its single worker thread."""

    def __init__(self, name: str, batcher, idle_sleep_s: float = 0.002,
                 submit_timeout_s: float = 30.0):
        self.name = name
        self.batcher = batcher
        self.idle_sleep_s = float(idle_sleep_s)
        self.submit_timeout_s = float(submit_timeout_s)
        self.inbox: "queue.Queue" = queue.Queue()
        self.paused = False            # test hook: commands yes, steps no
        self.incarnation = next(_INCARNATIONS)
        # fleet-unique manifest tag: migration manifests this replica
        # writes must survive its own respawn (batcher uids restart from
        # 0 under a new incarnation; the tag never collides)
        if hasattr(batcher, "migration_tag"):
            batcher.migration_tag = f"{name}-{self.incarnation}"
        self.crash_error: Optional[BaseException] = None
        self._subs: Dict[int, _Sub] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # written only by the worker, read lock-free by the router: a plain
        # dict REPLACED atomically each step, never mutated in place
        self.stats: Dict = {"health": batcher.health, "queue_depth": 0,
                            "active": 0, "projected_kv": 0.0,
                            "kv_occupancy": 0.0, "drained": False,
                            "beat": time.monotonic(), "retry_after": 0.0,
                            "sheds": 0}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "Replica":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name=f"dstpu-replica-{self.name}",
                daemon=True)
            self._thread.start()
        return self

    def interrupt(self, timeout_s: float = 5.0) -> bool:
        """Ask the worker to stop and wait briefly; True once it is dead.
        The hung-heartbeat recovery path: a worker stuck inside a step
        cannot be preempted from outside, so the controller interrupts,
        and only proceeds to :meth:`capture_dead` when the thread actually
        exited (False = still wedged, retry next poll)."""
        self._stop.set()
        self.inbox.put(None)
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
        return not self.alive

    def close(self) -> None:
        """Idempotent: stop and join the worker, fail queued commands,
        resolve live subscriptions as ``server_shutdown``, and tear down
        the batcher's own resources (HTTP server, signal handlers)."""
        self._stop.set()
        self.inbox.put(None)           # wake an idle-parked worker
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        while True:                    # unblock any caller still waiting
            try:
                cmd = self.inbox.get_nowait()
            except queue.Empty:
                break
            if cmd is not None:
                cmd[2].set_exception(ShedError(
                    "replica_unavailable", retryable=True,
                    retry_after_s=1.0, detail=f"{self.name} closed"))
        for uid, sub in list(self._subs.items()):
            req = self.batcher.manager.result(uid)
            if req is None:
                rec = {"state": CANCELLED,
                       "finish_reason": "server_shutdown", "tokens": [],
                       "usage": {"prompt_tokens": 0,
                                 "completion_tokens": 0},
                       "span": None, "error": None}
            elif req.done:
                rec = terminal_record(req)
            else:
                # still live at shutdown: the END event must carry a
                # TERMINAL state, never "decoding" — clients and drills
                # classify outcomes by it
                rec = terminal_record(req, state=CANCELLED,
                                      finish_reason="server_shutdown")
            sub.events.put({"event": "end", "replica": self.name, **rec})
        self._subs.clear()
        self.batcher.close()
        self._drop_engine_hook()

    @property
    def health(self) -> str:
        return self.batcher.health

    @property
    def alive(self) -> bool:
        """Worker thread running — False for a crashed or closed replica."""
        return self._thread is not None and self._thread.is_alive()

    @property
    def routable(self) -> bool:
        st = self.stats
        return (self.alive and st["health"] != DRAINING
                and not st["drained"])

    def load_score(self) -> float:
        """Lower = less loaded: queued + active requests, with projected
        worst-case KV occupancy as the fractional tiebreak."""
        st = self.stats
        return st["queue_depth"] + st["active"] + float(st["projected_kv"])

    # ------------------------------------------------------------------
    # thread-safe command surface
    # ------------------------------------------------------------------
    def _command(self, kind: str, payload, timeout: Optional[float] = None):
        if self._thread is None or not self._thread.is_alive():
            raise ShedError("replica_unavailable", retryable=True,
                            retry_after_s=1.0,
                            detail=f"{self.name} not running")
        fut: Future = Future()
        self.inbox.put((kind, payload, fut))
        try:
            return fut.result(timeout=timeout if timeout is not None
                              else self.submit_timeout_s)
        except (_FutureTimeout, TimeoutError):
            raise ShedError("replica_unavailable", retryable=True,
                            retry_after_s=1.0,
                            detail=f"{self.name} command {kind} timed out")

    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None, priority: int = 0,
               tier: Optional[str] = None,
               events: Optional["queue.Queue"] = None,
               trace_id: Optional[int] = None) -> int:
        """Submit through the worker; returns the batcher uid. Token/end
        events for the request are published to ``events`` (if given)
        starting before the first step that could touch it — no token is
        ever generated unobserved. ``trace_id`` rides through to the
        manager so the request keeps ONE causal track across the
        frontend/router/batcher hop (and across migrations). ``tier`` is
        the SLO class (None = the batcher's configured default)."""
        return self._command("submit", dict(
            prompt=prompt, max_new_tokens=max_new_tokens,
            deadline_s=deadline_s, priority=priority, tier=tier,
            events=events, trace_id=trace_id))

    def cancel(self, uid: int) -> bool:
        return self._command("cancel", uid)

    def request_drain(self, reason: str = "drain"
                      ) -> List[Tuple[ServeRequest, Optional["queue.Queue"]]]:
        """Enter DRAINING and capture the queued-but-unstarted requests
        (with their detached event queues) for the router to migrate.
        In-flight requests stay and finish under the drain."""
        return self._command("drain", reason)

    def adopt(self, donor: ServeRequest, payload: Optional[Dict] = None,
              manifest_path: Optional[str] = None, *,
              deadline_s: Optional[float] = None,
              migrated_from: Optional[str] = None,
              events: Optional["queue.Queue"] = None,
              sent: int = 0) -> int:
        """Adopt a migrated request through the worker (see
        :meth:`ContinuousBatcher.adopt_inflight`). The re-attached
        subscriber resumes at token index ``sent`` so nothing the donor
        already delivered is republished. Returns the local uid."""
        return self._command("adopt", dict(
            donor=donor, payload=payload, manifest_path=manifest_path,
            deadline_s=deadline_s, migrated_from=migrated_from,
            events=events, sent=sent))

    def request_rebalance(self, max_requests: int = 0) -> List[Tuple]:
        """Worker-side voluntary handoff of paused batch-tier work (see
        :meth:`ContinuousBatcher.export_paused_for_rebalance`). Returns
        ``(request, manifest_path, events, sent)`` tuples with the
        subscriptions detached, so the donor-side terminal stays silent
        and the router re-attaches the stream on the adopting sibling."""
        return self._command("rebalance", max_requests)

    def report(self) -> Dict:
        """``serving_report()`` taken inside the worker loop, so it never
        races a step (falls back to a direct call once the worker is
        gone)."""
        if self._thread is None or not self._thread.is_alive():
            return self.batcher.serving_report()
        return self._command("report", None)

    def resolve(self, uid: int) -> Optional[str]:
        return self._command("resolve", uid)

    def capture_dead(self) -> List[Tuple]:
        """Post-mortem capture after the worker thread died (crash path).
        Only legal on a DEAD replica — the batcher is single-threaded by
        contract, and this walks it from the caller's thread. Fails any
        commands stranded in the inbox, detaches queued AND in-flight
        requests (with their event queues) for the router to re-home,
        terminal-izes everything still on the dead batcher as
        ``replica_crash`` sheds (silent — the subscriptions are detached;
        the router either re-homes each request or resolves its stream
        itself), and tears the batcher down. A PAUSED request's durable
        manifest is re-exported with ownership transferred, so the local
        teardown leaves the shared-tier files for the adopting sibling —
        and a pause whose backup write failed gets a fresh export here.
        Every uid the dead replica ever admitted keeps resolving terminal
        through its (soon retired) ledger.

        Returns ``(request, events, pre_crash_state, manifest_path,
        tokens_already_sent)`` tuples."""
        if self.alive:
            raise RuntimeError(
                f"replica {self.name} worker still alive — capture_dead "
                f"is a post-mortem path (drain a live replica instead)")
        while True:                    # unblock callers stuck on commands
            try:
                cmd = self.inbox.get_nowait()
            except queue.Empty:
                break
            if cmd is not None:
                cmd[2].set_exception(ShedError(
                    "replica_unavailable", retryable=True,
                    retry_after_s=1.0, detail=f"{self.name} crashed"))
        m = self.batcher.manager
        mig = getattr(self.batcher, "_mig", None)
        captured = []
        for req in list(m.queue):
            sub = self._subs.pop(req.uid, None)
            captured.append((req, None if sub is None else sub.events,
                             QUEUED, None, 0))
        for req in list(m.active.values()):
            sub = self._subs.pop(req.uid, None)
            manifest = None
            if mig is not None and req.state == PAUSED:
                try:
                    manifest = self.batcher.engine.export_paused(
                        req.uid,
                        f"{self.batcher.migration_tag}-{req.uid}",
                        mig.shared_nvme_path, keep=False)
                except Exception as e:
                    logger.warning(f"serving: dead-replica export of "
                                   f"uid={req.uid} failed: {e!r}")
            captured.append((req, None if sub is None else sub.events,
                             req.state, manifest,
                             0 if sub is None else sub.sent))
        for req in list(m.queue):
            m.shed(req, "replica_crash")
        for req in list(m.active.values()):
            m.shed(req, "replica_crash")
        for uid, sub in list(self._subs.items()):
            req = m.result(uid)
            if req is not None and req.done:
                sub.events.put({"event": "end", "replica": self.name,
                                **terminal_record(req)})
        self._subs.clear()
        self._update_stats()
        self.batcher.close()
        self._drop_engine_hook()
        return captured

    def _drop_engine_hook(self) -> None:
        """A closed or dead replica's ledger outlives it (the router keeps
        it to answer ``resolve()`` for a retired incarnation): drop the
        ledger's hook into the engine, so the engine's weights and KV pool
        go with the replica instead of living as long as the ledger."""
        mgr = getattr(self.batcher, "manager", None)
        if mgr is not None:
            mgr.release_fn = None

    # ------------------------------------------------------------------
    # worker loop (the only batcher-touching thread)
    # ------------------------------------------------------------------
    def _run(self) -> None:
        try:
            get_injector().on_replica_start(self.name)
            self._update_stats()
            while not self._stop.is_set():
                # the crash site sits OUTSIDE the step try/except below:
                # that absorption boundary exists for step bugs, and an
                # injected replica_crash must actually kill the worker
                get_injector().on_replica_loop(self.name)
                m = self.batcher.manager
                idle = (self.paused or self.batcher.drained
                        or (not m.active and not m.queue))
                self._drain_commands(block=idle)
                if self._stop.is_set():
                    break
                if not self.paused and not self.batcher.drained:
                    try:
                        self.batcher.step()
                    except Exception as e:  # step bug must not kill serving
                        logger.warning(f"serving: replica {self.name} step "
                                       f"raised {e!r}")
                self._publish()
                self._update_stats()
        except Exception as e:         # worker death == replica crash
            self.crash_error = e
            logger.warning(f"serving: replica {self.name} worker died: "
                           f"{e!r}")
            flight_dump("replica_crash",
                        extra={"replica": self.name,
                               "incarnation": self.incarnation,
                               "error": repr(e)},
                        key=f"replica_crash:{self.name}:{self.incarnation}")

    def _drain_commands(self, block: bool) -> None:
        try:
            cmd = (self.inbox.get(timeout=self.idle_sleep_s) if block
                   else self.inbox.get_nowait())
        except queue.Empty:
            return
        while True:
            if cmd is not None:
                self._handle(cmd)
            try:
                cmd = self.inbox.get_nowait()
            except queue.Empty:
                return

    def _handle(self, cmd) -> None:
        kind, payload, fut = cmd
        try:
            if kind == "submit":
                events = payload.pop("events")
                uid = self.batcher.submit(payload.pop("prompt"), **payload)
                if events is not None:
                    self._subs[uid] = _Sub(events)
                self._update_stats()
                fut.set_result(uid)
            elif kind == "cancel":
                fut.set_result(self.batcher.manager.cancel(payload))
            elif kind == "drain":
                captured = []
                for req in list(self.batcher.manager.queue):
                    sub = self._subs.pop(req.uid, None)
                    captured.append(
                        (req, None if sub is None else sub.events))
                # begin_drain sheds the queue on THIS replica; with the
                # subscriptions detached above, those shed terminals stay
                # silent and the router re-homes the requests instead
                self.batcher.begin_drain(payload)
                self._update_stats()
                fut.set_result(captured)
            elif kind == "adopt":
                events = payload.pop("events")
                sent = payload.pop("sent")
                req = self.batcher.adopt_inflight(
                    payload.pop("donor"), payload.pop("payload"),
                    payload.pop("manifest_path"), **payload)
                if events is not None:
                    sub = _Sub(events)
                    # the donor already delivered these tokens; this
                    # publisher starts where the donor's stopped
                    sub.sent = min(int(sent), len(req.generated))
                    self._subs[req.uid] = sub
                self._update_stats()
                fut.set_result(req.uid)
            elif kind == "rebalance":
                out = []
                for req, path in \
                        self.batcher.export_paused_for_rebalance(payload):
                    sub = self._subs.pop(req.uid, None)
                    out.append((req, path,
                                None if sub is None else sub.events,
                                0 if sub is None else sub.sent))
                self._update_stats()
                fut.set_result(out)
            elif kind == "report":
                fut.set_result(self.batcher.serving_report())
            elif kind == "resolve":
                fut.set_result(self.batcher.manager.resolve(payload))
            else:
                fut.set_exception(ValueError(f"unknown command {kind}"))
        except BaseException as e:     # noqa: BLE001 — relayed to caller
            if not fut.done():
                fut.set_exception(e)

    def _publish(self) -> None:
        """Feed each subscriber the tokens its request gained this step;
        terminal requests get the full ``end`` record and drop off."""
        mgr = self.batcher.manager
        queued = None                  # built once, only if a sub needs it
        for uid, sub in list(self._subs.items()):
            req = mgr.active.get(uid) or mgr.done.get(uid)
            if req is None:
                if queued is None:
                    queued = {r.uid for r in mgr.queue}
                if uid in queued:
                    continue           # still waiting for admission
                del self._subs[uid]    # unknown (flushed externally)
                continue
            gen = req.generated
            while sub.sent < len(gen):
                sub.events.put({"event": "token",
                                "token": int(gen[sub.sent]),
                                "index": sub.sent, "replica": self.name})
                sub.sent += 1
            if req.done:
                sub.events.put({"event": "end", "replica": self.name,
                                **terminal_record(req)})
                del self._subs[uid]

    def _update_stats(self) -> None:
        b = self.batcher
        m = b.manager
        # NOTE: no queue_depth_by_priority here — this runs every worker
        # iteration and nothing routes on the breakdown (it is exported
        # via serving_report() and the /metrics gauges instead)
        self.stats = {
            "health": b.health,
            "queue_depth": m.queue_depth,
            "active": len(m.active),
            "kv_occupancy": b.kv_occupancy,
            "projected_kv": b._projected_blocks() / max(1, b.num_blocks),
            "drained": b.drained,
            # autoscaler signals: heartbeat (stale beat = hung worker),
            # the load-aware Retry-After watermark, and the cumulative
            # shed+reject count (the controller differences it per poll)
            "beat": time.monotonic(),
            "retry_after": m.current_retry_after(),
            "sheds": m.counters["shed"] + m.counters["rejected"],
            # per-SLO-tier backlog: the autoscaler's pressure signal
            # (batch-tier depth alone must not scale the fleet up)
            "queue_depth_by_tier": m.queue_depth_by_tier(),
            # paused batch-tier work: the fleet's rebalance-donor signal
            # (an idle sibling can adopt it through the shared tier)
            "paused_batch": sum(1 for r in m.active.values()
                                if r.state == PAUSED
                                and r.tier == TIER_BATCH),
        }


class _Route:
    __slots__ = ("replica", "inc", "uid", "events", "migrations")

    def __init__(self, replica: str, inc: int, uid: int, events):
        self.replica = replica
        self.inc = inc                 # incarnation that minted `uid`
        self.uid = uid
        self.events = events
        self.migrations = 0


class ReplicaRouter:
    """Least-loaded request routing over N :class:`Replica` workers."""

    def __init__(self, replicas: Sequence[Replica], config=None,
                 clock: Callable[[], float] = time.monotonic):
        from deepspeed_tpu_torch.config.config import RouterConfig

        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        self.cfg = config if config is not None else RouterConfig()
        self.replicas: Dict[str, Replica] = {r.name: r for r in replicas}
        self.clock = clock
        self._lock = threading.Lock()
        # router submits that reached a replica but have not recorded their
        # route yet, per replica name; a drain or crash capture that finds
        # no route waits for them (:meth:`_await_route`)
        self._landing: Dict[str, int] = {}              #: guarded_by: _lock
        self._landed = threading.Condition(self._lock)
        # insertion-ordered; TERMINAL routes older than max_route_history
        # are evicted so a long-running front-end does not grow
        # per-request state forever. A still-live head pauses eviction
        # (bounded overshoot: live routes are capped by queue+active) —
        # a live request must never lose its route, or cancel/resolve
        # would silently no-op on it
        self._routes: Dict[int, _Route] = {}           #: guarded_by: _lock
        self._route_order: Deque[int] = deque()        #: guarded_by: _lock
        #: guarded_by: _lock — (replica, incarnation, uid) → ruid
        self._by_loc: Dict[Tuple[str, int, int], int] = {}
        self._next_ruid = 0                            #: guarded_by: _lock
        # terminal ledgers of retired incarnations (crashed / swapped-out
        # replicas), bounded FIFO: pool-level resolve() keeps answering
        # for uids minted before a respawn replaced their home
        #: guarded_by: _lock
        self._retired: "OrderedDict[Tuple[str, int], object]" = OrderedDict()
        self._max_retired = 16
        self._prev_sigterm = None
        self.counters: Dict[str, int] = {              #: guarded_by: _lock
            "routed": 0, "failover": 0, "rejected": 0, "migrated": 0,
            "migration_failed": 0, "drains": 0, "crash_failovers": 0,
            "readmits": 0, "adopts": 0, "adopt_failures": 0,
            "reprefill_failovers": 0, "torn_manifests": 0, "rebalances": 0,
        }
        # migration instruments ride the first replica's ServingMetrics so
        # the router's counters land in the same registry the pool's
        # /metrics endpoint scrapes (None with a metrics-less batcher:
        # the router still counts, it just doesn't export)
        self.metrics = getattr(
            getattr(replicas[0], "batcher", None), "metrics", None) \
            if replicas else None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "ReplicaRouter":
        for rep in self._snapshot():
            rep.start()
        return self

    def close(self) -> None:
        self.restore_signal_handlers()
        for rep in self._snapshot():
            rep.close()

    def _snapshot(self) -> List[Replica]:
        """Consistent view of the pool: the replica dict mutates under
        ``_lock`` (readmit/add/remove), so iteration must not walk it
        live."""
        with self._lock:
            return list(self.replicas.values())

    @property
    def health(self) -> str:
        """Pool health for the shared ``/readyz``: ready while ANY replica
        can take traffic; draining only when the whole pool is going away."""
        states = [r.stats["health"] for r in self._snapshot()]
        if READY in states:
            return READY
        if DEGRADED in states:
            return DEGRADED
        if states and all(s == DRAINING for s in states):
            return DRAINING
        return "starting"

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def _ranked(self, exclude=()) -> List[Replica]:
        """Routable replicas, least-loaded first. STARTING ranks with
        READY (a replica that has not served yet IS the least loaded — it
        must get traffic to ever leave STARTING); DEGRADED ranks last (it
        runs on reduced capacity, so siblings absorb first); DRAINING is
        excluded entirely by ``routable``."""
        cands = [r for r in self._snapshot()
                 if r.name not in exclude and r.routable]
        return sorted(cands, key=lambda r: (
            1 if r.stats["health"] == DEGRADED else 0, r.load_score()))

    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None, priority: int = 0,
               tier: Optional[str] = None,
               events: Optional["queue.Queue"] = None,
               trace_id: Optional[int] = None,
               _exclude=(), _ruid: Optional[int] = None) -> int:
        """Route to the least-loaded replica; retry retryable sheds on
        siblings; surface the final :class:`ShedError` (with the LARGEST
        retry-after hint seen — the pool-wide pressure signal) only after
        every candidate refused. Returns a router-scoped uid."""
        attempts = 0
        cap = self.cfg.failover_attempts or len(self.replicas)
        last: Optional[ShedError] = None
        hint = 0.0
        for rep in self._ranked(exclude=_exclude):
            if attempts >= cap:
                break
            attempts += 1
            with self._lock:
                self._landing[rep.name] = self._landing.get(rep.name, 0) + 1
            try:
                uid = rep.submit(prompt, max_new_tokens=max_new_tokens,
                                 deadline_s=deadline_s, priority=priority,
                                 tier=tier, events=events,
                                 trace_id=trace_id)
                return self._record_route(rep, uid, events, _ruid)
            except ShedError as e:
                if not e.retryable:
                    raise            # oversize etc: no sibling can help
                last = e
                hint = max(hint, e.retry_after_s or 0.0)
                with self._lock:
                    self.counters["failover"] += 1
            finally:
                with self._landed:
                    self._landing[rep.name] -= 1
                    self._landed.notify_all()
        with self._lock:
            self.counters["rejected"] += 1
        if last is None:
            raise ShedError("no_replicas", retryable=True,
                            retry_after_s=max(hint, 1.0),
                            detail="no routable replica in the pool")
        raise ShedError(last.reason, retryable=True,
                        retry_after_s=max(hint, last.retry_after_s or 0.0),
                        detail=f"all {attempts} routable replicas refused")

    def _record_route(self, rep: Replica, uid: int, events,
                      _ruid: Optional[int]) -> int:
        """Insert (``_ruid=None``) or rewrite (migration keeps the
        client-facing uid) the route for a request that just landed on
        ``rep`` as ``uid``; returns the router-scoped uid."""
        with self._lock:
            if _ruid is None:
                ruid = self._next_ruid
                self._next_ruid += 1
                self._routes[ruid] = _Route(rep.name, rep.incarnation,
                                            uid, events)
                self._route_order.append(ruid)
                self.counters["routed"] += 1
                self._evict_terminal_routes()
            else:                # migration keeps the client-facing uid
                ruid = _ruid
                route = self._routes.get(ruid)
                if route is None:
                    # evicted between drain-capture and re-home (the
                    # draining replica sheds the capture into its done
                    # ledger, making the route eviction-eligible):
                    # re-insert under the SAME ruid so the client's
                    # uid keeps resolving through the migration
                    route = _Route(rep.name, rep.incarnation, uid,
                                   events)
                    self._routes[ruid] = route
                    self._route_order.append(ruid)
                else:
                    self._by_loc.pop(
                        (route.replica, route.inc, route.uid), None)
                    route.replica, route.uid = rep.name, uid
                    route.inc = rep.incarnation
                route.migrations += 1
            self._by_loc[(rep.name, rep.incarnation, uid)] = ruid
        return ruid

    def _route_loc(self, ruid: int) -> Optional[Tuple[str, int, int]]:
        """Snapshot (replica, incarnation, uid) under the lock: a
        migration rewrites ``route.replica``/``route.inc``/``route.uid``
        as a unit under ``_lock``, so an unlocked reader could see the OLD
        replica with the NEW uid (or race the eviction sweep) and aim its
        command at the wrong batcher."""
        with self._lock:
            route = self._routes.get(ruid)
            if route is None:
                return None
            return route.replica, route.inc, route.uid

    def cancel(self, ruid: int) -> bool:
        loc = self._route_loc(ruid)
        if loc is None:
            return False
        name, inc, uid = loc
        rep = self.replicas.get(name)
        if rep is None or rep.incarnation != inc:
            return False     # home incarnation retired: already terminal
        try:
            return rep.cancel(uid)
        except ShedError:
            return False

    def resolve(self, ruid: int) -> Optional[str]:
        """Terminal/current state for a router uid — follows the route
        through any migrations AND through replica respawns, so 'no
        admitted uid silently lost' is checkable at the pool level exactly
        like at one replica. A route whose home incarnation was replaced
        (crash respawn, rolling swap) answers from the retired ledger —
        never from the new batcher, whose uids restart at 0."""
        loc = self._route_loc(ruid)
        if loc is None:
            return None
        name, inc, uid = loc
        rep = self.replicas.get(name)
        if rep is not None and rep.incarnation == inc:
            try:
                return rep.resolve(uid)
            except ShedError:
                return rep.batcher.manager.resolve(uid)
        with self._lock:
            mgr = self._retired.get((name, inc))
        return None if mgr is None else mgr.resolve(uid)

    # ------------------------------------------------------------------
    # drain + migration
    # ------------------------------------------------------------------
    def drain_replica(self, name: str, reason: str = "drain") -> Dict:
        """Drain one replica, migrating its queued-but-unstarted requests
        onto the least-loaded siblings. Each migrated request keeps its
        router uid, priority, remaining deadline, and event stream; in-
        flight requests finish on the draining replica under its normal
        drain. Requests no sibling will take resolve as retryable sheds —
        refused loudly, never lost silently."""
        rep = self.replicas[name]
        with self._lock:
            self.counters["drains"] += 1
        captured = rep.request_drain(reason)
        migrated, failed = self._migrate(rep, captured)
        logger.warning(f"serving: router drained {name} ({reason}); "
                       f"migrated={migrated} failed={failed} "
                       f"in_flight_left={rep.stats['active']}")
        return {"replica": name, "captured": len(captured),
                "migrated": migrated, "failed": failed}

    def fail_over(self, name: str) -> Dict:
        """Crash path: post-mortem capture of a DEAD replica's queued-but-
        unstarted requests, re-homed onto siblings exactly like a drain
        migration (same uid/priority/deadline/event-stream preservation).
        In-flight requests died with their KV — their uids resolve as
        ``replica_crash`` sheds, refused loudly, never lost silently."""
        rep = self.replicas[name]
        captured = rep.capture_dead()
        migrated, failed = self._migrate(rep, captured)
        with self._lock:
            self.counters["crash_failovers"] += 1
        logger.warning(f"serving: router failed over dead {name}; "
                       f"migrated={migrated} failed={failed} "
                       f"error={rep.crash_error!r}")
        return {"replica": name, "captured": len(captured),
                "migrated": migrated, "failed": failed}

    def _migrate(self, rep: Replica, captured,
                 cause: str = "crash") -> Tuple[int, int]:
        """Re-home captured requests onto siblings of ``rep``. Each
        migrated request keeps its router uid, priority, remaining
        deadline, and event stream. Queued requests resubmit as plain
        routes; in-flight ones walk the recovery ladder
        (:meth:`_adopt_on_sibling`): durable-manifest adoption (resume on
        the sibling, greedy tokens bit-identical), else re-prefill from
        token history — recompute, never zero-fill — and only then a
        retryable shed on the event stream. Returns (migrated, failed)."""
        name = rep.name
        migrated = failed = 0
        for item in captured:
            if len(item) == 2:         # drain capture: queued-only pairs
                req, events = item
                pre_state, manifest, sent = QUEUED, None, 0
            else:
                req, events, pre_state, manifest, sent = item
            ruid = self._ruid_for(name, rep.incarnation, req.uid)
            if ruid is None:
                ruid = self._await_route(name, rep.incarnation, req.uid)
            remaining = (None if req.deadline is None
                         else req.deadline - self.clock())
            if remaining is not None and remaining <= 0:
                remaining = 0.001      # let the sibling's sweep expire it
            try:
                if not self.cfg.migrate_on_drain:
                    raise ShedError("draining", retryable=True,
                                    retry_after_s=1.0,
                                    detail="migration disabled")
                if pre_state != QUEUED:
                    new_ruid = self._adopt_on_sibling(
                        rep, req, events, manifest, ruid, remaining,
                        cause, sent)
                else:
                    # a traced request keeps its id across the migration;
                    # an untraced one (sampled out, or submitted while
                    # tracing was off) must not get minted a fresh
                    # mid-life track
                    mig_trace = (req.trace_id if req.trace_id is not None
                                 else (SAMPLED_OUT if get_bus().enabled
                                       else None))
                    new_ruid = self.submit(
                        req.prompt, max_new_tokens=req.max_new_tokens,
                        deadline_s=remaining, priority=req.priority,
                        tier=req.tier, events=events, trace_id=mig_trace,
                        _exclude=(name,),
                        _ruid=None if ruid is None else ruid)
                migrated += 1
                bus = get_bus()
                if req.trace_id is not None and bus.enabled:
                    bus.async_instant("request", "request", req.trace_id,
                                      args={"subsys": "router",
                                            "what": "migrated",
                                            "from": name, "cause": cause})
                if events is not None:
                    # announced only once the sibling really took it (a
                    # refused migration must read as a shed, not a move);
                    # a first sibling token may legally precede this event
                    with self._lock:
                        r = self._routes.get(new_ruid)
                        dest = r.replica if r is not None else "?"
                    events.put({"event": "migrated", "from": name,
                                "to": dest})
            except ShedError as e:
                failed += 1
                if events is not None:
                    events.put({"event": "end", "replica": name,
                                "state": "shed",
                                "finish_reason": e.reason, "tokens": [],
                                "usage": {"prompt_tokens": req.prompt_len,
                                          "completion_tokens": 0},
                                "span": req.span(),
                                "error": {"reason": e.reason,
                                          "retryable": e.retryable,
                                          "retry_after_s":
                                              e.retry_after_s}})
        with self._lock:
            self.counters["migrated"] += migrated
            self.counters["migration_failed"] += failed
        return migrated, failed

    def _adopt_on_sibling(self, donor: Replica, req: ServeRequest, events,
                          manifest: Optional[str], ruid: Optional[int],
                          remaining: Optional[float], cause: str,
                          sent: int) -> int:
        """The in-flight recovery ladder for one captured request. Rung 1:
        claim the durable manifest (atomic rename — two routers racing the
        same manifest get exactly one winner) and adopt it PAUSED on a
        sibling, whose normal resume pass promotes KV it never produced.
        Rung 2: re-prefill from token history (recompute, never
        zero-fill). Raises :class:`ShedError` when every rung fails; the
        caller resolves the stream as a retryable shed."""
        t0 = self.clock()
        payload = claimed = None
        if manifest is not None:
            claimed = claim_manifest(manifest)
            if claimed is not None:
                try:
                    payload = load_manifest(claimed)
                except (ManifestError, OSError) as e:
                    # torn or unreadable: counted + flight-recorded, then
                    # down the ladder — the orphaned durable files age out
                    # with the TTL sweep
                    with self._lock:
                        self.counters["torn_manifests"] += 1
                    logger.warning(f"serving: manifest for donor uid="
                                   f"{req.uid} unusable: {e}")
                    flight_dump("torn_manifest",
                                extra={"donor": donor.name,
                                       "uid": req.uid, "path": claimed},
                                key=f"torn:{claimed}")
        cap = self.cfg.failover_attempts or len(self.replicas)
        last: Optional[ShedError] = None
        if payload is not None:
            attempts = 0
            for rep in self._ranked(exclude=(donor.name,)):
                if attempts >= cap:
                    break
                attempts += 1
                try:
                    uid = rep.adopt(req, payload, claimed,
                                    deadline_s=remaining,
                                    migrated_from=donor.name,
                                    events=events, sent=sent)
                except ShedError as e:
                    last = e
                    continue
                except Exception as e:
                    # durable entries unusable (missing/short files): the
                    # sibling unwound cleanly; fall to re-prefill
                    with self._lock:
                        self.counters["adopt_failures"] += 1
                    logger.warning(f"serving: adopt on {rep.name} failed: "
                                   f"{e!r}; falling back to re-prefill")
                    payload = None
                    break
                new_ruid = self._record_route(rep, uid, events, ruid)
                with self._lock:
                    self.counters["adopts"] += 1
                if self.metrics is not None:
                    self.metrics.migration(cause).inc()
                    self.metrics.migration_ms.observe(
                        (self.clock() - t0) * 1e3)
                return new_ruid
        if claimed is not None:
            # the claim is spent: a consumed-or-unusable manifest must not
            # outlive this decision (the adopting engine owns it on the
            # success path above)
            try:
                os.remove(claimed)
            except OSError:
                pass
        attempts = 0
        for rep in self._ranked(exclude=(donor.name,)):
            if attempts >= cap:
                break
            attempts += 1
            try:
                uid = rep.adopt(req, None, None, deadline_s=remaining,
                                migrated_from=donor.name, events=events,
                                sent=sent)
            except ShedError as e:
                last = e
                continue
            new_ruid = self._record_route(rep, uid, events, ruid)
            with self._lock:
                self.counters["reprefill_failovers"] += 1
            if self.metrics is not None:
                self.metrics.migration(cause).inc()
                self.metrics.reprefill_fallbacks.inc()
                self.metrics.migration_ms.observe(
                    (self.clock() - t0) * 1e3)
            return new_ruid
        raise (last if last is not None else
               ShedError("no_replicas", retryable=True, retry_after_s=1.0,
                         detail="no sibling adopted the migrated request"))

    def rebalance_paused(self, donor: str, max_requests: int = 0) -> Dict:
        """Voluntary rebalance: ``donor`` exports its paused batch-tier
        work (ownership transferred to the shared tier, donor HBM/slots
        already freed by the pause) and siblings adopt it through the
        same ladder the crash path uses — client streams and router uids
        intact, SSE ``migrated`` events emitted."""
        rep = self.replicas[donor]
        exported = rep.request_rebalance(max_requests)
        if not exported:
            return {"replica": donor, "exported": 0, "migrated": 0,
                    "failed": 0}
        items = [(req, events, PAUSED, manifest, sent)
                 for req, manifest, events, sent in exported]
        migrated, failed = self._migrate(rep, items, cause="rebalance")
        with self._lock:
            self.counters["rebalances"] += migrated
        logger.warning(f"serving: rebalanced {migrated}/{len(exported)} "
                       f"paused requests off {donor} "
                       f"(failed={failed})")
        return {"replica": donor, "exported": len(exported),
                "migrated": migrated, "failed": failed}

    def _ruid_for(self, replica: str, inc: int, uid: int) -> Optional[int]:
        with self._lock:
            return self._by_loc.get((replica, inc, uid))

    def _await_route(self, replica: str, inc: int,
                     uid: int) -> Optional[int]:
        """The route of a captured request that a router submit landed on
        ``replica`` just before the capture: the submitting thread records
        it once the replica answers, so wait until no router submit to
        ``replica`` is in flight and look again (None: the request came
        from elsewhere). Without the wait the capture would be re-homed
        under a fresh uid while the client's uid recorded the request the
        drain shed."""
        with self._landed:
            self._landed.wait_for(lambda: not self._landing.get(replica),
                                  timeout=self.cfg.submit_timeout_s)
            return self._by_loc.get((replica, inc, uid))

    # ------------------------------------------------------------------
    # elastic membership (the fleet controller's surface)
    # ------------------------------------------------------------------
    def readmit(self, name: str, replacement: Replica,
                require_ready: bool = True) -> None:
        """Swap a respawned ``replacement`` in for the retired incarnation
        under ``name`` — the fix for the old permanent-exclusion bug (a
        drained or dead replica could never rejoin the routing set).
        READY-gated by default: the controller warms the replacement with
        a probe first, so the pool never routes to a replica still
        compiling. The old incarnation's terminal ledger is retired, not
        dropped — pool-level ``resolve()`` keeps answering for its uids."""
        if replacement.name != name:
            raise ValueError(f"replacement is named {replacement.name!r}, "
                             f"expected {name!r}")
        if not replacement.alive:
            raise RuntimeError(f"replica {name} replacement worker is not "
                               f"running — start() it before readmit")
        if require_ready and replacement.health != READY:
            raise RuntimeError(
                f"replica {name} replacement is {replacement.health!r}, "
                f"not {READY!r} — probe it to READY before readmit")
        with self._lock:
            old = self.replicas.get(name)
            if old is not None and old is not replacement:
                self._retire_locked(old)
            self.replicas[name] = replacement
            self.counters["readmits"] += 1
        logger.warning(f"serving: router readmitted {name} "
                       f"(incarnation {replacement.incarnation})")

    def add_replica(self, replica: Replica) -> None:
        """Scale-up admission of a brand-new name (see :meth:`readmit`
        for respawns under an existing name)."""
        with self._lock:
            if replica.name in self.replicas:
                raise ValueError(f"replica {replica.name} already in the "
                                 f"pool — use readmit() for a respawn")
            self.replicas[replica.name] = replica

    def remove_replica(self, name: str) -> Replica:
        """Scale-down removal: only a non-routable (drained or dead)
        replica may leave, and never the last one. Its terminal ledger is
        retired so in-ledger uids keep resolving."""
        with self._lock:
            rep = self.replicas.get(name)
            if rep is None:
                raise KeyError(name)
            if rep.routable:
                raise RuntimeError(f"replica {name} is still routable — "
                                   f"drain it before removal")
            if len(self.replicas) == 1:
                raise RuntimeError("cannot remove the last replica")
            self._retire_locked(rep)
            del self.replicas[name]
        return rep

    def _retire_locked(self, rep: Replica) -> None:  #: holds: _lock
        self._retired[(rep.name, rep.incarnation)] = rep.batcher.manager
        while len(self._retired) > self._max_retired:
            self._retired.popitem(last=False)

    def _evict_terminal_routes(self) -> None:  #: holds: _lock
        """Called under ``self._lock``. Drops oldest routes past the
        history cap, but ONLY terminal ones — liveness is probed with
        GIL-atomic dict/set reads on the replica's manager (``active`` /
        ``_queued_uids``), so no cross-thread handshake is needed. A uid
        in neither is terminal: in the ``done`` ledger, or already evicted
        from it by the bounded-ledger sweep (a route must not wedge the
        eviction queue waiting for a ledger entry that is never coming
        back). A live head stops the sweep (O(1) amortized; overshoot
        bounded by the number of live requests)."""
        while (len(self._routes) > self.cfg.max_route_history
               and self._route_order):
            head = self._route_order[0]
            route = self._routes.get(head)
            if route is None:          # already gone (defensive)
                self._route_order.popleft()
                continue
            rep = self.replicas.get(route.replica)
            if rep is not None and rep.incarnation == route.inc:
                # a route whose home incarnation retired is terminal by
                # construction (capture_dead/drain terminal-ized it) —
                # only the still-current incarnation is probed for life
                m = rep.batcher.manager
                # probe in REVERSE transition order (queued, then active):
                # admit() inserts into active BEFORE discarding from the
                # queued set, so not-queued-now implies already-in-active
                # (or terminal) — probing active first would let an admit
                # between the two reads make a live request look terminal
                if route.uid in m._queued_uids or route.uid in m.active:
                    break              # oldest route still live: wait
            self._route_order.popleft()
            del self._routes[head]
            self._by_loc.pop((route.replica, route.inc, route.uid), None)

    # ------------------------------------------------------------------
    # signals + reporting
    # ------------------------------------------------------------------
    def install_signal_handlers(self, drain: Optional[str] = None) -> None:
        """SIGTERM → drain ``drain`` (one replica) or the whole pool, with
        queue migration, from a helper thread (a signal handler must not
        block on worker handshakes). The pool membership is read at
        SIGNAL time — an elastic pool may have scaled since install."""

        def _on_sigterm(signum, frame):
            names = ([drain] if drain is not None
                     else [r.name for r in self._snapshot()])
            logger.warning(f"serving: router SIGTERM — draining {names}")
            threading.Thread(target=self._drain_many, args=(names,),
                             daemon=True).start()
        self._prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)

    def restore_signal_handlers(self) -> None:
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    def _drain_many(self, names) -> None:
        for n in names:
            try:
                self.drain_replica(n, "SIGTERM")
            except Exception as e:
                logger.warning(f"serving: SIGTERM drain of {n} failed: "
                               f"{e!r}")

    def report(self) -> Dict:
        """Pool-level mirror of ``serving_report()``: per-replica reports
        plus the routing counters."""
        with self._lock:
            counters = dict(self.counters)
            routes = len(self._routes)
        return {
            "health": self.health,
            "counters": counters,
            "routes": routes,
            "replicas": {rep.name: rep.report()
                         for rep in self._snapshot()},
        }
