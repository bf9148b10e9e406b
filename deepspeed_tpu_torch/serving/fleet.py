"""Elastic fleet control for the serving pool: crash recovery,
autoscaling, and rolling weight swaps with zero dropped requests
(counterpart of ``deepspeed_tpu/serving/fleet.py``).

The :class:`FleetController` is the supervisor one level above the
:class:`~deepspeed_tpu_torch.serving.router.ReplicaRouter`. The router owns
routing and request bookkeeping; the controller owns replica LIFECYCLE:

* **crash recovery** — each ``poll()`` checks every replica for a dead
  worker thread or a stale heartbeat (``stats["beat"]`` older than
  ``heartbeat_timeout_s``). A hung worker is interrupted first and only
  captured once actually dead (a wedged thread cannot be preempted). The
  dead replica's queued-but-unstarted requests fail over to siblings via
  the router's drain-migration machinery, a replacement spawns under the
  same name (exponential backoff, up to ``max_respawns`` attempts), is
  READY-probed with a tiny generation, and rejoins via
  ``router.readmit()`` — the incarnation token keeps the old ledger
  resolvable the whole time.

* **autoscaling** — scale decisions ride the signals the serving stack
  already exports: pool queue depth per routable replica (latency +
  throughput SLO tiers only — a batch-tier backlog is deferred-by-design
  work and neither triggers scale-up nor holds off scale-down), the
  shed-rate delta between polls, and the pool-max
  ``current_retry_after()`` watermark. Hysteresis on both edges (``scale_up_polls`` consecutive
  pressured polls to grow, ``scale_down_idle_polls`` consecutive idle
  polls to shrink) keeps a bursty queue from flapping the pool. Scale-up
  is a fast cold start (warm when a
  :class:`~deepspeed_tpu_torch.serving.coldstart.WarmStartCache`-backed
  factory is used); scale-down drains, waits for ``drained``, then removes —
  queued requests migrate, in-flight ones finish.

* **paused-work rebalance** — when cross-replica migration is configured
  (``serving.migration``), each poll also moves paused batch-tier work
  from a pressured replica onto a READY idle sibling through the shared
  KV tier (``router.rebalance_paused``) — preempted work resumes on idle
  capacity instead of waiting behind the donor's latency traffic.

* **rolling weight swaps** — ``rolling_swap()`` walks the pool one
  replica at a time: drain-migrate, build a replacement (new weights via
  the factory), READY-probe, readmit, close the old incarnation. The
  pool never drops below ``min_ready_floor`` READY replicas; if the
  floor cannot be honored the swap aborts loudly rather than brown out.

The controller is single-threaded by design — call ``poll()`` from one
control loop (or ``start()`` a background supervisor thread that does).
Replica factories are callables ``factory(name) -> Replica`` returning an
UNSTARTED replica; attach ``replica.start_info = {"source": "warm"|
"cold", "ms": ...}`` (``WarmStartCache.build_engine`` returns exactly
this) and the controller records cold/warm start latencies.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.observability.registry import (exponential_bounds,
                                                        get_registry)
from deepspeed_tpu_torch.observability.trace import flight_dump
from deepspeed_tpu_torch.serving.batcher import READY
from deepspeed_tpu_torch.serving.router import Replica, ReplicaRouter
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["FleetController"]

# tiny fixed probe prompt: enough to force one real prefill+decode on the
# fresh engine (first step flips STARTING -> READY)
_PROBE_PROMPT = [1, 2, 3, 4]


class FleetController:
    """Replica lifecycle supervisor — see the module docstring.

    Parameters
    ----------
    router:
        The live :class:`ReplicaRouter` to supervise.
    replica_factory:
        ``factory(name) -> Replica`` returning an UNSTARTED replica.
        Called for respawns and scale-ups.
    config:
        A :class:`~deepspeed_tpu_torch.config.config.FleetConfig`; defaults
        to the config defaults.
    """

    def __init__(self, router: ReplicaRouter,
                 replica_factory: Callable[[str], Replica],
                 config=None, registry=None):
        from deepspeed_tpu_torch.config.config import FleetConfig

        self.router = router
        self.replica_factory = replica_factory
        self.cfg = config or FleetConfig()
        self.counters: Dict[str, int] = {
            "polls": 0, "deaths": 0, "hung_interrupts": 0, "respawns": 0,
            "respawn_failures": 0, "scale_ups": 0, "scale_downs": 0,
            "rolling_swaps": 0, "probe_failures": 0, "rebalances": 0,
        }
        # hysteresis state
        self._up_streak = 0
        self._idle_streak = 0
        self._shed_seen: Dict = {}      # (name, incarnation) -> last counter
        self._next_idx = len(router.replicas)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        r = registry or get_registry()
        ms_bounds = exponential_bounds(start=1.0, count=20)  # 1ms..~524s
        self.m = {
            "deaths": r.counter("serving/replica_deaths",
                                "replica workers detected dead"),
            "respawns": r.counter("serving/replica_respawns",
                                  "replicas respawned and readmitted"),
            "ready": r.gauge("serving/replica_ready",
                             "replicas READY and routable"),
            "pool": r.gauge("elastic/replicas",
                            "replicas in the routing pool"),
            "scale_ups": r.counter("elastic/scale_ups",
                                   "autoscaler pool expansions"),
            "scale_downs": r.counter("elastic/scale_downs",
                                     "autoscaler pool contractions"),
            "rolling_swaps": r.counter(
                "elastic/rolling_swaps",
                "replicas swapped in rolling weight updates"),
            "drain_rejoin_ms": r.histogram(
                "elastic/drain_rejoin_ms",
                "rolling-swap drain -> READY rejoin wall time (ms)",
                bounds=ms_bounds),
            "cold_start_ms": r.histogram(
                "elastic/cold_start_ms",
                "replica engine cold-build wall time (ms)",
                bounds=ms_bounds),
            "warm_start_ms": r.histogram(
                "elastic/warm_start_ms",
                "replica engine warm-build wall time (ms)",
                bounds=ms_bounds),
        }

    # ------------------------------------------------------------------
    # the supervision loop
    # ------------------------------------------------------------------
    def poll(self) -> Dict:
        """One supervision pass: detect/recover dead replicas, then apply
        one autoscale decision. Returns what happened (for drills and the
        background loop's logs)."""
        self.counters["polls"] += 1
        actions: Dict = {"recovered": [], "interrupted": [],
                         "scaled_up": None, "scaled_down": None}
        now = time.monotonic()
        for rep in self.router._snapshot():
            if not rep.alive:
                actions["recovered"].append(self._recover(rep.name))
            elif now - rep.stats["beat"] > self.cfg.heartbeat_timeout_s:
                # hung worker: interrupt; recover only once actually dead
                self.counters["hung_interrupts"] += 1
                logger.warning(f"serving: fleet interrupting hung replica "
                               f"{rep.name} (stale heartbeat)")
                if rep.interrupt(timeout_s=1.0):
                    actions["recovered"].append(self._recover(rep.name))
                else:
                    actions["interrupted"].append(rep.name)
        self._autoscale(actions)
        actions["rebalanced"] = self._rebalance_paused()
        return actions

    def _rebalance_paused(self) -> Optional[Dict]:
        """One rebalance decision per poll: when a replica is sitting on
        paused batch-tier work (preempted under pressure, parked in the
        shared tier) and a DIFFERENT replica is READY and idle, hand the
        work over through the router's migration ladder. A donor with
        paused work always has ``active > 0``, so it can never be its own
        idle target; no-op when migration is not configured (the donor
        exports nothing)."""
        reps = [r for r in self.router._snapshot() if r.routable]
        donors = [r for r in reps if r.stats.get("paused_batch", 0) > 0]
        idle = [r for r in reps if r.stats["health"] == READY
                and r.stats["queue_depth"] == 0 and r.stats["active"] == 0]
        if not donors or not idle:
            return None
        donor = max(donors,
                    key=lambda r: r.stats.get("paused_batch", 0))
        res = self.router.rebalance_paused(donor.name,
                                           max_requests=len(idle))
        if res.get("migrated"):
            self.counters["rebalances"] += res["migrated"]
        return res

    def _autoscale(self, actions: Dict) -> None:
        cfg = self.cfg
        reps = self.router._snapshot()
        routable = [r for r in reps if r.routable]
        ready = [r for r in routable if r.stats["health"] == READY]
        self.m["ready"].set(len(ready))
        self.m["pool"].set(len(reps))
        queue_depth = sum(r.stats["queue_depth"] for r in routable)
        # scale pressure counts only the latency-sensitive tiers: a deep
        # batch-tier backlog is deferred-by-design work and must neither
        # trigger scale-up nor hold off scale-down. Replicas that predate
        # the tier breakdown (no queue_depth_by_tier in stats) fall back
        # to their total depth — unknown load is treated as urgent
        urgent_depth = 0
        for r in routable:
            by_tier = r.stats.get("queue_depth_by_tier")
            if by_tier is None:
                urgent_depth += r.stats["queue_depth"]
            else:
                urgent_depth += sum(d for t, d in by_tier.items()
                                    if t != "batch")
        active = sum(r.stats["active"] for r in routable)
        retry_hint = max((r.stats["retry_after"] for r in routable),
                        default=0.0)
        shed_delta = 0
        seen: Dict = {}
        for r in reps:
            k = (r.name, r.incarnation)
            cur = int(r.stats["sheds"])
            shed_delta += max(0, cur - self._shed_seen.get(k, cur))
            seen[k] = cur
        self._shed_seen = seen
        pressured = bool(routable) and (
            urgent_depth > cfg.scale_up_queue_per_replica * len(routable)
            or shed_delta > 0
            or retry_hint >= cfg.scale_up_retry_after_s)
        idle = bool(routable) and urgent_depth == 0 and active == 0
        self._up_streak = self._up_streak + 1 if pressured else 0
        self._idle_streak = self._idle_streak + 1 if idle else 0
        if (self._up_streak >= cfg.scale_up_polls
                and len(reps) < cfg.max_replicas):
            self._up_streak = 0
            actions["scaled_up"] = self.scale_up()
        elif (self._idle_streak >= cfg.scale_down_idle_polls
                and len(routable) > cfg.min_replicas):
            self._idle_streak = 0
            actions["scaled_down"] = self.scale_down()

    # ------------------------------------------------------------------
    # crash recovery
    # ------------------------------------------------------------------
    def _recover(self, name: str) -> Dict:
        """Fail over a dead replica's requests, respawn under the same
        name with exponential backoff, READY-probe, readmit."""
        self.counters["deaths"] += 1
        self.m["deaths"].inc()
        res = self.router.fail_over(name)
        t0 = time.perf_counter()
        attempt = 0
        while attempt < self.cfg.max_respawns:
            if attempt:
                time.sleep(min(self.cfg.respawn_backoff_s * 2 ** (attempt - 1),
                               10.0))
            attempt += 1
            try:
                replacement = self._spawn(name)
                self.router.readmit(name, replacement)
                self.counters["respawns"] += 1
                self.m["respawns"].inc()
                res.update(respawned=True, attempts=attempt,
                           respawn_ms=round(
                               (time.perf_counter() - t0) * 1e3, 1))
                logger.warning(f"serving: fleet respawned {name} "
                               f"(attempt {attempt}, "
                               f"{res['respawn_ms']:.0f} ms)")
                return res
            except Exception as e:
                logger.warning(f"serving: respawn attempt {attempt} for "
                               f"{name} failed: {e!r}")
        self.counters["respawn_failures"] += 1
        flight_dump("replica_respawn_failed",
                    extra={"replica": name, "attempts": attempt},
                    key=f"respawn_failed:{name}")
        res.update(respawned=False, attempts=attempt)
        return res

    def _spawn(self, name: str,
               factory: Optional[Callable[[str], Replica]] = None
               ) -> Replica:
        """Build + start + READY-probe a replica; raises if the probe does
        not complete (the failed replica is closed, never admitted)."""
        rep = (factory or self.replica_factory)(name)
        rep.start()
        try:
            self._probe_ready(rep)
        except Exception:
            self.counters["probe_failures"] += 1
            rep.close()
            raise
        info = getattr(rep, "start_info", None)
        if isinstance(info, dict) and "ms" in info:
            which = ("warm_start_ms" if info.get("source") == "warm"
                     else "cold_start_ms")
            self.m[which].observe(float(info["ms"]))
        return rep

    def _probe_ready(self, rep: Replica) -> None:
        """Admission gate: a tiny real generation must complete and health
        must reach READY before the pool routes to this replica."""
        cfg = self.cfg
        uid = rep.submit(_PROBE_PROMPT,
                         max_new_tokens=cfg.probe_max_new_tokens)
        deadline = time.monotonic() + cfg.probe_timeout_s
        while time.monotonic() < deadline:
            state = rep.resolve(uid)
            if state == "completed" and rep.stats["health"] == READY:
                return
            if state in ("shed", "expired", "cancelled"):
                raise RuntimeError(
                    f"replica {rep.name} probe resolved {state}")
            time.sleep(0.02)
        raise TimeoutError(f"replica {rep.name} probe did not complete in "
                           f"{cfg.probe_timeout_s}s "
                           f"(health={rep.stats['health']})")

    # ------------------------------------------------------------------
    # scaling
    # ------------------------------------------------------------------
    def _fresh_name(self) -> str:
        while True:
            name = f"r{self._next_idx}"
            self._next_idx += 1
            if name not in self.router.replicas:
                return name

    def scale_up(self, name: Optional[str] = None) -> Optional[str]:
        """Grow the pool by one READY-probed replica; None on failure
        (spawn errors must not take down the supervisor)."""
        name = name or self._fresh_name()
        try:
            rep = self._spawn(name)
            self.router.add_replica(rep)
        except Exception as e:
            logger.warning(f"serving: scale-up of {name} failed: {e!r}")
            return None
        self.counters["scale_ups"] += 1
        self.m["scale_ups"].inc()
        logger.warning(f"serving: fleet scaled up -> {name} "
                       f"(pool={len(self.router.replicas)})")
        return name

    def scale_down(self, name: Optional[str] = None,
                   timeout_s: float = 30.0) -> Optional[str]:
        """Shrink the pool by one replica: drain (queued requests migrate
        to siblings), wait for ``drained`` (in-flight requests finish),
        close, remove. Picks the least-loaded replica by default."""
        routable = [r for r in self.router._snapshot() if r.routable]
        if len(routable) <= max(1, self.cfg.min_replicas):
            return None
        if name is None:
            name = min(routable, key=lambda r: r.load_score()).name
        self.router.drain_replica(name, reason="scale_down")
        rep = self.router.replicas[name]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and not rep.stats["drained"]:
            time.sleep(0.02)
        rep = self.router.remove_replica(name)
        rep.close()
        self.counters["scale_downs"] += 1
        self.m["scale_downs"].inc()
        logger.warning(f"serving: fleet scaled down {name} "
                       f"(pool={len(self.router.replicas)})")
        return name

    # ------------------------------------------------------------------
    # rolling weight swap
    # ------------------------------------------------------------------
    def rolling_swap(self,
                     factory: Optional[Callable[[str], Replica]] = None,
                     drain_timeout_s: float = 60.0) -> Dict:
        """Reload weights across the whole pool with zero dropped
        requests: one replica at a time — drain-migrate its queue, build
        a replacement via ``factory`` (default: the controller's own),
        READY-probe it, readmit, close the old incarnation. Never drops
        the pool below ``min_ready_floor`` OTHER ready replicas; aborts
        (``ok=False``) if the floor cannot be honored."""
        results: List[Dict] = []
        ok = True
        for name in [r.name for r in self.router._snapshot()]:
            others_ready = [
                r for r in self.router._snapshot()
                if r.name != name and r.routable
                and r.stats["health"] == READY]
            if len(others_ready) < self.cfg.min_ready_floor:
                ok = False
                results.append({"replica": name, "swapped": False,
                                "reason": "min_ready_floor"})
                logger.warning(f"serving: rolling swap aborted at {name} — "
                               f"only {len(others_ready)} other READY "
                               f"replicas (floor="
                               f"{self.cfg.min_ready_floor})")
                break
            t0 = time.perf_counter()
            self.router.drain_replica(name, reason="rolling_swap")
            old = self.router.replicas[name]
            deadline = time.monotonic() + drain_timeout_s
            while (time.monotonic() < deadline
                   and not old.stats["drained"]):
                time.sleep(0.02)
            try:
                replacement = self._spawn(name, factory)
                self.router.readmit(name, replacement)
            except Exception as e:
                ok = False
                results.append({"replica": name, "swapped": False,
                                "reason": repr(e)})
                logger.warning(f"serving: rolling swap of {name} failed: "
                               f"{e!r} — old incarnation left drained")
                break
            old.close()
            ms = round((time.perf_counter() - t0) * 1e3, 1)
            self.counters["rolling_swaps"] += 1
            self.m["rolling_swaps"].inc()
            self.m["drain_rejoin_ms"].observe(ms)
            results.append({"replica": name, "swapped": True,
                            "drain_rejoin_ms": ms})
            logger.warning(f"serving: rolling swap {name} done in "
                           f"{ms:.0f} ms")
        return {"ok": ok, "replicas": results}

    # ------------------------------------------------------------------
    # background supervisor
    # ------------------------------------------------------------------
    def start(self, interval_s: float = 1.0) -> "FleetController":
        """Run ``poll()`` on a daemon thread every ``interval_s``."""
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, args=(interval_s,),
                name="dstpu-fleet", daemon=True)
            self._thread.start()
        return self

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.poll()
            except Exception as e:
                # the supervisor must outlive any single bad poll
                logger.warning(f"serving: fleet poll failed: {e!r}")

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def report(self) -> Dict:
        reps = self.router._snapshot()
        return {
            "counters": dict(self.counters),
            "pool": len(reps),
            "ready": sum(1 for r in reps
                         if r.routable and r.stats["health"] == READY),
            "replicas": {r.name: {"incarnation": r.incarnation,
                                  "alive": r.alive,
                                  "health": r.stats["health"]}
                         for r in reps},
        }
