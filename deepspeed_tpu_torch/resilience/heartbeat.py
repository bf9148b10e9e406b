"""Per-process heartbeat + hang watchdog (counterpart of
``deepspeed_tpu/resilience/heartbeat.py``).

A wedged host is the failure mode the rest of the resilience layer cannot
see: no exception, no exit code — the process sits in a collective (a peer
died mid-all-reduce) or stops making step progress (a stuck data loader, a
livelocked host thread). Two small daemon threads close the gap:

* :class:`Heartbeat` — writes ``heartbeat_{rank}.json`` (step, step age,
  in-flight collective, pid) into a shared directory every ``interval_s``.
  Peers — and the operator — can read liveness off the filesystem even when
  the process itself is unresponsive.
* :class:`HangWatchdog` — polls this process's own progress: no step
  boundary for ``deadline_s`` is a hang (the reference also times a host
  collective in flight against ``collective_deadline_s``). It classifies
  the likely straggler (the slowest timed op from the comms logger, peers
  whose heartbeat files have gone stale) and escalates per policy:

  - ``abort`` (default) — signal the :class:`ResilienceCoordinator`, so the
    NEXT boundary becomes a fleet-agreed ABORT and the elastic agent
    respawns. Right for soft stalls where stepping still limps along.
    The vote is deliberately NOT withdrawn if the condition later clears —
    rescinding on recovery would make this escalation a no-op (any vote a
    boundary can consume implies stepping resumed), so set the deadlines
    well above benign pauses (long evals, periodic host work) and use
    ``report`` where observe-only is wanted.
  - ``exit`` — ``os._exit(exit_code)`` after writing a last heartbeat.
    The only way out of a hard wedge (a collective that will never return);
    the cohort dies, the agent respawns it.
  - ``report`` — record and log only (drills, dashboards).

Deadlines are configured via ``resilience.heartbeat``; all counters surface
through ``engine.resilience_report()`` and the ``resilience/*`` registry
gauges. The port runs no host collective on one device (``comm/comm.py``
comes with meshes): ``collective_deadline_s`` only shortens the default
poll, and the liveness file's ``inflight`` is always null.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["Heartbeat", "HangWatchdog"]

HEARTBEAT_FILE_FMT = "heartbeat_{rank}.json"


class Heartbeat:
    """Liveness file writer. ``notify_step`` is called at step boundaries;
    a daemon thread persists the latest state every ``interval_s``."""

    def __init__(self, hb_dir: str, interval_s: float = 5.0,
                 rank: Optional[int] = None):
        if rank is None:
            from deepspeed_tpu_torch.utils.logging import _process_index

            rank = _process_index()
        self.rank = int(rank)
        self.dir = os.path.abspath(hb_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir,
                                 HEARTBEAT_FILE_FMT.format(rank=self.rank))
        self.interval_s = float(interval_s)
        self.last_step = 0
        self.last_step_time = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Heartbeat":
        if self._thread is None:
            self.beat()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=f"heartbeat-{self.rank}")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1.0)
            self._thread = None

    def notify_step(self, step: int) -> None:
        self.last_step = int(step)
        self.last_step_time = time.monotonic()

    def step_age_s(self) -> float:
        return time.monotonic() - self.last_step_time

    def beat(self) -> None:
        from deepspeed_tpu_torch.utils.io import atomic_write_text

        payload = {"rank": self.rank, "pid": os.getpid(),
                   "step": self.last_step,
                   "step_age_s": round(self.step_age_s(), 3),
                   "time": time.time(),
                   # the host collective in flight, in the reference's
                   # file format: none runs on one device
                   "inflight": None}
        try:
            atomic_write_text(self.path, json.dumps(payload))
        except OSError as e:  # a full/unreachable FS must not kill the writer
            logger.warning(f"heartbeat write failed: {e}")

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def peer_gaps(self) -> Dict[int, float]:
        """Seconds since each peer's heartbeat file was last written (mtime),
        this process excluded. Stale entries are the straggler suspects."""
        gaps: Dict[int, float] = {}
        now = time.time()
        try:
            names = os.listdir(self.dir)
        except OSError:
            return gaps
        for name in names:
            if not (name.startswith("heartbeat_") and name.endswith(".json")):
                continue
            try:
                rank = int(name[len("heartbeat_"):-len(".json")])
            except ValueError:
                continue
            if rank == self.rank:
                continue
            try:
                gaps[rank] = now - os.path.getmtime(
                    os.path.join(self.dir, name))
            except OSError:
                continue
        return gaps


class HangWatchdog:
    """Poll thread that turns silence into an escalation (see module doc)."""

    def __init__(self, heartbeat: Heartbeat, deadline_s: float = 300.0,
                 collective_deadline_s: Optional[float] = 120.0,
                 poll_s: Optional[float] = None, coordinator=None,
                 on_hang: str = "abort", exit_code: int = 47):
        if on_hang not in ("abort", "exit", "report"):
            raise ValueError(f"unknown on_hang policy {on_hang!r} "
                             "(have: abort, exit, report)")
        self.heartbeat = heartbeat
        self.deadline_s = float(deadline_s)
        self.collective_deadline_s = (None if collective_deadline_s is None
                                      else float(collective_deadline_s))
        candidates = [self.deadline_s]
        if self.collective_deadline_s is not None:
            candidates.append(self.collective_deadline_s)
        self.poll_s = float(poll_s) if poll_s else max(
            0.05, min(candidates) / 4.0)
        self.coordinator = coordinator
        self.on_hang = on_hang
        self.exit_code = int(exit_code)
        self.hang_detected = False
        self.last_cause = ""
        self.counters: Dict[str, float] = {
            "hangs_detected": 0, "stuck_collectives": 0, "stalled_steps": 0,
            "max_peer_gap_s": 0.0,
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HangWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="hang-watchdog")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s + 1.0)
            self._thread = None

    # ------------------------------------------------------------------
    def classify(self) -> str:
        """Best-effort straggler classification from the existing timers:
        the slowest eagerly-timed comm op and peers with stale heartbeat
        files."""
        from deepspeed_tpu_torch.comm.logger import comms_logger

        parts = []
        slowest, slowest_avg = None, 0.0
        for op, sizes in list(comms_logger.comms_dict.items()):
            lats = [v for vals in list(sizes.values()) for v in vals]
            if lats and sum(lats) / len(lats) > slowest_avg:
                slowest, slowest_avg = op, sum(lats) / len(lats)
        if slowest is not None:
            parts.append(f"slowest timed op {slowest} "
                         f"(avg {slowest_avg * 1e3:.1f}ms)")
        gaps = self.heartbeat.peer_gaps()
        if gaps:
            worst = max(gaps, key=gaps.get)
            self.counters["max_peer_gap_s"] = max(
                self.counters["max_peer_gap_s"], gaps[worst])
            stale = {r: round(g, 1) for r, g in gaps.items()
                     if g > self.deadline_s}
            if stale:
                parts.append(f"stale peer heartbeats {stale}")
            else:
                parts.append(f"largest peer heartbeat gap rank {worst} "
                             f"({gaps[worst]:.1f}s)")
        return "; ".join(parts) if parts else "no straggler evidence"

    def check(self) -> Optional[str]:
        """One poll: returns the hang cause (and escalates) or None."""
        cause = counter = None
        if self.heartbeat.last_step > 0 \
                and self.heartbeat.step_age_s() > self.deadline_s:
            # armed only after the first boundary: the first step's
            # warm-up (kernel builds) legitimately exceeds any deadline
            counter = "stalled_steps"
            cause = (f"no step boundary for "
                     f"{self.heartbeat.step_age_s():.1f}s "
                     f"(deadline {self.deadline_s}s)")
        if cause is None:
            if self.hang_detected:
                # condition cleared (the collective returned, steps resumed):
                # re-arm so a LATER, unrelated hang is a fresh event —
                # last_cause is kept for the post-mortem, and an already-cast
                # abort vote deliberately stands (see class docstring)
                self.hang_detected = False
                logger.warning("hang watchdog: condition cleared; re-armed "
                               "(an already-signaled abort still stands)")
            return None
        if self.hang_detected:
            # counters tick on the DETECTION transition only — a hang that
            # persists across polls is one event, not one per poll
            return cause
        self.hang_detected = True
        self.counters[counter] += 1
        self.counters["hangs_detected"] += 1
        try:
            extra = self.classify()
        except Exception as e:  # classification must never block escalation
            extra = f"classification failed: {e}"
        self.last_cause = f"{cause}; {extra}"
        logger.error(f"hang watchdog: {self.last_cause} "
                     f"(escalation={self.on_hang})")
        self._escalate()
        return cause

    def _escalate(self) -> None:
        from deepspeed_tpu_torch.observability.events import get_bus
        from deepspeed_tpu_torch.observability.trace import flight_dump

        bus = get_bus()
        if bus.enabled:
            bus.instant("resilience", "hang_escalation",
                        args={"policy": self.on_hang,
                              "cause": self.last_cause[:400]})
        # the black box of "what was in flight when the watchdog fired" —
        # keyed per detection so a re-armed later hang dumps again while
        # one incident never dumps twice
        flight_dump("hang_watchdog",
                    extra={"cause": self.last_cause, "policy": self.on_hang,
                           "counters": dict(self.counters)},
                    key=f"hang-{int(self.counters['hangs_detected'])}")
        if self.coordinator is not None:
            self.coordinator.signal_abort(f"hang: {self.last_cause}")
        if self.on_hang == "exit":
            self.heartbeat.beat()  # last words for the post-mortem
            logger.error(f"hang watchdog: exiting with code {self.exit_code} "
                         "for the elastic agent to respawn")
            os._exit(self.exit_code)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception as e:  # the watchdog must never kill training
                logger.warning(f"hang watchdog poll failed: {e}")

    def report(self) -> Dict:
        return {"hang_detected": self.hang_detected,
                "last_cause": self.last_cause,
                "counters": dict(self.counters)}
