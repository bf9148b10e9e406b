"""Step-boundary resilience decisions (counterpart of
``deepspeed_tpu/resilience/coordinator.py``).

At each step boundary a process folds its local signals (preemption notice,
step-guard abort budget, watchdog hang, injected faults) into a single int
code, and a max-reduce over the fleet makes every process act on the same
code at the same step:

* ``CONTINUE`` (0) — nobody signaled; keep stepping.
* ``SAVE`` (1) — someone holds a preemption notice; everyone commits the
  SAME emergency tag (``preempt_step{N}``) this boundary.
* ``ABORT`` (2) — someone cannot make progress (NaN budget spent, hung
  step); everyone raises :class:`CoordinatedAbort` this boundary.

Max-reduce gives the dominance order ABORT > SAVE > CONTINUE with one
scalar. ``interval_steps`` > 1 trades signal latency for reduce rate and
holds pending signals until the next scheduled agreement step. The agreed
decision and the deciding step are recorded in the checkpoint manifest
(``CheckpointManager.save(decision=...)``).

The port runs one process on one device: without a ``reduce_fn`` the
process decides locally (its own code is the fleet's). Tests drive 2+
simulated processes by injecting ``reduce_fn`` (a barrier-backed thread
max-reduce), as the reference's do. A cross-process reduce needs a process
group, which the port does not have yet: :func:`kv_store_max_reduce`
raises.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["CONTINUE", "SAVE", "ABORT", "DECISION_NAMES",
           "CoordinatedAbort", "ResilienceCoordinator",
           "kv_store_max_reduce"]

CONTINUE, SAVE, ABORT = 0, 1, 2
DECISION_NAMES = {CONTINUE: "CONTINUE", SAVE: "SAVE", ABORT: "ABORT"}


class CoordinatedAbort(RuntimeError):
    """The fleet agreed to abort this incarnation (hang, peer failure, or a
    step-guard budget spent somewhere); the elastic agent should respawn."""


def kv_store_max_reduce(num_processes: Optional[int] = None,
                        rank: Optional[int] = None,
                        timeout_ms: int = 60_000,
                        namespace: str = "resilience/decide"
                        ) -> Callable[[int], int]:
    """The reference's cross-process max-reduce over the JAX distributed
    key-value store. The port has no process group yet: raises."""
    raise NotImplementedError(
        "kv_store_max_reduce needs a process group across hosts, which the "
        'PyTorch port does not have yet (ROADMAP section 1, "Mesh, ZeRO and '
        'tensor parallelism"); one process decides locally')


class ResilienceCoordinator:
    """One per process. ``decide`` is called at every step boundary."""

    def __init__(self, reduce_fn: Optional[Callable[[int], int]] = None,
                 interval_steps: int = 1):
        """``reduce_fn(code) -> agreed_code`` is the cross-process
        max-reduce (tests inject a thread-barrier reduce; ``None`` decides
        locally: one process). ``interval_steps`` runs the reduce every N
        boundaries — pending signals are held, never dropped."""
        self._reduce = reduce_fn
        self.interval_steps = max(1, int(interval_steps))
        # signals arrive from other threads (SIGTERM handler, watchdog);
        # the pending slot is read-and-reset by decide() — lock the window
        # so a signal landing mid-decide is carried, never overwritten
        self._lock = threading.Lock()
        self._pending_code = CONTINUE    #: guarded_by: _lock
        self._pending_reason = ""        #: guarded_by: _lock
        # boundaries seen, NOT global_steps: skipped steps don't advance the
        # step counter, and the interval gate must keep ticking through a
        # NaN burst or a preemption would be held forever
        self._boundaries = 0             #: guarded_by: _lock
        self.last_decision = CONTINUE
        self.last_decision_step = -1
        self.last_reason = ""
        # incremented from signal threads (SIGTERM handler, watchdog) AND
        # the step thread: a dict-slot += is not atomic, so unguarded
        # increments lose updates under contention
        self.counters: Dict[str, int] = {  #: guarded_by: _lock
            "collectives": 0, "saves_agreed": 0, "aborts_agreed": 0,
            "signals_save": 0, "signals_abort": 0, "decide_latency_us": 0,
        }

    # ------------------------------------------------------------------
    # local signals (set from any thread: SIGTERM handler, watchdog, guard)
    # ------------------------------------------------------------------
    def signal_save(self, reason: str = "") -> None:
        with self._lock:
            self.counters["signals_save"] += 1
            if self._pending_code < SAVE:
                self._pending_code, self._pending_reason = SAVE, reason

    def signal_abort(self, reason: str = "") -> None:
        with self._lock:
            self.counters["signals_abort"] += 1
            if self._pending_code < ABORT:
                self._pending_code, self._pending_reason = ABORT, reason

    # ------------------------------------------------------------------
    def _agree(self, code: int) -> int:
        if self._reduce is not None:
            return int(self._reduce(code))
        return int(code)    # one process: its own code is the fleet's

    def decide(self, step: int, local_code: int = CONTINUE,
               local_reason: str = "") -> int:
        """Fold ``local_code`` + pending signals, agree with the fleet.

        Off-interval boundaries return CONTINUE without a collective and keep
        any pending signal armed — peers must enter the collective at the
        same boundary, so a signal raised between agreement boundaries waits
        for the next scheduled one. The interval counts BOUNDARIES (which
        advance even when every step is skipped), not ``step``."""
        with self._lock:
            if local_code > self._pending_code:
                self._pending_code = local_code
                self._pending_reason = local_reason
            self._boundaries += 1
            if self.interval_steps > 1 \
                    and self._boundaries % self.interval_steps != 0:
                return CONTINUE
            code, reason = self._pending_code, self._pending_reason
            self._pending_code, self._pending_reason = CONTINUE, ""
        t0 = time.monotonic()
        agreed = self._agree(code)
        with self._lock:
            self.counters["collectives"] += 1
            self.counters["decide_latency_us"] += int(
                (time.monotonic() - t0) * 1e6)
        self.last_decision = agreed
        self.last_decision_step = int(step)
        if agreed != CONTINUE:
            if agreed > code:
                # the agreed action outranks this process's own vote: a peer
                # drove it. The label must say so even when a weaker local
                # vote (e.g. a pending SAVE under an agreed ABORT) carried
                # its own reason — the agent keys respawn decisions on it.
                self.last_reason = ("peer signal"
                                    + (f" (local: {reason})" if reason
                                       else ""))
            else:
                self.last_reason = reason or "peer signal"
            key = "saves_agreed" if agreed == SAVE else "aborts_agreed"
            with self._lock:
                self.counters[key] += 1
            from deepspeed_tpu_torch.observability.events import get_bus

            bus = get_bus()
            if bus.enabled:
                bus.instant("resilience", "fleet_decision",
                            args={"decision": DECISION_NAMES[agreed],
                                  "step": int(step),
                                  "local": DECISION_NAMES[code],
                                  "reason": self.last_reason[:400]})
            logger.warning(
                f"resilience coordinator: fleet agreed "
                f"{DECISION_NAMES[agreed]} at step {step} "
                f"(local={DECISION_NAMES[code]}, reason={self.last_reason!r})")
        return agreed

    def decision_record(self) -> Dict:
        """The manifest stamp for a coordinated save/abort."""
        return {"decision": DECISION_NAMES[self.last_decision],
                "step": self.last_decision_step,
                "reason": self.last_reason}

    def report(self) -> Dict:
        with self._lock:
            counters = dict(self.counters)
        return {"last_decision": DECISION_NAMES[self.last_decision],
                "last_decision_step": self.last_decision_step,
                "last_reason": self.last_reason,
                "counters": counters}
