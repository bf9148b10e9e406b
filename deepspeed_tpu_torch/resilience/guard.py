"""Self-healing step guard (counterpart of
``deepspeed_tpu/resilience/guard.py``).

The reference's fp16 optimizers skip overflowed steps and shrink the loss
scale (``runtime/fp16/loss_scaler.py``). The guard generalizes that to a
runtime health loop for any precision:

* before the optimizer update it checks loss and global grad norm for
  NaN/Inf (and gives the fault injector its step/grads hooks);
* a bad step is SKIPPED — gradients dropped, LR schedule not ticked (the
  rewind), fp16 loss scale halved — instead of corrupting params, the
  optimizer's moments or its update count (the port's optimizer state is
  only touched by an applied update, so the skip leaves it as it was);
* after ``max_consecutive_bad_steps`` bad steps in a row it writes the
  resilience report and raises :class:`TooManyBadSteps` (a persistent NaN
  source means THIS incarnation cannot make progress — respawn from the
  last good checkpoint or give up).
"""

from __future__ import annotations

import math

from deepspeed_tpu_torch.resilience.faults import get_injector
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["StepGuard", "TooManyBadSteps"]


class TooManyBadSteps(RuntimeError):
    """Raised when consecutive NaN/Inf steps exhaust the healing budget."""


def _finite(x) -> bool:
    try:
        return math.isfinite(float(x))
    except (TypeError, ValueError):
        return False


class StepGuard:
    def __init__(self, engine, max_consecutive_bad_steps: int = 3):
        self.engine = engine
        self.max_consecutive_bad_steps = int(max_consecutive_bad_steps)
        self.consecutive_bad = 0
        self.counters = {
            "bad_steps_skipped": 0,   # imperative path: update NOT applied
            "bad_steps_detected": 0,  # fused path: update already applied
            "loss_scale_rewinds": 0,
            "injected_crashes_raised": 0, "aborts": 0,
        }

    # ------------------------------------------------------------------
    def pre_step(self) -> None:
        """Fault hooks that fire regardless of gradient health (crash at a
        configured step — the host-loss simulation)."""
        inj = get_injector()
        if inj:
            try:
                inj.maybe_crash(self.engine.global_steps)
            except BaseException:
                self.counters["injected_crashes_raised"] += 1
                raise

    def intercept(self) -> bool:
        """Run before the optimizer update. Returns True when the step was
        skipped (caller must not apply the update).

        Cost: one global norm + a host sync per step — the skip decision
        must land BEFORE the in-place update runs. Enabled only under
        ``resilience.enabled``."""
        import torch

        from deepspeed_tpu_torch.runtime.optimizers import global_norm

        eng = self.engine
        self.pre_step()
        # the accumulation buffer: each master leaf's .grad
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in eng._leaves]
        inj = get_injector()
        if inj:
            poisoned = inj.maybe_poison_grads(eng.global_steps, grads)
            if poisoned is not grads:
                for p, g in zip(eng._leaves, poisoned):
                    p.grad = g
                grads = poisoned
        gnorm = global_norm(grads)
        loss_ok = eng._last_loss is None or _finite(eng._last_loss)
        if _finite(gnorm) and loss_ok:
            self.consecutive_bad = 0
            return False
        self._heal(gnorm)
        if self.consecutive_bad >= self.max_consecutive_bad_steps:
            self.abort(f"{self.consecutive_bad} consecutive non-finite steps")
        return True

    def check_loss(self, loss) -> None:
        """Post-hoc health check for the fused path (the update already
        ran, so a bad step cannot be unwound — only DETECTED and, past the
        budget, escalated; counted separately from skips so the report
        never claims an applied-corrupt step was dropped). fp16 skips
        inside the step via the loss scaler, so this matters for bf16."""
        if loss is None or _finite(loss):
            self.consecutive_bad = 0
            return
        self.consecutive_bad += 1
        self.counters["bad_steps_detected"] += 1
        logger.error(f"non-finite loss at step {self.engine.global_steps} "
                     f"({self.consecutive_bad} consecutive); the fused "
                     "update was already applied — resume from a checkpoint "
                     "if this escalates")
        if self.consecutive_bad >= self.max_consecutive_bad_steps:
            self.abort(f"{self.consecutive_bad} consecutive non-finite losses")

    # ------------------------------------------------------------------
    def _heal(self, gnorm) -> None:
        """Skip bookkeeping: drop grads, keep LR untouched, shrink fp16 scale."""
        eng = self.engine
        # fp16 dynamic-scale calibration: overflow skips while the scale is
        # still walking down are the loss scaler WORKING, not a sick model —
        # they must not burn the abort budget. Only once the scale bottoms
        # out does a bad step count.
        calibrating = (eng.fp16_enabled
                       and float(eng.scaler_state["scale"])
                       > float(eng.config.fp16.min_loss_scale))
        if not calibrating:
            self.consecutive_bad += 1
        self.counters["bad_steps_skipped"] += 1
        from deepspeed_tpu_torch.observability.events import get_bus

        bus = get_bus()
        if bus.enabled:
            # these instants are what the flight dump of a later abort
            # carries: the skipped steps leading up to the budget
            bus.instant("resilience", "bad_step",
                        args={"step": int(eng.global_steps),
                              "consecutive": self.consecutive_bad,
                              "calibrating": calibrating})
        logger.error(
            f"step guard: non-finite loss/grads at step {eng.global_steps} "
            f"(gnorm={float(gnorm)}, consecutive={self.consecutive_bad}, "
            f"fp16_calibrating={calibrating}); skipping the update")
        if eng.fp16_enabled:
            eng.scaler_state = eng._scaler_update(eng.scaler_state, False)
            self.counters["loss_scale_rewinds"] += 1
        # clears the accumulator, counts skipped_steps, does NOT tick the LR
        # schedule — the "rewind" is that the schedule position (and the
        # optimizer's update count) stays at the last good step
        eng._skip_step(gnorm)

    def abort(self, reason: str) -> None:
        """Write the report (if a checkpoint dir is known), dump the
        flight recorder, and escalate."""
        self.counters["aborts"] += 1
        eng = self.engine
        report_dir = getattr(eng, "_resilience_report_dir", None)
        if report_dir:
            try:
                eng.write_resilience_report(report_dir)
            except OSError as e:
                logger.error(f"could not write resilience report: {e}")
        from deepspeed_tpu_torch.observability.events import get_bus
        from deepspeed_tpu_torch.observability.trace import flight_dump

        step = int(getattr(eng, "global_steps", -1))
        bus = get_bus()
        if bus.enabled:
            bus.instant("resilience", "stepguard_abort",
                        args={"step": step, "reason": reason})
        # keyed per step: the abort may surface via guard.abort AND the
        # coordinated-abort path for the same incident — one black box
        flight_dump("stepguard_abort",
                    extra={"step": step, "reason": reason,
                           "counters": dict(self.counters)},
                    key=f"abort-step{step}")
        logger.error(f"step guard aborting: {reason}")
        raise TooManyBadSteps(reason)
