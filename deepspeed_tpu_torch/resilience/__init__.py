"""Resilience layer (counterpart of ``deepspeed_tpu/resilience``): fault
injection, retries, preemption-safe checkpointing, the self-healing step
guard, step-boundary coordination and the hang watchdog.

* :mod:`~deepspeed_tpu_torch.resilience.faults` — deterministic fault
  injection (crashes, torn checkpoint writes, NaN gradients, serving and
  replica faults) driven by the ``resilience.faults`` config block or
  directly from tests;
* :mod:`~deepspeed_tpu_torch.resilience.retry` — :class:`RetryPolicy`
  (exponential backoff + jitter + deadline) wrapped around checkpoint IO;
* :mod:`~deepspeed_tpu_torch.resilience.manager` —
  :class:`CheckpointManager`: SIGTERM-triggered emergency save, keep-last-K
  retention, a per-checkpoint manifest + checksum, and load-time fallback
  to the previous verified tag;
* :mod:`~deepspeed_tpu_torch.resilience.guard` — :class:`StepGuard`:
  detects NaN/Inf loss or gradients, skips the step, rewinds the
  LR/loss-scale tick, and aborts after N consecutive bad steps;
* :mod:`~deepspeed_tpu_torch.resilience.coordinator` —
  :class:`ResilienceCoordinator`: folds local signals into one
  CONTINUE/SAVE/ABORT decision per step boundary (one process decides
  locally; a cross-process reduce comes with process groups);
* :mod:`~deepspeed_tpu_torch.resilience.heartbeat` — :class:`Heartbeat`
  liveness files + :class:`HangWatchdog`: stalled steps are detected
  against a deadline and escalated into a coordinated ABORT (or a hard
  exit).

All recovery events are counted and exposed through the training engine's
``resilience_report()``.
"""

from deepspeed_tpu_torch.resilience.coordinator import (ABORT, CONTINUE, SAVE,
                                                        CoordinatedAbort,
                                                        ResilienceCoordinator,
                                                        kv_store_max_reduce)
from deepspeed_tpu_torch.resilience.faults import (FaultInjector, FaultSpec,
                                                   InjectedCrash,
                                                   InjectedIOError,
                                                   get_injector, set_injector,
                                                   tear_checkpoint_dir)
from deepspeed_tpu_torch.resilience.guard import StepGuard, TooManyBadSteps
from deepspeed_tpu_torch.resilience.heartbeat import HangWatchdog, Heartbeat
from deepspeed_tpu_torch.resilience.manager import CheckpointManager
from deepspeed_tpu_torch.resilience.retry import (RetryDeadlineExceeded,
                                                  RetryPolicy, retry_call)

__all__ = [
    "ABORT",
    "CONTINUE",
    "SAVE",
    "CheckpointManager",
    "CoordinatedAbort",
    "FaultInjector",
    "FaultSpec",
    "HangWatchdog",
    "Heartbeat",
    "InjectedCrash",
    "InjectedIOError",
    "ResilienceCoordinator",
    "RetryDeadlineExceeded",
    "RetryPolicy",
    "StepGuard",
    "TooManyBadSteps",
    "get_injector",
    "kv_store_max_reduce",
    "set_injector",
    "retry_call",
    "tear_checkpoint_dir",
]
