"""Retry with exponential backoff, jitter, and a wall-clock deadline
(counterpart of ``deepspeed_tpu/resilience/retry.py``, a straight port).

Wrapped around the operations that fail transiently: checkpoint IO against
remote filesystems (the checkpoint manager's stage, manifest, ``latest`` and
load). The reference also wraps its host-level collectives; the port runs
none on one device.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type

from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["RetryPolicy", "RetryDeadlineExceeded", "retry_call"]


class RetryDeadlineExceeded(TimeoutError):
    """Retries exhausted (attempt budget or wall-clock deadline)."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: delay_n = min(base * mult^n, max_delay) ± jitter.

    ``deadline_s`` bounds TOTAL elapsed time across attempts — a hung remote
    filesystem must not stall a preemption-window save past the grace period.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25          # fraction of the delay randomized away
    deadline_s: Optional[float] = None

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        d = min(self.base_delay_s * (self.multiplier ** attempt),
                self.max_delay_s)
        if self.jitter > 0:
            r = (rng or random).uniform(-self.jitter, self.jitter)
            d = max(0.0, d * (1.0 + r))
        return d


def retry_call(fn: Callable, *args,
               policy: Optional[RetryPolicy] = None,
               retry_on: Tuple[Type[BaseException], ...] = (OSError, IOError),
               what: str = "operation",
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying on ``retry_on`` per ``policy``.

    ``on_retry(attempt, exc)`` fires before each backoff sleep (counters).
    Raises :class:`RetryDeadlineExceeded` (chained to the last error) when the
    attempt budget or deadline is spent.
    """
    policy = policy or RetryPolicy()
    t0 = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            last = e
            elapsed = time.monotonic() - t0
            if policy.deadline_s is not None and elapsed >= policy.deadline_s:
                break
            if attempt == policy.max_attempts - 1:
                break
            d = policy.delay(attempt)
            if policy.deadline_s is not None:
                d = min(d, max(0.0, policy.deadline_s - elapsed))
            logger.warning(f"{what} failed (attempt {attempt + 1}/"
                           f"{policy.max_attempts}): {e}; retrying in {d:.3f}s")
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(d)
    raise RetryDeadlineExceeded(
        f"{what} failed after {policy.max_attempts} attempts / "
        f"{time.monotonic() - t0:.2f}s") from last
