"""On-demand ``torch.profiler`` capture for a *running* job (counterpart of
``deepspeed_tpu/observability/profiler.py``).

A production hang or slowdown is exactly the moment you cannot restart the
process with profiling flags. :class:`ProfileTrigger` arms a
``torch.profiler`` trace capture from the outside — touch a trigger file or
send ``SIGUSR2`` — and the next step boundary starts a capture of N steps
into a timestamped subdirectory, then stops it. Guard rails:

* **never during warm-up** — the trigger only fires after ``warmup_steps``
  step boundaries have passed (the first boundaries are where kernels
  build and caches warm; a trace spanning them is useless and enormous),
  and arming earlier is *held*, not dropped;
* **rate-limited** — at most one capture per ``rate_limit_s``; an arm
  inside the window is counted (``suppressed_rate_limit``) and cleared so
  a stuck trigger file cannot turn the profiler into a firehose;
* **crash-proof** — profiler failures are logged and disarm the trigger;
  they never take the training/serving loop down.

``check(step)`` is the only hot-path call: when idle it is one ``Event``
check plus (only if a trigger file is configured) one ``os.path.exists``
stat — no device interaction whatsoever.
"""

from __future__ import annotations

import os
import signal as _signal
import threading
import time
from typing import Callable, Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["ProfileTrigger"]

#: the Chrome trace a default capture writes into its capture directory
TRACE_FILE = "trace.json"


#: the capture in flight: (profiler, capture directory)
_ACTIVE: Optional[tuple] = None


def _default_start(log_dir: str) -> None:
    """Start a ``torch.profiler`` session recording host (CPU) activity and,
    where a card is present, its kernels (CUDA)."""
    global _ACTIVE
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _ACTIVE is not None:
        raise RuntimeError("a profile capture is already running")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _ACTIVE = (prof, log_dir)


def _default_stop() -> None:
    """Stop the running capture and write its Chrome trace to
    ``<capture dir>/trace.json``."""
    global _ACTIVE
    if _ACTIVE is None:
        raise RuntimeError("no profile capture is running")
    prof, log_dir = _ACTIVE
    _ACTIVE = None
    prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class ProfileTrigger:
    """Arm-from-outside ``torch.profiler`` capture at step boundaries.

    ``start_fn`` / ``stop_fn`` are injectable so tests can observe the
    capture lifecycle without writing real traces.
    """

    def __init__(self, output_dir: str, capture_steps: int = 5,
                 rate_limit_s: float = 300.0,
                 trigger_file: Optional[str] = None,
                 warmup_steps: int = 2,
                 clock: Callable[[], float] = time.monotonic,
                 start_fn: Callable[[str], None] = _default_start,
                 stop_fn: Callable[[], None] = _default_stop):
        self.output_dir = output_dir
        self.capture_steps = max(1, int(capture_steps))
        self.rate_limit_s = float(rate_limit_s)
        self.trigger_file = (trigger_file if trigger_file is not None
                             else os.path.join(output_dir, "TRIGGER"))
        self.warmup_steps = max(0, int(warmup_steps))
        self.clock = clock
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self._armed = threading.Event()
        self._stop_at_step: Optional[int] = None
        self._capture_dir: Optional[str] = None
        self._last_capture_t: Optional[float] = None
        self._boundaries = 0
        self._prev_handler = None
        self.counters: Dict[str, int] = {
            "captures": 0, "suppressed_rate_limit": 0, "capture_errors": 0,
        }

    @classmethod
    def from_config(cls, cfg, **kw) -> "ProfileTrigger":
        """Build from an ``observability.profile`` config block."""
        return cls(output_dir=cfg.output_dir,
                   capture_steps=cfg.capture_steps,
                   rate_limit_s=cfg.rate_limit_s,
                   trigger_file=cfg.trigger_file or None,
                   warmup_steps=cfg.warmup_steps, **kw)

    # ------------------------------------------------------------------
    # arming surfaces
    # ------------------------------------------------------------------
    def arm(self) -> None:
        """Programmatic arm (what the signal handler and drills call)."""
        self._armed.set()

    def install_signal_handler(self, signum: int = None) -> None:
        """``SIGUSR2`` (default) arms a capture; handler is async-safe — it
        only sets an Event, the capture itself runs at a step boundary."""
        if signum is None:
            signum = _signal.SIGUSR2
        self._signum = signum
        self._prev_handler = _signal.signal(
            signum, lambda _s, _f: self._armed.set())

    def restore_signal_handler(self) -> None:
        if self._prev_handler is not None:
            _signal.signal(self._signum, self._prev_handler)
            self._prev_handler = None

    # ------------------------------------------------------------------
    # step-boundary hook
    # ------------------------------------------------------------------
    @property
    def capturing(self) -> bool:
        return self._stop_at_step is not None

    def _consume_trigger_file(self) -> bool:
        if not self.trigger_file or not os.path.exists(self.trigger_file):
            return False
        try:
            os.unlink(self.trigger_file)
        except OSError:
            pass  # already consumed by a peer process on shared storage
        return True

    def check(self, step: int) -> Optional[str]:
        """Call at every step boundary. Starts/stops captures as armed.
        Returns the capture directory when a capture STOPS (handy for
        drills), else None."""
        self._boundaries += 1
        if self._stop_at_step is not None:
            if step >= self._stop_at_step:
                return self._finish()
            return None
        armed = self._armed.is_set() or self._consume_trigger_file()
        if not armed:
            return None
        # warm-up exemption: hold (not drop) the arm until warmup passes —
        # the first boundaries are where kernels build and caches warm, and
        # a trace spanning them would bury the steady-state steps
        if self._boundaries <= self.warmup_steps:
            self._armed.set()
            return None
        now = self.clock()
        if self._last_capture_t is not None \
                and now - self._last_capture_t < self.rate_limit_s:
            self.counters["suppressed_rate_limit"] += 1
            self._armed.clear()
            logger.warning(
                f"profile trigger suppressed: last capture "
                f"{now - self._last_capture_t:.0f}s ago "
                f"(rate limit {self.rate_limit_s:.0f}s)")
            return None
        self._armed.clear()
        cap_dir = os.path.join(
            self.output_dir,
            f"capture{self.counters['captures']}_step{step}")
        try:
            os.makedirs(cap_dir, exist_ok=True)
            self.start_fn(cap_dir)
        except Exception as e:
            self.counters["capture_errors"] += 1
            logger.error(f"profile capture failed to start: {e}")
            return None
        self._capture_dir = cap_dir
        self._stop_at_step = step + self.capture_steps
        self._last_capture_t = now
        logger.warning(f"profile capture started at step {step} "
                       f"({self.capture_steps} steps -> {cap_dir})")
        return None

    def _finish(self) -> Optional[str]:
        cap_dir, self._capture_dir = self._capture_dir, None
        self._stop_at_step = None
        try:
            self.stop_fn()
        except Exception as e:
            self.counters["capture_errors"] += 1
            logger.error(f"profile capture failed to stop: {e}")
            return None
        self.counters["captures"] += 1
        logger.warning(f"profile capture complete: {cap_dir}")
        return cap_dir

    def close(self) -> None:
        """Stop an in-flight capture and restore the signal handler."""
        if self._stop_at_step is not None:
            self._finish()
        self.restore_signal_handler()

    def report(self) -> Dict:
        return {"capturing": self.capturing, "armed": self._armed.is_set(),
                "counters": dict(self.counters),
                "output_dir": self.output_dir,
                "trigger_file": self.trigger_file}
