"""Wall-clock and throughput timers (counterpart of
``deepspeed_tpu/utils/timer.py``).

Parity target: ``deepspeed/utils/timer.py`` — ``SynchronizedWallClockTimer`` (:44) and
``ThroughputTimer`` (:199). A synchronizing start/stop waits on the timer's
device (``torch.cuda.synchronize(device)`` on the card; the CPU runs eagerly,
so there is nothing to wait for), so host timestamps bound the device work
queued before them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import log_dist

try:
    import psutil  # type: ignore
except Exception:  # pragma: no cover
    psutil = None


def _synchronize(device=None) -> None:
    """Drain the work queued on ``device`` (a CUDA device; None or a CPU
    device has no queue) so host timestamps bound device time."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return
    torch.cuda.synchronize(device)


class _Timer:
    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self.started = False
        self.start_time = 0.0
        self.elapsed_ = 0.0
        self.records: List[float] = []

    def start(self, synchronize: bool = True) -> None:
        if self.started:
            return
        if synchronize:
            _synchronize(self.device)
        self.start_time = time.perf_counter()
        self.started = True

    def stop(self, record: bool = True, synchronize: bool = True) -> None:
        if not self.started:
            return
        if synchronize:
            _synchronize(self.device)
        delta = time.perf_counter() - self.start_time
        self.elapsed_ += delta
        if record:
            self.records.append(delta)
        self.started = False

    def elapsed(self, reset: bool = True) -> float:
        value = self.elapsed_
        if reset:
            self.elapsed_ = 0.0
        return value

    def mean(self) -> float:
        return sum(self.records) / max(len(self.records), 1)

    def reset(self) -> None:
        self.started = False
        self.elapsed_ = 0.0
        self.records = []


class SynchronizedWallClockTimer:
    """Named timer group whose start/stop synchronize with the queue of
    ``device`` (the engine's; None: nothing to wait for)."""

    def __init__(self, device=None):
        self.device = device
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self.device)
        return self.timers[name]

    def has(self, name: str) -> bool:
        return name in self.timers

    @staticmethod
    def memory_usage() -> str:
        if psutil is None:
            return "mem: n/a"
        vm = psutil.virtual_memory()
        return f"host mem used {vm.used / 2**30:.1f}GB ({vm.percent:.0f}%)"

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True,
            memory_breakdown: bool = False, ranks: Optional[List[int]] = None) -> None:
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {elapsed:.2f}ms")
        if parts:
            msg = "time (ms) | " + " | ".join(parts)
            if memory_breakdown:
                msg += " | " + self.memory_usage()
            log_dist(msg, ranks=ranks)


class ThroughputTimer:
    """Samples/sec + TFLOPS estimate across training steps.

    ``flops_per_sample`` (if provided) gives a model-level TFLOPS/MFU readout the way
    the reference estimates via its config (utils/timer.py:199). Its
    measured steps synchronize with ``device``'s queue.
    """

    def __init__(self, batch_size: int, start_step: int = 2, steps_per_output: int = 50,
                 flops_per_sample: Optional[float] = None, monitor_memory: bool = False,
                 device=None):
        self.device = device
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.flops_per_sample = flops_per_sample
        self.monitor_memory = monitor_memory
        self.epoch_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self.steps_in_window = 0
        self.started = False
        self.start_time = 0.0

    def update_epoch_count(self) -> None:
        self.epoch_count += 1

    def start(self) -> None:
        if self.started:
            return  # one window spans all GA micro-steps; don't reset mid-window
        self.started = True
        if self.global_step_count >= self.start_step:
            _synchronize(self.device)
            self.start_time = time.perf_counter()

    def stop(self, global_step: bool = True, report_speed: bool = True) -> None:
        if not self.started:
            return
        self.started = False
        if global_step:
            self.global_step_count += 1
        if self.start_time and self.global_step_count > self.start_step:
            _synchronize(self.device)
            duration = time.perf_counter() - self.start_time
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            self.steps_in_window += 1
            if report_speed and self.global_step_count % self.steps_per_output == 0:
                # divide by steps actually measured — the first window is short by
                # start_step warmup steps
                steps = max(self.steps_in_window, 1)
                samples_per_sec = steps * self.batch_size / max(self.step_elapsed_time, 1e-9)
                msg = (f"step={self.global_step_count} "
                       f"samples/sec={samples_per_sec:.2f} "
                       f"time/step={self.step_elapsed_time / steps * 1000:.1f}ms")
                if self.flops_per_sample:
                    tflops = samples_per_sec * self.flops_per_sample / 1e12
                    msg += f" est_tflops={tflops:.1f}"
                if self.monitor_memory:
                    msg += " | " + SynchronizedWallClockTimer.memory_usage()
                log_dist(msg)
                self.step_elapsed_time = 0.0
                self.steps_in_window = 0

    def avg_samples_per_sec(self) -> float:
        if self.total_elapsed_time <= 0:
            return 0.0
        effective_steps = self.global_step_count - self.start_step
        return effective_steps * self.batch_size / self.total_elapsed_time
