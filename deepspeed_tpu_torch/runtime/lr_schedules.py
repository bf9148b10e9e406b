"""Learning-rate schedules (counterpart of
``deepspeed_tpu/runtime/lr_schedules.py``).

``WarmupLR``, ``WarmupDecayLR``, ``WarmupCosineLR``, ``OneCycle`` and
``LRRangeTest`` as plain ``step -> lr`` functions of a Python int (the
optimizer's update count), with the reference's formulas;
:class:`LRSchedulerShim` keeps the imperative ``step()`` / ``get_last_lr()``
surface.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

ScheduleFn = Callable[[int], float]


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_) -> ScheduleFn:
    def fn(step):
        s = min(float(step), warmup_num_steps)
        if warmup_type == "log":
            frac = math.log1p(s) / math.log(warmup_num_steps + 1)
        else:
            frac = s / max(warmup_num_steps, 1)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * min(frac, 1.0)

    return fn


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> ScheduleFn:
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)

    def fn(step):
        s = float(step)
        if s < warmup_num_steps:
            return warm(s)
        decay = max(0.0, (total_num_steps - s)
                    / max(1.0, total_num_steps - warmup_num_steps))
        return warmup_max_lr * decay

    return fn


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000,
                     cos_min_ratio: float = 0.0001,
                     warmup_max_lr: float = 0.001, **_) -> ScheduleFn:
    def fn(step):
        s = float(step)
        if s < warmup_num_steps:
            ratio = warmup_min_ratio + (1 - warmup_min_ratio) * min(
                s / max(warmup_num_steps, 1), 1.0)
        else:
            prog = min(max((s - warmup_num_steps)
                           / max(1, total_num_steps - warmup_num_steps), 0.0),
                       1.0)
            ratio = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (
                1 + math.cos(math.pi * prog))
        return warmup_max_lr * ratio

    return fn


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_) -> ScheduleFn:
    second = cycle_second_step_size or cycle_first_step_size
    total = cycle_first_step_size + second

    def fn(step):
        s = float(step)
        in_cycle = min(s, total)
        up = min(in_cycle, cycle_first_step_size) / cycle_first_step_size
        down = min(max((in_cycle - cycle_first_step_size) / second, 0.0), 1.0)
        lr = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (up - up * down)
        post = max(s - total, 0.0)
        if decay_step_size > 0:
            lr = lr * (1 - decay_lr_rate) ** (post // decay_step_size)
        return lr

    return fn


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> ScheduleFn:
    def fn(step):
        s = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            s = math.floor(s)
        return lr_range_test_min_lr * (1 + s * lr_range_test_step_rate)

    return fn


SCHEDULES: Dict[str, Callable[..., ScheduleFn]] = {
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "WarmupCosineLR": warmup_cosine_lr,
    "OneCycle": one_cycle,
    "LRRangeTest": lr_range_test,
}


def build_schedule(type_name: str, params: Dict[str, Any]) -> ScheduleFn:
    if type_name not in SCHEDULES:
        raise ValueError(f"unknown scheduler '{type_name}' "
                         f"(have {sorted(SCHEDULES)})")
    return SCHEDULES[type_name](**params)


class LRSchedulerShim:
    """Imperative facade over a schedule fn (reference lr_scheduler API)."""

    def __init__(self, schedule: ScheduleFn, engine=None):
        self.schedule = schedule
        self._engine = engine
        self._step = 0

    def step(self, increment: int = 1) -> None:
        self._step += increment

    @property
    def last_step(self) -> int:
        if self._engine is not None:
            return int(self._engine.global_steps)
        return self._step

    def get_last_lr(self):
        return [float(self.schedule(self.last_step))]

    def state_dict(self):
        return {"step": self._step}

    def load_state_dict(self, sd):
        self._step = int(sd["step"])
