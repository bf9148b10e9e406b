"""Curriculum learning scheduler (counterpart of
``deepspeed_tpu/runtime/data_pipeline/curriculum.py``): the difficulty
(e.g. the sequence length) grows with the training step under the
fixed_linear / fixed_root / fixed_discrete schedules, rounded down to a
multiple of ``difficulty_step``. The engine truncates each batch to the
current difficulty.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List


class CurriculumScheduler:
    def __init__(self, config: Dict[str, Any]):
        self.schedule_type = config.get("curriculum_type", "seqlen")
        self.min_difficulty = int(config["min_difficulty"])
        self.max_difficulty = int(config["max_difficulty"])
        self.schedule = config.get("schedule_type", "fixed_linear")
        sc = config.get("schedule_config", {})
        self.total_steps = int(sc.get("total_curriculum_step", 10000))
        self.difficulty_step = int(sc.get("difficulty_step", 8))
        self.root_degree = int(sc.get("root_degree", 2))
        self.discrete_levels: List[int] = list(sc.get("difficulty", []))
        self.discrete_steps: List[int] = list(sc.get("max_step", []))
        self.current_difficulty = self.min_difficulty

    def update_difficulty(self, global_step: int) -> int:
        s = min(max(global_step, 0), self.total_steps)
        if self.schedule == "fixed_linear":
            frac = s / max(self.total_steps, 1)
        elif self.schedule == "fixed_root":
            frac = (s / max(self.total_steps, 1)) ** (1.0 / self.root_degree)
        elif self.schedule == "fixed_discrete":
            level = sum(1 for ms in self.discrete_steps if global_step >= ms)
            level = min(level, len(self.discrete_levels) - 1)
            self.current_difficulty = self.discrete_levels[level]
            return self.current_difficulty
        else:
            raise ValueError(f"unknown curriculum schedule {self.schedule}")
        diff = self.min_difficulty + frac * (self.max_difficulty - self.min_difficulty)
        # round to difficulty_step granularity (static-shape buckets limit retraces)
        diff = int(diff // self.difficulty_step * self.difficulty_step)
        self.current_difficulty = max(self.min_difficulty,
                                      min(diff, self.max_difficulty))
        return self.current_difficulty

    def get_current_difficulty(self) -> int:
        return self.current_difficulty
