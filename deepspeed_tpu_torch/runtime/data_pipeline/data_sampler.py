"""Curriculum-aware data sampler (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_sampler.py``): at each step,
draw only samples whose difficulty metric is within the curriculum's
current ceiling, so the data order itself follows the schedule.

The sampler keeps indices sorted by difficulty; each batch draws uniformly
from the admissible prefix under the current difficulty (never fewer than
a batch). Deterministic given (seed, step): the same numpy generator calls
as the reference, so both packages draw the same indices.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum import CurriculumScheduler


class DataEfficiencySampler:
    """Yields index batches filtered by the curriculum difficulty."""

    def __init__(self, difficulties: Sequence[float], batch_size: int,
                 scheduler: CurriculumScheduler, seed: int = 42,
                 drop_last: bool = True):
        self.difficulties = np.asarray(difficulties)
        self.batch_size = int(batch_size)
        self.scheduler = scheduler
        self.seed = seed
        self.drop_last = drop_last
        self.global_step = 0
        # ascending difficulty order; prefix of this array = admissible pool
        self._order = np.argsort(self.difficulties, kind="stable")
        self._sorted_diff = self.difficulties[self._order]

    def set_step(self, global_step: int) -> None:
        self.global_step = int(global_step)

    def _admissible(self) -> np.ndarray:
        limit = self.scheduler.update_difficulty(self.global_step)
        n = int(np.searchsorted(self._sorted_diff, limit, side="right"))
        return self._order[:max(n, self.batch_size)]  # never starve a batch

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(self.seed + self.global_step)
        while True:
            pool = self._admissible()
            idx = rng.choice(pool, size=self.batch_size,
                             replace=len(pool) < self.batch_size)
            yield idx
            self.global_step += 1
