"""Engine-managed data loader (counterpart of
``deepspeed_tpu/runtime/dataloader.py``; numpy, the port keeps its own
copy).

The engine builds a loader from ``training_data`` with the resolved
micro-batch size: it yields micro-batches of ``micro_batch`` examples as
numpy arrays, which the engine moves to its device.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import numpy as np


def default_collate(samples) -> Any:
    """Stack a list of samples (dicts of arrays / arrays / tuples) into a batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([np.asarray(s[i]) for s in samples])
                           for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedTpuDataLoader:
    """Batches an indexable or iterable dataset into micro-batches; an
    indexable dataset is shuffled per epoch from ``seed + epoch``."""

    def __init__(self, dataset, batch_size: int, collate_fn: Optional[Callable] = None,
                 shuffle: bool = True, seed: int = 42, drop_last: bool = True,
                 num_local_io_workers: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.collate_fn = collate_fn or default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[Any]:
        try:
            n = len(self.dataset)
        except TypeError:
            yield from self._iter_iterable()
            return
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        num_batches = len(self)
        for b in range(num_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
        self.epoch += 1

    def _iter_iterable(self) -> Iterator[Any]:
        buf = []
        for sample in self.dataset:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)


class RepeatingLoader:
    """Infinite wrapper (reference ``runtime/dataloader.py`` RepeatingLoader)."""

    def __init__(self, loader):
        self.loader = loader
        self._it = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)
