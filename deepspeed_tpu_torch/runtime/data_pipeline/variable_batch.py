"""Variable batch size and LR (counterpart of
``deepspeed_tpu/runtime/data_pipeline/variable_batch.py``): group samples by
sequence length so every batch carries about the same token budget (short
sequences, bigger batches), and scale the LR with the batch-size ratio
(the linear rule by default, or sqrt). Batch sizes snap to a small set of
bucket sizes (powers of two by default).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def batch_by_tokens(seqlens: Sequence[int], max_tokens: int,
                    bucket_batch_sizes: Optional[Sequence[int]] = None,
                    shuffle_seed: Optional[int] = 42,
                    drop_last: bool = False) -> List[np.ndarray]:
    """Pack sample indices into batches of ≈``max_tokens`` tokens.

    Samples are sorted by length (so batches are length-homogeneous — the
    padding-waste killer), packed greedily, then the batch ORDER is shuffled.
    Batch sizes snap DOWN to the nearest allowed bucket size; ``drop_last``
    discards batches that could not reach any allowed size (a tail, or a
    single sample over the budget) — required when batches must shard evenly
    over a data-parallel mesh.
    """
    seqlens = np.asarray(seqlens)
    if bucket_batch_sizes is None:
        bucket_batch_sizes = [1, 2, 4, 8, 16, 32, 64, 128, 256]
    buckets = sorted(int(b) for b in bucket_batch_sizes)
    order = np.argsort(seqlens, kind="stable")
    batches: List[np.ndarray] = []
    i = 0
    while i < len(order):
        remaining = len(order) - i
        # sorted ascending: a window of size b is bounded by its LAST element
        feasible = [b for b in buckets
                    if b <= remaining
                    and b * max(int(seqlens[order[i + b - 1]]), 1) <= max_tokens]
        size = max(feasible, default=1)
        batches.append(order[i:i + size])
        i += size
    if drop_last:
        batches = [b for b in batches if len(b) in buckets]
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(batches)
    return batches


def lr_scale_for_batch(batch_size: int, base_batch_size: int,
                       method: str = "linear") -> float:
    """Batch-size → LR multiplier (reference ``scale_lr``): linear scaling
    rule, or sqrt for adaptive optimizers."""
    ratio = batch_size / max(base_batch_size, 1)
    if method == "linear":
        return ratio
    if method == "sqrt":
        return float(np.sqrt(ratio))
    raise ValueError(f"unknown lr scaling method '{method}'")


class VariableBatchLRSchedule:
    """Wrap an LR schedule so each step's LR is scaled by its batch ratio.

    Callable as ``schedule(step)`` — the engine's schedule_fn contract — with
    ``set_batch_size`` called by the data loop before each step (the reference
    wires this through its dataloader+lr_scheduler pair)."""

    def __init__(self, inner: Callable, base_batch_size: int,
                 method: str = "linear"):
        self.inner = inner
        self.base = int(base_batch_size)
        self.method = method
        self._scale = 1.0

    def set_batch_size(self, batch_size: int) -> None:
        self._scale = lr_scale_for_batch(batch_size, self.base, self.method)

    def __call__(self, step):
        base = self.inner(step) if callable(self.inner) else self.inner
        return base * self._scale


class VariableBatchDataLoader:
    """Iterate a dataset in token-budget batches, reporting the LR scale.

    Yields ``(batch_dict, lr_scale)``; pair with :class:`VariableBatchLRSchedule`
    (call ``schedule.set_batch_size(len(batch))`` or use the yielded scale)."""

    def __init__(self, dataset, seqlens: Sequence[int], max_tokens: int,
                 collate_fn: Optional[Callable] = None,
                 base_batch_size: Optional[int] = None,
                 bucket_batch_sizes: Optional[Sequence[int]] = None,
                 lr_method: str = "linear", seed: int = 42,
                 drop_last: bool = True):
        from deepspeed_tpu_torch.runtime.dataloader import default_collate

        self.dataset = dataset
        self.batches = batch_by_tokens(seqlens, max_tokens,
                                       bucket_batch_sizes=bucket_batch_sizes,
                                       shuffle_seed=seed, drop_last=drop_last)
        self.collate = collate_fn or default_collate
        sizes = [len(b) for b in self.batches]
        self.base = base_batch_size or int(np.median(sizes))
        self.lr_method = lr_method

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for idx in self.batches:
            batch = self.collate([self.dataset[int(i)] for i in idx])
            yield batch, lr_scale_for_batch(len(idx), self.base, self.lr_method)
