"""Sequence-parallel data loader adapter (counterpart of
``deepspeed_tpu/runtime/data_pipeline/sp_dataloader.py``): each batch is
sliced along the sequence dimension so sp rank ``r`` of ``sp`` holds its
``T/sp`` tokens. Slicing only: it needs no process group.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np


class SPDataLoaderAdapter:
    def __init__(self, loader, sp_world_size: int, sp_rank: int = 0,
                 seq_keys=("input_ids", "labels", "attention_mask", "position_ids")):
        self.loader = loader
        self.sp = int(sp_world_size)
        self.rank = int(sp_rank)
        self.seq_keys = set(seq_keys)

    def __len__(self):
        return len(self.loader)

    def _shard(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for k, v in batch.items():
            arr = np.asarray(v)
            if k in self.seq_keys and arr.ndim >= 2 and arr.shape[1] % self.sp == 0:
                chunk = arr.shape[1] // self.sp
                out[k] = arr[:, self.rank * chunk:(self.rank + 1) * chunk]
            else:
                out[k] = arr
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for batch in self.loader:
            yield self._shard(batch)
