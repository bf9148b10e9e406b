"""Memory-mapped indexed dataset (counterpart of
``deepspeed_tpu/runtime/data_pipeline/indexed_dataset.py``), in the
reference's on-disk format byte for byte, so either package reads the
other's files: ``<name>.bin`` is the concatenated token payload;
``<name>.idx`` is the magic ``DSTPUIDX``, a ``<BQ`` dtype code and item
count, then the int64 sizes and the int64 offsets.
"""

from __future__ import annotations

import os
import struct
from typing import List, Sequence

import numpy as np

_MAGIC = b"DSTPUIDX"
_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64,
           6: np.float32, 7: np.float64, 8: np.uint16, 9: np.uint32}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class MMapIndexedDatasetBuilder:
    def __init__(self, path_prefix: str, dtype=np.int32):
        self.prefix = path_prefix
        self.dtype = np.dtype(dtype)
        self._bin = open(path_prefix + ".bin", "wb")
        self._sizes: List[int] = []

    def add_item(self, tokens: Sequence[int]) -> None:
        arr = np.asarray(tokens, dtype=self.dtype)
        self._bin.write(arr.tobytes(order="C"))
        self._sizes.append(arr.size)

    def finalize(self) -> None:
        self._bin.close()
        with open(self.prefix + ".idx", "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<BQ", _DTYPE_CODES[self.dtype], len(self._sizes)))
            sizes = np.asarray(self._sizes, np.int64)
            offsets = np.concatenate([[0], np.cumsum(sizes)])
            f.write(sizes.tobytes())
            f.write(offsets.tobytes())


class MMapIndexedDataset:
    """Zero-copy random access to a .bin/.idx pair."""

    def __init__(self, path_prefix: str):
        with open(path_prefix + ".idx", "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{path_prefix}.idx: bad magic {magic!r}")
            code, count = struct.unpack("<BQ", f.read(9))
            self.dtype = np.dtype(_DTYPES[code])
            self._sizes = np.frombuffer(f.read(8 * count), np.int64)
            self._offsets = np.frombuffer(f.read(8 * (count + 1)), np.int64)
        self._data = np.memmap(path_prefix + ".bin", dtype=self.dtype, mode="r")

    def __len__(self) -> int:
        return len(self._sizes)

    def __getitem__(self, i: int) -> np.ndarray:
        start, end = self._offsets[i], self._offsets[i + 1]
        return np.asarray(self._data[start:end])

    @property
    def sizes(self) -> np.ndarray:
        return self._sizes
