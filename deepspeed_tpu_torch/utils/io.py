"""Small durable-IO helpers shared by the checkpoint and resilience layers
(counterpart of ``deepspeed_tpu/utils/io.py``)."""

from __future__ import annotations

import os

__all__ = ["atomic_write_text"]


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically: unique tmp + fsync +
    ``os.replace``. Readers see either the previous content or the new one —
    never a torn/empty file — and concurrent writers cannot collide on the
    tmp name."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
