"""Small helpers shared across the port (counterpart of
``deepspeed_tpu/utils``): device resolution, rank-aware logging and the
wall-clock / throughput timers."""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.utils.logging import log_dist, logger  # noqa: F401
from deepspeed_tpu_torch.utils.timer import (  # noqa: F401
    SynchronizedWallClockTimer, ThroughputTimer)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a machine without
    one raises instead of quietly running on the CPU (the CPU is only ever
    used when a caller asks for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' explicitly to run "
            "the plain PyTorch versions on the CPU")
    return dev
