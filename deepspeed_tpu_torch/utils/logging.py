"""Rank-aware logging utilities (counterpart of
``deepspeed_tpu/utils/logging.py``).

Parity target: ``deepspeed/utils/logging.py`` (``log_dist``, ``logger``) — rank-filtered
logging so multi-process runs don't emit one line per process.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Iterable, Optional

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name: str = "deepspeed_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    log = logging.getLogger(name)
    log.setLevel(level)
    log.propagate = False
    if not log.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        log.addHandler(handler)
    return log


logger = _create_logger(
    level=LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info").lower(), logging.INFO)
)


def _process_index() -> int:
    """This process's rank in the ``torch.distributed`` process group, 0 when
    no group is up (one process)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given process ranks (default: rank 0 only).

    ``ranks=[-1]`` logs on every process.
    """
    ranks = list(ranks) if ranks is not None else [0]
    rank = _process_index()
    if -1 in ranks or rank in ranks:
        logger.log(level, f"[rank {rank}] {message}")


def warning_once(message: str, _seen=set()) -> None:  # noqa: B006 - intentional cache
    if message not in _seen:
        _seen.add(message)
        logger.warning(message)
