"""Engine sanity checks (counterpart of ``deepspeed_tpu/runtime/sanity.py``;
reference DeepSpeed: the ``sanity_checks`` config consumed at
``engine.py:1346``, the cross-rank asserts ``assert_ints_same_as_other_ranks``
and the dataloader same-across-ranks check at ``engine.py:641``).

* the config digest is identical on every process (trivially so on one);
* the parameter tree is finite;
* every parameter sits on ``engine.device`` (where the reference compares
  each leaf's sharding with the engine's declared one);
* the first training batch agrees across processes (replicated-loader
  deployments; per-host-sharded loaders opt out with
  ``sanity_check_batches: false``).

Enabled by the top-level ``sanity_checks`` config flag; each check is also
callable directly. One process has nothing to compare its digests with;
under a process group of more than one rank the comparisons raise (the
port's process groups are not built yet).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

import numpy as np
import torch

from deepspeed_tpu_torch.models.spec import tree_leaves
from deepspeed_tpu_torch.runtime.checkpoint import flatten_tree
from deepspeed_tpu_torch.utils.logging import log_dist

__all__ = ["check_config_consistency", "check_param_integrity",
           "check_param_placement", "check_batch_consistency",
           "run_startup_checks"]


def _digest64(payload: bytes) -> int:
    return int.from_bytes(hashlib.sha256(payload).digest()[:8], "big",
                          signed=False) >> 1  # fits int64


def _assert_same_across_processes(value: int, what: str) -> None:
    """One process holds the only copy: nothing to compare. Processes of a
    group would gather their digests here; the port has no process group
    yet and says so rather than passing unchecked."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f"comparing the {what} across processes needs the port's "
            'process groups (ROADMAP section 1, "Mesh, ZeRO and tensor '
            'parallelism")')


def check_config_consistency(engine) -> None:
    """Every process must run the SAME resolved config."""
    payload = json.dumps(dataclasses.asdict(engine.config), sort_keys=True,
                         default=str).encode()
    _assert_same_across_processes(_digest64(payload), "config digest")


def check_param_integrity(engine) -> None:
    """Raise on non-finite parameter leaves (a corrupted checkpoint or
    diverged restore trains NaN silently); integer leaves are skipped. One
    host fetch for the whole tree."""
    flat = flatten_tree(engine.params)
    floating = [(n, t) for n, t in flat.items() if t.is_floating_point()]
    if not floating:
        return
    with torch.no_grad():
        finite = torch.stack([torch.isfinite(t).all()
                              for _, t in floating]).cpu()
    bad = [n for (n, _), ok in zip(floating, finite.tolist()) if not ok]
    if bad:
        raise RuntimeError(f"non-finite parameters in {len(bad)} leaves "
                           f"(first 5): {bad[:5]}")


def check_param_placement(engine) -> None:
    """Every parameter must live on the engine's device (a leaf left on the
    host would silently run the step off the card)."""
    want = torch.device(engine.device)
    for name, t in flatten_tree(engine.params).items():
        got = t.device
        if got.type != want.type or (want.index is not None
                                     and got.index != want.index):
            raise RuntimeError(f"parameter {name} placed on {got} but the "
                               f"engine runs on {want}")


def check_batch_consistency(batch: Any) -> None:
    """First-batch agreement across processes (``engine.py:641`` broadcast
    check): with replicated loaders every process must feed identical
    data."""
    leaves = tree_leaves(batch) if isinstance(batch, dict) else (
        batch if isinstance(batch, (list, tuple)) else [batch])
    payload = b"".join(
        np.ascontiguousarray(x.detach().cpu().numpy()
                             if isinstance(x, torch.Tensor)
                             else np.asarray(x)).tobytes() for x in leaves)
    _assert_same_across_processes(_digest64(payload), "training batch digest")


def run_startup_checks(engine) -> None:
    """The engine-construction sanity pass (``sanity_checks: true``)."""
    check_config_consistency(engine)
    check_param_integrity(engine)
    check_param_placement(engine)
    log_dist("sanity checks passed: config digest, param integrity, "
             "param placement")
