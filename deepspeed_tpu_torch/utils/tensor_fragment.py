"""Safe access to full params, gradients and optimizer state (counterpart
of ``deepspeed_tpu/utils/tensor_fragment.py``).

Parity target: ``deepspeed/utils/tensor_fragment.py:19`` -- the public
``safe_get_full_fp32_param`` / ``safe_set_full_fp32_param`` /
``safe_get_full_grad`` / ``safe_get_full_optimizer_state`` API that hides
ZeRO partitioning from user code. On one device every leaf is whole: a read
is a host copy, a write copies into the engine's own tensor in place (the
optimizer keeps its references). Reads return numpy, as the reference's
do.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

PathLike = Union[str, Sequence[Any]]

__all__ = ["safe_get_full_fp32_param", "safe_set_full_fp32_param",
           "safe_get_full_grad", "safe_get_full_optimizer_state"]


def _resolve(tree: Any, path: PathLike) -> torch.Tensor:
    keys = path.split("/") if isinstance(path, str) else list(path)
    node = tree
    for k in keys:
        node = node[k]
    return node


def _index(engine, leaf: torch.Tensor) -> int:
    """The leaf's position in the engine's flat leaf list (the order of the
    optimizer's per-leaf state)."""
    for i, t in enumerate(engine._leaves):
        if t is leaf:
            return i
    raise KeyError("not a parameter leaf of this engine")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def safe_get_full_fp32_param(engine, path: PathLike) -> np.ndarray:
    """Full fp32 master value of one param."""
    return _host(_resolve(engine.params, path))


@torch.no_grad()
def safe_set_full_fp32_param(engine, path: PathLike, value) -> None:
    """Overwrite one param in place, keeping its dtype and device."""
    leaf = _resolve(engine.params, path)
    new = torch.as_tensor(np.asarray(value)).to(leaf.device, leaf.dtype)
    if new.shape != leaf.shape:
        raise ValueError(f"shape mismatch for {path}: {tuple(new.shape)} vs "
                         f"{tuple(leaf.shape)}")
    leaf.copy_(new)


def safe_get_full_grad(engine, path: PathLike) -> Optional[np.ndarray]:
    """Accumulated gradient for one param (None before any backward of
    the open accumulation window). Scaled by the fp16 loss scale, as the
    reference's accumulator is."""
    grad = _resolve(engine.params, path).grad
    return None if grad is None else _host(grad)


def safe_get_full_optimizer_state(engine, path: PathLike, state_key: str
                                  ) -> Optional[np.ndarray]:
    """One optimizer-state fragment (e.g. 'mu'/'nu' for adam) for one
    param; None when the optimizer keeps no such state."""
    per_leaf = engine.opt_state.get(state_key)
    if not isinstance(per_leaf, list) or not per_leaf:
        return None
    return _host(per_leaf[_index(engine, _resolve(engine.params, path))])
