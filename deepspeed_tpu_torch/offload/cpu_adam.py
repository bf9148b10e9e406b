"""Host Adam over the native C++ loop (counterpart of
``deepspeed_tpu/offload/cpu_adam.py``).

fp32 master weights and moments live in host RAM and are updated by the
vectorised OpenMP loop of the repo's ``csrc/cpu_adam.cpp`` (built by the
``cpu_adam`` op builder; a failed build raises). ``ctypes`` releases the
GIL for the call, so a worker thread can run it beside the caller.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch


def _ptr(a) -> ctypes.c_void_p:
    """The data pointer of a contiguous fp32 CPU tensor or numpy array."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu" or a.dtype != torch.float32 \
                or not a.is_contiguous():
            raise ValueError(f"host Adam takes contiguous fp32 CPU tensors, "
                             f"got {a.dtype} on {a.device}")
        return ctypes.c_void_p(a.data_ptr())
    if a.dtype != np.float32 or not a.flags["C_CONTIGUOUS"]:
        raise ValueError(f"host Adam takes contiguous fp32 arrays, got "
                         f"{a.dtype}")
    return ctypes.c_void_p(a.ctypes.data)


def _numel(a) -> int:
    return a.numel() if isinstance(a, torch.Tensor) else a.size


class DeepSpeedCPUAdam:
    """Adam/AdamW over flat host fp32 buffers (one instance per engine)."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True):
        from deepspeed_tpu_torch.ops import get_op_builder

        self.lib = get_op_builder("cpu_adam").load()
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.step_count = 0

    def step(self, params, grads, exp_avg, exp_avg_sq,
             lr: Optional[float] = None, increment: bool = True) -> None:
        """In-place fused update of one flat fp32 shard: ``params``,
        ``exp_avg`` and ``exp_avg_sq`` are written, ``grads`` read (each a
        contiguous fp32 CPU tensor or numpy array of the same size)."""
        n = _numel(params)
        if any(_numel(a) != n for a in (grads, exp_avg, exp_avg_sq)):
            raise ValueError("host Adam: params, grads and moments differ "
                             "in size")
        if increment:
            self.step_count += 1
        self.lib.ds_adam_step(
            _ptr(params), _ptr(grads), _ptr(exp_avg), _ptr(exp_avg_sq), n,
            self.lr if lr is None else lr, self.betas[0], self.betas[1],
            self.eps, self.weight_decay, 1 if self.adamw_mode else 0,
            self.step_count)


def adam_step_plain(params: torch.Tensor, grads: torch.Tensor,
                    exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
                    step: int, lr: float, betas=(0.9, 0.999),
                    eps: float = 1e-8, weight_decay: float = 0.0,
                    adamw_mode: bool = True) -> None:
    """The plain PyTorch twin of :meth:`DeepSpeedCPUAdam.step` (fp32
    tensors, in place): the same update in the loop's order of operations,
    with step ``step`` (1-based)."""
    b1, b2 = betas
    g = grads if adamw_mode or not weight_decay else \
        grads + weight_decay * params
    exp_avg.mul_(b1).add_(g * (1.0 - b1))
    exp_avg_sq.mul_(b2).add_(g * g * (1.0 - b2))
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    denom = exp_avg_sq.sqrt() / bc2 ** 0.5 + eps
    upd = (lr / bc1) * (exp_avg / denom)
    if adamw_mode:
        upd = upd + lr * weight_decay * params
    params.sub_(upd)
