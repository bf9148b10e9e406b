"""Attention ops of the serving path, each a hand-written Hopper kernel with a
plain PyTorch version beside it (counterpart of ``deepspeed_tpu/ops``).

Dispatch is by the tensors' device: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise. There is no fallback from a CUDA tensor
to the plain version.
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.ops._build import KERNELS, reset_counts  # noqa: F401


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version's domain);
    False when every one lies on a CUDA device (the kernel's). Anything else
    raises: a mixed call is a caller bug, never silently moved."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, got "
                     f"{sorted(kinds)}")


def cuda_operand(t: torch.Tensor, name: str, dtype: torch.dtype
                 ) -> torch.Tensor:
    """Validate a kernel operand: dtype must match, layout must be
    contiguous (the kernels compute their own offsets)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: kernel takes {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
    return t


def int32_meta(t: torch.Tensor) -> torch.Tensor:
    """Small per-atom metadata as contiguous int32 on its device."""
    return t.to(torch.int32).contiguous()


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
