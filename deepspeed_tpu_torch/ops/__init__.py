"""Ops of the ported paths, each a hand-written Hopper kernel with a plain
PyTorch version beside it (counterpart of ``deepspeed_tpu/ops``), and the
op-builder registry (``OpBuilder``, ``ALL_OPS``, ``get_op_builder``,
``op_report``: the reference's ``ds_report`` / ``OpBuilder.load()``
surface).

Dispatch is by the tensors' device: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise. There is no fallback from a CUDA tensor
to the plain version.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Type

import torch

from deepspeed_tpu_torch.ops._build import KERNELS, reset_counts  # noqa: F401


# Head dims the card's attention kernels (A, B, C, D, E, F, I) are built
# for. Their wrappers refuse any other before a launch: there is no
# fallback to the plain version on a CUDA tensor.
CARD_HEAD_DIMS = (64, 96, 128, 256)


def card_head_dim(d: int, kernel: str) -> int:
    """``d`` when the card's attention kernels are built for it; else a
    ``ValueError`` naming :data:`CARD_HEAD_DIMS`."""
    if d not in CARD_HEAD_DIMS:
        raise ValueError(f"{kernel}: the card's attention kernels take "
                         f"head_dim in {CARD_HEAD_DIMS}, got {d}")
    return d


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


# ---------------------------------------------------------------------------
# op-builder registry (the reference's :18-85)
# ---------------------------------------------------------------------------

class OpBuilder:
    """Discovery/compatibility shim (the reference's ``OpBuilder``): a
    ported op's ``load()`` returns its function, whose kernels are built at
    their first CUDA launch (``ops/_build.py``)."""

    NAME = "base"

    def is_compatible(self, verbose: bool = False) -> bool:
        return True

    def load(self) -> Callable:
        raise NotImplementedError


class FlashAttentionBuilder(OpBuilder):
    NAME = "flash_attn"

    def load(self):
        from deepspeed_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention


class RMSNormBuilder(OpBuilder):
    NAME = "rms_norm"

    def load(self):
        from deepspeed_tpu_torch.ops.rms_norm import fused_rms_norm

        return fused_rms_norm


class _Unported(OpBuilder):
    """An op of the reference the port does not have yet: listed under its
    reference name, not compatible, and ``load()`` names the ROADMAP item
    that ports it."""

    ROADMAP = ""

    def is_compatible(self, verbose: bool = False) -> bool:
        return False

    def load(self):
        raise NotImplementedError(
            f"op {self.NAME!r} is not ported yet (ROADMAP section 1, "
            f"{self.ROADMAP})")


class QuantizerBuilder(_Unported):
    NAME = "quantizer"
    ROADMAP = "item 10: the non-Pallas ops, ops/quantization.py"


class RingAttentionBuilder(_Unported):
    NAME = "ring_attention"
    ROADMAP = "item 9: long context, ops/ring_attention.py"


ALL_OPS: Dict[str, Type[OpBuilder]] = {
    b.NAME: b for b in (FlashAttentionBuilder, RMSNormBuilder,
                        QuantizerBuilder, RingAttentionBuilder)
}


def get_op_builder(name: str) -> OpBuilder:
    return ALL_OPS[name]()


def op_report() -> List[tuple]:
    """``ds_report``'s op table: ``[(name, compatible)]``."""
    return [(name, cls().is_compatible()) for name, cls in ALL_OPS.items()]
