"""Blockwise symmetric int8 / int4 quantization (counterpart of
``deepspeed_tpu/ops/quantization.py``, its two blockwise functions).

A tensor is flattened and cut into groups of ``group_size`` values, halved
until it divides the size (so a group may span rows). Each group's scale
is its absmax times the fp32 reciprocal of ``qmax`` (127 or 7), floored at
1e-12: what XLA compiles the reference's ``absmax / qmax`` to under
``jax.jit``, so the payloads and scales equal the reference's bit for bit.
int4 packs two neighbouring values a byte (the first in the low nibble).

The reference's fp8 / fp6 quantizers belong to ROADMAP section 1,
"Remainder"; its quantized collectives to "Mesh, ZeRO and tensor
parallelism".
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def quantize_blockwise(x: torch.Tensor, bits: int = 8,
                       group_size: int = 2048
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` -> (int8 payload [groups, group] (int4: [groups, group / 2]),
    fp32 scales [groups])."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    flat = x.reshape(-1)
    n = flat.shape[0]
    gs = min(group_size, n)
    while n % gs:
        gs //= 2
    groups = flat.reshape(n // gs, gs).float()
    qmax = _qmax(bits)
    scale = torch.clamp_min(groups.abs().amax(dim=1, keepdim=True)
                            * (1.0 / qmax), 1e-12)
    q = torch.clamp(torch.round(groups / scale), -qmax - 1, qmax)
    if bits == 4:
        q = q.to(torch.int32).reshape(n // gs, gs // 2, 2)
        packed = (q[..., 0] & 0x0F) | ((q[..., 1] & 0x0F) << 4)
        return packed.to(torch.int8), scale[:, 0]
    return q.to(torch.int8), scale[:, 0]


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         bits: int = 8,
                         shape: Optional[Tuple[int, ...]] = None,
                         dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """:func:`quantize_blockwise`'s payload back to values: ``q * scale``
    in fp32, reshaped to ``shape`` (default flat), cast to ``dtype``."""
    if bits == 4:
        b = q.to(torch.int32)                     # sign-extended bytes
        lo = (b << 28) >> 28                      # the low nibble, signed
        hi = b >> 4
        vals = torch.stack([lo, hi], dim=-1).reshape(q.shape[0], -1)
    else:
        vals = q
    out = (vals.float() * scale[:, None]).reshape(-1)
    if shape is not None:
        out = out.reshape(shape)
    return out.to(dtype)
