"""Fused dequantize-matmul, W8A16 / W4A16 (counterpart of
``deepspeed_tpu/ops/quant_matmul.py``).

Weight layout (``quantize_matmul_weight``): the contraction dim D is split
into groups of ``group`` rows sharing one scale per output column (scales
``[D/group, F]``). int8 weights are ``[D, F]``; int4 packs two rows per byte,
de-interleaved WITHIN each group: byte row ``r`` of group ``g`` holds row
``g*group + r`` in its low nibble and row ``g*group + r + group/2`` in its
high nibble (``[D/2, F]``). This is not the KV pool's int4 layout (global
lane pairing, ``ops/paged_attention.py``).

Kernels (launched only for CUDA tensors; CPU tensors take
:func:`plain_quantized_matmul`):

* G ``quantized_matmul(x, packed, scales, bits)`` -- one weight matrix;
* H ``quantized_matmul(..., layer=i)`` -- ``packed``/``scales`` are the whole
  ``[L, ...]`` stacks and the kernel reads layer ``i`` in place (no per-layer
  copy).

Shape rule (the reference's, by shape only, never on failure): the kernel
runs for ``B <= 256`` rows with ``D``, ``F`` and ``group`` all multiples of
128. Anything else computes ``x @ dequantize_matmul_weight(...)`` with
``torch.matmul``, as the reference leaves it to XLA. The reference's TPU-only
VMEM budget clause has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import cuda_operand, on_cpu, stream_ptr
from deepspeed_tpu_torch.ops._build import KERNELS

MAX_ROWS = 256          # widest activation batch the kernels take
# csrc/quant_matmul.cu's tiles: B <= 16 rows take qmm_rows_kernel (_RN
# columns a CTA, its contraction split over _RWARPS warps of whole groups),
# more take qmm_tile_kernel (_TM rows x _TN columns)
_RN = 128
_RWARPS = 4
_TM = _TN = 128
_SMS = 132              # H100 SXM streaming multiprocessors
_ROW_CTAS_PER_SM = 2    # qmm_rows_kernel's CTAs an SM (its shared memory)


def quantize_matmul_weight(w: torch.Tensor, bits: int = 4, group: int = 128
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``w`` [D, F] -> (packed int8 [D/2, F] (int4) or [D, F] (int8), scales
    fp32 [D/group, F]), bit-identical to the reference as its engine runs it
    (under ``jax.jit``) for the same fp32 input: scale = amax times the fp32
    reciprocal of qmax (XLA compiles the reference's ``amax / qmax`` so),
    floor 1e-12; values rounded half-to-even and clipped to
    ``[-qmax-1, qmax]``."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    D, F = w.shape
    if D % group:
        raise ValueError(f"D={D} must divide by group={group}")
    wf = w.float().contiguous().reshape(D // group, group, F)  # w may be a .T
    qmax = 7 if bits == 4 else 127
    scale = torch.clamp_min(wf.abs().amax(dim=1) * (1.0 / qmax), 1e-12)
    q = torch.clamp(torch.round(wf / scale[:, None]), -qmax - 1, qmax)
    q = q.to(torch.int32)
    if bits == 8:
        return q.to(torch.int8).reshape(D, F), scale
    h = group // 2
    packed = (q[:, :h] & 0x0F) | ((q[:, h:] & 0x0F) << 4)
    return packed.to(torch.int8).reshape(D // 2, F), scale


def _unpack_weight(packed: torch.Tensor, bits: int, G: int, group: int
                   ) -> torch.Tensor:
    """Packed weights -> exact int values [G, group, F] (int32)."""
    F = packed.shape[-1]
    if bits == 8:
        return packed.reshape(G, group, F).to(torch.int32)
    b = packed.reshape(G, group // 2, F).to(torch.int32)       # sign-extended
    lo = (b << 28) >> 28
    hi = b >> 4
    return torch.cat([lo, hi], dim=1)


def dequantize_matmul_weight(packed: torch.Tensor, scales: torch.Tensor,
                             bits: int, D: int) -> torch.Tensor:
    """The kernel's layout back to a dense bf16 [D, F] (the reference's
    oracle and the off-shape fallback's weight): ``q * scale`` in fp32,
    rounded to bf16."""
    G, F = scales.shape
    q = _unpack_weight(packed, bits, G, D // G).float()
    return (q * scales.float()[:, None]).reshape(D, F).to(torch.bfloat16)


def _layer_of(packed, scales, layer):
    return (packed, scales) if layer is None else (packed[layer],
                                                   scales[layer])


def plain_quantized_matmul(x: torch.Tensor, packed: torch.Tensor,
                           scales: torch.Tensor, bits: int,
                           layer: Optional[int] = None) -> torch.Tensor:
    """Plain version of kernels G/H (the reference's ``_qmm_body`` :59): per
    group an fp32 dot of ``x`` with the exact integer weights, times the
    group's fp32-upcast column scales, summed over groups. ``x`` [B, D];
    returns [B, F] in ``x``'s dtype."""
    packed, scales = _layer_of(packed, scales, layer)
    B, D = x.shape
    G, F = scales.shape
    q = _unpack_weight(packed, bits, G, D // G).float()      # [G, group, F]
    y = torch.einsum("bgk,gkf->gbf", x.float().reshape(B, G, D // G), q)
    return (y * scales.float()[:, None, :]).sum(dim=0).to(x.dtype)


def uses_kernel(x: torch.Tensor, scales: torch.Tensor) -> bool:
    """The shape rule: whether G/H (or, on the CPU, their plain version)
    computes this product rather than ``x @ dequantize(...)``."""
    B, D = x.shape
    G, F = scales.shape[-2:]
    return (B <= MAX_ROWS and D % 128 == 0 and F % 128 == 0
            and D % G == 0 and (D // G) % 128 == 0)


def qmm_splits(B: int, F: int, G: int) -> int:
    """Contraction splits so a narrow product still fills the card (each
    split sums a range of groups). At B <= 16 the kernel's last CTA of each
    column tile adds the splits: the most splits that keep the grid within
    one wave of ``_ROW_CTAS_PER_SM`` CTAs an SM while every split's groups
    share evenly over the CTA's ``_RWARPS`` warps, which take whole groups
    (``tools/qmm_sweep.py`` on the card: more CTAs, or warps given unequal
    runs, were slower). Above 16 rows a second pass adds them, and one
    256-thread CTA holds an SM and each does the same work, so the most
    splits that keep the grid within one wave: more would only add waves
    and partial-sum traffic."""
    if B <= 16:
        tiles = F // _RN
        for per in range(_RWARPS, G, _RWARPS):
            splits = -(-G // per)     # the kernel's per is ceil(G / splits)
            if (-(-G // splits) == per
                    and tiles * splits <= _ROW_CTAS_PER_SM * _SMS):
                return splits
        return 1
    want = _SMS // ((F // _TN) * -(-B // _TM))
    per = -(-G // min(G, max(1, want)))
    return -(-G // per)


def qmm_kernel_args(x, packed, scales, bits: int, layer: Optional[int] = None):
    """Kernel G's (``layer`` None) or H's launcher arguments and the output
    ``(out,)``, allocated here (with the split workspace)."""
    B, D = x.shape
    G, F = scales.shape[-2:]
    rows = D // 2 if bits == 4 else D
    if packed.shape[-2:] != (rows, F):
        raise ValueError(f"packed {tuple(packed.shape)} does not match "
                         f"int{bits} weights [{rows}, {F}]")
    cuda_operand(x, "x", torch.bfloat16)
    cuda_operand(packed, "packed", torch.int8)
    cuda_operand(scales, "scales", torch.bfloat16)
    if any(t.data_ptr() % 16 for t in (x, packed, scales)):
        raise ValueError("x, packed and scales must start on 16 bytes (the "
                         "kernels load 16-byte vectors)")
    splits = qmm_splits(B, F, G)
    out = torch.empty(B, F, dtype=torch.bfloat16, device=x.device)
    work = (torch.empty(splits, B, F, dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    args = (x, packed, scales, out, work, B, D, F, G, int(bits), splits)
    if layer is not None:
        L = scales.shape[0]
        if not 0 <= int(layer) < L:
            raise IndexError(f"layer {layer} outside a stack of {L}")
        args += (int(layer),)
    return args + (stream_ptr(x),), (out,)


def quantized_matmul(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, bits: int = 4,
                     layer: Optional[int] = None) -> torch.Tensor:
    """``x`` [B, D] @ dequant(packed, scales) -> [B, F] in ``x``'s dtype.
    With ``layer``, ``packed``/``scales`` are the [L, ...] stacks (kernel H);
    without, one matrix (kernel G). Off the shape rule (module docstring):
    ``x @ dequantize_matmul_weight(...)``."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if not uses_kernel(x, scales):
        p, s = _layer_of(packed, scales, layer)
        return x @ dequantize_matmul_weight(p, s, bits, x.shape[1]).to(x.dtype)
    if on_cpu(x, packed, scales):
        return plain_quantized_matmul(x, packed, scales, bits, layer)
    args, (out,) = qmm_kernel_args(x, packed, scales, bits, layer)
    KERNELS["qmm" if layer is None else "qmm_stacked"].launch(*args)
    return out

