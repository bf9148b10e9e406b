"""Causal GQA flash attention forward (counterpart of
``deepspeed_tpu/ops/flash_attention.py``; forward only -- the backward kernels
come with the training path).

``flash_attention`` / ``flash_attention_lse`` take the model layout
``q [B, T, H, d]``, ``k/v [B, S, K, d]`` (query head ``h`` reads kv head
``h // (H/K)``). On CUDA tensors they launch kernel D
(``csrc/flash_attention.cu``, replacing the TPU ``_fwd_kernel``); on CPU
tensors they run :func:`plain_flash_forward`, the same math in fp32.

Masking is start-aligned like the TPU kernel: query row ``t`` sits at
position ``t + rel_offset`` against key column ``c``; causal keeps
``t + rel_offset >= c``, a window keeps ``t + rel_offset - c <= window - 1``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import (cuda_operand, on_cpu, stream_ptr)
from deepspeed_tpu_torch.ops._build import KERNELS

NEG_INF = -1e30


def plain_flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        rel_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel D: ``(out [B,T,H,d] in q's dtype, lse [B,H,T]
    fp32)``. Scores, softmax and the PV product in fp32; masked columns get
    p = 0 (a fully masked row returns zeros and lse = -1e30 + log(1e-30))."""
    B, T, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    rep = H // K
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * (1.0 / math.sqrt(d))
    qpos = torch.arange(T, device=q.device)[:, None] + rel_offset
    col = torch.arange(S, device=q.device)[None, :]
    keep = torch.ones(T, S, dtype=torch.bool, device=q.device)
    if causal:
        keep &= qpos >= col
    if window is not None:
        keep &= qpos - col <= window - 1
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
    denom = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bhts,bshd->bthd", p, vf) / denom.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(denom)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        rel_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B,T,H,d], lse [B,H,T])``: kernel D on CUDA bf16 tensors,
    :func:`plain_flash_forward` on CPU ones. ``rel_offset`` (static) shifts
    every query row's position against key 0 (the chunk-pair masking of the
    FPDT merge). The TPU version returns lse as ``[B,H,T,1]``; here the
    trailing unit axis is dropped."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if on_cpu(q, k, v):
        return plain_flash_forward(q, k, v, causal=causal, window=window,
                                   rel_offset=rel_offset)
    args, out = flash_kernel_args(q, k, v, causal=causal, window=window,
                                  rel_offset=rel_offset)
    KERNELS["flash_fwd"].launch(*args)
    return out


def flash_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      rel_offset: int = 0):
    """Kernel D's launcher arguments and its outputs ``(out, lse)``,
    allocated here (CUDA bf16 tensors)."""
    B, T, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != (B, S, K, d) or v.shape != k.shape or H % K:
        raise ValueError(f"flash_attention_lse: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        cuda_operand(t, n, torch.bfloat16)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    args = (q, k, v, out, lse, B, T, S, H, K, d, int(causal),
            int(window or 0), int(rel_offset), 1.0 / math.sqrt(d),
            stream_ptr(q))
    return args, (out, lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """Flash attention over model-layout tensors; returns ``out``."""
    if window is not None:
        if not causal:
            raise ValueError("sliding window implies causal attention")
        if q.shape[1] != k.shape[1]:
            raise ValueError(
                f"windowed flash attention requires T == S (got "
                f"T={q.shape[1]}, S={k.shape[1]})")
    return flash_attention_lse(q, k, v, causal=causal, window=window)[0]
