"""Causal GQA flash attention, forward and backward (counterpart of
``deepspeed_tpu/ops/flash_attention.py``).

``flash_attention`` / ``flash_attention_lse`` take the model layout
``q [B, T, H, d]``, ``k/v [B, S, K, d]`` (query head ``h`` reads kv head
``h // (H/K)``) and are differentiable in both outputs through the op
``dstpu::flash_attn`` with its registered autograd (:func:`flash_op`, the
counterpart of the reference's ``custom_vjp``s ``_flash`` / ``_flash_lse``). On CUDA tensors the forward
launches kernel D (``csrc/flash_forward.cu``, replacing the TPU
``_fwd_kernel``) and the backward kernels E then F (``csrc/
flash_backward.cu``, replacing ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``);
on CPU tensors each runs its plain version, the same math in fp32.

Masking is start-aligned like the TPU kernel: query row ``t`` sits at
position ``t + rel_offset`` against key column ``c``; causal keeps
``t + rel_offset >= c``, a window keeps ``t + rel_offset - c <= window - 1``.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import (card_head_dim, cuda_operand, on_cpu,
                                     stream_ptr)
from deepspeed_tpu_torch.ops._build import KERNELS

NEG_INF = -1e30


def _keep(T: int, S: int, causal: bool, window: Optional[int],
          rel_offset: int, device) -> torch.Tensor:
    """[T, S] bool: which (query row, key column) pairs are visible."""
    qpos = torch.arange(T, device=device)[:, None] + rel_offset
    col = torch.arange(S, device=device)[None, :]
    keep = torch.ones(T, S, dtype=torch.bool, device=device)
    if causal:
        keep &= qpos >= col
    if window is not None:
        keep &= qpos - col <= window - 1
    return keep


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
    keep = _keep(T, S, causal, window, rel_offset, q.device)
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
    denom = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bhts,bshd->bthd", p, vf) / denom.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(denom)


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  rel_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel D's wrapper: ``(out [B,T,H,d], lse [B,H,T])``, kernel D on CUDA
    bf16 tensors, :func:`plain_flash_forward` on CPU ones. Not
    differentiable: :func:`flash_attention_lse` is."""
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
    card_head_dim(d, "kernel D")
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        cuda_operand(t, n, torch.bfloat16)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    args = (q, k, v, out, lse, B, T, S, H, K, d, int(causal),
            int(window or 0), int(rel_offset), 1.0 / math.sqrt(d),
            stream_ptr(q))
    return args, (out, lse)


# ---------------------------------------------------------------------------
# backward: delta, then kernel E (dq) and kernel F (dk, dv)
# ---------------------------------------------------------------------------

def flash_delta(out: torch.Tensor, do: torch.Tensor,
                dlse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``delta [B,H,T]`` fp32 = rowsum(dO * O) - dlse. The lse cotangent
    folds in here because d lse / d s = p, so the kernels' ds = p (dp -
    delta) needs no change (the reference's :257-261). A PyTorch reduction,
    as the reference leaves it to XLA outside the Pallas calls."""
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _plain_bwd_terms(q, k, v, do, lse, delta, causal, window, rel_offset):
    """fp32 ``(p, ds, q, k, do)`` of the backward over all heads, k
    repeated over each kv head's group; masked entries p = ds = 0 (a row
    that sees nothing has lse = s = -1e30, where exp(s - lse) would be 1)."""
    B, T, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    rep = H // K
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * (1.0 / math.sqrt(d))
    keep = _keep(T, S, causal, window, rel_offset, q.device)
    p = torch.where(keep, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - delta.float()[..., None])
    return p, ds, qf, kf, dof


def plain_flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, *, causal: bool = True,
                       window: Optional[int] = None, rel_offset: int = 0
                       ) -> torch.Tensor:
    """Plain version of kernel E: ``dq [B,T,H,d]`` in q's dtype."""
    _, ds, _, kf, _ = _plain_bwd_terms(q, k, v, do, lse, delta, causal,
                                       window, rel_offset)
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * (1.0 / math.sqrt(q.shape[-1]))
    return dq.to(q.dtype)


def plain_flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, rel_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel F: ``(dk, dv) [B,S,K,d]`` in k's dtype, each
    summed over its kv head's group of query heads."""
    B, S, K, d = k.shape
    rep = q.shape[2] // K
    p, ds, qf, _, dof = _plain_bwd_terms(q, k, v, do, lse, delta, causal,
                                         window, rel_offset)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf) * (1.0 / math.sqrt(d))
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    return (dk.reshape(B, S, K, rep, d).sum(dim=3).to(k.dtype),
            dv.reshape(B, S, K, rep, d).sum(dim=3).to(v.dtype))


def plain_flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         do: torch.Tensor,
                         dlse: Optional[torch.Tensor] = None, *,
                         causal: bool = True, window: Optional[int] = None,
                         rel_offset: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the whole backward, ``(dq, dk, dv)``: delta, then
    the math of kernels E and F (``p = exp(s * scale - lse)``, ``ds = p (dp
    - delta)``, the GQA sum over each kv head's group)."""
    delta = flash_delta(out, do, dlse)
    kw = dict(causal=causal, window=window, rel_offset=rel_offset)
    dq = plain_flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq,) + plain_flash_bwd_dkv(q, k, v, do, lse, delta, **kw)


def flash_bwd_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor, lse: torch.Tensor,
                          delta: torch.Tensor, *, part: str,
                          causal: bool = True, window: Optional[int] = None,
                          rel_offset: int = 0):
    """Launcher arguments and outputs of kernel E (``part="dq"``: ``dq``)
    or kernel F (``part="dkv"``: ``(dk, dv)``), allocated here (CUDA bf16
    q/k/v/dO, fp32 lse/delta [B,H,T]; d in ``CARD_HEAD_DIMS``)."""
    B, T, H, d = q.shape
    S, K = k.shape[1], k.shape[2]
    if (k.shape != (B, S, K, d) or v.shape != k.shape or do.shape != q.shape
            or lse.shape != (B, H, T) or delta.shape != lse.shape or H % K):
        raise ValueError(f"flash backward: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, dO "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)}, delta "
                         f"{tuple(delta.shape)}")
    card_head_dim(d, "kernel E" if part == "dq" else "kernel F")
    for t, n in ((q, "q"), (k, "k"), (v, "v"), (do, "dO")):
        cuda_operand(t, n, torch.bfloat16)
    for t, n in ((lse, "lse"), (delta, "delta")):
        cuda_operand(t, n, torch.float32)
    tail = (B, T, S, H, K, d, int(causal), int(window or 0), int(rel_offset),
            1.0 / math.sqrt(d), stream_ptr(q))
    if part == "dq":
        dq = torch.empty_like(q)
        return (q, k, v, do, lse, delta, dq) + tail, dq
    if part == "dkv":
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        return (q, k, v, do, lse, delta, dk, dv) + tail, (dk, dv)
    raise ValueError(f"part must be 'dq' or 'dkv', got {part!r}")


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                 causal: bool = True, window: Optional[int] = None,
                 rel_offset: int = 0) -> torch.Tensor:
    """Kernel E's wrapper: ``dq``; kernel E on CUDA tensors,
    :func:`plain_flash_bwd_dq` on CPU ones."""
    kw = dict(causal=causal, window=window, rel_offset=rel_offset)
    if on_cpu(q, k, v, do, lse, delta):
        return plain_flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    args, dq = flash_bwd_kernel_args(q, k, v, do, lse, delta, part="dq", **kw)
    KERNELS["flash_bwd_dq"].launch(*args)
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  rel_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel F's wrapper: ``(dk, dv)``; kernel F on CUDA tensors,
    :func:`plain_flash_bwd_dkv` on CPU ones."""
    kw = dict(causal=causal, window=window, rel_offset=rel_offset)
    if on_cpu(q, k, v, do, lse, delta):
        return plain_flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    args, dkv = flash_bwd_kernel_args(q, k, v, do, lse, delta, part="dkv",
                                      **kw)
    KERNELS["flash_bwd_dkv"].launch(*args)
    return dkv


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   dlse: Optional[torch.Tensor] = None, *,
                   causal: bool = True, window: Optional[int] = None,
                   rel_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's saved ``out`` and ``lse``: delta,
    then kernel E, then kernel F (their plain versions on CPU tensors) --
    the counterpart of ``_bwd_pallas``."""
    delta = flash_delta(out, do, dlse)
    kw = dict(causal=causal, window=window, rel_offset=rel_offset)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


_OPS: dict = {}
_OPS_LOCK = threading.Lock()


def flash_op():
    """The flash forward as a dispatcher op, ``dstpu::flash_attn(q, k, v,
    causal, window, rel_offset) -> (out, lse)``, with its autograd
    registered (backward: the op ``dstpu::flash_attn_bwd``, kernels E then
    F). Registered at first use. Being an op the dispatcher sees, it is the
    one a selective-checkpoint policy names to keep the attention output
    (the reference's ``checkpoint_name(out, "flash_attn_out")``;
    ``runtime/activation_checkpointing.py``). Kernel D on CUDA tensors,
    the plain versions on CPU tensors."""
    op = _OPS.get("fwd")
    if op is not None:
        return op
    with _OPS_LOCK:     # replicas on threads may reach here together
        if "fwd" not in _OPS:
            _OPS["fwd"] = _register_flash_op()
    return _OPS["fwd"]


def _register_flash_op():
    from torch.library import custom_op

    @custom_op("dstpu::flash_attn", mutates_args=())
    def fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], rel_offset: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        return flash_forward(q, k, v, causal=causal, window=window,
                             rel_offset=rel_offset)

    @custom_op("dstpu::flash_attn_bwd", mutates_args=())
    def bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
            dlse: Optional[torch.Tensor], causal: bool,
            window: Optional[int], rel_offset: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return flash_backward(q, k, v, out, lse, do, dlse, causal=causal,
                              window=window, rel_offset=rel_offset)

    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, rel_offset = inputs
        ctx.save_for_backward(q, k, v, *output)
        ctx.opts = (causal, window, rel_offset)

    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        do = torch.zeros_like(out) if do is None else do.contiguous()
        dq, dk, dv = bwd(q, k, v, out, lse, do, dlse, *ctx.opts)
        return dq, dk, dv, None, None, None

    fwd.register_autograd(backward, setup_context=setup_context)
    return fwd


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        rel_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B,T,H,d], lse [B,H,T])``, differentiable in both. ``rel_offset``
    (static) shifts every query row's position against key 0 (the
    chunk-pair masking of the FPDT merge). The TPU version returns lse as
    ``[B,H,T,1]``; here the trailing unit axis is dropped."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    on_cpu(q, k, v)         # a mixed call raises before the dispatcher
    return flash_op()(q, k, v, bool(causal), window, int(rel_offset))


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
