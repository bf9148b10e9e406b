"""Fused RMS norm (counterpart of ``deepspeed_tpu/ops/rms_norm.py``).

``fused_rms_norm(x, weight, eps)`` normalises the last dim of ``x`` (any
leading shape): ``x * rsqrt(mean(x^2) + eps) * weight`` with fp32
statistics, cast to x's dtype. The forward is kernel J on CUDA tensors
(``csrc/rms_norm.cu``, x bf16 or fp32, weight bf16 or fp32) and
:func:`plain_rms_norm` on CPU ones; the backward is the reference's
closed form (:57-70) in plain torch, as the reference left it to XLA.
Its one user is the op-builder registry (``ops.RMSNormBuilder.load()``).
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.ops import cuda_operand, on_cpu, stream_ptr
from deepspeed_tpu_torch.ops._build import KERNELS

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def plain_rms_norm(x2d: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Plain version of kernel J on ``x2d`` [n, D]: the reference's
    ``_rms_kernel`` arithmetic, fp32 throughout, cast to x's dtype."""
    xf = x2d.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * weight.float()).to(x2d.dtype)


def rms_kernel_args(x2d: torch.Tensor, weight: torch.Tensor,
                    eps: float = 1e-5):
    """Kernel J's launcher arguments and its output ``(out,)``."""
    n, D = x2d.shape
    if x2d.dtype not in _KERNEL_DTYPES or weight.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel J takes bf16/fp32 x and weight, got "
                        f"{x2d.dtype} / {weight.dtype}")
    if D % 8:
        raise ValueError(f"kernel J takes rows of a multiple of 8 values, "
                         f"got D = {D}")
    if tuple(weight.shape) != (D,):
        raise ValueError(f"weight must be [{D}], got {tuple(weight.shape)}")
    cuda_operand(x2d, "x", x2d.dtype)
    cuda_operand(weight, "weight", weight.dtype)
    out = torch.empty_like(x2d)
    args = (x2d, weight, out, n, D, int(x2d.dtype == torch.float32),
            int(weight.dtype == torch.float32), float(eps), stream_ptr(x2d))
    return args, (out,)


def rms_norm_forward(x2d: torch.Tensor, weight: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """The forward on ``x2d`` [n, D]: kernel J on CUDA, the plain version
    on CPU."""
    if on_cpu(x2d, weight):
        return plain_rms_norm(x2d, weight, eps)
    args, (out,) = rms_kernel_args(x2d, weight, eps)
    KERNELS["rms_norm"].launch(*args)
    return out


def rms_norm_backward(x2d, weight, g, eps: float = 1e-5):
    """The reference's closed-form backward (:57-70), fp32: (dx in x's
    dtype, dweight in weight's dtype)."""
    xf, gf, wf = x2d.float(), g.float(), weight.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    dxhat = gf * wf
    dx = inv * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    dw = (gf * xhat).sum(dim=0)
    return dx.to(x2d.dtype), dw.to(weight.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, weight, eps):
        ctx.save_for_backward(x2d, weight)
        ctx.eps = eps
        return rms_norm_forward(x2d, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x2d, weight = ctx.saved_tensors
        dx, dw = rms_norm_backward(x2d, weight, g, ctx.eps)
        return dx, dw, None


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """RMS-normalise the last dim of ``x`` (any leading shape) scaled by
    ``weight`` [D]; differentiable in both."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).contiguous()
    return _RMSNorm.apply(x2d, weight.contiguous(), float(eps)).reshape(shape)
