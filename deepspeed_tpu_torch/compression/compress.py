"""Quantization-aware fake quantization (counterpart of
``deepspeed_tpu/compression/compress.py``, its ``ste_quantize``: the
model's ``act_quant_bits`` reads it).

The rest of the reference's compression transforms (post-training weight
quantization, pruning, layer reduction) belong to ROADMAP section 1,
"Remainder".
"""

from __future__ import annotations

import torch

from deepspeed_tpu_torch.ops.quantization import (dequantize_blockwise,
                                                  quantize_blockwise)


class _STEQuantize(torch.autograd.Function):
    """The blockwise quantize-dequantize round trip forward; the gradient
    passes straight through to ``x``."""

    @staticmethod
    def forward(ctx, x, bits, group_size):
        q, s = quantize_blockwise(x, bits=bits, group_size=group_size)
        return dequantize_blockwise(q, s, bits=bits, shape=x.shape,
                                    dtype=x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def ste_quantize(x: torch.Tensor, bits: int = 8,
                 group_size: int = 2048) -> torch.Tensor:
    """``x`` fake-quantized to ``bits`` over groups of up to
    ``group_size`` of its flattened values (:mod:`~deepspeed_tpu_torch.ops.
    quantization`), with straight-through gradients (the reference's
    ``QuantAct`` / weight QAT)."""
    return _STEQuantize.apply(x, bits, group_size)
