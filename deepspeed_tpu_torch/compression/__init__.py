"""Compression (counterpart of ``deepspeed_tpu/compression``): so far the
straight-through fake quantizer that ``act_quant_bits`` uses; the other
transforms belong to ROADMAP section 1, "Remainder"."""

from deepspeed_tpu_torch.compression.compress import ste_quantize  # noqa: F401
