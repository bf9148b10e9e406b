"""Sequence tiling for long-context training (counterpart of
``deepspeed_tpu/sequence``). Only ``tiling.py`` is ported; Ulysses, FPDT
and auto-SP wait for ROADMAP section 1, "Long context"."""

from deepspeed_tpu_torch.sequence.tiling import (  # noqa: F401
    TiledMLP, sequence_tiled_compute, tiled_logits_loss,
)
