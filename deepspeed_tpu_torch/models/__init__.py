"""Model family (counterpart of ``deepspeed_tpu/models``)."""

from deepspeed_tpu_torch.models.presets import PRESETS, get_preset  # noqa: F401
from deepspeed_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig, TransformerLM)
