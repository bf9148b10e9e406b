"""Configuration of the training path (counterpart of
``deepspeed_tpu/config``)."""

from deepspeed_tpu_torch.config.config import (  # noqa: F401
    DeepSpeedTpuConfig, from_config)
