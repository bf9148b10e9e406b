"""Configuration of the training path and of the serving engine's features
(counterpart of ``deepspeed_tpu/config``)."""

from deepspeed_tpu_torch.config.config import (  # noqa: F401
    DeepSpeedTpuConfig, FleetConfig, FrontendConfig, KVTierConfig,
    MigrationConfig, MoEConfig, ObservabilityConfig, PrefixCacheConfig,
    ProfileTriggerConfig, RouterConfig, ServingConfig, SLOConfig,
    SpeculativeConfig, TracingConfig, from_config)
