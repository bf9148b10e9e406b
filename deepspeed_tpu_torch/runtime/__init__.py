"""The single-device training runtime (counterpart of
``deepspeed_tpu/runtime``): engine, optimizers, lr schedules, activation
checkpointing and the data loader."""
