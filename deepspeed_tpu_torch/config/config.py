"""Root configuration of the training path (counterpart of
``deepspeed_tpu/config/config.py``), in dataclasses.

The same JSON/dict config as the reference. Only the sections the
single-device training engine reads are ported: the batch triple,
``optimizer``, ``scheduler``, ``fp16`` / ``bf16``, ``gradient_clipping``,
``steps_per_print``, ``seed``, ``zero_optimization.stage`` (0-3 compute the
same thing on one device, as the reference does on a one-device mesh),
``mesh`` (every axis 1) and ``activation_checkpointing``. Keys are checked:
a misspelled key raises ``ValueError`` naming it, and a section or option of
the reference that this port does not implement raises
``NotImplementedError`` naming it -- nothing is silently ignored.
"""

from __future__ import annotations

import dataclasses
import difflib
import json
from typing import Any, Dict, Optional, Union

AUTO = "auto"
_SECTION = object()     # an unported key whose mere presence raises


def _unknown(path: str, key: str, known) -> ValueError:
    near = difflib.get_close_matches(key, list(known), n=1)
    hint = f" (did you mean {near[0]!r}?)" if near else ""
    return ValueError(f"{path}: unknown config key {key!r}{hint}")


def _check_type(path: str, default, value) -> None:
    """Light type checks against the field's default (pydantic's job in the
    reference): bools, ints, floats and strings must keep their kind."""
    ok = True
    if isinstance(default, bool):
        ok = isinstance(value, bool)
    elif isinstance(default, int):
        ok = isinstance(value, int) and not isinstance(value, bool)
    elif isinstance(default, float):
        ok = isinstance(value, (int, float)) and not isinstance(value, bool)
    elif isinstance(default, str):
        ok = isinstance(value, str)
    if not ok:
        raise ValueError(f"{path}: expected {type(default).__name__}, got "
                         f"{value!r}")


class _Section:
    """Base of the config sections: :meth:`build` checks every key."""

    #: nested sections: key -> class
    NESTED: Dict[str, type] = {}
    #: keys of the reference this port does not implement: key -> the
    #: reference's default (a value equal to it asks for nothing and passes;
    #: ``_SECTION`` raises on any value)
    UNPORTED: Dict[str, Any] = {}

    @classmethod
    def build(cls, values, path: str):
        if isinstance(values, cls):
            return values
        if not isinstance(values, dict):
            raise ValueError(f"{path}: expected an object, got {values!r}")
        fields = {f.name: f for f in dataclasses.fields(cls)
                  if not f.name.startswith("_")}
        kw = {}
        for key, val in values.items():
            where = f"{path}.{key}" if path else key
            if key in cls.UNPORTED:
                ref_default = cls.UNPORTED[key]
                if ref_default is _SECTION or val != ref_default:
                    raise NotImplementedError(
                        f"config {where!r} is not ported to the PyTorch "
                        "engine yet (single device, training slice)")
                continue
            if key not in fields:
                raise _unknown(path or "config", key,
                               list(fields) + list(cls.UNPORTED))
            sub = cls.NESTED.get(key)
            if sub is not None and val is not None:
                val = sub.build(val, where)
            elif fields[key].default not in (dataclasses.MISSING, None,
                                             AUTO):
                _check_type(where, fields[key].default, val)
            kw[key] = val
        obj = cls(**kw)
        obj._set = frozenset(kw)
        obj.validate(path)
        return obj

    def validate(self, path: str) -> None:
        pass


@dataclasses.dataclass
class OptimizerConfig(_Section):
    """``optimizer``: ``{"type": "AdamW", "params": {...}}``."""

    type: str = "adamw"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchedulerConfig(_Section):
    """``scheduler``, e.g. WarmupLR / WarmupDecayLR / WarmupCosineLR."""

    type: str = "WarmupLR"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FP16Config(_Section):
    """Dynamic loss scaling (``loss_scale`` 0 = dynamic). ``hysteresis`` is
    accepted and, as in the reference, not used by the scaler."""

    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0


@dataclasses.dataclass
class BF16Config(_Section):
    enabled: bool = True
    master_weights: bool = True
    immediate_grad_update: bool = True


@dataclasses.dataclass
class ZeroConfig(_Section):
    """``zero_optimization``: ``stage`` 0-3, which on one device all keep
    whole fp32 params, grads and optimizer state and compute the same step.
    The bucket and overlap knobs tune collectives that one device does not
    have; they are accepted."""

    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    sub_group_size: int = 1_000_000_000
    param_persistence_threshold: int = 100_000
    model_persistence_threshold: int = 9999999999
    max_live_parameters: int = 1_000_000_000
    prefetch_bucket_size: int = 50_000_000
    round_robin_gradients: bool = False
    zero_allow_untested_optimizer: bool = True
    ignore_unused_parameters: bool = True
    use_multi_rank_bucket_allreduce: bool = True

    UNPORTED = {"offload_optimizer": _SECTION, "offload_param": _SECTION,
                "zenflow": _SECTION, "zero_pp": _SECTION,
                "zero_quantized_weights": False,
                "zero_quantized_gradients": False,
                "zero_hpz_partition_size": 1, "mics_shard_size": -1,
                "mics_hierarchical_params_gather": False}

    def validate(self, path: str) -> None:
        if not 0 <= int(self.stage) <= 3:
            raise ValueError(f"zero stage must be 0..3, got {self.stage}")


@dataclasses.dataclass
class MeshConfig(_Section):
    """``mesh``: the port runs on one device, so every axis is 1 (``dp`` may
    stay "auto", which resolves to 1)."""

    auto: bool = False
    pp: int = 1
    dp: Union[int, str] = AUTO
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    num_slices: int = 1

    def validate(self, path: str) -> None:
        if self.auto:
            raise NotImplementedError("config 'mesh.auto' is not ported (one "
                                      "device)")
        for ax in ("pp", "dp", "fsdp", "ep", "sp", "tp", "num_slices"):
            v = getattr(self, ax)
            if ax == "dp" and v == AUTO:
                continue
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"mesh.{ax}: expected a positive int, got "
                                 f"{v!r}")
            if v > 1:
                raise NotImplementedError(
                    f"config 'mesh.{ax}' = {v}: the PyTorch engine runs on "
                    "one device; meshes are not ported yet")


@dataclasses.dataclass
class ActivationCheckpointingConfig(_Section):
    """``activation_checkpointing``: ``policy`` ``none`` or ``full`` (the
    reference's named policies raise); the engine applies a policy other
    than ``none`` to the model's layers."""

    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "none"

    UNPORTED = {"cpu_checkpointing": False}

    def validate(self, path: str) -> None:
        from deepspeed_tpu_torch.runtime.activation_checkpointing import (
            check_policy)

        check_policy(self.policy)


@dataclasses.dataclass
class DeepSpeedTpuConfig(_Section):
    """The root config. Build it with :func:`from_config`."""

    train_batch_size: Union[int, str, None] = None
    train_micro_batch_size_per_gpu: Union[int, str, None] = None
    gradient_accumulation_steps: Union[int, str, None] = None
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = dataclasses.field(default_factory=FP16Config)
    bf16: BF16Config = dataclasses.field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = dataclasses.field(default_factory=ZeroConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    activation_checkpointing: ActivationCheckpointingConfig = dataclasses.field(
        default_factory=ActivationCheckpointingConfig)
    gradient_clipping: float = 0.0
    steps_per_print: int = 10
    seed: int = 42

    NESTED = {"optimizer": OptimizerConfig, "scheduler": SchedulerConfig,
              "fp16": FP16Config, "bf16": BF16Config,
              "zero_optimization": ZeroConfig, "mesh": MeshConfig,
              "activation_checkpointing": ActivationCheckpointingConfig}
    UNPORTED = {
        **{k: _SECTION for k in (
            "moe", "pipeline", "resilience", "observability", "offload",
            "comms_logger", "monitor_config", "tensorboard", "csv_monitor",
            "wandb", "flops_profiler", "data_types", "compression",
            "checkpoint", "sequence_parallel", "elasticity", "autotuning",
            "serving", "inference", "data_efficiency", "hybrid_engine",
            "progressive_layer_drop")},
        "sanity_checks": False, "sanity_check_batches": True,
        "wall_clock_breakdown": False, "prescale_gradients": False,
        "gradient_predivide_factor": 1.0, "dump_state": False,
    }

    @classmethod
    def build(cls, values, path: str = ""):
        if isinstance(values, dict) and values.get("mesh") == AUTO:
            raise NotImplementedError("config 'mesh': 'auto' is not ported "
                                      "(one device)")
        return super().build(values, path)

    def validate(self, path: str) -> None:
        """fp16 and bf16 are mutually exclusive: bf16 defaults to enabled,
        so enabling fp16 flips the default off; an explicit double-enable
        raises."""
        if self.fp16.enabled and self.bf16.enabled:
            if "enabled" in getattr(self.bf16, "_set", ()):
                raise ValueError("fp16.enabled and bf16.enabled are mutually "
                                 "exclusive")
            self.bf16.enabled = False

    def resolve_batch_sizes(self, dp_world_size: int) -> None:
        """Fill in the missing member(s) of (train_batch, micro_batch,
        grad_accum); ``train_batch_size == micro_batch * grad_accum *
        dp_world_size`` must hold."""
        tb = None if self.train_batch_size in (None, AUTO) else int(self.train_batch_size)
        mb = (None if self.train_micro_batch_size_per_gpu in (None, AUTO)
              else int(self.train_micro_batch_size_per_gpu))
        ga = (None if self.gradient_accumulation_steps in (None, AUTO)
              else int(self.gradient_accumulation_steps))

        if tb and mb and ga:
            if tb != mb * ga * dp_world_size:
                raise ValueError(
                    f"train_batch_size {tb} != micro_batch {mb} * grad_accum {ga} "
                    f"* dp_world_size {dp_world_size}")
        elif tb and mb:
            if tb % (mb * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by micro_batch*dp "
                    f"{mb * dp_world_size}")
            ga = tb // (mb * dp_world_size)
        elif tb and ga:
            if tb % (ga * dp_world_size) != 0:
                raise ValueError(
                    f"train_batch_size {tb} not divisible by grad_accum*dp "
                    f"{ga * dp_world_size}")
            mb = tb // (ga * dp_world_size)
        elif mb and ga:
            tb = mb * ga * dp_world_size
        elif mb:
            ga = 1
            tb = mb * dp_world_size
        elif tb:
            ga = 1
            if tb % dp_world_size != 0:
                raise ValueError(f"train_batch_size {tb} not divisible by dp {dp_world_size}")
            mb = tb // dp_world_size
        else:
            raise ValueError(
                "at least one of train_batch_size / train_micro_batch_size_per_gpu "
                "must be set")

        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = ga


def from_config(config: Union[str, Dict[str, Any], DeepSpeedTpuConfig, None]
                ) -> DeepSpeedTpuConfig:
    """The root config from a dict, a JSON file path, or an instance."""
    if config is None:
        return DeepSpeedTpuConfig.build({})
    if isinstance(config, DeepSpeedTpuConfig):
        return config
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise TypeError(f"unsupported config type {type(config)}")
    return DeepSpeedTpuConfig.build(config)
