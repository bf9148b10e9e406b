"""Root configuration of the training path (counterpart of
``deepspeed_tpu/config/config.py``), in dataclasses.

The same JSON/dict config as the reference. Only the sections the
single-device training engine reads are ported: the batch triple,
``optimizer``, ``scheduler``, ``fp16`` / ``bf16``, ``gradient_clipping``,
``steps_per_print``, ``seed``, ``zero_optimization.stage`` (0-3 compute the
same thing on one device, as the reference does on a one-device mesh),
``zero_optimization.offload_optimizer`` / ``zenflow`` / ``offload_param``
and ``offload`` (the host / NVMe optimizer tier),
``mesh`` (every axis 1), ``activation_checkpointing``, ``observability``,
``wall_clock_breakdown``, ``checkpoint``, ``resilience``,
``data_efficiency``, ``progressive_layer_drop``, ``moe``,
``sanity_checks`` / ``sanity_check_batches`` and the serving layer's
``serving``. Keys are checked:
a misspelled key raises ``ValueError`` naming it, and a section or option of
the reference that this port does not implement raises
``NotImplementedError`` naming it -- nothing is silently ignored.
"""

from __future__ import annotations

import dataclasses
import difflib
import json
from typing import Any, Dict, List, Optional, Union

AUTO = "auto"
_MESH_ITEM = ' (ROADMAP section 1, "Mesh, ZeRO and tensor parallelism")'
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


def _asks_nothing(val, ref_default) -> bool:
    """True when an unported key's value equals the reference's default."""
    if ref_default is _SECTION:
        return False
    if isinstance(ref_default, dict) and isinstance(val, dict):
        return all(k in ref_default and v == ref_default[k]
                   for k, v in val.items())
    return val == ref_default


class _Section:
    """Base of the config sections: :meth:`build` checks every key."""

    #: nested sections: key -> class
    NESTED: Dict[str, type] = {}
    #: keys of the reference this port does not implement: key -> the
    #: reference's default (a value equal to it asks for nothing and passes;
    #: ``_SECTION`` raises on any value; a dict of defaults passes a dict
    #: whose every key holds its default)
    UNPORTED: Dict[str, Any] = {}
    #: unported key -> the title of the ROADMAP section 1 item that ports it
    UNPORTED_ITEM: Dict[str, str] = {}
    #: keys with a non-None default that also take None
    NULLABLE: frozenset = frozenset()

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
                if not _asks_nothing(val, cls.UNPORTED[key]):
                    item = cls.UNPORTED_ITEM.get(key)
                    raise NotImplementedError(
                        f"config {where!r} is not ported to the PyTorch "
                        "engine yet " + (f'(ROADMAP section 1, "{item}")'
                                         if item else
                                         "(single device, training slice)"))
                continue
            if key not in fields:
                raise _unknown(path or "config", key,
                               list(fields) + list(cls.UNPORTED))
            sub = cls.NESTED.get(key)
            if sub is not None and val is not None:
                val = sub.build(val, where)
            elif fields[key].default not in (dataclasses.MISSING, None,
                                             AUTO) and not (
                    val is None and key in cls.NULLABLE):
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


OFFLOAD_DEVICES = ("none", "cpu", "nvme")


def _check_offload_device(path: str, device) -> None:
    if device not in OFFLOAD_DEVICES:
        raise ValueError(f"{path}.device must be one of {OFFLOAD_DEVICES}, "
                         f"got {device!r}")


@dataclasses.dataclass
class OffloadParamConfig(_Section):
    """``zero_optimization.offload_param`` (ZeRO-Infinity param offload):
    accepted with the reference's fields and, as in the reference, read by
    nothing."""

    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False

    def validate(self, path: str) -> None:
        _check_offload_device(path, self.device)


@dataclasses.dataclass
class OffloadOptimizerConfig(_Section):
    """``zero_optimization.offload_optimizer`` (ZeRO-Offload / Infinity):
    ``device`` ``cpu`` keeps the fp32 masters and Adam moments in host RAM,
    ``nvme`` the moments in files under ``nvme_path``; the update runs in
    the host C++ loop (``offload/optimizer.py``). ``buffer_count`` is the
    NVMe tier's AIO thread count when ``offload.aio.threads`` is 0 and
    autotune is off; the other knobs are accepted, as in the reference."""

    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0

    def validate(self, path: str) -> None:
        _check_offload_device(path, self.device)


@dataclasses.dataclass
class ZenFlowConfig(_Section):
    """``zero_optimization.zenflow`` (the reference's): two mechanisms on
    top of ``offload_optimizer``, one at a time --

    * ``overlap_step``: the whole host Adam step runs on a background
      worker with 1-step bounded staleness, beside the card's next
      forward and backward;
    * ``topk_ratio > 0``: the top-k most important gradient columns update
      on the card every step through a selective Adam, the rest accumulate
      on the card and go through the host Adam every ``update_interval``
      steps; columns are reselected every ``select_interval`` steps.
      ``"auto"`` intervals resolve to update 4, select 4 x update."""

    overlap_step: bool = False
    topk_ratio: float = 0.0
    select_strategy: str = "auto"
    select_interval: Any = AUTO
    update_interval: Any = AUTO
    full_warm_up_rounds: int = 0

    def validate(self, path: str) -> None:
        if not (0.0 <= self.topk_ratio <= 1.0):
            raise ValueError("zenflow.topk_ratio must be in [0, 1]")
        if self.select_strategy not in ("auto", "step"):
            raise ValueError(
                "zenflow.select_strategy: 'epoch' needs steps_per_epoch which "
                "the engine does not track — use 'step' with select_interval "
                "in steps, or 'auto'")
        for f in ("select_interval", "update_interval"):
            v = getattr(self, f)
            if not (v == AUTO or (isinstance(v, int) and v >= 1)):
                raise ValueError(f"zenflow.{f} must be 'auto' or a positive "
                                 "integer")
        if self.select_strategy == "step" and self.select_interval == AUTO:
            raise ValueError(
                "zenflow.select_strategy='step' requires an explicit integer "
                "select_interval (in steps)")
        if self.topk_ratio > 0 and self.overlap_step:
            raise ValueError(
                "zenflow: overlap_step and the top-k selective split are "
                "alternative overlap mechanisms — enable one, not both")
        if self.topk_ratio == 0 and not self.overlap_step:
            raise ValueError(
                "zero_optimization.zenflow is enabled but both mechanisms "
                "are off (overlap_step=False, topk_ratio=0) — the block "
                "would be a no-op. Set overlap_step=true or topk_ratio>0 "
                "(overlap_step's default changed from true to false to "
                "match the reference default).")

    def resolved_update_interval(self) -> int:
        return 4 if self.update_interval == AUTO else int(self.update_interval)

    def resolved_select_interval(self) -> int:
        if self.select_interval == AUTO:
            return 4 * self.resolved_update_interval()
        return int(self.select_interval)


@dataclasses.dataclass
class ZeroConfig(_Section):
    """``zero_optimization``: ``stage`` 0-3, which on one device all keep
    whole fp32 params and grads and compute the same step;
    ``offload_optimizer`` moves the optimizer (fp32 masters and moments)
    to the host or NVMe, ``zenflow`` overlaps or splits that host step,
    ``offload_param`` is accepted and read by nothing, as in the
    reference. The bucket and overlap knobs tune collectives that one
    device does not have; they are accepted."""

    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    offload_param: Optional[OffloadParamConfig] = None
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    zenflow: Optional[ZenFlowConfig] = None
    sub_group_size: int = 1_000_000_000
    param_persistence_threshold: int = 100_000
    model_persistence_threshold: int = 9999999999
    max_live_parameters: int = 1_000_000_000
    prefetch_bucket_size: int = 50_000_000
    round_robin_gradients: bool = False
    zero_allow_untested_optimizer: bool = True
    ignore_unused_parameters: bool = True
    use_multi_rank_bucket_allreduce: bool = True

    NESTED = {"offload_param": OffloadParamConfig,
              "offload_optimizer": OffloadOptimizerConfig,
              "zenflow": ZenFlowConfig}
    UNPORTED = {"zero_pp": _SECTION,
                "zero_quantized_weights": False,
                "zero_quantized_gradients": False,
                "zero_hpz_partition_size": 1, "mics_shard_size": -1,
                "mics_hierarchical_params_gather": False}
    UNPORTED_ITEM = {k: "Mesh, ZeRO and tensor parallelism" for k in UNPORTED}

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
            raise NotImplementedError(
                "config 'mesh.auto' is not ported (one device)" + _MESH_ITEM)
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
                    "one device; meshes are not ported yet" + _MESH_ITEM)


@dataclasses.dataclass
class ActivationCheckpointingConfig(_Section):
    """``activation_checkpointing``: ``policy`` is any name of
    ``runtime/activation_checkpointing.py`` ``POLICIES`` (an unknown one
    raises ``ValueError``); the engine applies a policy other than ``none``
    to the model's layers. The reference's other keys are accepted as it
    accepts them: on one device they ask for nothing (its offload is the
    ``offload_*`` policies)."""

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "none"

    def validate(self, path: str) -> None:
        from deepspeed_tpu_torch.runtime.activation_checkpointing import (
            check_policy)

        check_policy(self.policy)


@dataclasses.dataclass
class CurriculumLearningConfig(_Section):
    """``data_efficiency.data_sampling.curriculum_learning`` (the
    reference's :478)."""

    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 8
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"
    schedule_config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def model_dump(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class DataSamplingConfig(_Section):
    enabled: bool = False
    curriculum_learning: CurriculumLearningConfig = dataclasses.field(
        default_factory=CurriculumLearningConfig)

    NESTED = {"curriculum_learning": CurriculumLearningConfig}


@dataclasses.dataclass
class RandomLTDConfig(_Section):
    """``data_efficiency.data_routing.random_ltd``: layers ``[start, end)``
    run on a random subset of ``keep`` tokens; keep grows from
    ``min_value`` by ``step_size`` every ``interval`` steps up to
    ``max_value`` (0: the model's ``max_seq_len``); ``end`` -1 is
    ``num_layers - 1``."""

    enabled: bool = False
    random_ltd_layer_start: int = 1
    random_ltd_layer_end: int = -1
    min_value: int = 128
    max_value: int = 0
    step_size: int = 16
    interval: int = 100


@dataclasses.dataclass
class DataRoutingConfig(_Section):
    enabled: bool = False
    random_ltd: RandomLTDConfig = dataclasses.field(
        default_factory=RandomLTDConfig)

    NESTED = {"random_ltd": RandomLTDConfig}


@dataclasses.dataclass
class DataEfficiencyConfig(_Section):
    """``data_efficiency`` (the reference's :517): the curriculum and
    random-LTD."""

    enabled: bool = False
    data_sampling: DataSamplingConfig = dataclasses.field(
        default_factory=DataSamplingConfig)
    data_routing: DataRoutingConfig = dataclasses.field(
        default_factory=DataRoutingConfig)

    NESTED = {"data_sampling": DataSamplingConfig,
              "data_routing": DataRoutingConfig}


@dataclasses.dataclass
class ProgressiveLayerDropConfig(_Section):
    """``progressive_layer_drop`` (the reference's :525): ``compiled_tiers``
    > 0 runs only the first k layers, k from theta's expected kept-layer
    count on that many tiers; 0 drops each layer at random with the PLD
    depth ramp."""

    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001
    compiled_tiers: int = 0


class _Checked(_Section):
    """A section that checks itself when constructed directly too (the
    serving sections are passed to ``InferenceEngineV2`` as instances,
    dicts or bools, as the reference's pydantic models are)."""

    def __post_init__(self):
        for key, sub in self.NESTED.items():
            val = getattr(self, key)
            if not isinstance(val, sub):
                setattr(self, key, sub.build(val, key))
        self.validate("")


@dataclasses.dataclass
class MoEConfig(_Checked):
    """``moe`` (the reference's :425): the same fields, defaults and checks.
    The model reads its MoE settings from its ``TransformerConfig``
    (``num_experts``, ``top_k``, ``capacity_factor``, ``moe_dispatch``,
    ``moe_kernel``, ...); this section is accepted and validated as the
    reference's is. ``kernel`` picks the grouped dispatch's product
    (``ragged`` or the ``padded`` einsum twin); ``a2a_bits`` /
    ``a2a_slice`` and ``replica_slots`` configure expert parallelism,
    which one device never uses."""

    enabled: bool = False
    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    drop_tokens: bool = True
    use_rts: bool = True               # random token selection
    noisy_gate_policy: Optional[str] = None   # None|Jitter|RSample
    kernel: str = "ragged"
    a2a_bits: int = 0
    a2a_slice: int = 0
    replica_slots: int = 0

    def validate(self, path: str) -> None:
        if self.kernel not in ("ragged", "padded"):
            raise ValueError("moe.kernel must be 'ragged' or 'padded', "
                             f"got {self.kernel!r}")
        if self.a2a_bits not in (0, 4, 8):
            raise ValueError("moe.a2a_bits must be 0, 4 or 8, got "
                             f"{self.a2a_bits}")
        if self.a2a_slice < 0 or self.replica_slots < 0:
            raise ValueError("moe.a2a_slice and moe.replica_slots must "
                             "be >= 0")


@dataclasses.dataclass
class KVTierConfig(_Checked):
    """``inference.prefix_cache.tiers`` (the reference's :938): instead of
    freeing an LRU cache block held only by the prefix tree, demote its KV
    pages to a host buffer, and past ``host_mb`` on to NVMe under
    ``<nvme_path>/kv``; a radix match on a demoted block promotes it
    back."""

    enabled: bool = False
    host_mb: float = 64.0
    nvme_path: str = ""
    promote_depth: int = 4
    nvme_max_mb: float = 0.0     # 0 = unbounded
    nvme_ttl_s: float = 0.0      # 0 = no idle limit

    def validate(self, path: str) -> None:
        if self.host_mb <= 0:
            raise ValueError(
                "inference.prefix_cache.tiers.host_mb must be > 0")
        if self.promote_depth < 1:
            raise ValueError(
                "inference.prefix_cache.tiers.promote_depth must be >= 1")
        if self.nvme_max_mb < 0 or self.nvme_ttl_s < 0:
            raise ValueError(
                "inference.prefix_cache.tiers.nvme_max_mb / nvme_ttl_s "
                "must be >= 0 (0 = unbounded)")


@dataclasses.dataclass
class PrefixCacheConfig(_Checked):
    """``inference.prefix_cache`` (the reference's :981): a radix tree of
    full-block token chunks over the paged pool; ``max_blocks`` caps the
    tree (None: bounded by the pool, LRU reclaim under pressure)."""

    enabled: bool = False
    max_blocks: Optional[int] = None
    tiers: KVTierConfig = dataclasses.field(default_factory=KVTierConfig)

    NESTED = {"tiers": KVTierConfig}

    def validate(self, path: str) -> None:
        if self.max_blocks is not None and self.max_blocks < 1:
            raise ValueError(
                "inference.prefix_cache.max_blocks must be >= 1")


@dataclasses.dataclass
class SpeculativeConfig(_Checked):
    """``inference.speculative`` (the reference's :1004): n-gram
    self-drafting inside greedy decode; ``fallback_steps`` is the fused
    loop's chunk when no sequence has a draft."""

    enabled: bool = False
    ngram: int = 3
    max_draft: int = 4
    fallback_steps: int = 8

    def validate(self, path: str) -> None:
        if self.ngram < 1:
            raise ValueError("inference.speculative.ngram must be >= 1")
        if not (1 <= self.max_draft <= 64):
            raise ValueError(
                "inference.speculative.max_draft must be in [1, 64]")
        if self.fallback_steps < 1:
            raise ValueError(
                "inference.speculative.fallback_steps must be >= 1")


@dataclasses.dataclass
class ProfileTriggerConfig(_Section):
    """``observability.profile`` (the reference's :1058): on-demand
    ``torch.profiler`` capture armed from outside a running job (trigger
    file or SIGUSR2) -- see
    :class:`~deepspeed_tpu_torch.observability.ProfileTrigger`."""

    enabled: bool = False
    output_dir: str = "./xla_profiles"
    # "" = <output_dir>/TRIGGER; touching the file arms one capture
    trigger_file: str = ""
    signal_enabled: bool = False      # SIGUSR2 arms a capture
    capture_steps: int = 5            # steps traced per capture
    rate_limit_s: float = 300.0       # at most one capture per this window
    warmup_steps: int = 2             # never arm before this many boundaries


@dataclasses.dataclass
class TracingConfig(_Section):
    """``observability.tracing`` (the reference's :1074): the causal event
    bus and crash flight recorder (``observability/events.py`` /
    ``trace.py``). Off by default; when off the cost is one attribute check
    per instrumented site and nothing is recorded."""

    enabled: bool = False
    # events kept per category (a deque maxlen: drops oldest, never grows)
    ring_size: int = 4096
    # keep every Nth request trace (1 = all), counted, not sampled at random
    sample: int = 1
    dump_dir: str = "./flight_dumps"
    # terminal request spans retained after the serving ledger evicts them
    retain_terminal: int = 256

    def validate(self, path: str) -> None:
        if self.ring_size < 16:
            raise ValueError("observability.tracing.ring_size must be "
                             ">= 16")
        if self.sample < 1:
            raise ValueError("observability.tracing.sample must be >= 1")
        if self.retain_terminal < 0:
            raise ValueError("observability.tracing.retain_terminal must "
                             "be >= 0")


@dataclasses.dataclass
class ObservabilityConfig(_Section):
    """``observability`` (the reference's :1112): the process-wide metrics
    registry, the ``/metrics`` + ``/healthz`` / ``/readyz`` server, the
    profile trigger and the event bus. ``enabled`` defaults True: the
    registry costs a handful of host float ops per step and no device
    sync; the HTTP server and the breakdown timers stay opt-in. The
    registry-to-monitor bridge's cadence (``flush_interval_steps``) is
    accepted; monitors are not ported, so nothing flushes."""

    enabled: bool = True
    http_server: bool = False         # stand up /metrics on engine init
    http_host: str = "127.0.0.1"
    http_port: int = 0                # 0 = ephemeral
    flush_interval_steps: int = 0     # bridge cadence (0 = steps_per_print)
    # per-step fwd/bwd/optimizer timer gauges (train/*_ms); also turned on
    # by the top-level wall_clock_breakdown flag
    train_breakdown: bool = False
    monitor_memory: bool = False      # host memory on the periodic speed log
    profile: ProfileTriggerConfig = dataclasses.field(
        default_factory=ProfileTriggerConfig)
    tracing: TracingConfig = dataclasses.field(default_factory=TracingConfig)

    NESTED = {"profile": ProfileTriggerConfig, "tracing": TracingConfig}


_SLO_TIERS = ("latency", "throughput", "batch")


@dataclasses.dataclass
class FrontendConfig(_Checked):
    """``serving.frontend`` (the reference's :632): the stdlib-HTTP
    front-end -- ``POST /v1/generate`` (JSON, or SSE when streaming) on the
    same mux as ``/metrics`` / ``/healthz`` / ``/readyz``. Retryable sheds
    map to 429 + ``Retry-After``, terminal refusals to 413, deadline expiry
    to 504."""

    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = 0                     # 0 = ephemeral
    # x-api-key header value -> admission priority (higher = shed later)
    api_keys: Dict[str, int] = dataclasses.field(default_factory=dict)
    require_api_key: bool = False     # 401 requests without a known key
    allow_priority_header: bool = True  # honor x-priority / body "priority"
    # bounds of the x-priority / body override: it never outranks the
    # api_keys tenants, nor mints unbounded per-priority metric labels
    max_header_priority: int = 0
    min_header_priority: int = -1
    default_priority: int = 0
    max_prompt_tokens: int = 8192     # 413 above this, before the queue
    request_timeout_s: float = 120.0  # unary wait cap when no deadline given
    max_body_bytes: int = 8 << 20

    def validate(self, path: str) -> None:
        if self.min_header_priority > self.max_header_priority:
            raise ValueError("serving.frontend: min_header_priority must "
                             "be <= max_header_priority")
        if self.max_prompt_tokens < 1 or self.max_body_bytes < 1 \
                or self.request_timeout_s <= 0:
            raise ValueError("serving.frontend: max_prompt_tokens, "
                             "max_body_bytes, request_timeout_s must be "
                             "positive")


@dataclasses.dataclass
class RouterConfig(_Checked):
    """``serving.router`` (the reference's :674): least-loaded routing over
    replicas, retryable sheds failed over to siblings before a 429,
    DRAINING replicas routed away, and drain-time migration."""

    enabled: bool = False
    failover_attempts: int = 0        # replicas tried per submit (0 = all)
    migrate_on_drain: bool = True
    idle_sleep_s: float = 0.002       # replica worker park time when idle
    submit_timeout_s: float = 30.0    # cross-thread submit handshake cap
    max_route_history: int = 65536    # terminal routes kept for resolve()

    def validate(self, path: str) -> None:
        if self.failover_attempts < 0:
            raise ValueError("serving.router.failover_attempts must be >= 0")
        if self.idle_sleep_s <= 0 or self.submit_timeout_s <= 0:
            raise ValueError("serving.router: idle_sleep_s and "
                             "submit_timeout_s must be > 0")
        if self.max_route_history < 1:
            raise ValueError("serving.router.max_route_history must be "
                             ">= 1")


@dataclasses.dataclass
class FleetConfig(_Checked):
    """``serving.fleet`` (the reference's :707): the elastic replica
    lifecycle above the router (``serving/fleet.py``) -- crash detection
    and respawn with READY-gated readmission, autoscaling on queue depth,
    sheds and Retry-After with hysteresis, and rolling weight swaps under a
    min-ready floor."""

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    # a worker whose stats heartbeat is older than this is treated as hung
    # and recovered like a death (thread death is seen at once)
    heartbeat_timeout_s: float = 10.0
    # readiness probe of a respawned / new replica before readmission: a
    # tiny generate must complete within this budget
    probe_timeout_s: float = 120.0
    probe_max_new_tokens: int = 2
    # respawn back-off: base * 2^attempt, capped; past max_respawns the
    # replica stays out (the flight recorder has the why)
    respawn_backoff_s: float = 0.5
    max_respawns: int = 3
    # scale up after scale_up_polls consecutive polls with pool queue
    # depth > scale_up_queue_per_replica x routable replicas (or any shed
    # in the poll window, or the Retry-After watermark below); scale down
    # after scale_down_idle_polls consecutive idle polls
    scale_up_queue_per_replica: float = 4.0
    scale_up_retry_after_s: float = 2.0
    scale_up_polls: int = 2
    scale_down_idle_polls: int = 6
    # rolling swap: never below this many READY replicas while one at a
    # time drains, reloads weights and rejoins
    min_ready_floor: int = 1

    def validate(self, path: str) -> None:
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError("serving.fleet: need 1 <= min_replicas <= "
                             "max_replicas")
        if self.heartbeat_timeout_s <= 0 or self.probe_timeout_s <= 0:
            raise ValueError("serving.fleet: heartbeat_timeout_s and "
                             "probe_timeout_s must be > 0")
        if self.respawn_backoff_s < 0 or self.max_respawns < 1:
            raise ValueError("serving.fleet: respawn_backoff_s must be "
                             ">= 0 and max_respawns >= 1")
        if self.scale_up_polls < 1 or self.scale_down_idle_polls < 1:
            raise ValueError("serving.fleet: scale_up_polls and "
                             "scale_down_idle_polls must be >= 1")
        if self.scale_up_queue_per_replica < 0:
            raise ValueError("serving.fleet.scale_up_queue_per_replica "
                             "must be >= 0")
        if self.min_ready_floor < 1:
            raise ValueError("serving.fleet.min_ready_floor must be >= 1")
        if self.probe_max_new_tokens < 1:
            raise ValueError("serving.fleet.probe_max_new_tokens must be "
                             ">= 1")


@dataclasses.dataclass
class SLOConfig(_Checked):
    """``serving.slo`` (the reference's :770): SLO tiers (``latency``,
    ``throughput``, ``batch``) with per-tier admission budgets (a tier over
    budget waits, never sheds) and preemption: under KV pressure victims
    are paused -- their KV demoted through the tier store -- and resume
    later with the same greedy tokens. Victims: batch first, deadline-free
    first, most remaining work first; never paused twice before they
    advance."""

    enabled: bool = False
    default_tier: str = "throughput"
    # fractions of the batcher's KV admission budget per tier
    budgets: Dict[str, float] = dataclasses.field(default_factory=lambda: {
        "latency": 1.0, "throughput": 1.0, "batch": 1.0})
    preempt: bool = True              # pause victims instead of shedding
    max_pauses: int = 4               # pause cycles before a shed
    resume_max_per_step: int = 1
    pause_host_mb: float = 64.0       # host budget of the pause store
    # Retry-After multiplier per tier (batch backs off hardest)
    retry_after_factor: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"latency": 1.0, "throughput": 1.0,
                                 "batch": 4.0})

    def validate(self, path: str) -> None:
        if self.default_tier not in _SLO_TIERS:
            raise ValueError(f"serving.slo.default_tier must be one of "
                             f"{list(_SLO_TIERS)}")
        for name, table in (("budgets", self.budgets),
                            ("retry_after_factor", self.retry_after_factor)):
            unknown = set(table) - set(_SLO_TIERS)
            if unknown:
                raise ValueError(f"serving.slo.{name}: unknown tiers "
                                 f"{sorted(unknown)}")
        if any(not (0.0 < v <= 1.0) for v in self.budgets.values()):
            raise ValueError("serving.slo.budgets values must be in (0, 1]")
        if any(v <= 0 for v in self.retry_after_factor.values()):
            raise ValueError(
                "serving.slo.retry_after_factor values must be > 0")
        if self.max_pauses < 0 or self.resume_max_per_step < 1:
            raise ValueError("serving.slo: max_pauses must be >= 0 and "
                             "resume_max_per_step >= 1")
        if self.pause_host_mb <= 0:
            raise ValueError("serving.slo.pause_host_mb must be > 0")


@dataclasses.dataclass
class MigrationConfig(_Checked):
    """``serving.migration`` (the reference's :834): every pause also
    exports a durable copy of the victim's KV onto a shared NVMe namespace
    (``<shared_nvme_path>/kv``) with an atomic resume manifest
    (``<shared_nvme_path>/manifests``), so a sibling replica can adopt it
    after a crash, a drain or a rebalance. The ladder is resume, then
    re-prefill from token history, then a retryable shed; adopted KV is
    never zero-filled."""

    enabled: bool = False
    shared_nvme_path: str = ""        # REQUIRED when enabled
    manifest_ttl_s: float = 0.0       # 0 = never expire

    def validate(self, path: str) -> None:
        if self.enabled and not self.shared_nvme_path:
            raise ValueError("serving.migration.enabled requires "
                             "shared_nvme_path (a directory every replica "
                             "can reach)")
        if self.manifest_ttl_s < 0:
            raise ValueError("serving.migration.manifest_ttl_s must be "
                             ">= 0 (0 = never expire)")


@dataclasses.dataclass
class ServingConfig(_Checked):
    """``serving`` (the reference's :870): the request-lifecycle layer above
    ``InferenceEngineV2`` -- bounded admission on projected worst-case KV
    demand (prompt + max_new_tokens) under ``kv_high_watermark``,
    deadlines, watermark shedding down to ``kv_low_watermark``, DEGRADED
    capacity (``degraded_capacity_factor``) and SIGTERM drain; ``fleet``
    configures the elastic replica lifecycle above the router."""

    enabled: bool = False
    max_queue_depth: int = 64
    # queued requests above this are shed (None = max_queue_depth)
    queue_high_watermark: Optional[int] = None
    max_active_requests: Optional[int] = None  # None = engine max_sequences
    default_max_new_tokens: int = 128
    default_deadline_s: Optional[float] = None   # None = no deadline
    retry_after_s: float = 1.0        # backoff hint carried by ShedError
    prefill_chunk: int = 256          # prompt tokens fed per serving step
    eos_token_id: Optional[int] = None
    kv_high_watermark: float = 0.90
    kv_low_watermark: float = 0.75
    failure_window: int = 32          # sliding step-outcome window length
    degrade_failure_ratio: float = 0.25   # enter DEGRADED at this ratio
    degraded_capacity_factor: float = 0.5
    drain_timeout_s: float = 30.0
    monitor_interval: int = 10        # serving steps between monitor writes
    # per-request spans -> serving/ttft_ms, tpot_ms, queue_wait_ms, e2e_ms
    # (lifecycle counters record either way)
    trace_requests: bool = True
    max_done_history: int = 65536     # terminal ledger bound
    frontend: FrontendConfig = dataclasses.field(
        default_factory=FrontendConfig)
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    migration: MigrationConfig = dataclasses.field(
        default_factory=MigrationConfig)

    NESTED = {"frontend": FrontendConfig, "router": RouterConfig,
              "fleet": FleetConfig, "slo": SLOConfig,
              "migration": MigrationConfig}

    def validate(self, path: str) -> None:
        if not (0.0 < self.kv_low_watermark <= self.kv_high_watermark
                <= 1.0):
            raise ValueError("serving: need 0 < kv_low_watermark <= "
                             "kv_high_watermark <= 1")
        if not (0.0 < self.degraded_capacity_factor <= 1.0):
            raise ValueError("serving.degraded_capacity_factor must be in "
                             "(0, 1]")
        if not (0.0 < self.degrade_failure_ratio <= 1.0):
            raise ValueError("serving.degrade_failure_ratio must be in "
                             "(0, 1]")
        if self.prefill_chunk < 1 or self.max_queue_depth < 1:
            raise ValueError("serving: prefill_chunk and max_queue_depth "
                             "must be >= 1")
        if self.max_done_history < 1:
            raise ValueError("serving.max_done_history must be >= 1")


@dataclasses.dataclass
class CheckpointConfig(_Section):
    """``checkpoint`` (the reference's :410): ``async_save`` writes the
    files and the ``latest`` pointer on a commit thread after a synchronous
    device-to-host copy. The reference's other keys are taken at their
    defaults only: nothing on one device reads them."""

    UNPORTED = {"use_node_local_storage": False,
                "parallel_write_pipeline": False, "tag_validation": "Warn",
                "load_universal": False}
    UNPORTED_ITEM = {k: "Mesh, ZeRO and tensor parallelism"
                     for k in UNPORTED}

    async_save: bool = False


@dataclasses.dataclass
class RetryConfig(_Section):
    """``resilience.retry`` (the reference's :573): backoff for checkpoint
    IO."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class ResilienceCheckpointConfig(_Section):
    """``resilience.checkpoint`` (the reference's :584): the preemption-safe
    checkpoint lifecycle."""

    keep_last_k: int = 3
    verify: bool = True          # manifest+checksum on save, verify on load
    save_on_preempt: bool = True  # SIGTERM -> emergency save at next boundary
    exit_on_preempt: bool = False
    preempt_exit_code: int = 42
    # stage inline, commit (manifest -> latest -> GC) on a background thread;
    # a .staging sentinel keeps crash-in-the-window tags load-rejectable
    async_save: bool = False


@dataclasses.dataclass
class CoordinationConfig(_Section):
    """``resilience.coordination`` (the reference's :597): step-boundary
    CONTINUE / SAVE / ABORT decisions. One process decides locally; signals
    are held across off-interval boundaries, never dropped."""

    enabled: bool = True
    interval_steps: int = 1


@dataclasses.dataclass
class HeartbeatConfig(_Section):
    """``resilience.heartbeat`` (the reference's :613): the liveness file
    and the hang watchdog. ``dir`` defaults to ``<checkpoint dir>/
    heartbeats``; no step boundary for ``deadline_s`` (or a host collective
    in flight past ``collective_deadline_s``) escalates per ``on_hang``:
    ``abort``, ``exit`` or ``report``."""

    enabled: bool = False
    dir: Optional[str] = None
    interval_s: float = 5.0
    deadline_s: float = 300.0
    collective_deadline_s: Optional[float] = 120.0
    poll_s: Optional[float] = None   # default: min(deadlines) / 4
    on_hang: str = "abort"
    exit_code: int = 47

    NULLABLE = frozenset({"collective_deadline_s"})


@dataclasses.dataclass
class ResilienceConfig(_Section):
    """``resilience`` (the reference's :1215): the step guard, retries,
    checkpoint verification and fallback, step-boundary coordination, the
    heartbeat watchdog and the fault table."""

    enabled: bool = False
    # consecutive NaN/Inf steps before aborting
    max_consecutive_bad_steps: int = 3
    retry: RetryConfig = dataclasses.field(default_factory=RetryConfig)
    checkpoint: ResilienceCheckpointConfig = dataclasses.field(
        default_factory=ResilienceCheckpointConfig)
    coordination: CoordinationConfig = dataclasses.field(
        default_factory=CoordinationConfig)
    heartbeat: HeartbeatConfig = dataclasses.field(
        default_factory=HeartbeatConfig)
    # fault-injection table (resilience/faults.py FaultSpec), e.g.
    # [{"kind": "crash", "step": 3, "hard": true}]
    faults: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    NESTED = {"retry": RetryConfig, "checkpoint": ResilienceCheckpointConfig,
              "coordination": CoordinationConfig,
              "heartbeat": HeartbeatConfig}

    def validate(self, path: str) -> None:
        if not (isinstance(self.faults, list)
                and all(isinstance(f, dict) for f in self.faults)):
            raise ValueError(f"resilience.faults: expected a list of "
                             f"objects, got {self.faults!r}")


@dataclasses.dataclass
class AioConfig(_Section):
    """``offload.aio``: the swap pipeline's IO shape (the reference's) --
    ``threads`` AIO workers per swapper (0: the autotuned value when
    ``autotune`` is on, else ``offload_optimizer.buffer_count``),
    ``chunk_mb`` the per-op IO size (0: autotuned or 8 MB),
    ``prefetch_depth`` k of the optimizer's read-ahead pipeline (0:
    strictly serial), ``autotune`` a first-use ``aio_bench`` sweep,
    ``o_direct`` page-cache bypass, ``upload_overlap`` the upload of
    finished leaves while later leaves are still in the host Adam."""

    threads: int = 0
    chunk_mb: int = 0
    prefetch_depth: int = 2
    autotune: bool = False
    autotune_cache: str = ""
    o_direct: bool = False
    upload_overlap: bool = True

    def validate(self, path: str) -> None:
        if self.threads < 0 or self.chunk_mb < 0 or self.prefetch_depth < 0:
            raise ValueError(
                "offload.aio: threads/chunk_mb/prefetch_depth must be >= 0 "
                "(0 means auto/serial)")


@dataclasses.dataclass
class OffloadConfig(_Section):
    """``offload``: how the host/NVMe offload tier moves bytes (which tier
    is offloaded lives under ``zero_optimization.offload_optimizer``)."""

    aio: AioConfig = dataclasses.field(default_factory=AioConfig)

    NESTED = {"aio": AioConfig}


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
    observability: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig)
    wall_clock_breakdown: bool = False
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    checkpoint: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    resilience: ResilienceConfig = dataclasses.field(
        default_factory=ResilienceConfig)
    # cross-process config digest, param integrity / placement at startup,
    # first-batch agreement (runtime/sanity.py); per-host-sharded loaders
    # disable only the batch check with sanity_check_batches=false
    sanity_checks: bool = False
    sanity_check_batches: bool = True
    data_efficiency: DataEfficiencyConfig = dataclasses.field(
        default_factory=DataEfficiencyConfig)
    progressive_layer_drop: ProgressiveLayerDropConfig = dataclasses.field(
        default_factory=ProgressiveLayerDropConfig)
    moe: MoEConfig = dataclasses.field(default_factory=MoEConfig)
    offload: OffloadConfig = dataclasses.field(default_factory=OffloadConfig)

    NESTED = {"optimizer": OptimizerConfig, "scheduler": SchedulerConfig,
              "fp16": FP16Config, "bf16": BF16Config,
              "zero_optimization": ZeroConfig, "mesh": MeshConfig,
              "activation_checkpointing": ActivationCheckpointingConfig,
              "observability": ObservabilityConfig,
              "serving": ServingConfig, "checkpoint": CheckpointConfig,
              "resilience": ResilienceConfig,
              "data_efficiency": DataEfficiencyConfig,
              "progressive_layer_drop": ProgressiveLayerDropConfig,
              "moe": MoEConfig, "offload": OffloadConfig}
    UNPORTED_ITEM = {
        **{k: "Mesh, ZeRO and tensor parallelism" for k in (
            "pipeline", "comms_logger", "compression", "autotuning",
            "prescale_gradients", "gradient_predivide_factor")},
        "sequence_parallel": "Long context",
        **{k: "Remainder" for k in (
            "monitor_config", "tensorboard", "csv_monitor", "wandb",
            "flops_profiler", "data_types", "elasticity", "inference",
            "hybrid_engine", "dump_state")},
    }
    UNPORTED = {
        **{k: _SECTION for k in UNPORTED_ITEM},
        "prescale_gradients": False,
        "gradient_predivide_factor": 1.0, "dump_state": False,
    }

    @classmethod
    def build(cls, values, path: str = ""):
        if isinstance(values, dict) and values.get("mesh") == AUTO:
            raise NotImplementedError(
                "config 'mesh': 'auto' is not ported (one device)"
                + _MESH_ITEM)
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
