"""The training engine on one device (counterpart of
``deepspeed_tpu/runtime/engine.py`` ``DeepSpeedTpuEngine``).

The reference's imperative UX with its semantics:

* ``forward(batch)`` returns the micro-batch loss with its autograd graph;
  ``backward(loss)`` adds the gradients of ``loss * scale`` into the fp32
  master leaves' ``.grad`` (the accumulation buffer); ``step()`` applies the
  update at the gradient-accumulation boundary; ``train_batch`` runs a whole
  global batch.
* The update (the reference's ``apply_step`` :507-533): unscale by
  ``scale * ga``, take the global norm, then clip and update through the
  optimizer; in fp16 mode a non-finite norm skips the update (params,
  optimizer state and its count unchanged) and the dynamic loss scaler
  halves, while ``loss_scale_window`` finite steps in a row double it
  (:548-567).
* ``fused_train_step`` takes ``ga * micro`` examples at once and returns the
  mean loss, with the same semantics (``runtime/onebit.py`` ``ga_grads``).

* Observability (the reference's ``_configure_observability`` and
  ``_emit_train_metrics``): with ``observability.enabled`` (the default)
  each committed step sets the ``train/*`` gauges of the process registry
  from host values (step wall clock, steps, samples, skipped steps, the
  optimizer's and, with ``train_breakdown``, the forward's and backward's
  host times, and the comms logger's eager collective time, 0 on one
  device; loss and lr at ``steps_per_print``), emits a ``train/step``
  instant on the event bus when tracing is on, checks the profile trigger,
  and can serve ``/metrics``.

One device: params, grads and optimizer state stay whole on it, so ZeRO
stages 0-3 compute the same step, as they do in the reference on a
one-device mesh. Monitor (and so the registry-to-monitor bridge),
resilience, offload, 1-bit optimizers, ZeRO++ and checkpoints are not in
this slice.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.config import DeepSpeedTpuConfig
from deepspeed_tpu_torch.models.spec import tree_leaves
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedTpuDataLoader
from deepspeed_tpu_torch.runtime.lr_schedules import (LRSchedulerShim,
                                                      build_schedule)
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer, global_norm
from deepspeed_tpu_torch.utils import resolve_device
from deepspeed_tpu_torch.utils.timer import ThroughputTimer

logger = logging.getLogger("deepspeed_tpu_torch")


def _own_params(tree, device: torch.device):
    """The engine's own copy of a parameter tree (tensors or numpy arrays)
    on ``device``: contiguous leaves, floating ones requiring grad."""
    if isinstance(tree, dict):
        return {k: _own_params(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to(device).clone()
    else:
        from deepspeed_tpu_torch.bridge import params_from_numpy

        t = params_from_numpy(tree, device)
    t = t.contiguous()
    return t.requires_grad_(t.is_floating_point())


class DeepSpeedTpuEngine:
    """See the module docstring. Public surface mirrors the reference's."""

    def __init__(self, model, config: DeepSpeedTpuConfig,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, collate_fn: Optional[Callable] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        config.resolve_batch_sizes(1)
        policy = config.activation_checkpointing.policy
        if policy != "none" and getattr(model, "cfg", None) is not None:
            # the config's remat policy applies to the model's layers; the
            # caller's model object is left as it was
            model = copy.copy(model)
            model.cfg = dataclasses.replace(model.cfg, remat_policy=policy)
        self.module = model
        self.zero_stage = int(config.zero_optimization.stage)
        self.fp16_enabled = bool(config.fp16.enabled)
        self.bf16_enabled = bool(config.bf16.enabled) and not self.fp16_enabled

        # ---- schedule & optimizer -------------------------------------
        self.lr_scheduler = lr_scheduler
        schedule_fn = None
        if lr_scheduler is None and config.scheduler is not None:
            schedule_fn = build_schedule(config.scheduler.type,
                                         config.scheduler.params)
            self.lr_scheduler = LRSchedulerShim(schedule_fn, engine=self)
        elif callable(lr_scheduler):
            schedule_fn = lr_scheduler
            self.lr_scheduler = LRSchedulerShim(schedule_fn, engine=self)
        opt_cfg = config.optimizer
        self.tx = build_optimizer(
            opt_cfg.type if opt_cfg else "adamw",
            dict(opt_cfg.params) if opt_cfg else {}, lr_schedule=schedule_fn,
            gradient_clipping=config.gradient_clipping)
        self.optimizer = self   # the reference returns engine.optimizer too

        # ---- state ------------------------------------------------------
        if model_parameters is None:
            params = model.init(seed=config.seed, device=self.device)
        else:
            params = model_parameters
        self.params = _own_params(params, self.device)
        self._leaves = list(tree_leaves(self.params))
        self.opt_state = self.tx.init(self._leaves)
        self.scaler_state = self._init_scaler_state()
        self._pending: Optional[torch.Tensor] = None
        self._grad_acc_count = 0

        # ---- bookkeeping ------------------------------------------------
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._last_loss = None
        self._last_gnorm = None
        self._world_params = sum(t.numel() for t in self._leaves)
        self.tput_timer = ThroughputTimer(
            batch_size=int(self.config.train_batch_size),
            steps_per_output=config.steps_per_print,
            monitor_memory=config.observability.monitor_memory,
            device=self.device)
        self._configure_observability(config)
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data,
                                                         collate_fn=collate_fn)
        logger.info("engine ready: %.1fM params, zero_stage=%d, device=%s",
                    self._world_params / 1e6, self.zero_stage, self.device)

    # ---- fp16 dynamic loss scaler (the reference's :548-567) ------------
    def _init_scaler_state(self) -> Dict[str, Any]:
        c = self.config.fp16
        if not self.fp16_enabled:
            return {"scale": 1.0, "good_steps": 0}
        init_scale = (c.loss_scale if c.loss_scale > 0
                      else 2.0 ** c.initial_scale_power)
        return {"scale": float(init_scale), "good_steps": 0}

    def _scaler_update(self, scaler: Dict[str, Any], finite: bool
                       ) -> Dict[str, Any]:
        c = self.config.fp16
        if c.loss_scale > 0:                       # static scale
            return scaler
        good = scaler["good_steps"] + 1 if finite else 0
        grow = good >= c.loss_scale_window
        scale = scaler["scale"]
        if finite:
            scale = scale * 2.0 if grow else scale
        else:
            scale = max(scale / 2.0, c.min_loss_scale)
        return {"scale": scale, "good_steps": 0 if grow else good}

    # ---- data -----------------------------------------------------------
    def deepspeed_io(self, dataset, batch_size: Optional[int] = None,
                     collate_fn: Optional[Callable] = None,
                     **kw) -> DeepSpeedTpuDataLoader:
        """The engine data loader: micro-batches of
        ``train_micro_batch_size_per_gpu`` examples."""
        bs = batch_size or int(self.config.train_micro_batch_size_per_gpu)
        return DeepSpeedTpuDataLoader(dataset, bs, collate_fn=collate_fn,
                                      seed=self.config.seed, **kw)

    def _put_batch(self, batch):
        """Host batch (numpy arrays, tensors, in dicts/lists) -> tensors on
        the engine's device."""
        if isinstance(batch, dict):
            return {k: self._put_batch(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._put_batch(v) for v in batch)
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)

    # ---- train loop UX --------------------------------------------------
    def forward(self, batch, *args, **kwargs) -> torch.Tensor:
        """The micro-batch loss, with its graph (reference :681)."""
        self.tput_timer.start()
        if self._breakdown:
            self.wall_timers("fwd").start(synchronize=False)
        loss = self.module.loss_fn(self.params, self._put_batch(batch))
        self._pending = loss
        self._last_loss = loss.detach()
        if self._breakdown:
            # record=False: the per-micro-step records list is unbounded;
            # the gauge only needs elapsed(reset=True) at the boundary
            self.wall_timers("fwd").stop(record=False, synchronize=False)
        return loss

    __call__ = forward

    def backward(self, loss: Optional[torch.Tensor] = None, *args, **kwargs):
        """Add the gradients of ``loss * scale`` into the accumulation
        buffer (the leaves' ``.grad``; reference :711)."""
        if self._pending is None:
            raise RuntimeError("backward() called before forward()")
        loss = self._pending if loss is None else loss
        if self._breakdown:
            self.wall_timers("bwd").start(synchronize=False)
        (loss * self.scaler_state["scale"]).backward()
        self._pending = None
        self._grad_acc_count += 1
        self.micro_steps += 1
        if self._breakdown:
            self.wall_timers("bwd").stop(record=False, synchronize=False)
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._grad_acc_count >= int(
            self.config.gradient_accumulation_steps)

    @torch.no_grad()
    def _apply(self, ga: float) -> Tuple[torch.Tensor, bool]:
        """Unscale -> global norm -> (fp16) overflow skip + scaler update ->
        clip and update (the reference's ``apply_step``). Returns (norm of
        the unscaled gradients, skipped); clears the accumulation buffer."""
        denom = self.scaler_state["scale"] * ga
        grads = []
        for p in self._leaves:
            g = torch.zeros_like(p) if p.grad is None else p.grad
            p.grad = None
            grads.append(g.float().div_(denom))
        gnorm = global_norm(grads)
        if self.fp16_enabled:
            finite = bool(torch.isfinite(gnorm))
            self.scaler_state = self._scaler_update(self.scaler_state, finite)
            if not finite:
                return gnorm, True
        self.tx.update(self._leaves, grads, self.opt_state, norm=gnorm)
        return gnorm, False

    def step(self, *args, **kwargs) -> None:
        """Optimizer step at the GA boundary (reference :778)."""
        if not self.is_gradient_accumulation_boundary():
            return
        t0 = time.perf_counter()
        gnorm, skipped = self._apply(
            float(self.config.gradient_accumulation_steps))
        self._grad_acc_count = 0
        self._last_gnorm = gnorm
        # the imperative path only: the fused step buries the update in
        # one call, where only train/step_ms means something
        self._opt_ms = (time.perf_counter() - t0) * 1e3
        self._commit_step(skipped)
        self.tput_timer.stop(global_step=True, report_speed=True)

    def _commit_step(self, skipped: bool) -> None:
        if skipped:
            self.skipped_steps += 1
        else:
            self.global_steps += 1
            if self.lr_scheduler is not None:
                self.lr_scheduler.step()
        self.global_samples += int(self.config.train_batch_size)
        if self.global_steps and \
                self.global_steps % self.config.steps_per_print == 0:
            self._report_progress()
        if self._obs is not None:
            self._emit_train_metrics()

    def train_batch(self, data_iter: Optional[Iterable] = None) -> float:
        """One global batch: GA micro-steps, then the optimizer step; returns
        the mean loss (reference :910)."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("no data_iter and no training_data configured")
            data_iter = iter(self.training_dataloader)
        total = 0.0
        ga = int(self.config.gradient_accumulation_steps)
        for _ in range(ga):
            loss = self.forward(next(data_iter))
            self.backward(loss)
            total += float(loss.detach())
        self.step()
        return total / ga

    def fused_train_step(self, batch) -> torch.Tensor:
        """GA micro-steps and the update in one call: every array of
        ``batch`` has ``ga * micro`` rows, split into ``ga`` micro-batches
        in order. Returns the mean loss (reference :935)."""
        if self._grad_acc_count:
            raise RuntimeError("fused_train_step inside an open gradient-"
                               "accumulation window (call step() first)")
        ga = int(self.config.gradient_accumulation_steps)
        batch = self._put_batch(batch)
        rows = {v.shape[0] for v in batch.values()}
        if len(rows) != 1 or next(iter(rows)) % ga:
            raise ValueError(f"fused_train_step: leading dims {sorted(rows)} "
                             f"must agree and divide by ga={ga}")
        scale = self.scaler_state["scale"]
        losses = []
        for i in range(ga):
            mb = {k: v.chunk(ga)[i] for k, v in batch.items()}
            loss = self.module.loss_fn(self.params, mb)
            (loss * scale).backward()
            losses.append(loss.detach())
        loss = torch.stack(losses).mean()
        gnorm, skipped = self._apply(float(ga))
        self._last_loss, self._last_gnorm = loss, gnorm
        self._commit_step(skipped)
        return loss

    # ---- introspection (reference public getters) -----------------------
    def get_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_last_lr()
        lr = (self.config.optimizer.params.get("lr", 0.0)
              if self.config.optimizer else 0.0)
        return [lr]

    def get_global_grad_norm(self) -> Optional[float]:
        return None if self._last_gnorm is None else float(self._last_gnorm)

    def gradient_accumulation_steps(self) -> int:
        return int(self.config.gradient_accumulation_steps)

    def train_micro_batch_size_per_gpu(self) -> int:
        return int(self.config.train_micro_batch_size_per_gpu)

    def train_batch_size(self) -> int:
        return int(self.config.train_batch_size)

    def get_model(self):
        return self.module

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    # ---- observability surface (the reference's :1165-1330) -------------
    def _configure_observability(self, config) -> None:
        """Registry gauges for the per-step breakdown, the optional
        ``/metrics`` server and the profile trigger. With
        ``observability.enabled`` a step costs a handful of host float ops;
        the breakdown timers are opt-in and never synchronise the device
        (host timestamps bound the launches; the loss read that
        ``train_batch`` already makes stays the only sync)."""
        from deepspeed_tpu_torch.comm.logger import comms_logger
        from deepspeed_tpu_torch.observability.events import get_bus
        from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer

        ocfg = config.observability
        self.wall_timers = SynchronizedWallClockTimer(self.device)
        self._ebus = get_bus()
        self._obs = None
        self._obs_server = None
        self._profile_trigger = None
        self._breakdown = bool(ocfg.enabled and (
            ocfg.train_breakdown or config.wall_clock_breakdown))
        self._opt_ms: Optional[float] = None
        self._last_commit_t: Optional[float] = None
        # baseline now, not 0: the comms logger is a process singleton, and
        # latency recorded before this engine existed must not land in the
        # first step's delta
        self._comm_lat_base = comms_logger.total_latency_s()
        if ocfg.tracing.enabled:
            # causal event tracing + flight recorder, applied to the process
            # bus in place, so every seam built before starts emitting
            from deepspeed_tpu_torch.observability import configure_tracing

            configure_tracing(ocfg.tracing)
        if not ocfg.enabled:
            return
        from deepspeed_tpu_torch.observability import (ObservabilityServer,
                                                       ProfileTrigger,
                                                       get_registry)
        from deepspeed_tpu_torch.utils.logging import _process_index

        g = get_registry().gauge
        self._obs = {
            "step_ms": g("train/step_ms", "wall clock between step commits"),
            "fwd_ms": g("train/fwd_ms", "forward (breakdown mode)"),
            "bwd_ms": g("train/bwd_ms", "backward (breakdown mode)"),
            "optimizer_ms": g("train/optimizer_ms", "optimizer apply"),
            "comm_ms": g("train/comm_ms",
                         "eager host-collective time this step"),
            "checkpoint_ms": g("train/checkpoint_ms",
                               "last checkpoint save wall clock"),
            "loss": g("train/loss", "last reported loss"),
            "lr": g("train/lr", "current learning rate"),
            "steps": g("train/steps", "global optimizer steps"),
            "samples": g("train/samples", "global samples consumed"),
            "skipped_steps": g("train/skipped_steps",
                               "overflow/guard-skipped steps"),
        }
        if ocfg.profile.enabled:
            self._profile_trigger = ProfileTrigger.from_config(ocfg.profile)
            if ocfg.profile.signal_enabled:
                self._profile_trigger.install_signal_handler()
        if ocfg.http_server and _process_index() == 0:
            self._obs_server = ObservabilityServer(
                get_registry(), host=ocfg.http_host,
                port=ocfg.http_port).start()

    def _emit_train_metrics(self) -> None:
        """Per-commit registry update from host values; the one device read,
        ``float(loss)``, happens at ``steps_per_print`` where
        ``_report_progress`` already pays it."""
        from deepspeed_tpu_torch.comm.logger import comms_logger

        o = self._obs
        now = time.perf_counter()
        if self._last_commit_t is not None:
            o["step_ms"].set((now - self._last_commit_t) * 1e3)
        self._last_commit_t = now
        o["steps"].set(float(self.global_steps))
        o["samples"].set(float(self.global_samples))
        o["skipped_steps"].set(float(self.skipped_steps))
        if self._ebus.enabled:
            # one instant per committed step: the training heartbeat the
            # flight recorder shows around an abort (host clock only)
            self._ebus.instant("train", "step",
                               args={"step": int(self.global_steps)})
        if self._opt_ms is not None:
            o["optimizer_ms"].set(self._opt_ms)
            self._opt_ms = None
        if self._breakdown:
            for timer, key in (("fwd", "fwd_ms"), ("bwd", "bwd_ms")):
                if self.wall_timers.has(timer):
                    o[key].set(self.wall_timers(timer).elapsed(reset=True)
                               * 1e3)
        lat = comms_logger.total_latency_s()
        # a comms_logger.reset() mid-run rewinds the total below the base;
        # rebase instead of reporting a negative step delta
        o["comm_ms"].set(max(0.0, lat - self._comm_lat_base) * 1e3)
        self._comm_lat_base = lat
        if self.global_steps and \
                self.global_steps % self.config.steps_per_print == 0:
            if self._last_loss is not None:
                o["loss"].set(float(self._last_loss))
            o["lr"].set(float(self.get_lr()[0]))
        if self._profile_trigger is not None:
            self._profile_trigger.check(self.global_steps)

    def observability_report(self) -> Dict[str, Any]:
        """One-call snapshot of the observability surface itself."""
        from deepspeed_tpu_torch.observability import get_registry

        return {
            "enabled": self._obs is not None,
            "breakdown": self._breakdown,
            "metrics_url": (self._obs_server.url
                            if self._obs_server is not None else None),
            "profile": (self._profile_trigger.report()
                        if self._profile_trigger is not None else None),
            "families": sorted(f.name for f in get_registry().collect()),
        }

    def shutdown(self) -> None:
        """Stop an in-flight profile capture and the ``/metrics`` server.
        Idempotent."""
        if self._profile_trigger is not None:
            self._profile_trigger.close()
        if self._obs_server is not None:
            self._obs_server.close()
            self._obs_server = None

    def _report_progress(self) -> None:
        loss = None if self._last_loss is None else float(self._last_loss)
        logger.info("step=%d loss=%s lr=%.3e grad_norm=%s scale=%.0f "
                    "skipped=%d", self.global_steps, loss, self.get_lr()[0],
                    self.get_global_grad_norm(), self.scaler_state["scale"],
                    self.skipped_steps)
