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

* Checkpoints (the reference's :1127-1163): ``save_checkpoint`` /
  ``load_checkpoint`` through ``runtime/checkpoint.py`` -- or, under
  ``resilience.enabled``, through a per-directory ``CheckpointManager``
  (manifest, verification with fallback, keep-last-K, retried IO, the
  SIGTERM emergency save) -- and the ``train/checkpoint_ms`` gauge.
* Data efficiency and progressive layer drop (the reference's :212-275,
  :582-662): the curriculum truncates each batch's sequence keys to its
  difficulty; random-LTD's kept-token count grows with the step (updated
  at accumulation boundaries); PLD's theta rides the batch (gated mode) or
  sets the model's static depth (``compiled_tiers``). Each batch carries
  the step seed ``ltd_seed`` and ``pld_theta`` as host tensors, so the
  model reads them with no device sync. The reference rebuilds its jitted
  programs after a bucket or tier change; the port has nothing to
  rebuild.
* Resilience (the reference's :278-350, :1333-1590): under
  ``resilience.enabled`` the ``StepGuard`` checks each step before the
  update (a non-finite loss or gradient skips it whole), the coordinator
  decides CONTINUE / SAVE / ABORT at each boundary, the heartbeat and hang
  watchdog threads run when configured, ``DSTPU_CHECKPOINT_DIR`` arms the
  preemption handler, and ``resilience_report()`` gathers every counter
  (into the registry's ``resilience/*`` gauges at ``steps_per_print``).
  ``sanity_checks`` runs ``runtime/sanity.py`` at construction and on the
  first batch.

* Offload (the reference's :171-183, :732-815, :1051): with
  ``zero_optimization.offload_optimizer.device`` ``cpu`` or ``nvme`` the
  update runs in ``offload/optimizer.py``'s ``HostOffloadOptimizer``: the
  fp32 masters and Adam moments live on the host (the moments on disk for
  ``nvme``), the device keeps its params and grads and an empty
  ``opt_state``, and each step copies the grads out and the updated params
  back. ``zenflow.overlap_step`` runs that host step in the background,
  collected at the next boundary (and before a save, a load, an emergency
  save and ``shutdown``); ``zenflow.topk_ratio`` selects
  ``ZenFlowSelectiveOptimizer``. ``offload_report()`` reads the data path.

One device: params, grads and optimizer state stay whole on it, so ZeRO
stages 0-3 compute the same step, as they do in the reference on a
one-device mesh. Monitor (and so the registry-to-monitor bridge), 1-bit
optimizers and ZeRO++ are not in this slice.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.config import DeepSpeedTpuConfig
from deepspeed_tpu_torch.models.spec import tree_leaves
from deepspeed_tpu_torch.runtime.checkpoint import flatten_tree
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedTpuDataLoader
from deepspeed_tpu_torch.runtime.lr_schedules import (LRSchedulerShim,
                                                      build_schedule)
from deepspeed_tpu_torch.runtime.optimizers import (ONE_BIT, build_optimizer,
                                                    global_norm)
from deepspeed_tpu_torch.utils import resolve_device
from deepspeed_tpu_torch.utils.timer import ThroughputTimer

logger = logging.getLogger("deepspeed_tpu_torch")


def _own_params(tree, device: torch.device):
    """The engine's own copy of a parameter tree (tensors or numpy arrays)
    on ``device``: contiguous leaves, floating ones requiring grad. Keys in
    sorted order, as JAX flattens a dict: the leaf order (and so the global
    norm's summation order) is the same whatever order the tree came in,
    so a checkpoint resumes bit for bit into any engine of the model."""
    if isinstance(tree, dict):
        return {k: _own_params(tree[k], device) for k in sorted(tree)}
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
        if getattr(model, "cfg", None) is not None and (
                policy != "none" or config.data_efficiency.enabled
                or config.progressive_layer_drop.enabled):
            # the config's remat policy applies to the model's layers, and
            # random-LTD / PLD set the model's state; the caller's model
            # object is left as it was
            model = copy.copy(model)
            if policy != "none":
                model.cfg = dataclasses.replace(model.cfg,
                                                remat_policy=policy)
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
        zcfg = config.zero_optimization
        off = zcfg.offload_optimizer
        offload = off is not None and off.device in ("cpu", "nvme")
        if zcfg.zenflow is not None and not offload:
            raise ValueError(
                "zero_optimization.zenflow requires offload_optimizer "
                "(device cpu|nvme) — there is no host step to overlap")
        if offload and opt_cfg is not None and opt_cfg.type.lower().replace(
                "_", "") in ONE_BIT:
            raise ValueError("1-bit optimizers do not compose with "
                             "offload_optimizer")
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
        self._offload = None
        if offload:
            # the optimizer state lives on the host: none on the device
            self.opt_state = {}
            self._configure_offload_optimizer(off, schedule_fn)
        else:
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
        self._configure_data_efficiency(config)
        self._pending_ckpt = None      # an in-flight async save
        self._configure_resilience(config.resilience)
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data,
                                                         collate_fn=collate_fn)
        self._first_batch_checked = not (config.sanity_checks
                                         and config.sanity_check_batches)
        if config.sanity_checks:
            from deepspeed_tpu_torch.runtime.sanity import run_startup_checks

            run_startup_checks(self)
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

    # ---- data efficiency and PLD (the reference's :212-275, :582-662) -----
    def _configure_data_efficiency(self, config) -> None:
        de = config.data_efficiency
        self._curriculum = None
        self._ltd_cfg = None
        if de.enabled and de.data_sampling.enabled \
                and de.data_sampling.curriculum_learning.enabled:
            from deepspeed_tpu_torch.runtime.data_pipeline import (
                CurriculumScheduler)

            self._curriculum = CurriculumScheduler(
                de.data_sampling.curriculum_learning.model_dump())
            # the reference bounds the distinct difficulties because each
            # is a fresh compile there; the port compiles nothing per shape
            # but keeps the bound as a contract of the config
            n_buckets = (self._curriculum.max_difficulty
                         - self._curriculum.min_difficulty) \
                // max(self._curriculum.difficulty_step, 1) + 1
            if n_buckets > 64:
                raise ValueError(
                    f"curriculum_learning would create {n_buckets} distinct "
                    "sequence-length buckets; raise schedule_config."
                    "difficulty_step so (max_difficulty - min_difficulty) / "
                    "difficulty_step <= 64")
        if de.enabled and de.data_routing.enabled \
                and de.data_routing.random_ltd.enabled:
            self._ltd_cfg = de.data_routing.random_ltd
            if not hasattr(self.module, "set_random_ltd"):
                raise ValueError("random_ltd requires a model with "
                                 "set_random_ltd (TransformerLM family)")
            self._update_random_ltd()
        self._pld = None
        self._pld_tiers = 0
        pcfg = config.progressive_layer_drop
        if not pcfg.enabled:
            return
        if self._ltd_cfg is not None:
            raise ValueError("progressive_layer_drop and random_ltd both "
                             "rewrite the layer loop; enable one")
        from deepspeed_tpu_torch.runtime.progressive_layer_drop import (
            ProgressiveLayerDrop)

        self._pld = ProgressiveLayerDrop(theta=pcfg.theta, gamma=pcfg.gamma)
        self._pld_tiers = int(pcfg.compiled_tiers)
        if self._pld_tiers > 0:
            if getattr(getattr(self.module, "cfg", None),
                       "window_start_layer", 0):
                raise NotImplementedError(
                    "progressive_layer_drop.compiled_tiers does not support "
                    "mixed-window models (window_start_layer > 0)")
            wd = float((config.optimizer.params or {}).get(
                "weight_decay", 0.0)) if config.optimizer else 0.0
            if wd > 0.0:
                # the dropped tail layers get no gradients, but decoupled
                # decay would keep shrinking them every step
                raise ValueError(
                    "progressive_layer_drop.compiled_tiers requires "
                    "weight_decay=0: the statically-dropped tail layers "
                    "receive no gradients but decoupled decay would keep "
                    "shrinking them every step")

    def _update_random_ltd(self) -> None:
        """Random-LTD's kept-token count: from ``min_value``, +``step_size``
        every ``interval`` steps, clamped at ``max_value`` (0: the model's
        ``max_seq_len``)."""
        c = self._ltd_cfg
        ceil = c.max_value or getattr(self.module.cfg, "max_seq_len", 1 << 30)
        keep = min(ceil, c.min_value
                   + c.step_size * (self.global_steps // max(c.interval, 1)))
        if keep != self.module._ltd_keep:
            self.module.set_random_ltd(
                keep, (c.random_ltd_layer_start, c.random_ltd_layer_end))

    def curriculum_difficulty(self) -> Optional[int]:
        if self._curriculum is None:
            return None
        return self._curriculum.update_difficulty(self.global_steps)

    def _apply_curriculum(self, batch):
        """Truncate the sequence keys to the curriculum's difficulty."""
        if self._curriculum is None or not isinstance(batch, dict):
            return batch
        diff = self.curriculum_difficulty()
        out = {}
        for k, v in batch.items():
            arr = v if isinstance(v, torch.Tensor) else np.asarray(v)
            if arr.ndim >= 2 and arr.shape[1] > diff and k in (
                    "input_ids", "labels", "attention_mask", "position_ids"):
                arr = arr[:, :diff]
            out[k] = arr
        return out

    def _inject_ltd_seed(self, batch):
        """The per-step routing inputs, one per example: the random-LTD /
        PLD step seed and (gated PLD) theta. In PLD's compiled-tiers mode
        theta sets the model's depth instead (:meth:`_update_pld_depth`)."""
        if (self._ltd_cfg is None and self._pld is None) \
                or not isinstance(batch, dict):
            return batch
        if self._pld is not None and self._pld_tiers > 0:
            self._update_pld_depth()
            return batch
        b = batch["input_ids"].shape[0]
        out = {**batch, "ltd_seed": np.full((b,), self.global_steps
                                            + self.micro_steps, np.int32)}
        if self._pld is not None:
            self._pld.update_state(self.global_steps)
            out["pld_theta"] = np.full((b,), self._pld.get_theta(),
                                       np.float32)
        return out

    def _update_pld_depth(self) -> None:
        """PLD's static depth in compiled-tiers mode: theta's expected
        kept-layer count on the tier grid."""
        from deepspeed_tpu_torch.runtime.progressive_layer_drop import (
            active_layers)

        if not hasattr(self.module, "set_pld_depth"):
            raise NotImplementedError(
                "progressive_layer_drop.compiled_tiers requires a "
                "TransformerLM module")
        self._pld.update_state(self.global_steps)
        k = active_layers(self._pld.get_theta(), self.module.cfg.num_layers,
                          self._pld_tiers, theta_min=self._pld.theta)
        if k != self.module._pld_depth:
            self.module.set_pld_depth(k)

    #: batch keys the model reads on the host (no device sync)
    _HOST_KEYS = ("ltd_seed", "pld_theta")

    def _put_batch(self, batch):
        """Host batch (numpy arrays, tensors, in dicts/lists) -> tensors on
        the engine's device (the routing keys stay host tensors)."""
        if isinstance(batch, dict):
            return {k: (torch.as_tensor(v) if k in self._HOST_KEYS
                        else self._put_batch(v)) for k, v in batch.items()}
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
        if self._ltd_cfg is not None and self._grad_acc_count == 0:
            self._update_random_ltd()   # only at accumulation boundaries
        batch = self._inject_ltd_seed(self._apply_curriculum(batch))
        if not self._first_batch_checked:
            from deepspeed_tpu_torch.runtime.sanity import (
                check_batch_consistency)

            check_batch_consistency(batch)  # engine.py:641 broadcast check
            self._first_batch_checked = True
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

    def _take_grads(self, ga: float):
        """The accumulated gradients, unscaled by ``scale * ga``, in leaf
        order; clears the accumulation buffer (the leaves' ``.grad``)."""
        denom = self.scaler_state["scale"] * ga
        grads = []
        for p in self._leaves:
            g = torch.zeros_like(p) if p.grad is None else p.grad
            p.grad = None
            grads.append(g.float().div_(denom))
        return grads

    @torch.no_grad()
    def _apply(self, ga: float) -> Tuple[torch.Tensor, bool]:
        """Unscale -> global norm -> (fp16) overflow skip + scaler update ->
        clip and update (the reference's ``apply_step``). Returns (norm of
        the unscaled gradients, skipped); clears the accumulation buffer."""
        grads = self._take_grads(ga)
        if self._offload is not None:
            return self._offload_apply(grads)
        gnorm = global_norm(grads)
        if self.fp16_enabled:
            finite = bool(torch.isfinite(gnorm))
            self.scaler_state = self._scaler_update(self.scaler_state, finite)
            if not finite:
                return gnorm, True
        self.tx.update(self._leaves, grads, self.opt_state, norm=gnorm)
        return gnorm, False

    # ---- offload (the reference's :732-815, :844) ------------------------
    def _configure_offload_optimizer(self, off, schedule_fn) -> None:
        """ZeRO-Offload / Infinity: the host optimizer over this engine's
        params; ``zero_optimization.zenflow`` turns on the overlapped step
        or the selective split."""
        from deepspeed_tpu_torch.offload import (HostOffloadOptimizer,
                                                 ZenFlowSelectiveOptimizer)

        zf = self.config.zero_optimization.zenflow
        overlap = bool(zf is not None and zf.overlap_step)
        selective = bool(zf is not None and zf.topk_ratio > 0)
        if (overlap or selective) and self.fp16_enabled:
            raise NotImplementedError(
                "zenflow needs the overflow-skip decision at step "
                "time; it does not compose with fp16 dynamic loss scaling "
                "(use bf16)")
        p = dict(self.config.optimizer.params) if self.config.optimizer else {}
        aio = self.config.offload.aio
        common = dict(
            lr=p.get("lr", 1e-3), betas=tuple(p.get("betas", (0.9, 0.999))),
            eps=p.get("eps", 1e-8), weight_decay=p.get("weight_decay", 0.0),
            gradient_clipping=self.config.gradient_clipping,
            schedule_fn=schedule_fn,
            nvme_path=off.nvme_path if off.device == "nvme" else None,
            # offload.aio owns how bytes move; 0 threads falls back to the
            # autotuner (when on) or offload_optimizer.buffer_count
            aio_threads=(aio.threads if aio.threads > 0
                         else (0 if aio.autotune else off.buffer_count)),
            aio_chunk_mb=aio.chunk_mb,
            prefetch_depth=aio.prefetch_depth,
            aio_autotune=aio.autotune,
            aio_autotune_cache=aio.autotune_cache,
            aio_o_direct=aio.o_direct,
            upload_overlap=aio.upload_overlap)
        if selective:
            self._offload = ZenFlowSelectiveOptimizer(
                self.params, topk_ratio=zf.topk_ratio,
                select_interval=zf.resolved_select_interval(),
                update_interval=zf.resolved_update_interval(),
                full_warm_up_rounds=zf.full_warm_up_rounds, **common)
        else:
            self._offload = HostOffloadOptimizer(
                self.params, overlap_step=overlap, **common)

    def _offload_apply(self, grads) -> Tuple[float, bool]:
        """The host step on the unscaled gradients (leaf order). With
        ``overlap_step`` the previous async step is collected first, this
        one is launched, and the previous step's norm is reported (its
        skip decision lags one step by design: ZenFlow's bounded
        staleness)."""
        off = self._offload
        named = dict(zip(flatten_tree(self.params), grads))
        if off.overlap:
            self._collect_offload()
            # read before launching: the worker overwrites _last_gnorm
            gnorm_prev = off._last_gnorm
            off.step_async(named, self.params, self.global_steps)
            return gnorm_prev, False
        _, skipped = off.step(named, self.params, self.global_steps)
        if self.fp16_enabled:
            self.scaler_state = self._scaler_update(self.scaler_state,
                                                    not skipped)
        return off._last_gnorm, skipped

    def _collect_offload(self) -> None:
        """Apply the previous async offload step's params (ZenFlow overlap:
        the host Adam of step N-1 ran during step N's forward and
        backward)."""
        prev = self._offload.finish_pending()
        if prev is not None and prev[1]:
            # the launch-time commit counted this as a successful step;
            # restate it as skipped so the counters match the synchronous
            # path (the one LR-schedule tick it took is not unwound)
            self.skipped_steps += 1
            self.global_steps = max(0, self.global_steps - 1)

    def _drain_offload(self) -> None:
        if self._offload is not None and self._offload.overlap:
            self._collect_offload()

    def offload_report(self) -> Dict[str, Any]:
        """The offload data path in one call: tier layout, pipeline depth
        and overlap flags, the last step's grad-copy, Adam and upload
        times, the stall fraction and the swapper's counters."""
        if self._offload is None:
            return {"enabled": False}
        return {"enabled": True, **self._offload.report()}

    def step(self, *args, **kwargs) -> None:
        """Optimizer step at the GA boundary (reference :778)."""
        if not self.is_gradient_accumulation_boundary():
            return
        # self-healing guard: fires configured faults, then skips (instead
        # of applying) a step whose loss/grads are non-finite
        if self._guard is not None and self._guard.intercept():
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

    def _skip_step(self, gnorm) -> None:
        """The guard's skip: drop the accumulated gradients and commit the
        step as skipped (no update, no LR tick)."""
        for p in self._leaves:
            p.grad = None
        self._grad_acc_count = 0
        self._last_gnorm = gnorm
        self._commit_step(True)
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
            if self._resilience_enabled() and self.global_steps and \
                    self.global_steps % self.config.steps_per_print == 0:
                self._emit_resilience_metrics()
        if self._heartbeat is not None:
            self._heartbeat.notify_step(self.global_steps)
        self._resilience_step_boundary()

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
        if self._ltd_cfg is not None:
            self._update_random_ltd()
        batch = self._inject_ltd_seed(self._apply_curriculum(batch))
        if self._guard is not None:
            self._guard.pre_step()  # crash faults fire on the fused path too
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
            if "ltd_seed" in mb:
                # each micro-batch draws its own tokens / layers (the
                # reference folds the batch's token sum into its key)
                mb["ltd_seed"] = mb["ltd_seed"] + i
            loss = self.module.loss_fn(self.params, mb)
            (loss * scale).backward()
            losses.append(loss.detach())
        loss = torch.stack(losses).mean()
        gnorm, skipped = self._apply(float(ga))
        self._last_loss, self._last_gnorm = loss, gnorm
        self._commit_step(skipped)
        if self._guard is not None:
            # post-hoc: the update already ran, so a bad step is detected
            # (and escalated past the budget) rather than unwound
            self._guard.check_loss(loss)
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

    # ---- checkpoints (delegates to runtime/checkpoint.py) ----------------
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None, **kw) -> None:
        """Write a tagged checkpoint (reference :1129). Under
        ``resilience.enabled`` through the directory's checkpoint manager.
        ``train/checkpoint_ms`` reads the call's wall time: an async save
        reports its stage (the device-to-host copy) here, its commit in
        ``resilience/ckpt_save_ms``."""
        from deepspeed_tpu_torch.runtime.checkpoint import save_checkpoint

        self._drain_offload()  # the async step lands before the snapshot
        t0 = time.perf_counter()
        if self._resilience_enabled():
            self._resilience_manager(save_dir).save(
                self, tag=tag, client_state=client_state or {})
        else:
            save_checkpoint(self, save_dir, tag=tag,
                            client_state=client_state or {})
        if self._obs is not None:
            self._obs["checkpoint_ms"].set((time.perf_counter() - t0) * 1e3)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True, **kw):
        """Restore a checkpoint into this engine's tensors on its device
        (reference :1147); returns ``(path, client_state)``."""
        from deepspeed_tpu_torch.runtime.checkpoint import load_checkpoint

        self._drain_offload()
        if self._resilience_enabled():
            return self._resilience_manager(load_dir).load(
                self, tag=tag, load_optimizer_states=load_optimizer_states)
        return load_checkpoint(self, load_dir, tag=tag,
                               load_optimizer_states=load_optimizer_states)

    # ---- resilience surface (the reference's :278-350, :1333-1590) -------
    def _configure_resilience(self, rcfg) -> None:
        """The guard, the coordinator, the heartbeat and watchdog threads,
        and (with ``DSTPU_CHECKPOINT_DIR``) the preemption handler."""
        self._guard = None
        self._coordinator = None
        self._heartbeat = None
        self._watchdog = None
        self._ckpt_managers: Dict[str, Any] = {}
        self._primary_mgr = None
        self._resilience_report_dir = os.environ.get("DSTPU_CHECKPOINT_DIR")
        if not rcfg.enabled:
            return
        from deepspeed_tpu_torch.resilience import (FaultInjector,
                                                    ResilienceCoordinator,
                                                    StepGuard, set_injector)

        if rcfg.faults:
            set_injector(FaultInjector(rcfg.faults))
        self._guard = StepGuard(
            self, max_consecutive_bad_steps=rcfg.max_consecutive_bad_steps)
        if rcfg.coordination.enabled:
            self._coordinator = ResilienceCoordinator(
                interval_steps=rcfg.coordination.interval_steps)
        hb = rcfg.heartbeat
        if hb.enabled:
            from deepspeed_tpu_torch.resilience import HangWatchdog, Heartbeat

            if hb.on_hang == "abort" and self._coordinator is None:
                # the default escalation routes through the coordinated
                # decide; without it the watchdog would detect and then do
                # nothing -- the exact wedge it exists to prevent
                raise ValueError(
                    "resilience.heartbeat.on_hang='abort' requires "
                    "resilience.coordination.enabled; use on_hang="
                    "'exit' (hard wedges) or 'report' instead")
            hb_dir = hb.dir
            if hb_dir is None and self._resilience_report_dir:
                hb_dir = os.path.join(self._resilience_report_dir,
                                      "heartbeats")
            if hb_dir is None:
                import tempfile

                hb_dir = os.path.join(tempfile.gettempdir(),
                                      f"dstpu_heartbeats_{os.getpid()}")
                logger.warning(
                    "resilience.heartbeat.dir is unset and no checkpoint "
                    "dir is known; writing heartbeats to %s -- peer "
                    "straggler classification needs a shared directory "
                    "(set heartbeat.dir or DSTPU_CHECKPOINT_DIR)", hb_dir)
            self._heartbeat = Heartbeat(hb_dir,
                                        interval_s=hb.interval_s).start()
            self._watchdog = HangWatchdog(
                self._heartbeat, deadline_s=hb.deadline_s,
                collective_deadline_s=hb.collective_deadline_s,
                poll_s=hb.poll_s, coordinator=self._coordinator,
                on_hang=hb.on_hang, exit_code=hb.exit_code).start()
        if self._resilience_report_dir:
            # launched with a checkpoint dir: arm the preemption handler
            # against it right away
            self._resilience_manager(self._resilience_report_dir)

    def _resilience_enabled(self) -> bool:
        return bool(self.config.resilience.enabled)

    def _resilience_manager(self, ckpt_dir: str):
        """One CheckpointManager per checkpoint directory; the first
        becomes the preemption-save target."""
        from deepspeed_tpu_torch.resilience import (CheckpointManager,
                                                    RetryPolicy)

        key = os.path.abspath(ckpt_dir)
        mgr = self._ckpt_managers.get(key)
        if mgr is None:
            rc = self.config.resilience
            mgr = CheckpointManager(
                ckpt_dir, keep_last_k=rc.checkpoint.keep_last_k,
                verify=rc.checkpoint.verify,
                retry_policy=RetryPolicy(**dataclasses.asdict(rc.retry)),
                async_save=rc.checkpoint.async_save)
            if rc.checkpoint.save_on_preempt:
                mgr.install_preemption_handler()
            self._ckpt_managers[key] = mgr
            if self._primary_mgr is None:
                self._primary_mgr = mgr
            if not self._resilience_report_dir:
                self._resilience_report_dir = key
        return mgr

    def _resilience_step_boundary(self) -> None:
        """Fold local signals into this boundary's decision. With
        coordination on (the default under ``resilience.enabled``) a
        SIGTERM, the guard's budget and a watchdog hang become votes, and
        the agreed code acts; with it off, an armed preemption saves
        locally."""
        mgr, guard = self._primary_mgr, self._guard
        if self._coordinator is None:
            if mgr is not None and mgr.preempted:
                self._drain_offload()
                mgr.maybe_emergency_save(self)
                rc = self.config.resilience.checkpoint
                if rc.exit_on_preempt:
                    raise SystemExit(rc.preempt_exit_code)
            return
        from deepspeed_tpu_torch.resilience.coordinator import (ABORT,
                                                                CONTINUE,
                                                                SAVE)

        local, reason = CONTINUE, ""
        if mgr is not None and mgr.preempted:
            local, reason = SAVE, "preemption notice (SIGTERM)"
        if guard is not None and \
                guard.consecutive_bad >= guard.max_consecutive_bad_steps:
            local, reason = ABORT, (f"{guard.consecutive_bad} consecutive "
                                    "non-finite steps")
        decision = self._coordinator.decide(self.global_steps, local, reason)
        if decision == SAVE:
            self._coordinated_emergency_save()
        elif decision == ABORT:
            self._coordinated_abort()

    def _set_decision_gauge(self, code: int) -> None:
        if self._obs is not None:
            from deepspeed_tpu_torch.observability import get_registry

            get_registry().gauge("resilience/decision",
                                 "last non-CONTINUE decision").set(
                                     float(code))

    def _coordinated_emergency_save(self) -> None:
        """Commit the emergency tag of this boundary."""
        from deepspeed_tpu_torch.observability import flight_dump
        from deepspeed_tpu_torch.resilience.coordinator import SAVE

        coord = self._coordinator
        mgr = self._primary_mgr
        if mgr is None and self._resilience_report_dir:
            mgr = self._resilience_manager(self._resilience_report_dir)
        if mgr is None:
            logger.error("SAVE agreed but no checkpoint dir is known (set "
                         "DSTPU_CHECKPOINT_DIR or save once first); "
                         "skipping the emergency save")
            return
        # the boundary is the consistent point, but an overlapped offload
        # step may still be in flight: drain it so the snapshot matches
        # global_steps
        self._drain_offload()
        mgr.preempted = False  # consumed, signaled here or not
        tag = f"preempt_step{self.global_steps}"
        path = mgr.save(self, tag=tag, emergency=True,
                        decision=coord.decision_record())
        flight_dump("emergency_save",
                    extra={"tag": tag, "path": path,
                           "decision": coord.decision_record()},
                    key=f"emergency-{tag}")
        logger.warning("coordinated emergency checkpoint saved to %s", path)
        self._set_decision_gauge(SAVE)
        rc = self.config.resilience.checkpoint
        if rc.exit_on_preempt:
            raise SystemExit(rc.preempt_exit_code)

    def _coordinated_abort(self) -> None:
        """Abort at this boundary: the guard's own abort when its budget is
        the cause, else write the report and raise ``CoordinatedAbort``."""
        from deepspeed_tpu_torch.observability import flight_dump
        from deepspeed_tpu_torch.resilience.coordinator import (
            ABORT, CoordinatedAbort)

        coord, guard = self._coordinator, self._guard
        reason = coord.last_reason or "peer abort"
        self._set_decision_gauge(ABORT)
        if guard is not None and \
                guard.consecutive_bad >= guard.max_consecutive_bad_steps:
            guard.abort(reason)
        if self._resilience_report_dir:
            try:
                self.write_resilience_report(self._resilience_report_dir)
            except OSError as e:
                logger.error("could not write resilience report: %s", e)
        flight_dump("coordinated_abort",
                    extra={"step": int(self.global_steps),
                           "reason": reason},
                    key=f"abort-step{int(self.global_steps)}")
        logger.error("coordinated abort: %s", reason)
        raise CoordinatedAbort(reason)

    def _resilience_events(self):
        """The reference's ``resilience/*`` stream: one value per counter
        the report exposes, as ``(name, value)``."""
        events = [("resilience/skipped_steps", float(self.skipped_steps)),
                  ("resilience/comm_retries", 0.0)]
        if self._guard is not None:
            events += [
                ("resilience/guard_bad_steps_skipped",
                 float(self._guard.counters["bad_steps_skipped"])),
                ("resilience/guard_consecutive_bad",
                 float(self._guard.consecutive_bad))]
        agg: Dict[str, float] = {}
        for mgr in self._ckpt_managers.values():
            for k, v in mgr.counters.items():
                agg[k] = agg.get(k, 0) + v
            if mgr.async_stats["commits"]:
                events.append(("resilience/async_save_latency_s",
                               float(mgr.async_stats["last_latency_s"])))
        for k in ("emergency_saves", "verify_failures", "load_fallbacks",
                  "gc_removed", "io_retries", "async_saves",
                  "async_commit_failures"):
            if k in agg:
                events.append((f"resilience/ckpt_{k}", float(agg[k])))
        if self._coordinator is not None:
            c = self._coordinator.counters
            events += [("resilience/decisions_save",
                        float(c["saves_agreed"])),
                       ("resilience/decisions_abort",
                        float(c["aborts_agreed"]))]
        if self._watchdog is not None:
            w = self._watchdog.counters
            events += [("resilience/hangs_detected",
                        float(w["hangs_detected"])),
                       ("resilience/heartbeat_max_peer_gap_s",
                        float(w["max_peer_gap_s"]))]
        if self._heartbeat is not None:
            events.append(("resilience/heartbeat_step_age_s",
                           float(self._heartbeat.step_age_s())))
        return events

    def _emit_resilience_metrics(self) -> None:
        """``resilience/*`` into the registry's gauges (the port has no
        monitor: the reference writes the same values as monitor events)."""
        from deepspeed_tpu_torch.observability import get_registry

        g = get_registry().gauge
        for name, value in self._resilience_events():
            g(name, "resilience counter").set(value)

    def resilience_report(self) -> Dict[str, Any]:
        """The whole recovery picture in one call: guard skips and aborts,
        checkpoint verification failures, fallbacks and GC, async-save
        commit stats, coordination decisions, heartbeat and hang counters,
        faults fired. ``comm`` reads no retries and nothing in flight: the
        port runs no host collective on one device."""
        from deepspeed_tpu_torch.resilience.faults import get_injector

        ckpt: Dict[str, int] = {}
        async_stats = {"commits": 0, "last_latency_s": 0.0,
                       "total_latency_s": 0.0}
        for mgr in self._ckpt_managers.values():
            for k, v in mgr.counters.items():
                ckpt[k] = ckpt.get(k, 0) + v
            for k, v in mgr.async_stats.items():
                async_stats[k] = (max(async_stats[k], v)
                                  if k == "last_latency_s"
                                  else async_stats[k] + v)
        guard = self._guard
        aborted = bool(guard.counters["aborts"]) if guard else False
        coord = self._coordinator
        if coord is not None:
            aborted = aborted or bool(coord.counters["aborts_agreed"])
        return {
            "schema": 2,
            "global_steps": self.global_steps,
            "skipped_steps": self.skipped_steps,
            "guard": dict(guard.counters) if guard is not None else {},
            "consecutive_bad_steps": (guard.consecutive_bad
                                      if guard is not None else 0),
            "aborted": aborted,
            "checkpoint": ckpt,
            "checkpoint_async": async_stats,
            "comm": {"retries": 0, "inflight": None},
            "coordination": coord.report() if coord is not None else {},
            "heartbeat": (self._watchdog.report()
                          if self._watchdog is not None else {}),
            "faults_fired": list(get_injector().fired),
        }

    def write_resilience_report(self, out_dir: str) -> str:
        """Atomically persist ``resilience_report()`` as
        ``<out_dir>/resilience_report.json`` (where an elastic agent looks
        for it)."""
        import json

        from deepspeed_tpu_torch.utils.io import atomic_write_text

        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "resilience_report.json")
        atomic_write_text(path, json.dumps(self.resilience_report(),
                                           indent=2))
        return path

    def shutdown(self) -> None:
        """Orderly teardown: collect an in-flight offload step and close
        the host optimizer (its AIO handle and page-locked buffers), finish
        an in-flight async save and its commit, stop the heartbeat and
        watchdog threads, an in-flight profile capture and the
        ``/metrics`` server. Idempotent."""
        from deepspeed_tpu_torch.runtime.checkpoint import finalize_pending

        if self._offload is not None:
            self._drain_offload()
            self._offload.close()

        for mgr in self._ckpt_managers.values():
            mgr.drain(raise_on_error=False)
        try:
            finalize_pending(self)
        except Exception as e:   # already logged by the commit thread
            logger.error("async checkpoint commit failed: %s", e)
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._heartbeat is not None:
            self._heartbeat.stop()
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
