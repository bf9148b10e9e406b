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

One device: params, grads and optimizer state stay whole on it, so ZeRO
stages 0-3 compute the same step, as they do in the reference on a
one-device mesh. Monitor, observability, resilience, offload, 1-bit
optimizers, ZeRO++ and checkpoints are not in this slice.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
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
        loss = self.module.loss_fn(self.params, self._put_batch(batch))
        self._pending = loss
        self._last_loss = loss.detach()
        return loss

    __call__ = forward

    def backward(self, loss: Optional[torch.Tensor] = None, *args, **kwargs):
        """Add the gradients of ``loss * scale`` into the accumulation
        buffer (the leaves' ``.grad``; reference :711)."""
        if self._pending is None:
            raise RuntimeError("backward() called before forward()")
        loss = self._pending if loss is None else loss
        (loss * self.scaler_state["scale"]).backward()
        self._pending = None
        self._grad_acc_count += 1
        self.micro_steps += 1
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
        gnorm, skipped = self._apply(
            float(self.config.gradient_accumulation_steps))
        self._grad_acc_count = 0
        self._last_gnorm = gnorm
        self._commit_step(skipped)

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

    def _report_progress(self) -> None:
        loss = None if self._last_loss is None else float(self._last_loss)
        logger.info("step=%d loss=%s lr=%.3e grad_norm=%s scale=%.0f "
                    "skipped=%d", self.global_steps, loss, self.get_lr()[0],
                    self.get_global_grad_norm(), self.scaler_state["scale"],
                    self.skipped_steps)
