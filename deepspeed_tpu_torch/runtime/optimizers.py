"""Optimizers of the training engine (counterpart of
``deepspeed_tpu/runtime/optimizers.py``).

The reference builds optax chains; this module keeps their semantics, not
``torch.optim``'s defaults, and updates the fp32 master leaves in place:

* Adam: ``mu_hat / (sqrt(nu_hat) + eps)`` -- eps outside the sqrt -- then
  weight decay ``+ wd * p`` on every leaf, then ``- lr * update``. Both
  ``adam_w_mode`` settings compute this, as the reference's two optax
  chains (``adamw`` and ``scale_by_adam`` + ``add_decayed_weights``) do.
* SGD / momentum: optax ``trace`` (``t = g + m * t``; nesterov ``g + m * t``)
  then ``- lr * t``; weight decay is not applied, as in the reference.
* Update k (0-based) uses ``schedule(k)``: the count advances only when an
  update is applied, so an fp16 step skipped for overflow does not move it.
* ``gradient_clipping > 0`` clips by the global norm first, as
  ``optax.clip_by_global_norm`` (``g * max_norm / norm`` when norm >= max),
  in place and with the norm the caller already took when it has one.

lamb, lion, adagrad, adafactor, rmsprop, muon and the 1-bit optimizers are
not ported yet: they raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

ScheduleFn = Callable[[int], float]

UNPORTED = ("onebitadam", "zerooneadam", "onebitlamb", "lamb", "fusedlamb",
            "lion", "fusedlion", "adagrad", "adafactor", "rmsprop", "muon")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of every element squared), as a 0-dim fp32 tensor (no host
    synchronisation)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> None:
    """optax's ``clip_by_global_norm``, in place: unchanged when ``norm <
    max_norm``, else scaled by ``max_norm / norm``. ``norm`` is the global
    norm of ``grads`` (taken here when not given)."""
    if norm is None:
        norm = global_norm(grads)
    factor = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(factor)


class Optimizer:
    """A gradient transformation over a list of leaves: ``init(params)``
    returns the state, ``update(params, grads, state, norm=None)`` clips
    ``grads`` in place (when configured; ``norm`` is their global norm if
    the caller has it), applies one update to ``params`` in place and
    advances the state's ``count``."""

    def __init__(self, lr: Union[float, ScheduleFn], init_fn: Callable,
                 update_fn: Callable, gradient_clipping: float = 0.0):
        self.lr = lr if callable(lr) else (lambda _step, _v=float(lr): _v)
        self._init_fn = init_fn
        self._update_fn = update_fn
        self.gradient_clipping = float(gradient_clipping or 0.0)

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0, **self._init_fn(params)}

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict[str, Any],
               norm: Optional[torch.Tensor] = None) -> None:
        if self.gradient_clipping > 0:
            clip_by_global_norm(grads, self.gradient_clipping, norm)
        self._update_fn(params, grads, state, self.lr(state["count"]))
        state["count"] += 1


def _adam(b1: float, b2: float, eps: float, wd: float):
    def init(params):
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(params, grads, state, lr):
        # bias corrections in fp32, as optax computes them (1 - b2**n loses
        # digits to cancellation there; matching it keeps the two equal)
        n = np.float32(state["count"] + 1)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** n)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** n)
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(eps))
            if wd:
                u.add_(p, alpha=wd)
            p.add_(u, alpha=-lr)

    return init, update


def _sgd(momentum: float, nesterov: bool):
    def init(params):
        return {"trace": [torch.zeros_like(p) for p in params]
                if momentum else []}

    def update(params, grads, state, lr):
        if not momentum:
            for p, g in zip(params, grads):
                p.add_(g, alpha=-lr)
            return
        for p, g, t in zip(params, grads, state["trace"]):
            t.mul_(momentum).add_(g)
            p.add_(g + momentum * t if nesterov else t, alpha=-lr)

    return init, update


def build_optimizer(name: str, params_cfg: Dict[str, Any],
                    lr_schedule: Optional[ScheduleFn] = None,
                    gradient_clipping: float = 0.0) -> Optimizer:
    """Map a DeepSpeed ``optimizer`` config section to an :class:`Optimizer`."""
    p = dict(params_cfg)
    lr = lr_schedule if lr_schedule is not None else p.pop("lr", 1e-3)
    p.pop("lr", None)
    betas = tuple(p.pop("betas", (0.9, 0.999)))
    eps = p.pop("eps", 1e-8)
    wd = p.pop("weight_decay", 0.0)
    key = name.lower().replace("_", "").replace("-", "")
    if key in ("adam", "fusedadam", "adamw", "cpuadam"):
        fns = _adam(betas[0], betas[1], eps, wd)
    elif key == "sgd":
        fns = _sgd(p.pop("momentum", 0.0), p.pop("nesterov", False))
    elif key == "momentum":
        fns = _sgd(p.pop("momentum", 0.9), False)
    elif key in UNPORTED:
        raise NotImplementedError(f"optimizer '{name}' is not ported yet "
                                  "(ported: adam, adamw, sgd, momentum)")
    else:
        raise ValueError(f"unknown optimizer '{name}'")
    return Optimizer(lr, *fns, gradient_clipping=gradient_clipping)
