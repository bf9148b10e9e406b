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
* LAMB: the Adam update plus ``wd * p``, scaled per leaf by the trust ratio
  ``||p|| / ||u||`` (1 when either norm is 0); a stacked ``[L, ...]`` leaf
  is one leaf, as in the reference's tree.
* Lion (``optax.lion``): ``sign((1 - b1) g + b1 m) + wd * p``, then ``m <-
  b2 m + (1 - b2) g``.
* Adagrad (``optax.adagrad``): the sum of squares starts at 0.1, eps inside
  the rsqrt.
* Adafactor (``optax.adafactor(lr)``): second moments factored over a
  leaf's two largest dims once both are >= 128 (a stacked ``[L, D, F]``
  leaf over D and F), decay ``1 - (n+1)^-0.8``, eps 1e-30 on the squared
  gradient, block-RMS clipping at 1, the learning rate, then the leaf's
  parameter RMS (at least 1e-3).
* RMSProp (``optax.rmsprop``): decay 0.9 from 0, eps inside the rsqrt; the
  momentum trace runs on the lr-scaled update.
* Muon (the reference's ``muon``): a Nesterov trace, then 5 quintic
  Newton-Schulz iterations in bf16 on each 2-D leaf and on each layer slice
  of a 3-D leaf (``torch.matmul`` with fp32 accumulation, outside any
  kernel), scaled by
  ``sqrt(max(1, rows / cols))``; other leaves are scaled by
  ``adam_lr_ratio``.

The 1-bit optimizers raise ``NotImplementedError``: they come with the
mesh (ROADMAP section 1, "Mesh, ZeRO and tensor parallelism").
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

ScheduleFn = Callable[[int], float]

ONE_BIT = ("onebitadam", "zerooneadam", "onebitlamb")


def sq_norm(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t``'s squares in fp32, 0-dim. A summation, not
    ``vector_norm``: the CPU's fp32 ``vector_norm`` of a 67M-element leaf
    is off by ~1% (its accumulators saturate), ``sum``'s cascade is not."""
    t = t.float()
    return (t * t).sum()


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of every element squared), as a 0-dim fp32 tensor (no host
    synchronisation)."""
    return torch.stack([sq_norm(t) for t in tensors]).sum().sqrt()


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


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def _adam_updates(params, grads, state, b1, b2, eps, wd):
    """Yield ``(p, u)``: optax's ``scale_by_adam`` then
    ``add_decayed_weights``, advancing the moments in place."""
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
        yield p, u


def _adam(b1: float, b2: float, eps: float, wd: float):
    def init(params):
        return {"mu": _zeros(params), "nu": _zeros(params)}

    def update(params, grads, state, lr):
        for p, u in _adam_updates(params, grads, state, b1, b2, eps, wd):
            p.add_(u, alpha=-lr)

    return init, update


def _lamb(b1: float, b2: float, eps: float, wd: float):
    """The reference's ``_lamb``: adam, decayed weights, optax's
    ``scale_by_trust_ratio`` per leaf, then the learning rate."""
    def init(params):
        return {"mu": _zeros(params), "nu": _zeros(params)}

    def update(params, grads, state, lr):
        for p, u in _adam_updates(params, grads, state, b1, b2, eps, wd):
            pn, un = sq_norm(p).sqrt(), sq_norm(u).sqrt()
            ratio = torch.where((pn == 0) | (un == 0), 1.0, pn / un)
            p.add_(u.mul_(ratio), alpha=-lr)

    return init, update


def _lion(b1: float, b2: float, wd: float):
    def init(params):
        return {"mu": _zeros(params)}

    def update(params, grads, state, lr):
        for p, g, mu in zip(params, grads, state["mu"]):
            u = torch.sign(g * (1.0 - b1) + mu * b1)
            mu.mul_(b2).add_(g, alpha=1.0 - b2)
            if wd:
                u.add_(p, alpha=wd)
            p.add_(u, alpha=-lr)

    return init, update


def _adagrad(eps: float, initial: float = 0.1):
    def init(params):
        return {"sum_of_squares": [torch.full_like(p, initial)
                                   for p in params]}

    def update(params, grads, state, lr):
        for p, g, ss in zip(params, grads, state["sum_of_squares"]):
            ss.addcmul_(g, g)
            inv = torch.where(ss > 0, torch.rsqrt(ss + eps), 0.0)
            p.add_(inv.mul_(g), alpha=-lr)

    return init, update


def _rmsprop(eps: float, momentum: float, decay: float = 0.9):
    def init(params):
        return {"nu": _zeros(params), "trace": _zeros(params)}

    def update(params, grads, state, lr):
        for p, g, nu, t in zip(params, grads, state["nu"], state["trace"]):
            nu.mul_(decay).addcmul_(g, g, value=1.0 - decay)
            u = torch.rsqrt(nu + eps).mul_(g).mul_(-lr)
            t.mul_(momentum).add_(u)
            p.add_(t)

    return init, update


def _factored_dims(shape, min_dim: int = 128):
    """optax's ``_factored_dims``: the two largest axes ``(d1, d0)``
    (second largest, largest), or None below ``min_dim``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


def _adafactor(decay_rate: float = 0.8, eps: float = 1e-30,
               clip: float = 1.0, min_scale: float = 1e-3):
    """``optax.adafactor(lr)`` with its defaults (no momentum, no weight
    decay)."""
    def init(params):
        rows, cols, full = [], [], []
        for p in params:
            dims = _factored_dims(tuple(p.shape))
            if dims is None:
                rows.append(None)
                cols.append(None)
                full.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                rows.append(torch.zeros_like(p.select(d0, 0)))
                cols.append(torch.zeros_like(p.select(d1, 0)))
                full.append(None)
        return {"v_row": rows, "v_col": cols, "v": full}

    def update(params, grads, state, lr):
        t = np.float32(state["count"] + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-decay_rate))
        for i, (p, g) in enumerate(zip(params, grads)):
            gsq = g * g + eps
            dims = _factored_dims(tuple(p.shape))
            if dims is None:
                v = state["v"][i]
                v.mul_(decay).add_(gsq, alpha=1.0 - decay)
                u = g * v.rsqrt()
            else:
                d1, d0 = dims
                vr, vc = state["v_row"][i], state["v_col"][i]
                vr.mul_(decay).add_(gsq.mean(dim=d0), alpha=1.0 - decay)
                vc.mul_(decay).add_(gsq.mean(dim=d1), alpha=1.0 - decay)
                rd1 = d1 - 1 if d1 > d0 else d1
                row = (vr / vr.mean(dim=rd1, keepdim=True)).rsqrt()
                u = g * row.unsqueeze(d0) * vc.rsqrt().unsqueeze(d1)
            u.div_(torch.clamp_min(u.square().mean().sqrt() / clip, 1.0))
            u.mul_(lr)
            rms = p.square().mean().sqrt()
            p.sub_(u.mul_(torch.where(rms <= min_scale, min_scale, rms)))

    return init, update


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A bf16 product with fp32 accumulation, rounded to bf16: cuBLAS's
    bf16 GEMM on CUDA tensors; on CPU ones the fp32 product of the bf16
    values, rounded (what the reference's bf16 ``dot`` compiles to on the
    CPU, and not slower there than an emulated bf16 GEMM)."""
    if a.is_cuda:
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _newton_schulz(g: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """The reference's quintic iteration in bf16 over the last two dims
    (each slice of a stacked leaf on its own), back in ``g``'s dtype."""
    # the reference's python-float coefficients are weakly typed: they take
    # the array's dtype, so they are rounded to bf16 before each product
    a, b, c = (float(torch.tensor(v, dtype=torch.bfloat16))
               for v in (3.4445, -4.7750, 2.0315))
    x = g.to(torch.bfloat16)
    transpose = x.shape[-2] > x.shape[-1]
    if transpose:
        x = x.transpose(-2, -1)
    # the reference's norm: bf16 squares, an fp32 sum rounded to bf16, then
    # the bf16 sqrt (jnp.linalg.norm of a bf16 array)
    norm = (x * x).float().sum(dim=(-2, -1), keepdim=True).to(x.dtype).sqrt()
    x = x / (norm + 1e-7)
    for _ in range(steps):
        A = _bf16_matmul(x, x.transpose(-2, -1))
        B = b * A + c * _bf16_matmul(A, A)
        x = a * x + _bf16_matmul(B, x)
    if transpose:
        x = x.transpose(-2, -1)
    return x.to(g.dtype)


def _muon(momentum: float, nesterov: bool = True, adam_lr_ratio: float = 0.1):
    def init(params):
        return {"trace": _zeros(params)}

    def update(params, grads, state, lr):
        for p, g, t in zip(params, grads, state["trace"]):
            t.mul_(momentum).add_(g)
            u = g + momentum * t if nesterov else t
            if u.dim() in (2, 3):
                rows, cols = u.shape[-2], u.shape[-1]
                u = _newton_schulz(u) * math.sqrt(max(1.0, rows / cols))
            else:
                u = u * adam_lr_ratio
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
    if key in ONE_BIT:
        raise NotImplementedError(
            f"optimizer '{name}' is a 1-bit compressed optimizer, not ported "
            'yet (ROADMAP section 1, "Mesh, ZeRO and tensor parallelism")')
    if key in ("adam", "fusedadam", "adamw", "cpuadam"):
        fns = _adam(betas[0], betas[1], eps, wd)
    elif key in ("lamb", "fusedlamb"):
        fns = _lamb(betas[0], betas[1], eps, wd)
    elif key in ("lion", "fusedlion"):
        fns = _lion(betas[0], betas[1], wd)
    elif key == "sgd":
        fns = _sgd(p.pop("momentum", 0.0), p.pop("nesterov", False))
    elif key == "momentum":
        fns = _sgd(p.pop("momentum", 0.9), False)
    elif key == "adagrad":
        fns = _adagrad(eps)
    elif key == "adafactor":
        fns = _adafactor()
    elif key == "rmsprop":
        fns = _rmsprop(eps, p.pop("momentum", 0.0))
    elif key == "muon":
        fns = _muon(p.pop("momentum", 0.95))
    else:
        raise ValueError(f"unknown optimizer '{name}'")
    return Optimizer(lr, *fns, gradient_clipping=gradient_clipping)
