"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing.py``).

Every policy is ``torch.utils.checkpoint`` in its non-reentrant form around
a block. ``none`` keeps every activation; ``full`` and ``nothing_saveable``
recompute the whole block in the backward. The named policies of the
reference (``jax.checkpoint_policies``) keep the outputs of some ops from
the forward and recompute the rest; an op is named as the dispatcher sees
it:

* ``dots_saveable``: the products (``aten::mm``, ``addmm``, ``bmm``,
  ``baddbmm``);
* ``dots_with_no_batch_dims_saveable``: the 2-D products (``mm``,
  ``addmm``), not the batched ones;
* ``attn_saveable``: the attention output, the op ``dstpu::flash_attn``
  (``ops/flash_attention.py`` :func:`flash_op`, the reference's
  ``"flash_attn_out"``), so the recompute launches no kernel D;
* ``dots_and_attn_saveable``: both;
* ``offload_attn`` / ``offload_dots``: the attention output / the 2-D
  products, kept in pinned host memory between the forward and the
  backward.

The policies run as a pair of ``TorchDispatchMode``s given to the
checkpoint's ``context_fn``: in the forward, :class:`_SaveMode` runs each op
and keeps the outputs its policy names; in the recompute,
:class:`_RecomputeMode` answers those ops from what was kept, in the same
order, and runs every other op. An offloaded output is copied to a pinned
host buffer on the current stream (``non_blocking``) as it is kept, and
back to the device when the recompute asks for it: the tensor that
selective checkpointing keeps is the host copy itself, which no saved-
tensors hook could reach. ``OFFLOAD_STATS`` counts the bytes sent to the
host.

:func:`recomputing` tells code inside a block whether this call is the
backward's recompute (the MoE expert-load tracker counts a forward once).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

#: canonical policy names (the reference's ``POLICIES``)
POLICIES = (
    "none", "full", "dots_saveable", "nothing_saveable",
    "dots_with_no_batch_dims_saveable", "attn_saveable",
    "dots_and_attn_saveable", "offload_dots", "offload_attn",
)

#: the op whose output the attention policies keep
ATTN_OP = "dstpu::flash_attn"
DOTS = frozenset({"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"})
DOTS_NO_BATCH = frozenset({"aten::mm", "aten::addmm"})

#: bytes and tensors the offload policies sent to the host (process-wide;
#: reset by the caller)
OFFLOAD_STATS = {"bytes": 0, "tensors": 0}

# recomputes in progress (the backward runs them on autograd's threads)
_RECOMPUTES = [0]


def recomputing() -> bool:
    """True while a checkpointed block is being recomputed for its
    backward."""
    return _RECOMPUTES[0] > 0


class SavePolicy(NamedTuple):
    """Which ops' outputs a policy keeps on the device (``save``) and which
    in pinned host memory (``offload``), by the dispatcher's op name."""

    save: frozenset
    offload: frozenset

    def action(self, func) -> str:
        name = func.name()
        if name in self.save:
            return "save"
        if name in self.offload:
            return "offload"
        return ""


_NAMED = {
    "dots_saveable": SavePolicy(DOTS, frozenset()),
    "dots_with_no_batch_dims_saveable": SavePolicy(DOTS_NO_BATCH,
                                                   frozenset()),
    "attn_saveable": SavePolicy(frozenset({ATTN_OP}), frozenset()),
    "dots_and_attn_saveable": SavePolicy(DOTS | {ATTN_OP}, frozenset()),
    "offload_attn": SavePolicy(frozenset(), frozenset({ATTN_OP})),
    "offload_dots": SavePolicy(frozenset(), DOTS_NO_BATCH),
}


def resolve_policy(policy):
    """Map a policy name to its :class:`SavePolicy`; None for ``none``,
    ``full`` and ``nothing_saveable`` (nothing kept: a whole-block
    recompute, or no checkpoint). An unknown name raises ``ValueError``."""
    if policy in (None, "none", "full", "nothing_saveable"):
        return None
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy '{policy}' "
                         f"(have {sorted(POLICIES)})")
    return _NAMED[policy]


def check_policy(policy) -> str:
    """``policy`` (None reads as ``none``) if it is a known name, else
    ``ValueError``."""
    policy = policy or "none"
    resolve_policy(policy)
    return policy


def _to_host(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    OFFLOAD_STATS["bytes"] += t.numel() * t.element_size()
    OFFLOAD_STATS["tensors"] += 1
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


class _SaveMode(TorchDispatchMode):
    """The forward's mode: runs every op, keeps the outputs the policy
    names (detached; offloaded ones as pinned host copies)."""

    def __init__(self, policy: SavePolicy, store: Dict[str, Any]):
        super().__init__()
        self.policy, self.store = policy, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        act = self.policy.action(func)
        if act:
            keep = _to_host if act == "offload" else (
                lambda t: t.detach())
            self.store[func.name()].append(tree_map(
                lambda t: keep(t) if isinstance(t, torch.Tensor) else t,
                out))
        return out


class _RecomputeMode(TorchDispatchMode):
    """The recompute's mode: answers the kept ops from the store in order
    (offloaded ones copied back to the device of the op's first tensor
    argument), runs every other op."""

    def __init__(self, policy: SavePolicy, store: Dict[str, Any]):
        super().__init__()
        self.policy, self.store = policy, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        act = self.policy.action(func)
        kept = self.store.get(func.name()) if act else None
        if not kept:
            return func(*args, **(kwargs or {}))
        out = kept.popleft()
        if act == "offload":
            dev = next(a.device for a in args if isinstance(a, torch.Tensor))
            out = tree_map(lambda t: t.to(dev, non_blocking=True)
                           if isinstance(t, torch.Tensor) else t, out)
        return out


def _contexts(policy: SavePolicy):
    store: Dict[str, Any] = collections.defaultdict(collections.deque)
    return _SaveMode(policy, store), _RecomputeMode(policy, store)


def configure(config) -> dict:
    """Read the ``activation_checkpointing`` config section into remat
    kwargs."""
    return {"policy": config.policy}


def checkpoint(function: Callable, *args, policy: str = "full") -> Any:
    """Run ``function(*args)`` under remat (reference ``checkpoint``)."""
    return checkpoint_wrapper(function, policy=policy)(*args)


def checkpoint_wrapper(function: Callable, policy: str = "full") -> Callable:
    """``function`` itself for ``none``; else a wrapper that runs it under
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` with
    the policy's dispatch modes (none for a whole-block recompute)."""
    if check_policy(policy) == "none":
        return function
    save = resolve_policy(policy)

    def checkpointed(*args):
        import torch.utils.checkpoint

        calls = [0]

        def run(*a):
            # the first call is the forward; any later one the recompute
            calls[0] += 1
            if calls[0] == 1:
                return function(*a)
            _RECOMPUTES[0] += 1
            try:
                return function(*a)
            finally:
                _RECOMPUTES[0] -= 1

        if save is None:
            return torch.utils.checkpoint.checkpoint(run, *args,
                                                     use_reentrant=False)
        return torch.utils.checkpoint.checkpoint(
            run, *args, use_reentrant=False,
            context_fn=lambda: _contexts(save))

    return checkpointed
