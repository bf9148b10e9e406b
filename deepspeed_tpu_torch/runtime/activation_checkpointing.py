"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing.py``).

``remat_policy`` ``none`` keeps every activation; ``full`` recomputes a
wrapped block's forward during the backward, through
``torch.utils.checkpoint`` in its non-reentrant form. The reference's named
save policies (``dots_saveable``, ``attn_saveable``, the offload policies,
...) are ``jax.checkpoint_policies`` and are not ported yet: they raise.
"""

from __future__ import annotations

from typing import Callable

#: the reference's policy names (``POLICIES``); only the first two are ported
POLICIES = (
    "none", "full", "dots_saveable", "nothing_saveable",
    "dots_with_no_batch_dims_saveable", "attn_saveable",
    "dots_and_attn_saveable", "offload_dots", "offload_attn",
)
PORTED = ("none", "full")


def check_policy(policy) -> str:
    """``policy`` if ported (None reads as ``none``); a known but unported
    policy raises ``NotImplementedError``, an unknown one ``ValueError``."""
    policy = policy or "none"
    if policy in PORTED:
        return policy
    if policy in POLICIES:
        raise NotImplementedError(
            f"remat policy {policy!r} is not ported yet (ported: {PORTED})")
    raise ValueError(f"unknown remat policy {policy!r} (have {POLICIES})")


def checkpoint_wrapper(function: Callable, policy: str = "full") -> Callable:
    """``function`` itself for ``none``; for ``full``, a wrapper that runs it
    under ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``."""
    if check_policy(policy) == "none":
        return function

    def checkpointed(*args):
        import torch.utils.checkpoint

        return torch.utils.checkpoint.checkpoint(function, *args,
                                                 use_reentrant=False)

    return checkpointed
