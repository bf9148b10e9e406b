"""The model contract of the training engine (counterpart of
``deepspeed_tpu/models/spec.py``).

A model hands the engine ``init(seed, device) -> params`` (a nested dict of
tensors) and ``loss_fn(params, batch) -> scalar loss tensor`` with autograd
through ``params``; the engine owns the optimizer and the gradient
accumulation. :class:`~deepspeed_tpu_torch.models.TransformerLM` is one.
"""

from __future__ import annotations

from typing import Any, Iterator

import torch


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def num_params(params: Any) -> int:
    return sum(t.numel() for t in tree_leaves(params))
