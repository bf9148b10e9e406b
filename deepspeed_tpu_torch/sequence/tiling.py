"""Tiled sequence compute: activation memory capped by chunking the
sequence (counterpart of ``deepspeed_tpu/sequence/tiling.py``).

Each chunk runs under non-reentrant ``torch.utils.checkpoint``, so only the
chunk inputs are kept for the backward and each chunk's intermediates
(an MLP's hidden layer, a chunk's ``[B, T/n, V]`` logits) live one chunk
at a time. The chunk loop is a Python loop, as the reference's is a
``lax.map``.
"""

from __future__ import annotations

from typing import Callable

import torch


def _checkpointed(fn: Callable, *args):
    import torch.utils.checkpoint

    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def sequence_tiled_compute(fn: Callable, x: torch.Tensor, num_shards: int,
                           seq_dim: int = 1, remat: bool = True
                           ) -> torch.Tensor:
    """Apply a sequence-pointwise ``fn`` over ``num_shards`` chunks of
    ``seq_dim`` (the largest count <= ``num_shards`` that divides it)."""
    T = x.shape[seq_dim]
    while T % num_shards != 0:
        num_shards -= 1
    if num_shards <= 1:
        return fn(x)
    outs = [_checkpointed(fn, c) if remat else fn(c)
            for c in x.chunk(num_shards, dim=seq_dim)]
    return torch.cat(outs, dim=seq_dim)


def TiledMLP(mlp_fn: Callable, num_shards: int = 4) -> Callable:
    """Wrap an MLP block so each sequence tile is computed (and recomputed
    in the backward) on its own."""

    def tiled(x, *args, **kwargs):
        return sequence_tiled_compute(lambda c: mlp_fn(c, *args, **kwargs),
                                      x, num_shards)

    return tiled


def tiled_logits_loss(hidden: torch.Tensor, head: torch.Tensor,
                      labels: torch.Tensor, num_shards: int = 8,
                      ignore_index: int = -100,
                      z_loss: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy of ``hidden [B, T, D] @ head [D, V]`` against
    ``labels [B, T]`` over ``num_shards`` sequence chunks, the logits in
    fp32 one chunk at a time; ``[B, T, V]`` is never materialised. Every
    negative label is padding (``ignore_index`` too); ``z_loss`` adds
    ``z_loss * logsumexp^2`` per token. ``head`` is cast to ``hidden``'s
    dtype inside each chunk, so an fp32 master head sums its chunks'
    gradients in fp32."""
    T = hidden.shape[1]
    while T % num_shards != 0:
        num_shards -= 1

    def chunk_loss(h, lab):
        logits = (h @ head.to(h.dtype)).float()
        logz = torch.logsumexp(logits, dim=-1)
        mask = (lab >= 0) & (lab != ignore_index)
        gold = logits.gather(-1, lab.clamp_min(0)[..., None].long())[..., 0]
        nll = logz - gold
        if z_loss > 0.0:
            nll = nll + z_loss * logz.square()
        return torch.where(mask, nll, 0.0).sum(), mask.sum()

    total, count = 0.0, 0
    for h, lab in zip(hidden.chunk(num_shards, dim=1),
                      labels.chunk(num_shards, dim=1)):
        s, c = _checkpointed(chunk_loss, h, lab)
        total, count = total + s, count + c
    return total / torch.clamp_min(count, 1)
