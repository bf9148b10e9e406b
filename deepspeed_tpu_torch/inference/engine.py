"""Inference engine v1: full-sequence forward and autoregressive generation
over a dense KV cache (counterpart of ``deepspeed_tpu/inference/engine.py``,
one device).

``generate`` runs the prompt as one ``forward_with_cache`` step, then one
token a step, sampling with :func:`sample_token`. The cache is the model's
dense ``init_kv_cache``, attention the plain ``_cached_attention`` (the
reference computes it in XLA, outside any Pallas kernel); ``forward`` is
the model's full-sequence ``logits`` (flash kernel D on the card).
``dtype="int8"|"int4"`` serves packed weights through kernels G/H, as the
reference's ``init_inference(dtype=torch.int8)``. An MoE model serves
through its ``moe_fn``, every lane of the batch routed. Random draws come
from an explicit ``torch.Generator`` seeded with ``seed`` (the reference's
JAX key): the same seed gives other draws than JAX's, from the same
distribution.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer import TransformerLM


def _categorical(logits: torch.Tensor, generator) -> torch.Tensor:
    """One draw per row from softmax(``logits``) [B, V] (entries of -inf
    are never drawn), by the Gumbel-max rule as ``jax.random.categorical``
    draws."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = torch.clamp(u, torch.finfo(u.dtype).tiny, 1.0)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_token(logits: torch.Tensor, temperature: float, top_k: int,
                 generator: Optional[torch.Generator] = None,
                 with_logprob: bool = False, top_p: float = 1.0):
    """Greedy / temperature / top-k / nucleus (top-p) sampling of the next
    token of each row of ``logits`` [B, V] (the reference's :26);
    optionally also the token's logprob under the SAMPLING distribution
    (the filtered, temperature-scaled one). ``generator`` replaces the
    reference's JAX key."""
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1)
        lp = logits.float()
    elif top_k > 0:
        # sample within the top-k subset: top-p then needs a cumsum over k
        # entries instead of a full-vocabulary sort
        lp_full = (logits / temperature).float()
        vals, idx = torch.topk(lp_full, top_k, dim=-1)     # sorted descending
        if top_p < 1.0:
            cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
            # the smallest prefix whose mass reaches top_p (the cutoff token
            # inclusive): entries whose PRECEDING mass is < top_p
            keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                              cum[:, :-1] < top_p], dim=-1)
            vals = torch.where(keep, vals, -torch.inf)
        j = _categorical(vals, generator)
        tok = idx.gather(-1, j[:, None])[:, 0]
        if not with_logprob:
            return tok
        logp_k = torch.log_softmax(vals, dim=-1)
        return tok, logp_k.gather(-1, j[:, None])[:, 0]
    else:
        lp = (logits / temperature).float()
        if top_p < 1.0:
            # nucleus: keep the smallest prefix of the sorted distribution
            # whose mass reaches top_p (the cutoff token inclusive)
            probs = torch.softmax(lp, dim=-1)
            sorted_p = torch.sort(probs, dim=-1, descending=True).values
            cum = torch.cumsum(sorted_p, dim=-1)
            k_idx = torch.argmax((cum >= top_p).to(torch.int8), dim=-1)
            cutoff = sorted_p.gather(-1, k_idx[:, None])
            lp = torch.where(probs < cutoff, -torch.inf, lp)
        tok = _categorical(lp, generator)
    if not with_logprob:
        return tok
    logp = torch.log_softmax(lp, dim=-1)
    return tok, logp.gather(-1, tok[:, None])[:, 0]


def generate_loop(step_fn, params, init_cache_fn, ids: np.ndarray, total: int,
                  temperature: float, top_k: int, seed: int,
                  eos_token_id: Optional[int], return_logprobs: bool = False,
                  top_p: float = 1.0, device="cuda"):
    """The autoregressive loop (the reference's :75): the prompt in one
    step, then one sampled token a step; after a sequence emits
    ``eos_token_id`` it is padded with it, and the loop ends early once
    every sequence has. With ``return_logprobs``, also the sampling logprob
    of every generated token (forced post-EOS pads get 0.0)."""
    B, T = ids.shape
    device = torch.device(device)
    cache = init_cache_fn(B, total)
    gen = torch.Generator(device=device).manual_seed(seed)
    logits, cache = step_fn(params, torch.from_numpy(ids).to(device), cache)
    next_logits = logits[:, -1]
    out, lps = [ids], []
    finished = np.zeros((B,), bool)
    for _ in range(total - T):
        nxt, lp = sample_token(next_logits, temperature, top_k, gen,
                               with_logprob=True, top_p=top_p)
        nxt_np = nxt.cpu().numpy().astype(ids.dtype)
        lp_np = lp.float().cpu().numpy()
        if eos_token_id is not None:
            lp_np = np.where(finished, 0.0, lp_np)
            nxt_np = np.where(finished, eos_token_id, nxt_np).astype(ids.dtype)
            finished |= nxt_np == eos_token_id
        out.append(nxt_np[:, None])
        lps.append(lp_np[:, None])
        if eos_token_id is not None and finished.all():
            break
        logits, cache = step_fn(params, torch.from_numpy(nxt_np[:, None])
                                .to(device), cache)
        next_logits = logits[:, -1]
    seqs = np.concatenate(out, axis=1)
    if return_logprobs:
        return seqs, np.concatenate(lps, axis=1)
    return seqs


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class InferenceEngine:
    """The v1 engine (the reference's :116) on one device: ``forward`` /
    ``__call__`` give full-sequence logits, ``generate`` samples over a
    dense KV cache. ``params`` is used as given (a tree already on the
    device is not copied); None draws ``model.init(seed=0)``."""

    def __init__(self, model: TransformerLM, config=None, params=None,
                 dtype=None, max_seq_len: Optional[int] = None,
                 device="cuda"):
        from deepspeed_tpu_torch.config import from_config
        from deepspeed_tpu_torch.inference.quant import (
            parse_weight_dtype, quantize_serving_params)
        from deepspeed_tpu_torch.utils import resolve_device

        self.device = resolve_device(device)
        self.module = model
        self.cfg = model.cfg
        self.config = from_config(config)
        self.max_seq_len = max_seq_len or self.cfg.max_seq_len
        if params is None:
            params = model.init(seed=0, device=self.device)
        else:
            params = _tree_to(params, self.device)
        wd = parse_weight_dtype(dtype)
        if wd != "bf16":
            params = quantize_serving_params(params, self.cfg,
                                             4 if wd == "int4" else 8)
        self.params = params

    def forward(self, input_ids, **kw) -> torch.Tensor:
        """Full-sequence logits [B, T, V] (the reference's ``forward``)."""
        ids = torch.as_tensor(np.asarray(input_ids)).to(self.device)
        return self.module.logits(self.params, ids)

    __call__ = forward

    def _init_cache(self, batch: int, total: int):
        return self.module.init_kv_cache(batch, total, device=self.device)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 eos_token_id: Optional[int] = None, top_p: float = 1.0):
        """Greedy / top-k / nucleus sampled generation: ``input_ids`` [B, T]
        -> [B, T + n] numpy tokens (n <= ``max_new_tokens``, fewer once
        every row has emitted ``eos_token_id``, and capped by
        ``max_seq_len``)."""
        ids = np.asarray(input_ids)
        total = min(self.max_seq_len, ids.shape[1] + max_new_tokens)
        return generate_loop(self.module.forward_with_cache, self.params,
                             self._init_cache, ids, total, temperature, top_k,
                             seed, eos_token_id, top_p=top_p,
                             device=self.device)

    # the reference's alias (hybrid engine and older call sites)
    _sample = staticmethod(sample_token)
