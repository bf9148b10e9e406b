"""Top-k gating and expert dispatch on one device (counterpart of
``deepspeed_tpu/moe/sharded_moe.py``, its one-device half).

Two dispatch algebras, picked by ``cfg.moe_dispatch``
(:func:`moe_block_for`):

* ``capacity`` (:func:`moe_mlp_block`): GShard top-k gating with a static
  per-expert capacity ``C`` (:func:`topk_gating`); ``[S, E, C]`` dispatch
  and combine masks feed einsums, and tokens past an expert's capacity
  pass through the residual (dropped), as the reference with
  ``drop_tokens=True``.
* ``grouped`` (:func:`grouped_moe_mlp_block`): dropless. The ``S*k``
  (token, expert) pairs are sorted by expert and run through a grouped
  product. ``moe_kernel="ragged"`` is one ``torch.matmul`` per expert over
  its contiguous rows (the group sizes go to the host: one device-to-host
  sync a block); ``"padded"`` is the reference's one-hot einsum twin at
  ``capacity_factor = inf`` (:func:`_padded_ffn`). Both run on the CPU and
  the card, so a configured kernel is never swapped for the other.

The grouped path moves rows with permutations only: the sort's inverse
undoes it, and each token's ``k`` expert outputs are summed over the ``k``
axis. No step scatters with atomics, so two runs (and a remat recompute)
are bit-identical.

Not here: the expert-parallel dispatch (``_grouped_moe_ep``) waits for a
mesh (ROADMAP section 1, "Mesh, ZeRO and tensor parallelism"); on one
device the reference never enters it. ``a2a_bits`` / ``a2a_slice`` are
accepted and unused, as there. A serving engine's int8 expert stacks
(``w_*_q`` / ``w_*_s`` leaves, ``inference/quant.py``) are dequantized to
the compute dtype before the products (:func:`_expert_weight`), as the
reference's are.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

#: placement-table leaves (moe/balancer.py) that ride the expert weight
#: dict replicated -- everything else under the dict is an expert stack
PLACEMENT_LEAVES = ("place_dest", "place_slot", "place_nrep")


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    cap = int(math.ceil(num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


# ---------------------------------------------------------------------------
# grouped-product kernel selection
# ---------------------------------------------------------------------------

MOE_KERNELS = ("ragged", "padded")


def moe_kernel_support() -> Tuple[Optional[str], str]:
    """How the dropless grouped expert product runs here: always
    ``("native", why)`` -- the ragged product is a ``torch.matmul`` per
    expert, which every backend runs."""
    return ("native", "the ragged grouped product is one torch.matmul per "
                      "expert over its sorted rows")


def resolve_moe_kernel(kernel: str) -> Tuple[str, str]:
    """Check a configured ``moe.kernel``: returns ``(kernel, "")``; an
    unknown name raises ``ValueError``. Both kernels run on every device,
    so neither ever stands in for the other."""
    if kernel not in MOE_KERNELS:
        raise ValueError(f"moe kernel must be one of {MOE_KERNELS}, "
                         f"got {kernel!r}")
    return kernel, ""


# ---------------------------------------------------------------------------
# expert-load observation (AutoEP input -- moe/balancer.py)
# ---------------------------------------------------------------------------

_TRACKER = None


def set_expert_tracker(tracker) -> None:
    """Install (or clear, with ``None``) the process-wide expert-load
    tracker. ``None`` (the default) costs nothing in the hot path; an
    installed one costs a device-to-host copy of ``E`` counts a block."""
    global _TRACKER
    _TRACKER = tracker


def _emit_expert_counts(counts: torch.Tensor) -> None:
    """Forward one dispatch's per-expert routed-token counts to the
    installed tracker -- once a forward: a remat recompute of the block
    for its backward counts nothing."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import (
        recomputing)

    t = _TRACKER
    if t is not None and not recomputing():
        t.observe(counts.detach().cpu().numpy())


def _route(logits: torch.Tensor, k: int,
           rng: Optional[torch.Generator] = None, noise_std: float = 0.0,
           valid: Optional[torch.Tensor] = None):
    """Shared router prefix for both dispatch algebras: fp32 gates, the
    GShard top-1 aux loss, renormalized top-k weights.

    ``valid`` [S] masks padding / idle rows: they are excluded from the
    aux stats and their combine weights are zeroed, so they can neither
    shift the load-balancing loss nor occupy expert capacity. ``rng`` (a
    ``torch.Generator`` on the logits' device) with ``noise_std > 0`` adds
    the RSample gate noise.
    """
    E = logits.shape[-1]
    logits = logits.float()
    if noise_std > 0.0 and rng is not None:
        logits = logits + noise_std * torch.randn(
            logits.shape, generator=rng, device=logits.device)
    gates = torch.softmax(logits, dim=-1)                       # [S, E]
    mask1 = F.one_hot(gates.argmax(dim=-1), E).float()
    if valid is None:
        g_sum, m_sum = gates.sum(0), mask1.sum(0)
        denom = max(float(logits.shape[0]), 1.0)
    else:
        vf = valid.float()
        g_sum = (gates * vf[:, None]).sum(0)
        m_sum = (mask1 * vf[:, None]).sum(0)
        denom = vf.sum().clamp_min(1.0)
    aux_loss = (g_sum * m_sum).sum() / (denom * denom) * E
    topk_vals, topk_idx = torch.topk(gates, k, dim=-1, sorted=True)
    # renormalize the kept gate mass (the reference normalizes combine
    # weights)
    topk_vals = topk_vals / topk_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    if valid is not None:
        topk_vals = topk_vals * valid[:, None].to(topk_vals.dtype)
    return gates, aux_loss, topk_vals, topk_idx


def topk_gating(logits: torch.Tensor, k: int = 2,
                capacity_factor: float = 1.25, min_capacity: int = 4,
                rng: Optional[torch.Generator] = None,
                noise_std: float = 0.0,
                valid: Optional[torch.Tensor] = None):
    """GShard top-k gating with per-expert capacity.

    Args:
        logits: [S, E] raw router outputs (fp32 recommended).
        valid: [S] bool -- False rows do not compete for expert capacity
            and carry zero combine weight.
    Returns:
        (dispatch [S, E, C] fp32, combine [S, E, C] fp32, aux_loss scalar,
        stats with ``capacity``, ``tokens_per_expert`` and
        ``drop_fraction``)
    """
    S, E = logits.shape
    C = _capacity(S, E, capacity_factor, min_capacity)
    _gates, aux_loss, topk_vals, topk_idx = _route(logits, k, rng, noise_std,
                                                   valid=valid)
    dev = logits.device
    dispatch = torch.zeros((S, E, C), dtype=torch.float32, device=dev)
    combine = torch.zeros((S, E, C), dtype=torch.float32, device=dev)
    counts = torch.zeros(E, dtype=torch.int64, device=dev)  # kept so far
    for j in range(k):
        idx_j = topk_idx[:, j]                                  # [S]
        mask_j = F.one_hot(idx_j, E)                            # [S, E]
        if valid is not None:
            mask_j = mask_j * valid[:, None].long()
        pos = torch.cumsum(mask_j, dim=0) - mask_j   # rank among j-th picks
        loc = (pos * mask_j).sum(1) + counts[idx_j]             # [S]
        keep = loc < C
        counts = counts + (mask_j * keep[:, None]).sum(0)
        # a location past the capacity is no slot (the reference's
        # one_hot of an out-of-range index is all zeros)
        onehot_loc = (F.one_hot(torch.where(keep, loc, 0), C).float()
                      * keep[:, None])
        sel = mask_j.float()[:, :, None] * onehot_loc[:, None, :]
        dispatch = dispatch + sel
        combine = combine + sel * topk_vals[:, j][:, None, None]
    stats = {"capacity": C, "tokens_per_expert": counts,
             "drop_fraction": 1.0 - dispatch.sum() / (S * k)}
    return dispatch, combine, aux_loss, stats


def top1_gating(logits: torch.Tensor, **kw):
    """``top1gating`` parity (switch-transformer routing)."""
    return topk_gating(logits, k=1, **kw)


def _expert_weight(w: Dict[str, torch.Tensor], name: str,
                   dt: torch.dtype) -> torch.Tensor:
    """Expert stack [E, D, F] in the compute dtype: the dense leaf, or a
    serving engine's int8 ``name+"_q"`` [E, D, F] times its per-group
    scales ``name+"_s"`` [E, G, F] (each scale covers D / G rows),
    multiplied in ``dt`` as the reference does."""
    if name in w:
        return w[name].to(dt)
    q, s = w[name + "_q"], w[name + "_s"]
    E, D, F = q.shape
    G = s.shape[1]
    return (q.to(dt).reshape(E, G, D // G, F)
            * s.to(dt).reshape(E, G, 1, F)).reshape(E, D, F)


def _has_gate(w: Dict[str, torch.Tensor]) -> bool:
    return "w_gate" in w or "w_gate_q" in w


def _capacity_ffn(xe: torch.Tensor, w: Dict[str, torch.Tensor],
                  dt: torch.dtype) -> torch.Tensor:
    """The expert MLPs over ``xe`` [E, N, D] rows: swiglu when the stack
    has a gate, else tanh-gelu; [E, N, D] out."""
    if _has_gate(w):
        act = F.silu(torch.einsum("end,edf->enf", xe,
                                  _expert_weight(w, "w_gate", dt)))
        act = act * torch.einsum("end,edf->enf", xe,
                                 _expert_weight(w, "w_up", dt))
    else:
        act = F.gelu(torch.einsum("end,edf->enf", xe,
                                  _expert_weight(w, "w_up", dt)),
                     approximate="tanh")
    return torch.einsum("enf,efd->end", act, _expert_weight(w, "w_down", dt))


def moe_mlp_block(h: torch.Tensor, w: Dict[str, torch.Tensor], cfg: Any,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in MoE MLP for ``TransformerLM`` (the model's ``moe_fn``).

    h: [B, T, D]; w: router [D, E], w_gate/w_up [E, D, F], w_down
    [E, F, D]; valid: optional [B, T] bool -- padding / idle lanes that
    must not consume expert capacity or shift the aux stats. Returns
    (y [B, T, D], aux loss fp32 scalar).
    """
    B, T, D = h.shape
    x = h.reshape(B * T, D)
    logits = x.float() @ w["router"].float()
    dispatch, combine, aux, stats = topk_gating(
        logits, k=cfg.top_k, capacity_factor=cfg.capacity_factor,
        min_capacity=getattr(cfg, "min_capacity", 4),
        valid=None if valid is None else valid.reshape(-1))
    if _TRACKER is not None:
        _emit_expert_counts(stats["tokens_per_expert"])
    dt = h.dtype
    xe = torch.einsum("sec,sd->ecd", dispatch.to(dt), x)        # [E, C, D]
    ye = _capacity_ffn(xe, w, dt)                               # [E, C, D]
    y = torch.einsum("sec,ecd->sd", combine.to(dt), ye)
    return y.reshape(B, T, D), aux


def _padded_ffn(xs: torch.Tensor, group_sizes: torch.Tensor,
                w: Dict[str, torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    """The pad-to-capacity einsum twin at ``capacity_factor = inf``: every
    expert padded to the FULL row count and computed with the capacity
    path's einsum chain. O(N*E) operations and an ``[E, N, D]``
    intermediate against the ragged product's O(N). Dropless: padding rows
    carry zero."""
    N = xs.shape[0]
    E = group_sizes.shape[0]
    ends = torch.cumsum(group_sizes, dim=0)
    seg = (torch.arange(N, device=xs.device)[:, None]
           >= ends[None, :]).sum(-1)
    oh = F.one_hot(seg, E).to(dt)                               # [N, E]
    xe = torch.einsum("ne,nd->end", oh, xs)                     # [E, N, D]
    return torch.einsum("ne,end->nd", oh, _capacity_ffn(xe, w, dt))


def _ragged_ffn(xs: torch.Tensor, group_sizes: torch.Tensor,
                w: Dict[str, torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    """The grouped product over expert-sorted rows: expert ``e``'s MLP on
    its contiguous rows, one ``torch.matmul`` per weight; an expert with no
    rows launches nothing. The group sizes are read on the host (one
    device-to-host sync). Rows are cut with ``split`` and each stack with
    ``unbind``, whose backwards write the pieces' gradients into one
    tensor (a slice or an index per piece would allocate a whole-size
    gradient per piece)."""
    gate = _has_gate(w)
    wg = _expert_weight(w, "w_gate", dt).unbind(0) if gate else None
    wu = _expert_weight(w, "w_up", dt).unbind(0)
    wd = _expert_weight(w, "w_down", dt).unbind(0)
    outs = []
    for e, xe in enumerate(xs.split(group_sizes.tolist())):
        if xe.shape[0]:
            if gate:
                act = F.silu(xe @ wg[e]) * (xe @ wu[e])
            else:
                act = F.gelu(xe @ wu[e], approximate="tanh")
            outs.append(act @ wd[e])
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _grouped_ffn(xs: torch.Tensor, group_sizes: torch.Tensor,
                 w: Dict[str, torch.Tensor], dt: torch.dtype,
                 kernel: str = "ragged") -> torch.Tensor:
    """Expert-grouped FFN over rows sorted by expert: ``kernel="ragged"``
    is :func:`_ragged_ffn`, ``"padded"`` the einsum twin
    :func:`_padded_ffn`."""
    if kernel == "padded":
        return _padded_ffn(xs, group_sizes, w, dt)
    return _ragged_ffn(xs, group_sizes, w, dt)


class _Permute(torch.autograd.Function):
    """``rows.index_select(0, idx)`` for a permutation ``idx`` whose
    inverse is ``inv``: the backward gathers with ``inv`` instead of
    scattering (``index_select``'s own backward adds with atomics on the
    card, in no fixed order)."""

    @staticmethod
    def forward(ctx, rows, idx, inv):
        ctx.save_for_backward(idx, inv)
        return rows.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        _idx, inv = ctx.saved_tensors
        return grad.index_select(0, inv), None, None


def grouped_moe_mlp_block(h: torch.Tensor, w: Dict[str, torch.Tensor],
                          cfg: Any, valid: Optional[torch.Tensor] = None, *,
                          kernel: Optional[str] = None,
                          a2a_bits: Optional[int] = None,
                          a2a_slice: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless sort-based dispatch over a grouped product (the reference's
    MegaBlocks-style analog of ``inference/v2/kernels/cutlass_ops/
    moe_gemm``). ``kernel`` (default ``cfg.moe_kernel``) picks the
    product: ``"ragged"`` or the ``"padded"`` einsum twin.

    Unlike the capacity path every (token, expert) pair is computed -- no
    capacity padding and no dropped tokens. ``valid`` [B, T] masks padding
    / idle lanes out of the aux stats and combine weights. ``a2a_bits`` /
    ``a2a_slice`` select the expert-parallel wire format, which one device
    never uses.
    """
    del a2a_bits, a2a_slice
    kernel, _ = resolve_moe_kernel(
        getattr(cfg, "moe_kernel", "ragged") if kernel is None else kernel)
    B, T, D = h.shape
    E = w["router"].shape[-1]
    k = cfg.top_k
    x = h.reshape(B * T, D)
    S = x.shape[0]
    vflat = None if valid is None else valid.reshape(-1)
    logits = x.float() @ w["router"].float()
    _gates, aux_loss, topk_vals, topk_idx = _route(logits, k, valid=vflat)

    flat_expert = topk_idx.reshape(-1)                          # [S*k]
    order = torch.argsort(flat_expert, stable=True)  # pairs grouped by expert
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(S * k, device=order.device))
    group_sizes = torch.bincount(flat_expert, minlength=E)
    if _TRACKER is not None:
        real = flat_expert if vflat is None else \
            flat_expert[vflat.repeat_interleave(k)]
        _emit_expert_counts(torch.bincount(real, minlength=E))

    dt = h.dtype
    # pair p is (token p // k, its p % k-th expert): the k copies of each
    # row, then the expert-sorted order
    pairs = x.to(dt)[:, None].expand(S, k, D).reshape(S * k, D)
    xs = _Permute.apply(pairs, order, inv)                      # [S*k, D]
    ys = _grouped_ffn(xs, group_sizes, w, dt, kernel)           # [S*k, D]
    y_pairs = _Permute.apply(ys, inv, order)          # back in pair order
    weights = topk_vals.reshape(S * k).to(dt)
    out = (y_pairs * weights[:, None]).reshape(S, k, D).sum(1)
    return out.reshape(B, T, D), aux_loss


def moe_block_for(cfg: Any):
    """Select the dispatch algebra from ``cfg.moe_dispatch``."""
    dispatch = getattr(cfg, "moe_dispatch", "capacity")
    if dispatch == "grouped":
        return grouped_moe_mlp_block
    if dispatch != "capacity":
        raise ValueError(f"unknown moe_dispatch '{dispatch}' "
                         "(have: capacity, grouped)")
    return moe_mlp_block


class MoE:
    """Layer-shaped parity wrapper (``deepspeed.moe.layer.MoE``)."""

    def __init__(self, hidden_size: int, num_experts: int = 1, k: int = 2,
                 capacity_factor: float = 1.25,
                 eval_capacity_factor: float = 2.0, min_capacity: int = 4,
                 drop_tokens: bool = True,
                 noisy_gate_policy: Optional[str] = None, **_):
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.min_capacity = min_capacity

    def __call__(self, h: torch.Tensor, w: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        class _Cfg:
            top_k = self.k
            capacity_factor = self.capacity_factor
            min_capacity = self.min_capacity

        return moe_mlp_block(h, w, _Cfg())
