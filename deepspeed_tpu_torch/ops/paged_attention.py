"""Paged attention over the blocked KV pool (counterpart of
``deepspeed_tpu/ops/paged_attention.py``, bf16 pool, single device).

The pool is stacked and lane-folded, ``[L, nb+1, bs, K*d]``: layer ``l``,
physical block ``b``, row ``o`` holds kv head ``kk`` in lanes
``[kk*d, (kk+1)*d)``; the last block is scratch. ``block_tables [S, nb_max]``
map each SLOT's logical blocks to physical ids (tail entries point at the
scratch block). An atom is a run of consecutive tokens of one slot starting
at ``atom_pos0``; the pool holds only tokens of earlier steps (positions
``< atom_pos0``), the atom's own K/V arrives beside it.

Kernels (each launched only for CUDA tensors; CPU tensors take the plain
version named in brackets):

* A ``decode_pool_partials`` -- flash-decode partials of 1-token atoms over
  their pooled past [``plain_decode_partials``];
* B ``past_partials`` -- the same for the ``tq*rep`` rows of chunk atoms,
  per kv head [``plain_past_partials``];
* C ``self_attention`` -- causal flash over each chunk atom's own tokens,
  seeded from B's partials [``plain_self_attention``].

Each wrapper gets its launcher's arguments from a ``*_kernel_args`` function
(operand checks, int32 metadata, output allocation) and launches through
``KERNELS[name].launch``.

``ragged_paged_attention`` dispatches on ``tq`` (A plus a plain self-token
merge for ``tq == 1``, B then C otherwise); :func:`plain_ragged_attention`
is the whole path in one dense gather, the parity reference.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import (cuda_operand, int32_meta, on_cpu,
                                     stream_ptr)
from deepspeed_tpu_torch.ops._build import KERNELS

NEG_INF = -1e30


def _past_ranges(atom_pos0: torch.Tensor, row_pos: torch.Tensor, bs: int,
                 nb_max: int, window: Optional[int]):
    """(pos0, lo block, live block count) of each atom's visible past.
    ``row_pos`` (>= pos0) anchors the window; ``pos0`` is the pool frontier.
    An atom with ``pos0 == 0`` has no live block."""
    pos0 = atom_pos0.to(torch.int32)
    if window is not None:
        lo = torch.clamp_min(
            torch.div(row_pos.to(torch.int32) - (window - 1), bs,
                      rounding_mode="floor"), 0)
    else:
        lo = torch.zeros_like(pos0)
    last = torch.clamp_max(torch.div(pos0 - 1, bs, rounding_mode="floor"),
                           nb_max - 1)
    nblk = torch.where(pos0 > 0, torch.clamp_min(last - lo + 1, 0),
                       torch.zeros_like(pos0))
    return pos0, lo.to(torch.int32), nblk.to(torch.int32)


def _pool_geometry(q_heads_d, k_pool):
    H, d = q_heads_d
    L, nbp1, bs, KD = k_pool.shape
    if KD % d:
        raise ValueError(f"pool lanes {KD} not a multiple of head_dim {d}")
    K = KD // d
    if H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    return L, nbp1, bs, K, H // K


def _dense_past(pool: torch.Tensor, layer: int, block_tables: torch.Tensor,
                atom_slot: torch.Tensor, K: int, d: int) -> torch.Tensor:
    """[A, nb_max*bs, K, d] fp32 gather of each atom's logical pool rows."""
    bt = block_tables[atom_slot.long()].long()                 # [A, nb_max]
    A, nb_max = bt.shape
    bs = pool.shape[2]
    return pool[layer][bt].reshape(A, nb_max * bs, K, d).float()


# ---------------------------------------------------------------------------
# A: decode partials
# ---------------------------------------------------------------------------

def plain_decode_partials(q, k_pool, v_pool, layer: int, block_tables,
                          atom_slot, atom_pos0, *, window=None, row_pos=None):
    """Plain version of kernel A (the TPU package's ``xla_decode_partials``
    :655): dense gather, fp32. Returns acc [A,H,d] (unnormalised), m, l
    [A,H]; an atom with nothing visible gets m = -1e30, l = 0, acc = 0."""
    A, H, d = q.shape
    _, _, bs, K, rep = _pool_geometry((H, d), k_pool)
    if row_pos is None:
        row_pos = atom_pos0
    kd = _dense_past(k_pool, layer, block_tables, atom_slot, K, d)
    vd = _dense_past(v_pool, layer, block_tables, atom_slot, K, d)
    kd = kd.repeat_interleave(rep, dim=2)
    vd = vd.repeat_interleave(rep, dim=2)
    S = kd.shape[1]
    s = torch.einsum("ahd,ashd->ahs", q.float(), kd) / math.sqrt(d)
    col = torch.arange(S, device=q.device)[None, None, :]
    keep = col < atom_pos0.long()[:, None, None]
    if window is not None:
        keep = keep & (col > row_pos.long()[:, None, None] - window)
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
    return torch.einsum("ahs,ashd->ahd", p, vd), m, p.sum(dim=-1)


def decode_kernel_args(q, k_pool, v_pool, layer: int, block_tables,
                       atom_slot, atom_pos0, *, window=None, row_pos=None):
    """Kernel A's launcher arguments and its outputs ``(acc, m, l)``,
    allocated here (CUDA tensors)."""
    if row_pos is None:
        row_pos = atom_pos0
    A, H, d = q.shape
    L, nbp1, bs, K, rep = _pool_geometry((H, d), k_pool)
    nb_max = block_tables.shape[1]
    cuda_operand(q, "q", torch.bfloat16)
    cuda_operand(k_pool, "k_pool", torch.bfloat16)
    cuda_operand(v_pool, "v_pool", torch.bfloat16)
    bt = int32_meta(block_tables)
    slot = int32_meta(atom_slot)
    pos0, lo, nblk = _past_ranges(atom_pos0, row_pos, bs, nb_max, window)
    pos0, lo, nblk = int32_meta(pos0), int32_meta(lo), int32_meta(nblk)
    rpos = int32_meta(row_pos)
    acc = torch.empty(A, H, d, dtype=torch.float32, device=q.device)
    m = torch.empty(A, H, dtype=torch.float32, device=q.device)
    l = torch.empty(A, H, dtype=torch.float32, device=q.device)
    args = (q, k_pool, v_pool, int(layer), nbp1, bs, H, K, d, bt, nb_max,
            slot, pos0, rpos, lo, nblk, A, int(window or 0),
            1.0 / math.sqrt(d), acc, m, l, stream_ptr(q))
    return args, (acc, m, l)


def decode_pool_partials(q, k_pool, v_pool, layer: int, block_tables,
                         atom_slot, atom_pos0, *, window=None, row_pos=None):
    """(acc, m, l) flash-decode partials of each decode row over its pooled
    past (positions < pos0). ``row_pos`` is the query's own position
    (default pos0); it anchors the sliding window, e.g. in the fused decode
    loop where rows advance while the pool frontier stays put. q [A,H,d];
    pools [L, nb+1, bs, K*d]. Kernel A on CUDA, plain version on CPU."""
    if row_pos is None:
        row_pos = atom_pos0
    if on_cpu(q, k_pool, v_pool, block_tables, atom_slot, atom_pos0,
              row_pos):
        return plain_decode_partials(q, k_pool, v_pool, layer, block_tables,
                                     atom_slot, atom_pos0, window=window,
                                     row_pos=row_pos)
    args, out = decode_kernel_args(q, k_pool, v_pool, layer, block_tables,
                                   atom_slot, atom_pos0, window=window,
                                   row_pos=row_pos)
    KERNELS["paged_decode"].launch(*args)
    return out


def _decode_attention(q, k_self, v_self, k_pool, v_pool, layer, block_tables,
                      atom_slot, atom_pos0, atom_len, *, window):
    """Decode-row attention: kernel A's pool partials merged with the self
    token (position pos0: always visible, inside any window). The merge is
    plain torch. Shapes q/k_self/v_self [A, H|K, d]."""
    A, H, d = q.shape
    rep = H // k_self.shape[-2]
    acc, m_k, l_k = decode_pool_partials(
        q, k_pool, v_pool, layer, block_tables, atom_slot, atom_pos0,
        window=window)
    qf = q.float()
    ks = k_self.float().repeat_interleave(rep, dim=1)
    vs = v_self.float().repeat_interleave(rep, dim=1)
    s_self = (qf * ks).sum(dim=-1) / math.sqrt(d)
    m2 = torch.maximum(m_k, s_self)
    c_k = torch.exp(m_k - m2)
    c_s = torch.exp(s_self - m2)
    denom = torch.clamp_min(l_k * c_k + c_s, 1e-30)
    out = (acc * c_k[..., None] + vs * c_s[..., None]) / denom[..., None]
    out = torch.where(atom_len[:, None, None] > 0, out, 0.0)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# B: chunk-atom past partials
# ---------------------------------------------------------------------------

def plain_past_partials(q, k_pool, v_pool, layer: int, block_tables,
                        atom_slot, atom_pos0, tq: int, *, window=None):
    """Plain version of kernel B: per-kv-head partials of each chunk atom's
    rows over its pooled past. q packed [N = A*tq, H, d]. Returns acc
    [A, K, R=tq*rep, d], m/l [A, K, R] with row ``t*rep + rr`` = token t,
    head ``kk*rep + rr``."""
    N, H, d = q.shape
    _, _, bs, K, rep = _pool_geometry((H, d), k_pool)
    A, R = N // tq, tq * rep
    kd = _dense_past(k_pool, layer, block_tables, atom_slot, K, d)
    vd = _dense_past(v_pool, layer, block_tables, atom_slot, K, d)
    S = kd.shape[1]
    qk = (q.float().reshape(A, tq, K, rep, d).permute(0, 2, 1, 3, 4)
          .reshape(A, K, R, d))
    s = torch.einsum("akrd,askd->akrs", qk, kd) / math.sqrt(d)
    pos0 = atom_pos0.long()[:, None, None, None]
    col = torch.arange(S, device=q.device)[None, None, None, :]
    keep = col < pos0
    if window is not None:
        t = (torch.arange(R, device=q.device) // rep)[None, None, :, None]
        keep = keep & (col > pos0 + t - window)
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
    return torch.einsum("akrs,askd->akrd", p, vd), m, p.sum(dim=-1)


def past_kernel_args(q, k_pool, v_pool, layer: int, block_tables, atom_slot,
                     atom_pos0, tq: int, *, window=None):
    """Kernel B's launcher arguments and its outputs ``(acc, m, l)``. The
    oldest row of each atom (position pos0) bounds the window's first live
    block."""
    N, H, d = q.shape
    L, nbp1, bs, K, rep = _pool_geometry((H, d), k_pool)
    A, R = N // tq, tq * rep
    nb_max = block_tables.shape[1]
    cuda_operand(q, "q", torch.bfloat16)
    cuda_operand(k_pool, "k_pool", torch.bfloat16)
    cuda_operand(v_pool, "v_pool", torch.bfloat16)
    bt = int32_meta(block_tables)
    slot = int32_meta(atom_slot)
    pos0, lo, nblk = _past_ranges(atom_pos0, atom_pos0, bs, nb_max, window)
    pos0, lo, nblk = int32_meta(pos0), int32_meta(lo), int32_meta(nblk)
    acc = torch.empty(A, K, R, d, dtype=torch.float32, device=q.device)
    m = torch.empty(A, K, R, dtype=torch.float32, device=q.device)
    l = torch.empty(A, K, R, dtype=torch.float32, device=q.device)
    args = (q, k_pool, v_pool, int(layer), nbp1, bs, H, K, d, bt, nb_max,
            slot, pos0, lo, nblk, A, tq, int(window or 0),
            1.0 / math.sqrt(d), acc, m, l, stream_ptr(q))
    return args, (acc, m, l)


def past_partials(q, k_pool, v_pool, layer: int, block_tables, atom_slot,
                  atom_pos0, tq: int, *, window=None):
    """Kernel B on CUDA, :func:`plain_past_partials` on CPU (same
    layouts)."""
    if on_cpu(q, k_pool, v_pool, block_tables, atom_slot, atom_pos0):
        return plain_past_partials(q, k_pool, v_pool, layer, block_tables,
                                   atom_slot, atom_pos0, tq, window=window)
    args, out = past_kernel_args(q, k_pool, v_pool, layer, block_tables,
                                 atom_slot, atom_pos0, tq, window=window)
    KERNELS["paged_past"].launch(*args)
    return out


# ---------------------------------------------------------------------------
# C: seeded chunk-self flash
# ---------------------------------------------------------------------------

def plain_self_attention(q, k_self, v_self, atom_len, tq: int, seed=None, *,
                         window=None):
    """Plain version of kernel C. q packed [N = A*tq, H, d], k/v_self
    [N, K, d]; ``seed`` = (acc, m, l) in :func:`past_partials`' layout or
    None (no past). Keeps col <= row, col < atom_len and the window; rows
    >= atom_len come out zero. Returns [N, H, d] in q's dtype."""
    N, H, d = q.shape
    K = k_self.shape[1]
    rep, A = H // K, N // tq
    qa = q.float().reshape(A, tq, H, d)
    ka = k_self.float().reshape(A, tq, K, d).repeat_interleave(rep, dim=2)
    va = v_self.float().reshape(A, tq, K, d).repeat_interleave(rep, dim=2)
    s = torch.einsum("athd,ashd->ahts", qa, ka) / math.sqrt(d)
    row = torch.arange(tq, device=q.device)[:, None]
    col = torch.arange(tq, device=q.device)[None, :]
    alen = atom_len.long()[:, None, None, None]
    keep = (col <= row)[None, None] & (col[None, None] < alen)
    if window is not None:
        keep = keep & (col > row - window)[None, None]
    if seed is None:
        m0 = torch.full((A, H, tq), NEG_INF, device=q.device)
        l0 = torch.zeros(A, H, tq, device=q.device)
        a0 = torch.zeros(A, H, tq, d, device=q.device)
    else:
        acc_p, m_p, l_p = seed

        def to_hq(x):  # [A, K, (tq, rep), ...] -> [A, H, tq, ...]
            x = x.reshape(A, K, tq, rep, *x.shape[3:]).transpose(2, 3)
            return x.reshape(A, H, tq, *x.shape[4:])
        m0, l0, a0 = to_hq(m_p), to_hq(l_p), to_hq(acc_p)
    s = torch.where(keep, s, NEG_INF)
    m_new = torch.maximum(m0, s.amax(dim=-1))
    p = torch.where(keep, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m0 - m_new)
    l = l0 * corr + p.sum(dim=-1)
    acc = a0 * corr[..., None] + torch.einsum("ahts,ashd->ahtd", p, va)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = torch.where(row[None, None] < alen, out, 0.0)        # [A,H,tq,d]
    return out.transpose(1, 2).reshape(N, H, d).to(q.dtype)


def self_kernel_args(q, k_self, v_self, atom_len, tq: int, seed=None, *,
                     window=None):
    """Kernel C's launcher arguments and its output ``(out,)``."""
    N, H, d = q.shape
    K = k_self.shape[1]
    cuda_operand(q, "q", torch.bfloat16)
    k_self = cuda_operand(k_self.to(q.dtype).contiguous(), "k_self",
                          torch.bfloat16)
    v_self = cuda_operand(v_self.to(q.dtype).contiguous(), "v_self",
                          torch.bfloat16)
    alen = int32_meta(atom_len)
    if seed is not None:
        acc_p, m_p, l_p = (cuda_operand(x, n, torch.float32) for x, n in
                           zip(seed, ("seed acc", "seed m", "seed l")))
        seeds = (m_p, l_p, acc_p)
    else:
        seeds = (None, None, None)
    out = torch.empty_like(q)
    args = (q, k_self, v_self, alen, *seeds, out, N // tq, tq, H, K, d,
            int(window or 0), 1.0 / math.sqrt(d), stream_ptr(q))
    return args, (out,)


def self_attention(q, k_self, v_self, atom_len, tq: int, seed=None, *,
                   window=None):
    """Kernel C on CUDA, :func:`plain_self_attention` on CPU."""
    if on_cpu(q, k_self, v_self, atom_len, *(seed or ())):
        return plain_self_attention(q, k_self, v_self, atom_len, tq, seed,
                                    window=window)
    args, (out,) = self_kernel_args(q, k_self, v_self, atom_len, tq, seed,
                                    window=window)
    KERNELS["chunk_self"].launch(*args)
    return out


def _prefill_attention(q, k_self, v_self, k_pool, v_pool, layer, block_tables,
                       atom_slot, atom_pos0, atom_len, tq, *, window,
                       no_past=False):
    """Chunk-atom attention = kernel B's past partials + kernel C's seeded
    self flash. ``no_past`` (every atom starts at position 0) skips B."""
    seed = None
    if not no_past:
        seed = past_partials(q, k_pool, v_pool, layer, block_tables,
                             atom_slot, atom_pos0, tq, window=window)
    return self_attention(q, k_self, v_self, atom_len, tq, seed,
                          window=window)


def ragged_paged_attention(q, k_self, v_self, k_pool, v_pool, block_tables,
                           atom_slot, atom_pos0, atom_len, tq: int,
                           window: Optional[int] = None, layer: int = 0,
                           no_past: bool = False) -> torch.Tensor:
    """Attention over the atoms of the packed token row: ``q``/``k_self``/
    ``v_self`` [N, H|K, d] with N = n_atoms*tq; atom ``a`` covers rows
    ``[a*tq, a*tq + atom_len[a])`` at positions ``atom_pos0[a] + i`` of slot
    ``atom_slot[a]``. Pools are stacked lane-folded; ``layer`` picks the
    layer. Returns [N, H, d]."""
    if tq == 1:
        return _decode_attention(q, k_self, v_self, k_pool, v_pool, layer,
                                 block_tables, atom_slot, atom_pos0, atom_len,
                                 window=window)
    return _prefill_attention(q, k_self, v_self, k_pool, v_pool, layer,
                              block_tables, atom_slot, atom_pos0, atom_len,
                              tq, window=window, no_past=no_past)


def plain_ragged_attention(q, k_self, v_self, k_pool, v_pool, block_tables,
                           atom_slot, atom_pos0, atom_len, tq: int,
                           window: Optional[int] = None, layer: int = 0):
    """The whole of :func:`ragged_paged_attention` as one dense gather (the
    TPU package's ``xla_ragged_attention`` :1331), fp32: the parity
    reference for the split past + self path."""
    N, H, d = q.shape
    _, _, bs, K, rep = _pool_geometry((H, d), k_pool)
    A = N // tq
    kd = _dense_past(k_pool, layer, block_tables, atom_slot, K, d)
    vd = _dense_past(v_pool, layer, block_tables, atom_slot, K, d)
    S = kd.shape[1]
    k_all = torch.cat([kd, k_self.float().reshape(A, tq, K, d)], dim=1)
    v_all = torch.cat([vd, v_self.float().reshape(A, tq, K, d)], dim=1)
    k_all = k_all.repeat_interleave(rep, dim=2)
    v_all = v_all.repeat_interleave(rep, dim=2)
    s = torch.einsum("athd,ashd->ahts", q.float().reshape(A, tq, H, d),
                     k_all) / math.sqrt(d)
    dev = q.device
    pos0 = atom_pos0.long()
    alen = atom_len.long()
    t = torch.arange(tq, device=dev)
    row = (pos0[:, None] + t[None, :])[:, None, :, None]       # [A,1,tq,1]
    colpos = torch.cat([torch.arange(S, device=dev).expand(A, S),
                        pos0[:, None] + t[None, :]], dim=1)[:, None, None, :]
    is_past = (torch.arange(S + tq, device=dev) < S)[None, None, None, :]
    keep = torch.where(is_past, colpos < pos0[:, None, None, None],
                       colpos <= row)
    keep = keep & (t[None, None, :, None] < alen[:, None, None, None])
    own = (torch.arange(S + tq, device=dev) - S)[None, None, None, :]
    keep = keep & (is_past | (own < alen[:, None, None, None]))
    if window is not None:
        keep = keep & (colpos > row - window)
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("ahts,ashd->athd", p, v_all)
    out = torch.where((t[None, :] < alen[:, None])[:, :, None, None], out, 0.0)
    return out.reshape(N, H, d).to(q.dtype)


def packed_kv_append(pool: torch.Tensor, new_rows: torch.Tensor,
                     block_tables: torch.Tensor, tok_slot: torch.Tensor,
                     tok_pos: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write per-token KV rows of ALL layers into the stacked pool
    ``[L, nb+1, bs, K*d]`` IN PLACE (one ``index_copy_`` on the flat
    ``[L*(nb+1)*bs, K*d]`` view) and return the same tensor.
    ``new_rows`` [L, N, K, d] or [L, N, K*d]; metadata [N]. Rows with
    ``valid`` False are filtered out before the copy (never written, and
    never given an index that could wrap)."""
    L, nbp1, bs, KD = pool.shape
    N = new_rows.shape[1]
    rows = new_rows.reshape(L, N, KD)
    bt_rows = block_tables[tok_slot.long()].long()             # [N, nb_max]
    logical = torch.clamp(torch.div(tok_pos.long(), bs, rounding_mode="floor"),
                          0, bt_rows.shape[1] - 1)
    phys = bt_rows.gather(1, logical[:, None])[:, 0]
    off = tok_pos.long() % bs
    li = torch.arange(L, device=pool.device)[:, None]
    idx = (li * nbp1 + phys[None, :]) * bs + off[None, :]      # [L, N]
    if valid is not None:
        keep = valid.bool()
        rows, idx = rows[:, keep], idx[:, keep]
    flat = pool.view(L * nbp1 * bs, KD)
    flat.index_copy_(0, idx.reshape(-1),
                     rows.reshape(-1, KD).to(pool.dtype))
    return pool
