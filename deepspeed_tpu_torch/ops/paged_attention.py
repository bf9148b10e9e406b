"""Paged attention over the blocked KV pool (counterpart of
``deepspeed_tpu/ops/paged_attention.py``, single device).

The pool is stacked and lane-folded, ``[L, nb+1, bs, K*d]``: layer ``l``,
physical block ``b``, row ``o`` holds kv head ``kk`` in lanes
``[kk*d, (kk+1)*d)``; the last block is scratch. A quantized pool
(``kv_scale`` given) is int8 ``[L, nb+1, bs, K*d]`` or int4 ``[L, nb+1, bs,
K*d/2]`` with per-token dequant scales ``kv_scale [L, nb+1, 1, 2*bs]`` (k in
lanes ``[0, bs)``, v in ``[bs, 2bs)``); int4 pairs lanes GLOBALLY, byte ``j``
holding feature ``j`` (low nibble) and ``j + K*d/2`` (high), unlike the
in-group weight layout of ``ops/quant_matmul.py``. ``block_tables [S, nb_max]``
map each SLOT's logical blocks to physical ids (tail entries point at the
scratch block). An atom is a run of consecutive tokens of one slot starting
at ``atom_pos0``; the pool holds only tokens of earlier steps (positions
``< atom_pos0``), the atom's own K/V arrives beside it.

Kernels (each launched only for CUDA tensors; CPU tensors take the plain
version named in brackets):

* A ``decode_pool_partials`` -- flash-decode partials of 1-token atoms over
  their pooled past [``plain_decode_partials``]; over a quantized pool the
  kernels ``paged_decode_int8`` (int8 q-hat, integer score product) and
  ``paged_decode_int4``. One launch a call: the kernel computes the live
  ranges and the int8 q-hat itself, splits the past over CTAs
  (:func:`decode_splits`) and merges the splits in the same launch
  (:func:`merge_decode_partials` is the merge's plain twin, for tests);
* B ``past_partials`` -- the same for the ``tq*rep`` rows of chunk atoms,
  per kv head [``plain_past_partials``]; ``paged_past_int8`` /
  ``paged_past_int4`` over a quantized pool. One launch a call: the kernel
  computes the live ranges itself;
* C ``self_attention`` -- causal flash over each chunk atom's own tokens,
  seeded from B's partials [``plain_self_attention``]. B and C run kernel
  D's tile body, so a prompt chunked at multiples of 64 tokens gets D's
  bits for its whole-prompt attention;
* I ``paged_attention`` -- a dense query tile ``[B, t, H, d]`` (every slot a
  row, chunks right-padded) over each slot's paged KV, causal from
  ``pos[b]``: the ``packed=False`` engine's attention, after
  :func:`paged_update` has written the tile's own K/V into the layer
  [``plain_paged_attention``]. One launch a call: a decode step's rows
  (``t * rep <= 16``) split each slot's past over CTAs as A does
  (:func:`paged_tile_splits`, :func:`tile_live_blocks`), a wider tile runs
  kernel D's register-resident flash over the paged columns.

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

from deepspeed_tpu_torch.ops import (card_head_dim, cuda_operand, int32_meta,
                                     on_cpu, stream_ptr)
from deepspeed_tpu_torch.ops._build import KERNELS

NEG_INF = -1e30


def _past_ranges(atom_pos0: torch.Tensor, row_pos: torch.Tensor, bs: int,
                 nb_max: int, window: Optional[int]):
    """(pos0, lo block, live block count) of each atom's visible past.
    ``row_pos`` (>= pos0) anchors the window; ``pos0`` is the pool frontier.
    An atom with ``pos0 == 0`` has no live block. Kernels A and B compute
    the same in their prologues (the plain twin of their formula)."""
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


def _pool_geometry(q_heads_d, k_pool, kv_scale=None, kv_bits=8):
    H, d = q_heads_d
    L, nbp1, bs, KD = k_pool.shape
    if kv_scale is not None and kv_bits == 4:
        KD *= 2                          # two lanes per byte
    if KD % d:
        raise ValueError(f"pool lanes {KD} not a multiple of head_dim {d}")
    K = KD // d
    if H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    return L, nbp1, bs, K, H // K


def _quantize_q_rows(q: torch.Tensor):
    """Per-row (last-axis) int8 quantization of a query: (q_int8, scale
    [..., 1] fp32), scale = amax times the fp32 reciprocal of 127 (how XLA
    compiles the reference's ``amax / 127``), floor 1e-12 -- the int8-pool
    decode's q-hat, bit-identical to the reference's (:390) under jit.
    Kernel A computes the same in its prologue."""
    qf = q.float()
    qs = torch.clamp_min(qf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0),
                         1e-12)
    qi = torch.clamp(torch.round(qf / qs), -127, 127)
    return qi.to(torch.int8), qs


def _unpack_int4_lanes(packed: torch.Tensor) -> torch.Tensor:
    """[..., K*d/2] int4-packed bytes -> [..., K*d] fp32 values (global lane
    pairing: the low nibbles are features ``[0, K*d/2)``, the high ones the
    rest; the reference's ``_unpack_int4_lanes_xla`` :645)."""
    b = packed.to(torch.int32)                                 # sign-extended
    return torch.cat([(b << 28) >> 28, b >> 4], dim=-1).float()


def _dense_past(pool: torch.Tensor, layer: int, block_tables: torch.Tensor,
                atom_slot: torch.Tensor, K: int, d: int, kv_scale=None,
                which: int = 0, kv_bits: int = 8) -> torch.Tensor:
    """[A, nb_max*bs, K, d] fp32 gather of each atom's logical pool rows,
    dequantized per token (scale half ``which``: 0 = k, 1 = v) when
    ``kv_scale`` is given."""
    bt = block_tables[atom_slot.long()].long()                 # [A, nb_max]
    A, nb_max = bt.shape
    bs = pool.shape[2]
    rows = pool[layer][bt]                            # [A, nb_max, bs, lanes]
    if kv_scale is not None:
        rows = (_unpack_int4_lanes(rows) if kv_bits == 4 else rows.float())
        sc = kv_scale[layer][bt][:, :, 0, which * bs:(which + 1) * bs]
        rows = rows * sc[..., None]
    return rows.reshape(A, nb_max * bs, K, d).float()


# ---------------------------------------------------------------------------
# A: decode partials
# ---------------------------------------------------------------------------

def plain_decode_partials(q, k_pool, v_pool, layer: int, block_tables,
                          atom_slot, atom_pos0, *, window=None, row_pos=None,
                          kv_scale=None, kv_bits: int = 8):
    """Plain version of kernel A (the TPU package's ``xla_decode_partials``
    :655): dense gather, fp32; a quantized pool is dequantized per token and,
    for int8, q replaced by its int8 q-hat. Returns acc [A,H,d]
    (unnormalised), m, l [A,H]; an atom with nothing visible gets m = -1e30,
    l = 0, acc = 0."""
    A, H, d = q.shape
    _, _, bs, K, rep = _pool_geometry((H, d), k_pool, kv_scale, kv_bits)
    if row_pos is None:
        row_pos = atom_pos0
    kd = _dense_past(k_pool, layer, block_tables, atom_slot, K, d, kv_scale,
                     0, kv_bits)
    vd = _dense_past(v_pool, layer, block_tables, atom_slot, K, d, kv_scale,
                     1, kv_bits)
    kd = kd.repeat_interleave(rep, dim=2)
    vd = vd.repeat_interleave(rep, dim=2)
    S = kd.shape[1]
    qf = q.float()
    if kv_scale is not None and kv_bits == 8:
        qi, qs = _quantize_q_rows(q)
        qf = qi.float() * qs
    s = torch.einsum("ahd,ashd->ahs", qf, kd) / math.sqrt(d)
    col = torch.arange(S, device=q.device)[None, None, :]
    keep = col < atom_pos0.long()[:, None, None]
    if window is not None:
        keep = keep & (col > row_pos.long()[:, None, None] - window)
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
    return torch.einsum("ahs,ashd->ahd", p, vd), m, p.sum(dim=-1)


# Kernel A's split of a past over CTAs (csrc/paged_decode.cu): a split is a
# run of whole pool blocks, at least _SPLIT_COLS columns; a grid has at most
# MAX_SPLITS splits an atom, a split at most MAX_SPLIT_BLOCKS blocks (the
# source's MAX_SPLITS and MAX_BPS: its shared memory is sized by them).
_SPLIT_COLS = 128
MAX_SPLITS = 64
MAX_SPLIT_BLOCKS = 128


def _block_splits(bs: int, nb_max: int, max_splits: int, max_blocks: int,
                  kernel: str) -> Tuple[int, int]:
    """(blocks a split, splits a grid): runs of whole pool blocks, at least
    ``_SPLIT_COLS`` columns each, at most ``max_splits`` of them over a
    table of ``nb_max`` blocks, at most ``max_blocks`` blocks each."""
    bps = max(-(-_SPLIT_COLS // bs), -(-nb_max // max_splits))
    if bps > max_blocks:
        raise ValueError(f"a block table of {nb_max} blocks of {bs} rows "
                         f"needs {bps} blocks a split; {kernel} takes at "
                         f"most {max_blocks}")
    return bps, -(-nb_max // bps)


def decode_splits(bs: int, nb_max: int) -> Tuple[int, int]:
    """(blocks a split, splits a grid) of kernel A for block size ``bs`` and
    a block table of ``nb_max`` blocks: split ``z`` of an atom covers its
    live blocks ``[lo + z*bps, lo + (z+1)*bps)`` (:func:`_past_ranges`)."""
    return _block_splits(bs, nb_max, MAX_SPLITS, MAX_SPLIT_BLOCKS, "kernel A")


def merge_decode_partials(parts):
    """Merge flash-decode partials ``[(acc, m, l), ...]`` of disjoint column
    ranges of the same rows, in list order, as kernel A merges its splits:
    m = max m_z, f_z = exp(m_z - m), l = sum f_z l_z, acc = sum f_z acc_z
    (fp32). Plain torch; the tests' model of the kernel's merge."""
    m = parts[0][1]
    for _, mz, _ in parts[1:]:
        m = torch.maximum(m, mz)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for az, mz, lz in parts:
        f = torch.exp(mz - m)
        l = l + f * lz
        acc = acc + f[..., None] * az
    return acc, m, l


_tickets = {}


def _ticket_buffer(device, n: int) -> torch.Tensor:
    """Kernel A's and kernel I's split tickets on ``device``: int32, zero
    between launches (the last split of each atom or slot and kv head group
    resets its own). One buffer a device, so launches on it must be ordered
    (one stream)."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


def decode_groups(H: int, K: int, kv_scale=None, kv_bits: int = 8) -> int:
    """Kernel A's kv head groups (the grid's y): an int4 pool with even K and
    at most 8 heads a group pairs kv heads kk and kk + K/2 in one CTA (the
    two nibbles of each byte); otherwise a CTA takes 16 heads of one kv
    head's group."""
    rep = H // K
    if kv_scale is not None and kv_bits == 4 and K % 2 == 0 and rep <= 8:
        return K // 2
    return K * -(-rep // 16)


def kernel_name(base: str, kv_scale=None, kv_bits: int = 8) -> str:
    """The kernel of ``base`` (``paged_decode`` / ``paged_past``) for this
    pool: the bf16 one, or its int8 / int4 mode."""
    return base if kv_scale is None else f"{base}_int{kv_bits}"


def _pool_operands(k_pool, v_pool, kv_scale, kv_bits):
    """Checked pool operands of A/B's launchers: the bf16 pools, or the int
    pools and their scales."""
    if kv_scale is None:
        cuda_operand(k_pool, "k_pool", torch.bfloat16)
        cuda_operand(v_pool, "v_pool", torch.bfloat16)
        return (k_pool, v_pool)
    if kv_bits not in (4, 8):
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    cuda_operand(k_pool, "k_pool", torch.int8)
    cuda_operand(v_pool, "v_pool", torch.int8)
    L, nbp1, bs = k_pool.shape[:3]
    if tuple(kv_scale.shape) != (L, nbp1, 1, 2 * bs):
        raise ValueError(f"kv_scale must be [L, nb+1, 1, 2*bs] = "
                         f"{(L, nbp1, 1, 2 * bs)}, got {tuple(kv_scale.shape)}")
    cuda_operand(kv_scale, "kv_scale", torch.float32)
    return (k_pool, v_pool, kv_scale)


def decode_kernel_args(q, k_pool, v_pool, layer: int, block_tables,
                       atom_slot, atom_pos0, *, window=None, row_pos=None,
                       kv_scale=None, kv_bits: int = 8):
    """Kernel A's (or its int mode's, :func:`kernel_name`) launcher
    arguments and its outputs ``(acc, m, l)``, allocated here (CUDA tensors),
    with the split workspace. No other launch: the kernel computes the live
    ranges and, over an int8 pool, the q-hat."""
    if row_pos is None:
        row_pos = atom_pos0
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    A, H, d = q.shape
    L, nbp1, bs, K, rep = _pool_geometry((H, d), k_pool, kv_scale, kv_bits)
    card_head_dim(d, "kernel A")
    nb_max = block_tables.shape[1]
    cuda_operand(q, "q", torch.bfloat16)
    pools = _pool_operands(k_pool, v_pool, kv_scale, kv_bits)
    bps, nsplit = decode_splits(bs, nb_max)
    dev = q.device
    ws = torch.empty(A * H * nsplit * (d + 2), dtype=torch.float32,
                     device=dev)
    tickets = _ticket_buffer(dev, A * decode_groups(H, K, kv_scale, kv_bits))
    acc = torch.empty(A, H, d, dtype=torch.float32, device=dev)
    m = torch.empty(A, H, dtype=torch.float32, device=dev)
    l = torch.empty(A, H, dtype=torch.float32, device=dev)
    args = (q, *pools, int(layer), nbp1, bs, H, K, d,
            int32_meta(block_tables), nb_max, int32_meta(atom_slot),
            int32_meta(atom_pos0), int32_meta(row_pos), A, int(window or 0),
            1.0 / math.sqrt(d), bps, nsplit, ws, tickets, acc, m, l,
            stream_ptr(q))
    return args, (acc, m, l)


def decode_pool_partials(q, k_pool, v_pool, layer: int, block_tables,
                         atom_slot, atom_pos0, *, window=None, row_pos=None,
                         kv_scale=None, kv_bits: int = 8):
    """(acc, m, l) flash-decode partials of each decode row over its pooled
    past (positions < pos0). ``row_pos`` is the query's own position
    (default pos0); it anchors the sliding window, e.g. in the fused decode
    loop where rows advance while the pool frontier stays put. q [A,H,d];
    pools [L, nb+1, bs, K*d] bf16, or int8/int4 with ``kv_scale``
    (``kv_bits``). Kernel A (or its int mode) on CUDA, plain version on
    CPU."""
    if row_pos is None:
        row_pos = atom_pos0
    kw = dict(window=window, row_pos=row_pos, kv_scale=kv_scale,
              kv_bits=kv_bits)
    extra = () if kv_scale is None else (kv_scale,)
    if on_cpu(q, k_pool, v_pool, block_tables, atom_slot, atom_pos0,
              row_pos, *extra):
        return plain_decode_partials(q, k_pool, v_pool, layer, block_tables,
                                     atom_slot, atom_pos0, **kw)
    args, out = decode_kernel_args(q, k_pool, v_pool, layer, block_tables,
                                   atom_slot, atom_pos0, **kw)
    KERNELS[kernel_name("paged_decode", kv_scale, kv_bits)].launch(*args)
    return out


def _decode_attention(q, k_self, v_self, k_pool, v_pool, layer, block_tables,
                      atom_slot, atom_pos0, atom_len, *, window, kv_scale=None,
                      kv_bits=8):
    """Decode-row attention: kernel A's pool partials merged with the self
    token (position pos0: always visible, inside any window; never
    quantized). The merge is plain torch. Shapes q/k_self/v_self
    [A, H|K, d]."""
    A, H, d = q.shape
    rep = H // k_self.shape[-2]
    acc, m_k, l_k = decode_pool_partials(
        q, k_pool, v_pool, layer, block_tables, atom_slot, atom_pos0,
        window=window, kv_scale=kv_scale, kv_bits=kv_bits)
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
                        atom_slot, atom_pos0, tq: int, *, window=None,
                        kv_scale=None, kv_bits: int = 8):
    """Plain version of kernel B: per-kv-head partials of each chunk atom's
    rows over its pooled past (a quantized pool dequantized per token; q is
    never quantized here, as in the reference's ``_past_kernel`` :857).
    q packed [N = A*tq, H, d]. Returns acc [A, K, R=tq*rep, d], m/l
    [A, K, R] with row ``t*rep + rr`` = token t, head ``kk*rep + rr``."""
    N, H, d = q.shape
    _, _, bs, K, rep = _pool_geometry((H, d), k_pool, kv_scale, kv_bits)
    A, R = N // tq, tq * rep
    kd = _dense_past(k_pool, layer, block_tables, atom_slot, K, d, kv_scale,
                     0, kv_bits)
    vd = _dense_past(v_pool, layer, block_tables, atom_slot, K, d, kv_scale,
                     1, kv_bits)
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
                     atom_pos0, tq: int, *, window=None, kv_scale=None,
                     kv_bits: int = 8):
    """Kernel B's (or its int mode's) launcher arguments and its outputs
    ``(acc, m, l)``, allocated here (CUDA tensors). No other launch: the
    kernel computes each atom's live range (:func:`_past_ranges`, the window
    anchored at the atom's oldest row, position pos0) itself."""
    N, H, d = q.shape
    card_head_dim(d, "kernel B")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    L, nbp1, bs, K, rep = _pool_geometry((H, d), k_pool, kv_scale, kv_bits)
    A, R = N // tq, tq * rep
    nb_max = block_tables.shape[1]
    cuda_operand(q, "q", torch.bfloat16)
    pools = _pool_operands(k_pool, v_pool, kv_scale, kv_bits)
    bt = int32_meta(block_tables)
    slot = int32_meta(atom_slot)
    pos0 = int32_meta(atom_pos0)
    acc = torch.empty(A, K, R, d, dtype=torch.float32, device=q.device)
    m = torch.empty(A, K, R, dtype=torch.float32, device=q.device)
    l = torch.empty(A, K, R, dtype=torch.float32, device=q.device)
    args = (q, *pools, int(layer), nbp1, bs, H, K, d, bt, nb_max,
            slot, pos0, A, tq, int(window or 0),
            1.0 / math.sqrt(d), acc, m, l, stream_ptr(q))
    return args, (acc, m, l)


def past_partials(q, k_pool, v_pool, layer: int, block_tables, atom_slot,
                  atom_pos0, tq: int, *, window=None, kv_scale=None,
                  kv_bits: int = 8):
    """Kernel B (or its int mode) on CUDA, :func:`plain_past_partials` on
    CPU (same layouts)."""
    kw = dict(window=window, kv_scale=kv_scale, kv_bits=kv_bits)
    extra = () if kv_scale is None else (kv_scale,)
    if on_cpu(q, k_pool, v_pool, block_tables, atom_slot, atom_pos0, *extra):
        return plain_past_partials(q, k_pool, v_pool, layer, block_tables,
                                   atom_slot, atom_pos0, tq, **kw)
    args, out = past_kernel_args(q, k_pool, v_pool, layer, block_tables,
                                 atom_slot, atom_pos0, tq, **kw)
    KERNELS[kernel_name("paged_past", kv_scale, kv_bits)].launch(*args)
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
    card_head_dim(d, "kernel C")
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
                       no_past=False, kv_scale=None, kv_bits=8):
    """Chunk-atom attention = kernel B's past partials + kernel C's seeded
    self flash (the atom's own KV stays in compute precision). ``no_past``
    (every atom starts at position 0) skips B."""
    seed = None
    if not no_past:
        seed = past_partials(q, k_pool, v_pool, layer, block_tables,
                             atom_slot, atom_pos0, tq, window=window,
                             kv_scale=kv_scale, kv_bits=kv_bits)
    return self_attention(q, k_self, v_self, atom_len, tq, seed,
                          window=window)


def ragged_paged_attention(q, k_self, v_self, k_pool, v_pool, block_tables,
                           atom_slot, atom_pos0, atom_len, tq: int,
                           window: Optional[int] = None, layer: int = 0,
                           no_past: bool = False, kv_scale=None,
                           kv_bits: int = 8) -> torch.Tensor:
    """Attention over the atoms of the packed token row: ``q``/``k_self``/
    ``v_self`` [N, H|K, d] with N = n_atoms*tq; atom ``a`` covers rows
    ``[a*tq, a*tq + atom_len[a])`` at positions ``atom_pos0[a] + i`` of slot
    ``atom_slot[a]``. Pools are stacked lane-folded (bf16, or int8/int4 with
    ``kv_scale``); ``layer`` picks the layer. Returns [N, H, d]."""
    kw = dict(window=window, kv_scale=kv_scale, kv_bits=kv_bits)
    if tq == 1:
        return _decode_attention(q, k_self, v_self, k_pool, v_pool, layer,
                                 block_tables, atom_slot, atom_pos0, atom_len,
                                 **kw)
    return _prefill_attention(q, k_self, v_self, k_pool, v_pool, layer,
                              block_tables, atom_slot, atom_pos0, atom_len,
                              tq, no_past=no_past, **kw)


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


def cache_append(cache: dict, k_rows: torch.Tensor, v_rows: torch.Tensor,
                 block_tables: torch.Tensor, tok_slot: torch.Tensor,
                 tok_pos: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> None:
    """Append per-token K/V rows of every layer ([L, N, K, d]) to a paged
    cache dict in place: :func:`packed_kv_append` into bf16 pools, or
    :func:`packed_kv_append_quant` into int pools and ``cache["kv_scale"]``
    (int4 when the pool has half the rows' ``K*d`` lanes)."""
    if "kv_scale" not in cache:
        for pool, rows in ((cache["k"], k_rows), (cache["v"], v_rows)):
            packed_kv_append(pool, rows, block_tables, tok_slot, tok_pos,
                             valid)
        return
    KD = k_rows.shape[-1] * k_rows.shape[-2]
    bits = 4 if 2 * cache["k"].shape[-1] == KD else 8
    for which, (pool, rows) in enumerate(((cache["k"], k_rows),
                                          (cache["v"], v_rows))):
        packed_kv_append_quant(pool, cache["kv_scale"], rows, block_tables,
                               tok_slot, tok_pos, which, valid, bits=bits)


def packed_kv_append_quant(pool: torch.Tensor, scale_pool: torch.Tensor,
                           new_rows: torch.Tensor, block_tables: torch.Tensor,
                           tok_slot: torch.Tensor, tok_pos: torch.Tensor,
                           which: int, valid: Optional[torch.Tensor] = None,
                           bits: int = 8):
    """Quantize per-token KV rows of ALL layers and write them into an
    int8/int4 pool IN PLACE, with their scales into ``scale_pool``
    ``[L, nb+1, 1, 2*bs]`` half ``which`` (0 = k, 1 = v); returns ``(pool,
    scale_pool)`` (the same tensors). One scale per token over all ``K*d``
    features: amax times the fp32 reciprocal of qmax (127 or 7; XLA
    compiles the reference's ``amax / qmax`` so), floor 1e-8, values rounded
    half-to-even and clipped to ``+-qmax``; int4 packs feature ``j`` with
    ``j + K*d/2`` (global lane pairing). Bit-identical to the reference's
    ``packed_kv_append_quant`` (:1268) under jit. ``new_rows`` [L, N, K, d] or
    [L, N, K*d]; rows with ``valid`` False are never written."""
    L, nbp1, bs, lanes = pool.shape
    N = new_rows.shape[1]
    KD = (new_rows.shape[-1] * new_rows.shape[-2] if new_rows.ndim == 4
          else new_rows.shape[-1])
    rows = new_rows.reshape(L, N, KD).float()
    qmax = 7.0 if bits == 4 else 127.0
    sc = torch.clamp_min(rows.abs().amax(dim=-1) * (1.0 / qmax), 1e-8)
    q = torch.clamp(torch.round(rows / sc[..., None]), -qmax, qmax)
    q = q.to(torch.int32)
    if bits == 4:
        q = (q[..., :KD // 2] & 0xF) | ((q[..., KD // 2:] & 0xF) << 4)
    q = q.to(torch.int8)
    bt_rows = block_tables[tok_slot.long()].long()             # [N, nb_max]
    logical = torch.clamp(torch.div(tok_pos.long(), bs, rounding_mode="floor"),
                          0, bt_rows.shape[1] - 1)
    phys = bt_rows.gather(1, logical[:, None])[:, 0]
    off = tok_pos.long() % bs
    blk = torch.arange(L, device=pool.device)[:, None] * nbp1 + phys[None, :]
    idx = blk * bs + off[None, :]                              # [L, N]
    sidx = blk * (2 * bs) + which * bs + off[None, :]
    if valid is not None:
        keep = valid.bool()
        q, sc, idx, sidx = q[:, keep], sc[:, keep], idx[:, keep], sidx[:, keep]
    pool.view(L * nbp1 * bs, lanes).index_copy_(0, idx.reshape(-1),
                                                 q.reshape(-1, lanes))
    scale_pool.view(-1).index_copy_(0, sidx.reshape(-1), sc.reshape(-1))
    return pool, scale_pool


# ---------------------------------------------------------------------------
# I: dense query tile over the paged pool (the packed=False engine)
# ---------------------------------------------------------------------------

def physical_positions(block_tables: torch.Tensor, positions: torch.Tensor,
                       block_size: int):
    """Global token positions [B, t] -> (physical block [B, t], offset
    [B, t]). The logical block is clipped to ``nb_max - 1`` (the
    reference's :76): a lane past the table lands in the slot's last
    block, and redirecting it is the caller's concern (:func:`paged_update`'s
    ``valid``)."""
    logical = torch.clamp(torch.div(positions.long(), block_size,
                                    rounding_mode="floor"),
                          0, block_tables.shape[1] - 1)
    phys = torch.gather(block_tables.long(), 1, logical)
    return phys, positions.long() % block_size


def paged_update(pool: torch.Tensor, new: torch.Tensor,
                 block_tables: torch.Tensor, pos: torch.Tensor,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write new KV ``[B, t, K, d]`` into ONE layer's blocks IN PLACE at
    each slot's positions ``pos[b] + i`` and return ``pool``. ``pool`` is
    ``[nb+1, bs, ...]`` holding ``K*d`` values a row: the lane-folded
    ``[nb+1, bs, K*d]`` view of a stacked pool's layer (``cache["k"][l]``),
    or ``[nb+1, bs, K, d]``; the last block is scratch. Lanes with ``valid``
    False land in the scratch block (the reference's :88)."""
    nbp1, bs = pool.shape[:2]
    B, t = new.shape[:2]
    gpos = pos.long()[:, None] + torch.arange(t, device=pool.device)[None]
    phys, off = physical_positions(block_tables, gpos, bs)
    if valid is not None:
        phys = torch.where(valid.bool(), phys, nbp1 - 1)
    flat = pool.view(nbp1 * bs, -1)
    flat.index_copy_(0, (phys * bs + off).reshape(-1),
                     new.reshape(B * t, flat.shape[1]).to(pool.dtype))
    return pool


def plain_paged_attention(q, k_pool, v_pool, block_tables, pos,
                          window: Optional[int] = None, layer: int = 0):
    """Plain version of kernel I (the reference's ``xla_paged_attention``
    :212): each slot's ``nb_max`` blocks gathered dense, fp32 scores per
    kv-head group, row ``i`` of slot ``b`` (position ``pos[b] + i``) keeping
    columns ``<= pos[b] + i`` (and ``> pos[b] + i - window``). A row with
    nothing visible gives 0, as the TPU kernel's ``_finalize`` (:155).
    q [B, t, H, d]; pools stacked lane-folded ``[L, nb+1, bs, K*d]`` read
    at ``layer``. Returns [B, t, H, d] in q's dtype."""
    B, t, H, d = q.shape
    _, _, bs, K, rep = _pool_geometry((H, d), k_pool)
    bt = block_tables.long()
    S = bt.shape[1] * bs
    kd = k_pool[layer][bt].reshape(B, S, K, d).float()
    vd = v_pool[layer][bt].reshape(B, S, K, d).float()
    qg = q.float().reshape(B, t, K, rep, d)
    s = torch.einsum("btkrd,bskd->bkrts", qg, kd) / math.sqrt(d)
    row = (pos.long()[:, None] + torch.arange(t, device=q.device)[None])
    row = row[:, None, None, :, None]                       # [B,1,1,t,1]
    col = torch.arange(S, device=q.device)
    keep = col <= row
    if window is not None:
        keep = keep & (col > row - window)
    s = torch.where(keep, s, NEG_INF)
    p = torch.where(keep, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    acc = torch.einsum("bkrts,bskd->btkrd", p, vd)
    l = p.sum(dim=-1).permute(0, 3, 1, 2)                   # [B, t, K, rep]
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, t, H, d).to(q.dtype)


# Kernel I's regimes (csrc/paged_tile.cu): a call whose t * rep rows of a GQA
# group fit one m16 tile (TILE_DECODE_ROWS) runs the decode regime, its
# slots' live columns split over CTAs like kernel A's pasts (at most
# TILE_MAX_SPLITS splits of at most TILE_MAX_SPLIT_BLOCKS blocks: the
# source's MAX_SPLITS and MAX_BPS); a wider tile runs the flash regime.
TILE_DECODE_ROWS = 16
TILE_MAX_SPLITS = 64
TILE_MAX_SPLIT_BLOCKS = 128


def paged_tile_splits(bs: int, nb_max: int) -> Tuple[int, int]:
    """(blocks a split, splits a grid) of kernel I's decode regime: split
    ``z`` of a slot covers its live blocks ``[lo + z*bps, lo + (z+1)*bps)``
    (:func:`tile_live_blocks`)."""
    return _block_splits(bs, nb_max, TILE_MAX_SPLITS, TILE_MAX_SPLIT_BLOCKS,
                         "kernel I")


def tile_live_blocks(pos: torch.Tensor, t: int, bs: int, nb_max: int,
                     window: Optional[int] = None):
    """(first live block, live block count) of each slot of a ``t``-token
    tile: the columns from the window start of its oldest row (position
    ``pos``) to its newest (``pos + t - 1``), clamped to the table's
    ``nb_max*bs``. Kernel I's decode regime computes the same in its
    prologue; a slot with no live column has count 0."""
    p = pos.long()
    c_lo = (torch.clamp_min(p - (window - 1), 0) if window is not None
            else torch.zeros_like(p))
    c_hi = torch.clamp_max(p + t, nb_max * bs)
    lo = torch.div(c_lo, bs, rounding_mode="floor")
    n = torch.where(c_hi > c_lo,
                    torch.div(c_hi - 1, bs, rounding_mode="floor") + 1 - lo,
                    torch.zeros_like(p))
    return lo.to(torch.int32), n.to(torch.int32)


def paged_tile_kernel_args(q, k_pool, v_pool, block_tables, pos,
                           window: Optional[int] = None, layer: int = 0):
    """Kernel I's launcher arguments and its output ``(out,)`` [B, t, H, d]
    bf16. The decode regime's split, workspace and tickets come with them
    (a wider tile's launch takes none)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    B, t, H, d = q.shape
    L, nbp1, bs, K, rep = _pool_geometry((H, d), k_pool)
    card_head_dim(d, "kernel I")
    cuda_operand(q, "q", torch.bfloat16)
    _pool_operands(k_pool, v_pool, None, 8)
    bt = int32_meta(block_tables)
    nb_max = bt.shape[1]
    bps = nsplit = 0
    ws = tickets = None
    if t * rep <= TILE_DECODE_ROWS:
        bps, nsplit = paged_tile_splits(bs, nb_max)
        ws = torch.empty(B * H * t * nsplit * (d + 2), dtype=torch.float32,
                         device=q.device)
        tickets = _ticket_buffer(q.device, B * K)
    out = torch.empty_like(q)
    args = (q, k_pool, v_pool, int(layer), nbp1, bs, H, K, d, bt, nb_max,
            int32_meta(pos), B, t, int(window or 0), 1.0 / math.sqrt(d),
            bps, nsplit, ws, tickets, out, stream_ptr(q))
    return args, (out,)


def paged_attention(q, k_pool, v_pool, block_tables, pos,
                    window: Optional[int] = None, layer: int = 0
                    ) -> torch.Tensor:
    """Attention of a dense query tile over each slot's paged KV (the
    reference's :1379): ``q`` [B, t, H, d] in the model layout (rows past a
    slot's chunk are don't-care); pools stacked lane-folded ``[L, nb+1, bs,
    K*d]`` read at ``layer``; ``block_tables`` [B, nb_max]; ``pos`` [B]
    tokens cached per slot BEFORE this tile, whose own K/V must already be
    in the pool (:func:`paged_update`). Returns [B, t, H, d]. Kernel I on
    CUDA, :func:`plain_paged_attention` on CPU."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if on_cpu(q, k_pool, v_pool, block_tables, pos):
        return plain_paged_attention(q, k_pool, v_pool, block_tables, pos,
                                     window, layer)
    args, (out,) = paged_tile_kernel_args(q, k_pool, v_pool, block_tables,
                                          pos, window, layer)
    KERNELS["paged_tile"].launch(*args)
    return out
