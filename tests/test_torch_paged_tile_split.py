"""Kernel I's two regimes, on the CPU: its decode regime's split of each
slot's live columns over CTAs in plain torch -- per-split partials over
whole pool blocks, merged in split order (``merge_decode_partials``),
normalised, equal the unsplit ``plain_paged_attention`` (fp32: within 1e-5)
-- the split rule and the limits it shares with ``csrc/paged_tile.cu``, the
source's contract, and the wrapper's refusals. The kernel itself is held
against the plain version on the card (``test_torch_kernels_cuda.py``)."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import paged_attention as tpa

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "deepspeed_tpu_torch/csrc/paged_tile.cu"
TOL = dict(atol=1e-5, rtol=1e-5)
K, D = 2, 16


def _case(H, t, bs, nb_max, seed):
    """Four slots over a stacked 2-layer pool (the data in layer 1): a fresh
    tile, one across a block edge, one deep in the table, and one whose
    padded rows pass the table's end."""
    rng = np.random.default_rng(seed)
    nbp1 = 4 * nb_max + 1
    bt = torch.from_numpy(rng.permutation(nbp1 - 1).reshape(4, nb_max)
                          .astype(np.int32))
    S = nb_max * bs
    pos = torch.tensor([0, bs - 1, S // 2 + 3, S - 2], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((4, t, H, D)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((2, nbp1, bs, K * D))
                               .astype(np.float32)) for _ in "kv")
    return q, kp, vp, bt, pos


def _partials(q, kp, vp, bt, pos, window, c0, c1):
    """Plain partials (acc [B, t, H, d], m, l [B, t, H]) of the tile's rows
    over columns [c0, c1) of each slot (tensors [B]), fp32."""
    B, t, H, d = q.shape
    rep = H // K
    bs = kp.shape[2]
    S = bt.shape[1] * bs
    kd = kp[1][bt.long()].reshape(B, S, K, d).repeat_interleave(rep, dim=2)
    vd = vp[1][bt.long()].reshape(B, S, K, d).repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, kd) / math.sqrt(d)
    row = (pos.long()[:, None] + torch.arange(t)[None])[:, None, :, None]
    col = torch.arange(S)[None, None, None, :]
    keep = (col <= row) & (col >= c0.long()[:, None, None, None]) \
        & (col < c1.long()[:, None, None, None])
    if window is not None:
        keep = keep & (col > row - window)
    s = torch.where(keep, s, tpa.NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bhts,bshd->bthd", p, vd)
    return acc, m.transpose(1, 2), p.sum(dim=-1).transpose(1, 2)


@pytest.mark.parametrize("H,t", [(8, 1), (8, 2), (8, 4), (2, 16)])
@pytest.mark.parametrize("bs,nb_max,window", [
    (16, 8, None), (16, 8, 1), (16, 8, 40), (8, 32, None), (8, 32, 40),
    (128, 2, None)])
def test_split_partials_merge_to_the_unsplit_plain(H, t, bs, nb_max, window):
    """t in {1, 2, 4} at rep 4 and t = 16 at rep 1 (each t rep <= 16: the
    decode regime), windows None, 1 and 40, one to sixteen splits; the last
    slot's padded rows pass the table. Each slot's split z keeps the
    columns of blocks [lo + z bps, lo + (z+1) bps); the merged, normalised
    partials equal the unsplit plain version."""
    assert t * (H // K) <= tpa.TILE_DECODE_ROWS
    q, kp, vp, bt, pos = _case(H, t, bs, nb_max, seed=bs + t + H)
    bps, nsplit = tpa.paged_tile_splits(bs, nb_max)
    lo, nblk = tpa.tile_live_blocks(pos, t, bs, nb_max, window)
    nlive = -(-nblk // bps)
    assert int(nlive.max()) <= nsplit
    parts = []
    for z in range(int(nlive.max())):
        c0 = (lo + z * bps) * bs
        parts.append(_partials(q, kp, vp, bt, pos, window, c0, c0 + bps * bs))
    acc, _, l = tpa.merge_decode_partials(parts)
    got = acc / l.clamp_min(1e-30)[..., None]
    want = tpa.plain_paged_attention(q, kp, vp, bt, pos, window, layer=1)
    torch.testing.assert_close(got, want, **TOL)
    if window is None and bs * nb_max >= 256:
        assert int(nlive.max()) > 1          # the deep slots split


@pytest.mark.parametrize("t", [1, 4, 16])
@pytest.mark.parametrize("bs,nb_max", [(128, 16), (16, 8), (8, 32),
                                       (1, 300), (64, 1000)])
@pytest.mark.parametrize("window", [None, 1, 40, 5000])
def test_live_blocks_cover_every_visible_column(t, bs, nb_max, window):
    """Every column some row of the tile sees lies in the slot's live
    blocks, none of them past the table, and the splits of those blocks fit
    the kernel's grid and shared memory."""
    S = nb_max * bs
    pos = torch.tensor([0, 1, bs, S // 2, S - 1, S + 5], dtype=torch.int32)
    lo, nblk = tpa.tile_live_blocks(pos, t, bs, nb_max, window)
    bps, nsplit = tpa.paged_tile_splits(bs, nb_max)
    assert 1 <= bps <= tpa.TILE_MAX_SPLIT_BLOCKS
    assert 1 <= nsplit <= tpa.TILE_MAX_SPLITS and nsplit * bps >= nb_max
    for b, p in enumerate(pos.tolist()):
        rows = np.arange(p, p + t)[:, None]
        col = np.arange(S)[None]
        seen = (col <= rows) & (col > rows - (window or 10**9))
        cols = np.nonzero(seen.any(axis=0))[0]
        first, n = int(lo[b]), int(nblk[b])
        assert n == 0 or (0 <= first and first + n <= nb_max)
        assert -(-n // bps) <= nsplit
        if len(cols):
            assert first * bs <= cols.min() and cols.max() < (first + n) * bs
            assert first == cols.min() // bs           # no dead leading block
        else:
            assert n == 0


def test_paged_tile_splits_refuse_a_table_too_long():
    with pytest.raises(ValueError, match="kernel I takes at most"):
        tpa.paged_tile_splits(128, tpa.TILE_MAX_SPLITS
                              * tpa.TILE_MAX_SPLIT_BLOCKS + 1)


def test_limits_are_the_kernels():
    """The wrapper's regime boundary and split limits are the source's: its
    m16 tile holds the decode regime's rows, its shared memory a split's
    block ids and a row's per-split merge factors."""
    src = SRC.read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"\b(MAX_BPS|MAX_SPLITS|ROWS) = (\d+)", src)}
    assert consts == {"MAX_BPS": tpa.TILE_MAX_SPLIT_BLOCKS,
                      "MAX_SPLITS": tpa.TILE_MAX_SPLITS,
                      "ROWS": tpa.TILE_DECODE_ROWS}
    assert "t * (H / K) <= dst::ROWS" in src


def test_paged_tile_source_keeps_its_contract():
    """Kernel I: mma.sync on ldmatrix fragments (no wmma, no tile engine),
    cp.async rings, and the decode regime's splits merged behind one atomic
    ticket a (slot, kv head)."""
    code = "\n".join(line.split("//")[0]
                     for line in SRC.read_text().splitlines())
    assert "wmma" not in code and "flash_tile.cuh" not in code
    for call in ("mma_bf16(", "ldsm_x4(", "ldsm_x4_trans(", "cp_async16(",
                 "tile_scores<", "tile_softmax_pv<", "__threadfence()",
                 "__ldcg("):
        assert call in code, call
    assert code.count("atomicAdd(") == 1


def test_kernel_args_refuse_what_the_kernel_is_not_built_for():
    """Head dims outside ``CARD_HEAD_DIMS`` (64, 96, 128, 256) and windows
    below 1 raise before any launch (the plain version takes any d)."""
    q, kp, vp, bt, pos = _case(8, 1, 8, 4, seed=0)
    with pytest.raises(ValueError,
                       match=r"head_dim in \(64, 96, 128, 256\), got 16"):
        tpa.paged_tile_kernel_args(q.bfloat16(), kp.bfloat16(),
                                   vp.bfloat16(), bt, pos)
    q = torch.zeros(4, 1, 8, 64, dtype=torch.bfloat16)
    pool = torch.zeros(2, 17, 8, K * 64, dtype=torch.bfloat16)
    for window in (0, -3):
        with pytest.raises(ValueError, match="window"):
            tpa.paged_tile_kernel_args(q, pool, pool, bt, pos, window=window)


@pytest.mark.parametrize("t,H,decode", [(1, 8, True), (4, 8, True),
                                        (5, 8, False), (16, 2, True),
                                        (17, 2, False), (700, 8, False)])
def test_kernel_args_pick_the_regime(monkeypatch, t, H, decode):
    """The decode regime's split, workspace and tickets come with a call of
    at most 16 rows a GQA group; a wider tile's launch takes none (CPU
    operands here: the stream is a stand-in)."""
    monkeypatch.setattr(tpa, "stream_ptr", lambda x: 0)
    bs, nb_max = 8, 4
    q = torch.zeros(4, t, H, 64, dtype=torch.bfloat16)
    pool = torch.zeros(2, 17, bs, K * 64, dtype=torch.bfloat16)
    bt = torch.zeros(4, nb_max, dtype=torch.int32)
    pos = torch.zeros(4, dtype=torch.int32)
    args, (out,) = tpa.paged_tile_kernel_args(q, pool, pool, bt, pos)
    bps, nsplit, ws, tickets = args[16:20]
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    if decode:
        assert (bps, nsplit) == tpa.paged_tile_splits(bs, nb_max)
        assert ws.numel() == 4 * H * t * nsplit * (64 + 2)
        assert tickets.dtype == torch.int32 and tickets.numel() >= 4 * K
        assert int(tickets.abs().sum()) == 0
    else:
        assert (bps, nsplit, ws, tickets) == (0, 0, None, None)
