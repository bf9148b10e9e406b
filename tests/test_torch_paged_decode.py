"""Kernel A's split of a past over CTAs, on the CPU: the plain partials of
each split, merged in the kernel's order (``merge_decode_partials``), equal
the unsplit plain partials (fp32: acc and l within 1e-5, m exactly), over a
bf16-valued, an int8 and an int4 pool, with windows, empty atoms and the
most splits a table gives; then the split rule and the constants it shares
with ``csrc/paged_decode.cu``. The kernel itself is held against the plain
version on the card (``test_torch_kernels_cuda.py``)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import paged_attention as tpa
from tests._torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "deepspeed_tpu_torch/csrc/paged_decode.cu"
TOL = dict(atol=1e-5, rtol=1e-5)
H, K, D = 4, 2, 16


def _pools(bits, bs, nb_max, n_slots=3, seed=0):
    """Stacked pools ``[2, n_slots*nb_max + 1, bs, lanes]`` holding every
    slot's rows (bf16 values in fp32, or int8 / int4 through the port's
    append), a permuted block table and the pool kwargs."""
    rng = np.random.default_rng(seed)
    nbp1 = n_slots * nb_max + 1
    bt = torch.from_numpy(rng.permutation(nbp1 - 1).reshape(n_slots, nb_max)
                          .astype(np.int32))
    rows = [torch.from_numpy(rng.standard_normal(
        (2, n_slots * nb_max * bs, K, D)).astype(np.float32)) for _ in "kv"]
    if bits == 16:
        pools = []
        for r in rows:
            pool = torch.zeros(2, nbp1, bs, K * D)
            tpa.packed_kv_append(
                pool, r.to(torch.bfloat16).float(), bt,
                torch.arange(n_slots).repeat_interleave(nb_max * bs),
                torch.arange(nb_max * bs).repeat(n_slots))
            pools.append(pool)
        return pools[0], pools[1], bt, {}
    lanes = K * D // (2 if bits == 4 else 1)
    pools = [torch.zeros(2, nbp1, bs, lanes, dtype=torch.int8) for _ in "kv"]
    scale = torch.zeros(2, nbp1, 1, 2 * bs)
    slot = torch.arange(n_slots).repeat_interleave(nb_max * bs)
    pos = torch.arange(nb_max * bs).repeat(n_slots)
    for which, (pool, r) in enumerate(zip(pools, rows)):
        tpa.packed_kv_append_quant(pool, scale, r, bt, slot, pos, which,
                                   bits=bits)
    return pools[0], pools[1], bt, dict(kv_scale=scale, kv_bits=bits)


def _split_partials(q, kp, vp, bt, slot, pos0, row_pos, window, bs, kw):
    """Each atom's plain partials split at kernel A's split points, merged
    by ``merge_decode_partials``: split ``z`` keeps columns
    ``[(lo + z bps) bs, (lo + (z+1) bps) bs)`` of the visible past, a piece
    given to ``plain_decode_partials`` as a pool frontier and a window."""
    nb_max = bt.shape[1]
    bps, nsplit = tpa.decode_splits(bs, nb_max)
    _, lo, nblk = tpa._past_ranges(pos0, row_pos, bs, nb_max, window)
    wide = nb_max * bs + 1              # a window that reaches column 0
    outs, nlives = [], []
    for a in range(q.shape[0]):
        nlive = -(-int(nblk[a]) // bps)
        assert nlive <= nsplit
        nlives.append(nlive)
        first = 0 if window is None else int(row_pos[a]) - window + 1
        parts = []
        for z in range(max(nlive, 1)):
            c0 = (int(lo[a]) + z * bps) * bs
            c1 = (int(lo[a]) + (z + 1) * bps) * bs
            parts.append(tpa.plain_decode_partials(
                q[a:a + 1], kp, vp, 1, bt, slot[a:a + 1],
                torch.clamp_max(pos0[a:a + 1], c1), window=wide,
                row_pos=torch.tensor([max(c0, first) - 1 + wide]), **kw))
        outs.append(tpa.merge_decode_partials(parts))
    return [torch.cat(x) for x in zip(*outs)], nlives


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("bs,nb_max,window", [
    (128, 16, None), (128, 16, 300), (16, 64, None), (16, 64, 40),
    (32, 64, None)])
def test_split_partials_merge_to_the_unsplit_plain(bits, bs, nb_max, window):
    """Pasts of 0, 1 and exactly one block's tokens, one before and one
    after a block edge, one of the table's last position (the most splits),
    and one whose window starts past its frontier (a live block, nothing
    visible); rows advanced past the frontier move the window only. Tables
    of 2048 and 1024 positions, one to eight blocks a split."""
    kp, vp, bt, kw = _pools(bits, bs, nb_max)
    S = nb_max * bs
    pos0 = torch.tensor([0, 1, bs, bs - 1, bs + 1, 2 * bs + 1, S - 1, 100],
                        dtype=torch.int32)
    shift = torch.tensor([0, 0, 3, 0, 1, 0, 0, 20], dtype=torch.int32)
    row_pos = pos0 + shift
    if window is not None and window < 30:      # nothing visible at pos0 100
        pos0[-1], row_pos[-1] = 100, 100 + window + 5
    slot = torch.arange(8, dtype=torch.int32) % 3
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, H, D)).astype(np.float32)).to(torch.bfloat16)
    (acc, m, l), nlives = _split_partials(q, kp, vp, bt, slot, pos0, row_pos,
                                          window, bs, kw)
    # unsplit, an atom a call: the pieces' score products, bit for bit
    racc, rm, rl = (torch.cat(x) for x in zip(*(
        tpa.plain_decode_partials(q[a:a + 1], kp, vp, 1, bt, slot[a:a + 1],
                                  pos0[a:a + 1], window=window,
                                  row_pos=row_pos[a:a + 1], **kw)
        for a in range(8))))
    assert torch.equal(m, rm)
    torch.testing.assert_close(l, rl, **TOL)
    torch.testing.assert_close(acc, racc, **TOL)
    assert nlives[0] == 0 and float(l[0].abs().max()) == 0.0
    assert bool((m[0] == tpa.NEG_INF).all())
    bps, nsplit = tpa.decode_splits(bs, nb_max)
    assert max(nlives) == nsplit or window is not None


def test_merge_of_one_part_is_that_part():
    rng = np.random.default_rng(3)
    part = (torch.from_numpy(rng.standard_normal((2, 3, 4))).float(),
            torch.from_numpy(rng.standard_normal((2, 3))).float(),
            torch.from_numpy(rng.random((2, 3))).float())
    for got, want in zip(tpa.merge_decode_partials([part]), part):
        assert torch.equal(got, want)


@pytest.mark.parametrize("bs,nb_max", [(128, 16), (128, 1), (16, 64),
                                       (8, 6), (1, 64), (128, 130),
                                       (256, 8192), (64, 1000)])
def test_decode_splits_cover_the_table(bs, nb_max):
    """Splits of whole blocks, at least 128 columns each (or the whole
    table), at most MAX_SPLITS of them, covering all ``nb_max`` blocks with
    none past it."""
    bps, nsplit = tpa.decode_splits(bs, nb_max)
    assert 1 <= bps <= tpa.MAX_SPLIT_BLOCKS
    assert 1 <= nsplit <= tpa.MAX_SPLITS
    assert (nsplit - 1) * bps < nb_max <= nsplit * bps
    assert bps * bs >= 128 or nsplit == 1


def test_decode_splits_refuse_a_table_too_long():
    with pytest.raises(ValueError, match="blocks a split"):
        tpa.decode_splits(128, tpa.MAX_SPLITS * tpa.MAX_SPLIT_BLOCKS + 1)


def test_split_limits_are_the_kernels():
    """The wrapper's split limits are the source's: its shared memory holds
    a split's block ids and a row's per-split merge factors."""
    src = SRC.read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"\b(MAX_BPS|MAX_SPLITS) = (\d+)", src)}
    assert consts == {"MAX_BPS": tpa.MAX_SPLIT_BLOCKS,
                      "MAX_SPLITS": tpa.MAX_SPLITS}


@pytest.mark.parametrize("H_,K_,bits,want", [
    (32, 8, 16, 8), (32, 8, 8, 8), (32, 8, 4, 4), (28, 4, 4, 2),
    (32, 1, 4, 2), (71, 1, 8, 5), (64, 8, 4, 4), (32, 2, 4, 2),
    (8, 8, 4, 4), (3, 3, 4, 3)])
def test_decode_groups(H_, K_, bits, want):
    """An int4 pool with even K and at most 8 heads a group pairs two kv
    heads a CTA; otherwise 16 heads of one group a CTA."""
    kw = {} if bits == 16 else dict(kv_scale=torch.zeros(1), kv_bits=bits)
    assert tpa.decode_groups(H_, K_, **kw) == want


def test_kernel_args_refuse_what_the_kernel_is_not_built_for():
    """Head dims outside ``CARD_HEAD_DIMS`` (64, 96, 128, 256) and windows
    below 1 raise before any launch (the plain version takes them)."""
    kp, vp, bt, _ = _pools(16, 8, 4)
    q = torch.zeros(2, H, D, dtype=torch.bfloat16)
    meta = (torch.tensor([0, 1]), torch.tensor([5, 9]))
    with pytest.raises(ValueError,
                       match=r"head_dim in \(64, 96, 128, 256\), got 16"):
        tpa.decode_kernel_args(q, kp.bfloat16(), vp.bfloat16(), 1, bt, *meta)
    q = torch.zeros(2, H, 64, dtype=torch.bfloat16)
    pool = torch.zeros(2, 9, 8, K * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="window"):
        tpa.decode_kernel_args(q, pool, pool, 1, bt, *meta, window=0)


def test_paged_decode_source_keeps_its_contract():
    """Kernel A: mma.sync on ldmatrix fragments (no wmma, no tile engine), a
    cp.async ring, the packed bytes turned into B fragments in registers,
    the int8 q-hat in the prologue with IEEE division and round half to
    even, expf, and the splits merged behind one atomic ticket a (atom,
    group)."""
    code = "\n".join(line.split("//")[0]
                     for line in SRC.read_text().splitlines())
    body = code[code.index("paged_decode_kernel(const"):
                code.index("int launch_decode(")]
    assert "wmma" not in code and "flash_tile.cuh" not in code
    for call in ("mma_bf16(", "mma_s8(", "ldsm_x4(", "ldsm_x4_trans(",
                 "cp_async16(", "cp_async4(", "frag_int8(", "frag_int4(",
                 "__fdiv_rn(", "rintf(", "expf(", "__threadfence()",
                 "__ldcg("):
        assert call in body, call
    assert body.count("atomicAdd(") == 1
