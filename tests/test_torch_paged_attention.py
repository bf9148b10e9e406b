"""Paged attention of the PyTorch port against the JAX package: the Pallas
kernels in interpret mode (``interpret=True``) and the dense-gather twins,
fp32 on the CPU (atol = rtol = 1e-5). The card's kernels A/B/C are held
against their plain versions in ``test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.ops import paged_attention as tpa
from tests._torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
L, BS, H, K, D = 2, 8, 4, 2, 16
N_SLOTS, NB_MAX = 4, 6                    # 48 positions per slot
NUM_BLOCKS = N_SLOTS * NB_MAX
LAYER = 1


def _pools(seed=0):
    """Stacked lane-folded pools + block tables (a seeded permutation, tail
    entries of slot 3 on the scratch block)."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((L, NUM_BLOCKS + 1, BS, K * D)).astype(np.float32)
    vp = rng.standard_normal((L, NUM_BLOCKS + 1, BS, K * D)).astype(np.float32)
    bt = rng.permutation(NUM_BLOCKS).reshape(N_SLOTS, NB_MAX).astype(np.int32)
    bt[3, 4:] = NUM_BLOCKS
    return kp, vp, bt


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("window", [None, 5, 12])
def test_past_ranges(window):
    pos0 = np.array([0, 1, 8, 9, 30, 47], np.int32)
    row = pos0 + np.array([0, 3, 0, 7, 1, 0], np.int32)
    _, lo_j, nblk_j, _ = jpa._past_ranges(_j(pos0), _j(row), BS, NB_MAX, 8,
                                          window)
    _, lo_t, nblk_t = tpa._past_ranges(_t(pos0), _t(row), BS, NB_MAX, window)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(nblk_t.numpy(), np.asarray(nblk_j))


@pytest.mark.parametrize("window,row_shift", [(None, 0), (6, 0), (6, 5),
                                              (20, 9)])
def test_decode_pool_partials_match_pallas(window, row_shift):
    kp, vp, bt = _pools(1)
    rng = np.random.default_rng(2)
    q = rng.standard_normal((5, H, D)).astype(np.float32)
    slot = np.array([0, 1, 2, 3, 1], np.int32)
    pos0 = np.array([0, 5, 8, 17, 40], np.int32)
    row = pos0 + row_shift
    acc_j, m_j, l_j = jpa.decode_pool_partials(
        _j(q), _j(kp), _j(vp), jnp.int32(LAYER), _j(bt), _j(slot), _j(pos0),
        window=window, row_pos=_j(row), interpret=True)
    acc_t, m_t, l_t = tpa.decode_pool_partials(
        _t(q), _t(kp), _t(vp), LAYER, _t(bt), _t(slot), _t(pos0),
        window=window, row_pos=_t(row))
    # the TPU kernel leaves don't-care values where nothing is visible
    # (pos0 == 0, or a window that ends before pos0)
    live = (pos0 > 0) & ((window is None) | (pos0 - 1 > row - (window or 0)))
    for got, want in ((acc_t, acc_j), (m_t, m_j), (l_t, l_j)):
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   **TOL)
    # the port's contract at pos0 == 0: nothing visible, nothing summed
    assert float(l_t[0].abs().max()) == 0 and float(acc_t[0].abs().max()) == 0
    acc_x, m_x, l_x = jpa.xla_decode_partials(
        _j(q), _j(kp), _j(vp), jnp.int32(LAYER), _j(bt), _j(slot), _j(pos0),
        window=window, row_pos=_j(row))
    for got, want in ((acc_t, acc_x), (m_t, m_x), (l_t, l_x)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


CASES = {
    "decode": (1, [0, 5, 8, 17, 40, 3, 0, 0], [1, 1, 1, 1, 1, 1, 0, 0], None,
               False),
    "decode-window": (1, [0, 5, 8, 17, 40, 3, 0, 0], [1] * 6 + [0, 0], 7,
                      False),
    "tq8-fresh": (8, [0, 0, 0, 0], [8, 5, 1, 0], None, True),
    "tq8-past": (8, [0, 8, 3, 17], [8, 5, 1, 8], None, False),
    "tq8-past-window": (8, [0, 8, 3, 17], [8, 5, 2, 8], 6, False),
    "tq32-past": (32, [0, 9], [32, 20], None, False),
    "tq32-past-window": (32, [5, 16], [30, 32], 10, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_paged_attention_matches_pallas(case):
    tq, pos0, alen, window, no_past = CASES[case]
    kp, vp, bt = _pools(3)
    A = len(pos0)
    N = A * tq
    rng = np.random.default_rng(4)
    q = rng.standard_normal((N, H, D)).astype(np.float32)
    ks = rng.standard_normal((N, K, D)).astype(np.float32)
    vs = rng.standard_normal((N, K, D)).astype(np.float32)
    slot = np.array([i % N_SLOTS for i in range(A)], np.int32)
    pos0 = np.array(pos0, np.int32)
    alen = np.array(alen, np.int32)
    want = jpa.ragged_paged_attention(
        _j(q), _j(ks), _j(vs), _j(kp), _j(vp), _j(bt), _j(slot), _j(pos0),
        _j(alen), tq, window=window, interpret=True, layer=jnp.int32(LAYER),
        no_past=no_past)
    args = (_t(q), _t(ks), _t(vs), _t(kp), _t(vp), _t(bt), _t(slot),
            _t(pos0), _t(alen), tq)
    got = tpa.ragged_paged_attention(*args, window=window, layer=LAYER,
                                     no_past=no_past)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the split past + self path agrees with the one-gather reference too
    dense = tpa.plain_ragged_attention(*args, window=window, layer=LAYER)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


def test_packed_kv_append_matches_reference():
    kp, _, bt = _pools(5)
    rng = np.random.default_rng(6)
    n = 12
    rows = rng.standard_normal((L, n, K, D)).astype(np.float32)
    slot = rng.integers(0, N_SLOTS, n).astype(np.int32)
    valid = rng.random(n) < 0.7
    # unique (slot, pos) pairs, as the engine guarantees
    pos = np.arange(n, dtype=np.int32) * 2 + (slot % 2)
    want = jpa.packed_kv_append(_j(kp), _j(rows), _j(bt), _j(slot), _j(pos),
                                _j(valid))
    pool = _t(kp.copy())
    out = tpa.packed_kv_append(pool, _t(rows), _t(bt), _t(slot), _t(pos),
                               _t(valid))
    assert out.data_ptr() == pool.data_ptr()          # written in place
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want))


def test_packed_kv_append_drops_every_invalid_row():
    kp, _, bt = _pools(7)
    pool = _t(kp.copy())
    rows = torch.full((L, 3, K * D), 99.0)
    tpa.packed_kv_append(pool, rows, _t(bt), _t(np.zeros(3, np.int32)),
                         _t(np.array([0, 1, 2], np.int32)),
                         _t(np.zeros(3, bool)))
    np.testing.assert_array_equal(pool.numpy(), kp)


def test_wrappers_refuse_operands_on_mixed_devices():
    """Every tensor operand, the seed and the metadata included, decides the
    dispatch: one off the query's device raises (never a host pointer handed
    to a kernel). ``meta`` stands in for the card here."""
    kp, vp, bt = _pools(8)
    q = torch.zeros(2 * 8, H, D)
    ks = vs = torch.zeros(2 * 8, K, D)
    alen = torch.tensor([8, 3])
    seed = tuple(t.to("meta") for t in tpa.plain_past_partials(
        q, _t(kp), _t(vp), 0, _t(bt), torch.tensor([0, 1]),
        torch.tensor([8, 8]), 8))
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        tpa.self_attention(q, ks, vs, alen, 8, seed)
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        tpa.decode_pool_partials(q[:2], _t(kp), _t(vp), 0, _t(bt),
                                 torch.tensor([0, 1]),
                                 torch.tensor([5, 9], device="meta"))
