"""The int8 / int4 KV pool of the PyTorch port against the JAX package on the
CPU, from numpy-seeded fp32 inputs.

* ``_quantize_q_rows`` (the int8 decode's q-hat) and
  ``packed_kv_append_quant`` (quantize-and-scatter, int8 and int4, with
  invalid rows) are bit-identical to the reference under ``jax.jit``, as
  its engine runs them, and the port's append is in place;
* the plain quantized modes of kernels A and B match the JAX XLA twin
  ``xla_decode_partials`` to atol = rtol = 1e-5, and the JAX Pallas kernels
  in interpret mode wherever something is visible: to 1e-5, except the int8
  decode kernel, which rounds ``p * v_scale`` to bf16 before the P V product
  (reference :512), held to atol = rtol = 1e-2;
* ``ragged_paged_attention`` over quantized pools (decode atoms, chunk atoms
  with and without a window) matches the JAX wrapper in interpret mode.

Pools are filled through the port's append, so the int4 pool's low and high
nibbles (features ``j`` and ``j + K*d/2``) hold different values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.ops import paged_attention as tpa
from tests._torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_PV_TOL = dict(atol=1e-2, rtol=1e-2)
L, BS, H, K, D = 2, 8, 4, 2, 16
N_SLOTS, NB_MAX = 4, 6                    # 48 positions per slot
NUM_BLOCKS = N_SLOTS * NB_MAX
LAYER = 1


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _block_tables(rng):
    bt = rng.permutation(NUM_BLOCKS).reshape(N_SLOTS, NB_MAX).astype(np.int32)
    bt[3, 4:] = NUM_BLOCKS
    return bt


def _quant_pools(bits, seed=0):
    """int pools + scales with every (slot, position) written through the
    port's append (rows of varied amplitude: per-token scales differ)."""
    rng = np.random.default_rng(seed)
    bt = _block_tables(rng)
    lanes = K * D // 2 if bits == 4 else K * D
    pools = {n: torch.zeros(L, NUM_BLOCKS + 1, BS, lanes, dtype=torch.int8)
             for n in "kv"}
    scale = torch.zeros(L, NUM_BLOCKS + 1, 1, 2 * BS)
    slot = np.repeat(np.arange(N_SLOTS), NB_MAX * BS).astype(np.int32)
    pos = np.tile(np.arange(NB_MAX * BS), N_SLOTS).astype(np.int32)
    valid = ~((slot == 3) & (pos >= 4 * BS))          # slot 3's tail: scratch
    for which, n in enumerate("kv"):
        rows = rng.standard_normal((L, len(slot), K, D)).astype(np.float32)
        rows *= rng.uniform(0.2, 3.0, (L, len(slot), 1, 1)).astype(np.float32)
        tpa.packed_kv_append_quant(pools[n], scale, _t(rows), _t(bt),
                                   _t(slot), _t(pos), which, _t(valid),
                                   bits=bits)
    return pools["k"], pools["v"], scale, bt


def test_quantize_q_rows_is_bit_identical():
    q = np.random.default_rng(0).standard_normal((5, H, D)).astype(np.float32)
    q[1, 2] = 0.0                                  # an all-zero row: floor
    q[2, 0, :4] = [0.5, -0.5, 1.5, 127.0 / 2]      # ties
    qj, sj = jax.jit(jpa._quantize_q_rows)(_j(q))
    qt, st = tpa._quantize_q_rows(_t(q))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_unpack_int4_lanes_matches():
    b = np.random.default_rng(1).integers(-128, 128, (3, 5, 16)).astype(
        np.int8)
    want = np.asarray(jpa._unpack_int4_lanes_xla(_j(b), K, D))
    np.testing.assert_array_equal(tpa._unpack_int4_lanes(_t(b)).numpy(), want)


@pytest.mark.parametrize("bits", [8, 4])
def test_packed_kv_append_quant_is_bit_identical(bits):
    rng = np.random.default_rng(2 + bits)
    bt = _block_tables(rng)
    lanes = K * D // 2 if bits == 4 else K * D
    pool0 = rng.integers(-128, 128, (L, NUM_BLOCKS + 1, BS, lanes)).astype(
        np.int8)
    scale0 = rng.random((L, NUM_BLOCKS + 1, 1, 2 * BS)).astype(np.float32)
    n = 12
    rows = rng.standard_normal((L, n, K, D)).astype(np.float32)
    rows[0, 3] = 0.0                               # zero row: scale floor
    slot = rng.integers(0, N_SLOTS, n).astype(np.int32)
    pos = (np.arange(n) * 2 + (slot % 2)).astype(np.int32)
    valid = rng.random(n) < 0.7
    for which in (0, 1):
        pj, sj = jax.jit(jpa.packed_kv_append_quant,
                         static_argnames=("which", "bits"))(
            _j(pool0), _j(scale0), _j(rows), _j(bt), _j(slot), _j(pos),
            which=which, valid=_j(valid), bits=bits)
        pool, scale = _t(pool0.copy()), _t(scale0.copy())
        out_p, out_s = tpa.packed_kv_append_quant(
            pool, scale, _t(rows), _t(bt), _t(slot), _t(pos), which,
            _t(valid), bits=bits)
        assert out_p.data_ptr() == pool.data_ptr()     # written in place
        assert out_s.data_ptr() == scale.data_ptr()
        np.testing.assert_array_equal(pool.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(sj))


def test_int4_pool_nibbles_differ():
    kp, _, _, _ = _quant_pools(4)
    b = kp.to(torch.int32)
    assert float((((b << 28) >> 28) != (b >> 4)).float().mean()) > 0.8


def _visible(pos0, row, window):
    return (pos0 > 0) & ((window is None) | (pos0 - 1 > row - (window or 0)))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("window,row_shift", [(None, 0), (6, 0), (20, 9)])
def test_plain_decode_quant_matches_reference(bits, window, row_shift):
    kp, vp, sc, bt = _quant_pools(bits, seed=bits)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((5, H, D)).astype(np.float32)
    slot = np.array([0, 1, 2, 3, 1], np.int32)
    pos0 = np.array([0, 5, 8, 17, 40], np.int32)
    row = pos0 + row_shift
    jargs = (_j(q), _j(kp.numpy()), _j(vp.numpy()), jnp.int32(LAYER), _j(bt),
             _j(slot), _j(pos0))
    jkw = dict(window=window, row_pos=_j(row), kv_scale=_j(sc.numpy()),
               kv_bits=bits)
    got = tpa.decode_pool_partials(
        _t(q), kp, vp, LAYER, _t(bt), _t(slot), _t(pos0), window=window,
        row_pos=_t(row), kv_scale=sc, kv_bits=bits)
    twin = jpa.xla_decode_partials(*jargs, **jkw)
    for g, w in zip(got, twin):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    pallas = jpa.decode_pool_partials(*jargs, interpret=True, **jkw)
    live = _visible(pos0, row, window)
    tol = BF16_PV_TOL if bits == 8 else TOL
    acc, m, l = (np.asarray(x) for x in pallas)
    np.testing.assert_allclose(got[1].numpy()[live], m[live], **TOL)
    np.testing.assert_allclose(got[2].numpy()[live], l[live], **TOL)
    np.testing.assert_allclose(got[0].numpy()[live], acc[live], **tol)
    assert float(got[2][0].abs().max()) == 0 and \
        float(got[0][0].abs().max()) == 0


CASES = {
    "decode": (1, [0, 5, 8, 17, 40, 3, 0, 0], [1, 1, 1, 1, 1, 1, 0, 0], None),
    "decode-window": (1, [0, 5, 8, 17, 40, 3, 0, 0], [1] * 6 + [0, 0], 7),
    "tq8-past": (8, [0, 8, 3, 17], [8, 5, 1, 8], None),
    "tq8-past-window": (8, [0, 8, 3, 17], [8, 5, 2, 8], 6),
    "tq32-past": (32, [0, 9], [32, 20], None),
}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_attention_quant_matches_pallas(bits, case):
    """Past (kernel B's int modes, q unquantized) plus the seeded self
    flash, or decode (A's int modes) plus the self-token merge."""
    tq, pos0, alen, window = CASES[case]
    kp, vp, sc, bt = _quant_pools(bits, seed=10 + bits)
    A = len(pos0)
    rng = np.random.default_rng(4)
    q, ks, vs = (rng.standard_normal((A * tq, h, D)).astype(np.float32)
                 for h in (H, K, K))
    slot = np.array([i % N_SLOTS for i in range(A)], np.int32)
    pos0, alen = np.array(pos0, np.int32), np.array(alen, np.int32)
    want = jpa.ragged_paged_attention(
        _j(q), _j(ks), _j(vs), _j(kp.numpy()), _j(vp.numpy()), _j(bt),
        _j(slot), _j(pos0), _j(alen), tq, window=window, interpret=True,
        layer=jnp.int32(LAYER), kv_scale=_j(sc.numpy()), kv_bits=bits)
    got = tpa.ragged_paged_attention(
        _t(q), _t(ks), _t(vs), kp, vp, _t(bt), _t(slot), _t(pos0), _t(alen),
        tq, window=window, layer=LAYER, kv_scale=sc, kv_bits=bits)
    tol = BF16_PV_TOL if (bits == 8 and tq == 1) else TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_past_quant_is_the_dequantized_bf16_path(bits):
    """Kernel B's int modes compute the bf16 mode's function on the
    per-token dequantized pool (q unquantized)."""
    kp, vp, sc, bt = _quant_pools(bits, seed=20 + bits)
    tq = 8
    q = np.random.default_rng(5).standard_normal((2 * tq, H, D)).astype(
        np.float32)
    slot, pos0 = _t(np.array([0, 2], np.int32)), _t(np.array([9, 40],
                                                              np.int32))
    got = tpa.past_partials(_t(q), kp, vp, LAYER, _t(bt), slot, pos0, tq,
                            kv_scale=sc, kv_bits=bits)
    unpack = tpa._unpack_int4_lanes if bits == 4 else (lambda t: t.float())
    kd = unpack(kp) * sc[:, :, :, :BS].transpose(2, 3)
    vd = unpack(vp) * sc[:, :, :, BS:].transpose(2, 3)
    want = tpa.past_partials(_t(q), kd, vd, LAYER, _t(bt), slot, pos0, tq)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
