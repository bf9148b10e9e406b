"""Kernels B (chunk-past partials) and C (seeded chunk-self flash) as one
path, fp32 on the CPU, through their plain versions:

* B's partials seeding C equal the whole ragged path in one dense gather
  (``plain_ragged_attention``) at 1e-5 over a bf16 pool, for chunk widths
  32 and 256, no window, a window of 1 (the past all hidden) and of 40,
  and GQA groups of 1 and 4 heads; over int8 and int4 pools, the same
  composition equals itself over the pool dequantized per token (1e-5);
* the composition against the JAX package's ``ragged_paged_attention``
  (``kernel="xla"``, its dense-gather path) on the same numpy inputs, at
  1e-5 (both fp32; sums taken in other orders);
* the source contract: B (``paged_attention.cu``) and C
  (``flash_attention.cu``) are built on kernel D's tile body
  (``flash_fwd_tile.cuh``) and the wmma tile engine they ran on is gone.

The card runs the kernels themselves against these plain versions in
``test_torch_kernels_cuda.py``.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.ops import paged_attention as tpa
from tests._torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parent.parent / "deepspeed_tpu_torch/csrc"
TOL = dict(atol=1e-5, rtol=1e-5)
L, BS, H, D = 2, 8, 4, 16
N_SLOTS, NB_MAX = 4, 6                    # 48 positions per slot
NUM_BLOCKS = N_SLOTS * NB_MAX
LAYER = 1
POS0 = [0, 5, 40, 47]                     # none, inside a block, 48 cols cut


def _inputs(seed, tq, K):
    """Atoms at ``POS0`` of slots 0-3 (chunk atoms of ``tq`` rows, real
    lengths tq, tq - 3, 1 and tq / 2), q [A tq, H, D], the atoms' own K/V
    [A tq, K, D] and fp32 pools [L, nb+1, BS, K D] whose values are bf16's."""
    rng = np.random.default_rng(seed)
    A = len(POS0)
    bt = rng.permutation(NUM_BLOCKS).reshape(N_SLOTS, NB_MAX).astype(np.int32)
    pools = [rng.standard_normal((L, NUM_BLOCKS + 1, BS, K * D))
             .astype(np.float32) for _ in "kv"]
    pools = [torch.from_numpy(p).bfloat16().float().numpy() for p in pools]
    q = rng.standard_normal((A * tq, H, D)).astype(np.float32)
    ks, vs = (rng.standard_normal((A * tq, K, D)).astype(np.float32)
              for _ in "kv")
    meta = (np.arange(A, dtype=np.int32), np.array(POS0, np.int32),
            np.array([tq, tq - 3, 1, tq // 2], np.int32))
    return q, ks, vs, pools, bt, meta


def _compose(q, ks, vs, kp, vp, bt, slot, pos0, alen, tq, window, **kw):
    seed = tpa.plain_past_partials(q, kp, vp, LAYER, bt, slot, pos0, tq,
                                   window=window, **kw)
    return tpa.plain_self_attention(q, ks, vs, alen, tq, seed, window=window)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("K", [4, 1])
@pytest.mark.parametrize("window", [None, 1, 40])
@pytest.mark.parametrize("tq", [32, 256])
def test_past_then_self_is_the_ragged_path_over_a_bf16_pool(tq, window, K):
    q, ks, vs, (kp, vp), bt, (slot, pos0, alen) = _inputs(10 + tq, tq, K)
    q, ks, vs, bt, slot, pos0, alen = _t(q, ks, vs, bt, slot, pos0, alen)
    kp, vp = (x.bfloat16() for x in _t(kp, vp))
    got = _compose(q, ks, vs, kp, vp, bt, slot, pos0, alen, tq, window)
    want = tpa.plain_ragged_attention(q, ks, vs, kp, vp, bt, slot, pos0,
                                      alen, tq, window=window, layer=LAYER)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # rows past each atom's length are zeros
    rows = torch.arange(tq)
    pad = (rows[None, :] >= alen[:, None]).reshape(-1)
    assert float(got[pad].abs().max()) == 0.0


def _quantized(kp, vp, bits):
    """The fp32 pools written through ``packed_kv_append_quant`` (every
    physical row), and the same pools dequantized per token."""
    L_, nbp1, bs, KD = kp.shape
    lanes = KD // 2 if bits == 4 else KD
    pools = [torch.zeros(L_, nbp1, bs, lanes, dtype=torch.int8)
             for _ in "kv"]
    scale = torch.zeros(L_, nbp1, 1, 2 * bs)
    bt_all = torch.arange(nbp1, dtype=torch.int32)[None]
    slot = torch.zeros(nbp1 * bs, dtype=torch.int32)
    pos = torch.arange(nbp1 * bs, dtype=torch.int32)
    dequant = []
    for which, (src, dst) in enumerate(zip((kp, vp), pools)):
        tpa.packed_kv_append_quant(dst, scale, torch.from_numpy(src).reshape(
            L_, nbp1 * bs, KD), bt_all, slot, pos, which, bits=bits)
        vals = tpa._unpack_int4_lanes(dst) if bits == 4 else dst.float()
        dequant.append(vals * scale[:, :, 0, which * bs:(which + 1) * bs,
                                    None])
    return pools, scale, dequant


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("K", [4, 1])
@pytest.mark.parametrize("bits", [8, 4])
def test_past_then_self_over_int_pools_is_over_the_dequantized_pool(
        bits, K, window):
    """Over an int pool B's plain version dequantizes per token (k and v
    scales of ``kv_scale``); the composition equals the same composition
    over the dequantized fp32 pool. K = 1 over int4: the head's features
    straddle the nibble halves."""
    tq = 32
    q, ks, vs, (kp, vp), bt, (slot, pos0, alen) = _inputs(20 + bits, tq, K)
    (kq, vq), scale, (kd, vd) = _quantized(kp, vp, bits)
    q, ks, vs, bt, slot, pos0, alen = _t(q, ks, vs, bt, slot, pos0, alen)
    got = _compose(q, ks, vs, kq, vq, bt, slot, pos0, alen, tq, window,
                   kv_scale=scale, kv_bits=bits)
    want = _compose(q, ks, vs, kd, vd, bt, slot, pos0, alen, tq, window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("window", [None, 1, 40])
@pytest.mark.parametrize("K", [4, 1])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_past_then_self_matches_the_jax_ragged_path(bits, K, window):
    """The composition against the JAX package's ``ragged_paged_attention``
    with ``kernel="xla"`` (stacked lane-folded pools, ``kv_scale`` for an
    int pool) on the same numpy inputs, fp32, at 1e-5."""
    tq = 32
    q, ks, vs, (kp, vp), bt, (slot, pos0, alen) = _inputs(30 + K, tq, K)
    kw = {}
    if bits == 16:
        jk, jv = kp, vp
        tk, tv = _t(kp, vp)
    else:
        (tk, tv), scale, _ = _quantized(kp, vp, bits)
        jk, jv = tk.numpy(), tv.numpy()
        kw = dict(kv_scale=scale, kv_bits=bits)
    want = jpa.ragged_paged_attention(
        *(jnp.asarray(a) for a in (q, ks, vs, jk, jv, bt, slot, pos0, alen)),
        tq, window=window, layer=jnp.int32(LAYER), kernel="xla",
        **{k: (jnp.asarray(v.numpy()) if k == "kv_scale" else v)
           for k, v in kw.items()})
    tq_args = _t(q, ks, vs)
    got = _compose(*tq_args, tk, tv, *_t(bt, slot, pos0, alen), tq, window,
                   **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_b_and_c_run_kernel_d_tile_body_and_the_tile_engine_is_gone():
    for source in ("paged_attention.cu", "flash_attention.cu"):
        code = (CSRC / source).read_text()
        assert '#include "flash_fwd_tile.cuh"' in code
        assert "tile_scores<" in code and "tile_softmax_pv<" in code
    assert not (CSRC / "flash_tile.cuh").exists()
    for path in CSRC.iterdir():
        assert "flash_tile.cuh" not in path.read_text(), path.name
    from deepspeed_tpu_torch.ops import _build

    assert "flash_tile.cuh" not in _build._HEADERS
