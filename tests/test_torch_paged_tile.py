"""The port's dense-tile paged attention (kernel I's ops) against the JAX
package's ``paged_attention`` (its Pallas ``_paged_kernel`` in interpret
mode) and ``paged_update``, fp32 on the CPU: GQA (4 query heads over 2 kv
heads), tiles of t in {1, 4, 13} tokens, windows None, 1, 6, 17 and 1000,
and a slot at a deep ``pos`` whose padded rows pass the end of its block
table (the clip of ``physical_positions``; invalid lanes to the scratch
block).

Pools agree exactly outside the scratch block (several invalid lanes land
on one scratch row, in an order neither framework fixes). Outputs agree to
2e-5 on the real rows: padded rows are don't-care in both packages (the TPU
kernel's masked rows carry exp(0) garbage until a visible column arrives;
a padded row past the table may see none).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.ops import paged_attention as tpa

TOL = dict(atol=2e-5, rtol=2e-5)
NB, BS, NB_MAX = 14, 8, 4          # 14 blocks + scratch, 4 blocks a slot
H, K, D = 4, 2, 16


def _case(t, seed):
    """Three slots: slot 0 a fresh chunk of t tokens, slot 1 continuing at
    pos 9 with a chunk of max(1, t - 2), slot 2 at pos 30 with a chunk of
    min(t, 2) -- its padded rows reach position 42, past the table's 32."""
    rng = np.random.default_rng(seed)
    bt = rng.permutation(NB)[:3 * NB_MAX].reshape(3, NB_MAX).astype(np.int32)
    pos = np.array([0, 9, 30], np.int32)
    lens = [t, max(1, t - 2), min(t, 2)]
    valid = np.zeros((3, t), bool)
    for b, n in enumerate(lens):
        valid[b, :n] = True

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(bt=bt, pos=pos, valid=valid, q=rnd(3, t, H, D),
                kp=rnd(NB + 1, BS, K, D), vp=rnd(NB + 1, BS, K, D),
                kn=rnd(3, t, K, D), vn=rnd(3, t, K, D))


def _jax_run(c, window):
    kp = jpa.paged_update(jnp.asarray(c["kp"]), jnp.asarray(c["kn"]),
                          jnp.asarray(c["bt"]), jnp.asarray(c["pos"]),
                          jnp.asarray(c["valid"]))
    vp = jpa.paged_update(jnp.asarray(c["vp"]), jnp.asarray(c["vn"]),
                          jnp.asarray(c["bt"]), jnp.asarray(c["pos"]),
                          jnp.asarray(c["valid"]))
    out = jpa.paged_attention(jnp.asarray(c["q"]), kp, vp,
                              jnp.asarray(c["bt"]), jnp.asarray(c["pos"]),
                              window=window, interpret=True)
    return np.asarray(kp), np.asarray(vp), np.asarray(out)


def _torch_run(c, window):
    """The port on a stacked 2-layer lane-folded pool, the case's data in
    layer 1 (layer 0 holds other values: the layer index must pick)."""
    t = torch.from_numpy
    junk = np.full((1, NB + 1, BS, K * D), 7.0, np.float32)
    kp = t(np.concatenate([junk, c["kp"].reshape(1, NB + 1, BS, K * D)]))
    vp = t(np.concatenate([junk, c["vp"].reshape(1, NB + 1, BS, K * D)]))
    bt, pos, valid = t(c["bt"]), t(c["pos"]), t(c["valid"])
    assert tpa.paged_update(kp[1], t(c["kn"]), bt, pos, valid).data_ptr() \
        == kp[1].data_ptr()
    tpa.paged_update(vp[1], t(c["vn"]), bt, pos, valid)
    out = tpa.paged_attention(t(c["q"]), kp, vp, bt, pos, window=window,
                              layer=1)
    assert torch.all(kp[0] == 7.0) and torch.all(vp[0] == 7.0)
    return (kp[1].numpy().reshape(NB + 1, BS, K, D),
            vp[1].numpy().reshape(NB + 1, BS, K, D), out.numpy())


@pytest.mark.parametrize("t,window", [(1, None), (4, None), (13, None),
                                      (4, 1), (13, 6), (13, 17), (1, 1000)])
def test_paged_tile_matches_the_jax_kernel(t, window):
    c = _case(t, seed=100 + t + (window or 0))
    jk, jv, jout = _jax_run(c, window)
    tk, tv, tout = _torch_run(c, window)
    np.testing.assert_array_equal(tk[:NB], jk[:NB])
    np.testing.assert_array_equal(tv[:NB], jv[:NB])
    assert tout.shape == (3, t, H, D) and tout.dtype == np.float32
    np.testing.assert_allclose(tout[c["valid"]], jout[c["valid"]], **TOL)


def test_padded_rows_past_the_table_stay_in_bounds():
    """Slot 2's padded rows (positions 32..42) clip to its last logical
    block, go to the scratch block, and attend over at most the table's
    32 columns; a row with no visible column in range gives 0."""
    c = _case(13, seed=7)
    gpos = c["pos"][:, None] + np.arange(13)[None]
    phys, off = tpa.physical_positions(torch.from_numpy(c["bt"]),
                                       torch.from_numpy(gpos), BS)
    assert int(phys[2, -1]) == int(c["bt"][2, -1]) and int(off[2, -1]) == 42 % BS
    _, _, out = _torch_run(c, window=1)
    # window 1 at position >= 32: the only visible column is past the table
    assert np.all(out[2, 2:] == 0.0)
    assert np.all(np.isfinite(out))


def test_window_must_be_positive():
    c = _case(1, seed=0)
    t = torch.from_numpy
    pool = t(c["kp"].reshape(1, NB + 1, BS, K * D))
    with pytest.raises(ValueError, match="window"):
        tpa.paged_attention(t(c["q"]), pool, pool, t(c["bt"]), t(c["pos"]),
                            window=0)
