"""Flash attention forward of the PyTorch port against the JAX package's
Pallas kernel in interpret mode (fp32 on the CPU, atol = rtol = 1e-5). The
card's kernel D is held against its plain version in
``test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa
from tests._torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B, T, S, H, K, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, d)).astype(np.float32),
            rng.standard_normal((B, S, K, d)).astype(np.float32),
            rng.standard_normal((B, S, K, d)).astype(np.float32))


@pytest.mark.parametrize("causal,window,H,K", [
    (True, None, 4, 4), (True, None, 4, 2), (True, 7, 4, 2),
    (False, None, 4, 1), (True, 1, 2, 2)])
def test_flash_attention_matches_pallas(causal, window, H, K):
    q, k, v = _inputs(2, 32, 32, H, K, 16, seed=H * 10 + K)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window, interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rel_offset,window", [(0, None), (16, None),
                                               (16, 20), (32, 8)])
def test_flash_attention_lse_rel_offset(rel_offset, window):
    q, k, v = _inputs(1, 16, 48, 4, 2, 16, seed=rel_offset)
    o_j, lse_j = jfa.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, rel_offset=rel_offset, interpret=True)
    o_t, lse_t = tfa.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, rel_offset=rel_offset)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               **TOL)


def test_window_rejects_ragged_and_noncausal():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 16, 2, 2, 8, 0))
    with pytest.raises(ValueError, match="T == S"):
        tfa.flash_attention(q, k, v, window=4)
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, k[:, :8], v[:, :8], causal=False, window=4)


def test_mixed_devices_raise():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 2, 8, 0))
    with pytest.raises(ValueError, match="all be on"):
        tfa.flash_attention_lse(q, k.to("meta"), v)
