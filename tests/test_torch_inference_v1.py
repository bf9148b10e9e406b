"""The port's ``init_inference`` / v1 ``InferenceEngine`` against the JAX
package's on the CPU, fp32, the same bridged weights:

* ``generate`` greedy: token-identical, with and without EOS padding (the
  EOS id is a token row 0 first emits at its third step or later and row
  1 never does, so row 0 pads from there while row 1 runs on);
* ``forward``: full-sequence logits to atol = rtol = 1e-4;
* ``dtype="int8"`` (hidden 128, vocab 512: every leaf quantizes): the
  quantized trees are bit-identical, ``forward`` logits agree to 1e-4 and
  greedy ``generate`` is token-identical;
* ``sample_token`` on fixed logits: greedy tokens and ``with_logprob``
  values equal JAX's (1e-6). Under temperature, top-k and top-p the random
  streams differ, so draws are not compared: every token the port draws
  lies in the support the reference's rule keeps, and its logprob equals
  the log-softmax of the reference's filtered logits at that token (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.inference.engine import sample_token as jax_sample
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference.engine import sample_token
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.models.transformer import QuantizedWeight

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, arch="llama", dtype="float32")
QUANT = dict(TINY, vocab_size=512, hidden_size=128)


def _pair(cfg, seed):
    jm, tm = JaxLM(JaxConfig(**cfg)), TransformerLM(TransformerConfig(**cfg))
    rng = np.random.default_rng(seed)
    params = jax.device_get(jm.init(jax.random.key(seed)))
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape))
        .astype(np.float32), params)
    return jm, tm, params


def _engines(cfg, seed, dtype=None):
    jm, tm, params = _pair(cfg, seed)
    jeng = jds.init_inference(jm, params=jax.tree_util.tree_map(jnp.asarray,
                                                                params),
                              dtype=dtype)
    teng = tds.init_inference(tm, params=params_from_numpy(params, "cpu"),
                              dtype=dtype, device="cpu")
    return jeng, teng


def _ids(vocab, seed=3):
    return np.random.default_rng(seed).integers(1, vocab, (2, 9)).astype(
        np.int32)


def test_generate_greedy_matches_with_eos_padding():
    jeng, teng = _engines(TINY, seed=31)
    ids = _ids(256, seed=8)
    want = np.asarray(jeng.generate(ids, max_new_tokens=12))
    got = teng.generate(ids, max_new_tokens=12)
    assert got.shape == (2, 21)
    np.testing.assert_array_equal(got, want)
    # EOS: a token row 0 first emits at its third step or later and row 1
    # never does
    gen = want[:, 9:]
    k, eos = next((k, int(t)) for k, t in enumerate(gen[0]) if k >= 2
                  and t not in gen[0, :k] and t not in gen[1])
    want = np.asarray(jeng.generate(ids, max_new_tokens=12, eos_token_id=eos))
    got = teng.generate(ids, max_new_tokens=12, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 21) and np.all(got[0, 9 + k:] == eos)
    assert eos not in got[1, 9:]


def test_generate_loop_returns_the_greedy_logprobs():
    """``generate_loop(return_logprobs=True)`` (the hybrid engine's form):
    the same tokens and per-token logprobs as the reference's loop (1e-4),
    EOS pads logged as 0."""
    from deepspeed_tpu.inference.engine import generate_loop as jax_loop
    from deepspeed_tpu_torch.inference.engine import generate_loop

    jeng, teng = _engines(TINY, seed=31)
    ids = _ids(256, seed=8)
    eos = int(np.asarray(jeng.generate(ids, max_new_tokens=4))[0, 9 + 2])
    want = jax_loop(jeng._step, jeng.params, jeng.mesh,
                    jeng.module.init_kv_cache, ids, 9 + 6, 0.0, 0, 0, eos,
                    return_logprobs=True)
    got = generate_loop(teng.module.forward_with_cache, teng.params,
                        teng._init_cache, ids, 9 + 6, 0.0, 0, 0, eos,
                        return_logprobs=True, device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **TOL)
    assert got[1].shape == (2, 6) and np.all(got[1][0, 3:] == 0.0)


def test_forward_logits_match():
    jeng, teng = _engines(TINY, seed=32)
    ids = _ids(256, seed=4)
    want = np.asarray(jeng.forward(ids))
    got = teng.forward(ids)
    assert tuple(got.shape) == (2, 9, 256)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_int8_weights_match():
    jeng, teng = _engines(QUANT, seed=33, dtype="int8")
    jq = jeng.params["layers"]["attn"]["wqkv"]
    tq = teng.params["layers"]["attn"]["wqkv"]
    assert isinstance(tq, QuantizedWeight) and tq.bits == 8
    np.testing.assert_array_equal(tq.packed.numpy(), np.asarray(jq.packed))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    ids = _ids(512, seed=5)
    np.testing.assert_allclose(teng.forward(ids).numpy(),
                               np.asarray(jeng.forward(ids)), **TOL)
    np.testing.assert_array_equal(
        teng.generate(ids, max_new_tokens=6),
        np.asarray(jeng.generate(ids, max_new_tokens=6)))


def test_checkpoint_loading_is_not_ported():
    tm = TransformerLM(TransformerConfig(**TINY))
    with pytest.raises(NotImplementedError, match="models/hf.py"):
        tds.init_inference(tm, checkpoint="/nonexistent", device="cpu")


def _logits(seed=6, B=4, V=64):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(
        np.float32) * 3.0


def test_sample_token_greedy_matches():
    lg = _logits()
    jt, jlp = jax_sample(jnp.asarray(lg), 0.0, 0, jax.random.key(0),
                         with_logprob=True)
    tt, tlp = sample_token(torch.from_numpy(lg), 0.0, 0, None,
                           with_logprob=True)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-6,
                               rtol=1e-6)
    assert torch.equal(sample_token(torch.from_numpy(lg), 0.0, 0), tt)


def _reference_filtered(lg, temperature, top_k, top_p):
    """The reference's filtered sampling logits over the whole vocabulary
    (-inf outside the support it keeps), from its own rule in numpy."""
    lp = lg / temperature
    if top_k > 0:
        order = np.argsort(-lp, axis=-1, kind="stable")[:, :top_k]
        vals = np.take_along_axis(lp, order, axis=-1)
        if top_p < 1.0:
            e = np.exp(vals - vals.max(-1, keepdims=True))
            cum = np.cumsum(e / e.sum(-1, keepdims=True), axis=-1)
            keep = np.concatenate([np.ones_like(cum[:, :1], bool),
                                   cum[:, :-1] < top_p], axis=-1)
            vals = np.where(keep, vals, -np.inf)
        out = np.full_like(lp, -np.inf)
        np.put_along_axis(out, order, vals, axis=-1)
        return out
    if top_p < 1.0:
        e = np.exp(lp - lp.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
        sp = -np.sort(-probs, axis=-1)
        k = np.argmax(np.cumsum(sp, axis=-1) >= top_p, axis=-1)
        cutoff = np.take_along_axis(sp, k[:, None], axis=-1)
        lp = np.where(probs < cutoff, -np.inf, lp)
    return lp


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 1.0), (1.3, 5, 1.0), (0.9, 8, 0.6), (1.0, 0, 0.5)])
def test_sample_token_draws_lie_in_the_reference_support(temperature, top_k,
                                                         top_p):
    lg = _logits(seed=7)
    filt = _reference_filtered(lg.astype(np.float64), temperature, top_k,
                               top_p)
    m = filt.max(-1, keepdims=True)
    logp = filt - (m + np.log(np.exp(filt - m).sum(-1, keepdims=True)))
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(50):
        tok, lp = sample_token(torch.from_numpy(lg), temperature, top_k, gen,
                               with_logprob=True, top_p=top_p)
        tok = tok.numpy()
        assert np.all(np.isfinite(filt[np.arange(4), tok])), (
            f"drew a token outside the kept support: {tok}")
        np.testing.assert_allclose(lp.numpy(), logp[np.arange(4), tok],
                                   atol=1e-5, rtol=1e-5)
        seen.update(zip(range(4), tok.tolist()))
    assert len(seen) > 4, "the sampler drew one token per row every time"
    # the JAX sampler keeps the same support on the same logits
    jt = np.asarray(jax_sample(jnp.asarray(lg), temperature, top_k,
                               jax.random.key(1), top_p=top_p))
    assert np.all(np.isfinite(filt[np.arange(4), jt]))
