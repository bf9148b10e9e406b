"""Parity of the PyTorch port's model layers and full-sequence logits with
the JAX package, fp32 on the CPU (atol = rtol = 1e-5: the two frameworks sum
in different orders, nothing else differs).

Inputs and parameters are made with numpy from a seed and handed to both
packages; the JAX parameter tree is perturbed first so norms and biases are
not the trivial ones/zeros of the init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from deepspeed_tpu_torch.models import transformer as ttf

TOL = dict(atol=1e-5, rtol=1e-5)


def perturbed_params(jax_model, seed=0, scale=0.02):
    """JAX init + seeded numpy noise on every leaf -> numpy tree."""
    rng = np.random.default_rng(seed)
    params = jax.device_get(jax_model.init(jax.random.key(seed)))
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("scaling", [
    None, {"rope_type": "linear", "factor": 4.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 32}])
def test_rope_frequencies(scaling):
    want = jtf.rope_frequencies(16, 64, 10000.0, scaling)
    got = ttf.rope_frequencies(16, 64, 10000.0, scaling)
    _close(got, want)


@pytest.mark.parametrize("rd", [16, 8])
def test_apply_rope_positions_and_partial(rd):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 5)).astype(np.int32)
    fj = jtf.rope_frequencies(rd, 64, 10000.0)
    ft = ttf.rope_frequencies(rd, 64, 10000.0)
    _close(ttf.apply_rope(_t(x), ft, torch.from_numpy(pos)),
           jtf.apply_rope(jnp.asarray(x), fj, jnp.asarray(pos)))
    _close(ttf.apply_rope(_t(x), ft), jtf.apply_rope(jnp.asarray(x), fj))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    w = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    _close(ttf._norm(_t(x), {k: _t(v) for k, v in w.items()}, kind, 1e-5),
           jtf._norm(jnp.asarray(x), w, kind, 1e-5))


@pytest.mark.parametrize("causal,window,S", [
    (True, None, 12), (True, 5, 12), (False, None, 12), (True, None, 20),
    (True, 4, 20)])
def test_repeat_kv_and_xla_attention(causal, window, S):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 12, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 8)).astype(np.float32)
    kr, vr = ttf.repeat_kv(_t(k), _t(v), 4)
    kj, vj = jtf.repeat_kv(jnp.asarray(k), jnp.asarray(v), 4)
    _close(kr, kj)
    _close(vr, vj)
    _close(ttf.xla_attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window),
           jtf.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window))


@pytest.mark.parametrize("overrides", [
    dict(), dict(activation="gelu", proj_bias=True),
    dict(activation="gelu_exact", proj_bias=True),
    dict(activation="relu")])
def test_mlp_block(overrides):
    cfg_j = jax_preset("tiny", dtype="float32", **overrides)
    cfg_t = get_preset("tiny", dtype="float32", **overrides)
    params = perturbed_params(JaxLM(cfg_j), seed=4)
    w = {k: v[0] for k, v in params["layers"]["mlp"].items()}
    x = np.random.default_rng(5).standard_normal((2, 3, 64)).astype(np.float32)
    _close(ttf.mlp_block(_t(x), {k: _t(v) for k, v in w.items()}, cfg_t),
           jtf.mlp_block(jnp.asarray(x), w, cfg_j))


def test_unported_features_raise():
    with pytest.raises(NotImplementedError):
        TransformerLM(get_preset("tiny-moe"))
    # one attention path: no impl selector may route card work elsewhere
    for impl in ("fpdt", "xla"):
        with pytest.raises(NotImplementedError):
            TransformerLM(get_preset("tiny", attention_impl=impl))


def test_cuda_default_raises_without_a_card(monkeypatch):
    """Entry points default to the card and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(get_preset("tiny")).init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(get_preset("tiny")).init_paged_kv_cache(4, 8)


LOGIT_CONFIGS = {
    "tiny-gqa": ("tiny", dict(num_kv_heads=2)),
    "tiny-window": ("tiny", dict(sliding_window=16, window_start_layer=1)),
    "tiny-window-all": ("tiny", dict(sliding_window=8, num_kv_heads=2)),
    "tiny-gpt2": ("tiny-gpt2", dict()),
    "gpt2-family-knobs": ("tiny-gpt2", dict(
        use_rope=True, learned_pos=False, rope_pct=0.5, parallel_block=True,
        qkv_bias=True, proj_bias=True, activation="gelu_exact",
        tie_embeddings=False)),
    "falcon-style": ("tiny-gpt2", dict(
        use_rope=True, learned_pos=False, parallel_block=True,
        parallel_shared_norm=True, activation="relu", num_kv_heads=1)),
    "llama3-rope-scaling": ("tiny", dict(
        num_kv_heads=2, qkv_bias=True, tie_embeddings=False,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "original_max_position_embeddings": 32})),
}


@pytest.mark.parametrize("name", sorted(LOGIT_CONFIGS))
def test_full_logits_match(name):
    preset, ov = LOGIT_CONFIGS[name]
    jm = JaxLM(jax_preset(preset, dtype="float32", **ov))
    tm = TransformerLM(get_preset(preset, dtype="float32", **ov))
    params = perturbed_params(jm, seed=6)
    ids = np.random.default_rng(7).integers(0, 256, (2, 40)).astype(np.int32)
    want = jm.logits(jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(ids))
    got = tm.logits(params_from_numpy(params, device="cpu"),
                    torch.from_numpy(ids))
    assert got.shape == (2, 40, 256)
    _close(got, want)


def test_init_tree_matches_reference_structure():
    """The port's init draws other numbers than jax.random, but the tree,
    shapes and dtypes are the reference's (what the bridge relies on)."""
    for preset, ov in LOGIT_CONFIGS.values():
        jp = jax.eval_shape(JaxLM(jax_preset(preset, **ov)).init,
                            jax.random.key(0))
        tp = TransformerLM(get_preset(preset, **ov)).init(seed=0,
                                                          device="cpu")
        flat_j = {jax.tree_util.keystr(k): v.shape for k, v in
                  jax.tree_util.tree_flatten_with_path(jp)[0]}
        flat_t = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                  jax.tree_util.tree_flatten_with_path(tp)[0]}
        assert flat_t == flat_j
