"""The port's dense-tile engines against the JAX package's, fp32 ``tiny``
with GQA (4 query heads over 2 kv heads) on the CPU, the same bridged
weights and the same ``put`` calls:

* ``InferenceEngineV2(packed=False)`` -- one ``[max_sequences, t_max]``
  tile a step through ``forward_with_paged_cache`` (kernel I's ops; the
  JAX engine runs its Pallas ``_paged_kernel`` in interpret mode);
* ``InferenceEngineV2(paged=False)`` -- the same tile over a dense cache
  through ``forward_with_cache``.

Script: a prompt batch (5, 11 and 50 tokens), a mixed ``put`` (three
decode tokens beside a fresh 21-token prompt: slot 2's padded rows then
reach position 70, past the 64-token table / cache), and 8 decode ``put``
steps fed the JAX engine's argmax. Every ``put``'s logits agree to atol =
rtol = 1e-4 and the port's greedy token equals the JAX engine's at every
step; slot positions and block tables agree after the script. Each
configuration also runs on a sliding-window model (window 6 from layer 1
on). ``decode_batch`` and an int8 KV pool raise as the reference's do,
and a dense cache made by the JAX model crosses the bridge and goes on
serving in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from tests._torch_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ENGINE_KW = dict(max_sequences=4, max_seq_len=64, block_size=8)
DECODE_PUTS = 8
CONFIGS = {"packed=False": dict(packed=False),
           "paged=False": dict(paged=False)}
MODELS = {"full": {}, "window": dict(sliding_window=6, window_start_layer=1)}


def _perturbed(jax_model, seed=0, scale=0.02):
    rng = np.random.default_rng(seed)
    params = jax.device_get(jax_model.init(jax.random.key(seed)))
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def _run(model, engine):
    cfg = dict(dtype="float32", num_kv_heads=2, **MODELS[model])
    jm, tm = JaxLM(jax_preset("tiny", **cfg)), TransformerLM(
        get_preset("tiny", **cfg))
    params = _perturbed(jm, seed=21)
    kw = dict(ENGINE_KW, **CONFIGS[engine])
    jeng = JaxEngine(jm, params=jax.tree_util.tree_map(jnp.asarray, params),
                     **kw)
    teng = InferenceEngineV2(tm, params_from_numpy(params, device="cpu"),
                             device="cpu", **kw)
    rng = np.random.default_rng(22)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (5, 11, 50)]
    fresh = rng.integers(1, 256, 21).astype(np.int32)
    rec = {"jax": [], "torch": []}
    rec["jax"].append(jeng.put([0, 1, 2], prompts))
    rec["torch"].append(teng.put([0, 1, 2], prompts))
    toks = [np.array([int(np.argmax(rec["jax"][-1][u]))], np.int32)
            for u in range(3)]
    rec["jax"].append(jeng.put([0, 1, 2, 3], toks + [fresh]))
    rec["torch"].append(teng.put([0, 1, 2, 3], toks + [fresh]))
    for _ in range(DECODE_PUTS):
        toks = [np.array([int(np.argmax(rec["jax"][-1][u]))], np.int32)
                for u in range(4)]
        rec["jax"].append(jeng.put([0, 1, 2, 3], toks))
        rec["torch"].append(teng.put([0, 1, 2, 3], toks))
    if teng.paged:
        state = {"jax": (jeng._pos.copy(), np.asarray(jeng._block_tables())),
                 "torch": (teng._pos.copy(), teng._block_tables().copy())}
    else:
        state = {"jax": (np.asarray(jeng.cache["pos"]),),
                 "torch": (teng.cache["pos"].numpy(),)}
    return dict(rec=rec, state=state, engines=(jeng, teng))


@pytest.mark.parametrize("model,engine",
                         [(m, e) for m in MODELS for e in CONFIGS])
def test_dense_engine_matches_the_jax_engine(model, engine):
    """One test per engine pair, so each pair is built once per worker."""
    run = _run(model, engine)
    for step, (want, got) in enumerate(zip(run["rec"]["jax"],
                                           run["rec"]["torch"])):
        assert sorted(got) == sorted(want)
        for uid in want:
            w = np.asarray(want[uid], np.float32)
            assert got[uid].shape == (256,) and got[uid].dtype == np.float32
            np.testing.assert_allclose(got[uid], w, **LOGIT_TOL,
                                       err_msg=f"put {step} uid {uid}")
            assert int(np.argmax(got[uid])) == int(np.argmax(w)), (
                f"put {step} uid {uid}: greedy token differs")
    for want, got in zip(run["state"]["jax"], run["state"]["torch"]):
        np.testing.assert_array_equal(got, want)
    for eng in run["engines"]:
        with pytest.raises(ValueError, match="packed paged engine"):
            eng.decode_batch([0], [3], steps=2)


@pytest.mark.parametrize("engine", list(CONFIGS))
def test_quantized_kv_needs_the_packed_engine(engine):
    tm = TransformerLM(get_preset("tiny", dtype="float32"))
    with pytest.raises(ValueError, match="quantized KV"):
        InferenceEngineV2(tm, device="cpu", kv_dtype="int8",
                          **CONFIGS[engine], **ENGINE_KW)


def test_int8_pool_raises_in_the_dense_tile_step():
    """The model-level guard of the reference (:1063): the dense-tile step
    refuses a quantized pool."""
    tm = TransformerLM(get_preset("tiny", dtype="float32"))
    params = tm.init(seed=0, device="cpu")
    cache = tm.init_paged_kv_cache(8, 8, device="cpu", quantize=True)
    ids = torch.zeros(1, 2, dtype=torch.int32)
    bt = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="int8 KV"):
        tm.forward_with_paged_cache(params, ids, cache, bt,
                                    torch.zeros(1, dtype=torch.int32))


def test_a_dense_cache_crosses_the_bridge():
    """A prompt step of the JAX model's ``forward_with_cache``, its cache
    bridged with ``params_from_numpy``, then one decode step in each
    package from that cache: logits to 1e-4, caches equal to 1e-5."""
    cfg = dict(dtype="float32", num_kv_heads=2)
    jm, tm = JaxLM(jax_preset("tiny", **cfg)), TransformerLM(
        get_preset("tiny", **cfg))
    params = _perturbed(jm, seed=23)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    ids = np.random.default_rng(24).integers(1, 256, (2, 7)).astype(np.int32)
    step = jax.jit(jm.forward_with_cache)
    _, jcache = step(jp, jnp.asarray(ids), jm.init_kv_cache(2, 32))
    tcache = params_from_numpy(jax.device_get(jcache), device="cpu")
    assert tcache["pos"].dtype == torch.int32 and tcache["pos"].tolist() == [7, 7]
    nxt = np.array([[3], [5]], np.int32)
    jl, jcache = step(jp, jnp.asarray(nxt), jcache)
    tl, tcache = tm.forward_with_cache(tp, torch.from_numpy(nxt), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=1e-5,
                                   rtol=1e-5)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
