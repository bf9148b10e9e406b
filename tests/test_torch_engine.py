"""The PyTorch port's ``InferenceEngineV2`` against the JAX package's, fp32
``tiny`` with GQA on the CPU: the same bridged weights, the same sequence of
``put``/``decode_batch`` calls.

* every ``put``'s logits agree to atol 1e-4 (rtol 1e-4): whole-prompt
  prefill, single-token decode steps, a prompt longer than ``MAX_ATOM`` fed
  in chunks beside decode tokens, and a chunk continuing a sequence;
* ``decode_batch(steps=12)`` gives identical greedy tokens up to the first
  step where the JAX run's top-2 logit gap is below 1e-3 (cross-framework
  sums differ in order, so a near tie may flip; after a flip the two
  sequences legitimately diverge).

``MAX_ATOM`` is set to 16 on both models so the chunking loop runs at the
tiny preset's ``max_seq_len`` of 64. The JAX engine runs its XLA twins
(``decode_kernel='xla'``); engines are module-scoped because each JAX
engine compiles its step programs once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import CapacityError, InferenceEngineV2
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from tests._torch_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3
STEPS = 12
ENGINE_KW = dict(max_sequences=8, max_seq_len=64, block_size=8)


def _perturbed(jax_model, seed=0, scale=0.02):
    rng = np.random.default_rng(seed)
    params = jax.device_get(jax_model.init(jax.random.key(seed)))
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def _script(eng, prompts, long_prompt, cont):
    """The put sequence both engines run; returns (per-put logits, the
    start tokens of decode_batch)."""
    rec = []
    uids = list(range(len(prompts)))
    rec.append(eng.put(uids, prompts))                        # whole prefill
    toks = [np.array([int(np.argmax(rec[-1][u]))], np.int32) for u in uids]
    rec.append(eng.put(uids, toks))                           # decode atoms
    toks = [np.array([int(np.argmax(rec[-1][u]))], np.int32) for u in uids]
    rec.append(eng.put(uids + [5], toks + [long_prompt]))     # chunked + dec
    toks = {u: int(np.argmax(rec[-1][u])) for u in uids + [5]}
    rec.append(eng.put([5, 2], [cont, np.array([toks[2]], np.int32)]))
    toks[5] = int(np.argmax(rec[-1][5]))
    toks[2] = int(np.argmax(rec[-1][2]))
    return rec, [toks[u] for u in uids + [5]]


@pytest.fixture(scope="module")
def runs():
    cfg = dict(dtype="float32", num_kv_heads=2)
    jm = JaxLM(jax_preset("tiny", **cfg))
    tm = TransformerLM(get_preset("tiny", **cfg))
    jm.MAX_ATOM = tm.MAX_ATOM = 16
    params = _perturbed(jm, seed=11)
    jeng = JaxEngine(jm, params=jax.tree_util.tree_map(jnp.asarray, params),
                     decode_kernel="xla", **ENGINE_KW)
    teng = InferenceEngineV2(tm, params_from_numpy(params, device="cpu"),
                             device="cpu", **ENGINE_KW)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 256, n).astype(np.int32)
               for n in (3, 8, 11, 16, 21)]
    long_prompt = rng.integers(1, 256, 40).astype(np.int32)
    cont = rng.integers(1, 256, 5).astype(np.int32)
    out = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        rec, starts = _script(eng, prompts, long_prompt, cont)
        dec = eng.decode_batch(list(range(6)), starts, steps=STEPS)
        out[name] = dict(rec=rec, starts=starts, dec=dec,
                         pos=eng._pos.copy(),
                         bt=np.asarray(eng._block_tables()).copy(),
                         free=eng.state.allocator.free_blocks)
    # margins of the JAX run's greedy steps: replay its decoded tokens one
    # put at a time on a fresh copy of the same sequences
    jeng.flush(list(range(6)))
    _script(jeng, prompts, long_prompt, cont)
    feed = list(out["jax"]["starts"])
    margins, replayed = [], []
    for s in range(STEPS):
        lg = jeng.put(list(range(6)), [np.array([t], np.int32) for t in feed])
        top2 = [np.sort(np.asarray(lg[u], np.float32))[-2:] for u in range(6)]
        margins.append([t[1] - t[0] for t in top2])
        replayed.append([int(np.argmax(lg[u])) for u in range(6)])
        feed = [int(out["jax"]["dec"][u][s]) for u in range(6)]
    out["margins"] = np.asarray(margins)                       # [steps, 6]
    out["replayed"] = np.asarray(replayed)
    out["torch_engine"] = teng
    return out


@pytest.mark.parametrize("step", range(4))
def test_put_logits_match(runs, step):
    want, got = runs["jax"]["rec"][step], runs["torch"]["rec"][step]
    assert sorted(want) == sorted(got)
    for uid in want:
        assert got[uid].shape == (256,) and got[uid].dtype == np.float32
        np.testing.assert_allclose(got[uid], np.asarray(want[uid], np.float32),
                                   **LOGIT_TOL, err_msg=f"uid {uid}")


def test_decode_start_tokens_identical(runs):
    assert runs["torch"]["starts"] == runs["jax"]["starts"]


@pytest.mark.parametrize("uid", range(6))
def test_decode_batch_greedy_tokens(runs, uid):
    want = np.asarray(runs["jax"]["dec"][uid])
    got = np.asarray(runs["torch"]["dec"][uid])
    assert got.shape == (STEPS,) and got.dtype == np.int32
    diff = np.nonzero(got != want)[0]
    if diff.size:
        s = int(diff[0])
        assert runs["margins"][s, uid] < MARGIN, (
            f"uid {uid} step {s}: {got[s]} vs {want[s]} with a JAX top-2 "
            f"gap of {runs['margins'][s, uid]:.2e}")


def test_margin_replay_reproduces_the_jax_decode(runs):
    """The margins are only meaningful if the one-token-put replay walks
    the same greedy path as the JAX fused decode (up to its own near ties)."""
    dec = np.stack([np.asarray(runs["jax"]["dec"][u]) for u in range(6)], 1)
    same = runs["replayed"] == dec
    assert np.all(same | (runs["margins"] < MARGIN))


def test_engine_bookkeeping_matches(runs):
    j, t = runs["jax"], runs["torch"]
    np.testing.assert_array_equal(t["pos"], j["pos"])
    np.testing.assert_array_equal(t["bt"], j["bt"])
    assert t["free"] == j["free"]


def test_flush_restores_the_pool(runs):
    eng = runs["torch_engine"]
    eng.flush(list(range(6)))
    assert eng.state.allocator.leaked_blocks() == []
    assert not eng._pos.any()


def test_capacity_and_unported_options():
    tm = TransformerLM(get_preset("tiny", dtype="float32"))
    eng = InferenceEngineV2(tm, device="cpu", **ENGINE_KW)
    with pytest.raises(CapacityError):
        eng.put([0], [np.arange(1, 66, dtype=np.int32)])      # > max_seq_len
    assert eng.state.sequences == {}
    # the dense-tile engines are ported (tests/test_torch_dense_engines.py);
    # a quantized pool still needs the packed paged engine (:153)
    for kw in (dict(packed=False), dict(paged=False)):
        assert not InferenceEngineV2(tm, device="cpu", **kw,
                                     **ENGINE_KW).packed
        with pytest.raises(ValueError, match="quantized KV"):
            InferenceEngineV2(tm, device="cpu", kv_dtype="int8", **kw,
                              **ENGINE_KW)
    # quantized KV and weights are ported; a bad value raises as the
    # reference does (engine_v2.py:122-124, :149-151)
    for kw, what in ((dict(kv_dtype="int2"), "kv_dtype"),
                     (dict(weight_dtype="fp8"), "weight_dtype")):
        with pytest.raises(ValueError, match=what):
            InferenceEngineV2(tm, device="cpu", **kw, **ENGINE_KW)
    # sampling, the prefix cache, speculation, tiers, pause/resume and MoE
    # serving are ported (tests/test_torch_engine_features.py, the
    # prefix-cache, KV-tier and MoE serving tests); a mesh still raises,
    # naming its ROADMAP item. The MoE options change nothing on a dense
    # model, as in the reference (it resolves them on a grouped MoE model)
    with pytest.raises(NotImplementedError,
                       match='"Mesh, ZeRO and tensor parallelism"'):
        InferenceEngineV2(tm, device="cpu", mesh={"tp": 2}, **ENGINE_KW)
    assert InferenceEngineV2(tm, device="cpu", moe_kernel="ragged",
                             **ENGINE_KW).moe_kernel is None
    eng.put([0], [np.arange(1, 5, dtype=np.int32)])
    toks = eng.decode_batch([0], [3], steps=2, temperature=0.7, seed=1)[0]
    assert toks.shape == (2,) and 0 <= toks.min() and toks.max() < 256
