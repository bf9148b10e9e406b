"""The PyTorch port's quantized ``InferenceEngineV2`` against the JAX
package's on the CPU: fp32 weights from the JAX init (a model like the JAX
package's own weight-quantization test: hidden 128, vocab 512, 2 layers, 4
query heads over 2 kv heads), bridged as numpy, served by both engines with
the same ``weight_dtype`` x ``kv_dtype`` pair -- the two pairs the card runs
(int4 weights with an int8 pool, int8 weights with an int4 pool), tied and
untied heads.

* the quantized parameter trees are bit-identical (fused ``wqkv`` /
  ``w_gateup``, packed bytes, scales, ``lm_head_q``; untied drops
  ``lm_head``);
* every ``put``'s logits agree: whole-prompt prefill (kernel H's plain
  version over 128 rows), decode tokens over the int pool, and a prompt
  longer than ``MAX_ATOM`` chunked beside decode tokens (B's int modes).
  Tolerances: int4 pool atol = rtol = 1e-4 (fp32 sums in another order;
  measured <= 3e-6); int8 pool atol = 1e-2 x that row's max |logit| (the
  reference's int8 decode kernel rounds ``p * v_scale`` to bf16 before its
  P V product, :512, the port's plain version does not; measured <= 3.5e-3
  of the max). A K/V element on a rounding boundary of its quantization
  would move a logit by more -- none does in these inputs;
* ``decode_batch(steps=4)`` gives the JAX engine's greedy tokens up to the
  first step where the port's own top-2 logit gap is within twice that
  tolerance (a near tie), after which the two runs may diverge.

The JAX engine runs its Pallas kernels in interpret mode where the pool is
int8 (its XLA ``put`` path would skip the int8 q-hat that kernel A and the
port apply), its XLA twins otherwise, and kernels G/H in interpret mode.
Each configuration is one test, so its two engines are built once. The
reference's time goes to compiling each distinct ``put`` in interpret
mode, so the script keeps them few: the long prompt (24 tokens) is fed
as one 16-token atom and then its last 8 beside the decode tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference.quant import parse_weight_dtype
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.models.transformer import QuantizedWeight
from tests._torch_threads import one_torch_thread  # noqa: F401

TOL_INT4_KV = 1e-4
TOL_INT8_KV = 1e-2         # x the row's max |logit|
STEPS = 4
ENGINE_KW = dict(max_sequences=4, max_seq_len=64, block_size=8)
PAIRS = [("int4", "int8"), ("int8", "int4")]
CFG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=256, arch="llama", dtype="float32")


def _script(eng, prompts, long_prompt):
    rec = [eng.put([0, 1, 2], prompts)]                       # whole prefill
    toks = [np.array([int(np.argmax(rec[-1][u]))], np.int32) for u in range(3)]
    rec.append(eng.put([0, 1, 2], toks))                      # decode atoms
    toks = [np.array([int(np.argmax(rec[-1][u]))], np.int32) for u in range(3)]
    rec.append(eng.put([0, 1, 2, 3], toks + [long_prompt]))   # chunked + dec
    return rec, [int(np.argmax(rec[-1][u])) for u in range(4)]


def _run(wd, kd, tie):
    jm = JaxLM(JaxConfig(tie_embeddings=tie, **CFG))
    tm = TransformerLM(TransformerConfig(tie_embeddings=tie, **CFG))
    jm.MAX_ATOM = tm.MAX_ATOM = 16
    params = jax.device_get(jm.init(jax.random.key(1 if tie else 2)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    params)
    jeng = JaxEngine(jm, params=jax.tree_util.tree_map(jnp.asarray, params),
                     decode_kernel="pallas" if kd == "int8" else "xla",
                     weight_dtype=wd, kv_dtype=kd,
                     **ENGINE_KW)
    teng = InferenceEngineV2(tm, params_from_numpy(params, device="cpu"),
                             device="cpu", weight_dtype=wd, kv_dtype=kd,
                             **ENGINE_KW)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (5, 11, 16)]
    long_prompt = rng.integers(1, 512, 24).astype(np.int32)
    out = {"jax_params": jax.device_get(jeng.params),
           "torch_params": teng.params}
    recorded = []
    real = tm.forward_decode_tail

    def recording(*args, **kw):
        logits, tail = real(*args, **kw)
        recorded.append(logits.float().numpy().copy())
        return logits, tail

    tm.forward_decode_tail = recording
    for name, eng in (("jax", jeng), ("torch", teng)):
        rec, starts = _script(eng, prompts, long_prompt)
        out[name] = dict(rec=rec, dec=eng.decode_batch([0, 1, 2, 3], starts,
                                                       steps=STEPS))
    out["torch_decode_logits"] = recorded
    out["torch_engine"] = teng
    return out


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _check_trees(jax_params, torch_params):
    j, t = dict(_flat(jax_params)), dict(_flat(torch_params))
    assert sorted(j) == sorted(t)
    n_quant = 0
    for path, tl in t.items():
        jl = j[path]
        if isinstance(tl, QuantizedWeight):
            n_quant += 1
            assert (tl.bits, tl.din) == (jl.bits, jl.din), path
            np.testing.assert_array_equal(tl.packed.numpy(),
                                          np.asarray(jl.packed), str(path))
            np.testing.assert_array_equal(tl.scales.numpy(),
                                          np.asarray(jl.scales), str(path))
        else:
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl),
                                          str(path))
    assert n_quant == 5          # wqkv, wo, w_gateup, w_down and the head
    assert ("layers", "attn", "wq") not in t and ("lm_head",) not in t


@pytest.mark.parametrize("wd,kd,tie", [(wd, kd, tie) for wd, kd in PAIRS
                                       for tie in (True, False)],
                         ids=lambda v: {True: "tied", False: "untied"}.get(
                             v, v) if isinstance(v, bool) else v)
def test_engine_matches_jax(wd, kd, tie):
    run = _run(wd, kd, tie)
    _check_trees(run["jax_params"], run["torch_params"])
    for step in range(3):
        want, got = run["jax"]["rec"][step], run["torch"]["rec"][step]
        assert sorted(want) == sorted(got)
        for uid in want:
            w = np.asarray(want[uid], np.float32)
            assert got[uid].shape == (512,) and got[uid].dtype == np.float32
            tol = (dict(atol=TOL_INT8_KV * float(np.abs(w).max()), rtol=0)
                   if kd == "int8" else dict(atol=TOL_INT4_KV,
                                             rtol=TOL_INT4_KV))
            np.testing.assert_allclose(got[uid], w, **tol,
                                       err_msg=f"put {step} uid {uid}")
    rows = run["torch_decode_logits"]
    assert len(rows) == STEPS
    for uid in range(4):
        want = np.asarray(run["jax"]["dec"][uid])
        got = np.asarray(run["torch"]["dec"][uid])
        assert got.shape == (STEPS,) and got.dtype == np.int32
        diff = np.nonzero(got != want)[0]
        if diff.size:
            s = int(diff[0])
            lo, hi = np.sort(rows[s][uid])[-2:]
            gap = 2 * (TOL_INT8_KV * abs(hi) if kd == "int8"
                       else TOL_INT4_KV * (1 + abs(hi)))
            assert hi - lo < gap, (f"uid {uid} step {s}: {got[s]} vs "
                                   f"{want[s]}, port top-2 gap {hi - lo:.2e}")
    eng = run["torch_engine"]
    eng.flush([0, 1, 2, 3])
    assert eng.state.allocator.leaked_blocks() == []
    assert eng.cache["k"].dtype == torch.int8


def test_parse_weight_dtype():
    assert [parse_weight_dtype(d) for d in
            (None, "int8", "int4", np.int8, torch.int8, torch.bfloat16,
             "fp16")] == ["bf16", "int8", "int4", "int8", "int8", "bf16",
                          "bf16"]


def test_bad_dtypes_and_unpacked_quant_kv_raise():
    tm = TransformerLM(TransformerConfig(**CFG))
    for kw in (dict(weight_dtype="int2"), dict(kv_dtype="fp8"),
               dict(kv_dtype="int8", packed=False)):
        with pytest.raises(ValueError):
            InferenceEngineV2(tm, device="cpu", **kw, **ENGINE_KW)
