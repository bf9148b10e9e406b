"""The port at head dims 96 and 256 against the JAX package, fp32 on the CPU:
2-layer narrow models shaped like ``phi3-mini`` (llama, H = K = 2, hidden
192: d = 96) and ``pythia-1b`` (gpt2 with rotary on a quarter of each head,
a parallel block and biases, H = 2, hidden 512: d = 256) -- the
``PRESET_SHAPED`` overrides the card tests use -- with the JAX init's
weights perturbed by numpy noise and bridged as numpy:

* full-sequence logits (atol = rtol = 1e-5, as ``test_torch_model.py``);
* ``InferenceEngineV2``: whole prompts, decode tokens, a prompt longer than
  ``MAX_ATOM`` chunked beside decode tokens, then ``decode_batch`` over a
  bf16-path (fp32 here), an int8 and an int4 pool, at the tolerances of
  ``test_torch_engine.py`` / ``test_torch_quant_engine.py``; the greedy
  tokens equal the JAX engine's;
* the ``packed=False`` engine (kernel I's path) at ``test_torch_dense_engines
  .py``'s tolerance, its greedy token equal at every step;
* one ``train_batch`` of each training engine (loss and grad norm to 1e-5
  relative, as ``test_torch_train.py``) and the per-leaf gradients of the
  loss (max abs error <= 1e-5 x (1 + the leaf's largest |gradient|));
* the plain versions of kernels A (bf16, int8, int4 pools), B and C (the
  ragged path, each pool), D, E/F and I at d = 96 and 256 against the JAX
  functions, their Pallas kernels in interpret mode, at the kernel tests'
  tolerances;
* the source contract: every launcher dispatches ``CARD_HEAD_DIMS`` and
  every wrapper refuses any other head dim before a launch.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from deepspeed_tpu_torch.ops import CARD_HEAD_DIMS
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import paged_attention as tpa
from deepspeed_tpu_torch.ops._build import KERNELS
from tests.test_torch_flash_backward import _jax_bwd
from tests.test_torch_kernels_cuda import PRESET_SHAPED
from tests.test_torch_model import perturbed_params
from tests.test_torch_quant_engine import _flat, _script

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "deepspeed_tpu_torch/csrc"
PRESETS = sorted(PRESET_SHAPED)
HEAD_DIM = {"phi3-mini": 96, "pythia-1b": 256}
TOL = dict(atol=1e-5, rtol=1e-5)            # fp32, sums in another order
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)      # engines (test_torch_engine.py)
TOL_INT8_KV = 1e-2                          # x the row's max |logit|
ENGINE_KW = dict(max_sequences=4, max_seq_len=64, block_size=8)
STEPS = 6


def _models(preset, **extra):
    ov = dict(PRESET_SHAPED[preset], dtype="float32", **extra)
    jm, tm = JaxLM(jax_preset(preset, **ov)), TransformerLM(get_preset(
        preset, **ov))
    assert tm.cfg.head_dim == HEAD_DIM[preset]
    return jm, tm


# ---------------------------------------------------------------------------
# the models and engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_logits_match(preset):
    jm, tm = _models(preset)
    params = perturbed_params(jm, seed=31)
    ids = np.random.default_rng(32).integers(1, 512, (2, 24)).astype(np.int32)
    want = jm.logits(jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(ids))
    got = tm.logits(params_from_numpy(params, device="cpu"),
                    torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)


def _logit_tol(kv, want):
    if kv == "int8":
        return dict(atol=TOL_INT8_KV * float(np.abs(want).max()), rtol=0)
    return LOGIT_TOL


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("preset", PRESETS)
def test_engine_matches_jax(preset, kv):
    """The JAX engine runs its Pallas kernels in interpret mode over an int8
    pool (its XLA ``put`` path would skip the int8 q-hat), its XLA twins
    otherwise. One test per configuration: its two engines are built
    once."""
    jm, tm = _models(preset)
    jm.MAX_ATOM = tm.MAX_ATOM = 16
    params = perturbed_params(jm, seed=33)
    jeng = JaxEngine(jm, params=jax.tree_util.tree_map(jnp.asarray, params),
                     decode_kernel="pallas" if kv == "int8" else "xla",
                     kv_dtype=kv, **ENGINE_KW)
    teng = InferenceEngineV2(tm, params_from_numpy(params, device="cpu"),
                             device="cpu", kv_dtype=kv, **ENGINE_KW)
    rng = np.random.default_rng(34)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (5, 11, 16)]
    long_prompt = rng.integers(1, 512, 40).astype(np.int32)
    out = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        rec, starts = _script(eng, prompts, long_prompt)
        out[name] = (rec, starts, eng.decode_batch([0, 1, 2, 3], starts,
                                                   steps=STEPS))
    for step, (want, got) in enumerate(zip(out["jax"][0], out["torch"][0])):
        assert sorted(got) == sorted(want)
        for uid in want:
            w = np.asarray(want[uid], np.float32)
            assert got[uid].shape == (512,) and got[uid].dtype == np.float32
            np.testing.assert_allclose(got[uid], w, **_logit_tol(kv, w),
                                       err_msg=f"put {step} uid {uid}")
    assert out["torch"][1] == out["jax"][1]
    for uid in range(4):
        want = np.asarray(out["jax"][2][uid])
        got = np.asarray(out["torch"][2][uid])
        assert got.shape == (STEPS,) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"uid {uid}")
    if kv != "bf16":
        assert teng.cache["k"].dtype == torch.int8


@pytest.mark.parametrize("preset", PRESETS)
def test_dense_tile_engine_matches_jax(preset):
    """``packed=False``: every put's logits at 1e-4 and the same greedy
    token at every step."""
    jm, tm = _models(preset)
    params = perturbed_params(jm, seed=35)
    kw = dict(ENGINE_KW, packed=False)
    jeng = JaxEngine(jm, params=jax.tree_util.tree_map(jnp.asarray, params),
                     **kw)
    teng = InferenceEngineV2(tm, params_from_numpy(params, device="cpu"),
                             device="cpu", **kw)
    rng = np.random.default_rng(36)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (5, 11, 30)]
    want, got = [jeng.put([0, 1, 2], prompts)], [teng.put([0, 1, 2], prompts)]
    for _ in range(4):
        toks = [np.array([int(np.argmax(want[-1][u]))], np.int32)
                for u in range(3)]
        want.append(jeng.put([0, 1, 2], toks))
        got.append(teng.put([0, 1, 2], toks))
    for step, (w, g) in enumerate(zip(want, got)):
        for uid in w:
            wu = np.asarray(w[uid], np.float32)
            np.testing.assert_allclose(g[uid], wu, **LOGIT_TOL,
                                       err_msg=f"put {step} uid {uid}")
            assert int(np.argmax(g[uid])) == int(np.argmax(wu))


TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-3,
                                              "weight_decay": 0.1}},
    "gradient_clipping": 1.0, "steps_per_print": 100, "seed": 3}


@pytest.mark.parametrize("preset", PRESETS)
def test_train_step_matches_jax(preset):
    """One ``train_batch`` of each training engine from the same weights:
    loss and grad norm to 1e-5 relative; then the gradient of every leaf of
    the loss, max abs error <= 1e-5 x (1 + that leaf's max |gradient|)."""
    jm, tm = _models(preset)
    jeng, *_ = ds.initialize(model=jm, config=dict(TRAIN_CONFIG),
                             mesh=ds.build_mesh(devices=jax.devices()[:1]))
    params0 = jax.device_get(jeng.params)
    teng = tds.initialize(tm, dict(TRAIN_CONFIG),
                          model_parameters=params_from_numpy(params0,
                                                             device="cpu"),
                          device="cpu")[0]
    ids = np.random.default_rng(37).integers(0, 512, (2, 32)).astype(np.int32)
    batch = {"input_ids": ids}
    losses = [eng.train_batch(iter([batch])) for eng in (jeng, teng)]
    norms = [eng.get_global_grad_norm() for eng in (jeng, teng)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    np.testing.assert_allclose(norms[1], norms[0], rtol=1e-5)

    jp = jax.tree_util.tree_map(jnp.asarray, params0)
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp,
                                            {"input_ids": jnp.asarray(ids)})
    tp = params_from_numpy(params0, device="cpu")
    leaves = dict(_flat(tp))
    for t in leaves.values():
        t.requires_grad_()
    tl = tm.loss_fn(tp, {"input_ids": torch.from_numpy(ids)})
    tg = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = dict(_flat(jax.device_get(jg)))
    assert sorted(want) == sorted(leaves)
    for name, g in zip(leaves, tg):
        w = np.asarray(want[name], np.float32)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-5 * (1 + float(np.abs(w).max())), (name, err)


# ---------------------------------------------------------------------------
# the plain versions of the kernels against the JAX functions
# ---------------------------------------------------------------------------

L, BS, H, K = 2, 8, 4, 2
N_SLOTS, NB_MAX = 3, 4
NUM_BLOCKS = N_SLOTS * NB_MAX
LAYER = 1
HEAD_DIMS = (96, 256)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


def _pool_case(d, kv_bits, seed):
    """Stacked pools of every slot's rows (fp32, or int8 / int4 through the
    port's append, rows of varied amplitude), a permuted block table and
    the kwargs of a quantized pool."""
    rng = np.random.default_rng(seed)
    bt = rng.permutation(NUM_BLOCKS).reshape(N_SLOTS, NB_MAX).astype(np.int32)
    slot = np.repeat(np.arange(N_SLOTS), NB_MAX * BS).astype(np.int32)
    pos = np.tile(np.arange(NB_MAX * BS), N_SLOTS).astype(np.int32)
    rows = [rng.standard_normal((L, len(slot), K, d)).astype(np.float32)
            * rng.uniform(0.2, 3.0, (L, len(slot), 1, 1)).astype(np.float32)
            for _ in "kv"]
    if kv_bits is None:
        pools = [torch.zeros(L, NUM_BLOCKS + 1, BS, K * d) for _ in "kv"]
        for pool, r in zip(pools, rows):
            tpa.packed_kv_append(pool, _t(r), _t(bt), _t(slot), _t(pos))
        return pools[0], pools[1], bt, {}, {}
    lanes = K * d // (2 if kv_bits == 4 else 1)
    pools = [torch.zeros(L, NUM_BLOCKS + 1, BS, lanes, dtype=torch.int8)
             for _ in "kv"]
    scale = torch.zeros(L, NUM_BLOCKS + 1, 1, 2 * BS)
    for which, (pool, r) in enumerate(zip(pools, rows)):
        tpa.packed_kv_append_quant(pool, scale, _t(r), _t(bt), _t(slot),
                                   _t(pos), which, bits=kv_bits)
    return (pools[0], pools[1], bt, dict(kv_scale=scale, kv_bits=kv_bits),
            dict(kv_scale=_j(scale.numpy()), kv_bits=kv_bits))


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_decode_partials_match_pallas(d, kv_bits):
    """Kernel A's plain version against the reference's decode kernel in
    interpret mode, rows that see something (the TPU leaves the rest
    don't-care), a window anchored past the frontier on two rows; over an
    int8 pool the kernel rounds ``p * v_scale`` to bf16 before its P V
    product (the port does not), so there ``acc`` is held against the
    reference's XLA twin, the same math in fp32, at the fp32 tolerance."""
    kp, vp, bt, tkw, jkw = _pool_case(d, kv_bits, seed=40 + d)
    rng = np.random.default_rng(41)
    q = rng.standard_normal((5, H, d)).astype(np.float32)
    slot = np.array([0, 1, 2, 0, 1], np.int32)
    pos0 = np.array([0, 5, 8, 17, 31], np.int32)
    row = pos0 + np.array([0, 0, 3, 0, 1], np.int32)
    window = 12
    got = tpa.decode_pool_partials(_t(q), kp, vp, LAYER, _t(bt), _t(slot),
                                   _t(pos0), window=window, row_pos=_t(row),
                                   **tkw)
    want = jpa.decode_pool_partials(
        _j(q), _j(kp.numpy()), _j(vp.numpy()), jnp.int32(LAYER), _j(bt),
        _j(slot), _j(pos0), window=window, row_pos=_j(row), interpret=True,
        **jkw)
    live = (pos0 > 0) & (pos0 - 1 > row - window)
    acc, m, l = (np.asarray(x) for x in want)
    np.testing.assert_allclose(got[1].numpy()[live], m[live], **TOL)
    np.testing.assert_allclose(got[2].numpy()[live], l[live], **TOL)
    if kv_bits == 8:
        acc = np.asarray(jpa.xla_decode_partials(
            _j(q), _j(kp.numpy()), _j(vp.numpy()), jnp.int32(LAYER), _j(bt),
            _j(slot), _j(pos0), window=window, row_pos=_j(row), **jkw)[0])
    np.testing.assert_allclose(got[0].numpy()[live], acc[live], **TOL)


RAGGED = {"tq8-past-window": (8, [0, 8, 3, 17], [8, 5, 2, 8], 6),
          "tq16-past": (16, [0, 9], [16, 11], None)}


@pytest.mark.parametrize("case", sorted(RAGGED))
@pytest.mark.parametrize("kv_bits", [None, 8, 4])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_ragged_attention_matches_pallas(d, kv_bits, case):
    """Kernels B (each pool) and C: chunk atoms over their pooled past and
    their own tokens, against the reference's Pallas path."""
    tq, pos0, alen, window = RAGGED[case]
    kp, vp, bt, tkw, jkw = _pool_case(d, kv_bits, seed=50 + d)
    A = len(pos0)
    rng = np.random.default_rng(51)
    q, ks, vs = (rng.standard_normal((A * tq, h, d)).astype(np.float32)
                 for h in (H, K, K))
    slot = np.array([i % N_SLOTS for i in range(A)], np.int32)
    pos0, alen = np.array(pos0, np.int32), np.array(alen, np.int32)
    want = jpa.ragged_paged_attention(
        _j(q), _j(ks), _j(vs), _j(kp.numpy()), _j(vp.numpy()), _j(bt),
        _j(slot), _j(pos0), _j(alen), tq, window=window, interpret=True,
        layer=jnp.int32(LAYER), **jkw)
    got = tpa.ragged_paged_attention(
        _t(q), _t(ks), _t(vs), kp, vp, _t(bt), _t(slot), _t(pos0), _t(alen),
        tq, window=window, layer=LAYER, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


FLASH = [(1, 40, 40, 4, 2, True, None, 0), (2, 24, 24, 2, 2, True, 7, 0),
         (1, 16, 40, 4, 2, True, None, 24), (1, 24, 24, 4, 2, True, 8, -6)]


@pytest.mark.parametrize("case", FLASH, ids=lambda c: "T{}S{}w{}r{}".format(
    c[1], c[2], c[6], c[7]))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_forward_and_backward_match_pallas(d, case):
    """Kernel D's plain version (out, lse) and E/F's (dq, dk, dv, with an
    lse cotangent) against the reference's forward and backward Pallas
    kernels in interpret mode; rows that see no key (rel_offset < 0) get
    dO = 0 there, as ``test_torch_flash_backward.py`` gives them."""
    B, T, S, Hq, Kk, causal, window, rel = case
    rng = np.random.default_rng(60 + d + T + S)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, do = f(B, T, Hq, d), f(B, S, Kk, d), f(B, S, Kk, d), \
        f(B, T, Hq, d)
    dlse = 0.5 * f(B, Hq, T)
    blind = max(0, -rel)
    do[:, :blind] = 0.0
    dlse[:, :, :blind] = 0.0
    out, lse, dq, dk, dv = _jax_bwd(q, k, v, do, dlse, T, S, causal, window,
                                    rel)
    kw = dict(causal=causal, window=window, rel_offset=rel)
    o_t, lse_t = tfa.plain_flash_forward(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(o_t.numpy()[:, blind:], out[:, blind:], **TOL)
    np.testing.assert_allclose(lse_t.numpy()[..., blind:],
                               lse[..., blind:], **TOL)
    got = tfa.plain_flash_backward(_t(q), _t(k), _t(v), _t(out), _t(lse),
                                   _t(do), _t(dlse), **kw)
    np.testing.assert_allclose(got[0].numpy()[:, blind:], dq[:, blind:],
                               **TOL)
    np.testing.assert_allclose(got[1].numpy(), dk, **TOL)
    np.testing.assert_allclose(got[2].numpy(), dv, **TOL)


@pytest.mark.parametrize("t,window", [(1, None), (5, None), (5, 3)])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_tile_matches_pallas(d, t, window):
    """Kernel I's plain version: three slots at positions 0, 9 and 20 of a
    4-block table, their tiles' own K/V already in the pool."""
    rng = np.random.default_rng(70 + d + t)
    nb = NUM_BLOCKS
    bt = rng.permutation(nb)[:3 * NB_MAX].reshape(3, NB_MAX).astype(np.int32)
    pos = np.array([0, 9, 20], np.int32)
    q = rng.standard_normal((3, t, H, d)).astype(np.float32)
    kp = rng.standard_normal((nb + 1, BS, K, d)).astype(np.float32)
    vp = rng.standard_normal((nb + 1, BS, K, d)).astype(np.float32)
    want = jpa.paged_attention(_j(q), _j(kp), _j(vp), _j(bt), _j(pos),
                               window=window, interpret=True)
    got = tpa.paged_attention(_t(q), _t(kp.reshape(1, nb + 1, BS, K * d)),
                              _t(vp.reshape(1, nb + 1, BS, K * d)), _t(bt),
                              _t(pos), window=window, layer=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the source contract and the refusal of other head dims
# ---------------------------------------------------------------------------

# each launcher's instantiation per head dim
LAUNCHES = {"paged_attention.cu": ["launch_past<BITS, {d}>"],
            "flash_attention.cu": ["launch_self<{d}>"],
            "flash_forward.cu": ["launch_fwd<{d}>"],
            "flash_backward.cu": ["launch_bwd<{d}, DKV>"],
            "paged_decode.cu": ["launch_decode<4, true, {d}>",
                                "launch_decode<BITS, false, {d}>"],
            "paged_tile.cu": ["launch_tile_decode<{d}>",
                              "launch_tile_flash<{d}>"]}
SMEM = {"paged_attention.cu": ["dst_paged_past_smem_bytes",
                               "dst_paged_past_int8_smem_bytes",
                               "dst_paged_past_int4_smem_bytes"],
        "flash_attention.cu": ["dst_chunk_self_smem_bytes"],
        "flash_forward.cu": ["dst_flash_fwd_smem_bytes"],
        "flash_backward.cu": ["dst_flash_bwd_dq_smem_bytes",
                              "dst_flash_bwd_dkv_smem_bytes"],
        "paged_decode.cu": ["dst_paged_decode_smem_bytes",
                            "dst_paged_decode_int8_smem_bytes",
                            "dst_paged_decode_int4_smem_bytes"],
        "paged_tile.cu": ["dst_paged_tile_decode_smem_bytes",
                          "dst_paged_tile_smem_bytes"]}


@pytest.mark.parametrize("source", sorted(LAUNCHES))
def test_every_launcher_dispatches_the_card_head_dims(source):
    """Each launcher instantiates every head dim of ``CARD_HEAD_DIMS`` behind
    ``hd == d`` and no other; the shared-memory exports chip_smoke reads hold
    one entry a head dim, in that order."""
    code = (CSRC / source).read_text()
    dims = {int(x) for x in re.findall(r"\bhd == (\d+)\)", code)}
    assert dims == set(CARD_HEAD_DIMS)
    for d in CARD_HEAD_DIMS:
        for call in LAUNCHES[source]:
            assert call.format(d=d) in code, (source, call, d)
    for sym in SMEM.get(source, []):
        assert f"{sym}[{len(CARD_HEAD_DIMS)}]" in code, sym
    if source in SMEM:        # (paged_decode.cu, paged_attention.cu: one
                              # macro, three arrays)
        found = [int(x) for x in
                 re.findall(r"Tiles<(?:BITS, )?(\d+)>::\w*BYTES", code)]
        n = 2 if source in ("flash_backward.cu", "paged_tile.cu") else 1
        assert found == list(CARD_HEAD_DIMS) * n


def test_the_tile_engine_kernels_dispatch_through_one_function():
    """The wmma tile engine (``flash_tile.cuh``, its ``launch_any_hd``
    dispatch and ``launch_tiles``) is gone: B (paged_attention.cu) and C
    (flash_attention.cu), its last kernels, dispatch their head dims through
    launchers of their own on kernel D's tile body, as I (paged_tile.cu)
    does."""
    assert not (CSRC / "flash_tile.cuh").exists()
    for source in ("paged_attention.cu", "flash_attention.cu",
                   "paged_tile.cu"):
        code = (CSRC / source).read_text()
        assert '#include "flash_fwd_tile.cuh"' in code
        assert "launch_any_hd(" not in code and "launch_tiles<" not in code
        assert "flash_tile.cuh" not in code and "wmma" not in code


def test_chip_smoke_reads_every_card_head_dim():
    import chip_smoke

    assert chip_smoke.CARD_HEAD_DIMS == CARD_HEAD_DIMS
    rows = [r for r in chip_smoke.PTXAS_REPORTS if r[4] == "d"]
    assert len(rows) == 13 and all(r[3] == CARD_HEAD_DIMS for r in rows)


def _refusals(d):
    """Every attention kernel's launcher-argument function (the CUDA path of
    its wrapper) on operands of head dim ``d``."""
    q3 = torch.zeros(2, 4, d, dtype=torch.bfloat16)
    pool = torch.zeros(2, 9, 8, 2 * d, dtype=torch.bfloat16)
    bt = torch.zeros(2, 4, dtype=torch.int32)
    meta = (torch.tensor([0, 1]), torch.tensor([5, 9]))
    q4 = torch.zeros(1, 8, 4, d, dtype=torch.bfloat16)
    kv4 = torch.zeros(1, 8, 2, d, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 8)
    return {
        "A": lambda: tpa.decode_kernel_args(q3, pool, pool, 1, bt, *meta),
        "B": lambda: tpa.past_kernel_args(q3, pool, pool, 1, bt, *meta, 1),
        "C": lambda: tpa.self_kernel_args(q3, q3[:, :2], q3[:, :2],
                                          torch.tensor([1, 1]), 1),
        "D": lambda: tfa.flash_kernel_args(q4, kv4, kv4),
        "E": lambda: tfa.flash_bwd_kernel_args(q4, kv4, kv4, q4, lse, lse,
                                               part="dq"),
        "F": lambda: tfa.flash_bwd_kernel_args(q4, kv4, kv4, q4, lse, lse,
                                               part="dkv"),
        "I": lambda: tpa.paged_tile_kernel_args(q4[:, :1].expand(2, 1, 4, d),
                                                pool, pool, bt,
                                                torch.tensor([0, 3])),
    }


@pytest.mark.parametrize("d", [16, 80, 112, 160])
@pytest.mark.parametrize("kernel", list("ABCDEFI"))
def test_wrappers_refuse_other_head_dims_before_a_launch(kernel, d):
    """A head dim outside ``CARD_HEAD_DIMS`` raises a ValueError naming the
    set from the function that prepares the launch (the wrapper's CUDA
    path), before any operand check, allocation or launch."""
    counts = {n: k.launches for n, k in KERNELS.items()}
    with pytest.raises(ValueError, match=re.escape(
            f"head_dim in {CARD_HEAD_DIMS}, got {d}")):
        _refusals(d)[kernel]()
    assert {n: k.launches for n, k in KERNELS.items()} == counts


def test_plain_versions_take_any_head_dim():
    """The CPU path has no head-dim limit: the plain versions run d = 80."""
    rng = np.random.default_rng(80)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, h, 80))
                                .astype(np.float32)) for h in (4, 2, 2))
    out, lse = tfa.flash_forward(q, k, v, causal=True)
    want, _ = tfa.plain_flash_forward(q, k, v, causal=True)
    assert out.shape == (1, 8, 4, 80) and torch.equal(out, want)
    assert math.isfinite(float(lse.sum()))


def test_parent_turns_refuses_to_run_without_a_card(monkeypatch):
    """The tool that reads the d = 64 / 128 rows of a parent tree and this
    one in turns measures the card only: without one it stops first."""
    import sys

    from deepspeed_tpu_torch.tools import parent_turns

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["parent_turns", "build/parent"])
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        parent_turns.main()
