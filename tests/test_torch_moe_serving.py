"""MoE serving on one device, the port against the JAX package on the CPU
(fp32, one torch thread, the reference's functions jitted):

* each of the model's five cached entry points (``forward_with_cache``,
  ``forward_with_paged_cache``, ``forward_prefill``,
  ``forward_with_packed_cache``, ``forward_decode_tail``) under both
  dispatch algebras, with padding and idle lanes in the batch: logits
  within 1e-5 relative L2 of the reference's (the grouped dispatch held
  against the reference's ``kernel="padded"`` twin, as the MoE training
  tests are: its ragged-vs-padded identity does not hold on every CPU);
* the packed ``InferenceEngineV2`` over a whole-prompt ``put``, a mixed
  ``put`` (decode tokens beside a prompt chunked at ``MAX_ATOM``) and
  ``decode_batch`` of 8 steps: logits within 1e-5, greedy tokens equal,
  and the expert-load trackers of ``enable_metrics`` equal the
  reference's; the ``packed=False`` and ``paged=False`` engines and v1
  ``generate`` likewise;
* the routed pairs a call reports are its real tokens x top-k x layers:
  padding and idle lanes reach no tracker;
* the int8 expert stacks of ``quantize_serving_params`` (int8 whatever the
  engine's bits, never gate|up-fused) bit-identical to the reference's
  ``w_*_q`` / ``w_*_s`` leaves, and their dequantization too;
* ``act_quant_bits`` 8 and 4: the blockwise quantizer bit for bit, and
  ``mlp_block``'s output and straight-through gradients within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.compression.compress import ste_quantize as jax_ste
from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.quant import (
    quantize_serving_params as jax_quantize)
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.observability import MetricsRegistry as JaxRegistry
from deepspeed_tpu.ops import quantization as jq
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.compression import ste_quantize
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference.quant import quantize_serving_params
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from deepspeed_tpu_torch.observability import MetricsRegistry
from deepspeed_tpu_torch.ops import quantization as tq
from tests._torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5           # logits and outputs, relative L2
DISPATCHES = ("capacity", "grouped")
ENTRY_POINTS = ("forward_with_cache", "forward_with_paged_cache",
                "forward_prefill", "forward_with_packed_cache",
                "forward_decode_tail")
ENGINE_KW = dict(max_sequences=8, max_seq_len=64, block_size=8)
MODEL_KW = dict(dtype="float32", num_kv_heads=2, max_seq_len=64)
DECODE_STEPS = 8


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _models(dispatch, **kw):
    """(the reference's model -- its grouped path through the padded twin
    --, the port's, at the preset's ragged kernel)."""
    jm = JaxLM(jax_preset("tiny-moe", moe_dispatch=dispatch,
                          moe_kernel="padded", **MODEL_KW, **kw))
    tm = TransformerLM(get_preset("tiny-moe", moe_dispatch=dispatch,
                                  **MODEL_KW, **kw))
    jm.MAX_ATOM = tm.MAX_ATOM = 16     # the chunking loop at 64 positions
    return jm, tm


@pytest.fixture(scope="module")
def params():
    """The reference's init plus seeded noise on every leaf (numpy)."""
    jm, _ = _models("capacity")
    rng = np.random.default_rng(22)
    tree = jax.device_get(jax.jit(jm.init)(jax.random.key(22)))
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape))
        .astype(np.float32), tree)


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def _pool(tm, rng, num_blocks=32):
    """A paged pool of random KV (both packages' layout)."""
    shape = tuple(tm.init_paged_kv_cache(num_blocks, 8, device="cpu")
                  ["k"].shape)
    return {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}


def _calls(tm, rng):
    """Per entry point: (its positional numpy arguments after ``params``,
    the reference-only keywords). Every batch holds padding or idle lanes:
    rows right-padded, a wholly idle row or slot."""
    V, L = tm.cfg.vocab_size, tm.cfg.num_layers
    K, hd = tm.cfg.num_kv_heads, tm.cfg.head_dim

    def ids(*shape):
        return rng.integers(1, V, shape).astype(np.int32)

    # four slots of 8 blocks of 8 in a 32-block pool
    bt = np.arange(32, dtype=np.int32).reshape(4, 8)
    # a dense tile of three slots: rows of 6, 4 and 0 (idle) real lanes
    valid_tile = np.arange(6)[None, :] < np.array([6, 4, 0])[:, None]
    dense = {n: np.zeros((L, 3, 32, K, hd), np.float32) for n in ("k", "v")}
    dense["pos"] = np.array([0, 5, 2], np.int32)
    # packed: 3 real decode rows of 8 (slots 0-2), then one 16-wide tile
    # holding a 10-token chunk of slot 3 from position 4
    dr, tq = 8, 16
    tok_slot = np.zeros(dr + tq, np.int32)
    tok_pos = np.zeros(dr + tq, np.int32)
    valid = np.zeros(dr + tq, bool)
    tok_slot[:3], tok_pos[:3], valid[:3] = [0, 1, 2], [9, 3, 17], True
    tok_slot[dr:], tok_pos[dr:dr + 10] = 3, 4 + np.arange(10)
    valid[dr:dr + 10] = True
    gather = np.array([0, 1, 2, dr + 9, 0, 0, 0, 0], np.int32)
    # a decode batch padded to 4 rows, step 2 of a 3-step tail
    tail = {n: rng.standard_normal((L, 4, 3, K, hd)).astype(np.float32)
            for n in ("k", "v")}
    return {
        "forward_with_cache": ((ids(3, 6), dense, valid_tile), {}),
        "forward_with_paged_cache": (
            (ids(3, 6), _pool(tm, rng), bt[:3],
             np.array([0, 9, 3], np.int32), valid_tile), {}),
        "forward_prefill": ((ids(3, 12), np.array([12, 7, 0], np.int32)),
                            {}),
        "forward_with_packed_cache": (
            (ids(dr + tq), _pool(tm, rng), bt, tok_slot, tok_pos, valid,
             gather, dr, tq, False), {"decode_kernel": "xla"}),
        "forward_decode_tail": (
            (ids(4), _pool(tm, rng), tail, 2, bt,
             np.arange(4, dtype=np.int32), np.array([9, 17, 4, 0], np.int32),
             np.array([True, True, True, False])),
            {"decode_kernel": "xla"}),
    }


def _to_jax(a):
    if isinstance(a, dict):
        return {k: _to_jax(v) for k, v in a.items()}
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _to_torch(a):
    if isinstance(a, dict):
        return {k: _to_torch(v) for k, v in a.items()}
    return torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a


# ---------------------------------------------------------------------------
# the five cached entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_matches_the_reference(params, entry, dispatch):
    jm, tm = _models(dispatch)
    jp, tp = _both(params)
    args, ref_kw = _calls(tm, np.random.default_rng(5))[entry]
    statics = {"forward_with_packed_cache": (8, 9, 10),
               "forward_decode_tail": (4,)}.get(entry, ())
    fn = jax.jit(functools.partial(getattr(jm, entry), **ref_kw),
                 static_argnums=statics)
    want = fn(jp, *(_to_jax(a) for a in args))[0]
    got = getattr(tm, entry)(tp, *(_to_torch(a) for a in args))[0]
    assert got.shape == tuple(want.shape)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= REL, (entry, dispatch, _rel(got, want))


def test_padding_lanes_leave_routing_alone(params):
    """Grouped (dropless): each prompt prefilled beside right-padded rows
    gives its logits of a prefill alone. Capacity: the mask is what keeps
    the padding out -- routed unmasked, it takes expert slots and the
    logits move."""
    _, tm = _models("grouped")
    tp = params_from_numpy(params, device="cpu")
    ids = np.random.default_rng(6).integers(1, 256, (4, 16)).astype(np.int32)
    lengths = torch.tensor([5, 16, 2, 9])
    batched = tm.forward_prefill(tp, torch.from_numpy(ids), lengths)[0]
    for r in range(4):
        n = int(lengths[r])
        alone = tm.forward_prefill(tp, torch.from_numpy(ids[r:r + 1, :n]),
                                   lengths[r:r + 1])[0]
        assert _rel(batched[r], alone[0]) <= REL, r
    _, tc = _models("capacity", capacity_factor=0.5)
    masked = tc.forward_prefill(tp, torch.from_numpy(ids), lengths)[0]
    tc.moe_fn = functools.partial(_unmasked, tsm.moe_mlp_block)
    unmasked = tc.forward_prefill(tp, torch.from_numpy(ids), lengths)[0]
    assert _rel(unmasked, masked) > 1e-3


def _unmasked(fn, h, w, cfg, valid=None):
    return fn(h, w, cfg)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _script(eng, rng):
    """Four prompts in one ``put``, then a mixed ``put`` (four decode
    tokens beside a 40-token prompt, chunked at ``MAX_ATOM``), then
    ``decode_batch`` of ``DECODE_STEPS``. Returns (logits of each put,
    the greedy tokens per uid)."""
    prompts = [rng.integers(1, 256, n).astype(np.int32)
               for n in (3, 8, 11, 21)]
    long_prompt = rng.integers(1, 256, 40).astype(np.int32)
    first = eng.put([0, 1, 2, 3], prompts)
    toks = [np.array([int(np.argmax(first[u]))], np.int32) for u in range(4)]
    mixed = eng.put([0, 1, 2, 3, 4], toks + [long_prompt])
    starts = [int(np.argmax(mixed[u])) for u in range(5)]
    dec = eng.decode_batch(list(range(5)), starts, steps=DECODE_STEPS)
    return [first, mixed], {u: [s] + list(map(int, dec[u]))
                            for u, s in enumerate(starts)}


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_packed_engine_matches_the_reference(params, dispatch):
    jm, tm = _models(dispatch)
    jp, tp = _both(params)
    jeng = JaxEngine(jm, params=jp, decode_kernel="xla", **ENGINE_KW)
    teng = InferenceEngineV2(tm, tp, device="cpu", **ENGINE_KW)
    try:
        jeng.enable_metrics(registry=JaxRegistry())
        teng.enable_metrics(registry=MetricsRegistry())
        want, want_toks = _script(jeng, np.random.default_rng(7))
        got, got_toks = _script(teng, np.random.default_rng(7))
        want_pairs = jeng._moe_tracker.snapshot()
        got_pairs = teng._moe_tracker.snapshot()
    finally:
        jsm.set_expert_tracker(None)
        tsm.set_expert_tracker(None)
    for w, g in zip(want, got):
        for uid in w:
            assert _rel(g[uid], w[uid]) <= REL, uid
    assert got_toks == want_toks
    np.testing.assert_array_equal(got_pairs, np.asarray(want_pairs))
    assert teng.moe_kernel == (None if dispatch == "capacity" else "ragged")
    assert teng.rebalance_moe() is None
    teng.flush(list(range(5)))
    assert teng.state.allocator.leaked_blocks() == []


def _dense_script(eng, rng):
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (5, 11, 30)]
    outs = [eng.put([0, 1, 2], prompts)]
    for _ in range(4):
        toks = [np.array([int(np.argmax(outs[-1][u]))], np.int32)
                for u in range(3)]
        outs.append(eng.put([0, 1, 2], toks))
    return outs


@pytest.mark.parametrize("engine", ["packed=False", "paged=False"])
def test_dense_tile_engine_matches_the_reference(params, engine):
    kw = {"packed=False": dict(packed=False),
          "paged=False": dict(paged=False)}[engine]
    jm, tm = _models("grouped")
    jp, tp = _both(params)
    want = _dense_script(JaxEngine(jm, params=jp, **ENGINE_KW, **kw),
                         np.random.default_rng(8))
    got = _dense_script(InferenceEngineV2(tm, tp, device="cpu", **ENGINE_KW,
                                          **kw), np.random.default_rng(8))
    for w, g in zip(want, got):
        for uid in w:
            assert _rel(g[uid], w[uid]) <= REL, uid
            assert int(np.argmax(g[uid])) == int(np.argmax(w[uid]))


def test_v1_generate_matches_the_reference(params):
    jm, tm = _models("grouped")
    jp, tp = _both(params)
    ids = np.random.default_rng(9).integers(1, 256, (2, 9)).astype(np.int32)
    jeng = jds.init_inference(jm, params=jp)
    teng = tds.init_inference(tm, params=tp, device="cpu")
    got = teng.generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(got, np.asarray(jeng.generate(
        ids, max_new_tokens=8)))
    assert _rel(teng.forward(ids), jeng.forward(ids)) <= REL


class _Reports:
    def __init__(self):
        self.seen = []

    def observe(self, counts):
        self.seen.append(int(np.asarray(counts).sum()))


def test_idle_and_padding_lanes_reach_no_tracker(params):
    """Each call's routed pairs are its real tokens x top-k, a layer: a
    padded prefill batch, a mixed packed step (idle decode rows, a padded
    tile), a decode batch padded to 8 slots and the dense-tile engines'
    idle slots."""
    _, tm = _models("grouped")
    tp = params_from_numpy(params, device="cpu")
    k, L = tm.cfg.top_k, tm.cfg.num_layers
    rng = np.random.default_rng(10)
    rep = _Reports()
    tsm.set_expert_tracker(rep)
    try:
        for kw in ({}, dict(packed=False), dict(paged=False)):
            eng = InferenceEngineV2(tm, tp, device="cpu", **ENGINE_KW, **kw)
            prompts = [rng.integers(1, 256, n).astype(np.int32)
                       for n in (3, 9, 14)]
            calls = [([0, 1, 2], prompts),
                     ([0, 2, 3], [np.array([5], np.int32),
                                  np.array([7], np.int32), prompts[1]])]
            for uids, chunks in calls:
                rep.seen.clear()
                eng.put(uids, chunks)
                real = sum(len(c) for c in chunks)
                assert rep.seen and all(n > 0 for n in rep.seen)
                assert sum(rep.seen) == real * k * L, (kw, rep.seen)
            if not kw:
                rep.seen.clear()
                eng.decode_batch([0, 1], [4, 6], steps=3)
                assert len(rep.seen) == 3 * L
                assert sum(rep.seen) == 2 * 3 * k * L
    finally:
        tsm.set_expert_tracker(None)


# ---------------------------------------------------------------------------
# int8 expert stacks
# ---------------------------------------------------------------------------

QUANT_KW = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                num_kv_heads=2, max_seq_len=64, num_experts=4, top_k=2,
                moe_dispatch="grouped")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_expert_stacks_equal_the_reference(bits, dtype):
    """The quantized tree's expert leaves bit for bit, int8 at either
    engine width, never fused; their dequantization bit for bit too."""
    from deepspeed_tpu.models import TransformerConfig as JaxConfig
    from deepspeed_tpu_torch.models import TransformerConfig

    jcfg = JaxConfig(dtype=dtype, **QUANT_KW)
    tcfg = TransformerConfig(dtype=dtype, **QUANT_KW)
    tree = jax.device_get(JaxLM(jcfg).init(jax.random.key(3)))
    cast = {"float32": np.float32, "bfloat16": jnp.bfloat16}[dtype]
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(cast), tree)
    mesh = jds.build_mesh(devices=jax.devices()[:1]).mesh
    want = jax.device_get(jax_quantize(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, bits, mesh))
    got = quantize_serving_params(params_from_numpy(tree, device="cpu"),
                                  tcfg, bits)
    jmlp, tmlp = want["layers"]["mlp"], got["layers"]["mlp"]
    assert sorted(tmlp) == sorted(jmlp) == [
        "router", "w_down_q", "w_down_s", "w_gate_q", "w_gate_s", "w_up_q",
        "w_up_s"]
    for name in sorted(jmlp):
        w, g = np.asarray(jmlp[name]), tmlp[name]
        if name.endswith("_q"):
            assert g.dtype == torch.int8 and g.shape == (2, 4) + w.shape[2:]
        elif name.endswith("_s"):
            assert g.dtype == ttf.torch_dtype(dtype)
        assert np.array_equal(_host(g), w.view(_host(g).dtype)), name
    for name in ("w_gate", "w_up", "w_down"):
        jw = jsm._expert_weight({k: v[1] for k, v in jmlp.items()}, name,
                                jnp.dtype(dtype))
        tw = tsm._expert_weight({k: v[1] for k, v in tmlp.items()}, name,
                                ttf.torch_dtype(dtype))
        assert np.array_equal(_host(tw), np.asarray(jw).view(
            _host(tw).dtype)), name
    assert isinstance(got["layers"]["attn"]["wqkv"], ttf.QuantizedWeight)
    assert got["layers"]["attn"]["wqkv"].bits == bits


def _host(t):
    """A CPU tensor as numpy (bf16 as its int16 bit pattern)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def test_int8_expert_engine_serves():
    """An int4 engine over an MoE model: int8 expert pairs, within the
    reference's loose bound (a random router flips top-2 under int8 noise)
    of the bf16 engine, greedy decode runs."""
    from deepspeed_tpu_torch.models import TransformerConfig

    tm = TransformerLM(TransformerConfig(dtype="float32", **QUANT_KW))
    tree = tm.init(seed=0, device="cpu")
    prompt = np.random.default_rng(4).integers(0, 512, 40)
    ref = InferenceEngineV2(tm, tree, device="cpu", **ENGINE_KW).put(
        [1], [prompt])[1]
    eng = InferenceEngineV2(tm, tree, device="cpu", weight_dtype="int4",
                            kv_dtype="int8", **ENGINE_KW)
    mlp = eng.params["layers"]["mlp"]
    assert "w_gateup" not in mlp and mlp["w_gate_q"].dtype == torch.int8
    first = eng.put([1], [prompt])[1]
    assert np.abs(first - ref).max() / np.abs(ref).max() < 0.6
    toks = eng.decode_batch([1], [int(np.argmax(first))], steps=4)[1]
    assert toks.shape == (4,)


# ---------------------------------------------------------------------------
# act_quant_bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_blockwise_quantizer_matches_the_reference(bits):
    """[2, 3, 640]: 3840 values, so the 2048 group halves to 256."""
    x = np.random.default_rng(bits).standard_normal((2, 3, 640)).astype(
        np.float32)
    jqv, js = jax.jit(functools.partial(jq.quantize_blockwise, bits=bits))(
        jnp.asarray(x))
    tqv, ts = tq.quantize_blockwise(torch.from_numpy(x), bits=bits)
    assert tqv.shape == tuple(jqv.shape) and ts.shape == (15,)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = jax.jit(functools.partial(
            jq.dequantize_blockwise, bits=bits, shape=x.shape, dtype=jdt))(
            jqv, js)
        got = tq.dequantize_blockwise(tqv, ts, bits=bits, shape=x.shape,
                                      dtype=dt)
        assert np.array_equal(_host(got), np.asarray(want).view(
            _host(got).dtype))


@pytest.mark.parametrize("bits", [8, 4])
def test_act_quant_mlp_block_matches_the_reference(params, bits):
    """``mlp_block`` with ``act_quant_bits``: output and the straight-
    through gradients of x and the weights within 1e-5."""
    jcfg = jax_preset("tiny", dtype="float32", act_quant_bits=bits)
    tcfg = get_preset("tiny", dtype="float32", act_quant_bits=bits)
    rng = np.random.default_rng(11)
    w = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("w_gate", (64, 256)), ("w_up", (64, 256)),
                      ("w_down", (256, 64)))}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    dy = rng.standard_normal((2, 5, 64)).astype(np.float32)

    def jloss(x, w):
        return jnp.sum(jtf.mlp_block(x, w, jcfg) * dy)

    jy = jax.jit(lambda x, w: jtf.mlp_block(x, w, jcfg))(jnp.asarray(x), w)
    jgx, jgw = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), w)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = {n: torch.from_numpy(v).requires_grad_(True) for n, v in w.items()}
    ty = ttf.mlp_block(tx, tw, tcfg)
    grads = torch.autograd.grad(ty, [tx, *tw.values()],
                                grad_outputs=torch.from_numpy(dy))
    assert _rel(ty.detach(), jy) <= REL
    assert _rel(grads[0], jgx) <= REL
    for g, n in zip(grads[1:], tw):
        assert _rel(g, jgw[n]) <= REL, n
    # the quantizer moved the output: the feature is on
    plain = ttf.mlp_block(tx, tw, get_preset("tiny", dtype="float32"))
    assert _rel(ty.detach(), plain.detach()) > 1e-4
    # straight through: the gradient of x is the plain block's own
    gx = torch.autograd.grad(ste_quantize(tx, bits=bits).sum(), tx)[0]
    assert torch.equal(gx, torch.ones_like(tx))
    jgx_ste = jax.grad(lambda v: jnp.sum(jax_ste(v, bits=bits)))(
        jnp.asarray(x))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx_ste))
