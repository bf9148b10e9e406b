"""MoE on one device, the port against the JAX package on the CPU (fp32,
one torch thread): the router (``_route``), ``topk_gating``,
``moe_mlp_block`` and ``grouped_moe_mlp_block`` under both of the port's
grouped products, held against the reference's capacity path and its
``kernel="padded"`` grouped path (the same top-k indices first, then
outputs within 1e-5 relative and aux within 1e-6), with idle lanes masked
by ``valid``, a capacity that drops tokens and the dropless grouped path;
the model's loss and per-leaf gradients under both dispatch algebras
(also under remat, random-LTD and progressive layer drop on the
reference's draws); 4 engine steps against the reference's engine (losses
1e-5 relative, params within 2e-6 + 1e-4 relative); the balancer's units;
the ``moe`` config section; int8 expert stacks and the cached serving
entry points on an MoE model (their values against the reference in
``tests/test_torch_moe_serving.py``). Widths are ``tiny-moe``'s (D 64, E 4,
2 layers)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.config.config import MoEConfig as JaxMoEConfig
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu.moe import balancer as jbal
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu_torch import InferenceEngineV2
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.config import MoEConfig, from_config
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from deepspeed_tpu_torch.models.spec import tree_leaves
from deepspeed_tpu_torch.moe import balancer as tbal
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_data_efficiency import _key0

OUT_REL = 1e-5       # block outputs, relative L2
AUX_TOL = 1e-6       # aux loss, absolute
GRAD_REL = 1e-5      # model grads, per leaf relative L2
D, F, E = 16, 32, 4  # the reference TestDroplessKernels' widths
SHAPES = [(2, 16), (1, 13), (3, 7)]


class Cfg:
    def __init__(self, top_k=2, capacity_factor=1.25, min_capacity=4,
                 moe_kernel="ragged"):
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.min_capacity, self.moe_kernel = min_capacity, moe_kernel


def _weights(seed, d=D, f=F, e=E):
    rng = np.random.default_rng(seed)
    return {"router": 0.3 * rng.standard_normal((d, e)),
            "w_gate": rng.standard_normal((e, d, f)) / 4,
            "w_up": rng.standard_normal((e, d, f)) / 4,
            "w_down": rng.standard_normal((e, f, d)) / 6}


def _pair(w):
    """(the reference's jnp weights, the port's tensors), fp32."""
    w = {k: np.asarray(v, np.float32) for k, v in w.items()}
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v) for k, v in w.items()})


def _h(shape, seed=9, d=D):
    return np.random.default_rng(seed).standard_normal(
        (*shape, d)).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _ref(fn, *args, **kw):
    """The reference's ``fn(*args, **kw)`` under ``jax.jit`` (keyword
    arguments static; a fraction of its eager op-by-op time)."""
    return jax.jit(functools.partial(fn, **kw))(*args)


def _flat(tree, prefix=""):
    """{dotted name: leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _same_routing(h, w_np, k):
    """The port's top-k indices equal the reference's on these logits."""
    logits = h.reshape(-1, h.shape[-1]) @ np.asarray(w_np["router"],
                                                     np.float32)
    _, _, _, ji = _ref(jsm._route, jnp.asarray(logits), k=k)
    _, _, _, ti = tsm._route(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# function level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_route_matches_the_reference(k):
    logits = np.random.default_rng(k).standard_normal((40, E)).astype(
        np.float32)
    valid = np.arange(40) % 5 != 3
    for v in (None, valid):
        jg, ja, jv, ji = _ref(jsm._route, jnp.asarray(logits), k=k,
                              valid=None if v is None else jnp.asarray(v))
        tg, ta, tv, ti = tsm._route(torch.from_numpy(logits), k,
                                    valid=None if v is None
                                    else torch.from_numpy(v))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert _rel(tg, jg) <= OUT_REL and _rel(tv, jv) <= OUT_REL
        assert abs(float(ta) - float(ja)) <= AUX_TOL


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_topk_gating_matches_the_reference(k, cf):
    logits = np.random.default_rng(3).standard_normal((48, E)).astype(
        np.float32)
    jd, jc, ja, js = _ref(jsm.topk_gating, jnp.asarray(logits), k=k,
                          capacity_factor=cf)
    td, tc, ta, ts = tsm.topk_gating(torch.from_numpy(logits), k=k,
                                     capacity_factor=cf)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert _rel(tc, jc) <= OUT_REL
    assert abs(float(ta) - float(ja)) <= AUX_TOL
    assert ts["capacity"] == int(js["capacity"])
    np.testing.assert_array_equal(ts["tokens_per_expert"].numpy(),
                                  np.asarray(js["tokens_per_expert"]))
    assert abs(float(ts["drop_fraction"]) - float(js["drop_fraction"])) \
        <= 1e-6


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_capacity_block_matches_the_reference(k, shape):
    jw, tw = _pair(_weights(k))
    h = _h(shape)
    _same_routing(h, jw, k)
    cfg = Cfg(top_k=k)
    jy, ja = _ref(jsm.moe_mlp_block, jnp.asarray(h), jw, cfg=cfg)
    ty, ta = tsm.moe_mlp_block(torch.from_numpy(h), tw, cfg)
    assert _rel(ty, jy) <= OUT_REL
    assert abs(float(ta) - float(ja)) <= AUX_TOL


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_block_matches_the_reference_padded(k, shape):
    """Both of the port's grouped products against the reference's
    ``kernel="padded"``; the port's two are bit-identical."""
    jw, tw = _pair(_weights(10 + k))
    h = _h(shape, seed=k)
    _same_routing(h, jw, k)
    jy, ja = _ref(jsm.grouped_moe_mlp_block, jnp.asarray(h), jw,
                  cfg=Cfg(top_k=k), kernel="padded")
    out = {}
    for kernel in tsm.MOE_KERNELS:
        ty, ta = tsm.grouped_moe_mlp_block(torch.from_numpy(h), tw,
                                           Cfg(top_k=k, moe_kernel=kernel))
        assert _rel(ty, jy) <= OUT_REL, kernel
        assert abs(float(ta) - float(ja)) <= AUX_TOL, kernel
        out[kernel] = ty
    assert _rel(out["ragged"], out["padded"]) <= OUT_REL


def test_capacity_block_ignores_idle_lanes():
    """Idle lanes (identical rows: the same router pick) placed before the
    real tokens would fill an expert's capacity and evict the real ones;
    ``valid`` keeps them out. With the mask the real rows equal a solo run
    of them, as the reference's ``test_capacity_moe_decode_ignores_idle_
    lanes`` asks, and the port equals the reference on every row."""
    jw, tw = _pair(_weights(21))
    real = _h((1, 4), seed=22)
    idle = np.repeat(_h((1, 1), seed=23), 12, axis=1)
    h = np.concatenate([idle, real], axis=1)                 # [1, 16, D]
    valid = np.arange(16) >= 12
    cfg = Cfg(top_k=2, capacity_factor=1.0, min_capacity=1)
    jy, ja = _ref(jsm.moe_mlp_block, jnp.asarray(h), jw, cfg=cfg,
                  valid=jnp.asarray(valid)[None])
    ty, ta = tsm.moe_mlp_block(torch.from_numpy(h), tw, cfg,
                               valid=torch.from_numpy(valid)[None])
    assert _rel(ty, jy) <= OUT_REL
    assert abs(float(ta) - float(ja)) <= AUX_TOL
    solo, solo_aux = tsm.moe_mlp_block(
        torch.from_numpy(real), tw,
        Cfg(top_k=2, capacity_factor=4.0, min_capacity=1))
    assert _rel(ty[:, 12:], solo) <= OUT_REL
    assert abs(float(ta) - float(solo_aux)) <= AUX_TOL
    unmasked, _ = tsm.moe_mlp_block(torch.from_numpy(h), tw, cfg)
    assert _rel(unmasked[:, 12:], solo) > 1e-2     # the eviction it stops
    for kernel in tsm.MOE_KERNELS:                 # the grouped path too
        gy, ga = tsm.grouped_moe_mlp_block(
            torch.from_numpy(h), tw, Cfg(moe_kernel=kernel),
            valid=torch.from_numpy(valid)[None])
        jgy, jga = _ref(jsm.grouped_moe_mlp_block, jnp.asarray(h), jw,
                        cfg=Cfg(), valid=jnp.asarray(valid)[None],
                        kernel="padded")
        assert _rel(gy, jgy) <= OUT_REL
        assert abs(float(ga) - float(jga)) <= AUX_TOL


def test_capacity_drops_tokens():
    """The reference's ``test_capacity_drops_tokens``: every token wants
    expert 0, so a capacity of max(ceil(S / E * 0.5), 4) keeps that many."""
    S = 64
    logits = np.stack([np.ones(S), -np.ones(S)], axis=1).astype(np.float32)
    td, _, _, ts = tsm.top1_gating(torch.from_numpy(logits),
                                   capacity_factor=0.5, min_capacity=4)
    jd, _, _, _ = _ref(jsm.top1_gating, jnp.asarray(logits),
                       capacity_factor=0.5, min_capacity=4)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert float(td.sum()) == max(int(np.ceil(S / 2 * 0.5)), 4)
    assert float(ts["drop_fraction"]) == pytest.approx(1 - 16 / 64)


def test_grouped_is_dropless():
    """The reference's ``test_grouped_is_dropless``: at a starvation
    capacity the capacity path drops tokens, the grouped path computes
    every one (the same as the capacity path with room for all)."""
    jw, tw = _pair(_weights(31))
    h = _h((1, 64), seed=32)
    logits = torch.from_numpy(h.reshape(-1, D)) @ tw["router"]
    _, _, _, stats = tsm.topk_gating(logits, k=2, capacity_factor=0.1,
                                     min_capacity=1)
    assert float(stats["drop_fraction"]) > 0.1
    tight = Cfg(top_k=2, capacity_factor=0.1, min_capacity=1)
    yc, _ = tsm.moe_mlp_block(torch.from_numpy(h), tw, tight)
    roomy, _ = tsm.moe_mlp_block(torch.from_numpy(h), tw,
                                 Cfg(top_k=2, capacity_factor=float(E)))
    for kernel in tsm.MOE_KERNELS:
        tight.moe_kernel = kernel
        yg, _ = tsm.grouped_moe_mlp_block(torch.from_numpy(h), tw, tight)
        assert torch.isfinite(yg).all()
        assert not torch.allclose(yg, yc)
        assert _rel(yg, roomy) <= OUT_REL
    jy, _ = _ref(jsm.grouped_moe_mlp_block, jnp.asarray(h), jw, cfg=tight,
                 kernel="padded")
    assert _rel(yg, jy) <= OUT_REL


def test_grouped_grads_equal_the_padded_twin():
    """The ragged product's gradients (x, router, each expert stack)
    against the padded twin's; the same seed twice is bit-identical."""
    _, tw = _pair(_weights(41))
    h = torch.from_numpy(_h((2, 16), seed=42))

    def grads(kernel):
        leaves = [h.clone().requires_grad_()] + [
            v.clone().requires_grad_() for v in tw.values()]
        w = dict(zip(tw, leaves[1:]))
        y, aux = tsm.grouped_moe_mlp_block(leaves[0], w,
                                           Cfg(moe_kernel=kernel))
        (y.square().sum() + aux).backward()
        return [t.grad for t in leaves]

    ragged, padded, again = grads("ragged"), grads("padded"), grads("ragged")
    for r, p, a in zip(ragged, padded, again):
        assert _rel(r, p) <= OUT_REL
        assert torch.equal(r, a)


def test_kernel_names_are_checked_and_never_swapped():
    assert tsm.resolve_moe_kernel("ragged") == ("ragged", "")
    assert tsm.resolve_moe_kernel("padded") == ("padded", "")
    with pytest.raises(ValueError, match="moe kernel"):
        tsm.resolve_moe_kernel("cutlass")
    assert tsm.moe_kernel_support()[0] == "native"
    assert set(tsm.MOE_KERNELS) == set(jsm.MOE_KERNELS)
    h = torch.zeros(1, 4, D)
    with pytest.raises(ValueError, match="moe kernel"):
        tsm.grouped_moe_mlp_block(h, _pair(_weights(0))[1],
                                  Cfg(moe_kernel="blocked"))
    with pytest.raises(ValueError, match="moe_dispatch"):
        tsm.moe_block_for(get_preset("tiny-moe", moe_dispatch="sparse"))


def test_quantized_expert_stacks_dequantize():
    """int8 ``w_gate_q`` / ``w_gate_s`` leaves in place of ``w_gate``: the
    block runs on their dequantized stack, as it runs on that stack dense
    (the reference's ``_expert_weight``; its bit-identity is held in
    tests/test_torch_moe_serving.py)."""
    from deepspeed_tpu_torch.ops.quant_matmul import quantize_matmul_weight

    _, tw = _pair(_weights(0, d=128))
    pairs = [quantize_matmul_weight(w, bits=8) for w in tw["w_gate"]]
    q = {"router": tw["router"], "w_up": tw["w_up"], "w_down": tw["w_down"],
         "w_gate_q": torch.stack([p for p, _ in pairs]),
         "w_gate_s": torch.stack([s for _, s in pairs])}
    dense = dict(q, w_gate=tsm._expert_weight(q, "w_gate", torch.float32))
    del dense["w_gate_q"], dense["w_gate_s"]
    assert _rel(dense["w_gate"], tw["w_gate"]) <= 1e-2
    h = torch.from_numpy(_h((1, 6), d=128))
    for block in (tsm.moe_mlp_block, tsm.grouped_moe_mlp_block):
        y, _ = block(h, q, Cfg())
        assert torch.equal(y, block(h, dense, Cfg())[0])


def test_moe_layer_wrapper_matches_the_reference():
    jw, tw = _pair(_weights(51))
    h = _h((2, 8), seed=52)
    jy, ja = _ref(jsm.MoE(D, num_experts=E, k=2), jnp.asarray(h), jw)
    ty, ta = tsm.MoE(D, num_experts=E, k=2)(torch.from_numpy(h), tw)
    assert _rel(ty, jy) <= OUT_REL and abs(float(ta) - float(ja)) <= AUX_TOL


class _Counts:
    def __init__(self):
        self.seen = []

    def observe(self, counts):
        self.seen.append(np.asarray(counts))


@pytest.mark.parametrize("dispatch", ["capacity", "grouped"])
def test_tracker_counts_each_forward_once_under_remat(dispatch):
    """One forward + backward under ``full`` remat reports each layer's
    routed pairs once (the recompute reports nothing): S*k a layer for the
    grouped path, the kept pairs for the capacity path."""
    tm = TransformerLM(get_preset("tiny-moe", dtype="float32",
                                  moe_dispatch=dispatch,
                                  capacity_factor=4.0,
                                  remat_policy="full"))
    p = tm.init(seed=0, device="cpu")
    for t in tree_leaves(p):
        t.requires_grad_(True)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 16)))
    tr = _Counts()
    tsm.set_expert_tracker(tr)
    try:
        tm.loss_fn(p, {"input_ids": ids}).backward()
    finally:
        tsm.set_expert_tracker(None)
    assert len(tr.seen) == tm.cfg.num_layers
    assert all(c.shape == (4,) and c.sum() == 32 * 2 for c in tr.seen)


# ---------------------------------------------------------------------------
# the model: loss and grads against the reference's loss_fn
# ---------------------------------------------------------------------------

def _jax_cfg(dispatch, **kw):
    # the reference's grouped path through its padded twin (its ragged vs
    # padded bit-identity does not hold on every CPU)
    return jax_preset("tiny-moe", dtype="float32", moe_dispatch=dispatch,
                      moe_kernel="padded", **kw)


def _loss_and_grads(tm, p, batch):
    leaves = _flat(p)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = tm.loss_fn(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


def _check(loss, grads, want, jg):
    assert abs(loss - float(want)) <= 1e-5 * abs(float(want))
    jg = _flat(jg)
    assert set(grads) == set(jg)
    for name, w in jg.items():
        assert _rel(grads[name], w) <= GRAD_REL, (name,
                                                  _rel(grads[name], w))


@pytest.fixture(scope="module")
def moe_params():
    """The reference's init (jitted) plus seeded noise on every leaf, as
    ``tests/test_torch_model.py``'s ``perturbed_params``."""
    rng = np.random.default_rng(6)
    params = jax.device_get(jax.jit(JaxLM(_jax_cfg("capacity")).init)(
        jax.random.key(6)))
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


@pytest.mark.parametrize("dispatch,kernel", [
    ("capacity", "ragged"), ("grouped", "ragged"), ("grouped", "padded")])
def test_loss_and_grads_match_the_reference(moe_params, dispatch, kernel):
    """``loss_fn`` (LM loss + 0.01 x the layers' aux) and every leaf's
    gradient, the router's and the expert stacks' included; ``init``
    builds the reference's leaves, and the bridge carries them as they
    are."""
    ids = np.random.default_rng(7).integers(0, 256, (2, 16)).astype(
        np.int32)
    batch = {"input_ids": ids}
    jm = JaxLM(_jax_cfg(dispatch))
    want, jg = jax.jit(jax.value_and_grad(lambda q: jm.loss_fn(q, batch)))(
        moe_params)
    tm = TransformerLM(get_preset("tiny-moe", dtype="float32",
                                  moe_dispatch=dispatch, moe_kernel=kernel))
    p = params_from_numpy(moe_params, device="cpu")
    shapes = {n: tuple(t.shape) for n, t in _flat(p).items()}
    assert {n: tuple(t.shape) for n, t in _flat(
        tm.init(seed=0, device="cpu")).items()} == shapes
    assert shapes["layers.mlp.router"] == (2, 64, 4)
    assert shapes["layers.mlp.w_down"] == (2, 4, 256, 64)
    want_leaves = _flat(moe_params)
    for n, t in _flat(p).items():
        assert np.array_equal(t.numpy(), want_leaves[n])
    loss, grads = _loss_and_grads(tm, p, batch)
    _check(loss, grads, want, jg)
    # the loss is the LM loss plus 0.01 x the layers' aux (>= 1 a layer)
    tm0 = TransformerLM(dataclasses.replace(tm.cfg, moe_aux_loss_coef=0.0))
    q = params_from_numpy(moe_params, device="cpu")
    with torch.no_grad():
        lm0 = float(tm0.loss_fn(q, {"input_ids": torch.from_numpy(ids)}))
        aux = float(tm.hidden_states_and_aux(q, torch.from_numpy(ids))[1])
    assert aux >= 2.0
    assert abs(loss - lm0 - 0.01 * aux) <= 1e-5 * abs(loss)


@pytest.mark.parametrize("feature", ["tiled-window", "ltd", "pld"])
def test_model_features_match_the_reference(moe_params, feature):
    """The tiled loss over two window segments, random-LTD (an LTD layer's aux
    from its kept tokens) and gated PLD (a dropped layer adds 0) under the
    grouped dispatch and the port's ``full`` remat, on the reference's
    draws."""
    ids = np.random.default_rng(8).integers(0, 256, (2, 16)).astype(
        np.int32)
    seed, keep, theta = 6, 9, 0.3      # seed 6 drops layer 1 under PLD
    batch = {"input_ids": ids}
    kw = {"tiled-window": dict(loss_tiling=4, sliding_window=8,
                               window_start_layer=1)}.get(feature, {})
    jm = JaxLM(_jax_cfg("grouped", **kw))      # remat changes no value
    tm = TransformerLM(get_preset("tiny-moe", dtype="float32",
                                  moe_dispatch="grouped",
                                  remat_policy="full", **kw))
    key0 = _key0(seed, ids)
    if feature == "ltd":
        batch["ltd_seed"] = np.full(2, seed, np.int32)
        jm.set_random_ltd(keep, (0, 1))
        tm.set_random_ltd(keep, (0, 1))
        tm.ltd_positions = lambda s, layer, T, k: torch.from_numpy(
            np.asarray(jnp.sort(jax.random.permutation(
                jax.random.fold_in(key0, layer), T)[:k])).astype(np.int64))
    elif feature == "pld":
        batch["ltd_seed"] = np.full(2, seed, np.int32)
        batch["pld_theta"] = np.full(2, theta, np.float32)
        bits = []

        def keep_bit(s, layer, th):
            p = 1.0 - ((np.float32(layer) + 1.0) / 2) * (1.0 - np.float32(th))
            bits.append(bool(jax.random.bernoulli(
                jax.random.fold_in(key0, layer), jnp.float32(p))))
            return bits[-1]
        tm.pld_keep = keep_bit
    want, jg = jax.jit(jax.value_and_grad(lambda q: jm.loss_fn(q, batch)))(
        moe_params)
    loss, grads = _loss_and_grads(
        tm, params_from_numpy(moe_params, device="cpu"), batch)
    _check(loss, grads, want, jg)
    if feature == "pld":
        assert bits == [True, False]       # layer 1 dropped: no grads, no aux
        assert not grads["layers.mlp.router"][1].any()


def test_remat_policies_give_none_s_grads_bit_for_bit(moe_params):
    ids = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (2, 16)))
    out = {}
    for policy in ("none", "full", "dots_saveable"):
        tm = TransformerLM(get_preset("tiny-moe", dtype="float32",
                                      moe_dispatch="grouped",
                                      remat_policy=policy))
        out[policy] = _loss_and_grads(
            tm, params_from_numpy(moe_params, device="cpu"),
            {"input_ids": ids.numpy()})
    for policy in ("full", "dots_saveable"):
        assert out[policy][0] == out["none"][0]
        for name, g in out["none"][1].items():
            assert torch.equal(out[policy][1][name], g), (policy, name)


# ---------------------------------------------------------------------------
# the engine: 4 steps against the reference's
# ---------------------------------------------------------------------------

def test_engine_steps_match_the_reference():
    """4 ``train_batch`` steps of the capacity model (the preset's default
    dispatch) under ``tests/test_torch_train.py``'s config (AdamW, WarmupLR,
    clipping, GA 2) plus an enabled ``moe`` section: losses to 1e-5
    relative, every leaf within 2e-6 + 1e-4 relative of the reference's,
    every leaf moved."""
    from tests.test_torch_train import CONFIG as TRAIN, GA, MICRO, SEQ, STEPS

    CONFIG = {**TRAIN, "moe": {"enabled": True, "num_experts": 4,
                               "top_k": 2}}
    cfg = dict(dtype="float32", moe_dispatch="capacity")
    jeng, *_ = ds.initialize(
        model=JaxLM(jax_preset("tiny-moe", **cfg)), config=dict(CONFIG),
        mesh=ds.build_mesh(devices=jax.devices()[:1]))
    params0 = jax.device_get(jeng.params)
    teng, *_ = tds.initialize(
        TransformerLM(get_preset("tiny-moe", **cfg)), dict(CONFIG),
        model_parameters=params_from_numpy(params0, device="cpu"),
        device="cpu")
    rng = np.random.default_rng(0)
    distinct = [{"input_ids": rng.integers(0, 256, (MICRO, SEQ)).astype(
        np.int32)} for _ in range(GA)]
    batches = [distinct[i % GA] for i in range(STEPS * GA)]
    losses = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        it = iter(batches)
        losses[name] = [float(eng.train_batch(it)) for _ in range(STEPS)]
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5)
    assert losses["torch"][-1] < losses["torch"][0]
    want, start = _flat(jax.device_get(jeng.params)), _flat(params0)
    got = _flat(teng.params)
    assert set(got) == set(want)
    for n, t in got.items():
        w = np.asarray(want[n])
        np.testing.assert_allclose(t.detach().numpy(), w, atol=2e-6,
                                   rtol=1e-4, err_msg=n)
        assert not np.array_equal(w, np.asarray(start[n])), n


# ---------------------------------------------------------------------------
# the balancer: the reference's TestBalancerUnits on both packages
# ---------------------------------------------------------------------------

def test_balancer_plans_equal_the_reference():
    for counts, ep, slots, prev in (([900, 50, 30, 20], 4, 2, None),
                                    ([100] * 8, 4, 2, None),
                                    ([5, 80, 0, 40, 7, 3], 2, 4,
                                     [0, 1, 2, 3, 4, 5, 1, 3])):
        want = jbal.plan_rebalance(counts, ep, slots, prev_assign=prev)
        got = tbal.plan_rebalance(counts, ep, slots, prev_assign=prev)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.bound == want.bound
        np.testing.assert_array_equal(tbal.shard_loads(got.assign, counts,
                                                       ep),
                                      jbal.shard_loads(want.assign, counts,
                                                       ep))
        again = tbal.plan_rebalance(counts, ep, slots,
                                    prev_assign=got.assign)
        assert again.moved_slots == 0
    plan = tbal.plan_rebalance([900, 50, 30, 20], ep=4, slots_per_shard=2)
    assert plan.nrep[0] == 5 and set(plan.assign) == {0, 1, 2, 3}
    assert plan.imbalance_after <= plan.bound + 1e-9
    with pytest.raises(ValueError, match="cannot hold"):
        tbal.plan_rebalance([1] * 9, ep=4, slots_per_shard=2)


def test_placement_tables_and_apply_equal_the_reference():
    assign = [0, 1, 0, 2]
    want = jbal.placement_tables(assign, num_experts=3, ep=2)
    got = tbal.placement_tables(assign, num_experts=3, ep=2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    w = {"router": np.arange(6.0, dtype=np.float32).reshape(2, 3),
         "w_up": np.arange(12.0, dtype=np.float32).reshape(3, 4)}
    jout = jbal.apply_placement({k: jnp.asarray(v) for k, v in w.items()},
                                assign, num_experts=3, ep=2)
    tout = tbal.apply_placement({k: torch.from_numpy(v)
                                 for k, v in w.items()},
                                assign, num_experts=3, ep=2)
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    # a re-placement sources each expert from its first previous replica
    prev = tbal.apply_placement(tout, [2, 1, 0, 0], num_experts=3, ep=2,
                                prev_assign=assign)
    np.testing.assert_array_equal(prev["w_up"].numpy(),
                                  w["w_up"][[2, 1, 0, 0]])
    with pytest.raises(ValueError, match="lost experts"):
        tbal.apply_placement(tout, assign, 3, 2, prev_assign=[0, 0, 1, 1])


def test_tracker_window_and_registry():
    from deepspeed_tpu_torch.observability import MetricsRegistry

    for tracker in (jbal.ExpertLoadTracker, tbal.ExpertLoadTracker):
        tr = tracker(4)
        tr.observe(np.array([8, 0, 0, 0]))
        tr.observe(np.array([0, 8, 0, 0]))
        assert tr.snapshot().tolist() == [8, 8, 0, 0]
        assert tr.imbalance() == pytest.approx(2.0)
        tr.reset()
        assert tr.snapshot().sum() == 0 and tr.imbalance() == 1.0
        with pytest.raises(ValueError, match="expected 4 counts"):
            tr.observe(np.zeros(3))
    from deepspeed_tpu.observability import MetricsRegistry as JaxRegistry

    snaps = []
    for tracker, registry in ((jbal.ExpertLoadTracker, JaxRegistry),
                              (tbal.ExpertLoadTracker, MetricsRegistry)):
        reg = registry()
        tr = tracker(2, registry=reg)
        tr.observe([3, 1])
        tr.observe([1, 1])
        snaps.append(reg.snapshot())
    assert snaps[1] == snaps[0]
    reg_t = snaps[1]
    assert [s["value"] for s in reg_t["moe/expert_tokens"]["series"]] == \
        [4.0, 2.0]
    assert reg_t["moe/imbalance"]["series"][0]["value"] == \
        pytest.approx(4 / 3)


# ---------------------------------------------------------------------------
# the config section and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw", [
    {}, {"kernel": "padded", "a2a_bits": 8, "a2a_slice": 2},
    {"enabled": True, "num_experts": 8, "top_k": 1,
     "noisy_gate_policy": "RSample", "replica_slots": 1},
    {"kernel": "blocked"}, {"a2a_bits": 3}, {"a2a_slice": -1},
    {"replica_slots": -2}])
def test_moe_config_section_checks_as_the_reference(raw):
    try:
        want = JaxMoEConfig(**raw).model_dump()
    except ValueError:
        want = None
    if want is None:
        with pytest.raises(ValueError, match="moe"):
            from_config({"moe": raw})
        with pytest.raises(ValueError):
            MoEConfig(**raw)
        return
    got = from_config({"moe": raw}).moe
    assert dataclasses.asdict(got) == want
    with pytest.raises(ValueError, match="kernl"):
        from_config({"moe": {"kernl": "padded"}})


def test_preset_overrides_reach_the_model():
    cfg = get_preset("tiny", num_experts=4, moe_dispatch="grouped",
                     moe_kernel="padded")
    tm = TransformerLM(cfg)
    assert tm.moe_fn is tsm.grouped_moe_mlp_block
    assert tm.init(seed=0, device="cpu")["layers"]["mlp"]["w_up"].shape \
        == (2, 4, 64, 256)
    assert TransformerLM(get_preset("tiny-moe")).moe_fn is tsm.moe_mlp_block
    mix = TransformerLM(get_preset("mixtral-8x7b"))
    assert (mix.cfg.num_experts, mix.cfg.top_k, mix.cfg.hidden_size,
            mix.cfg.intermediate_size) == (8, 2, 4096, 14336)


def test_cached_entry_points_and_engines_serve_an_moe_model():
    """Each cached entry point and both engine constructors run an MoE model
    (tests/test_torch_moe_serving.py holds their values against the
    reference's)."""
    tm = TransformerLM(get_preset("tiny-moe", dtype="float32"))
    p = tm.init(seed=0, device="cpu")
    ids = torch.ones(1, 4, dtype=torch.long)
    one = torch.zeros(1, dtype=torch.int32)
    calls = {
        "forward_with_cache": lambda: tm.forward_with_cache(
            p, ids, tm.init_kv_cache(1, 16, device="cpu")),
        "forward_with_paged_cache": lambda: tm.forward_with_paged_cache(
            p, ids, tm.init_paged_kv_cache(4, 8, device="cpu"),
            torch.zeros(1, 2, dtype=torch.int32), one),
        "forward_prefill": lambda: tm.forward_prefill(p, ids, one + 4),
        "forward_with_packed_cache": lambda: tm.forward_with_packed_cache(
            p, ids[0], tm.init_paged_kv_cache(4, 8, device="cpu"),
            torch.zeros(1, 2, dtype=torch.int32), one.repeat(4),
            torch.arange(4), torch.ones(4, dtype=torch.bool),
            torch.tensor([3])),
        "forward_decode_tail": lambda: tm.forward_decode_tail(
            p, ids[:, 0], tm.init_paged_kv_cache(4, 8, device="cpu"),
            {"k": torch.zeros(2, 1, 2, 4, 16), "v": torch.zeros(
                2, 1, 2, 4, 16)}, 0, torch.zeros(1, 2, dtype=torch.int32),
            one, one)}
    for name, call in calls.items():
        logits = call()[0]
        assert torch.isfinite(logits).all() and logits.shape[-1] == 256, name
    prompt = [np.arange(1, 6, dtype=np.int32)]
    for eng in (InferenceEngineV2(tm, p, device="cpu", max_seq_len=64),
                tds.init_inference(tm, params=p, device="cpu")):
        out = (eng.put([0], prompt)[0] if hasattr(eng, "put")
               else eng.generate(prompt, max_new_tokens=2))
        assert np.isfinite(out).all()
    # the full-sequence forward runs
    assert tm.logits(p, ids).shape == (1, 4, 256)
