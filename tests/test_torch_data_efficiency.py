"""The data-efficiency pipeline, progressive layer drop and random-LTD of
the port against the reference on the CPU: the curriculum's three
schedules, the sampler's draws, ``batch_by_tokens`` and the LR rule, the
indexed dataset's files (byte for byte, read across packages), the SP
adapter, the PLD schedule and tiers, and the engine's difficulty, LTD keep
and PLD depth step by step against the reference's engine -- all exact.
The LTD and PLD layers run on the reference's own ``jax.random`` draws
(the port's draw methods replaced) and agree with the reference's loss to
1e-5 relative and its gradients to 1e-5 relative L2 (``tiny`` preset, 4
layers, width 64, fp32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu.runtime import data_pipeline as jdp
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from deepspeed_tpu_torch.models.spec import tree_leaves
from deepspeed_tpu_torch.runtime import data_pipeline as tdp
from deepspeed_tpu_torch.runtime import progressive_layer_drop as tpld
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_model import perturbed_params

CURRICULA = [
    {"min_difficulty": 8, "max_difficulty": 64, "schedule_type":
     "fixed_linear", "schedule_config": {"total_curriculum_step": 10,
                                        "difficulty_step": 8}},
    {"min_difficulty": 16, "max_difficulty": 128, "schedule_type":
     "fixed_root", "schedule_config": {"total_curriculum_step": 12,
                                      "difficulty_step": 16,
                                      "root_degree": 3}},
    {"min_difficulty": 4, "max_difficulty": 32, "schedule_type":
     "fixed_discrete", "schedule_config": {"difficulty": [4, 12, 32],
                                          "max_step": [3, 7]}},
]


@pytest.mark.parametrize("cfg", CURRICULA,
                         ids=[c["schedule_type"] for c in CURRICULA])
def test_curriculum_schedules(cfg):
    j, t = jdp.CurriculumScheduler(cfg), tdp.CurriculumScheduler(cfg)
    seq = [(j.update_difficulty(s), t.update_difficulty(s))
           for s in range(-1, 16)]
    assert [a for a, _ in seq] == [b for _, b in seq]
    assert len({a for a, _ in seq}) > 2
    assert t.get_current_difficulty() == j.get_current_difficulty()


def test_sampler_draws_the_reference_indices():
    diffs = np.random.default_rng(1).integers(8, 64, 40)
    out = []
    for pkg in (jdp, tdp):
        s = pkg.DataEfficiencySampler(
            diffs, 4, pkg.CurriculumScheduler(CURRICULA[0]), seed=3)
        s.set_step(2)
        it = iter(s)
        out.append([next(it) for _ in range(8)])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_variable_batches_and_lr_rule():
    lens = np.random.default_rng(2).integers(4, 200, 60)
    for kw in ({}, {"bucket_batch_sizes": [1, 3, 6], "drop_last": True,
                    "shuffle_seed": 5}, {"shuffle_seed": None}):
        for a, b in zip(jdp.batch_by_tokens(lens, 512, **kw),
                        tdp.batch_by_tokens(lens, 512, **kw)):
            np.testing.assert_array_equal(a, b)
    for bs, base, m in ((8, 4, "linear"), (2, 8, "sqrt"), (5, 0, "linear")):
        assert tdp.lr_scale_for_batch(bs, base, m) == \
            jdp.lr_scale_for_batch(bs, base, m)
    with pytest.raises(ValueError, match="unknown lr scaling"):
        tdp.lr_scale_for_batch(2, 2, "cubic")
    scheds = [pkg.VariableBatchLRSchedule(lambda s: 1e-3 * (s + 1), 8,
                                          "sqrt") for pkg in (jdp, tdp)]
    for s in scheds:
        s.set_batch_size(32)
    assert scheds[0](3) == scheds[1](3)
    data = [{"input_ids": np.full(int(n), i, np.int32)} for i, n in
            enumerate(np.full(24, 16))]
    loaders = [pkg.VariableBatchDataLoader(data, np.full(24, 16), 64)
               for pkg in (jdp, tdp)]
    assert len(loaders[0]) == len(loaders[1])
    for (ja, js), (ta, ts) in zip(*loaders):
        np.testing.assert_array_equal(ja["input_ids"], ta["input_ids"])
        assert js == ts


def test_indexed_dataset_files_cross_read(tmp_path):
    items = [np.arange(n, dtype=np.int32) * 3 for n in (5, 0, 9, 2)]
    for pkg, name in ((jdp, "ref"), (tdp, "port")):
        b = pkg.MMapIndexedDatasetBuilder(str(tmp_path / name), np.uint16)
        for it in items:
            b.add_item(it)
        b.finalize()
    for ext in (".bin", ".idx"):
        assert (tmp_path / f"ref{ext}").read_bytes() == \
            (tmp_path / f"port{ext}").read_bytes()
    for pkg, name in ((tdp, "ref"), (jdp, "port")):
        d = pkg.MMapIndexedDataset(str(tmp_path / name))
        assert len(d) == 4 and d.dtype == np.uint16
        np.testing.assert_array_equal(d.sizes, [5, 0, 9, 2])
        for i, it in enumerate(items):
            np.testing.assert_array_equal(d[i], it)
    (tmp_path / "bad.idx").write_bytes(b"NOTMAGIC" + bytes(9))
    with pytest.raises(ValueError, match="bad magic"):
        tdp.MMapIndexedDataset(str(tmp_path / "bad"))


def test_sp_adapter_slices_like_the_reference():
    rng = np.random.default_rng(4)
    loader = [{"input_ids": rng.integers(0, 9, (2, 12)),
               "labels": rng.integers(0, 9, (2, 12)),
               "attention_mask": np.ones((2, 10)), "other": np.ones((2, 12))}
              for _ in range(2)]
    for rank in range(3):
        ja = jdp.SPDataLoaderAdapter(loader, 3, rank)
        ta = tdp.SPDataLoaderAdapter(loader, 3, rank)
        assert len(ta) == len(ja) == 2
        for jb, tb in zip(ja, ta):
            assert jb.keys() == tb.keys()
            for k in jb:
                np.testing.assert_array_equal(jb[k], tb[k])


def test_pld_schedule_and_tiers():
    j, t = jpld.ProgressiveLayerDrop(0.4, 0.05), \
        tpld.ProgressiveLayerDrop(0.4, 0.05)
    for step in (0, 1, 7, 40, 300):
        j.update_state(step)
        t.update_state(step)
        assert t.get_state() == j.get_state()
    for theta in (1.0, 0.9, 0.62, 0.5, 0.3):
        np.testing.assert_array_equal(tpld.layer_keep_probs(theta, 16),
                                      jpld.layer_keep_probs(theta, 16))
        for tiers in (1, 2, 4, 7):
            assert tpld.active_layers(theta, 16, tiers) == \
                jpld.active_layers(theta, 16, tiers)


BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "steps_per_print": 100}
ROUTING = {
    "data_efficiency": {
        "enabled": True,
        "data_sampling": {"enabled": True, "curriculum_learning": {
            "enabled": True, "min_difficulty": 8, "max_difficulty": 32,
            "schedule_config": {"total_curriculum_step": 6,
                                "difficulty_step": 8}}},
        "data_routing": {"enabled": True, "random_ltd": {
            "enabled": True, "min_value": 4, "step_size": 3, "interval": 2,
            "max_value": 14, "random_ltd_layer_start": 1,
            "random_ltd_layer_end": 3}}}}
PLD = {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                  "gamma": 0.4}}


def _engines(cfg):
    jeng = ds.initialize(model=JaxLM(jax_preset("tiny", dtype="float32",
                                                num_layers=4)),
                         config=dict(cfg),
                         mesh=ds.build_mesh(devices=jax.devices()[:1]))[0]
    teng = tds.initialize(TransformerLM(get_preset(
        "tiny", dtype="float32", num_layers=4)), dict(cfg), device="cpu")[0]
    return jeng, teng


@pytest.mark.parametrize("extra", [
    ROUTING, PLD,
    {"progressive_layer_drop": {**PLD["progressive_layer_drop"],
                                "compiled_tiers": 3}}],
    ids=["curriculum-ltd", "pld-gated", "pld-tiers"])
def test_engine_schedules_step_by_step(extra):
    jeng, teng = _engines({**BASE, **extra})
    ids = np.zeros((4, 48), np.int32)
    for step in range(14):
        for e in (jeng, teng):
            e.global_steps, e.micro_steps = step, 2 * step
        assert teng.curriculum_difficulty() == jeng.curriculum_difficulty()
        if "data_efficiency" in extra:
            jeng._update_random_ltd()
            teng._update_random_ltd()
            assert teng.module._ltd_keep == jeng.module._ltd_keep
            assert teng.module._ltd_layers == jeng.module._ltd_layers
        jb = jeng._inject_ltd_seed(jeng._apply_curriculum({"input_ids": ids}))
        tb = teng._inject_ltd_seed(teng._apply_curriculum({"input_ids": ids}))
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(np.asarray(tb[k]), jb[k])
        assert teng.module._pld_depth == jeng.module._pld_depth
    if "data_efficiency" in extra:
        assert teng.module._ltd_keep == 14 and tb["input_ids"].shape == (4, 32)
    elif "compiled_tiers" in extra["progressive_layer_drop"]:
        assert teng.module._pld_depth == 3


def test_engine_trains_through_curriculum_and_ltd():
    """Both train paths run the hooks: batches truncated to the
    difficulty, each micro-batch with its own seed, LTD on; the caller's
    model keeps its own state."""
    model = TransformerLM(get_preset("tiny", dtype="float32", num_layers=4))
    eng = tds.initialize(model, {**BASE, **ROUTING}, device="cpu")[0]
    assert eng.module is not model and model._ltd_keep is None
    seen = []
    loss_fn = eng.module.loss_fn
    eng.module.loss_fn = lambda p, b: seen.append(
        (tuple(b["input_ids"].shape), int(b["ltd_seed"][0]),
         b["ltd_seed"].device.type)) or loss_fn(p, b)
    rng = np.random.default_rng(0)
    batches = iter([{"input_ids": rng.integers(0, 256, (2, 40))}
                    for _ in range(2)])
    losses = [eng.train_batch(batches),
              float(eng.fused_train_step({"input_ids": rng.integers(
                  0, 256, (4, 40))}))]
    assert all(np.isfinite(losses))
    # seeds: global + micro steps; the fused step's micro-batch i adds i
    assert seen == [((2, 8), 0, "cpu"), ((2, 8), 1, "cpu"),
                    ((2, 8), 3, "cpu"), ((2, 8), 4, "cpu")]
    assert eng.module._ltd_keep == 4 and eng.global_steps == 2


@pytest.fixture(scope="module")
def routed():
    cfg = jax_preset("tiny", dtype="float32", num_layers=4)
    params = perturbed_params(JaxLM(cfg), seed=8)
    ids = np.random.default_rng(9).integers(0, 256, (2, 16)).astype(np.int32)
    return cfg, params, ids


def _key0(seed, ids):
    return jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)),
                              jnp.sum(jnp.asarray(ids)).astype(jnp.uint32))


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k],
                                                        f"{prefix}{k}.")]
    return [prefix[:-1]]


@pytest.mark.parametrize("mode", ["ltd", "pld"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_ltd_and_pld_layers_on_the_reference_draws(routed, mode, remat):
    cfg, params, ids = routed
    seed, keep, theta = 5, 9, 0.3
    jm = JaxLM(dataclasses.replace(cfg, remat_policy=remat))
    batch = {"input_ids": ids, "ltd_seed": np.full(2, seed, np.int32)}
    tm = TransformerLM(get_preset("tiny", dtype="float32", num_layers=4,
                                  remat_policy=remat))
    key0 = _key0(seed, ids)
    if mode == "ltd":
        jm.set_random_ltd(keep, (1, 3))
        tm.set_random_ltd(keep, (1, 3))
        drawn = []

        def positions(s, layer, T, k):
            drawn.append(layer)
            assert (s, T, k) == (seed, 16, keep)
            return torch.from_numpy(np.asarray(jnp.sort(
                jax.random.permutation(jax.random.fold_in(key0, layer),
                                       T)[:k])).astype(np.int64))
        tm.ltd_positions = positions
    else:
        batch["pld_theta"] = np.full(2, theta, np.float32)
        bits = []

        def keep_bit(s, layer, th):
            p = 1.0 - ((np.float32(layer) + 1.0) / 4) * (1.0 - np.float32(th))
            bit = bool(jax.random.bernoulli(jax.random.fold_in(key0, layer),
                                            jnp.float32(p)))
            bits.append(bit)
            return bit
        tm.pld_keep = keep_bit
    want, jg = jax.value_and_grad(lambda p: jm.loss_fn(p, batch))(params)
    jg = dict(zip(_names(jg), jax.tree_util.tree_leaves(jg)))
    p = params_from_numpy(params, device="cpu")
    leaves = list(tree_leaves(p))
    for t in leaves:
        t.requires_grad_(True)
    loss = tm.loss_fn(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(_names(p), torch.autograd.grad(loss, leaves)))
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    for name, w in jg.items():
        w = np.asarray(w)
        rel = np.linalg.norm(grads[name].numpy() - w) / max(
            np.linalg.norm(w), 1e-30)
        assert rel <= 1e-5, (name, rel)
    if mode == "ltd":
        assert drawn == [1, 2]
    else:
        assert len(bits) == 4 and 0 < sum(bits) < 4   # some layer dropped
        dropped = [i for i, b in enumerate(bits) if not b]
        wq = grads["layers.attn.wq"].numpy()
        assert all(not wq[i].any() for i in dropped)


def test_mixed_window_models_refuse_routing():
    tm = TransformerLM(get_preset("tiny", dtype="float32", num_layers=4,
                                  sliding_window=8, window_start_layer=2))
    p = tm.init(seed=0, device="cpu")
    ids = torch.zeros(1, 16, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="mixed-window"):
        tm.hidden_states(p, ids, pld_theta=0.5)
    tm.set_random_ltd(4)
    with pytest.raises(NotImplementedError, match="mixed-window"):
        tm.hidden_states(p, ids)


@pytest.mark.parametrize("extra,match", [
    ({"data_efficiency": {"enabled": True, "data_sampling": {
        "enabled": True, "curriculum_learning": {
            "enabled": True, "min_difficulty": 8, "max_difficulty": 1024,
            "schedule_config": {"difficulty_step": 8}}}}},
     "128 distinct sequence-length buckets"),
    ({**ROUTING, **PLD}, "enable one"),
    ({"progressive_layer_drop": {"enabled": True, "compiled_tiers": 2},
      "optimizer": {"type": "AdamW", "params": {"weight_decay": 0.1}}},
     "requires weight_decay=0")],
    ids=["curriculum-buckets", "pld-and-ltd", "tiers-weight-decay"])
def test_engine_guards_of_the_reference(extra, match):
    """The reference's construction-time contracts, kept: at most 64
    curriculum buckets, PLD or random-LTD (not both), compiled tiers
    without weight decay."""
    with pytest.raises(ValueError, match=match):
        tds.initialize(TransformerLM(get_preset("tiny", dtype="float32")),
                       {**BASE, **extra}, device="cpu")
