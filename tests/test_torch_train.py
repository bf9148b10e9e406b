"""The port's training path against the JAX package on the CPU (fp32):
``deepspeed_tpu_torch.initialize`` and ``deepspeed_tpu.initialize`` start
from the same bridged weights of the ``tiny`` preset (GQA), AdamW + WarmupLR
+ gradient clipping, GA 2, and train 4 ``train_batch`` steps on the same
numpy batches; losses and grad norms agree to 1e-5 relative, final params
within 2e-6 + 1e-4 relative. Also: ``fused_train_step`` equals
``train_batch``; each lr schedule and one update of each ported optimizer
against the reference's; the fp16 loss scaler; the config's checks; the
device defaults."""

import types

import jax
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.config import from_config as jax_from_config
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JaxEngine
from deepspeed_tpu.runtime.optimizers import build_optimizer as jax_optimizer
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.config import from_config
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.engine import DeepSpeedTpuEngine
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from tests._torch_threads import one_torch_thread  # noqa: F401

MODEL = dict(dtype="float32", num_kv_heads=2)
STEPS, GA, MICRO, SEQ = 4, 2, 2, 32
CONFIG = {
    "train_micro_batch_size_per_gpu": MICRO,
    "gradient_accumulation_steps": GA,
    "optimizer": {"type": "AdamW", "params": {
        "lr": 3e-3, "betas": [0.9, 0.95], "eps": 1e-8, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 1e-4, "warmup_max_lr": 3e-3, "warmup_num_steps": 3,
        "warmup_type": "linear"}},
    "gradient_clipping": 0.5,
    "steps_per_print": 100,
    "seed": 3,
}
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=2e-6, rtol=1e-4)


def _micro_batches(n, seed=0):
    """``n`` micro-batches cycling over GA distinct ones (so a few steps of
    training visibly lower the loss)."""
    rng = np.random.default_rng(seed)
    distinct = [{"input_ids": rng.integers(0, 256, (MICRO, SEQ))
                 .astype(np.int32)} for _ in range(GA)]
    return [distinct[i % GA] for i in range(n)]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix[:-1]: np.asarray(tree)}


def _run(engine, batches):
    it = iter(batches)
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(engine.train_batch(it))
        norms.append(engine.get_global_grad_norm())
    return losses, norms


@pytest.fixture(scope="module")
def trained():
    """Both engines after 4 train_batch steps on the same batches, and the
    bridged starting weights."""
    jeng, *_ = ds.initialize(
        model=JaxLM(jax_preset("tiny", **MODEL)), config=dict(CONFIG),
        mesh=ds.build_mesh(devices=jax.devices()[:1]))
    params0 = jax.device_get(jeng.params)
    teng, opt, loader, sched = tds.initialize(
        TransformerLM(get_preset("tiny", **MODEL)), dict(CONFIG),
        model_parameters=params_from_numpy(params0, device="cpu"),
        device="cpu")
    assert opt is teng and loader is None and sched is teng.lr_scheduler
    batches = _micro_batches(STEPS * GA)
    return dict(params0=params0, jax=(jeng, _run(jeng, batches)),
                torch=(teng, _run(teng, batches)), batches=batches)


def test_losses_and_grad_norms_match_the_reference(trained):
    (_, (jl, jn)), (teng, (tl, tn)) = trained["jax"], trained["torch"]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tn, jn, rtol=LOSS_RTOL)
    assert min(tn) > CONFIG["gradient_clipping"]      # clipping was active
    assert tl[-1] < tl[0]
    assert teng.global_steps == STEPS and teng.micro_steps == STEPS * GA
    assert teng.get_lr() == pytest.approx(trained["jax"][0].get_lr(),
                                          rel=1e-6)


def test_final_params_match_the_reference(trained):
    want = _leaves(jax.device_get(trained["jax"][0].params))
    got = _leaves(trained["torch"][0].params)
    assert set(got) == set(want)
    start = _leaves(trained["params0"])
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **PARAM_TOL)
        assert not np.array_equal(w, start[name]), name   # every leaf moved


def test_fused_train_step_equals_train_batch(trained):
    engines = [tds.initialize(
        TransformerLM(get_preset("tiny", **MODEL)), dict(CONFIG),
        model_parameters=params_from_numpy(trained["params0"], device="cpu"),
        device="cpu")[0] for _ in range(2)]
    batches = trained["batches"][:2 * GA]
    it = iter(batches)
    looped = [engines[0].train_batch(it) for _ in range(2)]
    fused = [float(engines[1].fused_train_step({"input_ids": np.concatenate(
        [b["input_ids"] for b in batches[i * GA:(i + 1) * GA]])}))
        for i in range(2)]
    np.testing.assert_allclose(fused, looped, rtol=1e-6)
    assert engines[1].global_steps == 2
    for a, b in zip(engines[0]._leaves, engines[1]._leaves):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_full_remat_matches_no_remat(trained):
    """activation_checkpointing.policy "full" recomputes each layer in the
    backward: same gradients."""
    cfg = dict(CONFIG, activation_checkpointing={"policy": "full"})
    model = TransformerLM(get_preset("tiny", **MODEL))
    grads = []
    for c in (CONFIG, cfg):
        eng = tds.initialize(model, dict(c), model_parameters=params_from_numpy(
            trained["params0"], device="cpu"), device="cpu")[0]
        eng.backward(eng.forward(trained["batches"][0]))
        grads.append([p.grad.clone() for p in eng._leaves])
    assert eng.module.cfg.remat_policy == "full"
    assert model.cfg.remat_policy == "none"      # the caller's model kept
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=1e-4, warmup_max_lr=1e-2,
                      warmup_num_steps=5)),
    ("WarmupLR", dict(warmup_max_lr=1e-2, warmup_num_steps=5,
                      warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=12, warmup_min_lr=1e-4,
                           warmup_max_lr=1e-2, warmup_num_steps=4)),
    ("WarmupCosineLR", dict(total_num_steps=12, warmup_min_ratio=0.1,
                            warmup_num_steps=4, warmup_max_lr=1e-2)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                      cycle_first_step_size=3, cycle_second_step_size=4,
                      decay_step_size=2, decay_lr_rate=0.1)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-3,
                         lr_range_test_step_size=3,
                         lr_range_test_step_rate=2.0,
                         lr_range_test_staircase=True)),
]


@pytest.mark.parametrize("name,params", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_lr_schedule_matches_reference(name, params):
    jfn = jlr.build_schedule(name, params)
    tfn = tlr.build_schedule(name, params)
    steps = range(16)
    np.testing.assert_allclose([tfn(s) for s in steps],
                               [float(jfn(s)) for s in steps],
                               rtol=2e-6, atol=1e-10)


OPTIMIZERS = [
    ("adamw", {"lr": 1e-2, "weight_decay": 0.1, "betas": [0.8, 0.9]}, 0.0),
    ("adam", {"lr": 1e-2, "weight_decay": 0.05, "adam_w_mode": False}, 0.0),
    ("Adam", {"lr": 1e-2, "eps": 1e-6}, 1.0),
    ("sgd", {"lr": 0.1}, 0.0),
    ("sgd", {"lr": 0.1, "momentum": 0.9, "nesterov": True}, 1.0),
    ("momentum", {"lr": 0.1}, 0.0),
]


@pytest.mark.parametrize("name,params,clip", OPTIMIZERS,
                         ids=[f"{o[0]}-{i}" for i, o in enumerate(OPTIMIZERS)])
@pytest.mark.parametrize("scheduled", [False, True])
def test_optimizer_updates_match_optax(name, params, clip, scheduled):
    """Two updates of a random tree (so the count, the bias correction and
    the schedule's step move) against the reference's optax chain."""
    rng = np.random.default_rng(4)
    shapes = {"w": (4, 3), "b": (3,), "s": (2, 2, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    gs = [{k: (2.0 * rng.standard_normal(s)).astype(np.float32)
           for k, s in shapes.items()} for _ in range(2)]
    sched = {"warmup_min_lr": 1e-3, "warmup_max_lr": 1e-2,
             "warmup_num_steps": 3}
    jtx = jax_optimizer(name, params, jlr.warmup_lr(**sched) if scheduled
                        else None, gradient_clipping=clip)
    jp, jstate = p0, None
    jstate = jtx.init(jp)
    for g in gs:
        upd, jstate = jtx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    opt = build_optimizer(name, params, tlr.warmup_lr(**sched) if scheduled
                          else None, gradient_clipping=clip)
    tp = [torch.from_numpy(p0[k].copy()) for k in shapes]
    state = opt.init(tp)
    for g in gs:
        opt.update(tp, [torch.from_numpy(g[k]) for k in shapes], state)
    assert state["count"] == 2
    for k, t in zip(shapes, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["OneBitAdam"])
def test_unported_optimizers_raise(name):
    with pytest.raises(NotImplementedError, match=name):
        build_optimizer(name, {})
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer("adamx", {})


def test_fp16_scaler_sequence_matches_reference():
    fp16 = {"enabled": True, "initial_scale_power": 4,
            "loss_scale_window": 2, "min_loss_scale": 2.0}
    base = {"train_micro_batch_size_per_gpu": 1, "fp16": fp16}
    jself = types.SimpleNamespace(config=jax_from_config(dict(base)))
    tself = types.SimpleNamespace(config=from_config(dict(base)))
    js = {"scale": np.float32(16.0), "good_steps": np.int32(0)}
    ts = {"scale": 16.0, "good_steps": 0}
    seq = [True, True, True, False, True, False, False, False, False, True,
           True, True]
    scales = []
    for finite in seq:
        js = JaxEngine._scaler_update(jself, js, np.bool_(finite))
        ts = DeepSpeedTpuEngine._scaler_update(tself, ts, finite)
        assert (ts["scale"], ts["good_steps"]) == (float(js["scale"]),
                                                   int(js["good_steps"]))
        scales.append(ts["scale"])
    assert max(scales) == 32.0 and min(scales) == 2.0   # grew; floored


def test_fp16_overflow_skips_the_step_and_keeps_the_count():
    cfg = dict(CONFIG, fp16={"enabled": True, "initial_scale_power": 8,
                             "loss_scale_window": 100})
    eng = tds.initialize(TransformerLM(get_preset("tiny", **MODEL)), cfg,
                         device="cpu")[0]
    assert not eng.bf16_enabled
    batches = iter(_micro_batches(3 * GA, seed=2))
    before = [p.detach().clone() for p in eng._leaves]
    for _ in range(GA):
        eng.backward(eng.forward(next(batches)))
    eng._leaves[0].grad[0, 0] = float("inf")
    eng.step()
    assert (eng.skipped_steps, eng.global_steps) == (1, 0)
    assert eng.opt_state["count"] == 0
    assert eng.scaler_state["scale"] == 128.0
    assert eng.get_global_grad_norm() == float("inf")
    for a, b in zip(before, eng._leaves):
        torch.testing.assert_close(a, b.detach(), atol=0, rtol=0)
    eng.train_batch(batches)
    assert (eng.skipped_steps, eng.global_steps) == (1, 1)
    assert eng.opt_state["count"] == 1
    assert np.isfinite(eng.get_global_grad_norm())


@pytest.mark.parametrize("triple,dp", [
    ((32, None, None), 1), ((32, 4, None), 1), ((32, None, 4), 1),
    ((None, 4, 2), 1), ((None, 4, None), 1), ((8, 2, 2), 2),
    ((24, 4, 2), 1), ((30, 4, None), 1), ((None, None, 2), 1)])
def test_batch_triple_matches_reference(triple, dp):
    keys = ("train_batch_size", "train_micro_batch_size_per_gpu",
            "gradient_accumulation_steps")
    raw = {k: v for k, v in zip(keys, triple) if v is not None}
    outcome = []
    for make in (jax_from_config, from_config):
        cfg = make(dict(raw))
        try:
            cfg.resolve_batch_sizes(dp)
            outcome.append(tuple(getattr(cfg, k) for k in keys))
        except ValueError as e:
            outcome.append(("ValueError", str(e)))
    assert outcome[0] == outcome[1]


@pytest.mark.parametrize("raw,where", [
    ({"gradient_clipings": 1.0}, "gradient_clipings"),
    ({"optimizer": {"type": "adamw", "parms": {}}}, "parms"),
    ({"zero_optimization": {"stag": 2}}, "stag"),
    ({"fp16": {"enabled": True, "loss_scale_windw": 10}}, "loss_scale_windw"),
])
def test_misspelled_key_names_the_field(raw, where):
    with pytest.raises(ValueError, match=where):
        from_config(raw)


@pytest.mark.parametrize("raw,where", [
    ({"zero_optimization": {"stage": 2, "zero_hpz_partition_size": 2}},
     "zero_hpz_partition_size"),
    ({"zero_optimization": {"zero_pp": {"enabled": True}}}, "zero_pp"),
    ({"zero_optimization": {"zero_quantized_weights": True}},
     "zero_quantized_weights"),
    ({"mesh": {"fsdp": 4}}, "mesh.fsdp"),
    ({"mesh": "auto"}, "mesh"),
    ({"compression": {"enabled": True}}, "compression"),
    ({"pipeline": {"stages": 2}}, "pipeline"),
    ({"elasticity": {"enabled": True}}, "elasticity"),
    ({"monitor_config": {"csv_monitor": {"enabled": True}}},
     "monitor_config"),
    ({"sequence_parallel": {"size": 2}}, "sequence_parallel"),
])
def test_unported_section_raises(raw, where):
    with pytest.raises(NotImplementedError, match=where):
        from_config(raw)


def test_config_accepts_what_the_training_path_reads():
    cfg = from_config({**CONFIG, "zero_optimization": {
        "stage": 3, "overlap_comm": True, "zero_quantized_weights": False},
        "mesh": {"dp": 1}, "bf16": {"enabled": False},
        "activation_checkpointing": {"policy": "full"},
        "wall_clock_breakdown": False})
    assert cfg.zero_optimization.stage == 3
    assert not (cfg.bf16.enabled or cfg.fp16.enabled)
    with pytest.raises(ValueError, match="mutually exclusive"):
        from_config({"fp16": {"enabled": True}, "bf16": {"enabled": True}})
    assert from_config({"fp16": {"enabled": True}}).bf16.enabled is False
    with pytest.raises(ValueError, match="zero stage"):
        from_config({"zero_optimization": {"stage": 4}})
    with pytest.raises(ValueError, match="gradient_clipping"):
        from_config({"gradient_clipping": "1.0"})


def test_entry_points_default_to_the_card():
    """``params_from_numpy`` and ``initialize`` run on the card unless asked
    for the CPU; without one they raise, as ``resolve_device`` does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.initialize(TransformerLM(get_preset("tiny", **MODEL)),
                       dict(CONFIG))
    assert params_from_numpy({"w": np.zeros(3, np.float32)},
                             device="cpu")["w"].device.type == "cpu"


def test_dataloader_matches_reference():
    """The port's numpy loader (its own copy) yields the reference's
    batches: same shuffle per epoch, same repeat."""
    import itertools

    from deepspeed_tpu.runtime import dataloader as jdl
    from deepspeed_tpu_torch.runtime import dataloader as tdl

    data = [{"input_ids": np.arange(i, i + 8, dtype=np.int32)}
            for i in range(10)]
    want = list(itertools.islice(jdl.RepeatingLoader(
        jdl.DeepSpeedTpuDataLoader(data, 3, seed=5)), 7))
    got = list(itertools.islice(tdl.RepeatingLoader(
        tdl.DeepSpeedTpuDataLoader(data, 3, seed=5)), 7))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g["input_ids"], w["input_ids"])


def test_train_batch_reads_training_data():
    data = [{"input_ids": np.arange(i, i + SEQ, dtype=np.int32) % 256}
            for i in range(8)]
    eng, _, loader, _ = tds.initialize(
        TransformerLM(get_preset("tiny", **MODEL)), dict(CONFIG),
        training_data=data, device="cpu")
    assert loader is eng.training_dataloader
    assert loader.batch_size == MICRO and len(loader) == 4
    assert np.isfinite(eng.train_batch())
    assert eng.global_steps == 1 and eng.micro_steps == GA
