"""The port's offload tier against the JAX package's on the CPU, inputs from
numpy seeds: ``DeepSpeedCPUAdam`` (AdamW and Adam modes, bit-identical to
the reference's, within 1e-5 of its plain twin), ``HostOffloadOptimizer``
(masters and moments bit-identical to the reference's without clipping,
1e-6 with it; the NVMe tier, serial and depth 2, bit-identical to the CPU
tier), ``ZenFlowSelectiveOptimizer`` (data without ties in the column
scores), the engine with ``offload_optimizer: cpu`` against the reference
engine (``tests/test_torch_train.py``'s ``LOSS_RTOL`` and ``PARAM_TOL``),
``overlap_step``'s one-step shift, ``host_optimizer.npz`` crossing both
ways between the packages, the offload config sections (the reference's
defaults and messages), the engine's refusals, the host library's build
failure, the drill scenarios (``chaos``) and chip_smoke's phase 17 at a
tiny width."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import deepspeed_tpu as ds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.config import config as jcfg
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu.offload import DeepSpeedCPUAdam as JaxCPUAdam
from deepspeed_tpu.offload import HostOffloadOptimizer as JaxHostOptimizer
from deepspeed_tpu.offload import ZenFlowSelectiveOptimizer as JaxZenFlow
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.config import config as tcfg
from deepspeed_tpu_torch.config import from_config
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from deepspeed_tpu_torch.offload import (DeepSpeedCPUAdam,
                                         HostOffloadOptimizer,
                                         ZenFlowSelectiveOptimizer)
from deepspeed_tpu_torch.offload.cpu_adam import adam_step_plain
from deepspeed_tpu_torch.runtime.checkpoint import flatten_tree
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import (CONFIG, GA, LOSS_RTOL, MODEL, PARAM_TOL,
                                    STEPS, _micro_batches)

OFFLOAD = {"offload_optimizer": {"device": "cpu"}}


# ---- the host Adam ---------------------------------------------------------

@pytest.mark.parametrize("adamw_mode", [True, False], ids=["adamw", "adam"])
def test_cpu_adam_matches_the_reference_and_its_plain_twin(adamw_mode):
    rng = np.random.default_rng(0)
    n = 4097                      # not a multiple of any SIMD width
    p = rng.normal(size=n).astype(np.float32)
    grads = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    kw = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
              adamw_mode=adamw_mode)
    ref = [p.copy(), np.zeros(n, np.float32), np.zeros(n, np.float32)]
    port = [torch.from_numpy(p.copy()), torch.zeros(n), torch.zeros(n)]
    plain = [torch.from_numpy(p.copy()), torch.zeros(n), torch.zeros(n)]
    jopt, topt = JaxCPUAdam(**kw), DeepSpeedCPUAdam(**kw)
    for step, g in enumerate(grads, 1):
        jopt.step(ref[0], g, ref[1], ref[2])
        topt.step(port[0], torch.from_numpy(g), port[1], port[2])
        adam_step_plain(plain[0], torch.from_numpy(g), plain[1], plain[2],
                        step=step, **kw)
    assert topt.step_count == jopt.step_count == 3
    for name, got, want, twin in zip("pmv", port, ref, plain):
        assert np.array_equal(got.numpy(), want), name
        torch.testing.assert_close(got, twin, rtol=1e-5, atol=1e-6)


def test_cpu_adam_refuses_what_its_loop_cannot_read():
    opt = DeepSpeedCPUAdam()
    good = torch.zeros(8)
    with pytest.raises(ValueError, match="fp32"):
        opt.step(good, torch.zeros(8, dtype=torch.float64), good.clone(),
                 good.clone())
    with pytest.raises(ValueError, match="differ in size"):
        opt.step(good, torch.zeros(9), good.clone(), good.clone())


def test_host_library_build_failure_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    from deepspeed_tpu_torch.ops import _build, get_op_builder

    src = tmp_path / "broken.cpp"
    src.write_text("extern \"C\" void ds_adam_step( {\n")
    monkeypatch.setattr(_build, "_host_source", lambda name: src)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "out")
    with pytest.raises(RuntimeError, match="build failed") as e:
        get_op_builder("cpu_adam").load()
    assert "broken.cpp" in str(e.value) and "-fopenmp" in " ".join(
        _build.host_flags("cpu_adam"))
    assert _build.host_flags("aio") == _build.GXX_FLAGS


# ---- the optimizer on a tiny tree ------------------------------------------

SHAPES = {"a": {"b": (24,), "w": (16, 24)}, "c": (3, 5, 8)}
OPT_KW = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)


def _tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _schedule(step):
    return 1e-2 * (step + 1) / 3


def _state(opt):
    return {k: np.array(v) for k, v in opt.state_dict().items()}


@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["no-clip", "clip"])
def test_host_offload_optimizer_matches_the_reference(clip):
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    grads = [_tree(rng, scale=0.3) for _ in range(3)]
    kw = dict(OPT_KW, gradient_clipping=clip, schedule_fn=_schedule)
    jopt = JaxHostOptimizer(_jax(p0), **kw)
    topt = HostOffloadOptimizer(_torch(p0), **kw)
    jp, tp = _jax(p0), _torch(p0)
    for step, g in enumerate(grads):
        jp, jskip = jopt.step(_jax(g), jp, step)
        tp, tskip = topt.step(_torch(g), tp, step)
        assert not jskip and not tskip
    np.testing.assert_allclose(topt._last_gnorm, jopt._last_gnorm, rtol=1e-6)
    if clip:
        assert topt._last_gnorm > clip          # clipping was active
    want, got = _state(jopt), _state(topt)
    assert got.keys() == want.keys() and int(got["step"]) == 3
    for key, w in want.items():
        if clip:
            np.testing.assert_allclose(got[key], w, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        else:
            assert np.array_equal(got[key], w), key
    for name, leaf in flatten_tree(tp).items():     # params = masters
        assert np.array_equal(leaf.numpy(), got["master/" + name]), name
    topt.close()


def test_a_non_finite_norm_skips_the_step_untouched():
    rng = np.random.default_rng(2)
    p0 = _tree(rng)
    opt = HostOffloadOptimizer(_torch(p0), **OPT_KW)
    before = _state(opt)
    bad = _tree(rng)
    bad["c"][0, 0, 0] = np.inf
    params = _torch(p0)
    out, skipped = opt.step(_torch(bad), params, 0)
    assert skipped and out is params and not np.isfinite(opt._last_gnorm)
    after = _state(opt)
    for key, w in before.items():
        assert np.array_equal(after[key], w), key
    opt.close()


@pytest.mark.parametrize("depth", [0, 2], ids=["serial", "depth2"])
def test_nvme_tier_is_bit_identical_to_the_cpu_tier(depth, tmp_path):
    rng = np.random.default_rng(3)
    p0 = _tree(rng)
    grads = [_tree(rng, scale=0.3) for _ in range(3)]
    opts = [HostOffloadOptimizer(_torch(p0), **OPT_KW),
            HostOffloadOptimizer(_torch(p0), nvme_path=str(tmp_path),
                                 prefetch_depth=depth, aio_chunk_mb=1,
                                 **OPT_KW)]
    params = [_torch(p0), _torch(p0)]
    for step, g in enumerate(grads):
        for opt, p in zip(opts, params):
            opt.step(_torch(g), p, step)
    cpu, nvme = (_state(o) for o in opts)
    for key, w in cpu.items():
        assert np.array_equal(nvme[key], w), key
    assert any(f.endswith(".swp") for f in
               os.listdir(tmp_path / "opt_states"))
    assert opts[1].report()["device"] == "nvme"
    for opt in opts:
        opt.close()


def test_zenflow_selective_matches_the_reference():
    """5 steps, update interval 2, select interval 4: the device columns,
    the host masters and the selected columns against the reference's.
    Column scores spread apart (no ties the two sums could order
    differently)."""
    rng = np.random.default_rng(4)
    shapes = {"w": (8, 32), "v": (2, 4, 16), "b": (32,)}
    p0 = _tree(rng, shapes)
    spread = {"w": 1 + 0.5 * np.arange(32), "v": 1 + 0.7 * np.arange(16),
              "b": np.ones(32)}
    grads = []
    for _ in range(5):
        g = _tree(rng, shapes, scale=0.3)
        grads.append({k: (np.abs(v) * spread[k]).astype(np.float32)
                      * np.sign(v) for k, v in g.items()})
    kw = dict(OPT_KW, topk_ratio=0.25, select_interval=4, update_interval=2,
              gradient_clipping=1.0)
    jopt, topt = JaxZenFlow(_jax(p0), **kw), ZenFlowSelectiveOptimizer(
        _torch(p0), **kw)
    jp, tp = _jax(p0), _torch(p0)
    for step, g in enumerate(grads):
        jp, _ = jopt.step(_jax(g), jp, step)
        tp, _ = topt.step(_torch(g), tp, step)
        for n in ("w", "v"):
            assert np.array_equal(topt._idx[n].numpy(),
                                  np.asarray(jopt._idx[n])), (step, n)
        for n, leaf in tp.items():
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jp[n]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {n}")
    assert topt._last_select == jopt._last_select == 4
    want, got = jopt.state_dict(), topt.state_dict()
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(w, np.float64), rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    again = ZenFlowSelectiveOptimizer(_torch(p0), **kw)
    again.load_state_dict(got)
    for key, w in again.state_dict().items():
        assert np.array_equal(np.asarray(w), np.asarray(got[key])), key
    topt.close()


# ---- the engine against the reference engine -------------------------------

def _config(**zero):
    return {**CONFIG, "zero_optimization": {**OFFLOAD, **zero}}


def _run(engine, batches, steps=STEPS):
    it = iter(batches)
    losses, norms = [], []
    for _ in range(steps):
        losses.append(engine.train_batch(it))
        norms.append(engine.get_global_grad_norm())
    return losses, norms


def _port_engine(params0, **zero):
    return tds.initialize(TransformerLM(get_preset("tiny", **MODEL)),
                          _config(**zero),
                          model_parameters=params_from_numpy(params0,
                                                             device="cpu"),
                          device="cpu")[0]


@pytest.fixture(scope="module")
def trained():
    """The reference engine and the port's with ``offload_optimizer: cpu``
    after 4 ``train_batch`` steps from the same bridged weights."""
    jeng, *_ = ds.initialize(
        model=JaxLM(jax_preset("tiny", **MODEL)), config=_config(),
        mesh=ds.build_mesh(devices=jax.devices()[:1]))
    params0 = jax.device_get(jeng.params)
    teng = _port_engine(params0)
    batches = _micro_batches(STEPS * GA)
    return dict(params0=params0, batches=batches,
                jax=(jeng, _run(jeng, batches)),
                torch=(teng, _run(teng, batches)))


def test_offload_engine_matches_the_reference_engine(trained):
    (jeng, (jl, jn)), (teng, (tl, tn)) = trained["jax"], trained["torch"]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tn, jn, rtol=LOSS_RTOL)
    assert min(tn) > CONFIG["gradient_clipping"]      # clipping was active
    assert tl[-1] < tl[0] and teng.global_steps == STEPS
    assert teng.opt_state == {} and jeng.opt_state == {}
    want = flatten_tree(jax.device_get(jeng.params))
    got = {k: v.detach().numpy() for k, v in flatten_tree(teng.params).items()}
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **PARAM_TOL)
    tstate, jstate = _state(teng._offload), _state(jeng._offload)
    assert tstate.keys() == jstate.keys()
    for key, w in jstate.items():
        np.testing.assert_allclose(tstate[key], w, err_msg=key, **PARAM_TOL)
    rep = teng.offload_report()
    assert rep["enabled"] and rep["device"] == "cpu" and rep["shards"] == \
        len(want) and set(rep) >= set(jeng.offload_report())


def test_fused_step_and_async_save_on_the_offload_engine(trained, tmp_path):
    """``fused_train_step`` equals ``train_batch`` on the offload path, the
    ``offload/*`` instruments are in the registry, and an async save's
    ``host_optimizer.npz`` holds the tier as it was at the save, though
    the next step's Adam writes the masters in place before the commit
    ends."""
    from deepspeed_tpu_torch.observability import get_registry

    batches = trained["batches"][:2 * GA]
    looped = _port_engine(trained["params0"])
    fused = _port_engine(trained["params0"])
    it = iter(batches)
    want = [looped.train_batch(it) for _ in range(2)]
    got = [float(fused.fused_train_step({"input_ids": np.concatenate(
        [b["input_ids"] for b in batches[i * GA:(i + 1) * GA]])}))
        for i in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for a, b in zip(looped._leaves, fused._leaves):
        assert torch.equal(a, b)
    names = {f.name for f in get_registry().collect()}
    assert {"offload/adam_ms", "offload/upload_ms"} <= names
    eng = tds.initialize(
        TransformerLM(get_preset("tiny", **MODEL)),
        {**_config(), "checkpoint": {"async_save": True}},
        model_parameters=params_from_numpy(trained["params0"], device="cpu"),
        device="cpu")[0]
    eng.train_batch(iter(batches))
    at_save = _state(eng._offload)
    eng.save_checkpoint(str(tmp_path))
    eng.train_batch(iter(batches))            # writes the masters in place
    eng.shutdown()                            # joins the commit
    with np.load(tmp_path / "global_step1" / "host_optimizer.npz") as z:
        for key, w in at_save.items():
            assert np.array_equal(z[key], w), key
    assert not np.array_equal(_state(eng._offload)["master/embed/tokens"],
                              at_save["master/embed/tokens"])


def test_overlap_step_shifts_the_trajectory_by_one_step(tmp_path):
    """ZenFlow's ``overlap_step`` on the reference's test settings (AdamW
    lr 1e-3, one fixed 2 x 16 batch): step N's update lands at step N+1's
    boundary, so the first two losses agree (1e-6) and the next trail the
    synchronous run by one step (2e-2, over the 4 steps chip_smoke gates;
    later steps drift further, in both packages, as each update reads a
    gradient one step stale); the 6-step trajectory equals the reference
    engine's within ``LOSS_RTOL``; a save drains the in-flight step."""
    fixed = {"input_ids": np.random.default_rng(0).integers(
        0, 256, (2, 16)).astype(np.int32)}
    runs = {}
    for overlap in (False, True):
        config = {"train_micro_batch_size_per_gpu": 2,
                  "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                  "zero_optimization": dict(OFFLOAD),
                  "steps_per_print": 100}
        if overlap:
            config["zero_optimization"]["zenflow"] = {"overlap_step": True}
        jeng = ds.initialize(model=JaxLM(jax_preset("tiny", **MODEL)),
                             config=config,
                             mesh=ds.build_mesh(devices=jax.devices()[:1]))[0]
        eng = tds.initialize(TransformerLM(get_preset("tiny", **MODEL)),
                             config, model_parameters=params_from_numpy(
                                 jax.device_get(jeng.params), device="cpu"),
                             device="cpu")[0]
        for tag, e in (("jax", jeng), ("torch", eng)):
            losses = []
            for _ in range(6):
                loss = e.forward(fixed)
                e.backward(loss)
                e.step()
                losses.append(float(loss.detach() if tag == "torch"
                                    else loss))
            runs[tag, overlap] = losses
    np.testing.assert_allclose(runs["torch", True], runs["jax", True],
                               rtol=LOSS_RTOL)
    over, sync = runs["torch", True], runs["torch", False]
    np.testing.assert_allclose(over[1], over[0], rtol=1e-6)
    np.testing.assert_allclose(over[1:4], sync[:3], rtol=2e-2)
    assert eng._offload._pending is not None
    eng.save_checkpoint(str(tmp_path))
    assert eng._offload._pending is None
    eng.shutdown()


def test_host_optimizer_file_crosses_between_the_packages(trained, tmp_path):
    """The port engine's ``host_optimizer.npz`` loads into the reference's
    host optimizer, and a file the reference writes (its ``np.savez`` of
    its state dict) loads into a port engine through ``load_checkpoint``:
    masters and moments bit for bit."""
    teng = trained["torch"][0]
    teng.save_checkpoint(str(tmp_path))
    tag = tmp_path / f"global_step{teng.global_steps}"
    path = tag / "host_optimizer.npz"
    ref = JaxHostOptimizer(_jax(trained["params0"]), **OPT_KW)
    with np.load(path) as z:
        ref.load_state_dict(dict(z))
    port_state = _state(teng._offload)
    for key, w in _state(ref).items():
        assert np.array_equal(w, port_state[key]), key
    # the reference's file into a fresh port engine
    rng = np.random.default_rng(5)
    jp = _jax(trained["params0"])
    ref.step(jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)
                              * 0.1), jp), jp, 0)
    want = _state(ref)
    np.savez(path, **ref.state_dict())
    fresh = _port_engine(trained["params0"])
    fresh.load_checkpoint(str(tmp_path))
    got = _state(fresh._offload)
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert np.array_equal(got[key], w), key


# ---- the config and the engine's refusals -----------------------------------

SECTIONS = [("OffloadParamConfig", "zero_optimization.offload_param"),
            ("OffloadOptimizerConfig", "zero_optimization.offload_optimizer"),
            ("ZenFlowConfig", "zero_optimization.zenflow"),
            ("AioConfig", "offload.aio")]
FIELDS = [(cls, path, name) for cls, path in SECTIONS
          for name in getattr(jcfg, cls).model_fields]


def _nested(path: str, value) -> dict:
    out = value
    for part in reversed(path.split(".")):
        out = {part: out}
    return out


@pytest.mark.parametrize("cls,path,name", FIELDS,
                         ids=[f"{p}.{n}" for _, p, n in FIELDS])
def test_offload_keys_take_the_reference_defaults(cls, path, name):
    default = getattr(jcfg, cls).model_fields[name].default
    section = {name: default}
    if cls == "ZenFlowConfig":        # an all-default block is refused
        section.setdefault("overlap_step", True)
        if name == "overlap_step":
            section = {"overlap_step": True}
    cfg = from_config(_nested(path, section))
    obj = cfg
    for part in path.split("."):
        obj = getattr(obj, part)
    want = getattr(jcfg, cls).model_validate(section)
    assert getattr(obj, name) == getattr(want, name) == section[name]
    assert getattr(getattr(tcfg, cls)(), name) == default


@pytest.mark.parametrize("raw,message", [
    ({"zero_optimization": {"zenflow": {}}}, "would be a no-op"),
    ({"zero_optimization": {"zenflow": {"topk_ratio": 1.5}}},
     "topk_ratio must be in [0, 1]"),
    ({"zero_optimization": {"zenflow": {"topk_ratio": 0.1,
                                        "overlap_step": True}}},
     "enable one, not both"),
    ({"zero_optimization": {"zenflow": {"topk_ratio": 0.1,
                                        "select_strategy": "epoch"}}},
     "'epoch' needs steps_per_epoch"),
    ({"zero_optimization": {"zenflow": {"topk_ratio": 0.1,
                                        "select_strategy": "step"}}},
     "requires an explicit integer"),
    ({"zero_optimization": {"zenflow": {"topk_ratio": 0.1,
                                        "update_interval": 0}}},
     "update_interval must be 'auto' or a positive integer"),
    ({"offload": {"aio": {"prefetch_depth": -1}}}, "must be >= 0"),
    ({"zero_optimization": {"offload_optimizer": {"device": "gpu"}}},
     "'gpu'"),
    ({"offload": {"aoi": {}}}, "aoi"),
], ids=["noop", "ratio", "both", "epoch", "step", "interval", "aio",
        "device", "typo"])
def test_offload_config_refusals_match_the_reference(raw, message):
    with pytest.raises(ValueError) as port:
        from_config(raw)
    with pytest.raises(ValueError) as ref:
        jcfg.from_config(raw)
    assert message in str(port.value) and message in str(ref.value)


def test_zenflow_resolves_the_reference_intervals():
    for block in ({"overlap_step": True}, {"topk_ratio": 0.1,
                                           "update_interval": 3},
                  {"topk_ratio": 0.1, "select_strategy": "step",
                   "select_interval": 5}):
        port = from_config(_nested("zero_optimization.zenflow", block))
        ref = jcfg.from_config(_nested("zero_optimization.zenflow", block))
        pz, rz = port.zero_optimization.zenflow, ref.zero_optimization.zenflow
        assert (pz.resolved_update_interval(), pz.resolved_select_interval()
                ) == (rz.resolved_update_interval(),
                      rz.resolved_select_interval())


@pytest.mark.parametrize("zero,extra,error,match", [
    ({"zenflow": {"overlap_step": True}}, {}, ValueError,
     "requires offload_optimizer"),
    ({**OFFLOAD, "zenflow": {"overlap_step": True}},
     {"fp16": {"enabled": True}}, NotImplementedError, "fp16"),
    (OFFLOAD, {"optimizer": {"type": "OneBitAdam", "params": {}}},
     ValueError, "do not compose with offload_optimizer"),
], ids=["zenflow-alone", "zenflow-fp16", "one-bit"])
def test_engine_refusals(zero, extra, error, match):
    config = {**CONFIG, **extra, "zero_optimization": zero}
    with pytest.raises(error, match=match):
        tds.initialize(TransformerLM(get_preset("tiny", **MODEL)), config,
                       device="cpu")


def test_offload_param_is_accepted_and_reads_nothing():
    config = {**CONFIG, "zero_optimization": {
        "offload_param": {"device": "cpu"}}}
    eng = tds.initialize(TransformerLM(get_preset("tiny", **MODEL)), config,
                         device="cpu")[0]
    assert eng._offload is None and eng.opt_state
    assert eng.offload_report() == {"enabled": False}


# ---- drills and chip_smoke's phase 17 ---------------------------------------

@pytest.mark.chaos
@pytest.mark.parametrize("scenario", ["io-error-read", "io-error-write",
                                      "pool-steady-state"])
def test_offload_drill_scenario(scenario, tmp_path):
    """``tools/offload_drill.py``'s scenarios on the port: a swap-site
    io_error mid-pipeline aborts cleanly -- pool restored, no torn moment
    file, the next step recovers -- and steady state does not grow the
    pool."""
    from deepspeed_tpu_torch.tools.offload_drill import run_scenario

    verdict = run_scenario(scenario, workdir=str(tmp_path), device="cpu")
    assert verdict["ok"], verdict


OFFLOAD_TINY = dict(hidden_size=64, num_layers=4, num_heads=4, num_kv_heads=2,
                    intermediate_size=128, vocab_size=512, dtype="float32",
                    param_dtype="float32")


def test_offload_phase_runs_on_a_tiny_cpu_model(monkeypatch):
    """Phase 17 with both presets cut to width 64 (4 layers; (d) 16) in
    fp32 on the CPU, rows cut to 64 tokens: every gate that does not read
    the card passes -- the host Adam vs its twin, params = masters, the
    losses vs on-card AdamW, upload_overlap on = off, the overlap shift,
    the top-k columns, the NVMe tiers and the resume bit for bit, (d)'s
    finite losses."""
    for name, value in (("OFFLOAD_MODEL_KW", OFFLOAD_TINY),
                        ("OFFLOAD_SEQ", 64), ("OFFLOAD_ADAM_N", 1 << 12)):
        monkeypatch.setattr(chip_smoke, name, value)
    from deepspeed_tpu_torch.ops import _build

    counts = chip_smoke.offload(torch, _build.KERNELS, _build.reset_counts,
                                device="cpu")
    assert set(counts) == set(chip_smoke.TRAIN_KERNELS)
    notes = chip_smoke.PHASE_NOTES["offload"]
    assert notes["big"]["layers"] == chip_smoke.OFFLOAD_BIG_LAYERS
    assert [s > 0 for s, _ in notes["full"]["topk"]["moved"]] == [True] * 3
    assert len(notes["nvme"]["runs"]) == 3
