"""The port's engine checkpoints (``deepspeed_tpu_torch/runtime/
checkpoint.py``) against the JAX package's on the CPU (fp32), in one
process: both engines start from the same bridged ``tiny`` weights with
``tests/test_torch_train.py``'s config, train 2 steps, commit a tag through
their package's ``CheckpointManager`` (manifest + ``latest``), and train 2
more; the port's tag is loaded into a fresh engine from other weights and
those 2 steps repeated. The reference's tag holds its ``meta.json`` and a
non-Orbax export of its params, never its Orbax state (see
``_RefStateWriter``). The port's resumed run equals its uninterrupted run
bit for bit and the reference's run within ``test_torch_train.py``'s
tolerance; ``meta.json`` has the reference's keys and values;
``consolidate_to_fp32`` and the ``.npz`` exports have the reference's
names; each package's ``verify_tag_dir`` judges the other's tags;
``tensor_fragment`` reads what the reference's reads. Then
``init_inference(checkpoint=)`` and chip_smoke's phase 13 on a tiny CPU
model.
"""

import itertools
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu.resilience.manager as ref_manager
import deepspeed_tpu.runtime.checkpoint as ref_ckpt
import deepspeed_tpu.utils.tensor_fragment as ref_tf
import deepspeed_tpu_torch as tds
import deepspeed_tpu_torch.resilience.manager as port_manager
import deepspeed_tpu_torch.runtime.checkpoint as port_ckpt
import deepspeed_tpu_torch.utils.tensor_fragment as port_tf
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from deepspeed_tpu_torch.resilience import tear_checkpoint_dir
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import (CONFIG, LOSS_RTOL, MODEL, PARAM_TOL,
                                    _micro_batches)

STEPS = 2          # before the save, and after it
TAG = f"global_step{STEPS}"


def _flat(tree, prefix=""):
    """``{"a/b": numpy}`` of a tree of tensors or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().cpu().numpy().copy()}
    return {prefix[:-1]: np.asarray(tree).copy()}


def _opt(eng):
    """The port engine's optimizer state by leaf name (the per-leaf lists
    follow each engine's own leaf order)."""
    names = list(port_ckpt.flatten_tree(eng.params))
    return {k: ({n: t.clone() for n, t in zip(names, v)}
                if isinstance(v, list) else v)
            for k, v in eng.opt_state.items()}


def _ref_engine():
    return ds.initialize(model=JaxLM(jax_preset("tiny", **MODEL)),
                         config=dict(CONFIG),
                         mesh=ds.build_mesh(devices=jax.devices()[:1]))[0]


def _port_engine(params=None, **over):
    return tds.initialize(
        TransformerLM(get_preset("tiny", **MODEL)), {**CONFIG, **over},
        model_parameters=(None if params is None
                          else params_from_numpy(params, device="cpu")),
        device="cpu")[0]


def _steps(eng, it, n):
    return [eng.train_batch(it) for _ in range(n)]


class _RefStateWriter:
    """Stands in for the reference's Orbax checkpointer (``ROADMAP.md`` §3:
    its multi-threaded save is an unsteady oracle in this suite): the
    reference's ``save_checkpoint`` and ``CheckpointManager.save`` run as
    they are, writing ``meta.json``, the manifest and ``latest``, while the
    tag's ``state/`` holds the reference's own non-Orbax export of the
    params (``save_16bit_model``)."""

    def __init__(self, engine):
        self.engine = engine

    def save(self, path, state, force=False):
        ref_ckpt.save_16bit_model(self.engine, path)

    def wait_until_finished(self):
        pass


def _run_both(tmp, monkeypatch):
    """Both packages from the same weights: the reference trains 4 steps
    straight, committing a tag through its ``CheckpointManager`` after 2;
    the port trains 2, commits a tag, trains 2 more, and a fresh port
    engine from other weights loads the tag and repeats those 2. Host
    copies of everything the checks read; the last engines stay for
    ``tensor_fragment``."""
    batches = _micro_batches(2)
    out = {"tmp": tmp, "batches": batches}

    jeng = _ref_engine()
    params0 = jax.device_get(jeng.params)
    it = itertools.cycle(batches)
    out["ref_before"] = _steps(jeng, it, STEPS)
    out["ref_saved"] = _flat(jax.device_get(jeng.params))
    with monkeypatch.context() as m:
        m.setattr(ref_ckpt, "_checkpointer",
                  lambda async_save=False: _RefStateWriter(jeng))
        ref_manager.CheckpointManager(str(tmp / "ref")).save(jeng)
    out["ref_after"] = _steps(jeng, it, STEPS)
    out["ref_final"] = _flat(jax.device_get(jeng.params))
    out["ref_engine"] = jeng

    teng = _port_engine(params0)
    it = itertools.cycle(batches)
    out["port_before"] = _steps(teng, it, STEPS)
    out["port_saved"] = _flat(teng.params)
    out["port_saved_opt"] = _opt(teng)
    port_manager.CheckpointManager(str(tmp / "port")).save(teng)
    out["port_after"] = _steps(teng, it, STEPS)
    out["port_final"] = _flat(teng.params)
    teng2 = _port_engine(seed=1)       # other weights until the load
    assert not np.array_equal(_flat(teng2.params)["embed/tokens"],
                              out["port_saved"]["embed/tokens"])
    out["port_loaded"] = teng2.load_checkpoint(str(tmp / "port"))
    out["port_loaded_opt"] = _opt(teng2)
    out["port_loaded_params"] = _flat(teng2.params)
    out["port_resumed"] = _steps(teng2, itertools.cycle(batches), STEPS)
    out["port_resumed_final"] = _flat(teng2.params)
    out["port_engine"] = teng2
    return out


def _check_loaded_state(runs):
    path, client = runs["port_loaded"]
    assert path.endswith(TAG) and client == {}
    for name, want in runs["port_saved"].items():
        assert np.array_equal(runs["port_loaded_params"][name], want), name
    saved, loaded = runs["port_saved_opt"], runs["port_loaded_opt"]
    assert saved.keys() == loaded.keys() and loaded["count"] == STEPS
    for key in ("mu", "nu"):
        assert saved[key].keys() == loaded[key].keys()
        for name, want in saved[key].items():
            assert torch.equal(loaded[key][name], want), (key, name)


def _check_resume_bit_for_bit(runs):
    assert runs["port_resumed"] == runs["port_after"]
    for name, want in runs["port_final"].items():
        assert np.array_equal(runs["port_resumed_final"][name], want), name


def _check_against_the_reference(runs):
    np.testing.assert_allclose(runs["port_before"], runs["ref_before"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(runs["port_resumed"], runs["ref_after"],
                               rtol=LOSS_RTOL)
    assert runs["port_resumed_final"].keys() == runs["ref_final"].keys()
    for name, want in runs["ref_final"].items():
        np.testing.assert_allclose(runs["port_resumed_final"][name], want,
                                   err_msg=name, **PARAM_TOL)
    eng = runs["port_engine"]
    assert eng.global_steps == 2 * STEPS
    assert eng.get_lr() == pytest.approx(runs["ref_engine"].get_lr(),
                                         rel=1e-6)


def _check_meta(runs):
    metas = [json.loads((runs["tmp"] / pkg / TAG / "meta.json").read_text())
             for pkg in ("ref", "port")]
    assert metas[0].keys() == metas[1].keys()
    assert metas[1] == metas[0]
    assert metas[1]["mesh_axes"] == {ax: 1 for ax in
                                     ("pp", "dp", "fsdp", "ep", "sp", "tp")}


def _check_consolidate(runs, tmp_path):
    """The port's ``consolidate_to_fp32`` has the names the reference's
    export wrote into its tag, and the reference's params at the save."""
    with np.load(runs["tmp"] / "ref" / TAG / "state" / "model_fp16.npz") as z:
        names = set(z.files)
    ref = runs["ref_saved"]
    assert names == set(ref)
    out = tmp_path / "fp32.npz"
    port = port_ckpt.consolidate_to_fp32(str(runs["tmp"] / "port"),
                                         output_file=str(out))
    assert port.keys() == names
    for name, want in ref.items():
        assert port[name].dtype == np.float32
        np.testing.assert_allclose(port[name], want, err_msg=name,
                                   **PARAM_TOL)
        assert np.array_equal(port[name], runs["port_saved"][name]), name
    with np.load(out) as z:                   # readable by name
        assert set(z.files) == names


def _check_params_only(runs):
    tree = port_ckpt.load_params_only(str(runs["tmp"] / "port"), tag=TAG)
    flat = _flat(tree)
    assert flat.keys() == runs["port_saved"].keys()
    for name, want in runs["port_saved"].items():
        assert np.array_equal(flat[name], want), name
    with pytest.raises(FileNotFoundError):
        port_ckpt.load_params_only(str(runs["tmp"]))


def _check_verify_across(runs, tmp_path):
    """Each package's ``verify_tag_dir`` accepts the tag the other's
    ``CheckpointManager`` committed, and the port's tag under the
    reference's ``write_manifest``, and rejects each once torn."""
    tags = []
    for writer in ("ref", "port"):
        tag = tmp_path / f"{writer}_tag"
        shutil.copytree(runs["tmp"] / writer / TAG, tag)
        tags.append((writer, tag))
    tag = tmp_path / "port_tag_ref_manifest"
    shutil.copytree(runs["tmp"] / "port" / TAG, tag)
    ref_manager.write_manifest(str(tag), STEPS)
    tags.append(("port, reference manifest", tag))
    for writer, tag in tags:
        for mod in (ref_manager, port_manager):
            ok, why = mod.verify_tag_dir(str(tag))
            assert ok, (writer, mod.__name__, why)
        tear_checkpoint_dir(str(tag), mode="truncate")
        for mod in (ref_manager, port_manager):
            ok, why = mod.verify_tag_dir(str(tag))
            assert not ok and "mismatch" in why, (writer, mod.__name__, why)


def _check_16bit(runs, tmp_path):
    ref = ref_ckpt.save_16bit_model(runs["ref_engine"], str(tmp_path / "r"))
    port = port_ckpt.save_16bit_model(runs["port_engine"],
                                      str(tmp_path / "p"))
    assert os.path.basename(port) == os.path.basename(ref) \
        == "model_fp16.npz"
    with np.load(ref) as r, np.load(port) as p:
        assert set(p.files) == set(r.files)
        for name in r.files:
            assert p[name].dtype == np.float16
            np.testing.assert_allclose(p[name].astype(np.float32),
                                       r[name].astype(np.float32),
                                       atol=2e-3, rtol=2e-3, err_msg=name)


def _check_tensor_fragment(runs):
    """The resumed engines of both packages: every param, Adam's mu and nu,
    a gradient after one forward/backward, and a write read back."""
    jeng, teng = runs["ref_engine"], runs["port_engine"]
    for name in runs["ref_final"]:
        np.testing.assert_allclose(
            port_tf.safe_get_full_fp32_param(teng, name),
            ref_tf.safe_get_full_fp32_param(jeng, name), err_msg=name,
            **PARAM_TOL)
        for key in ("mu", "nu"):
            got = port_tf.safe_get_full_optimizer_state(teng, name, key)
            want = ref_tf.safe_get_full_optimizer_state(jeng, name, key)
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, err_msg=f"{key} {name}",
                                       atol=1e-8, rtol=1e-3)
    assert port_tf.safe_get_full_optimizer_state(teng, "embed/tokens",
                                                 "trace") is None
    assert port_tf.safe_get_full_grad(teng, "embed/tokens") is None
    batch = runs["batches"][0]
    for eng in (jeng, teng):
        eng.backward(eng.forward(batch))
    for name in ("embed/tokens", "layers/attn/wq", "final_norm/scale"):
        np.testing.assert_allclose(port_tf.safe_get_full_grad(teng, name),
                                   ref_tf.safe_get_full_grad(jeng, name),
                                   err_msg=name, atol=1e-6, rtol=1e-3)
    value = np.linspace(-1, 1, 64, dtype=np.float32)
    for mod, eng in ((ref_tf, jeng), (port_tf, teng)):
        mod.safe_set_full_fp32_param(eng, ("final_norm", "scale"), value)
    np.testing.assert_array_equal(
        port_tf.safe_get_full_fp32_param(teng, "final_norm/scale"),
        ref_tf.safe_get_full_fp32_param(jeng, "final_norm/scale"))
    with pytest.raises(ValueError, match="shape mismatch"):
        port_tf.safe_set_full_fp32_param(teng, "final_norm/scale",
                                         np.zeros(3))


def test_round_trip_matches_the_reference(tmp_path, monkeypatch):
    """One test, so the reference's engine runs once per run of the suite
    (a module fixture would run again on every worker that takes one of its
    tests). Each check is its own function."""
    runs = _run_both(tmp_path / "ckpt", monkeypatch)
    _check_loaded_state(runs)
    _check_resume_bit_for_bit(runs)
    _check_against_the_reference(runs)
    _check_meta(runs)
    _check_consolidate(runs, tmp_path)
    _check_params_only(runs)
    _check_verify_across(runs, tmp_path)
    _check_16bit(runs, tmp_path)
    _check_tensor_fragment(runs)


@pytest.fixture(scope="module")
def port_tag(tmp_path_factory):
    """A port engine's committed tag after 2 steps, and its params then."""
    tmp = tmp_path_factory.mktemp("port_tag")
    eng = _port_engine()
    _steps(eng, itertools.cycle(_micro_batches(2)), STEPS)
    port_manager.CheckpointManager(str(tmp)).save(eng)
    return {"dir": tmp, "params": _flat(eng.params)}


# ---------------------------------------------------------------------------
# the port's own save paths and refusals
# ---------------------------------------------------------------------------

def test_async_save_round_trips_and_shutdown_joins(tmp_path):
    eng = _port_engine(checkpoint={"async_save": True})
    it = itertools.cycle(_micro_batches(2))
    _steps(eng, it, 1)
    eng.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    pending = eng._pending_ckpt
    assert pending is not None
    _steps(eng, it, 1)                      # steps on while it writes
    eng.shutdown()
    assert eng._pending_ckpt is None and not pending[0].is_alive()
    assert port_ckpt.read_latest_tag(str(tmp_path)) == "global_step1"
    eng2 = _port_engine(seed=1)
    path, client = eng2.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step1") and client == {"epoch": 3}
    assert eng2.global_steps == 1


def test_async_commit_error_reaches_the_caller(tmp_path, monkeypatch):
    eng = _port_engine(checkpoint={"async_save": True})

    def broken(path, flat):
        raise OSError("disk gone")

    monkeypatch.setattr(port_ckpt, "_write_tree", broken)
    eng.save_checkpoint(str(tmp_path))
    with pytest.raises(OSError, match="disk gone"):
        port_ckpt.finalize_pending(eng)
    assert port_ckpt.read_latest_tag(str(tmp_path)) is None


def test_load_without_latest_restores_nothing(tmp_path):
    eng = _port_engine()
    assert eng.load_checkpoint(str(tmp_path)) == (None, {})


def test_load_without_optimizer_states_keeps_fresh_moments(port_tag):
    eng = _port_engine(seed=1)
    eng.load_checkpoint(str(port_tag["dir"]), load_optimizer_states=False)
    assert eng.opt_state["count"] == 0 and eng.global_steps == STEPS
    assert all(not t.any() for t in eng.opt_state["mu"])
    flat = _flat(eng.params)
    for name, want in port_tag["params"].items():
        assert np.array_equal(flat[name], want), name


def test_load_refuses_another_models_checkpoint(port_tag):
    eng = tds.initialize(
        TransformerLM(get_preset("tiny", dtype="float32", num_layers=3)),
        dict(CONFIG), device="cpu")[0]
    with pytest.raises(ValueError, match="does not fit"):
        eng.load_checkpoint(str(port_tag["dir"]))


def test_init_inference_serves_an_engine_checkpoint(port_tag):
    model = TransformerLM(get_preset("tiny", **MODEL))
    ids = np.random.default_rng(4).integers(1, 256, (2, 9))
    from_ckpt = tds.init_inference(model, checkpoint=str(port_tag["dir"]),
                                   device="cpu")
    from_params = tds.init_inference(
        model, params=params_from_numpy(
            port_ckpt.unflatten_tree(port_tag["params"]), device="cpu"),
        device="cpu")
    got = from_ckpt.generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(got, from_params.generate(
        ids, max_new_tokens=8))
    assert got.shape == (2, 17)
    with pytest.raises(ValueError, match="needs the model"):
        tds.init_inference(checkpoint=str(port_tag["dir"]), device="cpu")


# ---------------------------------------------------------------------------
# chip_smoke's phase 13 at a tiny width on the CPU
# ---------------------------------------------------------------------------

CKPT_TINY = dict(hidden_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
                 intermediate_size=256, vocab_size=512, dtype="float32",
                 param_dtype="float32", max_seq_len=64)


def test_checkpoint_phase_runs_on_a_tiny_cpu_model(monkeypatch):
    """Every gate of phase 13 that runs off the card passes: the round trip
    bit for bit, the async commit after its manifest, the resilience
    drill, the served tokens (rows of 32 tokens, prompts of 9 and 20;
    launches are counted on the card only), and the crash-and-resume drill
    as two CPU subprocesses at ``tiny`` -- the reference's
    ``test_e2e_crash_torn_checkpoint_recovery`` without the elastic agent:
    run 0 tears the step-3 tag and hard-crashes in step 4 (exit 43), run 1
    falls back to the verified step-2 tag, heals one NaN step and reaches
    step 6 (``tools/crash_resume.check``)."""
    import chip_smoke

    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import flash_attention as tfa

    for name, value in (("CKPT_KERNELS", ()), ("CKPT_MODEL_KW", CKPT_TINY),
                        ("CKPT_SEQ", 32), ("CKPT_PROMPTS", (9, 20))):
        monkeypatch.setattr(chip_smoke, name, value)
    counts = chip_smoke.checkpoint(torch, tfa, _build.KERNELS,
                                   _build.reset_counts, device="cpu")
    assert counts == {}
