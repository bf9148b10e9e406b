"""The port's resilience layer (``deepspeed_tpu_torch.resilience``) on the
CPU: the retry policy, the config sections and the coordinator's
ThreadFleet scenarios against the JAX package's, then the scenarios of the
reference's ``tests/unit/test_resilience.py`` on tiny fp32 port engines with
the outcomes it asserts (the step guard, the checkpoint manager, async
commits, SIGTERM emergency saves, the hang watchdog), sanity checks, and
the refusals that stay. The reference runs no engine here: its checkpoint
saves are compared in one process in ``tests/test_torch_checkpoint.py``,
whose phase 13 test also runs the crash-and-resume drill
(``tools/crash_resume.py``) as CPU subprocesses.
"""

import dataclasses
import json
import os
import random
import signal
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import deepspeed_tpu.resilience as ref_res
import deepspeed_tpu.resilience.manager as ref_manager
import deepspeed_tpu_torch as tds
import deepspeed_tpu_torch.resilience as port_res
import deepspeed_tpu_torch.resilience.manager as port_manager
from deepspeed_tpu.config import from_config as jax_from_config
from deepspeed_tpu_torch import TransformerLM, get_preset
from deepspeed_tpu_torch.config import from_config
from deepspeed_tpu_torch.resilience import (ABORT, CONTINUE, SAVE,
                                            CoordinatedAbort, FaultInjector,
                                            InjectedCrash,
                                            ResilienceCoordinator,
                                            TooManyBadSteps, set_injector,
                                            tear_checkpoint_dir)
from deepspeed_tpu_torch.resilience.manager import (STAGING_FILE,
                                                    CheckpointManager,
                                                    verify_tag_dir)
from deepspeed_tpu_torch.runtime.checkpoint import (read_latest_tag,
                                                    write_latest_atomic)
from tests._torch_threads import one_torch_thread  # noqa: F401

PKGS = {"ref": ref_res, "port": port_res}
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_injector():
    """Every test starts and ends with an inert process-wide injector and
    its own SIGTERM disposition."""
    prev = signal.getsignal(signal.SIGTERM)
    set_injector(None)
    yield
    set_injector(None)
    signal.signal(signal.SIGTERM, prev)


def make_config(resilience=None, **over):
    cfg = {
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 1,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
        "zero_optimization": {"stage": 2},
        "steps_per_print": 100,
        "resilience": {"enabled": True, **(resilience or {})},
    }
    cfg.update(over)
    return cfg


def make_engine(**kw):
    eng, *_ = tds.initialize(TransformerLM(get_preset("tiny",
                                                      dtype="float32")),
                             make_config(**kw), device="cpu")
    return eng


def train_steps(engine, steps, seed=0):
    rng = np.random.default_rng(seed)
    fixed = {"input_ids": rng.integers(0, 256, (2, 32))}
    losses = []
    while len(losses) < steps:
        loss = engine.forward(fixed)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.detach()))
    return losses


def _roadmap_section_1() -> str:
    text = (ROOT / "ROADMAP.md").read_text()
    return text[text.index("### 1."):text.index("### 2.")]


# ---------------------------------------------------------------------------
# the retry policy and the config against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_retry_delay_sequence_equals_reference(seed):
    kw = dict(base_delay_s=0.1, multiplier=1.7, max_delay_s=1.5, jitter=0.3)
    seqs = {}
    for name, pkg in PKGS.items():
        rng = random.Random(seed)
        pol = pkg.RetryPolicy(**kw)
        seqs[name] = [pol.delay(a, rng) for a in range(10)]
        seqs[name + "/default"] = [pkg.RetryPolicy().delay(a, rng)
                                   for a in range(4)]
    assert seqs["port"] == seqs["ref"]
    assert seqs["port/default"] == seqs["ref/default"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_retry_call_outcomes(pkg):
    mod = PKGS[pkg]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    retries = []
    pol = mod.RetryPolicy(max_attempts=5, base_delay_s=0.001)
    assert mod.retry_call(flaky, policy=pol,
                          on_retry=lambda a, e: retries.append(a)) == "ok"
    assert len(calls) == 3 and retries == [0, 1]

    def down():
        raise OSError("down")

    with pytest.raises(mod.RetryDeadlineExceeded):
        mod.retry_call(down, policy=mod.RetryPolicy(max_attempts=2,
                                                    base_delay_s=0.001))

    def bug():
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        mod.retry_call(bug, policy=pol)


def _sections(cfg) -> dict:
    """The sections as dicts; the port's keys that it takes only at the
    reference's default count with that default."""
    out = {}
    for name in ("checkpoint", "resilience"):
        sec = getattr(cfg, name)
        out[name] = (sec.model_dump() if hasattr(sec, "model_dump")
                     else {**type(sec).UNPORTED, **dataclasses.asdict(sec)})
    out["sanity"] = (cfg.sanity_checks, cfg.sanity_check_batches)
    return out


def test_config_sections_default_like_reference():
    raw = {"resilience": {"enabled": True, "heartbeat": {"enabled": True,
                                                        "poll_s": 0.5}},
           "checkpoint": {"async_save": True}, "sanity_checks": True}
    for r in ({}, raw):
        assert _sections(from_config(dict(r))) == \
            _sections(jax_from_config(json.loads(json.dumps(r))))


@pytest.mark.parametrize("key,value", [
    ("use_node_local_storage", True), ("parallel_write_pipeline", True),
    ("tag_validation", "Fail"), ("load_universal", True)])
def test_unread_checkpoint_keys_refuse_other_values(key, value):
    """Nothing on one device reads these keys: their reference defaults
    pass, any other value names the ROADMAP title that ports it."""
    default = from_config({}).checkpoint.UNPORTED[key]
    from_config({"checkpoint": {key: default}})
    with pytest.raises(NotImplementedError,
                       match="Mesh, ZeRO and tensor parallelism"):
        from_config({"checkpoint": {key: value}})


def test_collective_deadline_takes_none_and_numbers_only():
    cfg = from_config({"resilience": {"heartbeat": {
        "collective_deadline_s": None}}})
    assert cfg.resilience.heartbeat.collective_deadline_s is None
    with pytest.raises(ValueError):
        from_config({"resilience": {"heartbeat": {"poll_s": 1.0,
                                                  "deadline_s": None}}})


@pytest.mark.parametrize("raw", [
    {"resilience": {"retry": {"max_atempts": 3}}},
    {"resilience": {"checkpoint": {"keep_last_k": "three"}}},
    {"resilience": {"heartbeat": {"enabled": [1]}}},
    {"resilience": {"heartbeat": {"deadline_s": "soon"}}},
    {"resilience": {"coordination": {"interval_steps": 2.5}}},
    {"resilience": {"faults": "nan"}},
    {"resilience": {"max_consecutive_bad_stepz": 2}},
    {"checkpoint": {"async_sav": True}},
    {"checkpoint": {"async_save": {}}},
    {"sanity_checks": [True]},
])
def test_config_bad_cases_raise_alike(raw):
    outcome = []
    for make in (jax_from_config, from_config):
        try:
            make(json.loads(json.dumps(raw)))
            outcome.append("accepted")
        except ValueError:
            outcome.append("ValueError")
    assert outcome == ["ValueError", "ValueError"]


# ---------------------------------------------------------------------------
# the coordinator's ThreadFleet scenarios on both packages
# ---------------------------------------------------------------------------

class ThreadFleet:
    """Barrier-backed max-reduce over N thread-simulated processes (the
    reference test's stand-in for a cross-process reduce)."""

    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=30)
        self.vals = [0] * n

    def reducer(self, rank):
        def reduce(code):
            self.vals[rank] = int(code)
            self.barrier.wait()
            out = max(self.vals)
            self.barrier.wait()
            return out
        return reduce

    def run(self, proc):
        errors = []

        def body(rank):
            try:
                proc(rank)
            except BaseException as e:  # noqa: BLE001 - surfaced below
                errors.append(e)

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        if errors:
            raise errors[0]


def _divergent_preempt(pkg):
    fleet = ThreadFleet(2)
    out = [None, None]

    def proc(rank):
        coord = pkg.ResilienceCoordinator(reduce_fn=fleet.reducer(rank))
        local = pkg.SAVE if rank == 0 else pkg.CONTINUE
        decision = coord.decide(5, local,
                                "preemption notice" if local else "")
        out[rank] = (decision, f"preempt_step{5}", coord.decision_record())

    fleet.run(proc)
    return out


def _peer_abort(pkg):
    fleet = ThreadFleet(3)
    out = [None] * 3

    def proc(rank):
        coord = pkg.ResilienceCoordinator(reduce_fn=fleet.reducer(rank))
        if rank == 1:
            coord.signal_abort("hang: stuck step")
        out[rank] = (coord.decide(7), coord.decision_record())

    fleet.run(proc)
    return out


def _abort_dominates_save(pkg):
    fleet = ThreadFleet(2)
    out = [None, None]

    def proc(rank):
        coord = pkg.ResilienceCoordinator(reduce_fn=fleet.reducer(rank))
        (coord.signal_save if rank == 0 else coord.signal_abort)("x")
        out[rank] = (coord.decide(3), coord.decision_record())

    fleet.run(proc)
    return out


def _interval_holds(pkg):
    coord = pkg.ResilienceCoordinator(reduce_fn=lambda c: c,
                                      interval_steps=2)
    coord.signal_save("preempt")
    return [coord.decide(3), coord.decide(4), coord.counters["collectives"],
            coord.decision_record()]


@pytest.mark.parametrize("scenario", [_divergent_preempt, _peer_abort,
                                      _abort_dominates_save, _interval_holds],
                         ids=["divergent-preempt", "peer-abort",
                              "abort-dominates-save", "interval-holds"])
def test_coordinator_scenarios_equal_reference(scenario):
    assert scenario(port_res) == scenario(ref_res)


def _fake_engine(step=5):
    """The engine surface ``CheckpointManager.save`` touches."""
    return SimpleNamespace(
        params={"w": torch.arange(4.0)},
        opt_state={"count": step, "mu": [torch.zeros(4)]},
        scaler_state={"scale": 1.0, "good_steps": 0},
        global_steps=step, global_samples=step * 8, micro_steps=step,
        skipped_steps=0, zero_stage=0, lr_scheduler=None, _pending_ckpt=None,
        config=SimpleNamespace(checkpoint=SimpleNamespace(async_save=False)))


def test_divergent_preempt_commits_identical_tags_with_the_decision(
        tmp_path):
    """Both simulated processes save the agreed tag; each manifest carries
    the decision, its step and the local reason, and the reference's
    ``verify_tag_dir`` accepts the port's tags."""
    decided = _divergent_preempt(port_res)
    for rank, (decision, tag, record) in enumerate(decided):
        assert decision == SAVE
        host = tmp_path / f"host{rank}"
        CheckpointManager(str(host)).save(_fake_engine(5), tag=tag,
                                          emergency=True, decision=record)
        assert read_latest_tag(str(host)) == tag == "preempt_step5"
        for mod in (port_manager, ref_manager):
            ok, why = mod.verify_tag_dir(str(host / tag))
            assert ok, why
        manifest = json.loads((host / tag / "manifest.json").read_text())
        assert manifest["coordination"] == record
        assert (manifest["coordination"]["decision"],
                manifest["coordination"]["step"]) == ("SAVE", 5)
    assert decided[0][2]["reason"] == "preemption notice"
    assert decided[1][2]["reason"] == "peer signal"


def test_signal_counters_survive_thread_contention():
    import sys

    coord = ResilienceCoordinator(reduce_fn=lambda c: c)
    n_threads, n_each = 8, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer():
            for _ in range(n_each):
                coord.signal_save("t")
                coord.signal_abort("t")
        ts = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert coord.counters["signals_save"] == n_threads * n_each
    assert coord.counters["signals_abort"] == n_threads * n_each
    assert coord.decide(0) == ABORT


def test_single_process_decides_locally():
    coord = ResilienceCoordinator()
    assert coord.decide(1) == CONTINUE
    coord.signal_save("drill")
    assert coord.decide(2) == SAVE
    coord.signal_abort("drill")
    assert coord.decide(3) == ABORT
    assert coord.report()["counters"]["collectives"] == 3


# ---------------------------------------------------------------------------
# the step guard
# ---------------------------------------------------------------------------

def test_nan_step_skipped_without_corrupting_state():
    eng = make_engine(scheduler={"type": "WarmupLR",
                                 "params": {"warmup_num_steps": 100}},
                      resilience={"faults": [{"kind": "nan_grads",
                                              "step": 2}]})
    train_steps(eng, 2)
    p_before = [t.detach().clone() for t in eng._leaves]
    o_before = {k: ([t.clone() for t in v] if isinstance(v, list) else v)
                for k, v in eng.opt_state.items()}
    lr_before = eng.get_lr()[0]
    train_steps(eng, 1)          # global_steps == 2: the fault fires
    assert eng.skipped_steps == 1 and eng.global_steps == 2
    for got, want in zip(eng._leaves, p_before):
        assert torch.equal(got, want)
    assert eng.opt_state["count"] == o_before["count"] == 2
    for key in ("mu", "nu"):
        for got, want in zip(eng.opt_state[key], o_before[key]):
            assert torch.equal(got, want)
    assert eng.get_lr()[0] == lr_before             # the LR rewind
    assert all(np.isfinite(train_steps(eng, 2, seed=5)))
    rep = eng.resilience_report()
    assert rep["guard"]["bad_steps_skipped"] == 1
    assert rep["faults_fired"] == ["nan_grads@grads:step=2"]
    assert eng.opt_state["count"] == 4
    eng.shutdown()


def test_persistent_nan_aborts(tmp_path, monkeypatch):
    monkeypatch.setenv("DSTPU_CHECKPOINT_DIR", str(tmp_path))
    eng = make_engine(resilience={
        "max_consecutive_bad_steps": 2,
        "faults": [{"kind": "nan_grads", "step": -1, "times": 99}]})
    with pytest.raises(TooManyBadSteps):
        train_steps(eng, 3)
    rep = json.loads((tmp_path / "resilience_report.json").read_text())
    assert rep["aborted"] is True
    assert rep["guard"]["bad_steps_skipped"] == 2
    assert rep["consecutive_bad_steps"] == 2
    eng.shutdown()


def test_injected_soft_crash():
    eng = make_engine(resilience={"faults": [{"kind": "crash", "step": 1}]})
    train_steps(eng, 1)
    with pytest.raises(InjectedCrash):
        train_steps(eng, 1)
    assert eng.resilience_report()["guard"]["injected_crashes_raised"] == 1
    eng.shutdown()


def test_fp16_overflow_calibration_not_aborted():
    """fp16 dynamic-scale walk-down overflows are the loss scaler working;
    they must not burn the guard's abort budget."""
    eng = make_engine(fp16={"enabled": True, "initial_scale_power": 126},
                      resilience={"max_consecutive_bad_steps": 1})
    losses = train_steps(eng, 3)
    assert eng.skipped_steps >= 1
    assert eng.scaler_state["scale"] < 2.0 ** 126
    assert eng.resilience_report()["guard"]["loss_scale_rewinds"] >= 1
    assert np.isfinite(losses[-1])
    eng.shutdown()


def test_fused_step_detects_a_nonfinite_loss():
    eng = make_engine(resilience={"max_consecutive_bad_steps": 1})
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 16))}
    eng.fused_train_step(batch)
    with torch.no_grad():
        eng.params["embed"]["tokens"].fill_(float("nan"))
    with pytest.raises(TooManyBadSteps):
        eng.fused_train_step(batch)
    assert eng.resilience_report()["guard"]["bad_steps_detected"] == 1


# ---------------------------------------------------------------------------
# the checkpoint manager
# ---------------------------------------------------------------------------

def test_latest_pointer_atomic(tmp_path):
    write_latest_atomic(str(tmp_path), "global_step1")
    write_latest_atomic(str(tmp_path), "global_step2")
    assert read_latest_tag(str(tmp_path)) == "global_step2"
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []


def test_manifest_verification(tmp_path):
    eng = make_engine()
    train_steps(eng, 1)
    eng.save_checkpoint(str(tmp_path))
    tag_dir = str(tmp_path / "global_step1")
    ok, why = verify_tag_dir(tag_dir)
    assert ok, why
    tear_checkpoint_dir(tag_dir, mode="corrupt")
    ok, why = verify_tag_dir(tag_dir)
    assert not ok and "mismatch" in why


def test_torn_newest_falls_back_to_previous_tag(tmp_path):
    eng = make_engine()
    train_steps(eng, 2)
    eng.save_checkpoint(str(tmp_path))          # global_step2 (good)
    train_steps(eng, 1)
    eng.save_checkpoint(str(tmp_path))          # global_step3 (newest)
    tear_checkpoint_dir(str(tmp_path / "global_step3"), mode="truncate")
    eng2 = make_engine()
    path, _ = eng2.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("global_step2")
    assert eng2.global_steps == 2
    rep = eng2.resilience_report()["checkpoint"]
    assert rep["verify_failures"] >= 1
    assert rep["load_fallbacks"] == 1
    assert read_latest_tag(str(tmp_path)) == "global_step2"


def test_keep_last_k_gc(tmp_path):
    eng = make_engine(resilience={"checkpoint": {"keep_last_k": 2}})
    (tmp_path / "tensorboard").mkdir()          # not a checkpoint: kept
    for _ in range(4):
        train_steps(eng, 1)
        eng.save_checkpoint(str(tmp_path))
    tags = sorted(d for d in os.listdir(tmp_path)
                  if os.path.isdir(tmp_path / d))
    assert tags == ["global_step3", "global_step4", "tensorboard"]
    assert eng.resilience_report()["checkpoint"]["gc_removed"] == 2
    for t in tags[:2]:
        ok, why = verify_tag_dir(str(tmp_path / t))
        assert ok, why


def test_io_error_retried(tmp_path):
    eng = make_engine(resilience={
        "retry": {"max_attempts": 3, "base_delay_s": 0.001},
        "faults": [{"kind": "io_error", "times": 2}]})
    train_steps(eng, 1)
    eng.save_checkpoint(str(tmp_path))
    assert eng.resilience_report()["checkpoint"]["io_retries"] == 2
    ok, why = verify_tag_dir(str(tmp_path / "global_step1"))
    assert ok, why


def test_legacy_checkpoint_loads_unverified(tmp_path):
    """A tag saved without resilience has no manifest; verification must
    warn and load it."""
    legacy = make_engine()
    legacy.config.resilience.enabled = False
    train_steps(legacy, 1)
    legacy.save_checkpoint(str(tmp_path))
    assert not (tmp_path / "global_step1" / "manifest.json").exists()
    eng2 = make_engine()
    path, _ = eng2.load_checkpoint(str(tmp_path))
    assert path is not None and eng2.global_steps == 1


def test_sigterm_emergency_save_is_loadable(tmp_path):
    eng = make_engine()
    train_steps(eng, 1)
    eng.save_checkpoint(str(tmp_path))      # creates the manager + handler
    assert eng._primary_mgr._preempt_handler_installed
    os.kill(os.getpid(), signal.SIGTERM)
    train_steps(eng, 1)                     # the boundary fires the save
    assert eng.resilience_report()["checkpoint"]["emergency_saves"] == 1
    tags = [d for d in os.listdir(tmp_path) if d.startswith("preempt")]
    assert tags == ["preempt_step2"]
    ok, why = verify_tag_dir(str(tmp_path / tags[0]))
    assert ok, why
    manifest = json.loads((tmp_path / tags[0] / "manifest.json").read_text())
    assert manifest["coordination"]["decision"] == "SAVE"
    eng2 = make_engine()
    path, _ = eng2.load_checkpoint(str(tmp_path))
    assert path.endswith("preempt_step2") and eng2.global_steps == 2
    assert np.isfinite(train_steps(eng2, 1, seed=3)[0])


# ---------------------------------------------------------------------------
# async checkpointing
# ---------------------------------------------------------------------------

ASYNC = {"checkpoint": {"async_save": True}}


def test_async_save_commits_in_background(tmp_path):
    eng = make_engine(resilience=dict(ASYNC), checkpoint={"async_save": True})
    train_steps(eng, 1)
    eng.save_checkpoint(str(tmp_path))
    mgr = eng._primary_mgr
    assert mgr.counters["async_saves"] == 1
    train_steps(eng, 1)                     # steps on while it commits
    mgr.drain()
    ok, why = verify_tag_dir(str(tmp_path / "global_step1"))
    assert ok, why
    assert read_latest_tag(str(tmp_path)) == "global_step1"
    assert not (tmp_path / "global_step1" / STAGING_FILE).exists()
    rep = eng.resilience_report()
    assert rep["checkpoint"]["async_saves"] == 1
    assert rep["checkpoint_async"]["commits"] == 1
    assert rep["checkpoint_async"]["last_latency_s"] > 0
    assert rep["comm"] == {"retries": 0, "inflight": None}
    assert rep["coordination"]["counters"]["collectives"] >= 1
    eng.shutdown()
    eng2 = make_engine()
    eng2.load_checkpoint(str(tmp_path))
    assert eng2.global_steps == 1


def test_crash_between_stage_and_commit_falls_back(tmp_path):
    eng = make_engine(resilience=dict(ASYNC))
    train_steps(eng, 2)
    eng.save_checkpoint(str(tmp_path))          # global_step2
    eng._primary_mgr.drain()
    train_steps(eng, 1)
    set_injector(FaultInjector([{"kind": "io_error",
                                 "site": "async_commit"}]))
    eng.save_checkpoint(str(tmp_path))          # global_step3: stage only
    eng._primary_mgr.drain(raise_on_error=False)
    set_injector(None)
    assert eng._primary_mgr.counters["async_commit_failures"] == 1
    assert (tmp_path / "global_step3" / STAGING_FILE).exists()
    assert not (tmp_path / "global_step3" / "manifest.json").exists()
    assert read_latest_tag(str(tmp_path)) == "global_step2"
    eng2 = make_engine(resilience=dict(ASYNC))
    path, _ = eng2.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("global_step2")
    assert eng2.global_steps == 2
    with pytest.raises(RuntimeError, match="uncommitted async stage"):
        eng2.load_checkpoint(str(tmp_path), tag="global_step3")
    assert eng2.resilience_report()["checkpoint"]["staged_rejected"] == 1
    eng2.shutdown()
    eng.shutdown()


def test_emergency_save_drains_pending_and_commits_sync(tmp_path):
    eng = make_engine(resilience=dict(ASYNC))
    train_steps(eng, 1)
    eng.save_checkpoint(str(tmp_path))          # async, maybe in flight
    os.kill(os.getpid(), signal.SIGTERM)
    train_steps(eng, 1)                         # boundary: agreed SAVE
    mgr = eng._primary_mgr
    assert mgr.counters["emergency_saves"] == 1
    assert mgr._pending_async is None
    ok, why = verify_tag_dir(str(tmp_path / "preempt_step2"))
    assert ok, why
    manifest = json.loads(
        (tmp_path / "preempt_step2" / "manifest.json").read_text())
    assert manifest["coordination"]["decision"] == "SAVE"
    assert manifest["coordination"]["step"] == 2
    eng.shutdown()


# ---------------------------------------------------------------------------
# the heartbeat and the hang watchdog
# ---------------------------------------------------------------------------

def _hb(tmp_path, **hb):
    base = {"enabled": True, "dir": str(tmp_path / "hb"),
            "interval_s": 0.05, "poll_s": 0.05,
            "deadline_s": 30.0, "collective_deadline_s": None}
    base.update(hb)
    return {"heartbeat": base}


def test_stall_escalates_to_coordinated_abort(tmp_path):
    eng = make_engine(resilience=_hb(tmp_path, deadline_s=0.4))
    train_steps(eng, 1)       # arm: stall detection needs one boundary
    time.sleep(0.8)           # wedge the step loop
    with pytest.raises(CoordinatedAbort):
        train_steps(eng, 1)
    rep = eng.resilience_report()
    assert rep["aborted"] is True
    assert rep["heartbeat"]["counters"]["hangs_detected"] == 1
    assert rep["coordination"]["last_reason"].startswith("hang")
    assert "no step boundary" in rep["heartbeat"]["last_cause"]
    hb = json.loads((tmp_path / "hb" / "heartbeat_0.json").read_text())
    assert hb["rank"] == 0 and hb["step"] >= 1 and hb["inflight"] is None
    eng.shutdown()
    assert not eng._watchdog._thread and not eng._heartbeat._thread


def test_startup_does_not_trip_stall_deadline(tmp_path):
    eng = make_engine(resilience=_hb(tmp_path, deadline_s=0.05))
    time.sleep(0.3)           # warm-up before the first boundary
    assert eng._watchdog.hang_detected is False
    assert np.isfinite(train_steps(eng, 1)[0])
    eng.shutdown()


def test_on_hang_abort_needs_coordination(tmp_path):
    res = _hb(tmp_path)
    res["coordination"] = {"enabled": False}
    with pytest.raises(ValueError, match="requires resilience.coordination"):
        make_engine(resilience=res)


# ---------------------------------------------------------------------------
# sanity checks, registry gauges, refusals
# ---------------------------------------------------------------------------

def test_sanity_checks_pass_and_catch_a_nan_param():
    from deepspeed_tpu_torch.runtime.sanity import (check_param_integrity,
                                                    check_param_placement)

    eng = make_engine(sanity_checks=True)
    assert not eng._first_batch_checked
    train_steps(eng, 1)
    assert eng._first_batch_checked
    with torch.no_grad():
        eng.params["final_norm"]["scale"][0] = float("inf")
    with pytest.raises(RuntimeError, match="final_norm/scale"):
        check_param_integrity(eng)
    eng.params["final_norm"]["scale"] = torch.ones(3, device="meta")
    with pytest.raises(RuntimeError, match="placed on meta"):
        check_param_placement(eng)


def test_resilience_counters_reach_the_registry():
    from deepspeed_tpu_torch.observability import get_registry

    eng = make_engine(steps_per_print=1, resilience={
        "faults": [{"kind": "nan_grads", "step": 1}]})
    train_steps(eng, 3)       # one skipped (injected), two committed
    fams = {f.name: f for f in get_registry().collect()}
    assert "resilience/skipped_steps" in fams
    assert "resilience/guard_bad_steps_skipped" in fams
    assert get_registry().gauge("resilience/skipped_steps").value == 1.0
    eng.shutdown()


def _refuse_kv_store():
    port_res.kv_store_max_reduce()


def _refuse_elasticity():
    from_config({"elasticity": {"enabled": True}})


def _refuse_hf_dir(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    tds.init_inference(TransformerLM(get_preset("tiny")),
                       checkpoint=str(tmp_path), device="cpu")


@pytest.mark.parametrize("refuse,item", [
    (_refuse_kv_store, "Mesh, ZeRO and tensor parallelism"),
    (_refuse_elasticity, "Remainder"), (_refuse_hf_dir, "Remainder")],
    ids=["kv-store-max-reduce", "elasticity", "hf-checkpoint-dir"])
def test_refusals_that_stay_name_their_roadmap_item(refuse, item, tmp_path):
    assert f"**{item}" in _roadmap_section_1()
    with pytest.raises(NotImplementedError,
                       match=f'ROADMAP section 1, "{item}"'):
        if refuse is _refuse_hf_dir:
            refuse(tmp_path)
        else:
            refuse()
