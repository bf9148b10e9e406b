"""The instruments of the port's ``InferenceEngineV2``, KV tier store,
swapper and training engine against the JAX package's, on the CPU.

Both serving engines get the same bridged weights (the ``tiny`` preset at
the ``tiny_features`` sizes of ``tests/test_torch_smoke.py``, fp32; the JAX
engine on its XLA twins), a fresh registry and a fresh event bus, and run
one script: prefix puts, ``decode_batch``, a demote and promote of every
cache block (host and NVMe tiers under ``tmp_path``), a pause/resume, an
export/adopt and speculative rounds. Equal between the two: every counter
and gauge value, every histogram's count and the multiset of (category,
name, phase) events, apart from the one difference the port states (it
never fuses a promote into a step: no ``promote_fence_fused`` instant,
``inference/decode_prologue_promotes`` 0). The fault drills (resume reads
failing on each tier, a failing migrate read, a torn manifest, a crash
inside the pause export, a failing NVMe swap read) give the same ``fired``
lists and the same unwinds, and a clean resume gives the unpaused tokens.
Greedy tokens are the same with the hooks on and off. A 2-step
``train_batch`` with observability on gives the reference's ``train/*``
family names and step counts. The last case runs chip_smoke's phase 10 on
a tiny CPU model.
"""

import collections
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.observability as ref_obs
import deepspeed_tpu.resilience.faults as ref_faults
from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.kv_tier import claim_manifest as jax_claim
from deepspeed_tpu.inference.kv_tier import load_manifest as jax_load
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
import deepspeed_tpu_torch.observability as port_obs
import deepspeed_tpu_torch.resilience.faults as port_faults
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference.kv_tier import (claim_manifest,
                                                   load_manifest)
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from tests._torch_threads import one_torch_thread  # noqa: F401

SIZES = dict(hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=128, vocab_size=512, dtype="float32",
             param_dtype="float32")
KW = dict(max_sequences=8, max_seq_len=128, block_size=16)
# 2 blocks of the pool's K and V pages (fp32, L=2, K*d=32, 16 rows): the
# host tier holds two, the rest spill to NVMe
BLOCK_BYTES = 2 * 2 * 16 * 32 * 4
HOST_MB = 2 * BLOCK_BYTES / 2**20
# the one stated difference: the reference folds promotes into its step's
# prologue (decode_kernel='pallas'), the port fences before each step
FUSED_ONLY_EVENTS = {("engine", "promote_fence_fused", "i")}
FUSED_ONLY_FAMILIES = {"inference/decode_prologue_promotes"}


@pytest.fixture(scope="module")
def weights():
    jm = JaxLM(jax_preset("tiny", **SIZES))
    params = jax.device_get(jm.init(jax.random.key(0)))
    return jm, params, TransformerLM(get_preset("tiny", **SIZES))


def _packages(weights):
    jm, params, tm = weights
    return {
        "ref": dict(obs=ref_obs, faults=ref_faults, claim=jax_claim,
                    load=jax_load,
                    make=lambda **kw: JaxEngine(jm, params=params,
                                                decode_kernel="xla",
                                                **{**KW, **kw})),
        "port": dict(obs=port_obs, faults=port_faults, claim=claim_manifest,
                     load=load_manifest,
                     make=lambda **kw: InferenceEngineV2(
                         tm, params_from_numpy(params, device="cpu"),
                         device="cpu", **{**KW, **kw})),
    }


def _traffic():
    rng = np.random.default_rng(16)
    prefix = rng.integers(1, 512, 32).astype(np.int32)       # 2 blocks
    shared = [np.concatenate([prefix, rng.integers(1, 512, n).astype(
        np.int32)]) for n in (5, 9, 17)]
    repeat = np.tile(rng.integers(1, 512, 5).astype(np.int32), 6)
    return shared, repeat


def _ints(a):
    return [int(x) for x in a]


def _argmax(out, uids):
    return [int(np.argmax(out[u])) for u in uids]


def _fresh(pkg, tmp, hooks: bool):
    """A fresh process registry and bus (tracing on with the hooks) and an
    inert injector, before any engine is built."""
    obs = pkg["obs"]
    obs.set_registry(None)
    bus = obs.configure_tracing(enabled=hooks, ring_size=4096, sample=1,
                                dump_dir=os.path.join(tmp, "flight"))
    bus.clear()
    pkg["faults"].set_injector(None)
    return bus


def _serve_script(pkg, tmp, hooks=True):
    """The engine script (see the module docstring). Returns the tokens,
    the registry snapshot, the bus events and a few reports."""
    bus = _fresh(pkg, tmp, hooks)
    shared, repeat = _traffic()
    tiers = {"enabled": True, "tiers": {
        "enabled": True, "host_mb": HOST_MB,
        "nvme_path": os.path.join(tmp, "nvme")}}
    eng = pkg["make"](prefix_cache=tiers,
                      speculative={"enabled": True, "max_draft": 3})
    if hooks:
        eng.enable_metrics()
    toks = {}
    # prefix puts: the first alone, then two that attach its prefix
    out = dict(eng.put([0], shared[:1]))
    out.update(eng.put([1, 2], shared[1:]))
    res = eng.decode_batch([0, 1, 2], _argmax(out, [0, 1, 2]), steps=4,
                           speculative=False)
    toks["decode"] = {u: _ints(res[u]) for u in (0, 1, 2)}
    eng.flush([0, 1, 2])
    # demote every cache block (host, then NVMe), then promote by a match
    pc = eng.prefix_cache
    demoted = pc.evictable_blocks()
    pc.evict(demoted)
    out = eng.put([3], shared[1:2])
    toks["promoted"] = _argmax(out, [3])
    eng.flush([3])
    # pause / resume
    out = eng.put([4], shared[2:3])
    res = eng.decode_batch([4], _argmax(out, [4]), steps=2,
                           speculative=False)
    t = _ints(res[4])
    pause_ok = eng.pause_request(4)
    paused_blocks = eng.paused_blocks(4)
    paused = (pause_ok, eng.resume_request(4), eng.flush_resumes())
    t += _ints(eng.decode_batch([4], [t[-1]], steps=2,
                                speculative=False)[4])
    toks["pause"] = t
    eng.flush([4])
    # speculative decode and one verify round
    out = eng.put([6], [repeat])
    t0 = _argmax(out, [6])[0]
    spec = _ints(eng.decode_batch([6], [t0], steps=6)[6])
    res, info = eng.spec_decode_round([6], [spec[-1]], drafts=[spec[:2]])
    toks["spec"] = spec + _ints(res[6])
    eng.flush([6])
    report = {k: v for k, v in eng.tier_report().items()
              if k != "fused_prologue_dispatches_saved"}
    fallback_steps = eng.spec_stats["fallback_steps"]
    eng.close()
    # export / adopt across two engines on one shared namespace
    shared_dir = os.path.join(tmp, "migrate")
    x, y = pkg["make"](), pkg["make"]()
    x.migration_nvme_path = y.migration_nvme_path = shared_dir
    out = x.put([5], shared[:1])
    t = _ints(x.decode_batch([5], _argmax(out, [5]), steps=2)[5])
    x.pause_request(5)
    path = x.export_paused(5, "x-5", shared_dir, keep=False)
    x.flush([5])
    claimed = pkg["claim"](path)
    y.adopt_paused(9, pkg["load"](claimed), manifest_path=claimed)
    y.resume_request(9)
    t += _ints(y.decode_batch([9], [t[-1]], steps=2)[9])
    toks["migrate"] = t
    y.flush([9])
    x.close()
    y.close()
    snap = pkg["obs"].get_registry().snapshot()
    events = [(e.cat, e.name, e.ph) for e in bus.events()]
    doc = pkg["obs"].trace_export(bus)
    valid = pkg["obs"].validate_trace(doc)
    synthetic = [e for e in doc["traceEvents"]
                 if e.get("args", {}).get("synthetic_end")]
    pkg["obs"].configure_tracing(enabled=False)
    bus.clear()
    return dict(toks=toks, snap=snap, events=events, valid=valid,
                synthetic=synthetic, report=report, demoted=demoted,
                paused=paused, paused_blocks=paused_blocks, info=info,
                fallback_steps=fallback_steps)


@pytest.fixture(scope="module")
def served(weights, tmp_path_factory):
    pkgs = _packages(weights)
    out = {k: _serve_script(p, str(tmp_path_factory.mktemp(k)))
           for k, p in pkgs.items()}
    out["port_off"] = _serve_script(pkgs["port"],
                                    str(tmp_path_factory.mktemp("off")),
                                    hooks=False)
    return out


def _values(snap):
    """Counters and gauges by (family, labels) -> value; histograms ->
    count."""
    out = {}
    for name, fam in snap.items():
        for s in fam["series"]:
            key = (name, tuple(sorted(s["labels"].items())))
            out[key] = s["count"] if fam["type"] == "histogram" \
                else s["value"]
    return out


def test_registry_values_equal_reference(served):
    ref, port = _values(served["ref"]["snap"]), _values(served["port"]["snap"])
    fused = {k for k in ref if k[0] in FUSED_ONLY_FAMILIES}
    assert {k: port[k] for k in fused} == {k: 0.0 for k in fused}
    assert {k: v for k, v in port.items() if k not in fused} == \
        {k: v for k, v in ref.items() if k not in fused}
    assert {n: f["type"] for n, f in served["port"]["snap"].items()} == \
        {n: f["type"] for n, f in served["ref"]["snap"].items()}


def test_registry_counts_follow_the_traffic(served):
    """The port's registry against the script's own traffic: tokens run
    through the model by ``put`` (prefix hits skip it), tokens of the fused
    decode scans, hit tokens, demotions into each tier, promotes."""
    v, p = _values(served["port"]["snap"]), served["port"]
    assert v[("inference/tokens", ())] == 37 + (9 + 17) + 9 + 1 + 30
    assert v[("inference/decode_tokens", ())] == 3 * 4 + 2 + 2 + \
        p["fallback_steps"]
    assert v[("inference/prefix_cache_hit_tokens", ())] == 32 * 3 + 48
    assert v[("inference/prefix_cache_tier_demotions",
              (("tier", "host"),))] == p["demoted"] + p["paused_blocks"]
    assert v[("inference/prefix_cache_tier_demotions",
              (("tier", "nvme"),))] == p["report"]["nvme_demotions"] > 0
    assert sum(v[("inference/prefix_cache_tier_promote_ms", (("tier", t),))]
               for t in ("host", "nvme")) == 3
    assert v[("offload/swap_in_ms", ())] > 0    # NVMe entries came back
    assert v[("inference/put_host_ms", ())] == \
        v[("inference/put_fetch_ms", ())] == 5


def test_event_multiset_equals_reference(served):
    ref = collections.Counter(served["ref"]["events"])
    port = collections.Counter(served["port"]["events"])
    for key in FUSED_ONLY_EVENTS:
        ref.pop(key, None)
        assert key not in port
    assert port == ref
    names = {(c, n) for c, n, _ in port}
    assert {("engine", "put"), ("engine", "decode_batch"),
            ("engine", "spec_verify"), ("engine", "promote_fence"),
            ("engine", "prefix_attach"), ("kv_tier", "promote_attach"),
            ("kv_tier", "demote"), ("kv_tier", "spill"),
            ("kv_tier", "kv_fetch"), ("kv_tier", "pause"),
            ("kv_tier", "resume_start"), ("kv_tier", "resume_upload"),
            ("kv_tier", "pause_export"), ("kv_tier", "adopt"),
            ("kv_tier", "durable_export"), ("kv_tier", "durable_adopt"),
            ("aio", "swap_op")} <= names


def test_trace_is_valid_and_balanced(served):
    for k in ("ref", "port"):
        assert served[k]["valid"] == [] and served[k]["synthetic"] == []


def test_tokens_and_reports_equal_reference_and_hooks_off(served):
    assert served["port"]["toks"] == served["ref"]["toks"]
    assert served["port_off"]["toks"] == served["port"]["toks"]
    # the store's counters (its buffer pool is the port's own: staging
    # buffers come from it, where the reference stages in numpy arrays)
    ref_rep = served["ref"]["report"]
    assert {k: v for k, v in served["port"]["report"].items()
            if k != "pool"} == {k: v for k, v in ref_rep.items()
                                if k in served["port"]["report"]
                                and k != "pool"}
    assert served["port"]["paused"] == served["ref"]["paused"] == \
        (True, True, [])
    assert served["port"]["info"] == served["ref"]["info"]
    off = served["port_off"]
    assert off["events"] == [] and not any(
        n.startswith("inference/put") for n in off["snap"])


# ---------------------------------------------------------------------------
# fault drills
# ---------------------------------------------------------------------------

def _drill_script(pkg, tmp):
    """The fault table, one drill at a time on one engine pair (no prefix
    cache; the pause store holds two blocks on the host and spills the
    rest to the shared NVMe namespace). Returns per drill: the injector's
    fired list and the observable unwind."""
    _fresh(pkg, tmp, hooks=True)
    F = pkg["faults"]
    shared, _ = _traffic()
    prompt = shared[2]                          # 49 tokens: 4 blocks
    mig = os.path.join(tmp, "mig")
    eng, other = pkg["make"](), pkg["make"]()
    for e in (eng, other):
        e.pause_store_mb = HOST_MB
        e.migration_nvme_path = mig
    alloc = eng.state.allocator

    def start(uid):
        out = eng.put([uid], [prompt])
        t = _ints(eng.decode_batch([uid], _argmax(out, [uid]), steps=2)[uid])
        return t

    def outcome(e, uid, failed):
        return dict(failed=failed, paused=e.is_paused(uid),
                    live=uid in e.state.sequences,
                    leaked=e.state.allocator.leaked_blocks(),
                    entries=e._tier_store.entries())

    out = {}
    # clean: the unpaused tokens, then a pause/resume that must give them
    ref_toks = start(1)
    ref_toks += _ints(eng.decode_batch([1], [ref_toks[-1]], steps=2)[1])
    eng.flush([1])
    got = start(1)
    assert eng.pause_request(1) and eng.resume_request(1)
    clean_failed = eng.flush_resumes()
    got += _ints(eng.decode_batch([1], [got[-1]], steps=2)[1])
    eng.flush([1])
    out["clean"] = (ref_toks, got, clean_failed)
    # resume reads failing on each tier
    for tier in ("host", "nvme"):
        inj = F.set_injector(F.FaultInjector(
            [{"kind": "resume_io_error", "site": tier}]))
        start(2)
        eng.pause_request(2)
        resumed = eng.resume_request(2)
        out[f"resume_{tier}"] = (inj.fired, resumed,
                                 outcome(eng, 2, eng.flush_resumes()))
        F.set_injector(None)
    # a swap read failing at submission (the NVMe entries' fetch start)
    # (twice: the chain's batched read falls back to per-block reads)
    inj = F.set_injector(F.FaultInjector(
        [{"kind": "io_error", "site": "swap_read", "times": 2}]))
    start(3)
    eng.pause_request(3)
    resumed = eng.resume_request(3)
    out["swap_read"] = (inj.fired, resumed,
                        outcome(eng, 3, eng.flush_resumes()))
    F.set_injector(None)
    # a migrate read failing on the adopter
    inj = F.set_injector(F.FaultInjector([{"kind": "migrate_io_error"}]))
    start(4)
    eng.pause_request(4)
    path = eng.export_paused(4, "x-4", mig, keep=False)
    eng.flush([4])
    claimed = pkg["claim"](path)
    other.adopt_paused(40, pkg["load"](claimed), manifest_path=claimed)
    resumed = other.resume_request(40)
    out["migrate"] = (inj.fired, resumed,
                      outcome(other, 40, other.flush_resumes()),
                      os.path.exists(claimed))
    F.set_injector(None)
    # a torn manifest: adoption rejects it on the sha check
    inj = F.set_injector(F.FaultInjector(
        [{"kind": "manifest_torn", "site": "x-5"}]))
    start(5)
    eng.pause_request(5)
    path = eng.export_paused(5, "x-5", mig, keep=True)
    try:
        pkg["load"](pkg["claim"](path))
        rejected = None
    except Exception as e:                      # ManifestError
        rejected = type(e).__name__
    eng.flush([5])
    out["torn"] = (inj.fired, rejected, outcome(eng, 5, []))
    F.set_injector(None)
    # a crash between the durable demote and the manifest commit
    inj = F.set_injector(F.FaultInjector(
        [{"kind": "crash_during_pause_export", "site": "x-6"}]))
    start(6)
    eng.pause_request(6)
    try:
        eng.export_paused(6, "x-6", mig)
        crashed = None
    except F.InjectedCrash as e:
        crashed = str(e)
    left = sorted(f for f in os.listdir(os.path.join(mig, "kv"))
                  if "x-6" in f)
    still = eng.is_paused(6)
    eng.flush([6])
    out["export_crash"] = (inj.fired, crashed, left, still,
                           outcome(eng, 6, []))
    F.set_injector(None)
    out["free"] = alloc.free_blocks == alloc.num_blocks
    eng.close()
    other.close()
    return out


@pytest.fixture(scope="module")
def drilled(weights, tmp_path_factory):
    return {k: _drill_script(p, str(tmp_path_factory.mktemp(f"drill_{k}")))
            for k, p in _packages(weights).items()}


@pytest.mark.parametrize("drill", ["resume_host", "resume_nvme",
                                   "swap_read", "migrate", "torn",
                                   "export_crash"])
def test_fault_drill_equals_reference(drilled, drill):
    assert drilled["port"][drill] == drilled["ref"][drill]
    fired = drilled["port"][drill][0]
    assert len(fired) == (2 if drill == "swap_read" else 1), fired


def test_fault_drills_unwind_and_clean_resume_gives_unpaused_tokens(drilled):
    p = drilled["port"]
    want, got, failed = p["clean"]
    assert got == want and failed == []
    assert p["clean"] == drilled["ref"]["clean"]
    for drill, uid in (("resume_host", 2), ("resume_nvme", 2),
                       ("swap_read", 3)):
        o = p[drill][2]
        assert o["failed"] == [uid] and not o["paused"] and not o["live"]
        assert o["leaked"] == [] and o["entries"] == 0, (drill, o)
    assert p["resume_host"][0] == ["resume_io_error@resume:host:step=-1"]
    assert p["resume_nvme"][0] == ["resume_io_error@resume:nvme:step=-1"]
    assert p["migrate"][2]["failed"] == [40] and not p["migrate"][3]
    assert p["torn"][1] == "ManifestError"
    assert p["export_crash"][1] is not None and p["export_crash"][2] == []
    assert p["export_crash"][3] and p["free"]


# ---------------------------------------------------------------------------
# training engine
# ---------------------------------------------------------------------------

TRAIN = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
         "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
         "steps_per_print": 2, "bf16": {"enabled": False},
         "observability": {"enabled": True, "train_breakdown": True,
                           "tracing": {"enabled": True}}}


def _train_report(pkg_name, weights, tmp):
    rng = np.random.default_rng(3)
    batches = [{"input_ids": rng.integers(1, 512, (2, 16)).astype(np.int32)}
               for _ in range(4)]
    cfg = {**TRAIN, "observability": {**TRAIN["observability"], "tracing": {
        "enabled": True, "dump_dir": os.path.join(tmp, pkg_name)}}}
    if pkg_name == "ref":
        import deepspeed_tpu as ds

        obs = ref_obs
        obs.set_registry(None)
        model = JaxLM(jax_preset("tiny", **SIZES))
        eng, *_ = ds.initialize(model=model, config=cfg,
                                mesh=ds.build_mesh(devices=jax.devices()[:1]))
    else:
        import deepspeed_tpu_torch as tds

        obs = port_obs
        obs.set_registry(None)
        eng, *_ = tds.initialize(model=TransformerLM(get_preset(
            "tiny", **SIZES)), config=cfg, device="cpu")
    it = iter(batches)
    losses = [eng.train_batch(it) for _ in range(2)]
    rep = eng.observability_report()
    g = {n: obs.get_registry().gauge(n).value
         for n in ("train/steps", "train/samples", "train/skipped_steps",
                   "train/comm_ms")}
    timed = {n: obs.get_registry().gauge(n).value > 0
             for n in ("train/step_ms", "train/fwd_ms", "train/bwd_ms",
                       "train/optimizer_ms", "train/loss")}
    steps = [e.args["step"] for e in obs.get_bus().events(["train"])]
    obs.configure_tracing(enabled=False)
    obs.get_bus().clear()
    eng.shutdown()
    return rep, g, timed, steps, losses


def test_training_engine_train_families_equal_reference(weights, tmp_path):
    ref = _train_report("ref", weights, str(tmp_path))
    port = _train_report("port", weights, str(tmp_path))
    assert port[0] == ref[0]
    assert port[0]["enabled"] and port[0]["breakdown"]
    assert [f for f in port[0]["families"] if f.startswith("train/")] == [
        "train/bwd_ms", "train/checkpoint_ms", "train/comm_ms",
        "train/fwd_ms", "train/loss", "train/lr", "train/optimizer_ms",
        "train/samples", "train/skipped_steps", "train/step_ms",
        "train/steps"]
    assert port[1] == ref[1] == {"train/steps": 2.0, "train/samples": 8.0,
                                 "train/skipped_steps": 0.0,
                                 "train/comm_ms": 0.0}
    assert port[2] == ref[2]
    assert port[3] == ref[3] == [1, 2]


# ---------------------------------------------------------------------------
# chip_smoke's phase 10 on the CPU
# ---------------------------------------------------------------------------

def test_observability_phase_runs_on_a_tiny_cpu_model(monkeypatch):
    """Phase 10 on llama3-8b's preset at the ``tiny_features`` sizes (2
    layers, 64 wide, fp32; phase 9's traffic cut to a 256-token prefix,
    max_seq_len 640, 4 decode steps, pause calls of 3): the greedy tokens
    of phase 9 (a)'s engine with the hooks off come from the same engine
    settings here, and every gate that runs off the card passes (the
    launch counts and the kernel's name in the capture need the card)."""
    import chip_smoke
    from deepspeed_tpu_torch.ops import _build

    monkeypatch.setattr(chip_smoke, "FEATURE_PREFIX", 256)
    monkeypatch.setattr(chip_smoke, "FEATURE_MAX_SEQ", 640)
    monkeypatch.setattr(chip_smoke, "FEATURE_STEPS", 4)
    monkeypatch.setattr(chip_smoke, "PAUSE_CALLS", (3, 3, 3))
    cfg = get_preset("llama3-8b", **{**SIZES, "vocab_size": 512})
    model = TransformerLM(cfg)
    tree = chip_smoke.serve_params(torch, cfg, "cpu")
    host_mb = (chip_smoke.TIER_HOST_BLOCKS * 2 * cfg.num_layers * 128
               * cfg.num_kv_heads * cfg.head_dim * 4 / 2**20)
    shared, _, _ = chip_smoke.feature_traffic(cfg.vocab_size)
    tmp = tempfile.mkdtemp(prefix="dstpu_test_")
    try:
        port_obs.configure_tracing(enabled=False)
        off = InferenceEngineV2(
            model, tree, max_sequences=8, max_seq_len=640, block_size=128,
            device="cpu", speculative={"enabled": False},
            prefix_cache={"enabled": True, "tiers": {
                "enabled": True, "host_mb": host_mb,
                "nvme_path": os.path.join(tmp, "nvme")}})
        _, greedy = chip_smoke.cold_then_warm(off, shared, [0, 1, 2, 3],
                                              cfg.vocab_size)
        off.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    chip_smoke.observability(torch, _build.KERNELS, _build.reset_counts,
                             model, tree, greedy, host_mb, device="cpu")
    assert not port_obs.get_bus().enabled
