"""The port's elastic fleet (``deepspeed_tpu_torch/serving/fleet.py``,
``coldstart.py``), the modules the warm-start cache keys on
(``parallel/cost_model.py``, ``autotuning/mesh_store.py``), the AIO
autotune bench (``ops/aio_bench.py``) and the ``serving.fleet`` config
against the JAX package's, on the CPU.

Where a case is pure host logic it runs on both packages on the same
inputs and the two outcome records must be equal: the config's defaults
and validator, the cost model's figures and the model signature, the
tuning caches' robustness cases of the reference's
``tests/unit/test_store_robustness.py``, and the autoscaler's decisions on
the reference's stub router (``tests/unit/test_fleet.py``). The warm-start
cache's cases of ``test_fleet.py`` run on the port, and a cache one package
publishes loads in the other into an equal tree (bf16 leaves included).
The crash -> respawn -> readmit case runs the port's tiny engine alone and
checks the outcomes the reference test asserts; the four drills run in
``slow`` wrappers, as the reference's do.
"""

import dataclasses
import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from tests._torch_threads import one_torch_thread  # noqa: F401

TERMINAL = ("completed", "shed", "expired")
PKGS = ("jax", "torch")


def _pkg(name):
    """One package's modules under common names."""
    if name == "jax":
        from deepspeed_tpu import observability
        from deepspeed_tpu.autotuning import mesh_store
        from deepspeed_tpu.config import config
        from deepspeed_tpu.models import TransformerLM, get_preset
        from deepspeed_tpu.offload import swap
        from deepspeed_tpu.ops import aio_bench
        from deepspeed_tpu.parallel import cost_model
        from deepspeed_tpu.serving import coldstart, fleet
    else:
        from deepspeed_tpu_torch import observability
        from deepspeed_tpu_torch.autotuning import mesh_store
        from deepspeed_tpu_torch.config import config
        from deepspeed_tpu_torch.models import TransformerLM, get_preset
        from deepspeed_tpu_torch.offload import swap
        from deepspeed_tpu_torch.ops import aio_bench
        from deepspeed_tpu_torch.parallel import cost_model
        from deepspeed_tpu_torch.serving import coldstart, fleet
    return types.SimpleNamespace(**{k: v for k, v in locals().items()
                                    if k != "name"})


def both(fn, *args):
    """``fn(package, *args)`` on the reference and on the port; the two
    outcome records must be equal. Returns the port's."""
    ref, port = (fn(_pkg(p), *args) for p in PKGS)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# serving.fleet
# ---------------------------------------------------------------------------

def test_fleet_config_defaults_match_reference():
    from deepspeed_tpu.config.config import FleetConfig as Ref
    from deepspeed_tpu.config.config import ServingConfig as RefServing
    from deepspeed_tpu_torch.config import (FleetConfig, ServingConfig,
                                            from_config)

    ref = Ref().model_dump()
    port = FleetConfig()
    assert {k: getattr(port, k) for k in ref} == ref
    assert ServingConfig().fleet.min_ready_floor \
        == RefServing().fleet.min_ready_floor
    cfg = from_config({"serving": {"enabled": True, "fleet": {
        "enabled": True, "max_replicas": 3, "heartbeat_timeout_s": 2.5}}})
    assert cfg.serving.fleet.enabled and cfg.serving.fleet.max_replicas == 3
    assert cfg.serving.fleet.heartbeat_timeout_s == 2.5
    with pytest.raises(ValueError, match="max_replica"):
        from_config({"serving": {"fleet": {"max_replica": 3}}})


@pytest.mark.parametrize("bad", [
    {"min_replicas": 0},
    {"min_replicas": 4, "max_replicas": 2},
    {"heartbeat_timeout_s": 0.0},
    {"max_respawns": 0},
    {"scale_up_polls": 0},
    {"probe_timeout_s": 0.0},
    {"respawn_backoff_s": -1.0},
    {"scale_down_idle_polls": 0},
    {"scale_up_queue_per_replica": -1.0},
    {"min_ready_floor": 0},
    {"probe_max_new_tokens": 0},
], ids=lambda b: "-".join(f"{k}={v}" for k, v in b.items()))
def test_fleet_config_bad_cases_raise_alike(bad):
    """Every bad case of the reference's ``TestFleetConfig`` (and the rest
    of its validator) raises in both packages."""
    def outcome(p):
        with pytest.raises(ValueError) as e:
            p.config.FleetConfig(**bad)
        # the reference wraps the message in pydantic's report: compare
        # the validator's own text
        text = str(e.value).split("serving.fleet", 1)[1]
        return text.split("\n")[0].split(" [type=")[0]

    both(outcome)


# ---------------------------------------------------------------------------
# the cost model, the model signature and the warm key
# ---------------------------------------------------------------------------

PRESETS = ("tiny", "llama3-1b", "llama3-8b")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("preset", PRESETS)
def test_model_signature_and_warm_key_match_reference(preset):
    def keys(p):
        model = p.TransformerLM(p.get_preset(preset))
        prof = p.cost_model.ModelProfile.from_model(model)
        return (p.cost_model.model_signature(prof),
                p.coldstart.warm_key(model, world=1, device_kind=H100),
                p.coldstart.warm_key(model, world=4, device_kind="cpu"),
                p.mesh_store.device_kind(), dataclasses.asdict(prof))

    sig, key, *_ = both(keys)
    assert key == f"{sig}|w1|{H100}|z0"


def _cost_figures(p):
    cm = p.cost_model
    out = {}
    for preset in ("tiny", "llama3-8b", "tiny-moe"):
        prof = cm.ModelProfile.from_transformer_config(p.get_preset(preset))
        model = cm.CostModel()
        for world in (1, 8):
            meshes = cm.enumerate_meshes(world, prof)
            rows = []
            for mesh in meshes:
                for kw in ({}, {"zero_stage": 3, "micro_batches": 4},
                           {"zero_stage": 3, "zero_pp": {
                               "enabled": True, "qwz": True, "qgz": True,
                               "weight_bits": 4, "grad_bits": 8}},
                           {"ici_sizes": {"fsdp": 2, "tp": 2, "ep": 2}}):
                    rows.append(model.predict(prof, mesh, **kw))
                rows.append(model.predict_throughput(prof, mesh,
                                                     micro_batch=2))
            out[(preset, world)] = (meshes, rows,
                                    cm.rank_meshes(prof, world))
        out[(preset, "a2a")] = cm.moe_a2a_bytes(
            96.0, prof.hidden, 2, 8, quant_bits=4, block_size=512,
            ici_size=4)
    samples = [{"step_s": 0.1 * (i + 1), "flops": 1e12 * (i + 1),
                "ici_bytes": 3e9 * (i % 3), "dcn_bytes": 0.0,
                "bubble_frac": 0.1 * (i % 2)} for i in range(5)]
    out["fit"] = cm.fit_bandwidths(samples).as_dict()
    return out


def test_cost_model_matches_reference():
    """``enumerate_meshes``, ``predict`` (ZeRO stages, ZeRO++ wire ratios,
    slow-link axes, pipeline bubbles), ``predict_throughput``,
    ``rank_meshes``, ``moe_a2a_bytes`` and ``fit_bandwidths`` give the
    reference's figures on the same inputs, at world 1 and 8."""
    out = both(_cost_figures)
    assert out[("tiny", 1)][0] == [{}]
    assert len(out[("llama3-8b", 8)][0]) > 4


@pytest.mark.parametrize("n,bits,block", [
    (4096, 8, 2048), (4096, 4, 2048), (6144, 4, 512), (100, 4, 64),
    (4097, 4, 2048), (7 * 2048, 8, 2048), (1, 4, 2048)])
def test_wire_bytes_copy_matches_reference(n, bits, block):
    from deepspeed_tpu.comm.quantized import wire_bytes as ref
    from deepspeed_tpu_torch.parallel.cost_model import wire_bytes

    assert wire_bytes(n, bits, block) == ref(n, bits, block)


# ---------------------------------------------------------------------------
# the on-disk tuning caches (tests/unit/test_store_robustness.py)
# ---------------------------------------------------------------------------

def _winner_corrupt(p, d):
    st = p.mesh_store.WinnerStore(os.path.join(d, "winners.json"))
    with open(st.path, "w") as f:
        f.write("{definitely not json")
    got = st.get("sig", 8, "cpu")
    st.put("sig", 8, "cpu", {"dp": 8}, 123.0)   # put() heals the file
    return got, st.get("sig", 8, "cpu")["metric"]


def _winner_torn(p, d):
    st = p.mesh_store.WinnerStore(os.path.join(d, "winners.json"))
    st.put("sig", 8, "cpu", {"dp": 8, "tp": 1}, 123.0)
    rec = dict(st.get("sig", 8, "cpu"))
    rec.pop("iso_time")
    size = os.path.getsize(st.path)
    with open(st.path, "r+b") as f:
        f.truncate(size // 2)
    return rec, st.get("sig", 8, "cpu")


def _winner_schema(p, d):
    st = p.mesh_store.WinnerStore(os.path.join(d, "winners.json"))
    with open(st.path, "w") as f:
        json.dump({"schema": 999, "winners": {"x": {}}}, f)
    return st.get("sig", 8, "cpu")


def _winner_missing(p, d):
    return p.mesh_store.WinnerStore(os.path.join(d, "w.json")).get(
        "sig", 8, "cpu")


def _winner_concurrent(p, d):
    st = p.mesh_store.WinnerStore(os.path.join(d, "winners.json"))
    errors = []

    def hammer(i):
        try:
            for j in range(10):
                st.put(f"sig{i}", 8, "cpu", {"dp": 8}, float(i * 10 + j))
        except Exception as e:   # pragma: no cover - the failure mode
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(st.path) as f:
        data = json.load(f)     # valid JSON: no torn merge state
    rec = st.get("sig0", 8, "cpu")
    return (errors, data["schema"], isinstance(data["winners"], dict),
            rec is None or rec["metric"] >= 0)


def _resolve_auto(p, d):
    """The ``mesh: auto`` ladder with a damaged winner cache: the
    cost-model / all-dp fallback, never an exception; a healthy winner is
    adopted afterwards."""
    cache = os.path.join(d, "winners.json")
    prof = p.cost_model.ModelProfile.from_model(p.TransformerLM(
        p.get_preset("tiny")))
    out = []
    for damage in ("{torn", "", json.dumps([1, 2, 3]),
                   json.dumps({"schema": 1, "winners": "not-a-dict"})):
        with open(cache, "w") as f:
            f.write(damage)
        for profile in (None, prof):
            out.append(p.mesh_store.resolve_auto_axis_sizes(
                8, profile, winner_cache=cache, kind="cpu"))
    p.mesh_store.WinnerStore(cache).put(
        p.cost_model.model_signature(prof), 8, "cpu", {"dp": 4, "tp": 2},
        50.0)
    out.append(p.mesh_store.resolve_auto_axis_sizes(
        8, prof, winner_cache=cache, kind="cpu"))
    out.append(p.mesh_store.resolve_auto_axis_sizes(1, prof))
    return out


def _fake_sweep(p, monkeypatch, fail=False):
    calls = []

    def sweep(bench_dir, **kw):
        if fail:
            raise OSError("injected bench failure")
        calls.append(kw)
        return [{"threads": 2, "chunk_mb": 4,
                 "read_MBps": 100.0, "write_MBps": 80.0}]

    monkeypatch.setattr(p.aio_bench, "sweep", sweep)
    return calls


def _aio_corrupt_cache(p, d, monkeypatch):
    calls = _fake_sweep(p, monkeypatch)
    cache = os.path.join(d, "aio_cache.json")
    with open(cache, "w") as f:
        f.write("~~~corrupt~~~")
    cfg = p.aio_bench.autotune_config(os.path.join(d, "swap"),
                                      cache_path=cache)
    first = (cfg["threads"], cfg["chunk_mb"], len(calls))
    # healed: the second call is a cache hit, no re-sweep
    cfg2 = p.aio_bench.autotune_config(os.path.join(d, "swap"),
                                       cache_path=cache)
    return first, (cfg2["threads"], len(calls)), calls[0]


def _aio_swapper_survives(p, d, monkeypatch):
    """An AsyncTensorSwapper with autotune on and a corrupt cache comes up
    (re-bench), adopts the winner, and moves bytes."""
    _fake_sweep(p, monkeypatch)
    cache = os.path.join(d, "aio_cache.json")
    with open(cache, "w") as f:
        f.write('{"truncated": ')
    sw = p.swap.AsyncTensorSwapper(os.path.join(d, "swap"), autotune=True,
                                   autotune_cache=cache)
    try:
        arr = np.arange(32, dtype=np.float32)
        sw.swap_out("t0", arr)
        sw.wait()
        ticket, segments = sw.swap_in_start_many(["t0"])
        try:
            flat = ticket.wait()
            off, nbytes = segments["t0"]
            out = np.frombuffer(flat[off:off + nbytes].tobytes(),
                                dtype=np.float32)
        finally:
            ticket.release()
        rep = sw.report()
        return (out.tolist() == arr.tolist(), rep["threads"],
                rep["chunk_mb"], rep["autotuned"]["threads"])
    finally:
        sw.close()


def _aio_sweep_fails(p, d, monkeypatch):
    _fake_sweep(p, monkeypatch, fail=True)
    sw = p.swap.AsyncTensorSwapper(os.path.join(d, "swap"), autotune=True,
                                   autotune_cache=os.path.join(d, "c.json"))
    try:
        return sw.autotuned, sw.num_threads, sw.chunk_bytes
    finally:
        sw.close()


@pytest.mark.parametrize("case", [
    _winner_corrupt, _winner_torn, _winner_schema, _winner_missing,
    _winner_concurrent, _resolve_auto],
    ids=lambda f: f.__name__.strip("_"))
def test_winner_store_robustness_matches_reference(case, tmp_path):
    def run(p):
        d = tmp_path / p.config.__name__.split(".")[0]
        d.mkdir()
        return case(p, str(d))

    both(run)


@pytest.mark.parametrize("case", [
    _aio_corrupt_cache, _aio_swapper_survives, _aio_sweep_fails],
    ids=lambda f: f.__name__.strip("_"))
def test_aio_autotune_robustness_matches_reference(case, tmp_path,
                                                   monkeypatch):
    def run(p):
        d = tmp_path / p.config.__name__.split(".")[0]
        d.mkdir()
        return case(p, str(d), monkeypatch)

    out = both(run)
    if case is _aio_sweep_fails:
        assert out[0] is None                # fell back, did not raise


def test_aio_sweep_measures_the_swapper(tmp_path):
    """The real (short) sweep through the port's swapper and
    ``csrc/aio.cpp``: one row per size x threads x chunk, both rates
    positive; ``main --json`` prints the rows and the best."""
    from deepspeed_tpu_torch.ops import aio_bench

    rows = aio_bench.sweep(str(tmp_path / "s"), sizes_mb=[1],
                           threads=[1, 2], repeats=1, o_direct=False,
                           chunks_mb=[0, 1])
    assert [(r["threads"], r["chunk_mb"]) for r in rows] \
        == [(1, 1), (1, 1), (2, 1), (2, 1)]
    assert all(r["read_MBps"] > 0 and r["write_MBps"] > 0 for r in rows)
    assert not os.listdir(tmp_path / "s")     # every bench dir removed


# ---------------------------------------------------------------------------
# the warm-start cache (tests/unit/test_fleet.py::TestWarmStartCache)
# ---------------------------------------------------------------------------

def _np_tree():
    rng = np.random.default_rng(0)
    return {"wte": rng.standard_normal((8, 4)).astype(np.float32),
            "blocks": [{"w": rng.standard_normal((4, 4)).astype(np.float32)}
                       for _ in range(2)],
            "scale": np.float32(2.5)}


def _torch_tree():
    """A served tree's leaf kinds: bf16 and fp32 tensors, an int8
    QuantizedWeight, a list, a 0-d leaf."""
    from deepspeed_tpu_torch.models.transformer import QuantizedWeight

    g = torch.Generator().manual_seed(0)
    return {"embed": {"tokens": torch.randn(16, 8, generator=g).to(
                torch.bfloat16)},
            "layers": [{"w": torch.randn(4, 4, generator=g)}
                       for _ in range(2)],
            "lm_head_q": QuantizedWeight(
                torch.randint(-128, 127, (2, 3, 8), dtype=torch.int8,
                              generator=g),
                torch.randn(2, 1, 8, generator=g).to(torch.bfloat16), 4, 6),
            "step": torch.tensor(3, dtype=torch.int32)}


def test_flatten_roundtrip():
    from deepspeed_tpu_torch.serving.coldstart import _flatten, _unflatten

    tree = _np_tree()
    rebuilt = _unflatten([(list(map(list, p)), leaf)
                          for p, leaf in _flatten(tree)])
    assert sorted(rebuilt) == sorted(tree)
    np.testing.assert_array_equal(rebuilt["wte"], tree["wte"])
    np.testing.assert_array_equal(rebuilt["blocks"][1]["w"],
                                  tree["blocks"][1]["w"])
    qt = _torch_tree()
    back = _unflatten([(list(map(list, p)), leaf)
                       for p, leaf in _flatten(qt)])
    from deepspeed_tpu_torch.tools.elastic_drill import trees_equal

    assert trees_equal(back, qt)
    assert back["lm_head_q"].bits == 4 and back["lm_head_q"].din == 6


def test_publish_load_roundtrip_bit_identical(tmp_path):
    """The reference's round trip on its numpy tree, and on a served tree
    of tensors: bf16, fp32, int8 QuantizedWeight and 0-d leaves come back
    bit for bit, through a SECOND cache on the same directory."""
    from deepspeed_tpu_torch.serving import WarmStartCache
    from deepspeed_tpu_torch.tools.elastic_drill import trees_equal

    cache = WarmStartCache(str(tmp_path))
    tree, qt = _np_tree(), _torch_tree()
    assert cache.publish("k1", tree) and cache.publish("k2", qt)
    assert cache.has_params("k1") and cache.has_params("k2")
    other = WarmStartCache(str(tmp_path))
    out = other.load_params("k1")
    np.testing.assert_array_equal(out["wte"].numpy(), tree["wte"])
    np.testing.assert_array_equal(out["blocks"][0]["w"].numpy(),
                                  tree["blocks"][0]["w"])
    assert out["scale"].shape == () and float(out["scale"]) == 2.5
    back = other.load_params("k2")
    assert trees_equal(back, qt)
    assert back["embed"]["tokens"].dtype == torch.bfloat16
    assert other.counters["warm_loads"] == 2
    assert other.last_load["bytes"] > 0
    with open(cache.manifest_path("k2")) as f:
        dtypes = {tuple(map(tuple, leaf["path"])): leaf["dtype"]
                  for leaf in json.load(f)["leaves"]}
    assert dtypes[(("d", "embed"), ("d", "tokens"))] == "bfloat16"
    assert dtypes[(("d", "lm_head_q"), ("q", "packed"))] == "int8"
    cache.close()
    other.close()


def test_corrupt_manifest_raises_cleanly(tmp_path):
    from deepspeed_tpu_torch.serving import WarmStartCache

    cache = WarmStartCache(str(tmp_path))
    cache.publish("k1", _np_tree())
    with open(cache.manifest_path("k1"), "w") as f:
        f.write("{not json at all")
    with pytest.raises((OSError, ValueError)):
        cache.load_params("k1")
    with open(cache.manifest_path("k1"), "w") as f:
        json.dump({"schema": 2, "leaves": []}, f)
    with pytest.raises(ValueError):
        cache.load_params("k1")
    cache.close()


def test_torn_swap_file_raises_cleanly(tmp_path):
    from deepspeed_tpu_torch.serving import WarmStartCache

    cache = WarmStartCache(str(tmp_path))
    cache.publish("k1", _np_tree())
    swap_dir = os.path.join(tmp_path, "weights")   # swapper namespace
    swps = [os.path.join(swap_dir, p) for p in os.listdir(swap_dir)
            if p.endswith(".swp")]
    victim = max(swps, key=os.path.getsize)
    with open(victim, "r+b") as f:
        f.truncate(max(os.path.getsize(victim) // 2, 1))
    fresh = WarmStartCache(str(tmp_path))   # no in-memory meta
    with pytest.raises((OSError, ValueError)):
        fresh.load_params("k1")
    cache.close()
    fresh.close()


def test_injected_io_error_on_load(tmp_path):
    from deepspeed_tpu_torch.resilience.faults import (FaultInjector,
                                                       FaultSpec,
                                                       InjectedIOError,
                                                       set_injector)
    from deepspeed_tpu_torch.serving import WarmStartCache

    cache = WarmStartCache(str(tmp_path))
    cache.publish("k1", _np_tree())
    set_injector(FaultInjector(
        [FaultSpec(kind="weight_load_io_error", site="warm")]))
    try:
        with pytest.raises(InjectedIOError):
            cache.load_params("k1")
    finally:
        set_injector(None)
    assert tuple(cache.load_params("k1")["wte"].shape) == (8, 4)
    cache.close()


def test_evict_module():
    from deepspeed_tpu_torch.serving.coldstart import _MODULES, evict_module

    _MODULES["tmp_key"] = object()
    assert evict_module("tmp_key")
    assert not evict_module("tmp_key")


def test_build_engine_cold_then_warm_and_fallbacks(tmp_path):
    """``build_engine`` on the tiny model, int8 weights: the first build
    is cold and publishes its quantized tree, the next is warm with that
    tree bit for bit (not quantized again) and the same logits; an
    injected ``weight_load_io_error`` and a corrupt manifest each build
    cold, with a warning and a counter; a bf16 engine refuses the int8
    tree."""
    from deepspeed_tpu_torch.models import TransformerLM, get_preset
    from deepspeed_tpu_torch.resilience.faults import (FaultInjector,
                                                       FaultSpec,
                                                       set_injector)
    from deepspeed_tpu_torch.serving import WarmStartCache, warm_key
    from deepspeed_tpu_torch.serving.coldstart import evict_module
    from deepspeed_tpu_torch.tools.elastic_drill import trees_equal

    cfg = get_preset("tiny", hidden_size=128, max_seq_len=128,
                     dtype="float32")
    key = warm_key(TransformerLM(cfg)) + "|test"
    kw = dict(max_sequences=2, max_seq_len=64, block_size=16, device="cpu",
              weight_dtype="int8")
    cache = WarmStartCache(str(tmp_path), executable_cache=True)
    evict_module(key)
    try:
        cold, info0 = cache.build_engine(key, lambda: TransformerLM(cfg),
                                         engine_kw=kw)
        warm, info1 = cache.build_engine(key, lambda: TransformerLM(cfg),
                                         engine_kw=kw)
        assert (info0["source"], info1["source"]) == ("cold", "warm")
        assert warm.module is cold.module and trees_equal(warm.params,
                                                          cold.params)
        prompt = [np.arange(1, 20, dtype=np.int32)]
        np.testing.assert_array_equal(warm.put([0], prompt)[0],
                                      cold.put([0], prompt)[0])
        set_injector(FaultInjector(
            [FaultSpec(kind="weight_load_io_error", site="warm")]))
        try:
            _, info2 = cache.build_engine(key, lambda: TransformerLM(cfg),
                                          engine_kw=kw, publish=False)
        finally:
            set_injector(None)
        with open(cache.manifest_path(key), "w") as f:
            f.write("{torn")
        _, info3 = cache.build_engine(key, lambda: TransformerLM(cfg),
                                      engine_kw=kw)
        assert (info2["source"], info3["source"]) == ("cold", "cold")
        assert cache.counters == {
            "publishes": 2, "publish_failures": 0, "warm_loads": 1,
            "warm_load_failures": 2, "cold_builds": 3, "warm_builds": 1}
        with pytest.raises(ValueError, match="int8"):
            cache.build_engine(key, lambda: TransformerLM(cfg),
                               engine_kw={**kw, "weight_dtype": "bf16"})
    finally:
        evict_module(key)
        cache.close()


@pytest.mark.parametrize("publisher", PKGS)
def test_cache_loads_across_packages(publisher, tmp_path):
    """A cache one package publishes for the ``tiny`` model (bf16 leaves)
    loads in the other into an equal tree (through ``bridge.py``)."""
    import jax

    from deepspeed_tpu.models import TransformerLM as JaxLM
    from deepspeed_tpu.models import get_preset as jax_preset
    from deepspeed_tpu.serving import WarmStartCache as JaxCache
    from deepspeed_tpu.serving import warm_key as jax_warm_key
    from deepspeed_tpu_torch.bridge import params_from_numpy
    from deepspeed_tpu_torch.models import TransformerLM, get_preset
    from deepspeed_tpu_torch.serving import WarmStartCache, warm_key
    from deepspeed_tpu_torch.tools.elastic_drill import trees_equal

    model = JaxLM(jax_preset("tiny", param_dtype="bfloat16"))
    tree = jax.device_get(model.init(jax.random.key(3)))
    key = warm_key(TransformerLM(get_preset("tiny")), world=1,
                   device_kind="cpu")
    assert key == jax_warm_key(model, world=1, device_kind="cpu")
    want = params_from_numpy(tree, device="cpu")
    assert want["embed"]["tokens"].dtype == torch.bfloat16
    if publisher == "jax":
        assert JaxCache(str(tmp_path)).publish(key, tree)
        port = WarmStartCache(str(tmp_path))
        assert trees_equal(port.load_params(key), want)
        port.close()
    else:
        port = WarmStartCache(str(tmp_path))
        assert port.publish(key, want)
        port.close()
        got = JaxCache(str(tmp_path)).load_params(key)
        assert trees_equal(params_from_numpy(got, device="cpu"), want)
        flat = jax.tree_util.tree_leaves(got)
        assert {str(a.dtype) for a in flat} \
            == {str(a.dtype) for a in jax.tree_util.tree_leaves(tree)}


# ---------------------------------------------------------------------------
# the autoscaler on the reference's stub router (tests/unit/test_fleet.py)
# ---------------------------------------------------------------------------

class _FakeRep:
    """Just enough replica surface for FleetController._autoscale."""

    def __init__(self, name, qdepth=0, by_tier=None, active=0, sheds=0,
                 retry_after=0.0):
        self.name = name
        self.incarnation = 0
        self.routable = True
        self.alive = True
        self.stats = {"health": "ready", "queue_depth": qdepth,
                      "active": active, "retry_after": retry_after,
                      "sheds": sheds, "drained": False,
                      "beat": time.monotonic()}
        if by_tier is not None:
            self.stats["queue_depth_by_tier"] = by_tier


class _FakeRouter:
    def __init__(self, reps):
        self.replicas = {r.name: r for r in reps}

    def _snapshot(self):
        return list(self.replicas.values())


#: per poll: (queue depth, by tier or None, active, sheds, retry_after) of
#: each replica of the pool
_SIGNALS = [
    [(50, {"batch": 50}, 0, 0, 0.0), (0, {}, 0, 0, 0.0)],
    [(50, {"batch": 50}, 0, 0, 0.0), (0, {}, 0, 0, 0.0)],
    [(9, {"latency": 9}, 1, 0, 0.0), (0, {}, 1, 0, 0.0)],
    [(9, {"latency": 9}, 1, 0, 0.0), (0, {}, 1, 0, 0.0)],
    [(9, None, 1, 0, 0.0), (0, None, 1, 0, 0.0)],
    [(0, {}, 1, 2, 0.0), (0, {}, 1, 0, 0.0)],
    [(0, {}, 1, 5, 0.0), (0, {}, 1, 0, 0.0)],
    [(0, {}, 1, 5, 2.5), (0, {}, 0, 0, 0.0)],
    [(0, {}, 1, 5, 2.5), (0, {}, 0, 0, 0.0)],
    [(0, {}, 0, 5, 0.0), (0, {}, 0, 0, 0.0)],
    [(0, {}, 0, 5, 0.0), (0, {}, 0, 0, 0.0)],
    [(0, {}, 0, 5, 0.0), (0, {}, 0, 0, 0.0)],
    [(3, {"throughput": 3}, 0, 5, 0.0), (2, {"batch": 2}, 0, 0, 0.0)],
    [(0, {}, 0, 5, 0.0), (0, {}, 0, 0, 0.0)],
]


def _autoscale_calls(p):
    reps = [_FakeRep("r0"), _FakeRep("r1")]
    ctl = p.fleet.FleetController(
        _FakeRouter(reps), lambda name: None,
        config=p.config.FleetConfig(scale_up_polls=2,
                                    scale_down_idle_polls=2,
                                    scale_up_queue_per_replica=4,
                                    scale_up_retry_after_s=2.0,
                                    min_replicas=1, max_replicas=8),
        registry=p.observability.MetricsRegistry())
    calls = []
    ctl.scale_up = lambda: calls.append("up") or "rX"
    ctl.scale_down = lambda: calls.append("down") or "r0"
    for step, signal in enumerate(_SIGNALS):
        for rep, (q, tiers, active, sheds, retry) in zip(reps, signal):
            rep.stats.update(queue_depth=q, active=active, sheds=sheds,
                             retry_after=retry)
            rep.stats.pop("queue_depth_by_tier", None)
            if tiers is not None:
                rep.stats["queue_depth_by_tier"] = tiers
        actions = {"scaled_up": None, "scaled_down": None}
        ctl._autoscale(actions)
        calls.append((step, ctl._up_streak, ctl._idle_streak,
                      actions["scaled_up"], actions["scaled_down"]))
    return calls


def test_autoscaler_decisions_match_reference():
    """The same up / down decisions, streaks included, for the same signal
    sequence: batch-tier backlog alone is idle, a latency backlog and a
    missing tier breakdown are pressure, shed deltas and the Retry-After
    watermark are pressure, hysteresis on both edges."""
    calls = both(_autoscale_calls)
    assert "up" in calls and "down" in calls


# ---------------------------------------------------------------------------
# crash -> respawn -> readmit on the port's tiny engine
# ---------------------------------------------------------------------------

def test_crash_respawn_readmit_resolves_old_uids(tmp_path):
    """The reference's ``TestRouterElasticity`` case on the port alone:
    r0's worker crashes under 12 requests; one poll fails its requests
    over, respawns r0 (warm: module and weights from the cache) under a
    new incarnation and readmits it; every old uid resolves terminal and
    the respawn serves a new request."""
    from deepspeed_tpu_torch.config import FleetConfig
    from deepspeed_tpu_torch.resilience.faults import (FaultInjector,
                                                       FaultSpec,
                                                       set_injector)
    from deepspeed_tpu_torch.tools.elastic_drill import (Setup,
                                                         await_terminal,
                                                         make_fleet)

    setup = Setup(device="cpu")
    router, fc, cache, _, _ = make_fleet(
        2, str(tmp_path), setup, serving_kw={"default_max_new_tokens": 4})
    fc.cfg = FleetConfig(respawn_backoff_s=0.0)
    try:
        old_inc = router.replicas["r0"].incarnation
        uids = [router.submit([1, 2, 3], max_new_tokens=4)
                for _ in range(12)]
        set_injector(FaultInjector(
            [FaultSpec(kind="replica_crash", site="r0")]))
        deadline = time.monotonic() + 15
        while router.replicas["r0"].alive and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not router.replicas["r0"].alive
        set_injector(None)
        actions = fc.poll()
        assert actions["recovered"] and actions["recovered"][0]["respawned"]
        r0 = router.replicas["r0"]
        assert r0.alive and r0.incarnation > old_inc
        assert r0.start_info["source"] == "warm"
        assert not await_terminal(router, uids, 60)
        uid = router.submit([4, 5], max_new_tokens=2)
        assert not await_terminal(router, [uid], 30)
        assert router.counters["readmits"] == 1
        assert router.counters["crash_failovers"] == 1
        assert fc.report()["counters"]["respawns"] == 1
    finally:
        set_injector(None)
        router.close()
        fc.close()
        cache.close()


def test_drain_capture_keeps_the_uid_of_a_submit_still_landing(tmp_path):
    """A drain (a rolling swap's, a scale-down's) can capture a queued
    request before the router submit that put it there has recorded its
    route. The capture waits for that route, so the client's uid follows
    the migration and completes; re-homed under a fresh uid instead, the
    client's uid would resolve the ``draining`` shed the drain left (the
    reference's router has the same race; rolling swaps under a trickle
    met it on the CPU)."""
    from deepspeed_tpu_torch.tools.elastic_drill import (Setup,
                                                         await_terminal,
                                                         make_fleet)

    router, fc, cache, _, _ = make_fleet(2, str(tmp_path), Setup(
        device="cpu"))
    try:
        for r in router._snapshot():
            r.paused = True                  # commands run, steps do not
        go, out, res = threading.Event(), [], []
        record = router._record_route

        def late_record(*args):
            go.wait(30)
            return record(*args)

        router._record_route = late_record
        t = threading.Thread(target=lambda: out.append(router.submit(
            [1, 2, 3], max_new_tokens=2)))
        t.start()
        deadline = time.monotonic() + 30
        while not any(r.stats["queue_depth"] for r in router._snapshot()):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        home = next(r.name for r in router._snapshot()
                    if r.stats["queue_depth"])
        router._record_route = record
        d = threading.Thread(target=lambda: res.append(
            router.drain_replica(home)))
        d.start()
        time.sleep(0.2)                      # the drain meets the landing
        go.set()
        t.join(30)
        d.join(30)
        for r in router._snapshot():
            r.paused = False
        assert res[0]["captured"] == 1 and res[0]["migrated"] == 1
        assert not await_terminal(router, out, 30)
        assert router.resolve(out[0]) == "completed"
        assert router._routes[out[0]].replica != home
    finally:
        router.close()
        fc.close()
        cache.close()


# ---------------------------------------------------------------------------
# slow end-to-end drill wrappers
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("scenario", ["replica-crash-mid-storm",
                                      "burst-autoscale", "rolling-swap",
                                      "cold-start-bench"])
def test_elastic_scenario(scenario, tmp_path):
    from deepspeed_tpu_torch.tools.elastic_drill import run_scenario

    verdict = run_scenario(scenario, workdir=str(tmp_path), device="cpu")
    assert verdict["ok"], verdict


# ---------------------------------------------------------------------------
# chip_smoke's phase 12 (the elastic fleet) at a tiny width on the CPU
# ---------------------------------------------------------------------------

FLEET_TINY = dict(hidden_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
                  intermediate_size=256, vocab_size=512, dtype="float32",
                  param_dtype="float32")


@pytest.fixture
def tiny_fleet(monkeypatch):
    """Phase 12 on the CPU: launches are counted on the card only, and the
    traffic is cut to keep the suite's time (llama3-8b's shape at width
    128, prompts of 40-120 tokens in 32-token chunks, max_seq_len 256,
    block 16, 4 new tokens)."""
    import chip_smoke

    for name, value in (("FLEET_KERNELS", ()), ("FLEET_PRESET_KW", FLEET_TINY),
                        ("FLEET_MAX_SEQ", 256), ("FLEET_BLOCK", 16),
                        ("FLEET_CHUNK", 32), ("FLEET_PROMPTS", (40, 120)),
                        ("FLEET_NEW", 4), ("FLEET_TRICKLE_S", 0.02),
                        ("FLEET_JOIN_S", 120.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


def test_fleet_phase_runs_on_a_tiny_cpu_model(tiny_fleet):
    """Every gate of phase 12 that runs off the card passes: cold, then
    warm with the published tree bit for bit and the same greedy tokens,
    both fallbacks cold; the crash respawned warm with every uid terminal
    and a flight dump; the burst grows and shrinks the pool; the rolling
    swap bumps every incarnation above the READY floor with every
    trickled request completed; nothing leaked."""
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import flash_attention as tfa
    from deepspeed_tpu_torch.ops import paged_attention as tpa
    from deepspeed_tpu_torch.ops import quant_matmul as tqm

    counts = tiny_fleet.fleet(torch, tpa, tqm, tfa, _build.KERNELS,
                              _build.reset_counts, device="cpu")
    assert counts == {}
