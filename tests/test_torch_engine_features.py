"""The PyTorch port's ``InferenceEngineV2`` serving features against the JAX
package's engine (fp32 ``tiny``, bridged weights, the JAX engine on its XLA
twins), on the CPU: sampled ``decode_batch``, pause/resume, durable
export/adopt, the promote fence (``tests/unit/test_decode_kernel.py``
``TestFusedPromoteFence``; the port uploads ahead of the step instead of
in a fused prologue) and the options that stay unported.

* sampling math: the port's ``sample_token`` against the reference's on
  fixed logits -- ``temperature=0`` and ``top_k=1`` give the argmax, and
  for temperature / top-k / top-p the two draw from the same filtered set
  with the same log-probabilities (atol 1e-5); the random streams differ
  (a ``torch.Generator`` against a JAX key) and are not compared;
* ``decode_batch(temperature=0)`` gives the greedy tokens of the
  reference; ``top_k=1`` gives them too; a seed reproduces its tokens and
  another seed gives others;
* greedy tokens identical, port against reference and within the port, for
  pause -> resume (fp32 pools, and an int8 pool in the port) and for export ->
  adopt across two port engines.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.engine import sample_token as jax_sample
from deepspeed_tpu.inference.kv_tier import claim_manifest as jax_claim
from deepspeed_tpu.inference.kv_tier import load_manifest as jax_load
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference.engine import sample_token
from deepspeed_tpu_torch.inference.kv_tier import (claim_manifest,
                                                   load_manifest)
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from tests._torch_threads import one_torch_thread  # noqa: F401

KW = dict(max_sequences=8, max_seq_len=128, block_size=16)
TIERS = {"enabled": True, "tiers": {"enabled": True, "host_mb": 8.0}}


# ---------------------------------------------------------------------------
# sampling math on fixed logits
# ---------------------------------------------------------------------------

def _draws(fn_port, fn_ref, logits, n=4000):
    """(token -> logprob) maps of ``n`` draws from each package on the
    same row of logits (the row repeated n times in one call)."""
    rows = np.repeat(logits[None], n, axis=0)
    tok, lp = fn_port(torch.from_numpy(rows))
    port = dict(zip(tok.tolist(), lp.tolist()))
    jtok, jlp = fn_ref(jnp.asarray(rows))
    ref = dict(zip(np.asarray(jtok).tolist(), np.asarray(jlp).tolist()))
    return port, ref


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.8, 10, 1.0), (0.8, 10, 0.8), (1.3, 0, 0.9), (0.7, 0, 1.0),
    (0.8, 50, 0.9)])
def test_sample_token_matches_reference_distribution(temperature, top_k,
                                                     top_p):
    logits = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    port, ref = _draws(
        lambda x: sample_token(x, temperature, top_k, gen, with_logprob=True,
                               top_p=top_p),
        lambda x: jax_sample(x, temperature, top_k, jax.random.key(0),
                             with_logprob=True, top_p=top_p),
        logits)
    assert set(port) == set(ref)
    for t, lp in port.items():
        assert abs(lp - ref[t]) < 1e-5, (t, lp, ref[t])


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.0, 40),
                                               (0.9, 1), (1.5, 1)])
def test_sample_token_greedy_cases_match_reference(temperature, top_k):
    logits = np.random.default_rng(1).standard_normal((6, 64)).astype(
        np.float32)
    got = sample_token(torch.from_numpy(logits), temperature, top_k,
                       torch.Generator().manual_seed(3))
    want = jax_sample(jnp.asarray(logits), temperature, top_k,
                      jax.random.key(3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32():
    jm = JaxLM(jax_preset("tiny", dtype="float32"))
    params = jax.device_get(jm.init(jax.random.key(0)))
    return jm, params, TransformerLM(get_preset("tiny", dtype="float32"))


def _jax(f32, **kw):
    jm, params, _ = f32
    return JaxEngine(jm, params=params, decode_kernel="xla", **{**KW, **kw})


def _port(f32, **kw):
    _, params, tm = f32
    return InferenceEngineV2(tm, params_from_numpy(params, device="cpu"),
                             device="cpu", **{**KW, **kw})


@pytest.fixture(scope="module")
def engines(f32):
    return {"jax": _jax(f32), "torch": _port(f32)}


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 256, n).astype(np.int32) for n in (19, 40, 7, 33)]


def _ints(a):
    return [int(x) for x in a]


def test_decode_batch_sampling(engines):
    eng = engines["torch"]
    prompts, uids = _prompts(), [0, 1, 2, 3]

    def run(**kw):
        out = eng.put(uids, prompts)
        t0 = [int(np.argmax(out[u])) for u in uids]
        toks = eng.decode_batch(uids, t0, steps=8, **kw)
        eng.flush(uids)
        return {u: _ints(toks[u]) for u in uids}

    greedy = run()
    ref = engines["jax"]
    out = ref.put(uids, prompts)
    jt = ref.decode_batch(uids, [int(np.argmax(out[u])) for u in uids],
                          steps=8)
    ref.flush(uids)
    assert greedy == {u: _ints(jt[u]) for u in uids}
    assert run(temperature=0.0, top_k=5, top_p=0.5, seed=9) == greedy
    assert run(temperature=0.9, top_k=1, seed=4) == greedy
    a = run(temperature=0.8, top_k=50, top_p=0.9, seed=7)
    assert a == run(temperature=0.8, top_k=50, top_p=0.9, seed=7)
    assert a != run(temperature=0.8, top_k=50, top_p=0.9, seed=8)
    assert a != greedy
    assert all(0 <= t < 256 for toks in a.values() for t in toks)
    assert eng.state.allocator.leaked_blocks() == []


def _pause_run(eng, pause=None, steps=(3, 3, 3)):
    """Four prompts put, then three decode_batch calls; ``pause`` is paused
    and resumed between the first two."""
    prompts, uids = _prompts(), [0, 1, 2, 3]
    out = eng.put(uids, prompts)
    cur = {u: int(np.argmax(out[u])) for u in uids}
    got = {u: [] for u in uids}
    info = {}
    for i, n in enumerate(steps):
        if i == 1 and pause is not None:
            info["paused"] = eng.pause_request(pause)
            info["is_paused"] = eng.is_paused(pause)
            info["blocks"] = eng.paused_blocks(pause)
            info["gone"] = pause not in eng.state.sequences
            info["can_resume"] = eng.can_resume(pause)
            info["resumed"] = eng.resume_request(pause)
            info["failed"] = eng.flush_resumes()
            info["report"] = eng.tier_report()
        res = eng.decode_batch(uids, [cur[u] for u in uids], steps=n)
        for u in uids:
            got[u] += _ints(res[u])
            cur[u] = got[u][-1]
    eng.flush(uids)
    alloc = eng.state.allocator
    info["restored"] = alloc.free_blocks == alloc.num_blocks
    return got, info


def test_pause_resume_greedy_bit_identical(engines):
    base = {n: _pause_run(e)[0] for n, e in engines.items()}
    got = {n: _pause_run(e, pause=2) for n, e in engines.items()}
    assert base["torch"] == base["jax"]
    assert got["torch"][0] == base["torch"] == got["jax"][0]
    t, j = got["torch"][1], got["jax"][1]
    assert t["paused"] and t["resumed"] and t["failed"] == []
    assert t["is_paused"] and t["gone"] and t["can_resume"] and t["restored"]
    for key in ("paused", "is_paused", "blocks", "gone", "can_resume",
                "resumed", "failed", "restored"):
        assert t[key] == j[key], key
    keys = ("host_entries", "host_demotions", "host_hits",
            "paused_requests", "pending_resumes", "pending_promotes")
    assert {k: t["report"][k] for k in keys} == \
        {k: j["report"][k] for k in keys}
    assert set(t["report"]) == set(j["report"])
    for eng in engines.values():
        assert eng._tier_store.entries() == 0


def test_pause_resume_int8_pool(f32):
    eng = _port(f32, kv_dtype="int8")
    base, _ = _pause_run(eng)
    got, info = _pause_run(eng, pause=1)
    assert got == base and info["resumed"] and info["restored"]
    parts = eng._extract_blocks([0])[0]
    assert sorted(parts) == ["k", "kv_scale", "v"]
    assert parts["k"].dtype == np.int8
    eng.close()


def test_pause_refusals_and_drop(engines):
    eng = engines["torch"]
    assert not eng.pause_request(77)              # unknown uid
    assert not eng.resume_request(77)
    eng.put([5], [np.arange(1, 10, dtype=np.int32)])
    assert eng.pause_request(5) and not eng.pause_request(5)
    assert eng.paused_blocks(5) == 1
    eng.flush([5])                                # a paused uid ends here
    assert not eng.is_paused(5) and eng._tier_store.entries() == 0
    assert eng.state.allocator.leaked_blocks() == []


def _migrate(make, claim, load, tmp_path):
    """Engine X runs the first decode call, pauses uid 2 and exports it;
    engine Y adopts it (fresh uid 9) and decodes the remaining calls."""
    shared = str(tmp_path)
    x, y = make(), make()
    x.migration_nvme_path = y.migration_nvme_path = shared
    prompts, uids = _prompts(), [0, 1, 2, 3]
    out = x.put(uids, prompts)
    cur = {u: int(np.argmax(out[u])) for u in uids}
    res = x.decode_batch(uids, [cur[u] for u in uids], steps=3)
    toks = _ints(res[2])
    assert x.pause_request(2)
    path = x.export_paused(2, "x-2", shared, keep=False)
    x.flush(uids)
    claimed = claim(path)
    assert claimed is not None and claim(path) is None
    payload = load(claimed)
    y.adopt_paused(9, payload, manifest_path=claimed)
    assert y.is_paused(9) and y.resume_request(9)
    tok = toks[-1]
    for _ in range(2):
        toks += _ints(y.decode_batch([9], [tok], steps=3)[9])
        tok = toks[-1]
    y.flush([9])
    info = dict(seen=payload["seen_tokens"], n=len(payload["entries"]),
                hist=payload["hist"], entries=y._tier_store.entries(),
                claimed_left=os.path.exists(claimed),
                free=y.state.allocator.free_blocks)
    x.close()
    y.close()
    return toks, info


def test_export_adopt_across_two_engines(f32, engines, tmp_path):
    base = _pause_run(engines["torch"])[0][2]
    got, info = _migrate(lambda: _port(f32), claim_manifest, load_manifest,
                         tmp_path / "torch")
    want, jinfo = _migrate(lambda: _jax(f32), jax_claim, jax_load,
                           tmp_path / "jax")
    assert got == base == want
    assert info == jinfo
    assert info["entries"] == 0 and not info["claimed_left"]


def test_export_refusals(engines, tmp_path):
    eng = engines["torch"]
    eng.put([6], [np.arange(1, 20, dtype=np.int32)])
    assert eng.export_paused(6, "t", str(tmp_path)) is None   # not paused
    assert eng.pause_request(6)
    # the store spills nowhere another engine sees: no manifest
    assert eng.export_paused(6, "t", str(tmp_path)) is None
    other = InferenceEngineV2(eng.module, eng.params, device="cpu", **KW)
    other.migration_nvme_path = str(tmp_path)
    with pytest.raises(ValueError, match="empty"):
        other.adopt_paused(1, {"entries": [], "seen_tokens": 0})
    eng.flush([6])
    other.close()


class TestPromoteFence:
    """The reference's ``TestFusedPromoteFence`` cases on the port's fence
    (an ``index_copy_`` upload ahead of the step)."""

    @staticmethod
    def _roundtrip(eng, seed=7):
        rng = np.random.default_rng(seed)
        shared = rng.integers(1, 256, 24).astype(np.int32)
        sfx = rng.integers(1, 256, 4).astype(np.int32)
        eng.put([0], [np.concatenate([shared, sfx])])
        eng.flush([0])
        pc = eng.prefix_cache
        pc.evict(pc.evictable_blocks())
        first = eng.put([1], [np.concatenate([shared, sfx])])
        out = eng.decode_batch([1], [int(np.argmax(first[1]))], steps=6)
        eng.flush([1])
        return _ints(out[1])

    def test_demote_promote_identical_to_reference(self, f32):
        kw = dict(max_sequences=4, max_seq_len=96, prefix_cache=TIERS)
        toks, reps = {}, {}
        for name, make in (("torch", _port), ("jax", _jax)):
            eng = make(f32, **kw)
            toks[name] = self._roundtrip(eng)
            reps[name] = eng.tier_report()
            eng.close()
        assert toks["torch"] == toks["jax"]
        assert set(reps["torch"]) == set(reps["jax"])
        assert reps["torch"]["fused_prologue_dispatches_saved"] == 0
        for key in ("host_demotions", "host_hits", "pending_promotes",
                    "pending_resumes"):
            assert reps["torch"][key] == reps["jax"][key], key

    def test_fence_leaves_no_pending_state(self, f32):
        eng = _port(f32, max_sequences=4, max_seq_len=96, prefix_cache=TIERS)
        self._roundtrip(eng)
        rep = eng.tier_report()
        assert rep["pending_promotes"] == 0 and rep["pending_resumes"] == 0
        eng.prefix_cache.clear()
        alloc = eng.state.allocator
        assert alloc.free_blocks == alloc.num_blocks
        eng.close()

    def test_pause_resume_with_prefix_tiers(self, f32):
        toks = {}
        for name, make in (("torch", _port), ("jax", _jax)):
            eng = make(f32, max_sequences=4, max_seq_len=96,
                       prefix_cache=TIERS)
            prompt = np.random.default_rng(11).integers(1, 256, 19).astype(
                np.int32)
            r = eng.put([5], [prompt])
            cur = int(np.argmax(r[5]))
            assert eng.pause_request(5) and eng.resume_request(5)
            assert eng.flush_resumes() == []
            toks[name] = _ints(eng.decode_batch([5], [cur], steps=6)[5])
            eng.flush([5])
            eng.close()
        assert toks["torch"] == toks["jax"]


MESH = "Mesh, ZeRO and tensor parallelism"


@pytest.mark.parametrize("kw,item", [
    (dict(mesh={"tp": 2}), MESH), (dict(topology=object()), MESH)])
def test_unported_options_name_their_roadmap_item(kw, item):
    """Each refusal names its ROADMAP section 1 item by title (a number
    would go stale as items close), and the title is an item there."""
    assert f"**{item}" in _roadmap_section_1()
    tm = TransformerLM(get_preset("tiny", dtype="float32"))
    with pytest.raises(NotImplementedError, match=f'ROADMAP section 1, '
                                                  f'"{item}"'):
        InferenceEngineV2(tm, device="cpu", **KW, **kw)


@pytest.mark.parametrize("kw", [dict(moe_kernel="ragged"),
                                dict(moe_a2a_bits=8),
                                dict(moe_replica_slots=1)],
                         ids=["moe_kernel", "moe_a2a_bits",
                              "moe_replica_slots"])
def test_moe_options_serve_on_one_device(kw):
    """The engine's MoE options are accepted on a grouped MoE model: the
    kernel it names runs (the preset's own here), and the expert-parallel
    wire format and replica slots change nothing on one device -- greedy
    tokens equal those of an engine built without the option."""
    tm = TransformerLM(get_preset("tiny-moe", dtype="float32",
                                  moe_dispatch="grouped"))
    tree = tm.init(seed=3, device="cpu")
    prompt = np.random.default_rng(4).integers(1, 256, 12).astype(np.int32)
    toks = []
    for extra in ({}, kw):
        eng = InferenceEngineV2(tm, tree, device="cpu", **KW, **extra)
        first = int(np.argmax(eng.put([0], [prompt])[0]))
        toks.append([first] + _ints(eng.decode_batch([0], [first],
                                                     steps=6)[0]))
        assert eng.moe_kernel == "ragged" and eng.rebalance_moe() is None
    assert toks[0] == toks[1]


def _refuse_moe_storm():
    from deepspeed_tpu_torch.tools.serve_drill import run_scenario

    run_scenario("moe-storm", device="cpu")


@pytest.mark.parametrize("refuse,item", [(_refuse_moe_storm, MESH)],
                         ids=["moe-storm"])
def test_unported_serving_parts_name_their_roadmap_item(refuse, item):
    """The serving layer's refusal -- the ``moe-storm`` drill, which serves
    MoE expert-parallel on an ep mesh -- names its ROADMAP section 1 item
    too."""
    assert f"**{item}" in _roadmap_section_1()
    with pytest.raises(NotImplementedError, match=f'ROADMAP section 1, '
                                                  f'"{item}"'):
        refuse()


def _roadmap_section_1() -> str:
    text = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ROADMAP.md")).read()
    return text.split("### 1.", 1)[1].split("### 2.", 1)[0]
