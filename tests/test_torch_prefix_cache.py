"""The PyTorch port's prefix cache and n-gram speculative decoding against
the JAX package's (``tests/unit/test_prefix_cache.py``): the same cases on
both, on the CPU.

* ``PrefixCache`` state machine (radix walk, acquire, insert, LRU evict,
  ``max_blocks``, clear): every case and a seeded random trace of
  operations run through both packages' ``PrefixCache`` over their own
  ``BlockedAllocator`` and give identical block ids, counters and
  ``report()``s;
* ``ngram_draft`` is equal on random histories and on the reference's
  cases;
* the engine (fp32 ``tiny``, bridged weights, the JAX engine on its XLA
  twins): greedy tokens identical between the port and the reference, and
  within the port between warm and cold caches and with speculation on and
  off; logits of a prefix-attached ``put`` agree with the reference's to
  atol = rtol = 1e-4; the prefix counters, the spec counters and the pool
  bookkeeping are equal.
"""

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference import ragged as jr
from deepspeed_tpu.inference.speculative import ngram_draft as jax_ngram
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.config import PrefixCacheConfig, SpeculativeConfig
from deepspeed_tpu_torch.inference import CapacityError, InferenceEngineV2
from deepspeed_tpu_torch.inference import ragged as tr
from deepspeed_tpu_torch.inference.speculative import ngram_draft
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from tests._torch_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
SPEC = {"enabled": True, "ngram": 2, "max_draft": 4, "fallback_steps": 4}


# ---------------------------------------------------------------------------
# PrefixCache state machine: each case returns what it observed, run on both
# ---------------------------------------------------------------------------

def _cache(m, num_blocks=8, bs=4, **kw):
    alloc = m.BlockedAllocator(num_blocks, bs)
    return alloc, m.PrefixCache(alloc, **kw)


def case_full_block_roundtrip(m):
    alloc, pc = _cache(m)
    toks = np.arange(10, dtype=np.int32)
    blocks = alloc.allocate(3)
    obs = [pc.insert(toks, blocks), pc.peek(toks)]
    other = np.concatenate([toks[:4], toks[4:8] + 1])
    obs += [pc.peek(other), pc.acquire(toks), alloc.refcount(blocks[0]),
            pc.report()]
    return obs


def case_max_tokens_caps(m):
    alloc, pc = _cache(m)
    toks = np.arange(8, dtype=np.int32)
    pc.insert(toks, alloc.allocate(2))
    return [pc.peek(toks, max_tokens=7), pc.report()]


def case_lru_spares_referenced(m):
    alloc, pc = _cache(m, num_blocks=4)
    a, b = alloc.allocate(1), alloc.allocate(1)
    pc.insert(np.arange(4), a)
    pc.insert(np.arange(100, 104), b)
    alloc.free(a)
    alloc.free(b)
    obs = [pc.acquire(np.arange(100, 104)), pc.evictable_blocks(),
           pc.evict(2), pc.peek(np.arange(4)), pc.peek(np.arange(100, 104))]
    return obs + [pc.report()]


def case_lru_order(m):
    alloc, pc = _cache(m, num_blocks=4)
    a, b = alloc.allocate(1), alloc.allocate(1)
    pc.insert(np.arange(4), a)
    pc.insert(np.arange(100, 104), b)
    alloc.free(a)
    alloc.free(b)
    got, _ = pc.acquire(np.arange(4))
    alloc.free(got)
    return [pc.evict(1), pc.peek(np.arange(4)), pc.peek(np.arange(100, 104)),
            pc.report()]


def case_interior_after_leaves(m):
    alloc, pc = _cache(m, num_blocks=4)
    blocks = alloc.allocate(2)
    pc.insert(np.arange(8), blocks)
    alloc.free(blocks)
    return [pc.evict(1), pc.peek(np.arange(8)), pc.evict(1),
            alloc.free_blocks, pc.report()]


def case_max_blocks_cap(m):
    alloc, pc = _cache(m, max_blocks=2)
    a = alloc.allocate(3)
    pc.insert(np.arange(12), a)
    obs = [pc._nodes]
    alloc.free(a)
    pc.insert(np.arange(100, 104), alloc.allocate(1))
    return obs + [pc._nodes, pc.report()]


def case_max_blocks_no_orphan(m):
    alloc, pc = _cache(m, max_blocks=1)
    a = alloc.allocate(1)
    pc.insert(np.arange(4), a)
    alloc.free(a)
    b = alloc.allocate(2)
    pc.insert(np.arange(8), b)
    alloc.free(b)
    obs = [pc.report(), pc.clear()]
    return obs + [alloc.free_blocks, alloc.leaked_blocks()]


def case_clear_releases_only_tree_refs(m):
    alloc, pc = _cache(m, num_blocks=4)
    a = alloc.allocate(1)
    pc.insert(np.arange(4), a)
    obs = [pc.clear(), alloc.refcount(a[0])]
    alloc.free(a)
    return obs + [alloc.free_blocks, alloc.leaked_blocks()]


def case_sequence_manager_reclaims(m):
    """SequenceManager with a cache: evictable blocks count as available,
    ``schedule`` evicts LRU-first, ``attach_prefix`` and ``restore``."""
    sm = m.SequenceManager(max_sequences=4, max_seq_len=32, block_size=4,
                           num_blocks=6)
    pc = m.PrefixCache(sm.allocator)
    sm.prefix_cache = pc
    seq = sm.schedule(1, 12)
    sm.commit(1)
    pc.insert(np.arange(12), seq.blocks)
    sm.flush(1)
    obs = [sm._available_blocks(), sm.can_schedule(2, 24),
           sm.can_schedule_batch([2, 3], [12, 12])]
    blocks, n = pc.acquire(np.arange(12), max_tokens=11)
    seq = sm.attach_prefix(2, blocks, n)
    obs += [seq.blocks, seq.seen_tokens, seq.published]
    seq = sm.schedule(3, 16)                 # 4 blocks: evicts one leaf
    obs += [seq.blocks, pc.report()]
    sm.flush(3)
    seq = sm.restore(4, 3, 9)
    obs += [seq.blocks, seq.seen_tokens, seq.slot, pc.report()]
    return obs


CASES = [case_full_block_roundtrip, case_max_tokens_caps,
         case_lru_spares_referenced, case_lru_order,
         case_interior_after_leaves, case_max_blocks_cap,
         case_max_blocks_no_orphan, case_clear_releases_only_tree_refs,
         case_sequence_manager_reclaims]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_prefix_cache_state_matches_reference(case):
    assert case(tr) == case(jr)


def test_prefix_cache_reference_expectations():
    """The reference's own assertions, on the port (a parity with a shared
    bug would pass the test above)."""
    ins, (got, n), (_, n2), (acq, n3), rc, rep = case_full_block_roundtrip(tr)
    assert ins == 2 and n == 8 and n2 == 4 and n3 == 8 and rc == 3
    assert got == acq and rep["hits"] == 1 and rep["hit_tokens"] == 8
    assert case_max_tokens_caps(tr)[0][1] == 4
    _, evictable, evicted, (_, na), (_, nb), _ = case_lru_spares_referenced(tr)
    assert (evictable, evicted, na, nb) == (1, 1, 0, 4)
    freed, (_, na), (_, nb), _ = case_lru_order(tr)
    assert (freed, na, nb) == (1, 4, 0)
    e1, (_, n), e2, free, _ = case_interior_after_leaves(tr)
    assert (e1, n, e2, free) == (1, 4, 1, 4)
    n1, n2, rep = case_max_blocks_cap(tr)
    assert (n1, n2, rep["evicted_blocks"]) == (2, 2, 1)
    *_, free, leaked = case_max_blocks_no_orphan(tr)
    assert free == 8 and leaked == []
    cleared, rc, free, leaked = case_clear_releases_only_tree_refs(tr)
    assert (cleared, rc, free, leaked) == (1, 1, 4, [])


def _random_trace(m, seed: int, steps: int = 300):
    """A seeded random mix of allocate / insert / acquire / free / evict /
    clear on one cache; every step's return value and ``report()``."""
    rng = np.random.default_rng(seed)
    alloc = m.BlockedAllocator(24, 4)
    pc = m.PrefixCache(alloc, max_blocks=int(rng.integers(6, 20)))
    vocab = np.arange(3, dtype=np.int32)
    owned = []                        # (tokens, blocks) a "sequence" holds
    obs = []
    for _ in range(steps):
        op = rng.integers(0, 6)
        toks = rng.choice(vocab, size=int(rng.integers(1, 5)) * 4 + int(
            rng.integers(0, 4)))
        try:
            if op == 0 and alloc.free_blocks >= len(toks) // 4 + 1:
                blocks = alloc.allocate(len(toks) // 4 + 1)
                obs.append(("insert", pc.insert(toks, blocks), blocks))
                owned.append(blocks)
            elif op == 1:
                blocks, n = pc.acquire(toks, max_tokens=len(toks) - 1)
                obs.append(("acquire", blocks, n))
                if blocks:
                    owned.append(blocks)
            elif op == 2 and owned:
                blocks = owned.pop(int(rng.integers(0, len(owned))))
                alloc.free(blocks)
                obs.append(("free", blocks))
            elif op == 3:
                obs.append(("evict", pc.evict(int(rng.integers(1, 4)))))
            elif op == 4:
                obs.append(("peek", pc.peek_tiers(toks)))
            elif op == 5 and rng.random() < 0.1:
                obs.append(("clear", pc.clear()))
        except RuntimeError as e:
            obs.append(("raised", str(e)))
        obs.append((pc.report(), alloc.free_blocks))
    for blocks in owned:
        alloc.free(blocks)
    obs.append((pc.clear(), alloc.leaked_blocks()))
    return obs


@pytest.mark.parametrize("seed", range(4))
def test_random_trace_matches_reference(seed):
    got, want = _random_trace(tr, seed), _random_trace(jr, seed)
    assert got == want
    assert got[-1][1] == []           # the pool is whole again


# ---------------------------------------------------------------------------
# n-gram drafter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_ngram_draft_matches_reference_on_random_histories(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        h = rng.integers(0, 4 + seed, int(rng.integers(0, 40)))
        n, k = int(rng.integers(1, 5)), int(rng.integers(0, 7))
        np.testing.assert_array_equal(ngram_draft(h, n, k),
                                      jax_ngram(h, n, k))


def test_ngram_draft_reference_cases():
    h = [1, 2, 3, 9, 1, 2, 4, 7, 1, 2]
    assert list(ngram_draft(h, ngram=2, max_draft=3)) == [4, 7, 1]
    assert list(ngram_draft([5, 6, 7, 8, 6], ngram=2, max_draft=2)) == [7, 8]
    assert ngram_draft([1, 2, 3, 4], ngram=3, max_draft=4).size == 0
    assert ngram_draft([1], ngram=3, max_draft=4).size == 0
    assert ngram_draft([1, 1], ngram=2, max_draft=0).size == 0


# ---------------------------------------------------------------------------
# the engine: port against reference, fp32 tiny
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32():
    jm = JaxLM(jax_preset("tiny", dtype="float32"))
    params = jax.device_get(jm.init(jax.random.key(0)))
    return jm, params, TransformerLM(get_preset("tiny", dtype="float32"))


def _pair(f32, **kw):
    jm, params, tm = f32
    base = dict(max_sequences=8, max_seq_len=128, block_size=16)
    base.update(kw)
    j = JaxEngine(jm, params=jax.tree_util.tree_map(np.asarray, params),
                  decode_kernel="xla", **base)
    t = InferenceEngineV2(tm, params_from_numpy(params, device="cpu"),
                          device="cpu", **base)
    return {"jax": j, "torch": t}


@pytest.fixture(scope="module")
def feat(f32):
    return _pair(f32, prefix_cache=True, speculative=SPEC)


@pytest.fixture(scope="module")
def plain(f32):
    return _pair(f32)


@pytest.fixture(scope="module")
def small(f32):
    return _pair(f32, prefix_cache=True, num_blocks=12, max_seq_len=64)


def _reset(eng):
    eng.flush(list(eng.state.sequences))
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
        for k in eng.prefix_cache.counters:
            eng.prefix_cache.counters[k] = 0
    for k in eng.spec_stats:
        eng.spec_stats[k] = 0
    alloc = eng.state.allocator
    assert alloc.free_blocks == alloc.num_blocks, "leak from previous test"
    return eng


def _both(pair, fn):
    """``fn(engine)`` on the reference and the port (each reset first)."""
    return {name: fn(_reset(eng)) for name, eng in pair.items()}


def _ints(a):
    return [int(x) for x in a]


def test_warm_prefix_cache_is_token_identical(feat):
    prompt = np.concatenate([np.random.default_rng(0).integers(0, 250, 48),
                             np.random.default_rng(10).integers(0, 250, 5)])

    def run(eng):
        r1 = eng.put([1], [prompt])
        t1 = int(np.argmax(r1[1]))
        cold = _ints(eng.decode_batch([1], [t1], steps=8,
                                      speculative=False)[1])
        eng.flush([1])
        r2 = eng.put([2], [prompt])
        t2 = int(np.argmax(r2[2]))
        seq = eng.state.sequences[2]
        seen = seq.seen_tokens
        shared = [eng.state.allocator.refcount(b) for b in seq.blocks[:3]]
        warm = _ints(eng.decode_batch([2], [t2], steps=8,
                                      speculative=False)[2])
        eng.flush([2])
        rep = eng.prefix_cache.report()
        cleared = eng.prefix_cache.clear()
        return dict(cold=[t1] + cold, warm=[t2] + warm, r1=np.asarray(r1[1]),
                    r2=np.asarray(r2[2]), seen=seen,
                    shared=shared, rep=rep, cleared=cleared,
                    leaked=eng.state.allocator.leaked_blocks())

    got = _both(feat, run)
    t, j = got["torch"], got["jax"]
    assert t["cold"] == t["warm"] == j["cold"] == j["warm"]
    assert t["rep"]["hit_tokens"] == 48 and t["seen"] == 53
    assert all(rc >= 2 for rc in t["shared"])
    for k in ("seen", "shared", "rep", "cleared", "leaked"):
        assert t[k] == j[k], k
    np.testing.assert_allclose(t["r2"], j["r2"], **LOGIT_TOL)
    np.testing.assert_allclose(t["r2"], t["r1"], **LOGIT_TOL)


def test_partial_prefix_match_prefills_only_suffix(feat, plain):
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 250, 32)
    p_a = np.concatenate([shared, rng.integers(0, 250, 20)])
    p_b = np.concatenate([shared, rng.integers(0, 250, 24)])

    def run(eng):
        ra, rb = eng.put([1], [p_a]), eng.put([2], [p_b])
        hit = (eng.prefix_cache.counters["hit_tokens"]
               if eng.prefix_cache is not None else 0)
        eng.flush([1, 2])
        return np.asarray(ra[1]), np.asarray(rb[2]), hit

    warm, cold = _both(feat, run), _both(plain, run)
    assert warm["torch"][2] == warm["jax"][2] == 32
    for i in (0, 1):
        np.testing.assert_allclose(warm["torch"][i], warm["jax"][i],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(warm["torch"][i], cold["torch"][i],
                                   **LOGIT_TOL)
        assert np.argmax(warm["torch"][i]) == np.argmax(cold["jax"][i])


def test_fully_cached_prompt_still_computes_last_token(feat):
    prompt = np.random.default_rng(2).integers(0, 250, 64)

    def run(eng):
        r1 = eng.put([1], [prompt])
        eng.flush([1])
        r2 = eng.put([2], [prompt])
        return (eng.state.sequences[2].seen_tokens,
                eng.prefix_cache.counters["hit_tokens"],
                int(np.argmax(r1[1])), int(np.argmax(r2[2])))

    got = _both(feat, run)
    assert got["torch"] == got["jax"]
    seen, hit, a, b = got["torch"]
    assert seen == 64 and hit == 48 and a == b


@pytest.mark.parametrize("which", ["repeat", "random"])
def test_speculative_greedy_token_identical(feat, which):
    prompt = (np.tile([5, 6, 7, 8], 8) if which == "repeat"
              else np.random.default_rng(4).integers(0, 250, 30))

    def run(eng):
        r = eng.put([1], [np.asarray(prompt)])
        t = int(np.argmax(r[1]))
        ref = _ints(eng.decode_batch([1], [t], steps=20,
                                     speculative=False)[1])
        eng.flush([1])
        eng.put([2], [np.asarray(prompt)])
        got = _ints(eng.decode_batch([2], [t], steps=20,
                                     speculative=True)[2])
        eng.flush([2])
        return ref, got, dict(eng.spec_stats)

    res = _both(feat, run)
    t, j = res["torch"], res["jax"]
    assert t[0] == t[1] == j[0] == j[1]
    stats = {k: v for k, v in t[2].items() if k != "fused"}
    assert stats == {k: v for k, v in j[2].items() if k != "fused"}
    assert stats["rounds"] > 0
    if which == "repeat":
        assert stats["emitted"] > stats["rounds"]   # > 1 token a round


def test_spec_partial_accept_leaves_consistent_state(feat, plain):
    prompt = np.random.default_rng(5).integers(0, 250, 20)

    def run(eng):
        eng.put([1], [prompt])
        a = _ints(eng.decode_batch([1], [3], steps=10)[1])
        b = _ints(eng.decode_batch([1], [a[-1]], steps=10)[1])
        return a, b, eng.state.sequences[1].seen_tokens

    spec, ref = _both(feat, run), _both(plain, run)
    assert spec["torch"] == spec["jax"] == ref["torch"] == ref["jax"]


def test_spec_decode_round_matches_reference(feat):
    prompt = np.tile([9, 3, 4, 1, 2], 6)

    def run(eng):
        eng.put([1, 2], [prompt, prompt[:17]])
        toks = [9, 4]                 # fed tokens that continue the pattern
        drafts = eng.draft_tokens([1, 2], toks)
        res, info = eng.spec_decode_round([1, 2], toks)
        return ([_ints(d) for d in drafts], {u: _ints(v) for u, v in
                                             res.items()}, info,
                [eng.state.sequences[u].seen_tokens for u in (1, 2)])

    got = _both(feat, run)
    assert got["torch"] == got["jax"]
    assert got["torch"][2]["drafted"] > 0


def test_prefix_eviction_under_pool_pressure(small):
    def run(eng):
        rng = np.random.default_rng(6)
        firsts = []
        for uid in range(8):
            r = eng.put([uid], [rng.integers(0, 250, 40)])
            firsts.append(int(np.argmax(r[uid])))
            eng.flush([uid])
        rep = eng.prefix_cache.report()
        eng.prefix_cache.clear()
        return firsts, rep, eng.state.allocator.leaked_blocks()

    got = _both(small, run)
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["evicted_blocks"] > 0 and got["torch"][2] == []


def test_shared_blocks_never_evicted_or_double_freed(small):
    def run(eng):
        rng = np.random.default_rng(7)
        shared = rng.integers(0, 250, 32)
        eng.put([1], [np.concatenate([shared, rng.integers(0, 250, 4)])])
        eng.put([2], [np.concatenate([shared, rng.integers(0, 250, 4)])])
        pinned = [eng.state.allocator.refcount(b)
                  for b in eng.state.sequences[2].blocks[:2]]
        evicted = eng.prefix_cache.evict(12)
        eng.flush([1, 2])
        eng.prefix_cache.clear()
        return pinned, evicted, eng.state.allocator.free_blocks

    got = _both(small, run)
    assert got["torch"] == got["jax"]
    pinned, evicted, free = got["torch"]
    assert all(rc >= 3 for rc in pinned) and evicted == 0 and free == 12


def test_put_reject_is_side_effect_free_with_warm_cache(small):
    prompt = np.random.default_rng(9).integers(0, 250, 40)
    errors = {"jax": jr.CapacityError, "torch": CapacityError}

    def run(eng):
        kind = "torch" if isinstance(eng, InferenceEngineV2) else "jax"
        r1 = eng.put([1], [prompt])
        hog = eng.state.allocator.allocate(eng.state.allocator.free_blocks)
        with pytest.raises(errors[kind]):
            eng.put([2], [prompt])
        clean = 2 not in eng.state.sequences and 2 not in eng._hist
        eng.state.allocator.free(hog)
        r2 = eng.put([2], [prompt])
        out = (clean, eng.state.sequences[2].seen_tokens,
               eng.prefix_cache.counters["hit_tokens"],
               int(np.argmax(r1[1])), int(np.argmax(r2[2])))
        eng.flush([1, 2])
        return out

    got = _both(small, run)
    assert got["torch"] == got["jax"]
    clean, seen, hit, a, b = got["torch"]
    assert clean and seen == 40 and hit == 32 and a == b


def test_config_sections_reach_the_engine(f32):
    _, params, tm = f32
    tree = params_from_numpy(params, device="cpu")
    pc = PrefixCacheConfig.build({"enabled": True, "max_blocks": 32},
                                 "inference.prefix_cache")
    sc = SpeculativeConfig(enabled=True, ngram=4, max_draft=6)
    eng = InferenceEngineV2(tm, tree, device="cpu", max_sequences=2,
                            max_seq_len=64, block_size=16, prefix_cache=pc,
                            speculative=sc)
    assert eng.prefix_cache is not None and eng.prefix_cache.max_blocks == 32
    assert eng.spec_cfg.max_draft == 6 and eng._hist == {}
    eng = InferenceEngineV2(tm, tree, device="cpu", max_sequences=2,
                            max_seq_len=64, block_size=16,
                            prefix_cache={"enabled": True},
                            speculative=True)
    assert eng.spec_cfg.enabled and eng.spec_cfg.ngram == 3
    with pytest.raises(ValueError, match="max_draft"):
        SpeculativeConfig(enabled=True, max_draft=0)
    with pytest.raises(ValueError, match="max_blocks"):
        PrefixCacheConfig(enabled=True, max_blocks=0)
    with pytest.raises(ValueError, match="unknown config key"):
        PrefixCacheConfig.build({"enabled": True, "max_block": 3}, "pc")
    with pytest.raises(ValueError, match="packed"):
        InferenceEngineV2(tm, tree, device="cpu", max_sequences=2,
                          max_seq_len=64, prefix_cache=True, paged=False)
