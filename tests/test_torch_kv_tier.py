"""The PyTorch port's KV tiers against the JAX package's
(``tests/unit/test_prefix_cache.py`` ``TestKVTierStore``,
``TestNvmeBoundsAndBatchedPromotes``, ``TestTieredPrefixCache`` and the
tiered engine tests; ``tests/unit/test_migration.py``
``TestManifestProtocol``), on the CPU.

* ``KVTierStore``: every case runs the same operations on both packages'
  stores (host budget, NVMe spill through each package's build of
  ``csrc/aio.cpp``, loans, promote depth, NVMe cap and TTL, batched chain
  reads) and observes identical payloads, tiers, counters and
  ``report()``s;
* the tiered ``PrefixCache`` (a fake extract, no device): the same;
* manifests: the protocol's cases on the port, and a manifest written by
  either package loads in the other;
* the engine (fp32 ``tiny``, bridged weights, the JAX engine on its XLA
  twins): a prompt served cold, published, and promoted back after a full
  demotion to host and NVMe gives the same greedy tokens in the port and
  the reference, with identical prefix-cache and tier counters; a failed
  promote read zero-fills and drops the node; a ``clear()`` between attach
  and fence scatters nothing; ``close()`` with promotes pending drops the
  garbage nodes.
"""

import json
import os
import tempfile
import threading

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference import kv_tier as jk
from deepspeed_tpu.inference import ragged as jr
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference import kv_tier as tk
from deepspeed_tpu_torch.inference import ragged as tr
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from deepspeed_tpu_torch.ops import get_op_builder
from tests._torch_threads import one_torch_thread  # noqa: F401

PKG = {"torch": (tk, tr), "jax": (jk, jr)}


def _payload(v, shape=(2, 4)):
    return {"k": np.full(shape, v, np.float32),
            "v": np.full(shape, -v, np.float32)}


def _same(parts, v):
    return all(np.array_equal(parts[n], _payload(v)[n]) for n in ("k", "v"))


def _both(case, tmp_path):
    """``case(kv_tier module, ragged module, a fresh directory)`` on the
    port and the reference."""
    out = {}
    for name, (k, r) in PKG.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = case(k, r, str(d))
    return out


# ---------------------------------------------------------------------------
# KVTierStore
# ---------------------------------------------------------------------------

def store_host_roundtrip(k, r, d):
    store = k.KVTierStore(host_mb=1.0)
    obs = [store.put(0, _payload(3))]
    f = store.fetch_start(0)
    obs += [f.tier, _same(f.wait(), 3)]
    f.release()
    store.discard(0)
    return obs + [store.entries(), store.report()]


def store_spill_and_promote(k, r, d):
    store = k.KVTierStore(host_mb=100 / 2**20, nvme_path=d)
    for i in range(3):
        store.put(i, _payload(i))
    obs = [store.report()]
    f = store.fetch_start(0)
    obs += [f.tier, _same(f.wait(), 0)]
    f.release()
    store.close()
    return obs + [store.pool.report()]


def store_budget_without_nvme_drops(k, r, d):
    dropped = []
    store = k.KVTierStore(host_mb=100 / 2**20, on_drop=dropped.append)
    for i in range(4):
        store.put(i, _payload(i))
    live = [key for key in range(4) if store.has(key)]
    f = store.fetch_start(live[-1])
    obs = [dropped, live, _same(f.wait(), live[-1])]
    f.release()
    store.close()
    return obs + [store.report()]


def store_loaned_entry_never_spilled(k, r, d):
    dropped = []
    store = k.KVTierStore(host_mb=100 / 2**20, on_drop=dropped.append)
    store.put(0, _payload(0))
    f = store.fetch_start(0)
    parts = f.wait()
    before = parts["k"].copy()
    for i in range(1, 5):
        store.put(i, _payload(i))
    obs = [store.has(0), list(dropped), np.array_equal(parts["k"], before)]
    store.discard(0)
    obs.append(store.has(0))
    f.release()
    obs.append(store.has(0))
    store.close()
    return obs + [store.pool.report()]


def store_put_keeps_its_own_entry(k, r, d):
    store = k.KVTierStore(host_mb=40 / 2**20)
    dropped = []
    store.on_drop = dropped.append
    store.put(1, _payload(1))
    f = store.fetch_start(1)
    store.put(2, _payload(2))
    obs = [store.has(2), list(dropped)]
    f.release()
    store.put(3, _payload(3))
    obs += [store.has(3), sorted(dropped)]
    store.close()
    return obs + [store.pool.report()]


def store_promote_depth_defers(k, r, d):
    store = k.KVTierStore(host_mb=1 / 2**20, nvme_path=d, promote_depth=1)
    for i in range(3):
        store.put(i, _payload(i))
    f0, f1 = store.fetch_start(0), store.fetch_start(1)
    obs = [f0.submitted, f1.submitted, _same(f0.wait(), 0),
           _same(f1.wait(), 1)]
    f0.release()
    f1.release()
    store.close()
    return obs + [store.report()]


def store_nvme_cap_lru(k, r, d):
    dropped = []
    store = k.KVTierStore(host_mb=100 / 2**20, nvme_path=d,
                          nvme_max_mb=150 / 2**20, on_drop=dropped.append)
    for i in range(6):
        store.put(i, _payload(i))
    obs = [store.report(), list(dropped)]
    live = [key for key in range(6) if store.tier_of(key) == "nvme"]
    f = store.fetch_start(live[-1])
    obs.append(_same(f.wait(), live[-1]))
    f.release()
    store.close()
    return obs + [store.pool.report()]


def store_nvme_ttl(k, r, d):
    clock = [0.0]
    dropped = []
    store = k.KVTierStore(host_mb=100 / 2**20, nvme_path=d, nvme_ttl_s=10.0,
                          on_drop=dropped.append)
    store._now = lambda: clock[0]
    store.put(0, _payload(0))
    store.put(1, _payload(1))
    obs = [store.tier_of(0)]
    clock[0] = 5.0
    f = store.fetch_start(0)
    f.wait()
    f.release()
    clock[0] = 12.0
    store.put(2, _payload(2))
    obs.append(store.has(0))
    clock[0] = 30.0
    store.put(3, _payload(3))
    obs += [store.has(0), list(dropped), store.report()]
    store.close()
    return obs


def store_chain_one_ticket(k, r, d):
    store = k.KVTierStore(host_mb=100 / 2**20, nvme_path=d)
    for i in range(4):
        store.put(i, _payload(i))
    keys = [key for key in range(4) if store.tier_of(key) == "nvme"]
    singles, batches = [], []
    one, many = store.swapper.swap_in_start, store.swapper.swap_in_start_many
    store.swapper.swap_in_start = lambda n: singles.append(n) or one(n)
    store.swapper.swap_in_start_many = \
        lambda ns: batches.append(list(ns)) or many(ns)
    obs = [keys, store.begin_chain(keys)]
    try:
        fetches = [store.fetch_start(key) for key in keys]
        obs += [(f.tier, _same(f.wait(), key))
                for key, f in zip(keys, fetches)]
    finally:
        store.end_chain()
    for f in fetches:
        f.release()
    obs += [batches, singles, store._reads_inflight, store.report()]
    store.close()
    return obs


def store_chain_lazy_past_depth(k, r, d):
    store = k.KVTierStore(host_mb=100 / 2**20, nvme_path=d, promote_depth=1)
    for i in range(4):
        store.put(i, _payload(i))
    keys = [key for key in range(4) if store.tier_of(key) == "nvme"][:2]
    blocker = store.fetch_start(keys[0])
    obs = [store.begin_chain(keys)]
    try:
        f = store.fetch_start(keys[1])
        obs.append((f._batch is not None, f._batch.ticket is None))
        blocker.wait()
        blocker.release()
        obs.append(_same(f.wait(), keys[1]))
    finally:
        store.end_chain()
    f.release()
    obs += [store._reads_inflight, store.report()]
    store.close()
    return obs


def store_reentrant_discard(k, r, d):
    clock = [0.0]
    store = k.KVTierStore(host_mb=100 / 2**20, nvme_path=d, nvme_ttl_s=5.0)
    store._now = lambda: clock[0]
    store.on_drop = lambda key: store.discard(1 - key) if key in (0, 1) \
        else None
    for i in range(3):
        store.put(i, _payload(i))
    obs = [store.tier_of(0), store.tier_of(1)]
    clock[0] = 30.0
    store.put(3, _payload(3))
    obs += [store.has(0), store.has(1), store.report()]
    store.close()
    return obs


def store_lazy_chain_only_ridden(k, r, d):
    store = k.KVTierStore(host_mb=100 / 2**20, nvme_path=d, promote_depth=1)
    for i in range(5):
        store.put(i, _payload(i))
    keys = [key for key in range(5) if store.tier_of(key) == "nvme"]
    blocker = store.fetch_start(keys[0])
    obs = [keys, store.begin_chain(keys[1:4])]
    try:
        f1, f2 = store.fetch_start(keys[1]), store.fetch_start(keys[2])
    finally:
        store.end_chain()
    store.discard(keys[3])
    blocker.wait()
    blocker.release()
    obs += [_same(f1.wait(), keys[1]), _same(f2.wait(), keys[2])]
    f1.release()
    f2.release()
    obs += [store._reads_inflight, store.report()]
    store.close()
    return obs


def store_chain_survives_failed_demote_write(k, r, d):
    store = k.KVTierStore(host_mb=100 / 2**20, nvme_path=d)
    for i in range(5):
        store.put(i, _payload(i))
    keys = [key for key in range(5) if store.tier_of(key) == "nvme"]

    class BoomTicket:
        def wait(self):
            raise IOError("torn demote write")

    store._nvme[keys[0]].wticket = BoomTicket()
    obs = [store.begin_chain(keys)]
    try:
        obs.append(store.has(keys[0]))
        f = store.fetch_start(keys[1])
        obs.append(_same(f.wait(), keys[1]))
    finally:
        store.end_chain()
    f.release()
    obs += [store._reads_inflight, store.report()]
    store.close()
    return obs


def store_unridden_members_pinned(k, r, d):
    store = k.KVTierStore(host_mb=100 / 2**20, nvme_path=d,
                          nvme_max_mb=200 / 2**20)
    for i in range(4):
        store.put(i, _payload(i))
    keys = [key for key in range(4) if store.tier_of(key) == "nvme"][:3]
    obs = [keys, store.begin_chain(keys)]
    f = store.fetch_start(keys[0])
    store.end_chain()
    store.put(8, _payload(8))
    store.put(9, _payload(9))
    obs += [store.has(keys[1]), store.has(keys[2]), _same(f.wait(), keys[0])]
    f.release()
    store.put(10, _payload(10))
    obs += [store._reads_inflight, store.report()]
    store.close()
    return obs


STORE_CASES = [store_host_roundtrip, store_spill_and_promote,
               store_budget_without_nvme_drops,
               store_loaned_entry_never_spilled,
               store_put_keeps_its_own_entry, store_promote_depth_defers,
               store_nvme_cap_lru, store_nvme_ttl, store_chain_one_ticket,
               store_chain_lazy_past_depth, store_reentrant_discard,
               store_lazy_chain_only_ridden,
               store_chain_survives_failed_demote_write,
               store_unridden_members_pinned]


@pytest.mark.parametrize("case", STORE_CASES, ids=lambda c: c.__name__[6:])
def test_store_matches_reference(case, tmp_path):
    got = _both(case, tmp_path)
    assert got["torch"] == got["jax"]


def test_store_reference_expectations(tmp_path):
    """A few of the reference's own assertions, on the port."""
    obs = store_spill_and_promote(tk, tr, str(tmp_path / "a"))
    assert obs[0]["nvme_entries"] >= 1 and obs[1:3] == ["nvme", True]
    assert obs[3]["outstanding"] == 0
    obs = store_chain_one_ticket(tk, tr, str(tmp_path / "b"))
    keys, armed, *reads, batches, singles, inflight, rep = obs
    assert armed and len(keys) >= 3 and len(batches) == 1 and not singles
    assert all(t == ("nvme", True) for t in reads)
    assert rep["batched_reads"] == 1 and inflight == 0
    obs = store_nvme_ttl(tk, tr, str(tmp_path / "c"))
    assert obs[:3] == ["nvme", True, False] and 0 in obs[3]


# ---------------------------------------------------------------------------
# the tiered PrefixCache (fake extract: no device in the loop)
# ---------------------------------------------------------------------------

def _tiered(k, r, num_blocks=8, block_size=4, **store_kw):
    alloc = r.BlockedAllocator(num_blocks, block_size=block_size)
    pc = r.PrefixCache(alloc)
    store = k.KVTierStore(**{"host_mb": 1.0, **store_kw})
    payloads = {}
    pc.attach_tier_store(store, lambda blocks: [dict(payloads[b])
                                                for b in blocks])

    def publish(toks, val):
        blks = alloc.allocate(len(toks) // block_size)
        for b in blks:
            payloads[b] = _payload(val)
        pc.insert(toks, blks)
        alloc.free(blks)
        return blks

    publish.payloads = payloads
    return alloc, pc, store, publish


def _drain(pc, store, v=None):
    out = []
    for rec in pc.drain_promotes():
        out.append((rec.block, rec.tier,
                    None if v is None else _same(rec.fetch.wait(), v)))
        rec.fetch.release()
        store.discard(rec.key)
    return out


def tiered_demote_keeps_nodes(k, r, d):
    alloc, pc, store, publish = _tiered(k, r)
    toks = np.arange(8, dtype=np.int32)
    publish(toks, 1)
    return [pc.evict(2), alloc.free_blocks, pc.report(), pc.peek_tiers(toks)]


def tiered_acquire_promotes(k, r, d):
    alloc, pc, store, publish = _tiered(k, r)
    toks = np.arange(8, dtype=np.int32)
    publish(toks, 7)
    pc.evict(2)
    blocks, n = pc.acquire(toks)
    obs = [blocks, n, _drain(pc, store, 7),
           [alloc.refcount(b) for b in blocks], pc.evictable_blocks()]
    alloc.free(blocks)
    obs.append(pc.evictable_blocks())
    pc.clear()
    return obs + [alloc.free_blocks, alloc.leaked_blocks(), store.entries()]


def tiered_cancel_promotes(k, r, d):
    alloc, pc, store, publish = _tiered(k, r)
    toks = np.arange(8, dtype=np.int32)
    publish(toks, 5)
    pc.evict(2)
    blocks, n = pc.acquire(toks)
    recs = pc.drain_promotes()
    alloc.free(blocks)
    pc.cancel_promotes(recs)
    obs = [alloc.free_blocks, pc.report(), store.entries()]
    blocks2, n2 = pc.acquire(toks)
    obs += [blocks2, n2, _drain(pc, store, 5)]
    alloc.free(blocks2)
    pc.clear()
    return obs + [alloc.leaked_blocks(), store.entries()]


def tiered_republish_readopts(k, r, d):
    alloc, pc, store, publish = _tiered(k, r)
    toks = np.arange(8, dtype=np.int32)
    publish(toks, 2)
    pc.evict(2)
    obs = [store.entries()]
    publish(toks, 2)
    return obs + [pc.report(), store.entries(), pc.peek_tiers(toks)]


def tiered_dropped_entry_detaches(k, r, d):
    alloc, pc, store, publish = _tiered(k, r, num_blocks=16,
                                        host_mb=150 / 2**20)
    for i in range(4):
        publish(np.arange(i * 100, i * 100 + 8, dtype=np.int32), i)
        pc.evict(2)
    obs = [store.counters["dropped"], pc.report()]
    for i in range(4):
        blocks, n = pc.acquire(np.arange(i * 100, i * 100 + 8,
                                         dtype=np.int32))
        obs += [blocks, n, _drain(pc, store)]
        alloc.free(blocks)
    pc.clear()
    return obs + [alloc.free_blocks, store.pool.report()]


def tiered_deep_chain_bottom_up(k, r, d):
    alloc, pc, store, publish = _tiered(k, r)
    toks = np.arange(16, dtype=np.int32)
    publish(toks, 9)
    return [pc.evict(4), pc.report(), pc.peek_tiers(toks)]


def tiered_pending_upload_resists(k, r, d):
    alloc, pc, store, publish = _tiered(k, r)
    toks = np.arange(8, dtype=np.int32)
    publish(toks, 3)
    pc.evict(2)
    blocks, n = pc.acquire(toks)
    recs = pc.drain_promotes()
    alloc.free(blocks)
    obs = [pc.evict(2), pc.report()["blocks"]]
    for rec in recs:
        obs.append(_same(rec.fetch.wait(), 3))
        rec.fetch.release()
        store.discard(rec.key)
        publish.payloads[rec.block] = _payload(3)
    pc.mark_uploaded(recs)
    obs.append(pc.evict(2))
    pc.clear()
    return obs + [alloc.free_blocks, alloc.leaked_blocks(), store.entries()]


def tiered_deep_chain_no_recursion_limit(k, r, d):
    alloc, pc, store, publish = _tiered(k, r, num_blocks=1300, host_mb=4.0)
    toks = np.arange(4800, dtype=np.int32)
    publish(toks, 1)
    obs = [pc.evict(1200), pc.report()]
    pc.clear()
    return obs + [store.entries(), alloc.leaked_blocks()]


def tiered_demote_failure_drops_orphans(k, r, d):
    alloc, pc, store, publish = _tiered(k, r)
    toks = np.arange(12, dtype=np.int32)
    publish(toks, 4)
    obs = [pc.evict(1), store.entries()]

    def broken_put(key, parts):
        raise RuntimeError("pinned copy failed")

    store.put = broken_put
    obs += [pc.evict(1), store.entries(), pc.report()]
    blocks, n = pc.acquire(toks)
    obs += [blocks, n, pc.drain_promotes()]
    alloc.free(blocks)
    pc.clear()
    return obs + [alloc.leaked_blocks()]


def tiered_acquire_pins_chain(k, r, d):
    alloc, pc, store, publish = _tiered(k, r, num_blocks=4,
                                        host_mb=40 / 2**20, nvme_path=d,
                                        nvme_max_mb=150 / 2**20)
    toks = np.arange(12, dtype=np.int32)
    publish(toks, 1)
    pc.evict(3)
    obs = [store.report()["nvme_entries"]]
    publish(np.arange(100, 112, dtype=np.int32), 2)
    obs.append(alloc.free_blocks)
    blocks, n = pc.acquire(toks)
    recs = pc.drain_promotes()
    for rec in recs:
        obs.append(_same(rec.fetch.wait(), 1))
        rec.fetch.release()
        store.discard(rec.key)
    pc.mark_uploaded(recs)
    if blocks:
        alloc.free(blocks)
    pc.clear()
    obs += [blocks, n, alloc.leaked_blocks(), store.pool.report()]
    store.close()
    return obs


def tiered_acquire_chain_one_ticket(k, r, d):
    alloc, pc, store, publish = _tiered(k, r, host_mb=40 / 2**20,
                                        nvme_path=d)
    toks = np.arange(12, dtype=np.int32)
    publish(toks, 9)
    pc.evict(3)
    obs = [store.report()["nvme_entries"]]
    blocks, n = pc.acquire(toks)
    obs += [blocks, n, _drain(pc, store, 9), store.counters["batched_reads"]]
    alloc.free(blocks)
    pc.clear()
    obs += [alloc.leaked_blocks(), store.entries(), store.pool.report()]
    store.close()
    return obs


TIERED_CASES = [tiered_demote_keeps_nodes, tiered_acquire_promotes,
                tiered_cancel_promotes, tiered_republish_readopts,
                tiered_dropped_entry_detaches, tiered_deep_chain_bottom_up,
                tiered_pending_upload_resists,
                tiered_deep_chain_no_recursion_limit,
                tiered_demote_failure_drops_orphans,
                tiered_acquire_pins_chain, tiered_acquire_chain_one_ticket]


@pytest.mark.parametrize("case", TIERED_CASES, ids=lambda c: c.__name__[7:])
def test_tiered_prefix_cache_matches_reference(case, tmp_path):
    got = _both(case, tmp_path)
    assert got["torch"] == got["jax"]


def test_tiered_prefix_cache_reference_expectations(tmp_path):
    freed, free, rep, info = tiered_demote_keeps_nodes(tk, tr, "")
    assert freed == 2 and free == 8
    assert rep["blocks"] == 0 and rep["demoted_nodes"] == 2
    assert info["matched_tokens"] == 8 and info["demoted_blocks"] == 2
    obs = tiered_acquire_chain_one_ticket(tk, tr, str(tmp_path))
    assert obs[0] == 2 and obs[2] == 12 and obs[4] == 1
    assert all(ok for _, _, ok in obs[3])
    obs = tiered_pending_upload_resists(tk, tr, "")
    assert obs[:2] == [0, 2] and obs[-4] == 2 and obs[-2:] == [[], 0]


# ---------------------------------------------------------------------------
# manifests (durable migration)
# ---------------------------------------------------------------------------

def _manifest(uid="u1"):
    return {"uid": uid, "seen_tokens": 11, "hist": [3, 1, 4, 1, 5],
            "entries": [{"name": f"{uid}-k0", "tier": "nvme", "nbytes": 64}]}


class TestManifestProtocol:
    def test_roundtrip(self, tmp_path):
        path = tk.write_manifest(str(tmp_path), _manifest())
        assert os.path.dirname(path) == tk.manifest_dir(str(tmp_path))
        assert os.path.basename(path) == "u1.json"
        assert tk.load_manifest(path) == _manifest()
        assert not [f for f in os.listdir(tk.manifest_dir(str(tmp_path)))
                    if f.endswith(".tmp")]

    @pytest.mark.parametrize("writer", ["torch", "jax"])
    def test_either_package_reads_the_other(self, tmp_path, writer):
        w, rd = (tk, jk) if writer == "torch" else (jk, tk)
        path = w.write_manifest(str(tmp_path), _manifest())
        assert rd.load_manifest(path) == _manifest()
        assert open(path).read() == open(jk.write_manifest(
            str(tmp_path / "again"), _manifest())).read()

    @pytest.mark.parametrize("damage", ["torn", "sha", "version"])
    def test_damaged_manifest_raises(self, tmp_path, damage):
        path = tk.write_manifest(str(tmp_path), _manifest())
        raw = open(path).read()
        doc = json.loads(raw)
        if damage == "torn":
            text = raw[:len(raw) // 2]
        elif damage == "sha":
            doc["payload"]["seen_tokens"] = 999
            text = json.dumps(doc)
        else:
            doc["version"] = 999
            text = json.dumps(doc)
        with open(path, "w") as f:
            f.write(text)
        with pytest.raises(tk.ManifestError):
            tk.load_manifest(path)

    def test_missing_raises_filenotfound(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            tk.load_manifest(str(tmp_path / "manifests" / "nope.json"))

    def test_claim_exactly_one_winner(self, tmp_path):
        path = tk.write_manifest(str(tmp_path), _manifest())
        claimed = tk.claim_manifest(path)
        assert claimed == path + ".claimed" and os.path.exists(claimed)
        assert tk.claim_manifest(path) is None
        assert tk.load_manifest(claimed) == _manifest()

    def test_claim_race_threaded(self, tmp_path):
        for round_ in range(8):
            path = tk.write_manifest(str(tmp_path), _manifest(f"r{round_}"))
            wins, barrier = [], threading.Barrier(2)

            def race():
                barrier.wait()
                got = tk.claim_manifest(path)
                if got is not None:
                    wins.append(got)

            ts = [threading.Thread(target=race) for _ in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert len(wins) == 1
            os.remove(wins[0])

    def test_sweep_reclaims_aged_manifests_and_kv(self, tmp_path):
        shared = str(tmp_path)
        os.makedirs(os.path.join(shared, "kv"))
        swp = os.path.join(shared, "kv", "u1-k0.swp")
        open(swp, "wb").write(b"\0" * 64)
        path = tk.write_manifest(shared, _manifest())
        tk.claim_manifest(tk.write_manifest(shared, _manifest("u2")))
        stray = os.path.join(tk.manifest_dir(shared), "junk.json.tmp")
        open(stray, "w").write("{")
        now = os.path.getmtime(path) + 100.0
        assert tk.sweep_manifests(shared, ttl_s=1e9, now=now) == 0
        assert tk.sweep_manifests(shared, ttl_s=0, now=now) == 0
        assert tk.sweep_manifests(shared, ttl_s=50.0, now=now) == 2
        assert not os.path.exists(path) and not os.path.exists(swp)
        assert not os.path.exists(stray)
        fresh = tk.write_manifest(shared, _manifest("u3"))
        assert tk.sweep_manifests(shared, ttl_s=1e6,
                                  now=os.path.getmtime(fresh) + 1) == 0
        assert os.path.exists(fresh)


def test_async_io_builder_is_registered():
    b = get_op_builder("async_io")
    assert b.is_compatible()
    lib = b.load()
    assert lib is get_op_builder("async_io").load()
    h = lib.ds_aio_handle_create(2)
    assert lib.ds_aio_pending(h) == 0
    lib.ds_aio_handle_destroy(h)


# ---------------------------------------------------------------------------
# the tiered engine: port against reference, fp32 tiny
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tier_pair(tmp_path_factory):
    jm = JaxLM(jax_preset("tiny", dtype="float32"))
    params = jax.device_get(jm.init(jax.random.key(0)))
    tm = TransformerLM(get_preset("tiny", dtype="float32"))
    out = {}
    for name in ("jax", "torch", "plain"):
        nvme = tmp_path_factory.mktemp(f"kv_tier_{name}")
        kw = dict(max_sequences=8, max_seq_len=128, block_size=16)
        if name != "plain":
            kw.update(num_blocks=24, prefix_cache={
                "enabled": True, "tiers": {
                    "enabled": True, "host_mb": 2 * 16384 / 2**20,
                    "nvme_path": str(nvme), "promote_depth": 2}})
        if name == "jax":
            out[name] = JaxEngine(jm, params=params, decode_kernel="xla",
                                  **kw)
        else:
            out[name] = InferenceEngineV2(
                tm, params_from_numpy(params, device="cpu"), device="cpu",
                **kw)
    yield out
    for eng in out.values():
        eng.close()


def _reset(eng):
    eng.flush(list(eng.state.sequences))
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
    alloc = eng.state.allocator
    assert alloc.free_blocks == alloc.num_blocks, "leak from previous test"
    return eng


def _gen(eng, uid, prompt, steps=6):
    r = eng.put([uid], [prompt])
    out = [int(np.argmax(r[uid]))]
    out += [int(t) for t in eng.decode_batch([uid], [out[0]],
                                             steps=steps)[uid]]
    eng.flush([uid])
    return out


def test_tiered_demote_promote_token_identical(tier_pair):
    prompt = np.random.default_rng(3).integers(0, 250, 52)
    base = _gen(_reset(tier_pair["plain"]), 0, prompt)
    seen = {}
    for name in ("torch", "jax"):
        eng = _reset(tier_pair[name])
        pc = eng.prefix_cache
        c0 = dict(pc.counters)
        first = _gen(eng, 1, prompt)
        blocks = pc.report()["blocks"]
        pc.evict(10)
        demoted = pc.report()
        promoted = _gen(eng, 2, prompt)
        rep = pc.report()
        counters = {k: rep[k] - c0[k] for k in c0}
        pc.clear()
        seen[name] = dict(first=first, promoted=promoted, blocks=blocks,
                          demoted={k: v for k, v in demoted.items()
                                   if k != "tiers"},
                          counters=counters,
                          free=eng.state.allocator.free_blocks,
                          entries=eng._tier_store.entries(),
                          outstanding=eng._tier_store.pool.report()[
                              "outstanding"])
        assert first == base and promoted == base, name
    assert seen["torch"]["blocks"] == 3
    assert seen["torch"]["counters"]["promoted_blocks"] == 3
    assert seen["torch"]["entries"] == 0 and seen["torch"]["outstanding"] == 0
    for key in ("demoted", "counters", "free", "entries", "outstanding"):
        assert seen["torch"][key] == seen["jax"][key], key
    rep = tier_pair["torch"].tier_report()
    assert set(rep) == set(tier_pair["jax"].tier_report())


def test_promote_read_failure_zero_fills_and_restores_loans(tier_pair):
    eng = _reset(tier_pair["torch"])
    prompt = np.random.default_rng(6).integers(0, 250, 52)
    _gen(eng, 30, prompt)
    eng.prefix_cache.evict(10)
    assert eng.prefix_attach(31, prompt) > 0 and eng._promote_q
    bad = eng._promote_q[0]

    class _BoomFetch:                      # KVFetch is slotted: wrap it
        def __init__(self, inner):
            self.inner, self.tier = inner, inner.tier

        def wait(self):
            raise RuntimeError("pinned pool exhausted")

        def release(self):
            self.inner.release()

    bad.fetch = _BoomFetch(bad.fetch)
    c = eng._tier_store.counters
    m0 = c["host_misses"] + c["nvme_misses"]
    eng._flush_promotes()
    assert not eng._promote_q
    assert c["host_misses"] + c["nvme_misses"] == m0 + 1
    assert not eng.prefix_cache._pending_upload
    pc = eng.prefix_cache
    assert pc.counters["tier_lost_blocks"] >= 1
    assert pc.peek_tiers(prompt, max_tokens=51)["matched_tokens"] == 0
    # the zero-filled block serves the acquirer: its pages are zeros
    blk = eng.state.sequences[31].blocks[0]
    assert not eng.cache["k"][:, blk].any()
    eng.flush([31])
    pc.clear()
    assert not eng.state.allocator.leaked_blocks()
    assert eng._tier_store.entries() == 0
    assert eng._tier_store.pool.report()["outstanding"] == 0
    assert eng._tier_store.swapper.report()["loaned_read_buffers"] == 0


def test_clear_between_attach_and_fence_discards_stale_promotes(tier_pair):
    eng = _reset(tier_pair["torch"])
    prompt = np.random.default_rng(7).integers(0, 250, 52)
    ref = _gen(eng, 40, prompt)
    eng.prefix_cache.evict(10)
    assert eng.prefix_attach(41, prompt) > 0 and eng._promote_q
    eng.prefix_cache.clear()
    eng.flush([41])

    def must_not_scatter(*a, **kw):
        raise AssertionError("fence scattered a stale promote")

    eng._promote_impl = must_not_scatter
    try:
        eng._flush_promotes()
    finally:
        del eng._promote_impl
    assert not eng._promote_q
    assert eng._tier_store.pool.report()["outstanding"] == 0
    assert _gen(eng, 42, prompt) == ref
    eng.prefix_cache.clear()
    assert not eng.state.allocator.leaked_blocks()


def test_close_with_pending_promotes_drops_garbage_nodes(tmp_path):
    tm = TransformerLM(get_preset("tiny", dtype="float32"))
    eng = InferenceEngineV2(
        tm, tm.init(seed=0, device="cpu"), device="cpu", max_sequences=4,
        max_seq_len=128, block_size=16, num_blocks=24, prefix_cache={
            "enabled": True, "tiers": {"enabled": True,
                                       "host_mb": 2 * 16384 / 2**20,
                                       "nvme_path": str(tmp_path)}})
    prompt = np.random.default_rng(8).integers(0, 250, 52)
    _gen(eng, 50, prompt)
    eng.prefix_cache.evict(10)
    assert eng.prefix_attach(51, prompt) > 0 and eng._promote_q
    pc = eng.prefix_cache
    eng.flush([51])
    eng.close()
    assert eng._tier_store is None and pc.tier_store is None
    assert pc.peek_tiers(prompt, max_tokens=51)["matched_tokens"] == 0
    assert not pc._pending_upload
    alloc = eng.state.allocator
    assert alloc.free_blocks == alloc.num_blocks
    assert not alloc.leaked_blocks()


def test_tiers_config_reaches_engine(tmp_path):
    tm = TransformerLM(get_preset("tiny", dtype="float32"))
    eng = InferenceEngineV2(
        tm, device="cpu", max_sequences=2, max_seq_len=64, block_size=16,
        prefix_cache={"enabled": True, "tiers": {
            "enabled": True, "host_mb": 0.5, "nvme_path": str(tmp_path),
            "promote_depth": 3}})
    try:
        store = eng._tier_store
        assert store.host_bytes == int(0.5 * 2**20)
        assert store.promote_depth == 3 and store.swapper is not None
        assert eng.prefix_cache.tier_store is store
        assert not store.pool.pin           # CPU engine: pageable buffers
    finally:
        eng.close()
    assert eng._tier_store is None
    from deepspeed_tpu_torch.config import KVTierConfig

    for bad in (dict(host_mb=0), dict(promote_depth=0),
                dict(nvme_max_mb=-1)):
        with pytest.raises(ValueError):
            KVTierConfig(**bad)
    # autotune=True adopts the AIO bench's cached winner for the swap
    # device (ops/aio_bench.py; no sweep when the cache holds one)
    from deepspeed_tpu_torch.offload import AsyncTensorSwapper

    swap_dir = tempfile.mkdtemp(dir=str(tmp_path))
    cache = os.path.join(str(tmp_path), "aio.json")
    dev = f"{os.stat(swap_dir).st_dev}:buf"
    with open(cache, "w") as f:
        json.dump({dev: {"threads": 3, "chunk_mb": 2}}, f)
    sw = AsyncTensorSwapper(swap_dir, autotune=True, autotune_cache=cache)
    try:
        assert (sw.num_threads, sw.chunk_bytes) == (3, 2 << 20)
        assert sw.report()["autotuned"] == {"threads": 3, "chunk_mb": 2}
    finally:
        sw.close()
