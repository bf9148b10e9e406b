"""Durable cross-replica migration in the port's serving layer against the
JAX package's, on the CPU (the scenarios of the reference's
``tests/unit/test_migration.py`` that adopt across batchers).

Each scenario runs once per package through the same code (fp32 ``tiny``,
bridged weights; see ``tests/test_torch_serving.py``): pause on a donor
batcher, export its durable manifest onto a shared namespace, adopt on a
sibling, and finish -- the greedy tokens bit-identical to an unmigrated
run -- or fall down the ladder to re-prefill from token history; the
migration faults (a crash during the export, a torn manifest, a failed
adopted read); a voluntary rebalance; one trace id from donor to sibling.
Outcome records must be equal across the packages. The engines are built
once per process; each scenario closes their tier stores at its end so the
next one re-creates them on its own namespace. The last test drains a
router under SIGTERM with migration on, as the reference does: in-flight
requests finish on the draining replica and only queued ones move.
"""

import os
import queue
import signal
import time

import pytest

from tests.test_torch_serving import (_whole_pools, both, ledger,  # noqa: F401
                                      pool_whole, prompt, sides)
from tests._torch_threads import one_torch_thread  # noqa: F401

SLO = {"enabled": True, "preempt": True}


def mig_batcher(s, kind, shared, **serving):
    """fp32 engine ``kind`` + SLO preemption + migration onto ``shared``."""
    cfg = s.cfg(**{"prefill_chunk": 32, "default_max_new_tokens": 8,
                   "slo": SLO,
                   "migration": {"enabled": True, "shared_nvme_path": shared,
                                 "manifest_ttl_s": 300.0}, **serving})
    return s.ContinuousBatcher(s.engine(kind), cfg)


def namespace(s, tmp_path):
    path = tmp_path / s.name
    path.mkdir(exist_ok=True)
    return str(path)


def close_all(*batchers):
    for b in batchers:
        b.engine.close()


def baseline(s, shared, p, n=8):
    solo = mig_batcher(s, "a", shared)
    uid = solo.submit(p, max_new_tokens=n, tier="batch")
    solo.pump(max_steps=80)
    base = list(solo.manager.result(uid).generated)
    close_all(solo)
    assert len(base) == n
    return base


def pause_mid_decode(b, uid):
    for _ in range(4):
        b.step()
    req = b.manager.active[uid]
    assert 0 < len(req.generated) < req.max_new_tokens
    assert b.engine.pause_request(uid)
    b.manager.pause(req)
    b._export_manifest(req)
    return req


def hand_off(s, a, uid):
    """Ownership transfer of ``uid``'s export (what a dead donor's capture
    does), claimed by a sibling: (claimed path, payload)."""
    path = a.engine.export_paused(uid, f"{a.migration_tag}-{uid}",
                                  a._mig.shared_nvme_path, keep=False)
    assert path is not None and os.path.exists(path)
    claimed = s.kv_tier.claim_manifest(path)
    assert claimed is not None
    return claimed, s.kv_tier.load_manifest(claimed)


def _durable_mid_decode(s, tmp_path):
    shared = namespace(s, tmp_path)
    p = prompt(40, 7)
    base = baseline(s, shared, p)
    a = mig_batcher(s, "a", shared)
    uid = a.submit(p, max_new_tokens=8, tier="batch")
    req = pause_mid_decode(a, uid)
    mid = len(req.generated)
    claimed, payload = hand_off(s, a, uid)
    b = mig_batcher(s, "b", shared)
    new = b.adopt_inflight(req, payload, claimed, migrated_from="a")
    assert b.engine.is_paused(new.uid)
    b.pump(max_steps=80)
    res = b.manager.result(new.uid)
    assert list(res.generated) == base and len(res.generated) > mid
    assert b.engine._tier_store.entries() == 0 and not os.path.exists(claimed)
    out = (mid, payload["seen_tokens"], len(payload["entries"]), base,
           ledger(b, [new.uid]), new.migrated_from,
           a.counters["pause_exports"], b.manager.counters["adopted"],
           b.counters["reprefill_fallbacks"])
    close_all(a, b)
    return out


def _donor_gc_reprefill(s, tmp_path):
    shared = namespace(s, tmp_path)
    p = prompt(40, 11)
    base = baseline(s, shared, p)
    a = mig_batcher(s, "a", shared)
    uid = a.submit(p, max_new_tokens=8, tier="batch")
    req = pause_mid_decode(a, uid)
    path = a.engine.export_paused(uid, f"{a.migration_tag}-{uid}", shared,
                                  keep=False)
    kv_dir = os.path.join(shared, "kv")
    for f in os.listdir(kv_dir):
        os.remove(os.path.join(kv_dir, f))
    b = mig_batcher(s, "b", shared)
    claimed = s.kv_tier.claim_manifest(path)
    with pytest.raises(Exception):
        b.adopt_inflight(req, s.kv_tier.load_manifest(claimed), claimed,
                         migrated_from="a")
    assert not b.manager.active and not b.manager.queue
    new = b.adopt_inflight(req, None, None, migrated_from="a")
    replay = [int(t) for t in new.replay]
    b.pump(max_steps=120)
    assert list(b.manager.result(new.uid).generated) == base
    out = (replay, base, ledger(b, [new.uid]))
    close_all(a, b)
    return out


def _reprefill_mid_prefill(s, tmp_path):
    shared = namespace(s, tmp_path)
    p = prompt(96, 13)
    base = baseline(s, shared, p)
    a = mig_batcher(s, "a", shared)
    uid = a.submit(p, max_new_tokens=8, tier="batch")
    a.step()
    req = a.manager.active[uid]
    assert 0 < req.prefilled < len(p)
    b = mig_batcher(s, "b", shared)
    new = b.adopt_inflight(req, None, None, migrated_from="a")
    b.pump(max_steps=120)
    assert list(b.manager.result(new.uid).generated) == base
    a.manager.cancel(uid)
    out = (req.prefilled, base, ledger(b, [new.uid]))
    close_all(a, b)
    return out


def _double_adopt(s, tmp_path):
    shared = namespace(s, tmp_path)
    p = prompt(40, 17)
    base = baseline(s, shared, p)
    a = mig_batcher(s, "a", shared)
    uid = a.submit(p, max_new_tokens=8, tier="batch")
    req = pause_mid_decode(a, uid)
    path = a.engine.export_paused(uid, f"{a.migration_tag}-{uid}", shared,
                                  keep=False)
    c1, c2 = s.kv_tier.claim_manifest(path), s.kv_tier.claim_manifest(path)
    assert (c1 is None) != (c2 is None)
    winner = c1 or c2
    b1, b2 = mig_batcher(s, "b", shared), mig_batcher(s, "c", shared)
    w = b1.adopt_inflight(req, s.kv_tier.load_manifest(winner), winner,
                          migrated_from="a")
    loser = b2.adopt_inflight(req, None, None, migrated_from="a")
    b1.pump(max_steps=80)
    b2.pump(max_steps=120)
    assert list(b1.manager.result(w.uid).generated) == base
    assert list(b2.manager.result(loser.uid).generated) == base
    out = (base, ledger(b1, [w.uid]), ledger(b2, [loser.uid]))
    close_all(a, b1, b2)
    return out


def _crash_during_export(s, tmp_path):
    shared = namespace(s, tmp_path)
    p = prompt(40, 19)
    base = baseline(s, shared, p)
    a = mig_batcher(s, "a", shared)
    uid = a.submit(p, max_new_tokens=8, tier="batch")
    for _ in range(4):
        a.step()
    req = a.manager.active[uid]
    assert a.engine.pause_request(uid)
    a.manager.pause(req)
    s.injector([{"kind": "crash_during_pause_export"}])
    a._export_manifest(req)
    s.injector(None)
    mdir = s.kv_tier.manifest_dir(shared)
    assert not os.path.exists(os.path.join(
        mdir, f"{a.migration_tag}-{uid}.json"))
    kv_dir = os.path.join(shared, "kv")
    assert not (os.path.isdir(kv_dir) and os.listdir(kv_dir))
    a.pump(max_steps=80)
    assert list(a.manager.result(uid).generated) == base
    out = (a.counters["pause_exports"], base, ledger(a, [uid]))
    close_all(a)
    return out


def _manifest_torn(s, tmp_path):
    shared = namespace(s, tmp_path)
    a = mig_batcher(s, "a", shared)
    uid = a.submit(prompt(40, 23), max_new_tokens=8, tier="batch")
    for _ in range(4):
        a.step()
    req = a.manager.active[uid]
    assert a.engine.pause_request(uid)
    a.manager.pause(req)
    s.injector([{"kind": "manifest_torn"}])
    path = a.engine.export_paused(uid, f"{a.migration_tag}-{uid}", shared,
                                  keep=False)
    s.injector(None)
    assert path is not None
    with pytest.raises(s.kv_tier.ManifestError):
        s.kv_tier.load_manifest(path)
    a.manager.cancel(uid)
    out = ledger(a, [uid])
    close_all(a)
    return out


def _migrate_io_error(s, tmp_path):
    shared = namespace(s, tmp_path)
    p = prompt(40, 29)
    base = baseline(s, shared, p)
    a = mig_batcher(s, "a", shared)
    uid = a.submit(p, max_new_tokens=8, tier="batch")
    req = pause_mid_decode(a, uid)
    claimed, payload = hand_off(s, a, uid)
    b = mig_batcher(s, "b", shared)
    new = b.adopt_inflight(req, payload, claimed, migrated_from="a")
    s.injector([{"kind": "migrate_io_error"}])
    b.pump(max_steps=10)
    s.injector(None)
    b.pump(max_steps=120)
    assert list(b.manager.result(new.uid).generated) == base
    assert b.counters["reprefill_fallbacks"] == 1
    assert b.manager.counters["reprefills"] == 1
    out = (base, ledger(b, [new.uid]), b.counters["resume_failures"])
    close_all(a, b)
    return out


def _rebalance(s, tmp_path):
    shared = namespace(s, tmp_path)
    p = prompt(40, 31)
    base = baseline(s, shared, p)
    a = mig_batcher(s, "a", shared)
    uid = a.submit(p, max_new_tokens=8, tier="batch")
    pause_mid_decode(a, uid)
    out = a.export_paused_for_rebalance()
    assert len(out) == 1 and out[0][0].uid == uid
    req, path = out[0]
    assert a.manager.result(uid).finish_reason == "rebalanced"
    assert not a.engine.is_paused(uid) and pool_whole(a.engine)
    b = mig_batcher(s, "b", shared)
    claimed = s.kv_tier.claim_manifest(path)
    new = b.adopt_inflight(req, s.kv_tier.load_manifest(claimed), claimed,
                           migrated_from="a")
    b.pump(max_steps=80)
    assert list(b.manager.result(new.uid).generated) == base
    rec = (ledger(a, [uid]), a.manager.counters["rebalanced"], base,
           ledger(b, [new.uid]))
    close_all(a, b)
    return rec


def _trace_donor_to_sibling(s, tmp_path):
    shared = namespace(s, tmp_path)
    bus = s.obs.configure_tracing(enabled=True)
    bus.clear()
    try:
        a = mig_batcher(s, "a", shared)
        uid = a.submit(prompt(40, 37), max_new_tokens=8, tier="batch")
        req = pause_mid_decode(a, uid)
        donor_trace = req.trace_id
        assert donor_trace is not None
        claimed, payload = hand_off(s, a, uid)
        b = mig_batcher(s, "b", shared)
        new = b.adopt_inflight(req, payload, claimed, migrated_from="a")
        assert new.trace_id == donor_trace
        b.pump(max_steps=80)
        whats = [(e.args or {}).get("what") for e in s.obs.get_bus().events()
                 if e.trace_id == donor_trace]
        assert {"pause", "adopt", "resume"} <= set(whats)
        out = (whats, ledger(b, [new.uid]))
        close_all(a, b)
    finally:
        s.obs.configure_tracing(enabled=False)
        bus.clear()
    return out


@pytest.mark.parametrize("scenario", [
    _durable_mid_decode, _donor_gc_reprefill, _reprefill_mid_prefill,
    _double_adopt, _crash_during_export, _manifest_torn, _migrate_io_error,
    _rebalance, _trace_donor_to_sibling], ids=lambda f: f.__name__.strip("_"))
def test_migration_matches_reference(sides, tmp_path, scenario):
    both(sides, scenario, tmp_path)


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError("condition not reached in time")


class _FreezeAtToken(queue.Queue):
    """A request's event stream that freezes its replica's worker (its
    commands still run) at the request's first token, so that a drain
    finds the request mid-decode whatever the timing."""

    def __init__(self, rep):
        super().__init__()
        self.rep, self.froze = rep, False

    def put(self, item, block=True, timeout=None):
        if item.get("event") == "token" and not self.froze:
            self.froze = self.rep.paused = True
        super().put(item, block, timeout)


# pool -> (replicas, the SIGTERM handler's drain target, requests re-homed)
DRAINS = {"sibling": (2, "r0", 2), "one-replica": (1, None, 2),
          "whole-pool": (2, None, 6)}


def _sigterm_drain(s, tmp_path, pool):
    """The reference's drain under SIGTERM, with migration on and SLO off:
    each replica holds two requests in flight and two queued; the in-flight
    finish on their draining replica, the queued move to a routable
    sibling, or end as retryable sheds when none is left (a one-replica
    router; a whole-pool drain, whose last replica also sheds what it was
    handed). Records each stream's states, tokens and moves."""
    n, target, rehomed = DRAINS[pool]
    cfg = s.cfg(prefill_chunk=32, default_max_new_tokens=4,
                migration={"enabled": True,
                           "shared_nvme_path": namespace(s, tmp_path)})
    reps = [s.Replica(f"r{i}", s.ContinuousBatcher(s.engine(k), cfg))
            for i, k in zip(range(n), "ab")]
    router = s.ReplicaRouter(reps, s.config.RouterConfig()).start()
    streams = {}
    try:
        for r in reps:
            r.paused = True
        for i, r in enumerate(reps):
            for j in range(2):
                q = _FreezeAtToken(r)
                r.submit(prompt(12, 60 + 4 * i + j), events=q)
                streams[f"{r.name}-inflight{j}"] = q
        for r in reps:
            r.paused = False
        _wait(lambda: all(r.paused for r in reps))
        for i, r in enumerate(reps):
            for j in range(2):
                q = queue.Queue()
                r.submit(prompt(12, 62 + 4 * i + j), events=q)
                streams[f"{r.name}-queued{j}"] = q
        router.install_signal_handlers(drain=target)
        try:
            os.kill(os.getpid(), signal.SIGTERM)
            _wait(lambda: router.counters["migrated"]
                  + router.counters["migration_failed"] >= rehomed)
        finally:
            router.restore_signal_handlers()
        for r in reps:
            r.paused = False
        events = {k: [] for k in streams}

        def ended():
            for k, q in streams.items():
                while not q.empty():
                    events[k].append(q.get_nowait())
            return all(ev and ev[-1]["event"] == "end"
                       for ev in events.values())
        _wait(ended)
        drained = [r.name for r in reps if r.batcher.health == s.DRAINING]
        _wait(lambda: all(r.stats["drained"] for r in reps
                          if r.name in drained))
    finally:
        router.close()
    out = {}
    for k, ev in events.items():
        end = ev[-1]
        err = end.get("error") or {}
        out[k] = (end["state"], end["finish_reason"], err.get("reason"),
                  err.get("retryable"), end["tokens"],
                  sorted({e["replica"] for e in ev if e["event"] == "token"}),
                  [(e["from"], e["to"]) for e in ev
                   if e["event"] == "migrated"])
        if "inflight" in k:
            assert end["state"] == "completed" and len(end["tokens"]) == 4
            assert out[k][5] == [k[:2]] and not out[k][6]
    close_all(*(r.batcher for r in reps))
    return (out, drained, {k: router.counters[k] for k in (
        "drains", "migrated", "migration_failed", "adopts")})


@pytest.mark.parametrize("pool", list(DRAINS))
def test_sigterm_drain_matches_reference(sides, tmp_path, pool):
    """In-flight requests finish where they run; queued ones are re-homed
    or shed, as the reference's drain does (no export at drain time)."""
    out, drained, counters = both(sides, _sigterm_drain, tmp_path, pool)
    n, target, rehomed = DRAINS[pool]
    queued = [v for k, v in out.items() if "queued" in k]
    if pool == "sibling":
        assert drained == ["r0"] and counters["migrated"] == 2
        assert all(v[0] == "completed" for v in queued)
    else:
        assert counters["migration_failed"] == (2 if n == 1 else 4)
        assert all(v[0] == "shed" and v[3] for v in queued)
    assert counters["adopts"] == 0
