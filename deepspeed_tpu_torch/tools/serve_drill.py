"""Serving chaos drills on the port: drive the request-lifecycle layer
(``deepspeed_tpu_torch/serving``) through a named overload or failure
scenario and exit nonzero if the serving invariants fail (counterpart of
the repo's ``tools/serve_drill.py``, which drives the JAX package).

    python -m deepspeed_tpu_torch.tools.serve_drill --list
    python -m deepspeed_tpu_torch.tools.serve_drill --scenario slo-storm
    python -m deepspeed_tpu_torch.tools.serve_drill --all --device cpu

Scenarios: ``deadline-storm``, ``shed-under-kv-pressure``,
``sigterm-drain``, ``frontend-storm``, ``prefix-storm``, ``kv-tier``,
``slo-storm``, ``crash-migrate``. ``moe-storm`` serves an MoE model
expert-parallel on an ``{"ep": 4, "dp": 2}`` mesh and rebalances its
experts, which needs a mesh (ROADMAP section 1, "Mesh, ZeRO and tensor
parallelism"); asking for it raises ``NotImplementedError``.

Invariants asserted after EVERY drill:

* **no KV-block leak** — the engine's block pool accounting returns to its
  initial state (every allocated block freed, no live sequences);
* **no request silently lost** — every admitted uid resolves to
  ``completed | shed | expired`` in the terminal ledger;
* scenario-specific checks (deadlines actually expired, sheds actually
  typed/retryable, drain actually closed admission and finished in-flight,
  greedy streams identical where a scenario says so).

The engines serve the ``tiny`` preset with its rotary table raised to
the engines' ``max_seq_len`` of 128. On the card (``--device cuda``, the
default) the model is 256 wide with 4 heads (head dim 64, which the
kernels take) in bf16, so the drills that ask for fp32 run bf16 there;
``--device cpu`` runs them as the reference does, in fp32 where asked.
Exit code 0 = invariants held; 1 = violated (details on stdout as JSON).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

from deepspeed_tpu_torch.utils import resolve_device

#: the tiny preset, its rotary table as long as the engines' max_seq_len
_PRESET = {"max_seq_len": 128}
#: on the card: a head dim the kernels take, in their dtype
_CARD_PRESET = {"hidden_size": 256, "num_heads": 4, "dtype": "bfloat16"}
#: in bf16 a served token may part from a run on other kernel paths at a
#: near-tie; it must then lie within this many standard deviations of the
#: logits below the teacher-forced argmax (chip_smoke's ``SPEC_GAP_SD``)
_GAP_SD = 0.25


def _make_batcher(device, num_blocks=None, monitor=None,
                  clock=time.monotonic, engine_kw=None, **serving):
    from deepspeed_tpu_torch.config import ServingConfig
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import TransformerLM, get_preset
    from deepspeed_tpu_torch.serving import ContinuousBatcher

    ekw = {"max_sequences": 8, "max_seq_len": 128, "block_size": 16,
           "num_blocks": num_blocks, **(engine_kw or {})}
    preset = {**_PRESET, **ekw.pop("preset_kw", {})}
    if resolve_device(device).type == "cuda":
        preset.update(_CARD_PRESET)
    eng = InferenceEngineV2(TransformerLM(get_preset("tiny", **preset)),
                            device=device, **ekw)
    cfg = ServingConfig(**{"prefill_chunk": 32, "default_max_new_tokens": 8,
                           **serving})
    return ContinuousBatcher(eng, cfg, monitor=monitor, clock=clock)


def _block_bytes(b, block_size):
    """Bytes of one KV block of ``b``'s engine (K and V, every layer)."""
    cfg = b.engine.cfg
    itemsize = 4 if cfg.dtype == "float32" else 2
    return (2 * cfg.num_layers * block_size * cfg.num_kv_heads
            * cfg.head_dim * itemsize)


def _teacher_forced_gap(eng, prompt, toks) -> float:
    """How far ``toks`` lie below the argmax of ``eng``'s logits under
    teacher forcing (a ``put`` of the prompt, then of each token in turn),
    at most, in standard deviations of the logits."""
    import numpy as np

    uid = 990
    lg = eng.put([uid], [np.asarray(prompt, np.int32)])[uid]
    worst = 0.0
    for i, tok in enumerate(toks):
        if i:
            lg = eng.put([uid], [np.asarray([toks[i - 1]], np.int32)])[uid]
        worst = max(worst, (float(lg.max()) - float(lg[tok]))
                    / float(lg.std()))
    eng.flush([uid])
    return worst


def _fresh_injector():
    from deepspeed_tpu_torch.resilience import set_injector

    set_injector(None)


def _invariants(b, uids) -> dict:
    """The cross-scenario serving invariants (see module doc)."""
    alloc = b.engine.state.allocator
    unresolved = {u: b.manager.resolve(u) for u in uids
                  if b.manager.resolve(u)
                  not in ("completed", "shed", "expired")}
    return {
        "kv_pool_restored": alloc.free_blocks == alloc.num_blocks,
        "free_blocks": alloc.free_blocks, "num_blocks": alloc.num_blocks,
        "live_sequences": len(b.engine.state.sequences),
        "unresolved_uids": unresolved,
        "ok": (alloc.free_blocks == alloc.num_blocks
               and not b.engine.state.sequences and not unresolved),
    }


# ---------------------------------------------------------------------------
# scenarios: each returns (ok: bool, details: dict)
# ---------------------------------------------------------------------------

def scenario_deadline_storm(workdir, device):
    """A burst of requests with deadlines too tight for the queue they join,
    plus one injected cache_io_error step. Invariant: every expired request
    — including ones caught mid-chunked-prefill — releases all KV blocks;
    the IO-failed step loses no request; survivors with generous deadlines
    still complete."""
    import numpy as np

    from deepspeed_tpu_torch.resilience import FaultInjector, set_injector

    now = [0.0]
    b = _make_batcher(device, clock=lambda: now[0], default_max_new_tokens=4,
                      max_queue_depth=32)
    # one engine step fails on KV-cache IO; the batcher must retry, not drop
    set_injector(FaultInjector([{"kind": "cache_io_error", "times": 1}]))
    real_step = b.step

    def step():
        ran = real_step()
        if ran:
            now[0] += 1.0
        return ran
    b.step = step
    rng = np.random.default_rng(0)
    tight = [b.submit(rng.integers(0, 250, 96), deadline_s=2.5)
             for _ in range(6)]            # 96-token prompts need 3 chunks
    loose = [b.submit(rng.integers(0, 250, 40), deadline_s=60.0)
             for _ in range(4)]
    b.pump(max_steps=200)
    rep = b.serving_report()
    inv = _invariants(b, tight + loose)
    details = {"report": rep, "invariants": inv,
               "tight": {u: b.manager.resolve(u) for u in tight},
               "loose": {u: b.manager.resolve(u) for u in loose}}
    ok = (inv["ok"] and rep["counters"]["expired"] >= 1
          and all(b.manager.resolve(u) == "completed" for u in loose)
          and rep["counters"]["completed"] >= len(loose)
          and rep["counters"]["step_failures"] == 1)
    return ok, details


def scenario_shed_under_kv_pressure(workdir, device):
    """More aggregate KV demand than the pool holds, then a shed_storm
    fault on top. Invariant: the batcher sheds lowest-priority/newest with
    typed retryable ShedErrors instead of CapacityError escaping put();
    the high-priority request completes; the pool drains back to empty."""
    import numpy as np

    from deepspeed_tpu_torch.resilience import FaultInjector, set_injector
    from deepspeed_tpu_torch.serving import ShedError

    b = _make_batcher(device, num_blocks=12, default_max_new_tokens=16,
                      kv_high_watermark=0.8, kv_low_watermark=0.5,
                      max_queue_depth=8)
    rng = np.random.default_rng(1)
    vip = b.submit(rng.integers(0, 250, 60), priority=10)
    crowd = [b.submit(rng.integers(0, 250, 60)) for _ in range(6)]
    rejected = 0
    try:
        for _ in range(4):           # overflow the bounded queue
            b.submit(rng.integers(0, 250, 60))
    except ShedError as e:
        rejected += 1
        retryable = e.retryable and e.reason == "queue_full"
    else:
        retryable = False
    b.pump(max_steps=30)
    set_injector(FaultInjector([{"kind": "shed_storm", "times": 2}]))
    b.pump(max_steps=300)
    _fresh_injector()
    b.pump(max_steps=300)
    rep = b.serving_report()
    inv = _invariants(b, [vip] + crowd)
    shed_reqs = [b.manager.done[u] for u in crowd
                 if b.manager.resolve(u) == "shed"]
    details = {"report": rep, "invariants": inv,
               "vip": b.manager.resolve(vip),
               "crowd": {u: b.manager.resolve(u) for u in crowd},
               "queue_full_rejected": rejected,
               "queue_full_retryable": retryable}
    ok = (inv["ok"] and b.manager.resolve(vip) == "completed"
          and rep["counters"]["shed"] >= 1 and rejected >= 1 and retryable
          and all(r.error is not None and r.error.retryable
                  for r in shed_reqs))
    return ok, details


def scenario_sigterm_drain(workdir, device):
    """SIGTERM mid-flight. Invariant: admission closes with a retryable
    'draining' ShedError, queued requests are shed, every in-flight
    sequence resolves (completed within the drain budget), and the batcher
    exits drained with the pool back to its initial state."""
    import numpy as np

    from deepspeed_tpu_torch.serving import ShedError

    b = _make_batcher(device, default_max_new_tokens=8, max_queue_depth=32,
                      max_active_requests=4)
    b.install_signal_handlers()
    try:
        rng = np.random.default_rng(2)
        uids = [b.submit(rng.integers(0, 250, 40)) for _ in range(6)]
        b.step()
        b.step()                       # some in flight, some still queued
        os.kill(os.getpid(), signal.SIGTERM)
        b.pump(max_steps=100)
        if not b.drained:
            b.drain(timeout_s=60.0)
        try:
            b.submit(rng.integers(0, 250, 8))
            admission_closed = False
        except ShedError as e:
            admission_closed = e.reason == "draining" and e.retryable
    finally:
        b.restore_signal_handlers()
    rep = b.serving_report()
    inv = _invariants(b, uids)
    details = {"report": rep, "invariants": inv,
               "states": {u: b.manager.resolve(u) for u in uids},
               "admission_closed": admission_closed}
    ok = (inv["ok"] and b.drained and admission_closed
          and rep["counters"]["completed"] >= 1
          and rep["health"] == "draining")
    return ok, details


class _PremiseFailed(Exception):
    """A drill's setup did not reach the state its gate assumes."""


def scenario_frontend_storm(workdir, device):
    """Real HTTP load (stdlib client, real sockets) against a 2-replica
    router behind the network front-end: a storm of concurrent
    mixed-priority requests with a shed_storm fault on top, then a SIGTERM
    drain of one replica mid-storm. Invariants: ≥1 429 with Retry-After;
    the drained replica's queued requests migrate to the sibling; every
    admitted router uid resolves terminal (none lost); both KV pools
    restored; front-end/router close idempotently."""
    import threading

    from deepspeed_tpu_torch.config.config import FrontendConfig, RouterConfig
    from deepspeed_tpu_torch.resilience import FaultInjector, set_injector
    from deepspeed_tpu_torch.serving import (FrontendError, GenerateClient,
                                             Replica, ReplicaRouter,
                                             ServingFrontend)

    depth = 8                          # each replica's max_queue_depth
    b0 = _make_batcher(device, max_queue_depth=depth,
                       default_max_new_tokens=3)
    b1 = _make_batcher(device, max_queue_depth=depth,
                       default_max_new_tokens=3)
    r0, r1 = Replica("r0", b0), Replica("r1", b1)
    router = ReplicaRouter([r0, r1], RouterConfig()).start()
    fe = ServingFrontend(router, FrontendConfig(
        api_keys={"gold": 5}, max_header_priority=4)).start()
    results, lock = [], threading.Lock()

    def wait_for(cond, timeout=120.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return True
            time.sleep(0.05)
        return False

    def queued():
        return (r0.stats["queue_depth"] + r1.stats["queue_depth"]
                + sum(1 for r in results if r[0] == "err"))

    def establish(ok, what):
        """Fail the drill with the reason when its premise does not
        hold, instead of running a phase whose gate then misreads."""
        if not ok:
            raise _PremiseFailed(
                f"{what} (r0 queue {r0.stats['queue_depth']}, r1 queue "
                f"{r1.stats['queue_depth']}, refused "
                f"{sum(1 for r in results if r[0] == 'err')})")

    def unary(i, key):
        cli = GenerateClient(fe.url, api_key=key, timeout_s=180)
        try:
            out = cli.generate(list(range(1, 10 + i % 4)),
                               max_new_tokens=3,
                               priority=None if key else (i % 3))
            with lock:
                results.append(("ok", out))
        except FrontendError as e:
            with lock:
                results.append(("err", e))

    def streamer(i):
        try:
            evs = list(GenerateClient(fe.url, timeout_s=180).stream(
                list(range(1, 12)), max_new_tokens=3))
            with lock:
                results.append(("stream", evs))
        except FrontendError as e:
            with lock:
                results.append(("err", e))

    timings, premise, threads = {}, None, []
    try:
        # phase 1 — storm: queues fill while the workers hold, the shed
        # storm lands on full queues, the overflow 429s at submit time
        r0.paused = r1.paused = True
        threads = [threading.Thread(
            target=unary, args=(i, "gold" if i % 5 == 0 else None))
            for i in range(20)]
        for t in threads:
            t.start()
        establish(wait_for(lambda: queued() >= 20),
                  "phase 1: 20 requests not all queued or refused in 120 s")
        set_injector(FaultInjector([{"kind": "shed_storm", "times": 2}]))
        r0.paused = r1.paused = False
        for t in threads:
            t.join(timeout=180)
        _fresh_injector()
        errs_p1 = [r[1] for r in results if r[0] == "err"]

        # phase 2 — SIGTERM drain of r0 mid-flight, queued work migrates.
        # Its premise: r0's queue holds requests and r1 has room for some
        # of them. The clients start one at a time, each once the one
        # before it is queued, so the router's least-loaded choice reads
        # fresh queue depths and splits them 6 / 6; started at once under
        # load, stale depths could send 8 to r1, leaving it no room.
        results.clear()
        r0.paused = r1.paused = True
        threads = ([threading.Thread(target=unary, args=(i, "gold"))
                    for i in range(6)]
                   + [threading.Thread(target=streamer, args=(i,))
                      for i in range(6)])
        for i, t in enumerate(threads):
            t.start()
            establish(wait_for(lambda: queued() >= i + 1, timeout=30.0),
                      f"phase 2: request {i + 1} of 12 not queued in 30 s")
        queued_r0 = r0.stats["queue_depth"]
        establish(queued_r0 >= 1 and r1.stats["queue_depth"] < depth,
                  "phase 2: the drain needs requests queued on r0 and room "
                  "on r1")
        router.install_signal_handlers(drain="r0")
        t_drain = time.monotonic()
        os.kill(os.getpid(), signal.SIGTERM)
        migrated_done = wait_for(
            lambda: router.counters["migrated"]
            + router.counters["migration_failed"] >= queued_r0)
        timings["drain_to_migrated_s"] = round(
            time.monotonic() - t_drain, 3)
        r0.paused = r1.paused = False
        for t in threads:
            t.join(timeout=180)
        quiesced = wait_for(
            lambda: all(r.stats["active"] == 0
                        and r.stats["queue_depth"] == 0
                        for r in (r0, r1)))
    except _PremiseFailed as e:
        premise = str(e)
        r0.paused = r1.paused = False
        for t in threads:
            t.join(timeout=180)
    finally:
        _fresh_injector()
        router.restore_signal_handlers()
        fe.close()
        fe.close()                    # idempotent-shutdown satellite
        router.close()
        router.close()

    if premise is not None:
        return False, {"premise_failed": premise}
    oks = [r[1] for r in results if r[0] == "ok"]
    streams = [r[1] for r in results if r[0] == "stream"]
    errs_p2 = [r[1] for r in results if r[0] == "err"]
    pool0 = _invariants(b0, [])
    pool1 = _invariants(b1, [])
    # no admitted uid lost: every router uid either terminal in a ledger
    # (ok/stream/end-record 429) — router.resolve follows migrations
    admitted_ids = ([o["id"] for o in oks]
                    + [evs[-1]["data"].get("id") for evs in streams
                       if evs and evs[-1]["event"] == "end"]
                    + [e.body["id"] for e in errs_p1 + errs_p2
                       if "id" in (e.body or {})])
    resolved = {i: router.resolve(i) for i in admitted_ids}
    unresolved = {i: st for i, st in resolved.items()
                  if st not in ("completed", "shed", "expired", "cancelled")}
    got_429 = [e for e in errs_p1 if e.status == 429
               and e.retry_after_s is not None]
    # a phase-2 request may legitimately end shed-retryable (the sibling's
    # queue can genuinely fill during migration — that's backpressure, not
    # loss); what may NOT happen is a stream without a terminal end record
    # or a uid that resolves to nothing
    done_streams = [evs for evs in streams
                    if evs and evs[-1]["event"] == "end"]
    completed_streams = [evs for evs in done_streams
                         if evs[-1]["data"]["state"] == "completed"]
    rep = router.report()
    details = {
        "phase1_429": len(got_429), "phase1_errs": len(errs_p1),
        "phase2_ok": len(oks), "phase2_streams": len(streams),
        "phase2_streams_completed": len(completed_streams),
        "phase2_errs": len(errs_p2),
        "queued_r0_at_drain": queued_r0,
        "migrated_done": migrated_done, "quiesced": quiesced,
        "router_counters": rep["counters"], "timings": timings,
        "unresolved_ids": unresolved,
        "pool_r0": pool0, "pool_r1": pool1,
    }
    ok = (len(got_429) >= 1
          and rep["counters"]["migrated"] >= 1
          and migrated_done and quiesced
          and not unresolved
          and all(o["state"] == "completed" and len(o["tokens"]) == 3
                  for o in oks)
          and len(done_streams) == len(streams)
          and all(evs[-1]["data"]["state"] in ("completed", "shed")
                  for evs in done_streams)
          and all(len(evs[-1]["data"]["tokens"]) == 3
                  for evs in completed_streams)
          and len(oks) + len(completed_streams) >= 1
          and pool0["kv_pool_restored"] and pool1["kv_pool_restored"])
    return ok, details


def scenario_prefix_storm(workdir, device):
    """N clients share one system prompt (prefix cache + n-gram speculation
    on, fp32 so exactness is argmax-stable). Invariants: cache hit-rate > 0
    with every warm request attaching the shared blocks; token streams
    IDENTICAL to a cache-less baseline (in bf16, on the card, a stream
    that parts from it lies within ``_GAP_SD`` of the baseline engine's
    teacher-forced argmax); distinct-prefix churn forces LRU
    eviction without evicting any block a live sequence shares; after
    flush + cache clear the pool is fully restored with zero refcounts
    leaked."""
    import numpy as np

    spec = {"enabled": True, "ngram": 2, "max_draft": 4, "fallback_steps": 4}
    pkw = {"preset_kw": {"dtype": "float32"}}
    rng = np.random.default_rng(0)
    system = rng.integers(0, 250, 48)          # 3 shared full blocks
    prompts = [np.concatenate([system, rng.integers(0, 250, 6)])
               for _ in range(8)]

    def serve(b):
        outs = []
        for p in prompts:      # sequential: request 1 publishes, 2..N hit
            uid = b.submit(p)
            b.pump(max_steps=200)
            outs.append([int(t) for t in b.manager.done[uid].generated])
        return outs

    cold = _make_batcher(device, engine_kw=pkw, default_max_new_tokens=10)
    base = serve(cold)
    # pool sized so the distinct-prefix churn below overflows it: eviction
    # must fire while the shared system blocks stay resident (hot LRU)
    b = _make_batcher(device, num_blocks=40,
                      engine_kw={**pkw, "prefix_cache": True,
                                 "speculative": spec},
                      default_max_new_tokens=10)
    got = serve(b)
    rep = b.serving_report()
    pc = b.engine.prefix_cache

    # churn distinct prefixes through the small pool to force LRU eviction
    for i in range(12):
        uid = b.submit(rng.integers(0, 250, 56))
        b.pump(max_steps=200)
    churn_rep = b.serving_report()

    alloc = b.engine.state.allocator
    live_after = len(b.engine.state.sequences)
    cleared = pc.clear()
    restored = alloc.free_blocks == alloc.num_blocks
    leaked = alloc.leaked_blocks()
    hit_rate = rep["counters"]["prefix_hit_requests"] / (len(prompts) - 1)
    exact = cold.engine.cfg.dtype == "float32"
    gap = (None if exact or got == base else
           max(_teacher_forced_gap(cold.engine, p, t)
               for p, t in zip(prompts, got)))
    details = {
        "tokens_identical": got == base,
        "teacher_forced_gap_sd": gap,
        "hit_requests": rep["counters"]["prefix_hit_requests"],
        "hit_tokens": rep["counters"]["prefix_hit_tokens"],
        "hit_rate": round(hit_rate, 3),
        "speculative": rep["speculative"],
        "evicted_blocks": churn_rep["prefix_cache"]["evicted_blocks"],
        "cleared_blocks": cleared, "live_sequences": live_after,
        "pool_restored": restored, "leaked_blocks": leaked,
        "kv": churn_rep["kv"],
    }
    ok = ((got == base or (not exact and gap <= _GAP_SD))
          and hit_rate > 0
          and rep["counters"]["prefix_hit_tokens"]
          >= 48 * (len(prompts) - 1)
          and rep["speculative"]["rounds"] > 0
          and churn_rep["prefix_cache"]["evicted_blocks"] > 0
          and live_after == 0 and restored and not leaked)
    return ok, details


def scenario_kv_tier(workdir, device):
    """Distinct-prefix churn through a small HBM block pool with the host +
    NVMe KV tiers on (fp32 so exactness is argmax-stable). Invariants:
    demote→promote cycles happen in BOTH tiers (host hits and NVMe hits,
    after demotions into each); every token stream is IDENTICAL to a
    cache-less baseline — including the second round, where prompts are
    served off promoted blocks; effective cache capacity (resident +
    demoted nodes) reaches ≥ 5× the HBM pool; after flush + clear the
    pool, the pinned-buffer pool, and the tier store are fully restored
    with zero loans or refcounts leaked."""
    import shutil
    import tempfile

    nvme_dir = tempfile.mkdtemp(dir=workdir) if workdir \
        else tempfile.mkdtemp()
    try:
        return _kv_tier_body(nvme_dir, device)
    finally:
        # the swapper only best-effort-removes files for discarded
        # entries; without this, every run leaks a /tmp dir of KV files
        shutil.rmtree(nvme_dir, ignore_errors=True)


def _kv_tier_body(nvme_dir, device):
    import numpy as np

    num_blocks, bs = 16, 16
    pkw = {"preset_kw": {"dtype": "float32"}}
    rng = np.random.default_rng(7)
    # 30 prompts x 3 full blocks each: far more cached state than 16 HBM
    # blocks can hold — round 1 churns the tree through demotion, round 2
    # serves the same prompts off promoted blocks
    prompts = [np.concatenate([rng.integers(0, 250, 48),
                               rng.integers(0, 250, 4)])
               for _ in range(30)]

    def serve(b, ps):
        outs = []
        for p in ps:
            uid = b.submit(p)
            b.pump(max_steps=200)
            outs.append([int(t) for t in b.manager.done[uid].generated])
        return outs

    cold = _make_batcher(device, num_blocks=num_blocks, engine_kw=pkw,
                         default_max_new_tokens=6)
    base = serve(cold, prompts)
    base_recent = serve(cold, prompts[-8:])
    # host budget ~10 blocks; the other ~70 demoted blocks must ride the
    # NVMe tier
    tiers = {"enabled": True, "host_mb": 10 * _block_bytes(cold, bs) / 2**20,
             "nvme_path": nvme_dir, "promote_depth": 4}
    b = _make_batcher(device, num_blocks=num_blocks,
                      engine_kw={**pkw,
                                 "prefix_cache": {"enabled": True,
                                                  "tiers": tiers}},
                      default_max_new_tokens=6)
    round1 = serve(b, prompts)
    pc = b.engine.prefix_cache
    capacity_r1 = pc.report()["blocks"] + pc.report()["demoted_nodes"]
    # the freshest demotions are still in the host tier: replaying the
    # most recent prompts exercises the host demote→promote cycle before
    # their blocks age out to NVMe
    round_recent = serve(b, prompts[-8:])
    round2 = serve(b, prompts)
    rep = b.serving_report()
    pcr = pc.report()
    tiers_rep = pcr["tiers"]
    capacity = max(capacity_r1, pcr["blocks"] + pcr["demoted_nodes"])

    alloc = b.engine.state.allocator
    live_after = len(b.engine.state.sequences)
    cleared = pc.clear()
    pool_restored = alloc.free_blocks == alloc.num_blocks
    leaked = alloc.leaked_blocks()
    store = b.engine._tier_store
    store_entries = store.entries()
    pinned = store.pool.report()
    swapper_rep = store.swapper.report() if store.swapper else {}
    b.engine.close()
    details = {
        "round1_identical": round1 == base,
        "recent_identical": round_recent == base_recent,
        "round2_identical": round2 == base,
        "effective_capacity_blocks": capacity,
        "hbm_pool_blocks": num_blocks,
        "capacity_ratio": round(capacity / num_blocks, 2),
        "prefix_cache": pcr,
        "tier_counters": {k: tiers_rep[k] for k in
                          ("host_demotions", "nvme_demotions", "host_hits",
                           "nvme_hits", "host_misses", "nvme_misses",
                           "dropped")},
        "batcher_tier_counters": {
            "tier_hit_requests": rep["counters"]["tier_hit_requests"],
            "tier_promoted_blocks":
                rep["counters"]["tier_promoted_blocks"]},
        "cleared_nodes": cleared, "live_sequences": live_after,
        "pool_restored": pool_restored, "leaked_blocks": leaked,
        "store_entries_after_clear": store_entries,
        "pinned_pool_after_clear": pinned,
        "swapper_after_clear": {k: swapper_rep.get(k) for k in
                                ("inflight_tickets",
                                 "loaned_read_buffers")},
    }
    ok = (round1 == base and round2 == base
          and round_recent == base_recent
          and tiers_rep["host_demotions"] >= 1
          and tiers_rep["nvme_demotions"] >= 1
          and tiers_rep["host_hits"] >= 1
          and tiers_rep["nvme_hits"] >= 1
          and pcr["promoted_blocks"] >= 1
          and rep["counters"]["tier_promoted_blocks"] >= 1
          and capacity >= 5 * num_blocks
          and live_after == 0 and pool_restored and not leaked
          and store_entries == 0
          and pinned["outstanding"] == 0
          and swapper_rep.get("inflight_tickets", 0) == 0
          and swapper_rep.get("loaned_read_buffers", 0) == 0)
    return ok, details


def scenario_slo_storm(workdir, device):
    """A latency-tier burst lands on a pool already decoding batch-tier
    work while a preempt_storm fault forces the preemption path (fp32 so
    exactness is argmax-stable). Invariants: ZERO latency-tier sheds —
    the storm pauses batch victims through the KV tier store instead of
    dropping anyone; >= 1 pause→resume round-trip actually happens (by
    counters); every request of every tier still completes and the
    preempted streams are BIT-IDENTICAL to an injection-free replay of
    the same workload; pool, pause store and loans fully restored."""
    import numpy as np

    from deepspeed_tpu_torch.resilience import FaultInjector, set_injector

    pkw = {"preset_kw": {"dtype": "float32"}}
    rng = np.random.default_rng(11)
    batch_prompts = [rng.integers(0, 250, 48) for _ in range(4)]
    lat_prompts = [rng.integers(0, 250, 24) for _ in range(3)]

    def run(inject):
        b = _make_batcher(device, engine_kw=pkw, default_max_new_tokens=8,
                          max_queue_depth=32,
                          slo={"enabled": True, "preempt": True})
        uids_b = [b.submit(p, tier="batch") for p in batch_prompts]
        b.pump(max_steps=4)            # batch work prefills / starts decode
        if inject:
            set_injector(FaultInjector(
                [{"kind": "preempt_storm", "times": 2}]))
        uids_l = [b.submit(p, tier="latency", deadline_s=120.0)
                  for p in lat_prompts]
        b.pump(max_steps=400)
        _fresh_injector()
        b.pump(max_steps=400)
        toks = {u: [int(t) for t in b.manager.done[u].generated]
                for u in uids_b + uids_l if u in b.manager.done}
        return b, uids_b, uids_l, toks

    t0 = time.time()
    b, uids_b, uids_l, toks = run(inject=True)
    storm_s = time.time() - t0
    _, base_b, base_l, base_toks = run(inject=False)

    rep = b.serving_report()
    inv = _invariants(b, uids_b + uids_l)
    mc = b.manager.counters
    shed_tiers = [r.tier for r in b.manager.done.values()
                  if r.finish_reason == "shed"]
    store = b.engine._tier_store
    tier_rep = b.engine.tier_report() or {}
    gen_tokens = sum(len(v) for v in toks.values())
    bench = {
        "metric": "resume_success_rate", "unit": "ratio",
        "value": (mc["resumed"] / mc["paused"] if mc["paused"] else 0.0),
        "paused": mc["paused"], "resumed": mc["resumed"],
        "resume_success_rate": (mc["resumed"] / mc["paused"]
                                if mc["paused"] else 0.0),
        "storm_tokens_per_sec": round(gen_tokens / max(storm_s, 1e-9), 2),
        "latency_sheds": sum(1 for t in shed_tiers if t == "latency"),
    }
    # identical uid sequence across the two runs → positional comparison
    identical = (len(uids_b + uids_l) == len(base_b + base_l)
                 and all(toks.get(u) == base_toks.get(v)
                         for u, v in zip(uids_b + uids_l, base_b + base_l)))
    details = {"report": rep, "invariants": inv, "bench": bench,
               "states": {u: b.manager.resolve(u) for u in uids_b + uids_l},
               "shed_tiers": shed_tiers,
               "bit_identical_vs_unpreempted": identical,
               "paused_requests_after": tier_rep.get("paused_requests"),
               "store_entries_after": store.entries() if store else 0}
    ok = (inv["ok"]
          and mc["paused"] >= 1 and mc["resumed"] >= 1
          and mc["resumed"] == mc["paused"]
          and rep["counters"]["resume_failures"] == 0
          and not any(t == "latency" for t in shed_tiers)
          and all(b.manager.resolve(u) == "completed"
                  for u in uids_b + uids_l)
          and identical
          and tier_rep.get("paused_requests", 0) == 0
          and (store.entries() if store else 0) == 0)
    return ok, details


def scenario_crash_migrate(workdir, device):
    """Two replicas share a durable NVMe namespace; one is killed
    mid-decode with batch-tier victims paused (durable manifests on the
    shared tier) and latency-tier work still decoding. Invariants: the
    sibling ADOPTS >= 1 paused request through its manifest and resumes
    it fp32-BIT-IDENTICAL to an uncrashed replay; >= 1 manifest-less
    in-flight request recovers by re-prefill from token history
    (recompute, never zero-fill); zero admitted uids unresolved — every
    stream carries a ``migrated`` event and exactly one terminal record;
    the surviving pool, its tier store, and the shared namespace
    (manifests + KV files) are fully reclaimed."""
    import shutil
    import tempfile

    shared = tempfile.mkdtemp(dir=workdir) if workdir \
        else tempfile.mkdtemp()
    try:
        return _crash_migrate_body(shared, device)
    finally:
        # exception-safe: a failed assertion must not leak the shared
        # namespace (same fix as the kv-tier drill's rmtree)
        shutil.rmtree(shared, ignore_errors=True)


def _crash_migrate_body(shared, device):
    import queue as queue_mod

    import numpy as np

    from deepspeed_tpu_torch.resilience.faults import (FaultInjector,
                                                       FaultSpec, set_injector)
    from deepspeed_tpu_torch.serving import Replica, ReplicaRouter

    pkw = {"preset_kw": {"dtype": "float32"}}
    mig = {"enabled": True, "shared_nvme_path": shared,
           "manifest_ttl_s": 300.0}
    rng = np.random.default_rng(23)
    batch_prompts = [rng.integers(0, 250, 48) for _ in range(4)]
    lat_prompts = [rng.integers(0, 250, 24) for _ in range(3)]
    plan = ([(p, "batch", 12) for p in batch_prompts]
            + [(p, "latency", 8) for p in lat_prompts])

    # uncrashed replay: greedy fp32 per-prompt baselines
    solo = _make_batcher(device, engine_kw=pkw, default_max_new_tokens=8)
    base = []
    for p, _tier, n in plan:
        uid = solo.submit(p, max_new_tokens=n)
        solo.pump(max_steps=400)
        base.append([int(t) for t in solo.manager.done[uid].generated])

    # 17 HBM blocks is the deterministic sweet spot: four decoding batch
    # requests hold 4 blocks each (16/17 stays under the raised
    # watermark), and once the storm pauses two of them the three live
    # latency requests (2 blocks each) leave only 3 free — a paused
    # victim needs 4 to resume, so the pauses STAY paused until the
    # crash lands
    def mk():
        return _make_batcher(device, num_blocks=17, engine_kw=pkw,
                             default_max_new_tokens=8, max_queue_depth=32,
                             kv_high_watermark=0.95, kv_low_watermark=0.5,
                             slo={"enabled": True, "preempt": True},
                             migration=mig)

    r0, r1 = Replica("r0", mk()), Replica("r1", mk())
    router = ReplicaRouter([r0, r1]).start()
    streams, collected = [], {}

    def drain_events():
        for uid, q in streams:
            buf = collected.setdefault(uid, [])
            while True:
                try:
                    buf.append(q.get_nowait())
                except queue_mod.Empty:
                    break

    def evs(uid, kind):
        return [e for e in collected.get(uid, ())
                if e.get("event") == kind]

    def wait_for(cond, timeout=120.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            drain_events()
            if cond():
                return True
            time.sleep(0.005)
        return False

    timings = {}
    try:
        # phase 1 — batch-tier work lands on r0 and reaches mid-decode
        uids = []
        for p, tier, n in plan[:len(batch_prompts)]:
            q = queue_mod.Queue()
            uids.append(r0.submit(p, max_new_tokens=n, tier=tier,
                                  events=q))
            streams.append((uids[-1], q))
        mid_decode = wait_for(
            lambda: all(evs(u, "token") and not evs(u, "end")
                        for u in uids))

        # phase 2 — latency storm + forced preemption: two batch victims
        # pause, auto-exporting durable manifests onto the shared tier.
        # The worker is FROZEN while the storm is armed — a free-running
        # replica would burn the preempt fault on steps where the latency
        # work is not yet admitted, pausing nobody
        r0.paused = True
        for p, tier, n in plan[len(batch_prompts):]:
            q = queue_mod.Queue()
            uids.append(r0.submit(p, max_new_tokens=n, tier=tier,
                                  events=q))
            streams.append((uids[-1], q))
        set_injector(FaultInjector([{"kind": "preempt_storm", "times": 2}]))
        r0.paused = False
        got_paused = wait_for(lambda: r0.stats["paused_batch"] >= 1,
                              timeout=60.0)
        paused_at_crash = r0.stats["paused_batch"]

        # phase 3 — kill r0's worker mid-decode, then fail over: PAUSED
        # requests adopt through their manifests, severed DECODING ones
        # re-prefill from token history on the sibling
        set_injector(FaultInjector(
            [FaultSpec(kind="replica_crash", site="r0")]))
        crashed = wait_for(lambda: not r0.alive, timeout=30.0)
        set_injector(None)
        drain_events()
        sent_before_crash = {u: len(evs(u, "token")) for u in uids}
        t_crash = time.monotonic()
        fo = router.fail_over("r0")
        done = wait_for(lambda: all(evs(u, "end") for u in uids))
        t_done = time.monotonic()
        timings["crash_to_all_terminal_s"] = round(t_done - t_crash, 3)
        quiesced = wait_for(
            lambda: (r1.stats["active"] == 0
                     and r1.stats["queue_depth"] == 0), timeout=30.0)
        # shared namespace reclaimed: every manifest and durable KV file
        # dies with its request (sibling-side discard removes files the
        # donor produced)
        reclaimed = wait_for(lambda: not _shared_tier_files(shared),
                             timeout=30.0)
        leftovers = [] if reclaimed else _shared_tier_files(shared)
    finally:
        _fresh_injector()
        router.close()

    drain_events()
    ends = {u: evs(u, "end") for u in uids}
    tokens = {u: (ends[u][0]["tokens"] if ends[u] else None)
              for u in uids}
    migrated_uids = [u for u in uids if evs(u, "migrated")]
    resumed_from = {u: ends[u][0].get("migrated_from")
                    for u in uids if ends[u]}
    identical = all(tokens[u] == base[i] for i, u in enumerate(uids))
    resumed_tokens = sum(len(evs(u, "token")) - sent_before_crash[u]
                         for u in uids)
    rc = router.counters
    inv1 = _invariants(r1.batcher, [])
    store = r1.batcher.engine._tier_store
    mig_total = rc["adopts"] + rc["reprefill_failovers"]
    rate = (mig_total / (mig_total + rc["migration_failed"])
            if mig_total + rc["migration_failed"] else 0.0)
    bench = {
        "metric": "migration_success_rate", "unit": "ratio",
        "value": rate, "migration_success_rate": rate,
        "resumed_tokens_per_sec": round(
            resumed_tokens / max(t_done - t_crash, 1e-9), 2),
        "durable_adopts": rc["adopts"],
        "reprefill_failovers": rc["reprefill_failovers"],
    }
    details = {
        "mid_decode": mid_decode, "got_paused": got_paused,
        "paused_at_crash": paused_at_crash, "crashed": crashed,
        "failover": fo, "all_terminal": done, "quiesced": quiesced,
        "router_counters": rc, "bench": bench, "timings": timings,
        "migrated_uids": migrated_uids, "resumed_from": resumed_from,
        "bit_identical_vs_uncrashed": identical,
        "states": {u: (ends[u][0]["state"] if ends[u] else None)
                   for u in uids},
        "shared_tier_leftovers": leftovers,
        "pool_r1": inv1,
        "store_entries_r1": store.entries() if store else 0,
    }
    ok = (mid_decode and got_paused and paused_at_crash >= 1 and crashed
          and done and quiesced and identical
          and fo["failed"] == 0
          and rc["adopts"] >= 1                 # >= 1 durable resume
          and rc["reprefill_failovers"] >= 1    # >= 1 manifest-less
          and all(len(ends[u]) == 1 for u in uids)
          and all(ends[u][0]["state"] == "completed" for u in uids)
          # every IN-FLIGHT capture resumed as an adoption from r0; a
          # queued-at-crash capture is re-submitted fresh (no donor tag)
          and all(f in (None, "r0") for f in resumed_from.values())
          and sum(1 for f in resumed_from.values() if f == "r0")
          == mig_total
          and len(migrated_uids) == fo["migrated"]
          and not leftovers
          and inv1["kv_pool_restored"]
          and (store.entries() if store else 0) == 0)
    return ok, details


def _shared_tier_files(shared):
    """Every regular file still alive under the shared namespace."""
    out = []
    for root, _dirs, files in os.walk(shared):
        out.extend(os.path.join(os.path.relpath(root, shared), f)
                   for f in files)
    return sorted(out)


def scenario_moe_storm(workdir, device):
    """Expert-parallel MoE serving under a skewed router with faults
    injected mid-dispatch: needs an "ep" mesh, not ported yet (MoE itself
    serves on one device)."""
    raise NotImplementedError(
        "serve_drill moe-storm serves MoE expert-parallel on an ep mesh, "
        'which is not ported yet (ROADMAP section 1, "Mesh, ZeRO and '
        'tensor parallelism")')


SCENARIOS = {
    "deadline-storm": scenario_deadline_storm,
    "shed-under-kv-pressure": scenario_shed_under_kv_pressure,
    "sigterm-drain": scenario_sigterm_drain,
    "frontend-storm": scenario_frontend_storm,
    "prefix-storm": scenario_prefix_storm,
    "kv-tier": scenario_kv_tier,
    "slo-storm": scenario_slo_storm,
    "crash-migrate": scenario_crash_migrate,
    "moe-storm": scenario_moe_storm,
}
#: every scenario but moe-storm (what ``--all`` runs)
PORTED = tuple(n for n in SCENARIOS if n != "moe-storm")


def run_scenario(name: str, workdir=None, device="cuda") -> dict:
    """Run one drill on ``device``; returns the verdict record (also usable
    from tests)."""
    if name not in SCENARIOS:
        raise SystemExit(f"unknown scenario {name!r} "
                         f"(have: {sorted(SCENARIOS)})")
    _fresh_injector()
    t0 = time.time()
    try:
        ok, details = SCENARIOS[name](workdir, device)
    finally:
        _fresh_injector()
    return {"scenario": name, "device": str(device), "ok": ok,
            "seconds": round(time.time() - t0, 2), "details": details}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", help="which drill to run")
    ap.add_argument("--all", action="store_true",
                    help="run every ported scenario")
    ap.add_argument("--list", action="store_true", help="list scenarios")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.list:
        for name, fn in SCENARIOS.items():
            print(f"{name}: {fn.__doc__.splitlines()[0]}"
                  + ("" if name in PORTED else " [not ported]"))
        return 0
    names = list(PORTED) if args.all else (
        [args.scenario] if args.scenario else None)
    if not names:
        ap.error("pass --scenario NAME, --all, or --list")
    rc = 0
    for name in names:
        verdict = run_scenario(name, device=args.device)
        print(json.dumps(verdict, indent=2, default=str))
        if not verdict["ok"]:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
