"""Elastic-fleet chaos drills on the port: drive the replica-lifecycle
layer (``deepspeed_tpu_torch/serving/fleet.py`` and ``coldstart.py``)
through crash, burst and weight-swap scenarios and exit nonzero if the
elasticity invariants fail (counterpart of the repo's
``tools/elastic_drill.py``, which drives the JAX package).

    python -m deepspeed_tpu_torch.tools.elastic_drill --list
    python -m deepspeed_tpu_torch.tools.elastic_drill --scenario rolling-swap
    python -m deepspeed_tpu_torch.tools.elastic_drill --all --device cpu
    python -m deepspeed_tpu_torch.tools.elastic_drill --all \\
        --weight-dtype int4 --kv-dtype int8

Invariants asserted after EVERY drill:

* **no request silently lost** -- every uid the ROUTER admitted resolves
  terminal (``completed | shed | expired``) at the pool level, across
  replica crashes, scale-downs and rolling swaps (crash-severed in-flight
  requests resolve as loud ``replica_crash`` sheds, never vanish);
* **no KV-block leak** -- every replica left in the pool returns its block
  pool to the fully free state once the storm quiesces;
* **no shared-tier leak** -- the fleet's replicas share one durable NVMe
  namespace (cross-replica migration on); at drill exit it must be EMPTY,
  and it is removed exception-safely even when a check fails mid-drill;
* scenario-specific checks (the crash produced a flight-recorder dump, the
  autoscaler grew and shrank the pool, the rolling swap bumped every
  incarnation while honouring the READY floor, the warm start served and
  its tree equals the published cold tree bit for bit).

``cold-start-bench`` reports the cold and warm build times and their ratio
with no threshold: the reference's ``>= 3x`` measures the XLA compile a
warm build skips, and the port compiles nothing per engine. The tool
prints its JSON verdicts and writes no ledger.

The engines serve the ``tiny`` preset (``--preset``) on engines of
``max_seq_len`` 128, 8 slots, block 16, prompts chunked at 32. On the card
(``--device cuda``, the default) the tiny model is 256 wide with 4 heads
(head dim 64, which the kernels take) in bf16. Exit code 0 = invariants
held; 1 = violated (details on stdout as JSON).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, Optional

from deepspeed_tpu_torch.utils import resolve_device

TERMINAL = ("completed", "shed", "expired")

#: on the card: a head dim the kernels take, in their dtype (the tiny
#: preset; ``tools/serve_drill.py``'s card model)
_CARD_TINY = {"hidden_size": 256, "num_heads": 4, "dtype": "bfloat16"}


@dataclasses.dataclass
class Setup:
    """What every replica of a drill serves: the model preset (and its
    overrides), the engine's sizes and dtypes, the batchers' chunk."""

    device: str = "cuda"
    preset: str = "tiny"
    preset_kw: Dict = dataclasses.field(default_factory=dict)
    weight_dtype: str = "bf16"
    kv_dtype: str = "bf16"
    max_sequences: int = 8
    max_seq_len: int = 128
    block_size: int = 16
    prefill_chunk: int = 32

    def model_config(self):
        from deepspeed_tpu_torch.models import get_preset

        kw = dict(self.preset_kw)
        if self.preset == "tiny" and resolve_device(self.device).type \
                == "cuda":
            kw = {**_CARD_TINY, **kw}
        return get_preset(self.preset, **kw)

    def engine_kw(self) -> Dict:
        return dict(max_sequences=self.max_sequences,
                    max_seq_len=self.max_seq_len,
                    block_size=self.block_size, device=self.device,
                    weight_dtype=self.weight_dtype, kv_dtype=self.kv_dtype)


def _fresh_injector():
    from deepspeed_tpu_torch.resilience import set_injector

    set_injector(None)


def _reset_tracing():
    from deepspeed_tpu_torch.observability import configure_tracing, get_bus

    configure_tracing(enabled=False)
    get_bus().clear()


def replica_factory(workdir, setup: Setup, cache, serving_kw=None):
    """``(factory, key)``: ``factory(name)`` builds an UNSTARTED replica
    through ``cache`` (``start_info`` attached), every replica with the
    same serving config and ONE durable NVMe namespace under ``workdir``
    (crash-severed in-flight requests re-home onto siblings through it,
    and the drills check it is empty at exit)."""
    from deepspeed_tpu_torch.config import ServingConfig
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.serving import (ContinuousBatcher, Replica,
                                             warm_key)

    mcfg = setup.model_config()
    key = warm_key(TransformerLM(mcfg))
    engine_kw = setup.engine_kw()
    shared = os.path.join(workdir, "shared-nvme")
    os.makedirs(shared, exist_ok=True)
    scfg = ServingConfig(**{"prefill_chunk": setup.prefill_chunk,
                            "default_max_new_tokens": 8,
                            "migration": {"enabled": True,
                                          "shared_nvme_path": shared,
                                          "manifest_ttl_s": 300.0},
                            **(serving_kw or {})})

    def make_replica(name):
        eng, info = cache.build_engine(key, lambda: TransformerLM(mcfg),
                                       engine_kw=engine_kw)
        rep = Replica(name, ContinuousBatcher(eng, scfg))
        rep.start_info = info
        return rep

    return make_replica, key


def make_fleet(n, workdir, setup: Setup, fleet_kw=None, serving_kw=None,
               cache=None):
    """A WarmStartCache-backed pool of ``n`` replicas and its controller.

    Every replica (initial, respawn, scale-up, swap) is built through the
    SAME cache and factory the controller uses, so the first build is the
    only cold one and the drill exercises the real respawn path end to end.
    Returns ``(router, controller, cache, factory, key)``."""
    from deepspeed_tpu_torch.config import FleetConfig
    from deepspeed_tpu_torch.serving import (FleetController, ReplicaRouter,
                                             WarmStartCache)

    cache = cache or WarmStartCache(os.path.join(workdir, "warm"))
    make_replica, key = replica_factory(workdir, setup, cache, serving_kw)
    router = ReplicaRouter([make_replica(f"r{i}") for i in range(n)]).start()
    fc = FleetController(router, make_replica,
                         FleetConfig(**{"respawn_backoff_s": 0.0,
                                        **(fleet_kw or {})}))
    return router, fc, cache, make_replica, key


def await_terminal(router, uids, timeout_s=90.0):
    """Pool-level 'no request silently lost': wait for every admitted uid
    to reach a terminal state; returns {uid: state} for stragglers."""
    deadline = time.monotonic() + timeout_s
    states = {}
    while time.monotonic() < deadline:
        states = {u: router.resolve(u) for u in uids}
        if all(s in TERMINAL for s in states.values()):
            return {}
        time.sleep(0.05)
    return {u: s for u, s in states.items() if s not in TERMINAL}


def pool_invariants(router, uids, timeout_s=90.0) -> dict:
    """The cross-scenario elasticity invariants (see module doc)."""
    unresolved = await_terminal(router, uids, timeout_s)
    # quiesce, then every live replica's KV pool must be fully free
    pools = {}
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        pools = {}
        for rep in router._snapshot():
            alloc = rep.batcher.engine.state.allocator
            pools[rep.name] = {"free": alloc.free_blocks,
                               "total": alloc.num_blocks,
                               "restored": (alloc.free_blocks
                                            == alloc.num_blocks)}
        if all(p["restored"] for p in pools.values()):
            break
        time.sleep(0.05)
    counts = {}
    for u in uids:
        s = router.resolve(u)
        counts[s] = counts.get(s, 0) + 1
    return {
        "admitted": len(uids), "terminal_counts": counts,
        "unresolved_uids": unresolved, "kv_pools": pools,
        "ok": (not unresolved
               and all(p["restored"] for p in pools.values())),
    }


def storm(router, count, max_new_tokens=8, deadline_s=None, prompts=None):
    """Submit ``count`` requests (``prompts`` cycled, else 3-token ones);
    ShedError rejections are LOUD backpressure, not lost requests --
    returned separately."""
    from deepspeed_tpu_torch.serving import ShedError

    uids, rejected = [], 0
    for i in range(count):
        prompt = ([int(t) for t in prompts[i % len(prompts)]] if prompts
                  else [1 + i % 7, 2, 3])
        try:
            uids.append(router.submit(prompt, max_new_tokens=max_new_tokens,
                                      deadline_s=deadline_s))
        except ShedError:
            rejected += 1
    return uids, rejected


def trees_equal(a, b) -> bool:
    """Every leaf of two served trees equal bit for bit (same paths)."""
    import torch

    from deepspeed_tpu_torch.serving.coldstart import _flatten

    fa, fb = _flatten(a), _flatten(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    for (_, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor)
                    and isinstance(y, torch.Tensor)
                    and x.dtype == y.dtype and torch.equal(x, y.to(x.device))):
                return False
        elif x != y:
            return False
    return True


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------
def scenario_replica_crash_mid_storm(workdir, setup):
    """Kill one replica's worker mid-storm: queued requests fail over to
    the sibling, in-flight ones shed LOUDLY, the flight recorder dumps,
    the controller respawns under the same name (warm start) and the
    respawned replica serves again -- zero admitted uids lost."""
    from deepspeed_tpu_torch.observability import configure_tracing
    from deepspeed_tpu_torch.resilience.faults import (FaultInjector,
                                                       FaultSpec,
                                                       set_injector)

    dump_dir = os.path.join(workdir, "flight")
    configure_tracing(enabled=True, ring_size=4096, sample=1,
                      dump_dir=dump_dir)
    router, fc, cache, _, _ = make_fleet(
        2, workdir, setup, fleet_kw={"heartbeat_timeout_s": 30.0})
    try:
        uids, rejected = storm(router, 32)
        set_injector(FaultInjector(
            [FaultSpec(kind="replica_crash", site="r0")]))
        t0 = time.monotonic()
        while router.replicas["r0"].alive and time.monotonic() - t0 < 15:
            time.sleep(0.01)
        crashed = not router.replicas["r0"].alive
        set_injector(None)
        actions = fc.poll()
        respawned = bool(actions["recovered"]
                         and actions["recovered"][0]["respawned"])
        inv = pool_invariants(router, uids)
        # the respawned incarnation must take NEW traffic
        post_uid = router.submit([9, 8, 7], max_new_tokens=4)
        post_state = await_terminal(router, [post_uid], 30.0)
        dumps = glob.glob(os.path.join(dump_dir, "flight_replica_crash_*"))
        details = {
            "crashed": crashed, "respawned": respawned,
            "recovered": actions["recovered"], "rejected": rejected,
            "incarnation": router.replicas["r0"].incarnation,
            "respawn_source": getattr(router.replicas["r0"], "start_info",
                                      None),
            "crash_failovers": router.counters["crash_failovers"],
            "readmits": router.counters["readmits"],
            "flight_dumps": [os.path.basename(p) for p in dumps],
            "post_respawn_completed": not post_state,
            "invariants": inv,
        }
        ok = (crashed and respawned and inv["ok"] and len(dumps) == 1
              and router.counters["crash_failovers"] == 1
              and router.counters["readmits"] == 1
              and not post_state)
        return ok, details
    finally:
        router.close()
        fc.close()
        cache.close()
        _reset_tracing()


def scenario_burst_autoscale(workdir, setup):
    """A queue burst grows the pool (hysteresis: two pressured polls),
    the post-burst idle shrinks it back to ``min_replicas`` -- every
    admitted uid terminal through both transitions."""
    router, fc, cache, _, _ = make_fleet(
        1, workdir, setup,
        fleet_kw={"min_replicas": 1, "max_replicas": 3,
                  "scale_up_queue_per_replica": 2.0, "scale_up_polls": 2,
                  "scale_down_idle_polls": 3},
        serving_kw={"max_queue_depth": 128, "default_max_new_tokens": 16})
    try:
        uids, rejected = storm(router, 48, max_new_tokens=16)
        polls = 0
        while fc.counters["scale_ups"] == 0 and polls < 20:
            fc.poll()
            polls += 1
            time.sleep(0.02)
        grew_to = len(router.replicas)
        inv = pool_invariants(router, uids)
        # pool idle now: keep polling until the autoscaler shrinks back
        polls = 0
        while len(router.replicas) > 1 and polls < 30:
            fc.poll()
            polls += 1
            time.sleep(0.02)
        details = {
            "rejected": rejected, "grew_to": grew_to,
            "shrunk_to": len(router.replicas),
            "scale_ups": fc.counters["scale_ups"],
            "scale_downs": fc.counters["scale_downs"],
            "invariants": inv,
        }
        ok = (grew_to >= 2 and len(router.replicas) == 1
              and fc.counters["scale_ups"] >= 1
              and fc.counters["scale_downs"] >= 1 and inv["ok"])
        return ok, details
    finally:
        router.close()
        fc.close()
        cache.close()


def scenario_rolling_swap(workdir, setup):
    """Rolling weight swap under live traffic: every replica drained,
    rebuilt, READY-probed and readmitted one at a time -- incarnations all
    bump, the pool never drops below the READY floor, and no admitted uid
    (including ones submitted DURING the swap) is lost."""
    from deepspeed_tpu_torch.serving import ShedError

    router, fc, cache, _, _ = make_fleet(
        2, workdir, setup, fleet_kw={"min_ready_floor": 1})
    try:
        before = {r.name: r.incarnation for r in router._snapshot()}
        uids, rejected = storm(router, 16)
        live_uids, stop = [], threading.Event()

        def trickle():
            while not stop.is_set():
                try:
                    live_uids.append(router.submit([4, 5, 6],
                                                   max_new_tokens=4))
                except ShedError:
                    pass
                time.sleep(0.02)

        t = threading.Thread(target=trickle, daemon=True)
        t.start()
        try:
            res = fc.rolling_swap()
        finally:
            stop.set()
            t.join(timeout=5)
        after = {r.name: r.incarnation for r in router._snapshot()}
        inv = pool_invariants(router, uids + live_uids)
        rejoin_ms = [r["drain_rejoin_ms"] for r in res["replicas"]
                     if r.get("swapped")]
        details = {
            "swap": res, "incarnations_before": before,
            "incarnations_after": after, "rejected": rejected,
            "during_swap_submitted": len(live_uids),
            "readmits": router.counters["readmits"],
            "invariants": inv,
            "bench": {"drain_rejoin_ms": (max(rejoin_ms)
                                          if rejoin_ms else None)},
        }
        ok = (res["ok"] and inv["ok"]
              and all(after[n] > before[n] for n in before)
              and router.counters["readmits"] == len(before)
              and len(live_uids) > 0)
        return ok, details
    finally:
        router.close()
        fc.close()
        cache.close()


def scenario_cold_start_bench(workdir, setup):
    """Cold vs warm start measured: the first engine build is cold; a
    respawn through the WarmStartCache (AIO-streamed weights, reused
    module) serves, and its tree equals the published cold tree bit for
    bit. An injected ``weight_load_io_error`` falls back to a cold build
    instead of failing the respawn. The cold / warm ratio is reported with
    no threshold."""
    from deepspeed_tpu_torch.resilience.faults import (FaultInjector,
                                                       FaultSpec,
                                                       set_injector)
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.serving import warm_key
    from deepspeed_tpu_torch.serving.coldstart import evict_module

    # a GENUINE cold build even when an earlier scenario of this process
    # built the model (the module table is process-global by design)
    evict_module(warm_key(TransformerLM(setup.model_config())))
    router, fc, cache, _, _ = make_fleet(1, workdir, setup)
    try:
        r0 = router.replicas["r0"]
        cold_ms = r0.start_info["ms"]
        cold_src = r0.start_info["source"]
        # warm respawn through the full controller path
        rep = fc._spawn("warm0")
        warm_ms = rep.start_info["ms"]
        warm_src = rep.start_info["source"]
        equal = trees_equal(rep.batcher.engine.params,
                            r0.batcher.engine.params)
        uid = rep.submit([1, 2, 3], max_new_tokens=4)
        t0 = time.monotonic()
        while (rep.resolve(uid) not in TERMINAL
               and time.monotonic() - t0 < 30):
            time.sleep(0.02)
        warm_served = rep.resolve(uid) == "completed"
        rep.close()
        # injected IO failure in the warm weight path -> cold fallback
        set_injector(FaultInjector(
            [FaultSpec(kind="weight_load_io_error", site="warm")]))
        try:
            rep2 = fc._spawn("fb0")
        finally:
            set_injector(None)
        fb_src = rep2.start_info["source"]
        rep2.close()
        ratio = cold_ms / max(warm_ms, 1e-6)
        details = {
            "cold_start_ms": cold_ms, "cold_source": cold_src,
            "warm_start_ms": warm_ms, "warm_source": warm_src,
            "cold_over_warm": round(ratio, 2),
            "warm_tree_equals_published": equal,
            "warm_served": warm_served,
            "io_error_fallback_source": fb_src,
            "cache": cache.report(),
            "bench": {"cold_start_ms": cold_ms, "warm_start_ms": warm_ms,
                      "cold_over_warm": round(ratio, 2)},
        }
        ok = (cold_src == "cold" and warm_src == "warm" and warm_served
              and equal and fb_src == "cold"
              and cache.counters["warm_load_failures"] >= 1)
        return ok, details
    finally:
        router.close()
        fc.close()
        cache.close()


SCENARIOS = {
    "replica-crash-mid-storm": scenario_replica_crash_mid_storm,
    "burst-autoscale": scenario_burst_autoscale,
    "rolling-swap": scenario_rolling_swap,
    "cold-start-bench": scenario_cold_start_bench,
}


def shared_tier_leftovers(workdir) -> list:
    """Files still alive under the fleet's shared NVMe namespace -- the
    drill-exit invariant is an EMPTY shared tier."""
    base = os.path.join(workdir, "shared-nvme")
    out = []
    for root, _dirs, files in os.walk(base):
        out.extend(os.path.join(os.path.relpath(root, base), f)
                   for f in files)
    return sorted(out)


def run_scenario(name: str, workdir=None, setup: Optional[Setup] = None,
                 **setup_kw) -> dict:
    """Run one drill (``setup`` or ``Setup(**setup_kw)``); returns the
    verdict record (also usable from tests). Each scenario gets a
    throwaway workdir unless given one."""
    if name not in SCENARIOS:
        raise SystemExit(f"unknown scenario {name!r} "
                         f"(have: {sorted(SCENARIOS)})")
    setup = setup or Setup(**setup_kw)
    _fresh_injector()
    t0 = time.time()
    owned = workdir is None
    if owned:
        workdir = tempfile.mkdtemp(prefix=f"elastic_{name}_")
    try:
        ok, details = SCENARIOS[name](workdir, setup)
        leftovers = shared_tier_leftovers(workdir)
        details["shared_tier_leftovers"] = leftovers
        ok = ok and not leftovers
    finally:
        _fresh_injector()
        # an assertion failure mid-drill must not leave the replicas'
        # shared NVMe namespace behind
        shutil.rmtree(os.path.join(workdir, "shared-nvme"),
                      ignore_errors=True)
        if owned:
            shutil.rmtree(workdir, ignore_errors=True)
    return {"scenario": name, "device": str(setup.device), "ok": ok,
            "seconds": round(time.time() - t0, 2), "details": details}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", help="which drill to run")
    ap.add_argument("--all", action="store_true", help="run every scenario")
    ap.add_argument("--list", action="store_true", help="list scenarios")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--weight-dtype", default="bf16",
                    choices=("bf16", "int8", "int4"))
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=("bf16", "int8", "int4"))
    ap.add_argument("--max-sequences", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    args = ap.parse_args(argv)
    if args.list:
        for name, fn in SCENARIOS.items():
            print(f"{name}: {fn.__doc__.splitlines()[0]}")
        return 0
    names = list(SCENARIOS) if args.all else (
        [args.scenario] if args.scenario else None)
    if not names:
        ap.error("pass --scenario NAME, --all, or --list")
    setup = Setup(device=args.device, preset=args.preset,
                  weight_dtype=args.weight_dtype, kv_dtype=args.kv_dtype,
                  max_sequences=args.max_sequences,
                  max_seq_len=args.max_seq_len, block_size=args.block_size,
                  prefill_chunk=args.prefill_chunk)
    rc = 0
    for name in names:
        verdict = run_scenario(name, setup=setup)
        print(json.dumps(verdict, indent=2, default=str))
        if not verdict["ok"]:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
