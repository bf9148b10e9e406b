"""The port's serving layer (``deepspeed_tpu_torch/serving``: request,
manager, batcher) against the JAX package's, on the CPU.

Every scenario of the reference's ``tests/unit/test_serving.py`` runs once
per package, on the same submissions, through the same code: the
scenario asserts the reference test's own invariants on each package and
returns its outcome record -- state per uid, finish reasons, shed order,
retry-after hints, counters and greedy tokens -- and the two records must
be equal. Both packages serve the ``tiny`` preset in fp32 (its rotary
table raised to the engines' ``max_seq_len`` of 128), the port on
weights bridged from the reference's (``bridge.py``), the reference's
engine on its XLA twins. Each package's engines are built once per
process and shared with ``tests/test_torch_frontend.py`` and
``tests/test_torch_migration.py``; a fixture checks after every test that
each pool is whole again. A few prompt lengths (12 to 96 tokens) and the 32-token prefill
chunk are shared across the scenarios, so the reference compiles few
shapes.

``tests/test_torch_migration.py`` and ``tests/test_torch_frontend.py``
import :class:`Side` and the fixtures from here.
"""

import numpy as np
import pytest

from tests._torch_threads import one_torch_thread  # noqa: F401

PRESET = dict(dtype="float32", max_seq_len=128)
ENGINE_KW = dict(max_sequences=8, max_seq_len=128, block_size=16)


class Side:
    """One package's serving surface: config classes, serving modules,
    injector, observability and engines (built on first use, cached)."""

    def __init__(self, name: str, params):
        self.name = name
        self.params = params
        self._engines = {}
        if name == "jax":
            from deepspeed_tpu import observability as obs
            from deepspeed_tpu import serving
            from deepspeed_tpu.config import config
            from deepspeed_tpu.inference import kv_tier
            from deepspeed_tpu.inference.ragged import CapacityError
            from deepspeed_tpu.resilience import faults
            from deepspeed_tpu.serving import protocol, request, router
        else:
            from deepspeed_tpu_torch import observability as obs
            from deepspeed_tpu_torch import serving
            from deepspeed_tpu_torch.config import config
            from deepspeed_tpu_torch.inference import kv_tier
            from deepspeed_tpu_torch.inference.ragged import CapacityError
            from deepspeed_tpu_torch.resilience import faults
            from deepspeed_tpu_torch.serving import protocol, request, router
        self.serving, self.config, self.obs = serving, config, obs
        self.kv_tier, self.faults, self.protocol = kv_tier, faults, protocol
        self.request, self.router = request, router
        self.CapacityError = CapacityError

    def __getattr__(self, item):
        # serving names (ContinuousBatcher, RequestManager, ShedError, ...)
        return getattr(self.serving, item)

    def cfg(self, **kw):
        return self.config.ServingConfig(**kw)

    def injector(self, specs):
        return self.faults.set_injector(
            None if specs is None else self.faults.FaultInjector(specs))

    def engine(self, kind: str = "a", **kw):
        """A module-scoped engine of this package; ``kind`` names a cached
        one (``kw`` configures it at first use)."""
        if kind not in self._engines:
            if self.name == "jax":
                from deepspeed_tpu.inference import InferenceEngineV2
                from deepspeed_tpu.models import TransformerLM, get_preset

                eng = InferenceEngineV2(
                    TransformerLM(get_preset("tiny", **PRESET)),
                    params=self.params, decode_kernel="xla",
                    **{**ENGINE_KW, **kw})
            else:
                from deepspeed_tpu_torch.bridge import params_from_numpy
                from deepspeed_tpu_torch.inference import InferenceEngineV2
                from deepspeed_tpu_torch.models import (TransformerLM,
                                                        get_preset)

                eng = InferenceEngineV2(
                    TransformerLM(get_preset("tiny", **PRESET)),
                    params_from_numpy(self.params, device="cpu"),
                    device="cpu", **{**ENGINE_KW, **kw})
            self._engines[kind] = eng
        return self._engines[kind]

    def engines(self):
        return list(self._engines.values())


def pool_whole(engine) -> bool:
    alloc = engine.state.allocator
    return alloc.free_blocks == alloc.num_blocks and not engine.state.sequences


_SIDES = []


@pytest.fixture(scope="module")
def sides():
    """(reference, port): the two packages on one set of fp32 weights,
    built once per process and shared by every module that imports this
    fixture, engines included (the reference compiles each engine's steps
    once). A module's end resets the injector and closes the engines' tier
    stores."""
    if not _SIDES:
        import jax

        from deepspeed_tpu.models import TransformerLM, get_preset

        params = jax.device_get(TransformerLM(get_preset(
            "tiny", **PRESET)).init(jax.random.key(0)))
        _SIDES.extend((Side("jax", params), Side("torch", params)))
    yield tuple(_SIDES)
    for side in _SIDES:
        side.injector(None)
        for eng in side.engines():
            eng.close()


@pytest.fixture(autouse=True)
def _whole_pools(request):
    """After the test, every engine's pool is whole again."""
    yield
    if "sides" in request.fixturenames:
        for side in request.getfixturevalue("sides"):
            side.injector(None)
            for kind, eng in side._engines.items():
                assert pool_whole(eng), f"{side.name} {kind}: pool leaked"


def both(sides, scenario, *args):
    """Run ``scenario(side, *args)`` on each package; the outcome records
    must be equal. Returns the port's."""
    ref, port = (scenario(side, *args) for side in sides)
    assert port == ref, (port, ref)
    return port


def prompt(n: int, seed: int):
    return list(np.random.default_rng(seed).integers(0, 250, n))


def ledger(b, uids) -> dict:
    """State, finish reason, retry hint and tokens of each uid."""
    out = {}
    for u in uids:
        r = b.manager.result(u)
        out[u] = (b.manager.resolve(u), r.finish_reason,
                  None if r.error is None else (r.error.reason,
                                                r.error.retryable,
                                                r.error.retry_after_s),
                  [int(t) for t in r.generated])
    return out


# ---------------------------------------------------------------------------
# RequestManager: ledger + typed refusals (no engine)
# ---------------------------------------------------------------------------

def _queue_full(s):
    mgr = s.RequestManager(max_queue_depth=2, retry_after_s=2.5)
    for _ in range(2):
        mgr.submit([1, 2, 3])
    with pytest.raises(s.ShedError) as ei:
        mgr.submit([1, 2, 3])
    e = ei.value
    assert isinstance(e, RuntimeError)
    assert e.reason == "queue_full" and e.retryable and e.retry_after_s > 2.5
    return (e.reason, e.retryable, e.retry_after_s, str(e),
            dict(mgr.counters))


def _retry_after_scales(s):
    mgr = s.RequestManager(max_queue_depth=4, retry_after_s=1.0)
    idle = mgr.current_retry_after()
    for _ in range(4):
        mgr.submit([1])
    full = mgr.current_retry_after()
    hints = []
    for _ in range(6):
        with pytest.raises(s.ShedError) as ei:
            mgr.submit([1])
        hints.append(ei.value.retry_after_s)
    assert idle == 1.0 and full > 1.0 and hints[0] > full
    assert hints == sorted(hints) and hints[-1] <= 4.0
    return idle, full, hints


def _priority_breakdown(s):
    mgr = s.RequestManager()
    for prio in (0, 5, 0, 2):
        mgr.submit([1], priority=prio)
    rep = mgr.report()
    assert mgr.queue_depth_by_priority() == {0: 2, 5: 1, 2: 1}
    return rep


def _closed_refuses(s):
    mgr = s.RequestManager()
    mgr.close("preemption")
    with pytest.raises(s.ShedError) as ei:
        mgr.submit([1])
    assert ei.value.reason == "draining" and ei.value.retryable
    return str(ei.value), mgr.report()


def _every_uid_resolves(s):
    released, now = [], [0.0]
    mgr = s.RequestManager(release_fn=released.append, clock=lambda: now[0])
    u_queued = mgr.submit([1, 2], deadline_s=5.0)
    u_active = mgr.submit([3, 4])
    u_done = mgr.submit([5, 6])
    for uid in (u_active, u_done):
        mgr.admit(mgr.result(uid))
    mgr.complete(mgr.result(u_done))
    mgr.shed(mgr.result(u_active), "kv_pressure")
    now[0] = 10.0
    expired = [r.uid for r in mgr.expire()]
    assert expired == [u_queued] and released == [[u_done], [u_active]]
    return (expired, [mgr.resolve(u) for u in (u_queued, u_active, u_done,
                                               999)],
            released, dict(mgr.counters), mgr.trace(u_active))


def _shed_order(s):
    now = [0.0]
    mgr = s.RequestManager(clock=lambda: now[0])
    lo_old = mgr.submit([1], priority=0)
    now[0] = 1.0
    hi = mgr.submit([1], priority=5)
    now[0] = 2.0
    lo_new = mgr.submit([1], priority=0)
    order = [r.uid for r in mgr.queued_by_shed_order()]
    assert order == [lo_new, lo_old, hi]
    return order, mgr.resolve(hi)


def _tier_flows(s):
    mgr = s.RequestManager(retry_after_s=1.0, default_tier="throughput",
                           retry_after_tier_factor={"batch": 4.0})
    uids = [mgr.submit([1, 2], tier=t)
            for t in ("latency", None, "hyperspeed")]
    tiers = [mgr.result(u).tier for u in uids]
    assert tiers == ["latency", "throughput", "throughput"]
    assert mgr.current_retry_after("batch") \
        == 4.0 * mgr.current_retry_after("latency")
    return tiers, mgr.queue_depth_by_tier(), mgr.current_retry_after("batch")


def _victim_order(s):
    def req(tier, deadline, remaining, uid):
        return s.request.ServeRequest(uid=uid, prompt=[1], submitted_at=0.0,
                                      max_new_tokens=remaining, tier=tier,
                                      deadline=deadline)

    reqs = [req("latency", None, 8, 1), req("batch", None, 64, 2),
            req("batch", None, 4, 3), req("batch", 99.0, 64, 4)]
    order = [r.uid for r in sorted(reqs, key=s.request.ServeRequest.
                                   preempt_key)]
    assert order == [2, 3, 4, 1]
    return order


def _replay_stream(s):
    """The re-prefill fallback's feed: prompt plus all but the last
    generated token, decoding resumes from the last."""
    r = s.request.ServeRequest(uid=0, prompt=s.request.as_prompt([5, 6, 7]),
                               max_new_tokens=4)
    r.generated = [8, 9]
    r.prefilled = 3
    r.prepare_replay()
    return ([int(t) for t in r.feed_source], r.feed_len, r.next_token,
            r.prefilled, r.span())


@pytest.mark.parametrize("scenario", [
    _queue_full, _retry_after_scales, _priority_breakdown, _closed_refuses,
    _every_uid_resolves, _shed_order, _tier_flows, _victim_order,
    _replay_stream], ids=lambda f: f.__name__.strip("_"))
def test_manager_matches_reference(sides, scenario):
    both(sides, scenario)


# ---------------------------------------------------------------------------
# engine-backed batcher scenarios
# ---------------------------------------------------------------------------

def _capacity_error(s):
    eng = s.engine()
    demand = eng.max_seq_len + 8
    with pytest.raises(s.CapacityError) as ei:
        eng.put([999], [np.zeros(demand, np.int32)])
    assert isinstance(ei.value, RuntimeError)
    assert 999 not in eng.state.sequences
    return ei.value.uids, ei.value.token_demand


def _deadline_mid_chunk(s):
    eng = s.engine()
    alloc = eng.state.allocator
    free0 = alloc.free_blocks
    now = [0.0]
    b = s.ContinuousBatcher(eng, s.cfg(prefill_chunk=32,
                                       default_max_new_tokens=4),
                            clock=lambda: now[0])
    uid = b.submit(np.arange(96) % 250, deadline_s=5.0)
    assert b.step()
    req = b.manager.active[uid]
    mid = (req.prefilled, alloc.free_blocks < free0)
    now[0] = 10.0
    b.step()
    done = b.manager.done[uid]
    assert b.manager.resolve(uid) == s.EXPIRED and mid[1]
    assert 0 < done.prefilled < done.prompt_len
    assert alloc.free_blocks == free0
    return mid[0], ledger(b, [uid]), b.serving_report()["counters"]


def _from_config(s):
    eng = s.engine()
    raw = {"train_batch_size": 8, "serving": {
        "enabled": True, "max_queue_depth": 7, "prefill_chunk": 16}}
    if s.name == "jax":
        cfg = s.config.DeepSpeedTpuConfig(**raw)
        off = s.config.DeepSpeedTpuConfig(train_batch_size=8)
    else:
        cfg = s.config.from_config(raw)
        off = s.config.from_config({"train_batch_size": 8})
    b = s.ContinuousBatcher.from_deepspeed_config(eng, cfg)
    with pytest.raises(ValueError, match="serving.enabled"):
        s.ContinuousBatcher.from_deepspeed_config(eng, off)
    return b.cfg.max_queue_depth, b.manager.max_queue_depth, \
        b.cfg.prefill_chunk


def _unadmittable_head(s):
    b = s.ContinuousBatcher(s.engine(), s.cfg(
        prefill_chunk=32, kv_high_watermark=0.05, kv_low_watermark=0.04))
    uid = b.submit(np.arange(60) % 250, max_new_tokens=8)
    ran = b.pump(max_steps=10)
    done = b.manager.done[uid]
    assert done.error.reason == "oversize" and not done.error.retryable
    return ran, ledger(b, [uid])


def _projected_admission(s):
    b = s.ContinuousBatcher(s.engine(), s.cfg(
        prefill_chunk=32, default_max_new_tokens=4, kv_high_watermark=0.10,
        kv_low_watermark=0.05))
    uids = [b.submit(np.arange(60) % 250) for _ in range(2)]
    b.step()
    first = (len(b.manager.active), b.manager.resolve(uids[1]))
    b.pump(max_steps=60)
    assert first == (1, s.QUEUED)
    assert all(b.manager.resolve(u) == s.COMPLETED for u in uids)
    assert b.manager.counters["shed"] == 0
    return first, ledger(b, uids)


class _Monitor:
    """Stands in for a monitor backend: records what ``write_events``
    gets (the port's ``monitor/`` is not ported yet)."""

    def __init__(self):
        self.events = []

    def write_events(self, events):
        self.events.extend(events)


def _report_and_monitor(s):
    mon = _Monitor()
    b = s.ContinuousBatcher(s.engine(), s.cfg(
        prefill_chunk=32, default_max_new_tokens=4, monitor_interval=1),
        monitor=mon, clock=lambda: 0.0, registry=s.obs.MetricsRegistry())
    uids = [b.submit(np.arange(20) % 250) for _ in range(3)]
    b.pump(max_steps=50)
    rep = b.serving_report()
    assert all(b.manager.resolve(u) == s.COMPLETED for u in uids)
    assert rep["counters"]["admitted"] == rep["counters"]["completed"] == 3
    tags = {}
    for tag, value, step in mon.events:
        tags[tag] = (value, step)
    for tag in ("serving/admitted", "serving/shed", "serving/expired",
                "serving/completed", "serving/queue_depth",
                "serving/kv_occupancy", "serving/health",
                "serving/step_p99_ms"):
        assert tag in tags, tag
    assert tags["serving/completed"][0] == 3.0
    keep = {k: rep[k] for k in ("health", "drained", "steps", "counters",
                                "shed_reasons", "queue_depth",
                                "retry_after_s", "retry_after_by_tier",
                                "active_requests", "paused_requests",
                                "latency_ms")}
    keep["kv"] = {k: v for k, v in rep["kv"].items() if k != "tiers"}
    return keep, tags, ledger(b, uids)


def _priority_gauges(s):
    reg = s.obs.MetricsRegistry()
    b = s.ContinuousBatcher(s.engine(), s.cfg(
        prefill_chunk=32, default_max_new_tokens=2, max_active_requests=1),
        registry=reg)
    uids = [b.submit(np.arange(12) % 250, priority=p) for p in (0, 0, 7)]
    assert b.step()
    fam = reg.get("serving/queue_depth")

    def series():
        return {dict(i.labels).get("priority"): i.value
                for i in fam.series.values()}

    mid = series()
    assert mid[None] == 2.0 and mid["0"] == 1.0 and mid["7"] == 1.0
    b.pump(max_steps=60)
    end = series()
    assert end["0"] == 0.0 and end["7"] == 0.0
    return mid, end, b.serving_report()["queue_depth_by_priority"], \
        ledger(b, uids)


def _prefix_aware_admission(s):
    eng = s.engine("prefix", prefix_cache=True)
    shared = np.arange(96) % 250
    eng.put([900], [shared])
    eng.flush([900])
    b = s.ContinuousBatcher(eng, s.cfg(
        prefill_chunk=32, default_max_new_tokens=8, kv_high_watermark=0.30,
        kv_low_watermark=0.20))
    warm0 = (b.reclaimable_blocks, b.kv_occupancy)
    a = b.submit((np.arange(96) + 7) % 250)
    b.step()
    warm = b.submit(shared)
    cold = b.submit((np.arange(96) + 31) % 250)
    b.step()
    mid = (b.manager.resolve(warm), b.manager.resolve(cold),
           b.counters["prefix_hit_requests"], b.counters["prefix_hit_tokens"])
    b.pump(max_steps=200)
    assert warm0 == (6, 0.0) and mid[1] == s.QUEUED and mid[2:] == (1, 80)
    assert b.manager.counters["shed"] == 0
    out = (warm0, mid, ledger(b, [a, warm, cold]))
    eng.prefix_cache.clear()
    return out


@pytest.mark.parametrize("scenario", [
    _capacity_error, _deadline_mid_chunk, _from_config, _unadmittable_head,
    _projected_admission, _report_and_monitor, _priority_gauges,
    _prefix_aware_admission], ids=lambda f: f.__name__.strip("_"))
def test_batcher_matches_reference(sides, scenario):
    both(sides, scenario)


# ---------------------------------------------------------------------------
# SLO tiers + preemption (pause/resume through the KV tier store)
# ---------------------------------------------------------------------------

def slo_batcher(s, **serving):
    return s.ContinuousBatcher(s.engine(), s.cfg(**{
        "prefill_chunk": 32, "default_max_new_tokens": 8,
        "slo": {"enabled": True, "preempt": True}, **serving}))


def _pause_resume_bit_identical(s):
    b = slo_batcher(s)
    p = prompt(40, 7)
    base_uid = b.submit(p, max_new_tokens=8, tier="batch")
    b.pump(max_steps=50)
    base = list(b.manager.result(base_uid).generated)
    uid = b.submit(p, max_new_tokens=8, tier="batch")
    for _ in range(4):
        b.step()
    req = b.manager.active[uid]
    mid = len(req.generated)
    assert b.engine.pause_request(uid)
    b.manager.pause(req)
    assert uid not in b.engine.state.sequences and b.engine.is_paused(uid)
    parked = b.engine.paused_blocks(uid)
    b.pump(max_steps=60)
    res = b.manager.result(uid)
    assert 0 < mid < 8 and list(res.generated) == base
    assert b.engine._tier_store.entries() == 0
    return mid, parked, base, ledger(b, [base_uid, uid]), \
        dict(b.manager.counters)


def _preempt_mid_prefill(s):
    b = slo_batcher(s, default_max_new_tokens=4)
    p = prompt(96, 3)
    base_uid = b.submit(p, tier="batch")
    b.pump(max_steps=40)
    base = list(b.manager.result(base_uid).generated)
    alloc = b.engine.state.allocator
    free0 = alloc.free_blocks
    uid = b.submit(p, tier="batch")
    b.step()
    req = b.manager.active[uid]
    assert req.state == "prefilling" and req.prefilled == 32
    assert b.engine.pause_request(uid)
    b.manager.pause(req)
    assert alloc.free_blocks == free0
    b.pump(max_steps=60)
    assert list(b.manager.result(uid).generated) == base
    assert b.engine._tier_store.entries() == 0
    return base, ledger(b, [base_uid, uid])


def _starvation_guard(s):
    b = slo_batcher(s)
    victim = b.submit(prompt(40, 5), max_new_tokens=8, tier="batch")
    other = b.submit(prompt(40, 6), max_new_tokens=8, tier="latency")
    for _ in range(3):
        b.step()
    req = b.manager.active[victim]
    assert req.pause_allowed()
    s.injector([{"kind": "preempt_storm", "times": 2}])
    b.step()
    after1 = (b.manager.counters["paused"], req.pause_count,
              req.pause_allowed())
    b.step()
    after2 = b.manager.counters["paused"]
    s.injector(None)
    b.pump(max_steps=80)
    assert after1 == (1, 1, False) and after2 == 1
    assert b.manager.counters["shed"] == 0
    r = b.manager.result(victim)
    assert r.progress > r.progress_at_last_pause
    return after1, after2, ledger(b, [victim, other])


def _resume_io_error(s):
    b = slo_batcher(s)
    uid = b.submit(prompt(40, 11), max_new_tokens=8, tier="batch")
    for _ in range(3):
        b.step()
    assert b.engine.pause_request(uid)
    b.manager.pause(b.manager.active[uid])
    s.injector([{"kind": "resume_io_error", "times": 8}])
    b.pump(max_steps=20)
    s.injector(None)
    req = b.manager.result(uid)
    assert req.error.reason == "resume_io_error" and req.error.retryable
    assert b.counters["resume_failures"] >= 1
    assert b.engine._tier_store.entries() == 0
    return ledger(b, [uid]), b.counters["resume_failures"]


def _per_tier_budget(s):
    b = slo_batcher(s, default_max_new_tokens=4,
                    slo={"enabled": True, "preempt": True,
                         "budgets": {"batch": 0.10}})
    bat = [b.submit(np.arange(60) % 250, tier="batch") for _ in range(2)]
    lat = b.submit(np.arange(60) % 250, tier="latency")
    b.step()
    first = [b.manager.resolve(u) for u in bat + [lat]]
    b.pump(max_steps=80)
    assert first[1] == s.QUEUED and first[2] in ("prefilling", "decoding",
                                                 s.COMPLETED)
    assert b.manager.counters["shed"] == 0
    return first, ledger(b, bat + [lat])


@pytest.mark.parametrize("scenario", [
    _pause_resume_bit_identical, _preempt_mid_prefill, _starvation_guard,
    _resume_io_error, _per_tier_budget], ids=lambda f: f.__name__.strip("_"))
def test_slo_preemption_matches_reference(sides, scenario):
    both(sides, scenario)


def _drain(s):
    """SIGTERM-style drain of one batcher (the reference's sigterm-drain
    drill): admission closes retryably, the queue is shed, in-flight
    requests finish."""
    b = slo_batcher(s, default_max_new_tokens=8, max_active_requests=4)
    uids = [b.submit(prompt(40, 20 + i)) for i in range(6)]
    b.step()
    b.step()
    b.begin_drain("SIGTERM")
    b.pump(max_steps=100)
    with pytest.raises(s.ShedError) as ei:
        b.submit([1, 2, 3])
    rep = b.drain(timeout_s=60.0)
    assert b.drained and rep["health"] == "draining"
    assert ei.value.reason == "draining"
    return ledger(b, uids), rep["counters"], rep["shed_reasons"]


def test_drain_matches_reference(sides):
    both(sides, _drain)


def test_config_serving_section_and_fleet_refusal():
    """``serving`` builds with the reference's defaults and validators,
    its ``fleet`` section included (which no longer refuses anything but
    its defaults: ``tests/test_torch_fleet.py`` holds it against the
    reference case by case)."""
    from deepspeed_tpu.config.config import ServingConfig as Ref
    from deepspeed_tpu_torch.config import ServingConfig, from_config

    ref, port = Ref(), ServingConfig()
    for sec in (None, "frontend", "router", "fleet", "slo", "migration"):
        r = ref if sec is None else getattr(ref, sec)
        p = port if sec is None else getattr(port, sec)
        for k, v in r.model_dump().items():
            if not isinstance(v, dict) or sec is not None:
                assert getattr(p, k) == v, (sec, k)
    cfg = from_config({"serving": {"enabled": True, "fleet": {
        "enabled": False, "max_replicas": 4}}})
    assert cfg.serving.enabled and cfg.serving.fleet.max_replicas == 4
    cfg = from_config({"serving": {"fleet": {"enabled": True,
                                             "min_ready_floor": 2}}})
    assert cfg.serving.fleet.enabled and cfg.serving.fleet.min_ready_floor == 2
    for bad in ({"slo": {"default_tier": "gold"}},
                {"kv_low_watermark": 0.95},
                {"migration": {"enabled": True}},
                {"frontend": {"min_header_priority": 3}},
                {"router": {"failover_attempts": -1}},
                {"fleet": {"min_replicas": 0}}):
        with pytest.raises(ValueError):
            from_config({"serving": bad})
