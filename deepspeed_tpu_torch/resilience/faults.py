"""Deterministic fault injection (counterpart of
``deepspeed_tpu/resilience/faults.py``).

The reference validates its recovery paths with chaos-style integration tests
(kill a rank mid-step, truncate a checkpoint shard); here the injection points
are first-class so the SAME faults drive unit tests and the ``resilience``
config block. A fault fires at an exact (site, step/occurrence) coordinate —
never randomly — so every recovery test is reproducible.

Sites (the strings hooks pass to :meth:`FaultInjector.fire`):

* ``"step"`` — start of the optimizer step; ``crash`` faults raise
  :class:`InjectedCrash` (or hard-exit with ``exit_code`` when ``hard=True``,
  simulating a host loss the Python runtime cannot catch).
* ``"grads"`` — gradients about to be applied; ``nan_grads`` faults poison the
  tree so the step guard's detection path is exercised end-to-end.
* ``"collective"`` — host-level collective entry (``comm/comm.py``);
  ``slow_collective`` sleeps, ``failed_collective`` raises
  :class:`InjectedIOError` for the first ``times`` calls (retry testing).
* ``"checkpoint_write"`` — checkpoint commit; ``torn_checkpoint`` truncates or
  corrupts files after the save so verification must reject the tag.
* ``"checkpoint_io"`` — checkpoint IO entry; ``io_error`` raises for the first
  ``times`` calls (retry testing).
* ``"swap_read"`` / ``"swap_write"`` — the offload swapper's submit hooks
  (``offload/swap.py``); an ``io_error`` spec whose ``site`` names one of
  them fires mid-pipeline in the NVMe optimizer path (drilled by
  ``tools/offload_drill.py``). Site is REQUIRED here: an un-sited
  ``io_error`` keeps its checkpoint-IO-only firing so existing drills are
  unchanged.
* serving sites (``deepspeed_tpu/serving``, drilled by ``tools/serve_drill.py``
  the way ``tools/chaos_drill.py`` drills training): ``slow_decode`` sleeps at
  the batcher's decode dispatch, ``cache_io_error`` raises
  :class:`InjectedIOError` at the engine step (a lost KV-cache read/write),
  ``decode_nan`` poisons a step's returned logits so the batcher's failure
  window and degraded mode are exercised, and ``shed_storm`` forces the
  watermark-shedding path for ``times`` consecutive serving steps.
* SLO-preemption sites (``serving/batcher.py`` pause/resume, drilled by
  ``tools/serve_drill.py --scenario slo-storm``): ``preempt_storm`` forces
  victim selection (the pause path) for ``times`` consecutive serving
  steps even with KV occupancy under the watermarks; ``resume_io_error``
  raises :class:`InjectedIOError` in the engine's resume tier-read — the
  victim must re-queue or shed RETRYABLY, never serve zeroed KV (``site``
  optionally pins the failure to one tier: ``host`` | ``nvme``).
* replica-lifecycle sites (``serving/router.py`` + ``serving/fleet.py``,
  drilled by ``tools/elastic_drill.py``): ``replica_crash`` raises
  :class:`InjectedCrash` at the top of a replica worker loop — OUTSIDE the
  batcher step's own exception absorption — so the worker thread actually
  dies and the :class:`FleetController` death-detection path runs
  (``site`` optionally pins the crash to one replica name; ``hard``
  hard-exits, simulating host loss); ``slow_start`` sleeps ``delay_s`` at
  replica startup (cold-start / readiness-probe timeout drills);
  ``weight_load_io_error`` raises :class:`InjectedIOError` in the warm
  weight-load path so the cold fallback is exercised.
* cross-replica-migration sites (durable pause export / sibling adopt,
  drilled by ``tools/serve_drill.py --scenario crash-migrate``):
  ``migrate_io_error`` raises :class:`InjectedIOError` in the adopted
  record's tier read so the sibling must fall back to re-prefill from
  token history (``site`` pins a tier: ``host`` | ``nvme``);
  ``manifest_torn`` truncates a just-committed resume manifest so
  adoption must reject it on the sha check (``site`` pins a uid); and
  ``crash_during_pause_export`` dies between the KV demote and the
  manifest commit — durable bytes with no manifest — so recovery must
  re-prefill and still reclaim the orphaned tier files.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["FaultSpec", "FaultInjector", "InjectedCrash", "InjectedIOError",
           "get_injector", "set_injector"]


def _tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class InjectedCrash(RuntimeError):
    """A deliberate, injected process failure (soft crash)."""


class InjectedIOError(OSError):
    """A deliberate, injected IO/communication failure."""


@dataclasses.dataclass
class FaultSpec:
    """One configured fault.

    ``kind``: crash | nan_grads | slow_collective | failed_collective |
    torn_checkpoint | io_error.
    ``step``: global step at which step-site faults fire (-1 = any step).
    ``times``: for occurrence-counted faults (failed_collective / io_error),
    how many consecutive calls fail before succeeding.
    ``site``: narrows io_error/crash faults to one checkpoint-IO hook site
    (``save`` | ``load`` | ``async_commit``); None fires at any IO site.
    A ``crash`` spec with a ``site`` simulates host loss at that exact IO
    point — e.g. ``{"kind": "crash", "site": "async_commit"}`` is the
    preemption-between-stage-and-manifest drill.
    """

    kind: str
    step: int = -1
    times: int = 1
    hard: bool = False          # crash: os._exit instead of raising
    exit_code: int = 43         # crash: hard-exit code
    delay_s: float = 0.0        # slow_collective: injected latency
    mode: str = "truncate"      # torn_checkpoint: truncate | corrupt | unlink
    site: Optional[str] = None  # io_error/crash: restrict to one IO hook site

    KINDS = ("crash", "nan_grads", "slow_collective", "failed_collective",
             "torn_checkpoint", "io_error",
             # serving sites (ContinuousBatcher hooks)
             "slow_decode", "decode_nan", "shed_storm", "cache_io_error",
             # SLO-preemption sites (pause/resume through the KV tier)
             "preempt_storm", "resume_io_error",
             # replica-lifecycle sites (Replica/FleetController hooks)
             "replica_crash", "slow_start", "weight_load_io_error",
             # cross-replica migration sites (durable pause export / adopt)
             "migrate_io_error", "manifest_torn", "crash_during_pause_export",
             # MoE expert-parallel a2a dispatch (engine_v2 hook)
             "moe_a2a_error")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {list(self.KINDS)})")

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown fault spec keys {sorted(unknown)} "
                             f"(known: {sorted(known)})")
        return cls(**d)


class FaultInjector:
    """Holds the fault table and fires faults at hook sites.

    Disabled (the default, empty table) it is a handful of dict lookups —
    cheap enough that the hooks stay unconditionally wired.
    """

    def __init__(self, faults: Optional[List] = None):
        self.faults: List[FaultSpec] = [
            f if isinstance(f, FaultSpec) else FaultSpec.from_dict(dict(f))
            for f in (faults or [])]
        self.fired: List[str] = []          # audit log of faults that fired
        self._counts: Dict[int, int] = {}   # per-spec occurrence counter

    def __bool__(self) -> bool:
        return bool(self.faults)

    def _record(self, spec: FaultSpec, site: str) -> None:
        self.fired.append(f"{spec.kind}@{site}:step={spec.step}")
        logger.warning(f"fault injected: {spec.kind} at {site} "
                       f"(step={spec.step})")

    def _take(self, spec: FaultSpec) -> bool:
        """Occurrence-counted firing: True for the first ``times`` calls."""
        i = id(spec)
        n = self._counts.get(i, 0)
        if n >= spec.times:
            return False
        self._counts[i] = n + 1
        return True

    # ---- step-site faults -------------------------------------------------
    def maybe_crash(self, step: int) -> None:
        for spec in self.faults:
            if spec.kind == "crash" and spec.step in (step, -1) \
                    and self._take(spec):
                self._record(spec, "step")
                if spec.hard:
                    os._exit(spec.exit_code)
                raise InjectedCrash(f"injected crash at step {step}")

    def maybe_poison_grads(self, step: int, grads):
        """Return ``grads`` with NaNs injected if a nan_grads fault matches."""
        for spec in self.faults:
            if spec.kind == "nan_grads" and spec.step in (step, -1) \
                    and self._take(spec):
                self._record(spec, "grads")
                import torch

                return _tree_map(
                    lambda g: torch.full_like(g, float("nan")), grads)
        return grads

    # ---- collective-site faults -------------------------------------------
    def on_collective(self, name: str) -> None:
        for spec in self.faults:
            if spec.kind == "slow_collective" and self._take(spec):
                self._record(spec, f"collective:{name}")
                time.sleep(spec.delay_s)
            elif spec.kind == "failed_collective" and self._take(spec):
                self._record(spec, f"collective:{name}")
                raise InjectedIOError(f"injected collective failure in {name}")

    # ---- checkpoint-site faults -------------------------------------------
    def on_checkpoint_io(self, what: str) -> None:
        for spec in self.faults:
            if spec.kind == "io_error" and spec.site in (None, what) \
                    and self._take(spec):
                self._record(spec, f"checkpoint_io:{what}")
                raise InjectedIOError(f"injected checkpoint IO failure ({what})")
            # a crash pinned to an IO site = host loss at that exact point
            # (site REQUIRED: an un-sited crash spec keeps its step-site-only
            # firing so existing drills are unchanged)
            if spec.kind == "crash" and spec.site == what \
                    and self._take(spec):
                self._record(spec, f"checkpoint_io:{what}")
                if spec.hard:
                    os._exit(spec.exit_code)
                raise InjectedCrash(f"injected crash at checkpoint IO ({what})")

    # ---- offload-swap-site faults -----------------------------------------
    def on_swap_io(self, site: str) -> None:
        """Hook at the offload swapper's op submission (``site``:
        ``swap_read`` | ``swap_write``). Only ``io_error`` specs EXPLICITLY
        pinned to a swap site fire — ``site=None`` stays checkpoint-IO-only
        so pre-existing drills keep their semantics."""
        for spec in self.faults:
            if spec.kind == "io_error" \
                    and spec.site in ("swap_read", "swap_write") \
                    and spec.site == site and self._take(spec):
                self._record(spec, f"offload:{site}")
                raise InjectedIOError(f"injected swap IO failure ({site})")

    # ---- serving-site faults ----------------------------------------------
    def on_serving_step(self, site: str) -> None:
        """Hook at the batcher's engine dispatch (``site``: ``prefill`` |
        ``decode``). ``slow_decode`` injects latency at the decode site (step
        deadline / p99 drills); ``cache_io_error`` raises at any serving site
        (or the one named by ``spec.site``) — the batcher must absorb it as a
        failed step, not lose requests."""
        for spec in self.faults:
            if spec.kind == "slow_decode" and site == "decode" \
                    and self._take(spec):
                self._record(spec, f"serving:{site}")
                time.sleep(spec.delay_s)
            elif spec.kind == "cache_io_error" \
                    and spec.site in (None, site) and self._take(spec):
                self._record(spec, f"serving:{site}")
                raise InjectedIOError(
                    f"injected KV-cache IO failure ({site})")

    def on_moe_dispatch(self, site: str) -> None:
        """Hook at the engine's expert-parallel MoE dispatch (``site``:
        ``prefill`` | ``decode``), fired just before the step that carries
        the token all-to-all. ``moe_a2a_error`` raises mid-dispatch — the
        batcher must absorb it like any failed serving step (requests
        retried or shed, never silently lost), which is exactly what the
        ``moe-storm`` drill asserts."""
        for spec in self.faults:
            if spec.kind == "moe_a2a_error" \
                    and spec.site in (None, site) and self._take(spec):
                self._record(spec, f"moe_a2a:{site}")
                raise InjectedIOError(
                    f"injected MoE all-to-all failure ({site})")

    def maybe_poison_logits(self, logits):
        """Return ``logits`` poisoned to NaN when a ``decode_nan`` fault
        matches (serving analog of :meth:`maybe_poison_grads`)."""
        for spec in self.faults:
            if spec.kind == "decode_nan" and self._take(spec):
                self._record(spec, "serving:decode")
                import numpy as np

                return np.full_like(np.asarray(logits, np.float32), np.nan)
        return logits

    def shed_forced(self) -> bool:
        """True while a ``shed_storm`` fault has occurrences left: the
        batcher treats its load watermarks as exceeded this step."""
        for spec in self.faults:
            if spec.kind == "shed_storm" and self._take(spec):
                self._record(spec, "serving:shed")
                return True
        return False

    def preempt_forced(self) -> bool:
        """True while a ``preempt_storm`` fault has occurrences left: the
        batcher runs victim selection (the pause path) this step even with
        KV occupancy under the watermarks — the drill lever for exercising
        pause→resume cycles without actually saturating the pool."""
        for spec in self.faults:
            if spec.kind == "preempt_storm" and self._take(spec):
                self._record(spec, "serving:preempt")
                return True
        return False

    def on_resume_read(self, tier: str) -> None:
        """Hook in the engine's resume tier-read (one call per parked
        block, before its ``wait()``): a ``resume_io_error`` spec raises so
        the resume must unwind — the victim re-queues or sheds retryably,
        NEVER decodes over zero-filled KV. ``site`` pins the failure to
        one tier (``host`` | ``nvme``); None fires at any tier."""
        for spec in self.faults:
            if spec.kind == "resume_io_error" \
                    and spec.site in (None, tier) and self._take(spec):
                self._record(spec, f"resume:{tier}")
                raise InjectedIOError(
                    f"injected resume tier-read failure ({tier})")

    # ---- replica-lifecycle faults -----------------------------------------
    def on_replica_loop(self, name: str) -> None:
        """Hook at the top of a :class:`Replica` worker iteration, BEFORE
        the batcher-step try/except — an injected ``replica_crash`` must
        escape the loop and kill the worker thread (that absorption
        boundary exists for step bugs, not for host loss). ``site`` pins
        the crash to one replica name; None kills whichever replica's
        worker fires first."""
        for spec in self.faults:
            if spec.kind == "replica_crash" and spec.site in (None, name) \
                    and self._take(spec):
                self._record(spec, f"replica:{name}")
                if spec.hard:
                    os._exit(spec.exit_code)
                raise InjectedCrash(f"injected replica crash ({name})")

    def on_replica_start(self, name: str) -> None:
        """Hook at replica worker startup: ``slow_start`` sleeps
        ``delay_s`` (cold-start and readiness-probe-timeout drills).
        ``site`` pins the stall to one replica name."""
        for spec in self.faults:
            if spec.kind == "slow_start" and spec.site in (None, name) \
                    and self._take(spec):
                self._record(spec, f"replica_start:{name}")
                time.sleep(spec.delay_s)

    def on_weight_load(self, what: str = "warm") -> None:
        """Hook in the warm-start weight path (``what``: ``warm`` for the
        AIO-streamed read, ``publish`` for the cache write): a
        ``weight_load_io_error`` spec raises so callers must fall back to
        the cold path rather than crash the respawn."""
        for spec in self.faults:
            if spec.kind == "weight_load_io_error" \
                    and spec.site in (None, what) and self._take(spec):
                self._record(spec, f"weight_load:{what}")
                raise InjectedIOError(
                    f"injected weight-load IO failure ({what})")

    # ---- cross-replica-migration faults -----------------------------------
    def on_migrate_read(self, tier: str) -> None:
        """Hook in the engine's ADOPTED-record tier read (cross-replica
        resume promoting KV another replica demoted; one call per parked
        block, before its ``wait()``): a ``migrate_io_error`` spec raises
        so the adopt must unwind — the sibling falls back to re-prefill
        from token history, NEVER decodes over zero-filled KV. ``site``
        pins the failure to one tier (``host`` | ``nvme``)."""
        for spec in self.faults:
            if spec.kind == "migrate_io_error" \
                    and spec.site in (None, tier) and self._take(spec):
                self._record(spec, f"migrate:{tier}")
                raise InjectedIOError(
                    f"injected migrate tier-read failure ({tier})")

    def maybe_tear_manifest(self, path: str, uid: str) -> bool:
        """After a resume-manifest commit: a ``manifest_torn`` spec
        truncates the file in place (a torn write the donor never saw),
        so adoption must reject it on the sha/JSON check and fall back
        to re-prefill. ``site`` pins the tear to one manifest uid.
        Returns True if a tear fired."""
        fired = False
        for spec in self.faults:
            if spec.kind == "manifest_torn" and spec.site in (None, uid) \
                    and self._take(spec):
                self._record(spec, f"manifest:{uid}")
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.truncate(max(size // 2, 1))
                fired = True
        return fired

    def on_pause_export(self, uid: str) -> None:
        """Hook between the durable KV demote and the manifest commit:
        a ``crash_during_pause_export`` spec raises :class:`InjectedCrash`
        (or hard-exits) at the exact window where KV bytes exist on the
        shared namespace but no manifest points at them — recovery must
        treat the export as absent (no manifest → re-prefill ladder) and
        the orphaned tier files must still be reclaimed. ``site`` pins
        the crash to one request uid."""
        for spec in self.faults:
            if spec.kind == "crash_during_pause_export" \
                    and spec.site in (None, uid) and self._take(spec):
                self._record(spec, f"pause_export:{uid}")
                if spec.hard:
                    os._exit(spec.exit_code)
                raise InjectedCrash(
                    f"injected crash during pause export ({uid})")

    def maybe_tear_checkpoint(self, tag_dir: str, step: int) -> bool:
        """After a save: damage the newest tag so verification must reject it.
        Returns True if a tear fired (callers may want to log)."""
        fired = False
        for spec in self.faults:
            if spec.kind == "torn_checkpoint" and spec.step in (step, -1) \
                    and self._take(spec):
                self._record(spec, "checkpoint_write")
                tear_checkpoint_dir(tag_dir, mode=spec.mode)
                fired = True
        return fired


def tear_checkpoint_dir(tag_dir: str, mode: str = "truncate") -> None:
    """Damage a checkpoint tag directory in-place (also callable from tests).

    ``truncate`` halves the largest data file (a torn write), ``corrupt``
    flips bytes in it (silent bit rot), ``unlink`` removes it (lost object).
    """
    victims = []
    for root, _dirs, files in os.walk(tag_dir):
        for f in files:
            p = os.path.join(root, f)
            victims.append((os.path.getsize(p), p))
    if not victims:
        raise FileNotFoundError(f"no files to tear under {tag_dir}")
    _, victim = max(victims)
    if mode == "truncate":
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif mode == "corrupt":
        with open(victim, "r+b") as f:
            data = bytearray(f.read())
            for i in range(0, len(data), max(len(data) // 64, 1)):
                data[i] ^= 0xFF
            f.seek(0)
            f.write(data)
    elif mode == "unlink":
        os.unlink(victim)
    else:
        raise ValueError(f"unknown tear mode {mode!r}")
    logger.warning(f"tore checkpoint file {victim} (mode={mode})")


# The process-wide injector: hooks in engine/comm/checkpoint consult this.
# Tests and the config plumbing swap it; the default empty injector is inert.
_injector = FaultInjector()


def get_injector() -> FaultInjector:
    return _injector


def set_injector(inj: Optional[FaultInjector]) -> FaultInjector:
    """Install ``inj`` (or a fresh inert injector when None); returns it."""
    global _injector
    _injector = inj if inj is not None else FaultInjector()
    return _injector
