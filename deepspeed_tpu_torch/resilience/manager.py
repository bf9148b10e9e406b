"""Preemption-aware checkpoint lifecycle management (counterpart of
``deepspeed_tpu/resilience/manager.py``).

Layered over ``runtime/checkpoint.py`` (which owns the data format):

* every save writes a per-tag ``manifest.json`` (file sizes + sha256) BEFORE
  the ``latest`` pointer moves, so ``latest`` only ever names a tag whose
  integrity can be proven;
* loads verify the manifest and step back to the previous good tag when the
  newest one fails (torn write, lost object, bit rot) instead of crashing;
* keep-last-K retention garbage-collects old tags (never the one ``latest``
  points at);
* a SIGTERM handler arms an emergency save that fires at the next step
  boundary — the preemption notice → drain → save → exit flow;
* ``async_save=True`` moves the commit half (manifest → ``latest`` → GC) to a
  background committer thread while training continues: the tag directory
  carries a ``.staging`` sentinel from first byte until the manifest is
  durable, so a crash between stage and commit leaves a tag that load-time
  verification REJECTS (falling back to the previous verified tag) instead of
  a tag that merely looks legacy. ``drain()`` fences the committer at the
  next save, any emergency save, every load, and engine shutdown;
* all IO goes through :func:`~deepspeed_tpu_torch.resilience.retry.retry_call`.

Every recovery event is counted in :attr:`CheckpointManager.counters`, which
``engine.resilience_report()`` folds into the report the elastic agent reads.
The manifest's schema is the reference's: each package's
:func:`verify_tag_dir` judges a tag the other committed.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.resilience.faults import get_injector
from deepspeed_tpu_torch.resilience.retry import RetryPolicy, retry_call
from deepspeed_tpu_torch.utils.io import atomic_write_text
from deepspeed_tpu_torch.utils.logging import _process_index, log_dist, logger

MANIFEST_FILE = "manifest.json"
# present from stage start until the manifest commit: marks a tag whose data
# may be complete on disk but whose integrity was never proven
STAGING_FILE = ".staging"

__all__ = ["CheckpointManager", "verify_tag_dir", "write_manifest",
           "STAGING_FILE"]


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _walk_files(tag_dir: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(tag_dir):
        for f in files:
            if f in (MANIFEST_FILE, STAGING_FILE) and root == tag_dir:
                continue
            out.append(os.path.relpath(os.path.join(root, f), tag_dir))
    return sorted(out)


def write_manifest(tag_dir: str, global_steps: int,
                   extra: Optional[Dict] = None) -> str:
    """Checksum every file under ``tag_dir`` into ``manifest.json``.

    ``extra`` merges additional metadata into the manifest — the coordinated
    SAVE/ABORT decision record rides here so every tag names the fleet
    decision (and deciding step) that produced it."""
    files = {}
    for rel in _walk_files(tag_dir):
        p = os.path.join(tag_dir, rel)
        files[rel] = {"size": os.path.getsize(p), "sha256": _sha256(p)}
    manifest = {"tag": os.path.basename(tag_dir),
                "global_steps": int(global_steps),
                "created": time.time(),
                **(extra or {}),
                "files": files}
    path = os.path.join(tag_dir, MANIFEST_FILE)
    atomic_write_text(path, json.dumps(manifest, indent=2))
    return path


def verify_tag_dir(tag_dir: str) -> Tuple[bool, str]:
    """Check ``tag_dir`` against its manifest. Returns (ok, reason)."""
    mpath = os.path.join(tag_dir, MANIFEST_FILE)
    if not os.path.exists(mpath):
        return False, "no manifest"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"unreadable manifest: {e}"
    for rel, want in manifest.get("files", {}).items():
        p = os.path.join(tag_dir, rel)
        if not os.path.exists(p):
            return False, f"missing file {rel}"
        size = os.path.getsize(p)
        if size != want["size"]:
            return False, f"size mismatch {rel}: {size} != {want['size']}"
        if _sha256(p) != want["sha256"]:
            return False, f"checksum mismatch {rel}"
    return True, "ok"


class CheckpointManager:
    """One manager per checkpoint directory. See module docstring."""

    def __init__(self, save_dir: str, keep_last_k: int = 3,
                 verify: bool = True,
                 retry_policy: Optional[RetryPolicy] = None,
                 async_save: bool = False):
        self.save_dir = os.path.abspath(save_dir)
        self.keep_last_k = int(keep_last_k)
        self.verify = bool(verify)
        self.retry_policy = retry_policy or RetryPolicy()
        self.async_save = bool(async_save)
        self.preempted = False
        self._preempt_handler_installed = False
        self._prev_sigterm = None
        # (thread, error_box, tag) of the in-flight async commit, if any
        self._pending_async: Optional[Tuple] = None
        self.async_stats: Dict[str, float] = {
            "commits": 0, "last_latency_s": 0.0, "total_latency_s": 0.0}
        self.counters: Dict[str, int] = {
            "saves": 0, "emergency_saves": 0, "gc_removed": 0,
            "verify_failures": 0, "load_fallbacks": 0, "io_retries": 0,
            "async_saves": 0, "async_commit_failures": 0, "staged_rejected": 0,
        }

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save(self, engine, tag: Optional[str] = None,
             client_state: Optional[Dict] = None,
             emergency: bool = False,
             asynchronous: Optional[bool] = None,
             decision: Optional[Dict] = None) -> str:
        """Commit protocol: data → manifest → atomic ``latest`` → GC.

        A crash at ANY point leaves either the previous checkpoint resumable
        (latest untouched) or the new one fully verified. With
        ``asynchronous`` (default: the manager's ``async_save``) the stage is
        written inline but the manifest→``latest``→GC commit runs on a
        background thread; the staged tag carries a ``.staging`` sentinel
        until committed so a crash in the window is load-time rejectable.
        Emergency saves always commit synchronously — the preemption grace
        window is no place for a background thread. ``decision`` (a
        coordinator ``decision_record()``) is stamped into the manifest."""
        from deepspeed_tpu_torch.runtime import checkpoint as ckpt

        self.drain(raise_on_error=False)  # one async commit in flight, ever
        tag = tag or f"global_step{engine.global_steps}"
        # snapshot now: by the time the background committer runs, training
        # has advanced engine.global_steps past the staged state
        global_steps = int(engine.global_steps)
        inj = get_injector()
        use_async = self.async_save if asynchronous is None else asynchronous
        if emergency:
            use_async = False
        t0 = time.monotonic()
        proc0 = _process_index() == 0
        tag_dir = os.path.join(self.save_dir, tag)
        if use_async and proc0:
            os.makedirs(tag_dir, exist_ok=True)
            atomic_write_text(os.path.join(tag_dir, STAGING_FILE),
                              str(time.time()))

        def _on_retry(_attempt, _exc):
            self.counters["io_retries"] += 1

        def _save():
            inj.on_checkpoint_io("save")
            path = ckpt.save_checkpoint(engine, self.save_dir, tag=tag,
                                        client_state=client_state,
                                        write_latest=False)
            if not use_async:
                ckpt.finalize_pending(engine)  # manifest must see final bytes
            return path

        path = retry_call(_save, policy=self.retry_policy,
                          what=f"checkpoint save ({tag})", on_retry=_on_retry)
        from deepspeed_tpu_torch.observability.events import get_bus

        _bus = get_bus()
        if _bus.enabled:
            _bus.instant("checkpoint", "staged",
                         args={"tag": tag, "step": global_steps,
                               "async": use_async, "emergency": emergency})

        def _commit():
            # the window between stage and this point is the crash drill:
            # an injected io_error/crash at site "async_commit" (or a real
            # host loss) leaves the sentinel in place and latest untouched.
            # finalize_pending (the file writes) is NOT retried on the async
            # path: retrying would require restaging, which only the caller
            # thread can do — a failed stage is counted and superseded by
            # the next save, while latest keeps the previous verified tag.
            ckpt.finalize_pending(engine)
            if use_async:
                inj.on_checkpoint_io("async_commit")

            def _manifest_io():
                write_manifest(path, global_steps, extra=(
                    {"coordination": decision} if decision else None))
                staging = os.path.join(path, STAGING_FILE)
                if os.path.exists(staging):
                    os.unlink(staging)

            def _latest_io():
                ckpt.write_latest_atomic(self.save_dir, tag)
                self._gc()

            if proc0:
                # the commit-protocol IO is ordinary filesystem IO: transient
                # remote-FS blips get the same RetryPolicy as the stage.
                # Retried in two phases so the injected tear point stays
                # strictly between manifest and latest (a retry must never
                # re-checksum post-tear data into a passing manifest).
                retry_call(_manifest_io, policy=self.retry_policy,
                           what=f"checkpoint manifest ({tag})",
                           on_retry=_on_retry)
                # a configured torn_checkpoint fault damages the tag here —
                # after the manifest, before latest — modeling a torn write
                # that the load-time verification must catch
                inj.maybe_tear_checkpoint(path, global_steps)
                retry_call(_latest_io, policy=self.retry_policy,
                           what=f"checkpoint latest ({tag})",
                           on_retry=_on_retry)
            if _bus.enabled:
                # committed = manifest written + latest flipped: the stage
                # -> commit gap on the timeline IS the async-save window
                _bus.instant("checkpoint", "committed",
                             args={"tag": tag, "step": global_steps,
                                   "async": use_async,
                                   "emergency": emergency})

        if use_async:
            error_box: list = []

            def _commit_bg():
                try:
                    _commit()
                    dt = time.monotonic() - t0
                    # a committed async save IS a save: the long-standing
                    # counter must not read 0 just because commits moved to
                    # a background thread
                    self.counters["saves"] += 1
                    self.async_stats["commits"] += 1
                    self.async_stats["last_latency_s"] = dt
                    self.async_stats["total_latency_s"] += dt
                    self._observe_save_latency(dt)
                    log_dist(f"async checkpoint committed: {path} "
                             f"({dt:.2f}s stage→commit)")
                except BaseException as e:
                    error_box.append(e)
                    self.counters["async_commit_failures"] += 1
                    logger.exception(
                        f"async checkpoint commit FAILED for {path}; latest "
                        "still names the previous verified tag")

            # non-daemon: interpreter exit joins the committer, so the final
            # save of a run always gets its manifest + latest
            t = threading.Thread(target=_commit_bg, daemon=False,
                                 name=f"ckpt-async-commit-{tag}")
            t.start()
            self._pending_async = (t, error_box, tag)
            self.counters["async_saves"] += 1
            log_dist(f"checkpoint staged: {path} (commit in background)")
        else:
            _commit()
            self.counters["emergency_saves" if emergency else "saves"] += 1
            self._observe_save_latency(time.monotonic() - t0)
            log_dist(f"checkpoint committed: {path} (emergency={emergency})")
        return path

    @staticmethod
    def _observe_save_latency(seconds: float) -> None:
        """Stream save latency into the metrics registry
        (``resilience/ckpt_save_ms``) so checkpoint cost is scrapeable next
        to the ``train/*`` step breakdown."""
        from deepspeed_tpu_torch.observability import get_registry

        get_registry().histogram(
            "resilience/ckpt_save_ms",
            "checkpoint save wall clock, stage->commit").observe(
                seconds * 1e3)

    def drain(self, raise_on_error: bool = True) -> None:
        """Block until the in-flight async commit (if any) finishes.

        Fences every ordering point: the next save, emergency saves, loads,
        and engine shutdown. A commit error is re-raised by default (callers
        that must make progress anyway — the next save supersedes the failed
        one — pass ``raise_on_error=False``; the failure is already counted
        and logged)."""
        pending = self._pending_async
        if pending is None:
            return
        self._pending_async = None
        thread, error_box, tag = pending
        thread.join()
        if error_box and raise_on_error:
            raise error_box[0]

    # ------------------------------------------------------------------
    # load with fallback
    # ------------------------------------------------------------------
    def _tags_newest_first(self) -> List[str]:
        """Checkpoint tag dirs under save_dir, newest first (manifest step,
        then mtime), with the ``latest`` pointee promoted to the front.

        Only directories that LOOK like checkpoints (a manifest, an engine
        ``meta.json``, or a ``state`` tree) are considered — the
        checkpoint dir routinely hosts unrelated subdirectories (monitor
        logs, tensorboard) that GC must never touch."""
        from deepspeed_tpu_torch.runtime.checkpoint import read_latest_tag

        entries = []
        if os.path.isdir(self.save_dir):
            for name in os.listdir(self.save_dir):
                d = os.path.join(self.save_dir, name)
                if not os.path.isdir(d):
                    continue
                mpath = os.path.join(d, MANIFEST_FILE)
                if not os.path.exists(mpath) \
                        and not os.path.exists(os.path.join(d, "meta.json")) \
                        and not os.path.isdir(os.path.join(d, "state")):
                    continue
                step = -1
                if os.path.exists(mpath):
                    try:
                        with open(mpath) as f:
                            step = int(json.load(f).get("global_steps", -1))
                    except (OSError, ValueError):
                        pass
                entries.append((step, os.path.getmtime(d), name))
        entries.sort(reverse=True)
        tags = [name for _s, _m, name in entries]
        latest = read_latest_tag(self.save_dir)
        if latest in tags:
            tags.remove(latest)
            tags.insert(0, latest)
        return tags

    def load(self, engine, tag: Optional[str] = None,
             load_optimizer_states: bool = True):
        """Restore the newest VERIFIED checkpoint; fall back tag-by-tag.

        With an explicit ``tag`` only that tag is tried (verification still
        applies). Returns ``(path, client_state)`` like ``load_checkpoint``,
        or ``(None, {})`` when nothing loadable exists."""
        from deepspeed_tpu_torch.runtime import checkpoint as ckpt

        self.drain(raise_on_error=False)  # a staged tag may be the wanted one
        candidates = [tag] if tag is not None else self._tags_newest_first()
        if not candidates:
            logger.warning(f"no checkpoints under {self.save_dir}")
            return None, {}
        inj = get_injector()
        wanted = candidates[0]
        last_err: Optional[str] = None
        for cand in candidates:
            tag_dir = os.path.join(self.save_dir, cand)
            if os.path.exists(os.path.join(tag_dir, STAGING_FILE)):
                # staged-but-never-committed async save (crash between stage
                # and manifest): data may LOOK complete, but integrity was
                # never proven — reject it like a failed verification rather
                # than letting it pass as a legacy pre-manifest tag
                self.counters["staged_rejected"] += 1
                self.counters["verify_failures"] += 1
                logger.error(f"checkpoint {cand} is an uncommitted async "
                             "stage (crash between stage and commit); "
                             "stepping back")
                last_err = f"{cand}: uncommitted async stage"
                continue
            if self.verify:
                if not os.path.exists(os.path.join(tag_dir, MANIFEST_FILE)):
                    # legacy tag saved before resilience was enabled: there
                    # is nothing to checksum, but rejecting a perfectly good
                    # checkpoint would strand the run — load unverified
                    logger.warning(f"checkpoint {cand} predates manifest "
                                   "verification; loading unverified")
                else:
                    ok, why = verify_tag_dir(tag_dir)
                    if not ok:
                        self.counters["verify_failures"] += 1
                        logger.error(f"checkpoint {cand} failed verification "
                                     f"({why}); stepping back")
                        last_err = f"{cand}: {why}"
                        continue

            def _on_retry(_attempt, _exc):
                self.counters["io_retries"] += 1

            def _load(c=cand):
                inj.on_checkpoint_io("load")
                return ckpt.load_checkpoint(
                    engine, self.save_dir, tag=c,
                    load_optimizer_states=load_optimizer_states)
            try:
                path, client = retry_call(_load, policy=self.retry_policy,
                                          what=f"checkpoint load ({cand})",
                                          on_retry=_on_retry)
            except Exception as e:  # torn beyond what checksums cover
                self.counters["verify_failures"] += 1
                logger.error(f"checkpoint {cand} failed to restore ({e}); "
                             "stepping back")
                last_err = f"{cand}: {e}"
                continue
            if cand != wanted:
                self.counters["load_fallbacks"] += 1
                if _process_index() == 0:
                    ckpt.write_latest_atomic(self.save_dir, cand)
                logger.warning(f"recovered from fallback checkpoint {cand} "
                               f"(wanted {wanted})")
            return path, client
        raise RuntimeError(
            f"no verifiable checkpoint under {self.save_dir} "
            f"(tried {candidates}; last error: {last_err})")

    # ------------------------------------------------------------------
    # retention
    # ------------------------------------------------------------------
    def _gc(self) -> None:
        if self.keep_last_k <= 0:
            return
        from deepspeed_tpu_torch.runtime.checkpoint import read_latest_tag

        tags = self._tags_newest_first()
        latest = read_latest_tag(self.save_dir)
        for old in tags[self.keep_last_k:]:
            if old == latest:
                continue
            shutil.rmtree(os.path.join(self.save_dir, old),
                          ignore_errors=True)
            self.counters["gc_removed"] += 1
            log_dist(f"checkpoint GC: removed {old}")

    # ------------------------------------------------------------------
    # preemption
    # ------------------------------------------------------------------
    def install_preemption_handler(self) -> None:
        """Arm SIGTERM → emergency-save-at-next-boundary (idempotent).

        The handler only sets a flag: the actual save runs at a step boundary
        (``engine._commit_step``) where params/optimizer state are a complete,
        consistent tree — never mid-dispatch."""
        if self._preempt_handler_installed:
            return

        def _handler(signum, frame):
            self.preempted = True
            logger.warning("SIGTERM received: emergency checkpoint armed "
                           "for the next step boundary")
            if callable(self._prev_sigterm):
                self._prev_sigterm(signum, frame)

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, _handler)
            self._preempt_handler_installed = True
        except ValueError:
            # not the main thread (e.g. a test runner worker): preemption
            # saves can still be triggered via maybe_emergency_save
            logger.warning("cannot install SIGTERM handler outside the main "
                           "thread; emergency saves must be triggered "
                           "manually")

    def maybe_emergency_save(self, engine) -> Optional[str]:
        """Called at step boundaries: save once if a preemption is pending."""
        if not self.preempted:
            return None
        self.preempted = False
        tag = f"preempt_step{engine.global_steps}"
        path = self.save(engine, tag=tag, emergency=True)
        from deepspeed_tpu_torch.observability.trace import flight_dump

        # the black box rides the preemption artifact: what was in flight
        # when SIGTERM landed (keyed per tag — one dump per preemption)
        flight_dump("emergency_save", extra={"tag": tag, "path": path},
                    key=f"emergency-{tag}")
        logger.warning(f"emergency checkpoint saved to {path}")
        return path
