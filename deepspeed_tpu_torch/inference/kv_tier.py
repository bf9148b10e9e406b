"""Tiered storage for demoted prefix-cache KV blocks and paused requests:
host memory and NVMe (counterpart of ``deepspeed_tpu/inference/kv_tier.py``).

* **host tier**: a demoted block's KV pages live in an aligned buffer from
  a :class:`~deepspeed_tpu_torch.offload.swap.PinnedBufferPool` (page-locked
  when the engine serves on the card, so the promote's copy to the pool
  runs at the link's rate);
* **NVMe tier**: past the ``host_mb`` budget the oldest host entries spill
  to ``<nvme_path>/kv`` through the AIO ticket path
  (:class:`~deepspeed_tpu_torch.offload.swap.AsyncTensorSwapper`,
  ``namespace="kv"``); a promote submits a ticket read that overlaps the
  host's batch building and fences at the engine's next step.

The store does not know what a block is: entries are named byte payloads
with per-part (shape, dtype) metadata, keyed by an int the caller chooses.
One thread drives every store call; only the buffer pool and the swapper
underneath are safe for several clients. The manifest protocol
(:func:`write_manifest` ... :func:`sweep_manifests`) makes a paused
request's durable KV addressable by another engine (durable migration).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.observability.events import get_bus
from deepspeed_tpu_torch.offload.swap import (AsyncTensorSwapper,
                                              PinnedBufferPool)

logger = logging.getLogger(__name__)

__all__ = ["KVTierStore", "KVFetch", "TIER_HOST", "TIER_NVME",
           "ManifestError", "manifest_dir", "write_manifest",
           "load_manifest", "claim_manifest", "sweep_manifests"]

TIER_HOST = "host"
TIER_NVME = "nvme"

# ---------------------------------------------------------------------------
# Portable resume manifests (cross-replica migration).
#
# A manifest makes a paused request's demoted KV ADDRESSABLE by a replica
# that never produced it: the durable entry names on the shared NVMe
# namespace, per-part (shape, dtype, offset) metadata, the sequence's
# seen_tokens, and the full token history (the re-prefill fallback when the
# KV bytes are gone). Commit is atomic (tmp + fsync + rename — the same
# discipline as the warm-start cache's `adopt_meta` manifests) and the body
# carries a sha256 over the canonical payload so a torn write is REJECTED
# at load, never half-adopted. Adoption races are settled by
# `claim_manifest`'s atomic rename: exactly one sibling wins.
# ---------------------------------------------------------------------------

MANIFEST_VERSION = 1
_MANIFEST_SUBDIR = "manifests"


class ManifestError(RuntimeError):
    """A resume manifest is torn, corrupt, or from an unknown version."""


def manifest_dir(shared_path: str) -> str:
    """The manifest directory under a shared migration namespace."""
    return os.path.join(shared_path, _MANIFEST_SUBDIR)


def _canonical(payload: Dict) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode()


def write_manifest(shared_path: str, payload: Dict) -> str:
    """Atomically commit a resume manifest; returns its path.

    ``payload["uid"]`` names the manifest file (it must be unique across
    the fleet — callers use the router-scoped ruid plus an incarnation
    token). The write is tmp + fsync + rename so a reader either sees a
    complete manifest or none at all; the embedded sha256 catches the
    remaining torn-write window (a reader mid-``rename`` on a non-POSIX
    filesystem, or deliberate fault injection)."""
    d = manifest_dir(shared_path)
    os.makedirs(d, exist_ok=True)
    body = _canonical(payload)
    doc = json.dumps({"version": MANIFEST_VERSION,
                      "sha256": hashlib.sha256(body).hexdigest(),
                      "payload": payload}, sort_keys=True)
    path = os.path.join(d, f"{payload['uid']}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(doc)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    return path


def load_manifest(path: str) -> Dict:
    """Parse and verify one manifest; returns its payload.

    Raises :class:`ManifestError` for torn/corrupt/version-skewed files
    and ``FileNotFoundError`` for missing ones — callers treat both as
    "no durable KV" and fall down the re-prefill ladder."""
    with open(path, "r") as f:
        raw = f.read()
    try:
        doc = json.loads(raw)
    except ValueError as e:
        raise ManifestError(f"torn resume manifest {path}: {e}") from e
    if not isinstance(doc, dict) or doc.get("version") != MANIFEST_VERSION:
        raise ManifestError(f"resume manifest {path}: unknown version "
                            f"{doc.get('version') if isinstance(doc, dict) else doc!r}")
    payload = doc.get("payload")
    want = doc.get("sha256")
    if not isinstance(payload, dict) or \
            hashlib.sha256(_canonical(payload)).hexdigest() != want:
        raise ManifestError(f"resume manifest {path}: sha256 mismatch")
    return payload


def claim_manifest(path: str) -> Optional[str]:
    """Atomically claim a manifest for adoption; returns the claimed path
    or None if another sibling won the race (or the donor reclaimed it).
    The claim is one ``os.rename`` — POSIX guarantees exactly one winner
    when two siblings race the same manifest."""
    claimed = path + ".claimed"
    try:
        os.rename(path, claimed)
    except OSError:
        return None
    return claimed


def sweep_manifests(shared_path: str, ttl_s: float,
                    now: Optional[float] = None) -> int:
    """Reclaim abandoned manifests (and the durable tier files they
    address) older than ``ttl_s`` seconds; returns manifests removed.
    ``ttl_s <= 0`` disables the sweep. Stray ``.tmp`` files from a writer
    that died mid-commit are always removed past the TTL too. Torn
    manifests past the TTL are unlinked even though their entry list is
    unreadable — their orphaned tier files then age out with the
    namespace."""
    if ttl_s <= 0:
        return 0
    d = manifest_dir(shared_path)
    if not os.path.isdir(d):
        return 0
    now = time.time() if now is None else now
    removed = 0
    for fn in os.listdir(d):
        path = os.path.join(d, fn)
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue                      # raced another sweeper
        if age <= ttl_s:
            continue
        is_manifest = fn.endswith(".json") or fn.endswith(".json.claimed")
        if is_manifest:
            try:
                payload = load_manifest(path)
            except (ManifestError, OSError):
                payload = None              # torn: entry list unreadable
            if payload is not None:
                for ent in payload.get("entries", []):
                    fp = os.path.join(shared_path, "kv",
                                      str(ent["name"]).replace("/", "_")
                                      + ".swp")
                    try:
                        os.remove(fp)
                    except OSError:
                        pass
        try:
            os.remove(path)
        except OSError:
            continue                        # raced another sweeper
        if is_manifest:
            removed += 1
    return removed


class _Entry:
    """One demoted block: a concatenated byte payload plus part metadata."""

    __slots__ = ("key", "name", "nbytes", "parts", "buf", "wticket",
                 "loans", "dropped", "touch")

    def __init__(self, key: int, nbytes: int,
                 parts: List[Tuple[str, tuple, np.dtype, int, int]]):
        self.key = key
        self.name = f"blk{key}"
        self.nbytes = nbytes        # payload bytes (unpadded)
        self.parts = parts          # (name, shape, dtype, offset, nbytes)
        self.buf = None             # PinnedBuffer while in the host tier
        self.wticket = None         # in-flight NVMe write ticket
        self.loans = 0              # outstanding KVFetch views; pins the
        self.dropped = False        # entry against spill/discard
        self.touch = 0.0            # last put/hit stamp (the TTL clock)


class _BatchRead:
    """ONE combined NVMe ticket serving a whole promote chain's reads.

    Refcounted: ``begin_chain`` holds the base reference, every
    :class:`KVFetch` riding the batch holds one more; the ticket's pooled
    buffer returns when the last holder derefs. ``ticket is None`` =
    lazily submitted at the first ``view()`` (promote-depth backpressure,
    same contract as a lazy single fetch)."""

    __slots__ = ("store", "names", "entries", "segments", "ticket", "refs",
                 "failed", "claimed")

    def __init__(self, store: "KVTierStore", names: List[str],
                 entries: List[_Entry], ticket=None, segments=None):
        self.store = store
        self.names = names
        self.entries = entries      # pinned until end_chain
        self.segments = segments    # {entry name: (offset, nbytes)}
        self.ticket = ticket
        self.refs = 1               # begin_chain's base reference
        self.failed = False
        # names a KVFetch actually rides; a LAZY batch submits only these
        # at fence time — unridden chain members were unpinned at
        # end_chain and may have been cap/TTL-evicted since (their _meta
        # is gone; reading them would poison the whole batch), and their
        # payloads are not needed anyway (the promote chain truncated)
        self.claimed: List[str] = []

    def view(self) -> np.ndarray:
        """The flat uint8 payload view (submits the lazy batch first)."""
        if self.failed:
            raise IOError("batched promote read already failed")
        if self.ticket is None:
            self.ticket, self.segments = \
                self.store._submit_read_many(self.claimed or self.names)
        try:
            return self.ticket.wait()
        except Exception:
            # every fetch on this batch fails together — conservative,
            # one IO covered them all
            self.failed = True
            raise

    def deref(self) -> None:
        self.refs -= 1
        if self.refs > 0:
            return
        if self.ticket is not None:
            self.store._reads_inflight -= 1
            try:
                self.ticket.release()
            except Exception:
                pass                # failure already surfaced via view()
        # the batch owns its members' chain pins: unpin only once the
        # shared ticket is dead — an unridden member evicted earlier
        # would unlink a file the ticket's preads still target
        for e in self.entries:
            e.loans -= 1
            if e.loans == 0 and e.dropped:
                self.store.discard(e.key)


class KVFetch:
    """One block's payload coming back from a tier.

    ``wait()`` returns ``{part_name: ndarray view}``; the views stay valid
    until :meth:`release` (host: over the entry's pinned buffer; NVMe: over
    the read ticket's loaned pool buffer). ``submitted`` is False for a
    promote past ``promote_depth`` — the read is submitted lazily inside
    ``wait()`` at the engine's fence instead of up front."""

    __slots__ = ("store", "entry", "tier", "t_start", "_ticket", "_lazy",
                 "_batch", "_parts", "_released", "eid")

    def __init__(self, store: "KVTierStore", entry: _Entry, tier: str,
                 ticket=None, lazy: bool = False, batch=None):
        self.store = store
        self.entry = entry
        self.tier = tier
        self.t_start = time.perf_counter()
        self._ticket = ticket
        self._lazy = lazy
        self._batch = batch         # _BatchRead this fetch rides, if any
        self._parts: Optional[Dict[str, np.ndarray]] = None
        self._released = False
        # async event-track id: fetch_start -> release is the promote's
        # in-flight window on the trace timeline
        self.eid: Optional[int] = None
        bus = store._ebus
        if bus.enabled:
            self.eid = bus.new_id()
            bus.async_begin("kv_tier", "kv_fetch", self.eid,
                            args={"key": entry.key, "tier": tier,
                                  "bytes": entry.nbytes, "lazy": lazy})

    @property
    def submitted(self) -> bool:
        if self._batch is not None:
            return self._batch.ticket is not None
        return not self._lazy

    def _slice_parts(self, blob: np.ndarray) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for name, shape, dtype, off, nb in self.entry.parts:
            out[name] = blob[off:off + nb].view(dtype).reshape(shape)
        return out

    def wait(self) -> Dict[str, np.ndarray]:
        """Block until the payload is host-resident; returns part views."""
        if self._parts is not None:
            return self._parts
        if self.tier == TIER_HOST:
            blob = self.entry.buf.data[:self.entry.nbytes]
        elif self._batch is not None:
            view = self._batch.view()   # submits a lazy batch, may raise
            off, nb = self._batch.segments[self.entry.name]
            blob = view[off:off + nb]
        else:
            if self._lazy:
                self._ticket = self.store._submit_read(self.entry)
                self._lazy = False
            blob = self._ticket.wait()[:self.entry.nbytes]
        self._parts = self._slice_parts(blob)
        return self._parts

    def release(self) -> None:
        """Drop the views. Host entries keep their pinned buffer (the entry
        still owns it — :meth:`KVTierStore.discard` returns it); NVMe read
        tickets hand their loaned pool buffer back. Idempotent."""
        if self._released:
            return
        self._released = True
        self._parts = None
        bus = self.store._ebus
        if self.eid is not None and bus.enabled:
            bus.async_end("kv_tier", "kv_fetch", self.eid,
                          args={"tier": self.tier})
            self.eid = None
        if self.tier == TIER_NVME and self._batch is not None:
            self._batch.deref()     # shared ticket: last holder releases
            self._batch = None
        elif self.tier == TIER_NVME and self._ticket is not None:
            self.store._reads_inflight -= 1
            try:
                self._ticket.release()
            except Exception:
                # release() implies wait(), which raises for a failed
                # chunk on paths that never waited (cancel / teardown
                # loops over many fetches). The ticket already returned
                # its buffer before raising; letting the error escape
                # here would strand every later fetch in those loops.
                pass
        elif self.tier == TIER_NVME and self._lazy:
            self._lazy = False      # cancelled before submit: nothing loaned
        self.entry.loans -= 1
        if self.entry.loans == 0 and self.entry.dropped:
            # a discard arrived while this fetch pinned the entry — finish
            # it now that the last view is gone
            self.store.discard(self.entry.key)


class KVTierStore:
    """Demoted-KV block store: pinned host tier with LRU spill to NVMe.

    ``put`` copies a block's KV pages into a pooled pinned buffer and, when
    the host tier exceeds ``host_bytes``, spills the oldest entries to the
    NVMe swapper (or, with no NVMe tier, drops them through ``on_drop`` so
    the radix tree detaches the dead node). ``fetch_start`` begins a
    promote — immediate for host entries, an async AIO ticket read for
    NVMe — and ``discard`` ends an entry's life in the store (the block is
    HBM-resident again, or dead).

    ``instruments`` is an optional per-tier dict of registry instruments:
    ``{tier: {"hits": Counter, "misses": Counter, "demotions": Counter,
    "bytes": Gauge}}`` (none by default). ``pin`` page-locks the host
    tier's buffers (an engine serving on the card sets it).
    """

    def __init__(self, host_mb: float = 64.0, nvme_path: str = "",
                 promote_depth: int = 4, nvme_max_mb: float = 0.0,
                 nvme_ttl_s: float = 0.0,
                 pool: Optional[PinnedBufferPool] = None,
                 swapper: Optional[AsyncTensorSwapper] = None,
                 on_drop: Optional[Callable[[int], None]] = None,
                 instruments: Optional[Dict[str, Dict]] = None,
                 pin: bool = False):
        self.host_bytes = int(host_mb * (1 << 20))
        self.promote_depth = int(promote_depth)
        # NVMe bounds (0 = unbounded): without them disk usage is limited
        # only by discard-on-drop — distinct-prefix churn grows the tier
        # without limit. Enforced LRU+TTL inside _spill.
        self.nvme_max_bytes = int(nvme_max_mb * (1 << 20))
        self.nvme_ttl_s = float(nvme_ttl_s)
        self._now = time.monotonic   # injectable clock (TTL tests)
        self.pool = pool if pool is not None else PinnedBufferPool(pin=pin)
        self._own_swapper = swapper is None and bool(nvme_path)
        if swapper is not None:
            self.swapper = swapper
        elif nvme_path:
            # the KV namespace scopes this client's files away from any
            # optimizer swapper sharing the device; the pinned pool is
            # shared with the host tier (one pool, two clients)
            self.swapper = AsyncTensorSwapper(nvme_path, namespace="kv",
                                              pool=self.pool)
        else:
            self.swapper = None
        self.on_drop = on_drop
        self._inst = instruments or {}
        self._ebus = get_bus()   # causal event bus (mutated in place)
        self._host: "OrderedDict[int, _Entry]" = OrderedDict()
        # insertion/touch order = LRU order for the cap enforcement
        self._nvme: "OrderedDict[int, _Entry]" = OrderedDict()
        self._host_used = 0
        self._nvme_used = 0
        self._reads_inflight = 0
        self._chain: Optional[_BatchRead] = None  # armed by begin_chain
        self._chain_pins: List[_Entry] = []       # pinned until end_chain
        self._chain_active = False                # begin/end_chain nesting
        self.counters: Dict[str, int] = {
            "host_demotions": 0, "nvme_demotions": 0,
            "host_hits": 0, "nvme_hits": 0,
            "host_misses": 0, "nvme_misses": 0, "dropped": 0,
            "nvme_ttl_dropped": 0, "nvme_cap_dropped": 0,
            "batched_reads": 0,
            "durable_exports": 0, "durable_adopts": 0,
        }

    # ------------------------------------------------------------------
    def _count(self, tier: str, what: str, n: int = 1) -> None:
        self.counters[f"{tier}_{what}"] += n
        inst = self._inst.get(tier, {})
        if what in inst:
            inst[what].inc(float(n))

    def _set_bytes(self) -> None:
        for tier, used in ((TIER_HOST, self._host_used),
                           (TIER_NVME, self._nvme_used)):
            g = self._inst.get(tier, {}).get("bytes")
            if g is not None:
                g.set(float(used))

    def count_miss(self, tier: str, n: int = 1) -> None:
        """Record a tier miss discovered by the caller (a promote read
        that failed after fetch_start)."""
        self._count(tier, "misses", n)

    # ------------------------------------------------------------------
    def has(self, key: int) -> bool:
        return key in self._host or key in self._nvme

    def tier_of(self, key: int) -> Optional[str]:
        if key in self._host:
            return TIER_HOST
        if key in self._nvme:
            return TIER_NVME
        return None

    def put(self, key: int, parts: Dict[str, np.ndarray]) -> bool:
        """Demote one block's KV pages into the host tier. Returns False
        (caller falls back to plain eviction) only if the pinned copy
        itself fails; budget pressure spills other entries instead."""
        metas: List[Tuple[str, tuple, np.dtype, int, int]] = []
        off = 0
        for name in sorted(parts):
            a = parts[name]
            metas.append((name, tuple(a.shape), a.dtype, off, a.nbytes))
            off += a.nbytes
        buf = self.pool.get(off)
        try:
            for name, shape, dtype, o, nb in metas:
                buf.data[o:o + nb] = (np.ascontiguousarray(parts[name])
                                      .view(np.uint8).reshape(-1))
        except BaseException:
            # the pinned copy is the only fallible work between pool.get
            # and the entry taking ownership — return the buffer or it
            # leaks out of the pool for the rest of the run
            self.pool.put(buf)
            raise
        entry = _Entry(key, off, metas)
        entry.buf = buf
        entry.touch = self._now()
        self._host[key] = entry
        self._host_used += off
        self._count(TIER_HOST, "demotions")
        if self._ebus.enabled:
            self._ebus.instant("kv_tier", "demote",
                               args={"key": key, "bytes": off,
                                     "tier": TIER_HOST})
        self._spill(protect=key)
        self._set_bytes()
        return True

    def _spill(self, protect: Optional[int] = None) -> None:
        """Move oldest host entries to NVMe while over the host budget (or
        drop them, via ``on_drop``, when there is no NVMe tier). Entries a
        live :class:`KVFetch` has pinned (``loans > 0``) are skipped — the
        promote path holds views over their buffers. ``protect`` shields
        the entry ``put()`` is inserting RIGHT NOW: dropping it would fire
        ``on_drop`` before the radix cache has recorded the handle, so the
        node would keep a dead handle nothing can ever clean up."""
        while self._host_used > self.host_bytes and len(self._host) > 1:
            key = e = None
            for k, cand in self._host.items():
                if cand.loans == 0 and k != protect:
                    key, e = k, cand
                    break
            if e is None:
                break               # everything old is pinned by promotes
            del self._host[key]
            self._host_used -= e.nbytes
            if self.swapper is None:
                self._drop_entry(e, TIER_HOST)
                continue
            try:
                blob = e.buf.data[:e.nbytes]
                # swap_out copies into its OWN pooled buffer at submit
                # time, so the host entry's buffer can recycle immediately
                e.wticket = self.swapper.swap_out(e.name, blob)
            except Exception as ex:
                logger.warning(f"kv tier: NVMe demotion of {e.name} failed "
                               f"({ex}); dropping the entry")
                self._drop_entry(e, TIER_HOST)
                continue
            self.pool.put(e.buf)
            e.buf = None
            self._nvme[key] = e
            self._nvme_used += e.nbytes
            self._count(TIER_NVME, "demotions")
            if self._ebus.enabled:
                self._ebus.instant("kv_tier", "spill",
                                   args={"key": key, "bytes": e.nbytes,
                                         "tier": TIER_NVME})
        self._enforce_nvme_bounds()

    def _evict_nvme(self, e: _Entry, reason: str) -> None:
        """Drop one NVMe entry for TTL/cap enforcement: the backing file
        is removed and the radix tree learns via ``on_drop`` (through
        ``_drop_entry``, which also counts the per-tier miss)."""
        self._nvme.pop(e.key, None)
        self._nvme_used -= e.nbytes
        if e.wticket is not None:
            try:
                e.wticket.wait()
            except Exception:
                pass
            e.wticket = None
        self.swapper.discard(e.name)
        self.counters[f"nvme_{reason}_dropped"] += 1
        self._drop_entry(e, TIER_NVME)

    def _enforce_nvme_bounds(self) -> None:
        """LRU + TTL bounds on the NVMe tier (``tiers.nvme_max_mb`` /
        ``tiers.nvme_ttl_s``). Entries idle past the TTL go first, then
        the oldest-touched entries until the tier fits the cap. Entries a
        live fetch (or an armed promote chain) pins are skipped."""
        if self.nvme_ttl_s > 0:
            now = self._now()
            for k in list(self._nvme):
                # .get, not [k]: evicting one entry fires on_drop ->
                # _drop_subtree, which may discard OTHER NVMe entries
                # (demoted descendants) out from under this snapshot
                e = self._nvme.get(k)
                if e is not None and e.loans == 0 \
                        and now - e.touch > self.nvme_ttl_s:
                    self._evict_nvme(e, "ttl")
        if self.nvme_max_bytes > 0:
            for k in list(self._nvme):   # OrderedDict: oldest touch first
                if self._nvme_used <= self.nvme_max_bytes:
                    break
                e = self._nvme.get(k)    # reentrant discard: see above
                if e is not None and e.loans == 0:
                    self._evict_nvme(e, "cap")

    def _drop_entry(self, e: _Entry, tier: str) -> None:
        self.counters["dropped"] += 1
        self._count(tier, "misses")
        if self._ebus.enabled:
            self._ebus.instant("kv_tier", "drop",
                               args={"key": e.key, "tier": tier})
        if e.buf is not None:
            self.pool.put(e.buf)
            e.buf = None
        if self.on_drop is not None:
            self.on_drop(e.key)

    # ------------------------------------------------------------------
    def _submit_read(self, e: _Entry):
        if e.wticket is not None:
            # the demotion write may still be in flight: reading the file
            # before it lands would return a torn payload
            e.wticket.wait()
            e.wticket = None
        self._reads_inflight += 1
        try:
            return self.swapper.swap_in_start(e.name)
        except BaseException:
            self._reads_inflight -= 1
            raise

    def _submit_read_many(self, names: List[str]):
        """Submit one batched ticket for a chain's entries (counts as ONE
        in-flight read — it is one ticket)."""
        self._reads_inflight += 1
        try:
            return self.swapper.swap_in_start_many(names)
        except BaseException:
            self._reads_inflight -= 1
            raise

    # ------------------------------------------------------------------
    def begin_chain(self, keys: Sequence[int]) -> bool:
        """Prepare the store for the promote chain ``PrefixCache.acquire``
        is about to walk. EVERY present chain entry — host or NVMe — is
        pinned (``loans``) until :meth:`end_chain`, so the demotions the
        same acquire triggers (make-room eviction → host spill → NVMe
        cap/TTL sweep) can neither spill a host member out from under its
        upcoming fetch nor drop an NVMe member whose read is wanted. When
        >= 2 members sit on NVMe, their reads additionally arm ONE
        batched AIO ticket the following ``fetch_start`` calls ride
        instead of submitting one read each. Pair with :meth:`end_chain`
        (try/finally). Returns True when anything was pinned."""
        if self._chain_active or keys is None:
            return False
        found = [self._host.get(k) or self._nvme.get(k) for k in keys]
        found = [e for e in found if e is not None]
        if not found:
            return False
        nvme = []
        for e in [e for e in found if e.key in self._nvme]:
            if e.wticket is not None:   # flush in-flight demote writes
                try:
                    e.wticket.wait()
                except Exception as ex:
                    # the demote write never landed: the file is torn.
                    # Degrade to a per-block miss (the radix tree drops
                    # the node and recomputes) exactly like fetch_start's
                    # failed-submit path — raising here would crash the
                    # whole serving acquire.
                    logger.warning(f"kv tier: demote write of {e.name} "
                                   f"failed ({ex}); dropping the entry")
                    e.wticket = None
                    self._count(TIER_NVME, "misses")
                    self.discard(e.key)
                    continue
                e.wticket = None
            nvme.append(e)
        pins = [e for e in found
                if e.key in self._host or e.key in self._nvme]
        if not pins:
            return False
        batched = None
        if len(nvme) >= 2 and self.swapper is not None:
            names = [e.name for e in nvme]
            if self._reads_inflight >= self.promote_depth:
                # lazy: submit at the first wait (the engine's fence)
                batched = _BatchRead(self, names, nvme)
            else:
                try:
                    ticket, segments = self._submit_read_many(names)
                    batched = _BatchRead(self, names, nvme, ticket,
                                         segments)
                except Exception as ex:
                    logger.warning("kv tier: batched promote read failed "
                                   f"to submit ({ex}); falling back to "
                                   "per-block reads")
        # batch members stay pinned by the BATCH until its ticket dies
        # (last rider release): their reads are already in flight, so an
        # unridden member evicted after end_chain would unlink a file a
        # pread is still targeting. Non-batch members unpin at end_chain.
        if batched is not None:
            self._chain = batched
            self.counters["batched_reads"] += 1
            for e in batched.entries:
                e.loans += 1
            pins = [e for e in pins if e not in batched.entries]
        for e in pins:
            e.loans += 1
        self._chain_pins = pins
        self._chain_active = True
        return True

    def end_chain(self) -> None:
        """Release ``begin_chain``'s entry pins and the batch's base
        reference; batch members stay pinned by the batch itself until
        its shared ticket releases (last riding fetch)."""
        pins, self._chain_pins = self._chain_pins, []
        chain, self._chain = self._chain, None
        self._chain_active = False
        for e in pins:
            e.loans -= 1
            if e.loans == 0 and e.dropped:
                self.discard(e.key)
        if chain is not None:
            chain.deref()

    def fetch_start(self, key: int) -> Optional[KVFetch]:
        """Begin promoting ``key``'s payload back toward HBM. Host entries
        resolve immediately; NVMe entries submit an async ticket read now
        (or lazily at ``wait()`` once ``promote_depth`` reads are already
        in flight). None = the entry is gone (tier miss — recompute)."""
        e = self._host.get(key)
        if e is not None:
            self._host.move_to_end(key)          # promote = hottest
            e.touch = self._now()
            self._count(TIER_HOST, "hits")
            e.loans += 1
            return KVFetch(self, e, TIER_HOST)
        e = self._nvme.get(key)
        if e is None:
            return None
        self._nvme.move_to_end(key)              # LRU for the cap sweep
        e.touch = self._now()
        self._count(TIER_NVME, "hits")
        chain = self._chain
        if chain is not None and e in chain.entries:
            # ride the chain's ONE batched ticket instead of submitting
            # a read per block
            e.loans += 1
            chain.refs += 1
            chain.claimed.append(e.name)
            return KVFetch(self, e, TIER_NVME, batch=chain)
        if self._reads_inflight >= self.promote_depth:
            e.loans += 1
            return KVFetch(self, e, TIER_NVME, lazy=True)
        try:
            ticket = self._submit_read(e)
        except Exception as ex:
            logger.warning(f"kv tier: NVMe promote read of {e.name} failed "
                           f"to submit ({ex})")
            self.discard(key)
            self._count(TIER_NVME, "misses")
            return None
        e.loans += 1
        return KVFetch(self, e, TIER_NVME, ticket=ticket)

    def discard(self, key: int) -> None:
        """Remove ``key`` from the store (promoted back to HBM, or dead).
        Idempotent; host buffers return to the pool, NVMe files are
        removed best-effort. An entry a live fetch still pins is marked and
        discarded when its last view releases."""
        e = self._host.get(key) or self._nvme.get(key)
        if e is None:
            return
        if e.loans > 0:
            e.dropped = True
            return
        if self._host.pop(key, None) is not None:
            self._host_used -= e.nbytes
            if e.buf is not None:
                self.pool.put(e.buf)
                e.buf = None
            self._set_bytes()
            return
        self._nvme.pop(key, None)
        self._nvme_used -= e.nbytes
        if e.wticket is not None:
            try:
                e.wticket.wait()
            except Exception:
                pass
            e.wticket = None
        self.swapper.discard(e.name)
        self._set_bytes()

    # ---- durable (incarnation-independent) addressing ----------------
    def attach_nvme(self, nvme_path: str) -> None:
        """Late-attach an NVMe tier (the shared migration namespace) to a
        store created host-only: the pause path's private store can exist
        before the serving layer learns ``serving.migration``'s path.
        No-op when a swapper is already attached or the path is empty."""
        if self.swapper is not None or not nvme_path:
            return
        self.swapper = AsyncTensorSwapper(nvme_path, namespace="kv",
                                          pool=self.pool)
        self._own_swapper = True

    def export_durable(self, keys: Sequence[int], tag: str) -> List[Dict]:
        """Write a DURABLE copy of each key's payload onto the NVMe
        namespace under incarnation-independent names (``mig-<tag>-<i>``)
        and return the entry descriptors a resume manifest embeds. The
        local entries are untouched (the donor keeps its fast resume
        path); every write ticket is WAITED before returning, so the
        bytes are on disk before the caller commits the manifest —
        a crash in between leaves orphaned files the TTL sweep reclaims,
        never a manifest pointing at air. ``tag`` must be unique across
        the fleet (router ruid + incarnation token). Raises on the first
        failed copy after best-effort cleanup of the partial export."""
        if self.swapper is None:
            raise RuntimeError("durable export requires an NVMe tier "
                               "(shared_nvme_path)")
        out: List[Dict] = []
        tickets = []
        try:
            for i, key in enumerate(keys):
                e = self._host.get(key) or self._nvme.get(key)
                if e is None:
                    raise KeyError(f"kv tier: no entry for key {key}")
                dname = f"mig-{tag}-{i}"
                if key in self._host:
                    blob = e.buf.data[:e.nbytes]
                else:
                    if e.wticket is not None:   # demote still in flight
                        e.wticket.wait()
                        e.wticket = None
                    blob = self.swapper.swap_in(e.name)[:e.nbytes]
                tickets.append(self.swapper.swap_out(dname, blob))
                out.append({
                    "name": dname,
                    "nbytes": int(e.nbytes),
                    "parts": [[n, list(shape), np.dtype(dt).str, int(off),
                               int(nb)] for n, shape, dt, off, nb in e.parts],
                })
            for t in tickets:
                t.wait()                        # durability before manifest
        except BaseException:
            for t in tickets:
                try:
                    t.wait()
                except Exception:
                    pass
            self.drop_durable(out)
            raise
        self.counters["durable_exports"] += len(out)
        if self._ebus.enabled:
            self._ebus.instant("kv_tier", "durable_export",
                               args={"tag": tag, "entries": len(out)})
        return out

    def adopt_durable(self, entries: Sequence[Dict],
                      keys: Sequence[int]) -> None:
        """Register durable entries ANOTHER replica's store exported as
        NVMe-tier entries of this store, under fresh local ``keys``.
        ``adopt_meta`` validates each backing file exists and is long
        enough — a torn or swept file surfaces HERE (FileNotFoundError),
        before any promote is attempted, and the partial adopt is fully
        unwound (adopted siblings discarded, which removes their shared
        files: ownership transferred at the manifest claim). After
        adoption the entries behave exactly like locally-demoted NVMe
        entries: promote via ``fetch_start``, reclaim via ``discard``."""
        if self.swapper is None:
            raise RuntimeError("durable adopt requires an NVMe tier "
                               "(shared_nvme_path)")
        if len(entries) != len(keys):
            raise ValueError("adopt_durable: len(entries) != len(keys)")
        done: List[int] = []
        try:
            for d, key in zip(entries, keys):
                if self.has(key):
                    raise KeyError(f"kv tier: key {key} already present")
                self.swapper.adopt_meta(d["name"], (int(d["nbytes"]),),
                                        np.uint8)
                parts = [(str(n), tuple(int(s) for s in shape),
                          np.dtype(dt), int(off), int(nb))
                         for n, shape, dt, off, nb in d["parts"]]
                e = _Entry(int(key), int(d["nbytes"]), parts)
                e.name = str(d["name"])   # the durable name IS the address
                e.touch = self._now()
                self._nvme[int(key)] = e
                self._nvme_used += e.nbytes
                done.append(int(key))
        except BaseException:
            for key in done:
                self.discard(key)
            raise
        self.counters["durable_adopts"] += len(done)
        self._set_bytes()
        if self._ebus.enabled:
            self._ebus.instant("kv_tier", "durable_adopt",
                               args={"entries": len(done)})

    def drop_durable(self, entries: Sequence[Dict]) -> None:
        """Best-effort removal of durable files this store exported (the
        donor resumed locally, or an export failed partway): the files
        are unlinked without ever having been store entries here."""
        if self.swapper is None:
            return
        for d in entries:
            try:
                self.swapper.discard(str(d["name"]))
            except Exception:
                pass

    # ------------------------------------------------------------------
    def clear(self) -> int:
        """Drop every entry (pool buffers returned, files removed).
        Returns entries cleared. On-drop is NOT fired — clear() is the
        tree telling the store to forget, not the store losing data."""
        n = len(self._host) + len(self._nvme)
        for key in list(self._host):
            self.discard(key)
        for key in list(self._nvme):
            self.discard(key)
        return n

    def entries(self) -> int:
        return len(self._host) + len(self._nvme)

    def report(self) -> Dict:
        return {
            "host_entries": len(self._host),
            "host_bytes": self._host_used,
            "host_budget_bytes": self.host_bytes,
            "nvme_entries": len(self._nvme),
            "nvme_bytes": self._nvme_used,
            "nvme_budget_bytes": self.nvme_max_bytes,
            "nvme_ttl_s": self.nvme_ttl_s,
            "nvme": self.swapper is not None,
            "reads_inflight": self._reads_inflight,
            "pool": self.pool.report(),
            **self.counters,
        }

    def close(self) -> None:
        """Idempotent teardown: drop every entry and close the private
        swapper (a shared swapper passed in by the caller is left open)."""
        self.clear()
        if self.swapper is not None:
            if self._own_swapper:
                self.swapper.close()
            self.swapper = None
