"""Ragged/continuous-batching state (counterpart of
``deepspeed_tpu/inference/ragged.py``; host-side Python, no tensors).

``BlockedAllocator`` is the refcounted free list of KV pool blocks (its block
ids ARE the physical pool indices), ``SequenceManager`` tracks live
sequences, their slots and blocks, and answers schedulability queries.
A :class:`PrefixCache` (radix tree over full-block token chunks) lets an
engine share resident KV blocks across requests that repeat a prompt
prefix: shared blocks are never written through (writes land past the
block-aligned shared prefix) and never freed while an owner remains; blocks
held only by the cache are evictable LRU-first, or demoted to a
:class:`~deepspeed_tpu_torch.inference.kv_tier.KVTierStore` when one is
attached.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class CapacityError(RuntimeError):
    """Engine overload: the requested tokens do not fit the KV pool / slot
    budget right now. Carries the demand (``uids``, ``token_demand``) so a
    serving layer can tell overload (shed + retry later) from a bug."""

    def __init__(self, uids: Sequence[int], token_demand: Sequence[int],
                 detail: str = ""):
        self.uids = list(uids)
        self.token_demand = [int(n) for n in token_demand]
        msg = (f"cannot schedule uids={self.uids} "
               f"(+{self.token_demand} tokens: per-sequence limit or "
               "aggregate KV demand exceeded)")
        if detail:
            msg = f"{msg}: {detail}"
        super().__init__(msg)


class BlockedAllocator:
    """Fixed-size block free list, refcounted: ``allocate`` hands out blocks
    at refcount 1, ``incref`` adds an owner, ``free`` drops one reference and
    returns a block to the free list at 0. Freeing a free block raises (a
    silent double free would give one physical block to two sequences)."""

    def __init__(self, num_blocks: int, block_size: int = 128):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks))
        self._refs: List[int] = [0] * num_blocks
        # refcount-transition hook (block, old_rc, new_rc) for a prefix cache
        self._observer: Optional[Callable[[int, int, int], None]] = None

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(f"out of KV blocks: want {n}, have {len(self._free)}")
        out, self._free = self._free[:n], self._free[n:]
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if self._refs[b] <= 0:
                raise RuntimeError(f"incref of unallocated block {b}")
            self._refs[b] += 1
            if self._observer is not None:
                self._observer(b, self._refs[b] - 1, self._refs[b])

    def refcount(self, block: int) -> int:
        return self._refs[block]

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if self._refs[b] <= 0:
                raise RuntimeError(
                    f"double free of KV block {b} (refcount already 0)")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)
            if self._observer is not None:
                self._observer(b, self._refs[b] + 1, self._refs[b])

    def leaked_blocks(self) -> List[int]:
        """Blocks still referenced: empty iff the pool is fully restored."""
        return [b for b, r in enumerate(self._refs) if r > 0]


class _PrefixNode:
    __slots__ = ("key", "block", "children", "parent", "stamp", "handle")

    def __init__(self, key: bytes, block: int, parent: "_PrefixNode"):
        self.key = key
        self.block = block       # physical pool block while HBM-resident
        self.children: Dict[bytes, _PrefixNode] = {}
        self.parent = parent
        self.stamp = 0
        # tier state: handle None + block >= 0 -> HBM-resident;
        # handle set -> demoted (KV pages live in the tier store under the
        # handle key; block is -1); handle None + block < 0 -> dead
        # (detached, or its tier entry was lost)
        self.handle: Optional[int] = None

    @property
    def resident(self) -> bool:
        return self.handle is None and self.block >= 0


class PromoteRecord:
    """One block being promoted from a lower tier back into the pool: the
    engine uploads ``fetch``'s payload into physical block ``block`` at its
    next device-dispatch fence (before any attention read can land on
    it). ``epoch`` is the cache epoch at promotion time — a ``clear()``
    between attach and the fence bumps it, telling the fence this record's
    block may already belong to someone else (release, don't scatter)."""

    __slots__ = ("node", "key", "block", "fetch", "tier", "epoch")

    def __init__(self, node: _PrefixNode, key: int, block: int, fetch,
                 tier: str, epoch: int):
        self.node = node
        self.key = key          # tier-store handle (discard after upload)
        self.block = block
        self.fetch = fetch
        self.tier = tier
        self.epoch = epoch


class PrefixCache:
    """Radix tree over FULL-BLOCK token chunks → resident KV block ids
    (SGLang RadixAttention over the paged pool).

    Each node maps one ``block_size``-token chunk (keyed by the chunk's
    int32 bytes, so a node's path from the root IS the token prefix) to the
    physical block that holds its KV. The cache holds one reference on every
    published block; sequences that :meth:`acquire` a prefix hold their own.
    A block whose only reference is the cache's is *evictable* — eviction is
    LRU leaf-first (evicting an interior node would orphan its children:
    their prefix could then match without its parent being resident).

    Partial tail blocks are never cached: matching stops at the last full
    block, so the first position a consumer writes is block-aligned and lands
    in a private block — sharing needs no device-side copy-on-write, the
    uncached tail is simply recomputed (copy-on-write by recompute)."""

    def __init__(self, allocator: BlockedAllocator,
                 max_blocks: Optional[int] = None,
                 instruments: Optional[Dict[str, object]] = None):
        self.allocator = allocator
        self.block_size = allocator.block_size
        self.max_blocks = max_blocks
        self._root: Dict[bytes, _PrefixNode] = {}
        self._nodes = 0
        self._clock = 0
        # O(1) evictability accounting: _tracked is the set of tree-held
        # blocks, _evictable counts those at refcount 1 (cache is the sole
        # owner). Kept exact through the allocator's refcount-transition
        # observer — a sequence flushing its shared prefix (2 -> 1) or a
        # new sharer attaching (1 -> 2) flips evictability without the
        # cache being on the call path.
        self._tracked: set = set()
        self._evictable = 0
        allocator._observer = self._on_ref_transition
        # ---- tier spill (attach_tier_store) --------------------------
        # With a KVTierStore attached, evict() DEMOTES an rc==1 block's KV
        # pages to pinned host DRAM (and, under host pressure, NVMe)
        # instead of discarding them; the node stays in the radix tree so
        # a later match promotes the pages back. extract_fn(blocks) ->
        # [payload dict] is the engine's device->host page fetch.
        self.tier_store = None
        self.extract_fn: Optional[Callable] = None
        self._by_handle: Dict[int, _PrefixNode] = {}
        self._demoted = 0
        self._next_handle = 0
        # promotions acquire() started this call chain; the engine drains
        # these into its upload queue and fences them before any device
        # step reads the promoted blocks
        self.pending_promotes: List[PromoteRecord] = []
        # nodes whose pool block is allocated but whose payload has NOT
        # been uploaded yet (fence pending). Until mark_uploaded(), such a
        # block must never be demoted (it would extract garbage) or freed
        # (the deferred scatter would overwrite whoever got the block next)
        # — even if the acquirer's refs are gone, e.g. a shed between
        # attach and the fence leaves the cache as sole owner at rc==1.
        self._pending_upload: set = set()
        # bumped by clear(): outstanding PromoteRecords the engine already
        # drained carry the old epoch, and the fence must not scatter them
        # (their blocks may have been freed and reallocated since)
        self.epoch = 0
        # plain counters (always on) + optional registry instruments
        self.counters: Dict[str, int] = {
            "hits": 0, "misses": 0, "hit_tokens": 0,
            "inserted_blocks": 0, "evicted_blocks": 0,
            "demoted_blocks": 0, "promoted_blocks": 0,
            "readopted_blocks": 0, "tier_lost_blocks": 0,
        }
        self._inst = instruments or {}

    def attach_tier_store(self, store, extract_fn: Callable) -> None:
        """Enable demote-instead-of-evict: ``store`` is a
        :class:`~deepspeed_tpu_torch.inference.kv_tier.KVTierStore`,
        ``extract_fn(blocks)`` returns one ``{part: ndarray}`` payload per
        listed pool block (the engine's batched device->host fetch)."""
        self.tier_store = store
        self.extract_fn = extract_fn
        store.on_drop = self._on_tier_drop

    # ------------------------------------------------------------------
    def _key(self, chunk: np.ndarray) -> bytes:
        return np.ascontiguousarray(chunk, np.int32).tobytes()

    def _walk(self, tokens: np.ndarray, max_tokens: Optional[int]
              ) -> List[_PrefixNode]:
        toks = np.atleast_1d(np.asarray(tokens, np.int32))
        limit = len(toks) if max_tokens is None else min(len(toks),
                                                         int(max_tokens))
        n_chunks = limit // self.block_size
        path: List[_PrefixNode] = []
        children = self._root
        for i in range(n_chunks):
            key = self._key(toks[i * self.block_size:(i + 1) * self.block_size])
            node = children.get(key)
            if node is None:
                break
            path.append(node)
            children = node.children
        return path

    # ------------------------------------------------------------------
    def peek(self, tokens, max_tokens: Optional[int] = None
             ) -> Tuple[List[int], int]:
        """Longest cached full-block prefix of ``tokens`` WITHOUT taking
        references (admission math). Returns (block ids, matched tokens);
        demoted-but-promotable blocks count as matched and appear as -1 in
        the id list (they have no pool block until promoted)."""
        path = self._walk(tokens, max_tokens)
        return [n.block for n in path], len(path) * self.block_size

    def peek_tiers(self, tokens, max_tokens: Optional[int] = None
                   ) -> Dict[str, int]:
        """Admission-math view of a prospective match: ``resident_tokens``
        are free capacity (blocks already in the pool, shared on attach);
        ``demoted_blocks`` are warm-but-not-resident — a promote allocates
        a pool block per entry but skips the prefill compute. Residents
        always form the leading chain: eviction demotes leaf-first, so
        demoted nodes are a suffix of any root path."""
        path = self._walk(tokens, max_tokens)
        k = 0
        while k < len(path) and path[k].resident:
            k += 1
        return {"matched_tokens": len(path) * self.block_size,
                "resident_tokens": k * self.block_size,
                "demoted_blocks": len(path) - k}

    def acquire(self, tokens, max_tokens: Optional[int] = None
                ) -> Tuple[List[int], int]:
        """Longest cached full-block prefix, with one reference taken per
        matched block (the caller now co-owns them; release via
        ``allocator.free`` exactly like privately allocated blocks).

        With a tier store attached, a match landing on demoted nodes
        promotes them: each gets a fresh pool block (evicting/demoting
        colder blocks if the free list is short) and an async payload
        fetch, recorded on :attr:`pending_promotes` for the engine to
        upload and fence before any attention read. The chain truncates at
        the first node that can neither be used nor promoted."""
        path = self._walk(tokens, max_tokens)
        demoted = [n for n in path
                   if not n.resident and n.handle is not None]
        usable: List[_PrefixNode] = []
        promotes: List[PromoteRecord] = []
        store = self.tier_store
        # one AIO ticket for the whole chain's NVMe reads (instead of one
        # per block): fetch_start inside _promote rides the armed batch.
        # Armed — and EVERY chain entry pinned, host tier too — before
        # the deficit eviction below: its demotions trigger host spill
        # and the NVMe cap/TTL sweep, which must neither move nor drop
        # the very entries this acquire is about to read.
        chained = (store is not None and demoted
                   and store.begin_chain([n.handle for n in demoted]))
        try:
            deficit = len(demoted) - self.allocator.free_blocks
            if deficit > 0:
                # make room for the whole promote chain in ONE pass — the
                # per-block evict(1) fallback inside _promote rebuilds the
                # full-tree candidate list every call, O(path x tree) on
                # the admission hot path under exactly the churn tiers
                # target
                self.evict(deficit, exclude=path)
            for n in path:
                if n.resident:
                    usable.append(n)
                    continue
                if n.handle is None:
                    break           # dead node (stale path reference)
                rec = self._promote(n, path)
                if rec is None:
                    break
                promotes.append(rec)
                usable.append(n)
        finally:
            if chained:
                store.end_chain()
        blocks = [n.block for n in usable]
        if blocks:
            self.allocator.incref(blocks)
            # promoted blocks join _tracked only AFTER the incref: the
            # observer ignores transitions of untracked blocks, so their
            # 1 -> 2 hop must not decrement an evictability they never
            # contributed to (same ordering as insert())
            for rec in promotes:
                self._tracked.add(rec.block)
            self._clock += 1
            for n in usable:
                n.stamp = self._clock
            self.counters["hits"] += 1
            self.counters["hit_tokens"] += len(blocks) * self.block_size
            if "hits" in self._inst:
                self._inst["hits"].inc()
                self._inst["hit_tokens"].inc(
                    float(len(blocks) * self.block_size))
            if "tier_hits_hbm" in self._inst and len(usable) > len(promotes):
                self._inst["tier_hits_hbm"].inc(
                    float(len(usable) - len(promotes)))
            self.pending_promotes.extend(promotes)
        else:
            self.counters["misses"] += 1
            if "misses" in self._inst:
                self._inst["misses"].inc()
        return blocks, len(blocks) * self.block_size

    def drain_promotes(self) -> List[PromoteRecord]:
        """Hand the promotions started since the last drain to the caller
        (the engine's upload queue)."""
        recs, self.pending_promotes = self.pending_promotes, []
        return recs

    def _promote(self, node: _PrefixNode,
                 path: Sequence[_PrefixNode]) -> Optional[PromoteRecord]:
        """Bring one demoted node back toward HBM: allocate a pool block
        (demoting/evicting colder cache blocks for room — never one on
        ``path``) and start the tier fetch. Returns None when the node
        cannot be promoted (no room, or its tier entry is gone — the
        subtree is dropped: it can never serve again)."""
        store = self.tier_store
        if store is None or not store.has(node.handle):
            self.counters["tier_lost_blocks"] += 1
            self._drop_subtree(node)
            return None
        if self.allocator.free_blocks == 0:
            self.evict(1, exclude=path)
            if self.allocator.free_blocks == 0:
                return None         # pool exhausted: keep what matched
        hid = node.handle
        block = self.allocator.allocate(1)[0]
        try:
            fetch = store.fetch_start(hid)
        except BaseException:
            self.allocator.free([block])
            raise
        if fetch is None:           # entry lost between has() and fetch
            self.allocator.free([block])
            self.counters["tier_lost_blocks"] += 1
            self._drop_subtree(node)
            return None
        self._by_handle.pop(hid, None)
        node.block = block
        node.handle = None
        self._nodes += 1
        self._demoted -= 1
        self._pending_upload.add(node)
        self.counters["promoted_blocks"] += 1
        return PromoteRecord(node, hid, block, fetch, fetch.tier,
                             self.epoch)

    def mark_uploaded(self, recs: Sequence[PromoteRecord]) -> None:
        """The engine's fence uploaded these promotions' payloads: their
        blocks are real KV now and rejoin the demotable/evictable world."""
        for rec in recs:
            self._pending_upload.discard(rec.node)

    def drop_failed_promote(self, node: _PrefixNode) -> None:
        """A promote's payload never reached the node's block (tier read
        failed; the engine zero-filled it): the node must leave the tree
        so only the in-flight acquirer computes on zeros — left published,
        every future match would silently serve zeroed KV, and the next
        demotion would persist the zeros into the tier. No-op on a node an
        earlier drop in the same fence batch already detached."""
        if node.resident:
            self.counters["tier_lost_blocks"] += 1
            self._drop_subtree(node)

    def cancel_promotes(self, recs: Sequence[PromoteRecord]) -> None:
        """Undo promotions whose acquirer failed before the upload fence:
        the pool block holds garbage (payload never uploaded), so the node
        re-demotes onto its still-live tier entry and the block returns to
        the free list. The caller must already have dropped the acquirer's
        references (the cache's allocate reference is released here)."""
        for rec in recs:
            rec.fetch.release()
            node = rec.node
            self._pending_upload.discard(node)
            node.handle = rec.key
            node.block = -1
            self._by_handle[rec.key] = node
            self._nodes -= 1
            self._demoted += 1
            self.counters["promoted_blocks"] -= 1
            self._tracked.discard(rec.block)
            if self.allocator.refcount(rec.block) == 1:
                self._evictable -= 1
            self.allocator.free([rec.block])

    def insert(self, tokens, blocks: Sequence[int]) -> int:
        """Publish the KV blocks holding ``tokens`` (full blocks only; both
        truncated to full-block granularity). Idempotent: chunks already in
        the tree just get their LRU stamp refreshed — an equal-content block
        from a second sequence is NOT swapped in (the resident one keeps
        serving). Returns the number of newly published blocks (each takes
        one cache-owned reference)."""
        toks = np.atleast_1d(np.asarray(tokens, np.int32))
        n_chunks = min(len(toks) // self.block_size, len(blocks))
        children = self._root
        parent: Optional[_PrefixNode] = None
        path: List[_PrefixNode] = []
        added = 0
        self._clock += 1
        for i in range(n_chunks):
            key = self._key(toks[i * self.block_size:(i + 1) * self.block_size])
            node = children.get(key)
            if node is None:
                # at the cap, make room — but never by evicting a node on
                # the path we are descending (the new node would attach to
                # a detached parent: an unreachable subtree whose cache
                # references could never be released again)
                if self.max_blocks is not None \
                        and self._nodes >= self.max_blocks \
                        and self.evict(1, exclude=path) == 0:
                    break        # at cap and nothing evictable: stop publishing
                node = _PrefixNode(key, int(blocks[i]), parent)
                self.allocator.incref([node.block])   # publisher holds one
                self._tracked.add(node.block)         # ref, so rc >= 2 here
                children[key] = node
                self._nodes += 1
                added += 1
            elif not node.resident:
                # re-adopt: the publisher's own private block carries byte-
                # identical content for this chunk, so the demoted node
                # becomes resident for free — no tier fetch, no upload
                node.block = int(blocks[i])
                self.allocator.incref([node.block])
                self._tracked.add(node.block)
                if node.handle is not None:
                    self._by_handle.pop(node.handle, None)
                    if self.tier_store is not None:
                        self.tier_store.discard(node.handle)
                    node.handle = None
                    self._demoted -= 1
                self._nodes += 1
                self.counters["readopted_blocks"] += 1
                added += 1
            node.stamp = self._clock
            path.append(node)
            parent = node
            children = node.children
        if added:
            self.counters["inserted_blocks"] += added
            if "blocks" in self._inst:
                self._inst["blocks"].set(float(self._nodes))
        return added

    # ------------------------------------------------------------------
    def _on_ref_transition(self, block: int, old_rc: int,
                           new_rc: int) -> None:
        """Allocator hook keeping ``_evictable`` exact in O(1): a tree-held
        block becomes evictable when its last co-owner leaves (2 -> 1) and
        stops being evictable when a sharer attaches (1 -> 2). All other
        transitions leave evictability unchanged."""
        if block in self._tracked:
            if old_rc == 2 and new_rc == 1:
                self._evictable += 1
            elif old_rc == 1 and new_rc == 2:
                self._evictable -= 1

    @property
    def held_blocks(self) -> int:
        """Blocks the tree references (evictable + pinned-by-sharers)."""
        return self._nodes

    def evictable_blocks(self) -> int:
        """Blocks reclaimable right now: cache-held blocks no live sequence
        references (refcount 1 nodes are downward-closed — a pinned child
        implies a pinned parent, since sequences hold whole prefixes — so
        every refcount-1 node is reachable by leaf-first eviction). O(1):
        maintained through the allocator's refcount-transition observer
        because this sits inside every schedulability query."""
        return self._evictable

    def _iter_nodes(self):
        stack = list(self._root.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def _evict_candidates(self, skip: set) -> List[_PrefixNode]:
        """Resident rc==1 nodes with no RESIDENT node below them (demoted
        descendants do not pin an ancestor — their KV already left HBM);
        eviction/demotion therefore proceeds deepest-first, keeping the
        invariant that residents form the leading chain of every path.
        Nodes with a pending promote upload are never candidates — their
        block holds garbage until the fence. Iterative post-order: a
        cached prefix chain can be thousands of blocks deep, far past the
        interpreter's recursion limit."""
        cands: List[_PrefixNode] = []
        sub: Dict[int, bool] = {}   # id(node) -> subtree has a resident
        stack: List[Tuple[_PrefixNode, bool]] = [
            (n, False) for n in self._root.values()]
        while stack:
            node, done = stack.pop()
            if not done:
                stack.append((node, True))
                stack.extend((c, False) for c in node.children.values())
                continue
            flags = [sub.pop(id(c)) for c in node.children.values()]
            sub_resident = any(flags)
            if node.resident:
                if not sub_resident and id(node) not in skip \
                        and node not in self._pending_upload \
                        and self.allocator.refcount(node.block) == 1:
                    cands.append(node)
                sub[id(node)] = True
            else:
                sub[id(node)] = sub_resident
        return cands

    def evict(self, want: int, exclude: Sequence[_PrefixNode] = ()) -> int:
        """Free up to ``want`` HBM blocks, LRU deepest-first; never touches
        a block another owner still references, nor a node in ``exclude``
        (insert's descent path / acquire's promotion path). One tree walk
        gathers ALL current candidates per pass (sorted by LRU stamp)
        instead of rescanning the tree per freed block; parents whose
        subtrees empty out are picked up by the next pass.

        With a tier store attached this is DEMOTION, not loss: each
        victim's KV pages are extracted (one batched device fetch per
        pass) into the host tier and the node stays in the radix tree,
        promotable on a later match; a victim the store cannot take (copy
        failure) falls back to plain eviction. Returns HBM blocks actually
        freed either way."""
        skip = {id(n) for n in exclude}
        demote = (self.tier_store is not None
                  and self.extract_fn is not None)
        freed = 0
        while freed < want:
            cands = self._evict_candidates(skip)
            if not cands:
                break
            cands.sort(key=lambda n: n.stamp)
            victims = cands[:want - freed]
            payloads = (self.extract_fn([n.block for n in victims])
                        if demote else None)
            for i, victim in enumerate(victims):
                block = victim.block
                if demote and self._demote(victim, payloads[i]):
                    victim.block = -1      # pages now live in the store
                else:
                    # plain eviction. The victim can carry DEMOTED
                    # descendants (only resident ones pin it); unlinking
                    # just the victim would orphan them — unreachable
                    # nodes whose tier entries leak until clear(). Drop
                    # their subtrees with the victim.
                    for child in list(victim.children.values()):
                        self._drop_subtree(child)
                    self._unlink(victim)
                    self._nodes -= 1
                self._tracked.discard(block)
                self._evictable -= 1        # victim was rc==1 by selection
                self.allocator.free([block])
                freed += 1
        if freed:
            self.counters["evicted_blocks"] += freed
            if "evictions" in self._inst:
                self._inst["evictions"].inc(float(freed))
            if "blocks" in self._inst:
                self._inst["blocks"].set(float(self._nodes))
        return freed

    def _demote(self, node: _PrefixNode, payload) -> bool:
        """Hand one victim's KV pages to the tier store; on success the
        node transitions resident -> demoted (caller frees the block)."""
        hid = self._next_handle
        self._next_handle += 1
        try:
            ok = self.tier_store.put(hid, payload)
        except Exception as e:
            logger.warning(f"prefix cache: demotion failed ({e}); "
                           "evicting the block instead")
            ok = False
        if not ok:
            return False
        node.handle = hid
        self._by_handle[hid] = node
        self._nodes -= 1
        self._demoted += 1
        self.counters["demoted_blocks"] += 1
        return True

    def _unlink(self, node: _PrefixNode) -> None:
        siblings = (node.parent.children if node.parent is not None
                    else self._root)
        siblings.pop(node.key, None)

    def _drop_subtree(self, node: _PrefixNode) -> None:
        """Detach ``node`` and everything below it (its tier entry was
        lost, so nothing beneath can ever match again): resident
        descendants lose the cache's reference, demoted descendants lose
        their store entries. Nodes are marked dead so stale path
        references (acquire iterating a pre-mutation walk) see them as
        unusable."""
        self._unlink(node)
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children = {}
            self._pending_upload.discard(n)   # dead nodes don't fence
            if n.resident:
                b = n.block
                self._nodes -= 1
                self._tracked.discard(b)
                if self.allocator.refcount(b) == 1:
                    self._evictable -= 1
                self.allocator.free([b])
            elif n.handle is not None:
                self._by_handle.pop(n.handle, None)
                if self.tier_store is not None:
                    self.tier_store.discard(n.handle)
                self._demoted -= 1
            n.handle = None
            n.block = -1
        if "blocks" in self._inst:
            self._inst["blocks"].set(float(self._nodes))

    def _on_tier_drop(self, handle: int) -> None:
        """Store callback: an entry was dropped under capacity pressure
        (host tier full, no NVMe) — detach the now-unservable node."""
        node = self._by_handle.get(handle)
        if node is not None:
            self.counters["tier_lost_blocks"] += 1
            self._drop_subtree(node)

    def clear(self) -> int:
        """Drop every cached prefix, releasing the cache's references (live
        sequences keep theirs) and every demoted entry's tier storage.
        Promotions still pending an engine upload are cancelled first (the
        acquirer is gone if clear() is reachable). Returns nodes whose
        cache-held state was dropped (resident + demoted)."""
        if self.pending_promotes:
            for rec in self.pending_promotes:
                rec.fetch.release()
                if self.tier_store is not None:
                    self.tier_store.discard(rec.key)
            self.pending_promotes = []
        nodes = list(self._iter_nodes())
        self._tracked.clear()           # before free: no transition counts
        for n in nodes:
            if n.resident:
                self.allocator.free([n.block])
            elif n.handle is not None and self.tier_store is not None:
                self.tier_store.discard(n.handle)
        self._root = {}
        self._nodes = 0
        self._demoted = 0
        self._by_handle = {}
        self._pending_upload.clear()
        # records the engine drained before this clear() still sit in its
        # upload queue referencing blocks we just released — the epoch
        # bump tells the fence to release them instead of scattering over
        # whoever owns those blocks by then
        self.epoch += 1
        self._evictable = 0             # empty tree: nothing evictable
        if "blocks" in self._inst:
            self._inst["blocks"].set(0.0)
        return len(nodes)

    def report(self) -> Dict:
        out = {"blocks": self._nodes,
               "demoted_nodes": self._demoted,
               "evictable_blocks": self.evictable_blocks(),
               **self.counters}
        if self.tier_store is not None:
            out["tiers"] = self.tier_store.report()
        return out


@dataclasses.dataclass
class SequenceDescriptor:
    """Per-sequence state."""

    uid: int
    slot: int                      # row of the block tables while live
    seen_tokens: int = 0           # tokens already in KV
    blocks: List[int] = dataclasses.field(default_factory=list)
    in_flight: int = 0
    published: int = 0             # leading blocks shared via a prefix cache


class SequenceManager:
    """Live sequences and KV capacity; schedulability queries
    (``can_schedule``/``can_schedule_batch``), block growth (``schedule``),
    commit and release (``flush``). With a :class:`PrefixCache` attached,
    capacity queries count cache-evictable blocks as available and
    ``schedule`` reclaims them LRU-first when the free list runs short."""

    def __init__(self, max_sequences: int, max_seq_len: int, block_size: int = 128,
                 num_blocks: Optional[int] = None):
        self.max_sequences = max_sequences
        self.max_seq_len = max_seq_len
        self.allocator = BlockedAllocator(
            num_blocks if num_blocks is not None
            else max_sequences * ((max_seq_len + block_size - 1) // block_size),
            block_size)
        self.prefix_cache: Optional[PrefixCache] = None
        self.sequences: Dict[int, SequenceDescriptor] = {}
        self._free_slots = list(range(max_sequences))
        # bumped whenever a slot is released, so engines can cache per-slot
        # derived state (block-table rows) and detect slot reuse
        self.slot_generation = [0] * max_sequences

    def _available_blocks(self) -> int:
        free = self.allocator.free_blocks
        if self.prefix_cache is not None:
            free += self.prefix_cache.evictable_blocks()
        return free

    def get_or_create(self, uid: int) -> SequenceDescriptor:
        if uid in self.sequences:
            return self.sequences[uid]
        if not self._free_slots:
            raise RuntimeError("no free sequence slots; flush finished sequences")
        seq = SequenceDescriptor(uid=uid, slot=self._free_slots.pop(0))
        self.sequences[uid] = seq
        return seq

    def attach_prefix(self, uid: int, blocks: Sequence[int],
                      n_tokens: int) -> SequenceDescriptor:
        """Start a fresh sequence that co-owns ``blocks`` (already
        referenced for it by ``PrefixCache.acquire``) holding its first
        ``n_tokens`` tokens of KV; the engine prefills only the suffix."""
        if uid in self.sequences:
            raise RuntimeError(f"attach_prefix on live uid {uid}")
        if n_tokens % self.allocator.block_size:
            raise ValueError("cached prefixes are full-block granular")
        seq = self.get_or_create(uid)
        seq.blocks = list(blocks)
        seq.seen_tokens = int(n_tokens)
        seq.published = len(seq.blocks)
        return seq

    def restore(self, uid: int, n_blocks: int,
                seen_tokens: int) -> SequenceDescriptor:
        """Re-materialise a paused sequence: a fresh slot and ``n_blocks``
        private blocks that hold ``seen_tokens`` tokens of KV once the
        engine's tier upload lands. ``seen_tokens`` need not be
        block-aligned, and nothing is shared back through the prefix tree
        (``published=0``)."""
        if uid in self.sequences:
            raise RuntimeError(f"restore on live uid {uid}")
        bs = self.allocator.block_size
        if n_blocks * bs < seen_tokens:
            raise ValueError(f"restore: {n_blocks} blocks cannot hold "
                             f"{seen_tokens} tokens (block_size={bs})")
        short = n_blocks - self.allocator.free_blocks
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short)
        seq = self.get_or_create(uid)
        seq.seen_tokens = int(seen_tokens)
        seq.published = 0
        try:
            seq.blocks = list(self.allocator.allocate(n_blocks))
        except RuntimeError:
            # unwind the slot so a failed restore leaks nothing
            self.sequences.pop(uid, None)
            self._free_slots.append(seq.slot)
            self.slot_generation[seq.slot] += 1
            raise
        return seq

    def can_schedule(self, uid: int, new_tokens: int) -> bool:
        seq = self.sequences.get(uid)
        seen = seq.seen_tokens if seq else 0
        if seen + new_tokens > self.max_seq_len:
            return False
        need_blocks = max(
            0, -(-(seen + new_tokens) // self.allocator.block_size)
            - (len(seq.blocks) if seq else 0))
        slots_ok = uid in self.sequences or bool(self._free_slots)
        return slots_ok and need_blocks <= self._available_blocks()

    def can_schedule_batch(self, uids, n_tokens) -> bool:
        """Joint schedulability of a batch; a uid listed twice is costed
        cumulatively."""
        tok: Dict[int, int] = {}
        blk: Dict[int, int] = {}
        new_slots = set()
        need = 0
        bs = self.allocator.block_size
        for uid, n in zip(uids, n_tokens):
            if uid not in tok:
                seq = self.sequences.get(uid)
                tok[uid] = seq.seen_tokens if seq else 0
                blk[uid] = len(seq.blocks) if seq else 0
                if seq is None:
                    new_slots.add(uid)
            tok[uid] += n
            if tok[uid] > self.max_seq_len:
                return False
            grow = -(-tok[uid] // bs) - blk[uid]
            if grow > 0:
                need += grow
                blk[uid] += grow
        return (len(new_slots) <= len(self._free_slots)
                and need <= self._available_blocks())

    def schedule(self, uid: int, new_tokens: int) -> SequenceDescriptor:
        seq = self.get_or_create(uid)
        needed = -(-(seq.seen_tokens + new_tokens) // self.allocator.block_size)
        grow = needed - len(seq.blocks)
        if grow > 0:
            short = grow - self.allocator.free_blocks
            if short > 0 and self.prefix_cache is not None:
                self.prefix_cache.evict(short)
            seq.blocks.extend(self.allocator.allocate(grow))
        seq.in_flight = new_tokens
        return seq

    def commit(self, uid: int) -> None:
        seq = self.sequences[uid]
        seq.seen_tokens += seq.in_flight
        seq.in_flight = 0

    def flush(self, uid: int) -> None:
        """Release a finished sequence's blocks and slot; shared blocks just
        lose this sequence's reference."""
        seq = self.sequences.pop(uid, None)
        if seq is not None:
            self.allocator.free(seq.blocks)
            self._free_slots.append(seq.slot)
            self.slot_generation[seq.slot] += 1
