"""Ragged/continuous-batching state (counterpart of
``deepspeed_tpu/inference/ragged.py``; host-side Python, no tensors).

``BlockedAllocator`` is the refcounted free list of KV pool blocks (its block
ids ARE the physical pool indices), ``SequenceManager`` tracks live
sequences, their slots and blocks, and answers schedulability queries.
The prefix cache is not ported yet: ``SequenceManager.prefix_cache`` stays
``None`` and no block is ever evictable.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence


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
    commit and release (``flush``)."""

    def __init__(self, max_sequences: int, max_seq_len: int, block_size: int = 128,
                 num_blocks: Optional[int] = None):
        self.max_sequences = max_sequences
        self.max_seq_len = max_seq_len
        self.allocator = BlockedAllocator(
            num_blocks if num_blocks is not None
            else max_sequences * ((max_seq_len + block_size - 1) // block_size),
            block_size)
        self.prefix_cache = None  # hook for the prefix cache (not ported yet)
        self.sequences: Dict[int, SequenceDescriptor] = {}
        self._free_slots = list(range(max_sequences))
        # bumped whenever a slot is released, so engines can cache per-slot
        # derived state (block-table rows) and detect slot reuse
        self.slot_generation = [0] * max_sequences

    def _available_blocks(self) -> int:
        return self.allocator.free_blocks

    def get_or_create(self, uid: int) -> SequenceDescriptor:
        if uid in self.sequences:
            return self.sequences[uid]
        if not self._free_slots:
            raise RuntimeError("no free sequence slots; flush finished sequences")
        seq = SequenceDescriptor(uid=uid, slot=self._free_slots.pop(0))
        self.sequences[uid] = seq
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
            seq.blocks.extend(self.allocator.allocate(grow))
        seq.in_flight = new_tokens
        return seq

    def commit(self, uid: int) -> None:
        seq = self.sequences[uid]
        seq.seen_tokens += seq.in_flight
        seq.in_flight = 0

    def flush(self, uid: int) -> None:
        """Release a finished sequence's blocks and slot."""
        seq = self.sequences.pop(uid, None)
        if seq is not None:
            self.allocator.free(seq.blocks)
            self._free_slots.append(seq.slot)
            self.slot_generation[seq.slot] += 1
