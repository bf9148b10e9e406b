"""Host-side KV bookkeeping of the PyTorch port (``inference/ragged.py``):
the refcounted allocator and schedulability cases of the JAX package's
``tests/unit/test_prefix_cache.py``, re-pointed at the port, plus a seeded
random trace replayed through both packages' ``SequenceManager``."""

import numpy as np
import pytest

from deepspeed_tpu.inference import SequenceManager as JaxManager
from deepspeed_tpu_torch.inference import (BlockedAllocator, CapacityError,
                                           SequenceManager)
from tests._torch_threads import one_torch_thread  # noqa: F401


class TestRefcountedAllocator:
    def test_double_free_raises(self):
        alloc = BlockedAllocator(num_blocks=4, block_size=8)
        a = alloc.allocate(2)
        alloc.free(a)
        assert alloc.free_blocks == 4
        with pytest.raises(RuntimeError, match="double free"):
            alloc.free(a)
        assert alloc.free_blocks == 4      # the failed free corrupted nothing
        with pytest.raises(RuntimeError, match="double free"):
            alloc.free([0])

    def test_shared_block_needs_one_free_per_owner(self):
        alloc = BlockedAllocator(num_blocks=2, block_size=8)
        [b] = alloc.allocate(1)
        alloc.incref([b])
        alloc.free([b])
        assert alloc.free_blocks == 1
        assert alloc.refcount(b) == 1
        alloc.free([b])
        assert alloc.free_blocks == 2
        with pytest.raises(RuntimeError, match="double free"):
            alloc.free([b])

    def test_incref_of_free_block_raises(self):
        alloc = BlockedAllocator(num_blocks=2, block_size=8)
        with pytest.raises(RuntimeError, match="unallocated"):
            alloc.incref([0])

    def test_out_of_blocks_and_leak_report(self):
        alloc = BlockedAllocator(num_blocks=3, block_size=8)
        got = alloc.allocate(3)
        with pytest.raises(RuntimeError, match="out of KV blocks"):
            alloc.allocate(1)
        assert alloc.leaked_blocks() == got
        alloc.free(got)
        assert alloc.leaked_blocks() == []


class TestSchedulability:
    def test_duplicate_uid_blocks_costed_cumulatively(self):
        sm = SequenceManager(max_sequences=2, max_seq_len=64, block_size=8,
                             num_blocks=8)
        sm.schedule(1, 4)
        sm.commit(1)
        taken = sm.allocator.allocate(sm.allocator.free_blocks)
        assert not sm.can_schedule_batch([1, 1], [4, 4])
        sm.allocator.free(taken)
        assert sm.can_schedule_batch([1, 1], [4, 4])

    def test_duplicate_uid_seq_len_costed_cumulatively(self):
        sm = SequenceManager(max_sequences=2, max_seq_len=32, block_size=8)
        sm.schedule(1, 30)
        sm.commit(1)
        assert sm.can_schedule_batch([1], [2])
        assert not sm.can_schedule_batch([1, 1], [2, 2])

    def test_duplicate_new_uid_counts_one_slot(self):
        sm = SequenceManager(max_sequences=1, max_seq_len=32, block_size=8)
        assert sm.can_schedule_batch([7, 7], [4, 4])

    def test_slots_blocks_and_flush(self):
        sm = SequenceManager(max_sequences=2, max_seq_len=32, block_size=8)
        a = sm.schedule(10, 9)          # 2 blocks
        assert len(a.blocks) == 2 and a.in_flight == 9
        sm.commit(10)
        assert a.seen_tokens == 9 and a.in_flight == 0
        sm.schedule(11, 1)
        assert not sm.can_schedule(12, 1)            # no slot left
        assert sm.can_schedule(10, 32 - 9)
        assert not sm.can_schedule(10, 32 - 9 + 1)   # past max_seq_len
        gen = list(sm.slot_generation)
        sm.flush(10)
        assert sm.slot_generation[a.slot] == gen[a.slot] + 1
        assert sm.allocator.free_blocks == sm.allocator.num_blocks - 1
        assert sm.can_schedule(12, 1)

    def test_capacity_error_carries_demand(self):
        err = CapacityError([3, 4], [5, 6], "decode_batch")
        assert isinstance(err, RuntimeError)
        assert err.uids == [3, 4] and err.token_demand == [5, 6]
        assert "decode_batch" in str(err)


def test_random_trace_matches_reference():
    """A seeded trace of schedule/commit/flush/query calls gives the same
    answers, slots and block ids in both packages."""
    rng = np.random.default_rng(0)
    ours = SequenceManager(max_sequences=4, max_seq_len=40, block_size=8,
                           num_blocks=14)
    ref = JaxManager(max_sequences=4, max_seq_len=40, block_size=8,
                     num_blocks=14)
    for _ in range(400):
        uids = [int(u) for u in rng.integers(0, 6, rng.integers(1, 4))]
        n = [int(x) for x in rng.integers(1, 12, len(uids))]
        op = rng.integers(0, 3)
        ok = ours.can_schedule_batch(uids, n)
        assert ok == ref.can_schedule_batch(uids, n)
        assert ours.can_schedule(uids[0], n[0]) == \
            ref.can_schedule(uids[0], n[0])
        if op == 0 and ok:
            for u, k in zip(uids, n):
                a, b = ours.schedule(u, k), ref.schedule(u, k)
                assert (a.slot, a.blocks) == (b.slot, b.blocks)
                ours.commit(u)
                ref.commit(u)
        elif op == 1:
            ours.flush(uids[0])
            ref.flush(uids[0])
        assert ours.allocator.free_blocks == ref.allocator.free_blocks
        assert ours.slot_generation == ref.slot_generation
