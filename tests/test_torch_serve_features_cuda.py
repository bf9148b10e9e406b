"""The serving features' device and host-library paths on the card: the
``async_io`` library (the repo's ``csrc/aio.cpp`` built with ``g++``)
round-trips a buffer through a file, and a demote -> promote of prefix
blocks through the host and NVMe tiers leaves llama3-8b-wide pool blocks
(8 kv heads x 128, block 128, bf16 and int8) bit-exact on the card, with
page-locked host buffers. Every test is marked ``cuda`` and skips without
a card. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_serve_features_cuda.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset
from deepspeed_tpu_torch.offload import AsyncTensorSwapper, PinnedBufferPool


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_async_io_round_trip(cuda_device, tmp_path):
    pool = PinnedBufferPool(pin=True)
    sw = AsyncTensorSwapper(str(tmp_path), chunk_mb=1, pool=pool,
                            namespace="kv")
    try:
        a = np.random.default_rng(0).integers(
            -128, 127, 3 * (1 << 20) + 123, dtype=np.int8)
        sw.swap_out("blk", a).wait()
        assert np.array_equal(sw.swap_in("blk"), a)
        t, seg = sw.swap_in_start_many(["blk"])
        off, n = seg["blk"]
        assert np.array_equal(t.wait()[off:off + n].view(np.int8), a)
        t.release()
        assert sw.bandwidth()["read_bytes"] > 0
    finally:
        sw.close()
    assert pool.report()["outstanding"] == 0
    buf = pool.get(4096)
    assert buf.raw.is_pinned()
    pool.put(buf)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_demote_promote_is_bit_exact_on_the_card(cuda_device, tmp_path,
                                                 kv_dtype):
    cfg = get_preset("llama3-8b", num_layers=2, intermediate_size=1024,
                     vocab_size=512, param_dtype="bfloat16")
    model = TransformerLM(cfg)
    block = 2 * cfg.num_layers * 128 * cfg.num_kv_heads * cfg.head_dim
    eng = InferenceEngineV2(
        model, max_sequences=4, max_seq_len=1024, block_size=128,
        kv_dtype=kv_dtype, prefix_cache={"enabled": True, "tiers": {
            "enabled": True, "host_mb": 1.5 * block / 2**20,
            "nvme_path": str(tmp_path)}})
    prompt = np.random.default_rng(1).integers(1, 512, 520).astype(np.int32)
    try:
        first = eng.put([0], [prompt])[0]
        blocks = eng.state.sequences[0].blocks[:4]
        idx = torch.tensor(blocks, device="cuda")
        before = {n: t.index_select(1, idx).clone()
                  for n, t in eng.cache.items()}
        eng.flush([0])
        pc = eng.prefix_cache
        assert pc.evict(pc.evictable_blocks()) == 4
        rep = eng.tier_report()
        assert rep["host_entries"] >= 1 and rep["nvme_entries"] >= 1
        assert eng.prefix_attach(1, prompt) == 512
        eng._flush_promotes()
        new = torch.tensor(eng.state.sequences[1].blocks[:4], device="cuda")
        for n, t in eng.cache.items():
            assert torch.equal(t.index_select(1, new), before[n]), n
        again = eng.put([1], [prompt[512:]])[1]
        assert np.linalg.norm(again - first) <= 2e-2 * np.linalg.norm(first)
        assert eng._tier_store.pool.pin
    finally:
        eng.close()
