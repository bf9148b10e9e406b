"""The serving stack above the engine on the card: a ``tiny`` model (256
wide, 4 heads of 64, bf16) served by two ``InferenceEngineV2`` replicas
behind a ``ReplicaRouter`` and a ``ServingFrontend``, a unary and a
streaming request over HTTP through ``GenerateClient``; kernels A, B, C
and D each launch at least once (their launch counters). Marked ``cuda``,
skipped without a card. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_serving_cuda.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_router_and_frontend_launch_a_b_c_d(cuda_device):
    from deepspeed_tpu_torch.config import (FrontendConfig, RouterConfig,
                                            ServingConfig)
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.serving import (ContinuousBatcher,
                                             GenerateClient, Replica,
                                             ReplicaRouter, ServingFrontend)

    model = TransformerLM(get_preset("tiny", hidden_size=256, num_heads=4,
                                     max_seq_len=512, dtype="bfloat16"))
    params = model.init(seed=0, device="cuda")
    engines = [InferenceEngineV2(model, params, max_sequences=4,
                                 max_seq_len=512, block_size=128)
               for _ in range(2)]
    cfg = ServingConfig(prefill_chunk=128, default_max_new_tokens=4)
    reps = [Replica(f"r{i}", ContinuousBatcher(e, cfg))
            for i, e in enumerate(engines)]
    router = ReplicaRouter(reps, RouterConfig()).start()
    fe = ServingFrontend(router, FrontendConfig()).start()
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 256, n)] for n in (300, 200)]
    try:
        _build.reset_counts()
        cli = GenerateClient(fe.url, timeout_s=120)
        out = cli.generate(prompts[0], max_new_tokens=4)
        evs = list(cli.stream(prompts[1], max_new_tokens=4))
        counts = {k: _build.KERNELS[k].launches
                  for k in ("paged_decode", "paged_past", "chunk_self",
                            "flash_fwd")}
    finally:
        fe.close()
        router.close()
    assert out["state"] == "completed" and len(out["tokens"]) == 4
    assert evs[-1]["event"] == "end"
    assert evs[-1]["data"]["tokens"] == [e["data"]["token"] for e in evs
                                         if e["event"] == "token"]
    assert all(counts.values()), counts
    for eng in engines:
        alloc = eng.state.allocator
        assert alloc.free_blocks == alloc.num_blocks
        assert not eng.state.sequences
