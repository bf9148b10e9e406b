"""MoE serving on the card at a small width: chip_smoke's phase 16
(``moe_serve``) on ``mixtral-8x7b``'s preset cut to 2 layers of width 256
(4 heads of 64, F 512, 8 experts, top-2, vocab 512, bf16) with its traffic
cut -- every gate of the phase (chunked vs whole, alone vs batched,
ragged vs padded, capacity at factor E vs grouped and (e)'s dense engines
within rel L2 2e-2; routed pairs equal to real tokens x 2 x layers; int8
expert stacks within 2e-2; int8 logits within 0.6) and A-D, G, H, A/B int8
and I launched --, and the int8 expert dequantization and the blockwise
activation quantizer on the card bit for bit against the CPU's. Marked
``cuda``, skipped without a card. The file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_moe_serving_cuda.py
"""

import numpy as np
import pytest
import torch

CARD_MOE = dict(hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                intermediate_size=512, vocab_size=512, num_experts=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_moe_serve_phase_at_a_small_width(cuda_device):
    import chip_smoke
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    rng = np.random.default_rng(0)
    prompts = ([rng.integers(1, 512, n).astype(np.int32)
                for n in (37, 128, 129, 200)],
               [rng.integers(1, 512, n).astype(np.int32) for n in (90, 300)])
    counts = chip_smoke.moe_serve(
        torch, pa, fa, qm, _build.KERNELS, _build.reset_counts,
        device="cuda", prompts=prompts, steps=8, max_atom=128,
        engine_kw=dict(max_sequences=8, max_seq_len=512, block_size=128),
        **CARD_MOE)
    assert all(counts.values()), counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_expert_dequant_matches_the_cpu(cuda_device, dtype):
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.ops.quant_matmul import quantize_matmul_weight

    g = torch.Generator().manual_seed(5)
    w = torch.randn(4, 256, 384, generator=g).to(dtype)
    pairs = [quantize_matmul_weight(x.float(), bits=8) for x in w]
    leaves = {"w_up_q": torch.stack([p for p, _ in pairs]),
              "w_up_s": torch.stack([s for _, s in pairs]).to(dtype)}
    want = sharded_moe._expert_weight(leaves, "w_up", dtype)
    got = sharded_moe._expert_weight(
        {n: t.to(cuda_device) for n, t in leaves.items()}, "w_up", dtype)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_blockwise_quantizer_matches_the_cpu(cuda_device, bits):
    from deepspeed_tpu_torch.compression import ste_quantize
    from deepspeed_tpu_torch.ops.quantization import quantize_blockwise

    x = torch.randn(6, 4096, generator=torch.Generator().manual_seed(bits))
    q, s = quantize_blockwise(x, bits=bits)
    qc, sc = quantize_blockwise(x.to(cuda_device), bits=bits)
    assert torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)
    xb = x.to(torch.bfloat16)
    assert torch.equal(ste_quantize(xb.to(cuda_device), bits=bits).cpu(),
                       ste_quantize(xb, bits=bits))
