"""Kernels A-D of the PyTorch port against their plain versions on the card
(bf16; atol = rtol = 2e-2 on normalised outputs, 1e-2 on m and lse). Every
test here is marked ``cuda`` and skips without a card. The file imports
neither JAX nor the JAX package, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import paged_attention as tpa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,window,rel", [(1024, None, 0), (333, None, 0),
                                          (256, 64, 0), (128, None, 64)])
def test_kernel_d_matches_plain_on_card(cuda_device, T, window, rel):
    from deepspeed_tpu_torch.ops._build import KERNELS

    g = torch.Generator(device=cuda_device).manual_seed(T)
    q, k, v = (torch.randn(2, T, h, 128, generator=g, device=cuda_device)
               .to(torch.bfloat16) for h in (32, 8, 8))
    n = KERNELS["flash_fwd"].launches
    out, lse = tfa.flash_attention_lse(q, k, v, causal=True, window=window,
                                 rel_offset=rel)
    torch.cuda.synchronize()
    assert KERNELS["flash_fwd"].launches == n + 1
    ref, ref_lse = tfa.plain_flash_forward(q, k, v, causal=True,
                                           window=window, rel_offset=rel)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=1e-2)


def _card_pools(dev, nbp1=65, bs=128, lanes=8 * 128):
    g = torch.Generator(device=dev).manual_seed(0)
    kp = torch.randn(2, nbp1, bs, lanes, generator=g, device=dev).bfloat16()
    vp = torch.randn(2, nbp1, bs, lanes, generator=g, device=dev).bfloat16()
    bt = torch.randperm(nbp1 - 1, generator=g, device=dev).to(torch.int32)
    return kp, vp, bt.reshape(4, 16).contiguous(), g


def _norm(acc, l):
    return (acc / l.clamp_min(1e-30)[..., None]).float()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 300])
def test_kernel_a_matches_plain_on_card(cuda_device, window):
    kp, vp, bt, g = _card_pools(cuda_device)
    q = torch.randn(6, 32, 128, generator=g, device=cuda_device).bfloat16()
    slot = torch.tensor([0, 1, 2, 3, 0, 1], device=cuda_device)
    pos0 = torch.tensor([0, 1, 129, 700, 2047, 64], device=cuda_device)
    acc, m, l = tpa.decode_pool_partials(q, kp, vp, 1, bt, slot, pos0,
                                         window=window)
    ra, rm, rl = tpa.plain_decode_partials(q, kp, vp, 1, bt, slot, pos0,
                                           window=window)
    live = pos0 > 0
    torch.testing.assert_close(_norm(acc, l)[live], _norm(ra, rl)[live],
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(m[live], rm[live], atol=1e-2, rtol=1e-2)
    assert float(l[~live].abs().max()) == 0.0


@pytest.mark.cuda
def test_kernel_a_decode_loop_rows_match_plain_on_card(cuda_device):
    """Rows of the fused decode loop sit past the pool frontier: the window
    is anchored at ``row_pos`` (> pos0), the pool still ends at pos0."""
    kp, vp, bt, g = _card_pools(cuda_device)
    q = torch.randn(4, 32, 128, generator=g, device=cuda_device).bfloat16()
    slot = torch.tensor([0, 1, 2, 3], device=cuda_device)
    pos0 = torch.tensor([130, 700, 300, 2000], device=cuda_device)
    row_pos = pos0 + torch.tensor([1, 7, 31, 3], device=cuda_device)
    acc, m, l = tpa.decode_pool_partials(q, kp, vp, 0, bt, slot, pos0,
                                         window=256, row_pos=row_pos)
    ra, rm, rl = tpa.plain_decode_partials(q, kp, vp, 0, bt, slot, pos0,
                                           window=256, row_pos=row_pos)
    torch.testing.assert_close(_norm(acc, l), _norm(ra, rl), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(m, rm, atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("tq,window", [(256, None), (100, None), (64, 90)])
def test_kernels_b_c_match_plain_on_card(cuda_device, tq, window):
    kp, vp, bt, g = _card_pools(cuda_device)
    A = 3
    q = torch.randn(A * tq, 32, 128, generator=g, device=cuda_device).bfloat16()
    ks = torch.randn(A * tq, 8, 128, generator=g, device=cuda_device).bfloat16()
    vs = torch.randn(A * tq, 8, 128, generator=g, device=cuda_device).bfloat16()
    slot = torch.tensor([0, 2, 3], device=cuda_device)
    pos0 = torch.tensor([256, 1000, 5], device=cuda_device)
    alen = torch.tensor([tq, tq - 7, 1], device=cuda_device)
    acc, m, l = tpa.past_partials(q, kp, vp, 0, bt, slot, pos0, tq,
                                  window=window)
    ra, rm, rl = tpa.plain_past_partials(q, kp, vp, 0, bt, slot, pos0, tq,
                                         window=window)
    torch.testing.assert_close(_norm(acc, l), _norm(ra, rl), atol=2e-2,
                               rtol=2e-2)
    live = rl > 0
    torch.testing.assert_close(m[live], rm[live], atol=1e-2, rtol=1e-2)
    seed = (ra, rm, rl)
    out = tpa.self_attention(q, ks, vs, alen, tq, seed, window=window)
    ref = tpa.plain_self_attention(q, ks, vs, alen, tq, seed, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 40])
def test_engine_on_card_matches_plain_cpu_engine(cuda_device, window):
    """The whole serving path on the card (every put and decode step through
    kernels A-D) against the same engine on the CPU (plain versions), bf16
    weights: logits within 5e-2 (bf16 rounding of a 2-layer model whose
    logits are O(1)), and each kernel launched. ``decode_batch``'s logits are
    recorded at every step of its fused loop and held to the same tolerance
    while a sequence's tokens agree; its greedy tokens must agree except at
    a step whose CPU top-2 gap is within twice that tolerance (a near tie),
    after which the two runs legitimately diverge."""
    import numpy as np

    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset
    from deepspeed_tpu_torch.ops._build import KERNELS, reset_counts

    cfg = get_preset("tiny", hidden_size=256, num_heads=4, num_kv_heads=2,
                     max_seq_len=512, sliding_window=window)
    model = TransformerLM(cfg)
    params = model.init(seed=0, device="cpu")
    kw = dict(max_sequences=4, max_seq_len=512, block_size=16)
    engines = {d: InferenceEngineV2(model, params, device=d, **kw)
               for d in ("cpu", "cuda")}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (5, 40)]
    longp = rng.integers(1, 256, 300).astype(np.int32)   # > MAX_ATOM
    tol = dict(atol=5e-2, rtol=5e-2)
    steps = 8
    recorded = {"cpu": [], "cuda": []}
    real = model.forward_decode_tail

    def recording(params, toks, *args, **kw):
        logits, tail = real(params, toks, *args, **kw)
        recorded[toks.device.type].append(logits.float().cpu().numpy())
        return logits, tail

    model.forward_decode_tail = recording
    reset_counts()
    out = {}
    for d, eng in engines.items():
        a = eng.put([0, 1], prompts)
        b = eng.put([0, 1, 2], [np.array([7], np.int32),
                                np.array([9], np.int32), longp])
        c = eng.decode_batch([0, 1, 2], [3, 4, 5], steps=steps)
        out[d] = (a, b, c)
    for step in range(2):
        for uid, lg in out["cpu"][step].items():
            np.testing.assert_allclose(out["cuda"][step][uid], lg, **tol)
    assert len(recorded["cpu"]) == len(recorded["cuda"]) == steps
    for uid in range(3):                    # batch row = uid
        for s in range(steps):
            want = recorded["cpu"][s][uid]
            np.testing.assert_allclose(recorded["cuda"][s][uid], want,
                                       **tol, err_msg=f"uid {uid} step {s}")
            if out["cuda"][2][uid][s] != out["cpu"][2][uid][s]:
                lo, hi = np.sort(want)[-2:]
                assert hi - lo < 2 * (tol["atol"] + tol["rtol"] * abs(hi)), (
                    f"uid {uid} step {s}: tokens differ with a CPU top-2 gap "
                    f"of {hi - lo:.3e}")
                break
    assert all(k.launches > 0 for k in KERNELS.values()), \
        {n: k.launches for n, k in KERNELS.items()}
