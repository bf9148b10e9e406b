"""Kernels A-K of the PyTorch port, and the int8 / int4 modes of A and B,
against their plain versions on the card, the attention kernels (A-F, I)
at every head dim they are built for (``CARD_HEAD_DIMS``: 64, 96, 128,
256) (bf16; atol = rtol = 2e-2 on
normalised outputs (A-C) and on G/H's products, 1e-2 on m and lse; D's
out, the backward's dq/dk/dv and I's out per 64-row tile within 2e-2 of
that tile's max-abs; J at 1e-2 in bf16 and 1e-5 in fp32, forward and
autograd backward; K at relative 1e-6). Every test here is marked
``cuda`` and skips without a card. The file imports neither JAX nor the
JAX package, so it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from chip_smoke import close_tiles  # D's out, dq/dk/dv, I's out: 64-row tiles
from deepspeed_tpu_torch.ops import CARD_HEAD_DIMS
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import paged_attention as tpa


# 2-layer narrow models shaped like the two presets whose head dims are
# neither 64 nor 128 (``get_preset`` overrides; the CPU parity tests in
# ``test_torch_head_dims.py`` use them too): phi3-mini's llama block at
# d = 96 with H = K, and pythia-1b's gpt2 block (parallel residual, biases,
# LayerNorm, exact GELU, rotary on a quarter of each head) at d = 256.
PRESET_SHAPED = {
    "phi3-mini": dict(hidden_size=192, num_heads=2, num_kv_heads=2,
                      num_layers=2, intermediate_size=256, vocab_size=512,
                      max_seq_len=512),
    "pythia-1b": dict(hidden_size=512, num_heads=2, num_kv_heads=2,
                      num_layers=2,
                      intermediate_size=1024, vocab_size=512,
                      max_seq_len=512),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,B,T,S,causal,window,rel", [
    (128, 2, 1024, 1024, True, None, 0),
    (64, 2, 1024, 1024, True, None, 0),
    (128, 1, 2048, 2048, True, None, 0),
    (64, 2, 2048, 2048, True, None, 0),
    (128, 2, 333, 333, True, None, 0),
    (64, 2, 333, 333, True, None, 0),
    (128, 2, 37, 37, True, None, 0),
    (64, 2, 37, 37, True, None, 0),
    (128, 2, 256, 256, True, 64, 0),
    (128, 2, 128, 192, True, None, 64),
    (64, 2, 128, 192, True, None, 64),
    (128, 2, 333, 200, False, None, 0),
    (64, 2, 100, 130, False, None, 0),
    (128, 2, 200, 200, True, 50, -20),
    (64, 2, 200, 200, True, 50, -20),
    (96, 2, 1024, 1024, True, None, 0),
    (256, 2, 1024, 1024, True, None, 0),
    (96, 2, 333, 333, True, None, 0),
    (256, 2, 333, 333, True, None, 0),
    (96, 2, 37, 37, True, None, 0),
    (256, 2, 37, 37, True, None, 0),
    (96, 2, 256, 256, True, 64, 0),
    (256, 2, 256, 256, True, 64, 0),
    (96, 2, 128, 192, True, None, 64),
    (256, 2, 128, 192, True, None, 64),
    (96, 2, 100, 130, False, None, 0),
    (256, 2, 333, 200, False, None, 0),
    (96, 2, 200, 200, True, 50, -20),
    (256, 2, 200, 200, True, 50, -20)])
def test_kernel_d_matches_plain_on_card(cuda_device, d, B, T, S, causal,
                                        window, rel):
    """D at d = 64, 96, 128 and 256 (H=32, K=8): T below one 64-row tile and
    not a multiple of it, S != T without a causal mask, rel_offset 64, and -20
    under a window of 50, whose first 20 rows see nothing (out = 0, lse the
    plain version's -1e30 sentinel). ``out`` per 64-row tile, batch row and
    head (``close_tiles``), lse at 1e-2."""
    from deepspeed_tpu_torch.ops._build import KERNELS

    g = torch.Generator(device=cuda_device).manual_seed(T * 3 + S + d)
    q = torch.randn(B, T, 32, d, generator=g, device=cuda_device).bfloat16()
    k, v = (torch.randn(B, S, 8, d, generator=g, device=cuda_device)
            .bfloat16() for _ in "kv")
    n = KERNELS["flash_fwd"].launches
    out, lse = tfa.flash_attention_lse(q, k, v, causal=causal, window=window,
                                       rel_offset=rel)
    torch.cuda.synchronize()
    assert KERNELS["flash_fwd"].launches == n + 1
    ref, ref_lse = tfa.plain_flash_forward(q, k, v, causal=causal,
                                           window=window, rel_offset=rel)
    close_tiles("D out", out, ref)
    torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=1e-2)
    if rel < 0:
        assert float(out[:, :-rel].abs().max()) == 0.0
        assert bool((lse[..., :-rel] == ref_lse[..., :-rel]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d,T", [(128, 1024), (128, 333), (64, 2048),
                                 (64, 37), (96, 1024), (96, 333), (96, 37),
                                 (256, 1024), (256, 333), (256, 37)])
def test_kernel_d_equals_kernel_c_bitwise_on_card(cuda_device, d, T):
    """D keeps the tile engine's arithmetic, so a causal pass over one
    prompt gives the same bits as kernel C over it as one unseeded atom:
    the property that lets a prompt served in chunks (B, then C) and whole
    (D) agree at full depth."""
    g = torch.Generator(device=cuda_device).manual_seed(d + T)
    q = torch.randn(1, T, 32, d, generator=g, device=cuda_device).bfloat16()
    k, v = (torch.randn(1, T, 8, d, generator=g, device=cuda_device)
            .bfloat16() for _ in "kv")
    out, _ = tfa.flash_forward(q, k, v, causal=True)
    alen = torch.tensor([T], dtype=torch.int32, device=cuda_device)
    out_c = tpa.self_attention(q[0], k[0], v[0], alen, T)
    torch.cuda.synchronize()
    assert torch.equal(out[0], out_c)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,H,K,d,causal,window,rel", [
    (2, 1024, 1024, 32, 8, 64, True, None, 0),
    (1, 333, 333, 32, 8, 128, True, None, 0),
    (2, 256, 256, 8, 2, 64, True, 64, 0),
    (1, 128, 192, 8, 8, 128, True, None, 64),
    (1, 200, 200, 8, 2, 64, True, 50, -20),
    (2, 100, 130, 4, 1, 128, False, None, 0),
    (2, 333, 333, 16, 4, 128, True, None, 0),
    (2, 300, 300, 8, 8, 64, True, None, 0),
    (1, 300, 300, 8, 2, 64, True, 100, 0),
    (1, 300, 300, 8, 2, 128, True, 40, 0),
    (4, 2048, 2048, 32, 8, 64, True, None, 0),
    (2, 333, 333, 16, 4, 96, True, None, 0),
    (2, 333, 333, 16, 4, 256, True, None, 0),
    (1, 300, 300, 8, 2, 96, True, 100, 0),
    (1, 300, 300, 8, 2, 256, True, 40, 0),
    (1, 128, 192, 8, 8, 96, True, None, 64),
    (1, 128, 192, 8, 8, 256, True, None, 64),
    (1, 200, 200, 8, 2, 96, True, 50, -20),
    (1, 200, 200, 8, 2, 256, True, 50, -20),
    (2, 100, 130, 4, 1, 96, False, None, 0),
    (2, 100, 130, 4, 1, 256, False, None, 0),
    (1, 2048, 2048, 32, 32, 96, True, None, 0),
    (1, 2048, 2048, 8, 8, 256, True, None, 0)])
def test_kernels_e_f_match_plain_on_card(cuda_device, B, T, S, H, K, d,
                                         causal, window, rel):
    """E (dq) and F (dk, dv) at d = 64, 96, 128 and 256, GQA, window,
    rel_offset (negative: the first rows see nothing and get zeros), ragged
    T and S, with an lse cotangent folded into delta; then the paths of the
    register-resident kernels: a group of rep = 4 at d = 128 with T not a
    multiple of 64 (F walks four heads as one ring of tiles, 32 columns of
    S at a time), rep = 1, windows whose edge cuts a 64-row tile at d = 64
    and 128, and the training shape (Llama-3.2-1B, T = 2048); then d = 96
    and 256 on the same paths (at 256 F splits dK's and dV's columns over
    two CTAs; so do E's dQ columns) and the phi3-mini (H = K = 32, d = 96)
    and pythia-1b (H = K = 8, d = 256) training shapes at T = 2048."""
    from deepspeed_tpu_torch.ops._build import KERNELS

    q, k, v, do, lse, delta, kw = _card_bwd_inputs(
        cuda_device, B, T, S, H, K, d, causal, window, rel)
    n = {name: KERNELS[name].launches
         for name in ("flash_bwd_dq", "flash_bwd_dkv")}
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert {name: KERNELS[name].launches - c for name, c in n.items()} == \
        {"flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    close_tiles("dq", dq,
               tfa.plain_flash_bwd_dq(q, k, v, do, lse, delta, **kw))
    rdk, rdv = tfa.plain_flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    close_tiles("dk", dk, rdk)
    close_tiles("dv", dv, rdv)
    if rel < 0:
        assert float(dq[:, :-rel].abs().max()) == 0.0


def _card_bwd_inputs(dev, B, T, S, H, K, d, causal, window, rel):
    """q, k, v, dO, the forward's lse, delta with an lse cotangent folded
    in, and the mask options, seeded by the shape."""
    g = torch.Generator(device=dev).manual_seed(T + S + d)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    q, do = rnd(B, T, H, d).bfloat16(), rnd(B, T, H, d).bfloat16()
    k, v = rnd(B, S, K, d).bfloat16(), rnd(B, S, K, d).bfloat16()
    kw = dict(causal=causal, window=window, rel_offset=rel)
    out, lse = tfa.flash_forward(q, k, v, **kw)
    delta = tfa.flash_delta(out, do, 0.1 * rnd(B, H, T))
    return q, k, v, do, lse, delta, kw


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,H,K,d,causal,window,rel", [
    (4, 2048, 2048, 32, 8, 64, True, None, 0),
    (2, 333, 333, 16, 4, 128, True, 40, 0),
    (1, 200, 200, 8, 2, 64, True, 50, -20),
    (2, 333, 333, 16, 4, 96, True, 40, 0),
    (1, 1024, 1024, 8, 8, 256, True, None, 0),
    (1, 200, 200, 8, 2, 256, True, 50, -20)])
def test_kernels_e_f_are_deterministic_on_card(cuda_device, B, T, S, H, K,
                                               d, causal, window, rel):
    """Two launches of E and of F on the same inputs give the same bits:
    neither uses atomics, and F sums each group's query heads in one fixed
    order in registers."""
    q, k, v, do, lse, delta, kw = _card_bwd_inputs(
        cuda_device, B, T, S, H, K, d, causal, window, rel)
    dq = [tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw) for _ in "ab"]
    dkv = [tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw) for _ in "ab"]
    torch.cuda.synchronize()
    assert torch.equal(dq[0], dq[1])
    assert torch.equal(dkv[0][0], dkv[1][0])
    assert torch.equal(dkv[0][1], dkv[1][1])


@pytest.mark.cuda
def test_flash_attention_autograd_on_card_launches_d_e_f(cuda_device):
    """Differentiating flash_attention_lse in both outputs goes through
    kernels D, E and F and agrees with the plain backward."""
    from deepspeed_tpu_torch.ops._build import KERNELS

    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(2, 300, h, 64, generator=g, device=cuda_device)
               .bfloat16().requires_grad_() for h in (16, 4, 4))
    w = torch.randn(2, 300, 16, 64, generator=g,
                    device=cuda_device).bfloat16()
    u = torch.randn(2, 16, 300, generator=g, device=cuda_device)
    n = {name: KERNELS[name].launches
         for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    out, lse = tfa.flash_attention_lse(q, k, v, causal=True)
    ((out.float() * w).sum() + (lse * u).sum()).backward()
    torch.cuda.synchronize()
    assert all(KERNELS[name].launches == c + 1 for name, c in n.items())
    want = tfa.plain_flash_backward(q.detach(), k.detach(), v.detach(),
                                    out.detach(), lse.detach(), w, u)
    for name, got, ref in zip("qkv", (q.grad, k.grad, v.grad), want):
        close_tiles(f"d{name}", got, ref)


def _card_pools(dev, nbp1=65, bs=128, lanes=8 * 128):
    g = torch.Generator(device=dev).manual_seed(0)
    kp = torch.randn(2, nbp1, bs, lanes, generator=g, device=dev).bfloat16()
    vp = torch.randn(2, nbp1, bs, lanes, generator=g, device=dev).bfloat16()
    bt = torch.randperm(nbp1 - 1, generator=g, device=dev).to(torch.int32)
    return kp, vp, bt.reshape(4, 16).contiguous(), g


def _norm(acc, l):
    return (acc / l.clamp_min(1e-30)[..., None]).float()


@pytest.mark.cuda
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
@pytest.mark.parametrize("window", [None, 300])
def test_kernel_a_matches_plain_on_card(cuda_device, window, d):
    kp, vp, bt, g = _card_pools(cuda_device, lanes=8 * d)
    q = torch.randn(6, 32, d, generator=g, device=cuda_device).bfloat16()
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
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
def test_kernel_a_decode_loop_rows_match_plain_on_card(cuda_device, d):
    """Rows of the fused decode loop sit past the pool frontier: the window
    is anchored at ``row_pos`` (> pos0), the pool still ends at pos0."""
    kp, vp, bt, g = _card_pools(cuda_device, lanes=8 * d)
    q = torch.randn(4, 32, d, generator=g, device=cuda_device).bfloat16()
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


# (tq, window) of kernel B's and C's checks: chunk widths 32 to 256, one
# not a multiple of the 64-row tile, windows inside the past and one (1)
# past every pooled column
B_C_CASES = [(256, None), (100, None), (64, 90), (32, None), (32, 40),
             (64, 1), (256, 1)]


def _b_atoms(dev):
    """Kernel B's atoms over ``_card_pools``' 16-block tables: pasts of 256,
    1000 and 5 tokens (pos0 1000 and 5 cut a 64-column tile) and none."""
    return (torch.tensor([0, 2, 3, 1], device=dev),
            torch.tensor([256, 1000, 5, 0], device=dev))


def _check_empty_rows(acc, m, l, rl):
    """Rows with nothing visible (pos0 = 0, a window past every column):
    m = -1e30, l = 0, acc = 0."""
    dead = rl == 0
    assert bool((m[dead] == -1e30).all()) and bool((l[dead] == 0).all())
    assert float(acc[dead].abs().sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
@pytest.mark.parametrize("tq,window", B_C_CASES)
def test_kernels_b_c_match_plain_on_card(cuda_device, tq, window, d):
    kp, vp, bt, g = _card_pools(cuda_device, lanes=8 * d)
    slot, pos0 = _b_atoms(cuda_device)
    A = len(pos0)
    q = torch.randn(A * tq, 32, d, generator=g, device=cuda_device).bfloat16()
    ks = torch.randn(A * tq, 8, d, generator=g, device=cuda_device).bfloat16()
    vs = torch.randn(A * tq, 8, d, generator=g, device=cuda_device).bfloat16()
    alen = torch.tensor([tq, tq - 7, 1, tq], device=cuda_device)
    acc, m, l = tpa.past_partials(q, kp, vp, 0, bt, slot, pos0, tq,
                                  window=window)
    ra, rm, rl = tpa.plain_past_partials(q, kp, vp, 0, bt, slot, pos0, tq,
                                         window=window)
    torch.testing.assert_close(_norm(acc, l), _norm(ra, rl), atol=2e-2,
                               rtol=2e-2)
    live = rl > 0
    torch.testing.assert_close(m[live], rm[live], atol=1e-2, rtol=1e-2)
    _check_empty_rows(acc, m, l, rl)
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
    serving = ("paged_decode", "paged_past", "chunk_self", "flash_fwd")
    assert all(KERNELS[n].launches > 0 for n in serving), \
        {n: k.launches for n, k in KERNELS.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("preset", sorted(PRESET_SHAPED))
def test_head_dim_engine_on_card_matches_plain_cpu_engine(cuda_device, preset,
                                                          kv):
    """The serving path at d = 96 (phi3-mini-shaped) and d = 256
    (pythia-1b-shaped) on the card -- kernels A-D, or A/B's int modes over an
    int8 / int4 pool -- against the same engine on the CPU (plain versions),
    bf16 weights, step by step: logits within 5e-2 (as the test above) at
    every put and at the first step of ``decode_batch``'s fused loop, then
    the ``packed=False`` engine (kernel I) against its CPU twin. An int
    pool is copied from the CPU engine into the card's before each step:
    the two devices' bf16 projections differ in the last bit, which moves a
    K/V element on a rounding boundary of its quantization by a whole step
    (an int4 step is 1/7 of its row's max; without the copy a few logits
    differ by 0.09), so each step holds the kernels on the same pool."""
    import numpy as np

    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset
    from deepspeed_tpu_torch.ops._build import KERNELS, reset_counts

    cfg = get_preset(preset, **PRESET_SHAPED[preset])
    model = TransformerLM(cfg)
    params = model.init(seed=0, device="cpu")
    kw = dict(max_sequences=4, max_seq_len=512, block_size=16, kv_dtype=kv)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, n).astype(np.int32) for n in (5, 40)]
    longp = rng.integers(1, 512, 300).astype(np.int32)   # > MAX_ATOM
    recorded = {"cpu": [], "cuda": []}
    real = model.forward_decode_tail

    def recording(params, toks, *args, **kw):
        logits, tail = real(params, toks, *args, **kw)
        recorded[toks.device.type].append(logits.float().cpu().numpy())
        return logits, tail

    model.forward_decode_tail = recording
    reset_counts()
    engines = {d: InferenceEngineV2(model, params, device=d, **kw)
               for d in ("cpu", "cuda")}
    steps = [lambda e: e.put([0, 1], prompts),
             lambda e: e.put([0, 1, 2], [np.array([7], np.int32),
                                         np.array([9], np.int32), longp]),
             lambda e: e.put([0, 1, 2], [np.array([3], np.int32)] * 3),
             lambda e: e.decode_batch([0, 1, 2], [3, 4, 5], steps=4)]
    out = {}
    for i, step in enumerate(steps):
        if kv != "bf16":
            for name, t in engines["cpu"].cache.items():
                engines["cuda"].cache[name].copy_(t)
        out[i] = {d: step(e) for d, e in engines.items()}
    for i in range(3):
        for uid, lg in out[i]["cpu"].items():
            np.testing.assert_allclose(out[i]["cuda"][uid], lg, atol=5e-2,
                                       rtol=5e-2, err_msg=f"put {i} uid {uid}")
    # the fused loop's first step is fed the same tokens on both devices
    np.testing.assert_allclose(recorded["cuda"][0], recorded["cpu"][0],
                               atol=5e-2, rtol=5e-2)
    suffix = "" if kv == "bf16" else f"_{kv}"
    names = (f"paged_decode{suffix}", f"paged_past{suffix}", "chunk_self",
             "flash_fwd")
    assert all(KERNELS[n].launches > 0 for n in names), \
        {n: k.launches for n, k in KERNELS.items()}
    if kv == "bf16":
        dense = {d: InferenceEngineV2(model, params, device=d, packed=False,
                                      max_sequences=4, max_seq_len=512,
                                      block_size=16).put([0, 1], prompts)
                 for d in ("cpu", "cuda")}
        for uid, lg in dense["cpu"].items():
            np.testing.assert_allclose(dense["cuda"][uid], lg, atol=5e-2,
                                       rtol=5e-2)
        assert KERNELS["paged_tile"].launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("preset", sorted(PRESET_SHAPED))
def test_head_dim_train_steps_on_card_match_the_cpu_engine(cuda_device,
                                                           preset):
    """Two ``train_batch`` steps at d = 96 and d = 256 (the preset-shaped
    models) on the card (kernels D, E, F) and on the CPU, as the test
    below: losses within 2e-2, grad norms within 5e-2 relative."""
    import numpy as np

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch import TransformerLM, get_preset
    from deepspeed_tpu_torch.ops._build import KERNELS, reset_counts

    model = TransformerLM(get_preset(preset, **PRESET_SHAPED[preset]))
    params = model.init(seed=0, device="cpu")
    config = {"train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "gradient_clipping": 1.0, "steps_per_print": 100}
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 512, (2, 200)).astype(np.int32)}
               for _ in range(4)]
    reset_counts()
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = tds.initialize(model, dict(config), model_parameters=params,
                             device=dev)[0]
        it = iter(batches)
        runs[dev] = [(eng.train_batch(it), eng.get_global_grad_norm())
                     for _ in range(2)]
    (cl, cn), (gl, gn) = (np.array(runs[d]).T for d in ("cpu", "cuda"))
    np.testing.assert_allclose(gl, cl, rtol=2e-2)
    np.testing.assert_allclose(gn, cn, rtol=5e-2)
    assert all(KERNELS[n].launches > 0
               for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))


@pytest.mark.cuda
def test_train_steps_on_card_match_the_cpu_engine(cuda_device):
    """Two ``train_batch`` steps of the same engine on the card (attention
    through kernels D, E and F) and on the CPU (plain versions), bf16
    compute from the same fp32 weights: losses within 2e-2 and grad norms
    within 5e-2 relative (bf16 rounding in different places), and each
    kernel launched."""
    import numpy as np

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch import TransformerLM, get_preset
    from deepspeed_tpu_torch.ops._build import KERNELS, reset_counts

    model = TransformerLM(get_preset("tiny", hidden_size=256, num_heads=4,
                                     num_kv_heads=2, max_seq_len=256))
    params = model.init(seed=0, device="cpu")
    config = {"train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "gradient_clipping": 1.0, "steps_per_print": 100}
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 256, (2, 200)).astype(np.int32)}
               for _ in range(4)]
    reset_counts()
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = tds.initialize(model, dict(config), model_parameters=params,
                             device=dev)[0]
        it = iter(batches)
        runs[dev] = [(eng.train_batch(it), eng.get_global_grad_norm())
                     for _ in range(2)]
    (cl, cn), (gl, gn) = (np.array(runs[d]).T for d in ("cpu", "cuda"))
    np.testing.assert_allclose(gl, cl, rtol=2e-2)
    np.testing.assert_allclose(gn, cn, rtol=5e-2)
    assert all(KERNELS[n].launches > 0
               for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))


def _card_qmm_operands(dev, bits, B, D, F, group, layer):
    """x [B, D] and a 4-deep stack (one matrix for ``layer`` None) of
    seeded random weights quantized by the port."""
    from deepspeed_tpu_torch.ops import quant_matmul as tqm

    g = torch.Generator(device=dev).manual_seed(B + D + F + bits)
    L = 1 if layer is None else 4
    ps, ss = [], []
    for _ in range(L):
        w = torch.randn(D, F, generator=g, device=dev) / D ** 0.5
        p, sc = tqm.quantize_matmul_weight(w, bits=bits, group=group)
        ps.append(p)
        ss.append(sc.bfloat16())
    packed, scales = torch.stack(ps), torch.stack(ss)
    if layer is None:
        packed, scales = packed[0], scales[0]
    x = torch.randn(B, D, generator=g, device=dev).bfloat16()
    return x, packed, scales


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,D,F,group,layer", [
    (1, 4096, 4096, 128, None), (6, 4096, 28672, 128, 2),
    (16, 14336, 4096, 128, 1), (17, 512, 384, 256, None),
    (256, 4096, 1024, 128, 0), (200, 256, 128, 128, 3),
    (128, 4096, 4096, 128, 2), (129, 4096, 6144, 128, None),
    (255, 4096, 28672, 128, 3), (256, 14336, 4096, 128, 1),
    # the decode kernel's row tiles at their edges (8 and 16 rows, one
    # row past the first), split and unsplit, and groups of 256 (int4:
    # 128 byte rows a group, the high nibbles 128 rows on)
    (2, 4096, 6144, 128, 3), (8, 4096, 4096, 128, 0),
    (9, 14336, 4096, 128, 2), (15, 4096, 28672, 128, None),
    (6, 4096, 4096, 256, 1), (16, 4096, 6144, 256, None),
    (3, 512, 384, 256, 2)])
def test_kernels_g_h_match_plain_on_card(cuda_device, bits, B, D, F, group,
                                         layer):
    """G (one matrix) and H (layer of a 4-deep stack): the decode kernel
    (B <= 16, at B = 1, 2, 6, 8, 9, 15, 16) and the 128-row tile kernel at
    its edges (one full tile, one row past it, one row short of two), split
    and unsplit contractions (w_down at B=256 splits; at B <= 16 every
    product narrower than the card), groups of 128 and 256. Past 64 rows
    the output is held per 64-row tile too, so a fault in a later row tile
    cannot hide under the tensor-wide tolerance."""
    from deepspeed_tpu_torch.ops import quant_matmul as tqm
    from deepspeed_tpu_torch.ops._build import KERNELS

    x, packed, scales = _card_qmm_operands(cuda_device, bits, B, D, F, group,
                                           layer)
    name = "qmm" if layer is None else "qmm_stacked"
    n = KERNELS[name].launches
    out = tqm.quantized_matmul(x, packed, scales, bits=bits, layer=layer)
    torch.cuda.synchronize()
    assert KERNELS[name].launches == n + 1
    ref = tqm.plain_quantized_matmul(x, packed, scales, bits, layer)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    if B > 64:
        close_tiles(f"G/H int{bits} B={B}", out.view(1, B, 1, F),
                    ref.view(1, B, 1, F))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,D,F", [(256, 4096, 28672), (256, 14336, 4096),
                                   (6, 14336, 4096), (6, 4096, 4096),
                                   (6, 4096, 28672)])
def test_kernel_h_is_deterministic_on_card(cuda_device, bits, B, D, F):
    """Two launches on the same inputs give the same bits, with the
    contraction unsplit (w_gateup at B=256 and B=6) and split: at B=256
    (w_down) a second kernel adds the splits in order, at B=6 (w_down in 7
    splits, wo in 8) the last CTA of each column tile does, behind a ticket
    that it resets for the next launch; never atomics on the sums."""
    from deepspeed_tpu_torch.ops import quant_matmul as tqm

    want = {(256, 4096): 2, (256, 28672): 1, (6, 4096): 7 if D > 4096 else 8,
            (6, 28672): 1}[B, F]
    assert tqm.qmm_splits(B, F, D // 128) == want
    x, packed, scales = _card_qmm_operands(cuda_device, bits, B, D, F, 128,
                                           1)
    a = tqm.quantized_matmul(x, packed, scales, bits=bits, layer=1)
    b = tqm.quantized_matmul(x, packed, scales, bits=bits, layer=1)
    c = tqm.quantized_matmul(x, packed, scales, bits=bits, layer=1)
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,D,F,layer", [
    (6, 4096, 65536, None), (6, 14336, 4096, 1), (16, 4096, 6144, 2),
    (1, 4096, 28672, 0)])
def test_decode_call_is_one_launch_on_card(cuda_device, bits, B, D, F,
                                           layer):
    """One G/H call at B <= 16 is one kernel on the card, split or not (the
    splits are added inside the kernel): counted by ``torch.profiler``,
    since the ``Kernel`` record counts wrapper calls only."""
    from chip_smoke import device_launches
    from deepspeed_tpu_torch.ops import quant_matmul as tqm

    x, packed, scales = _card_qmm_operands(cuda_device, bits, B, D, F, 128,
                                           layer)
    tqm.quantized_matmul(x, packed, scales, bits=bits, layer=layer)
    assert device_launches(torch, lambda: tqm.quantized_matmul(
        x, packed, scales, bits=bits, layer=layer)) == 1


def _card_quant_pools(dev, bits, nbp1=65, bs=128, K=8, d=128):
    """int pools filled through the port's append (every slot and
    position), rows of varied amplitude."""
    from deepspeed_tpu_torch.ops.paged_attention import packed_kv_append_quant

    g = torch.Generator(device=dev).manual_seed(bits)
    bt = torch.randperm(nbp1 - 1, generator=g, device=dev).to(torch.int32)
    bt = bt.reshape(4, 16).contiguous()
    lanes = K * d // (2 if bits == 4 else 1)
    pools = [torch.zeros(2, nbp1, bs, lanes, dtype=torch.int8, device=dev)
             for _ in "kv"]
    scale = torch.zeros(2, nbp1, 1, 2 * bs, device=dev)
    slot = torch.arange(4, device=dev).repeat_interleave(16 * bs)
    pos = torch.arange(16 * bs, device=dev).repeat(4)
    for which, pool in enumerate(pools):
        rows = torch.randn(2, len(slot), K, d, generator=g, device=dev)
        rows = rows * (0.2 + 3 * torch.rand(2, len(slot), 1, 1, generator=g,
                                            device=dev))
        packed_kv_append_quant(pool, scale, rows, bt, slot, pos, which,
                               bits=bits)
    return pools[0], pools[1], scale, bt, g


@pytest.mark.cuda
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("window,shift", [(None, 0), (300, 0), (256, 9)])
def test_kernel_a_int_modes_match_plain_on_card(cuda_device, bits, window,
                                                shift, d):
    from deepspeed_tpu_torch.ops._build import KERNELS

    kp, vp, sc, bt, g = _card_quant_pools(cuda_device, bits, d=d)
    q = torch.randn(6, 32, d, generator=g, device=cuda_device).bfloat16()
    slot = torch.tensor([0, 1, 2, 3, 0, 1], device=cuda_device)
    pos0 = torch.tensor([0, 1, 129, 700, 2047, 64], device=cuda_device)
    row = pos0 + shift
    kw = dict(window=window, row_pos=row, kv_scale=sc, kv_bits=bits)
    name = f"paged_decode_int{bits}"
    n = KERNELS[name].launches
    acc, m, l = tpa.decode_pool_partials(q, kp, vp, 1, bt, slot, pos0, **kw)
    torch.cuda.synchronize()
    assert KERNELS[name].launches == n + 1
    ra, rm, rl = tpa.plain_decode_partials(q, kp, vp, 1, bt, slot, pos0, **kw)
    live = rl > 0
    torch.testing.assert_close(_norm(acc, l)[live], _norm(ra, rl)[live],
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(m[live], rm[live], atol=1e-2, rtol=1e-2)
    assert float(l[~live].abs().sum()) == 0.0


def _card_decode_case(dev, bits, H, K, d, window):
    """Kernel A's atoms over a 16-block table of 128-row blocks: pasts of 1
    token, exactly one block, one before and one after a block edge, 2047
    (all sixteen splits), none, and two of the serve phase's; under a
    window, rows advanced past the frontier. Returns (args, kwargs) of
    ``decode_pool_partials``."""
    if bits == 16:
        kp, vp, bt, g = _card_pools(dev, lanes=K * d)
        kw = {}
    else:
        kp, vp, sc, bt, g = _card_quant_pools(dev, bits, K=K, d=d)
        kw = dict(kv_scale=sc, kv_bits=bits)
    q = torch.randn(8, H, d, generator=g, device=dev).bfloat16()
    slot = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3], device=dev)
    pos0 = torch.tensor([1, 128, 127, 129, 2047, 0, 700, 301], device=dev)
    shift = 0 if window is None else torch.tensor([0, 5, 1, 9, 0, 3, 31, 2],
                                                  device=dev)
    kw.update(window=window, row_pos=pos0 + shift)
    return (q, kp, vp, 1, bt, slot, pos0), kw


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
@pytest.mark.parametrize("H,K", [(32, 8), (8, 8), (32, 4), (16, 1), (12, 3),
                                 (40, 2), (32, 32)])
@pytest.mark.parametrize("window", [None, 256])
def test_kernel_a_splits_match_plain_on_card(cuda_device, bits, d, H, K,
                                             window):
    """Kernel A in each pool mode (one launch a call) at every head dim,
    against the plain version: H/K = 4, 1, 8 and 16 (int4 with even K and
    H/K <= 8 pairs two kv heads a CTA; K = 1 and K = 3 read one nibble, and
    a K = 3 head's features straddle the nibble halves), 20 (two 16-head
    CTAs a group), and phi3-mini's H = K = 32 (pythia-1b's is H = K = 8);
    acc / l at 2e-2 and l at relative 2e-2, m at 1e-2; atoms with nothing
    visible give m = -1e30, l = 0, acc = 0."""
    from deepspeed_tpu_torch.ops._build import KERNELS

    args, kw = _card_decode_case(cuda_device, bits, H, K, d, window)
    name = "paged_decode" if bits == 16 else f"paged_decode_int{bits}"
    n = KERNELS[name].launches
    acc, m, l = tpa.decode_pool_partials(*args, **kw)
    torch.cuda.synchronize()
    assert KERNELS[name].launches == n + 1
    ra, rm, rl = tpa.plain_decode_partials(*args, **kw)
    live = rl > 0
    torch.testing.assert_close(_norm(acc, l)[live], _norm(ra, rl)[live],
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(l[live], rl[live], atol=0, rtol=2e-2)
    torch.testing.assert_close(m[live], rm[live], atol=1e-2, rtol=1e-2)
    assert bool((m[~live] == -1e30).all()) and bool((l[~live] == 0).all())
    assert float(acc[~live].abs().sum()) == 0.0
    assert int((~live).sum()) >= H                 # the empty atom


@pytest.mark.cuda
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
def test_kernel_a_int8_q_hat_is_the_wrappers_on_card(cuda_device, d):
    """The int8 mode's in-kernel q-hat: m within relative 1e-4 of the plain
    version's (which takes ``_quantize_q_rows``), where one q element off by
    one moves a score by ~1e-3 of it."""
    args, kw = _card_decode_case(cuda_device, 8, 32, 8, d, None)
    _, m, _ = tpa.decode_pool_partials(*args, **kw)
    _, rm, rl = tpa.plain_decode_partials(*args, **kw)
    live = rl > 0
    torch.testing.assert_close(m[live], rm[live], atol=1e-6, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("window", [None, 256])
def test_kernel_a_is_deterministic_on_card(cuda_device, bits, window, d):
    """Two launches give the same bits: the splits merge in split order
    behind one ticket, whichever CTA finishes last."""
    args, kw = _card_decode_case(cuda_device, bits, 32, 8, d, window)
    first = tpa.decode_pool_partials(*args, **kw)
    second = tpa.decode_pool_partials(*args, **kw)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tq,window", B_C_CASES)
def test_kernel_b_int_modes_match_plain_on_card(cuda_device, bits, tq,
                                                window, d):
    from deepspeed_tpu_torch.ops._build import KERNELS

    kp, vp, sc, bt, g = _card_quant_pools(cuda_device, bits, d=d)
    slot, pos0 = _b_atoms(cuda_device)
    q = torch.randn(len(pos0) * tq, 32, d, generator=g,
                    device=cuda_device).bfloat16()
    kw = dict(window=window, kv_scale=sc, kv_bits=bits)
    name = f"paged_past_int{bits}"
    n = KERNELS[name].launches
    acc, m, l = tpa.past_partials(q, kp, vp, 0, bt, slot, pos0, tq, **kw)
    torch.cuda.synchronize()
    assert KERNELS[name].launches == n + 1
    ra, rm, rl = tpa.plain_past_partials(q, kp, vp, 0, bt, slot, pos0, tq,
                                         **kw)
    torch.testing.assert_close(_norm(acc, l), _norm(ra, rl), atol=2e-2,
                               rtol=2e-2)
    live = rl > 0
    torch.testing.assert_close(m[live], rm[live], atol=1e-2, rtol=1e-2)
    _check_empty_rows(acc, m, l, rl)


@pytest.mark.cuda
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H,K", [(16, 1), (12, 3), (8, 8)])
def test_kernel_b_int_modes_at_other_groups_match_plain_on_card(
        cuda_device, bits, H, K, d):
    """Kernel B's int modes with one and three kv heads (an int4 head's
    features straddle the nibble halves: each 16-feature chunk picks its
    own nibble) and with H = K, against the plain version."""
    kp, vp, sc, bt, g = _card_quant_pools(cuda_device, bits, K=K, d=d)
    slot, pos0 = _b_atoms(cuda_device)
    tq = 64
    q = torch.randn(len(pos0) * tq, H, d, generator=g,
                    device=cuda_device).bfloat16()
    kw = dict(kv_scale=sc, kv_bits=bits)
    acc, m, l = tpa.past_partials(q, kp, vp, 0, bt, slot, pos0, tq, **kw)
    ra, rm, rl = tpa.plain_past_partials(q, kp, vp, 0, bt, slot, pos0, tq,
                                         **kw)
    torch.testing.assert_close(_norm(acc, l), _norm(ra, rl), atol=2e-2,
                               rtol=2e-2)
    live = rl > 0
    torch.testing.assert_close(m[live], rm[live], atol=1e-2, rtol=1e-2)
    _check_empty_rows(acc, m, l, rl)


@pytest.mark.cuda
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("window", [None, 90])
def test_kernels_b_c_are_one_deterministic_launch_on_card(cuda_device, bits,
                                                          window, d):
    """Kernel B in each pool mode, and kernel C seeded from it: one launch
    on the card a call (the profiler's count: the live ranges come from the
    kernel, not the wrapper), and a second launch gives the same bits."""
    from chip_smoke import device_launches

    if bits == 16:
        kp, vp, bt, g = _card_pools(cuda_device, lanes=8 * d)
        kw = {}
    else:
        kp, vp, sc, bt, g = _card_quant_pools(cuda_device, bits, d=d)
        kw = dict(kv_scale=sc, kv_bits=bits)
    tq = 100
    slot, pos0 = (x.to(torch.int32) for x in _b_atoms(cuda_device))
    A = len(pos0)
    q = torch.randn(A * tq, 32, d, generator=g, device=cuda_device).bfloat16()
    ks, vs = (torch.randn(A * tq, 8, d, generator=g, device=cuda_device)
              .bfloat16() for _ in "kv")
    alen = torch.tensor([tq, tq - 7, 1, tq], dtype=torch.int32,
                        device=cuda_device)

    def past():
        return tpa.past_partials(q, kp, vp, 0, bt, slot, pos0, tq,
                                 window=window, **kw)

    seed = past()

    def self_():
        return tpa.self_attention(q, ks, vs, alen, tq, seed, window=window)

    for call in (past, self_):
        first, second = call(), call()
        for x, y in zip(first if isinstance(first, tuple) else (first,),
                        second if isinstance(second, tuple) else (second,)):
            assert torch.equal(x, y)
        assert device_launches(torch, call) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
@pytest.mark.parametrize("P", [256, 512, 768])
def test_kernels_b_then_c_equal_kernel_d_bitwise_on_card(cuda_device, P, d):
    """A prompt of 1024 tokens whose first P tokens' K/V sit in a bf16 pool
    behind a shuffled block table: kernel B over the next 256 rows at
    pos0 = P, then kernel C seeded from B's partials, gives kernel D's bits
    for those rows of the whole prompt (no window). B walks D's 64-column
    tiles over the past and C continues D's walk from B's fp32 state: the
    property the serving engine's chunked-vs-whole gate rests on."""
    T, H, K, bs, tq = 1024, 32, 8, 128, 256
    g = torch.Generator(device=cuda_device).manual_seed(P + d)
    q = torch.randn(1, T, H, d, generator=g, device=cuda_device).bfloat16()
    k, v = (torch.randn(1, T, K, d, generator=g, device=cuda_device)
            .bfloat16() for _ in "kv")
    want, _ = tfa.flash_forward(q, k, v, causal=True)
    nb_max, nbp1 = T // bs, 2 * T // bs + 1
    bt = torch.randperm(nbp1 - 1, generator=g, device=cuda_device)[:nb_max]
    bt = bt.to(torch.int32).reshape(1, nb_max).contiguous()
    kp, vp = (torch.zeros(2, nbp1, bs, K * d, dtype=torch.bfloat16,
                          device=cuda_device) for _ in "kv")
    live = bt[0, :P // bs].long()
    kp[1, live] = k[0, :P].reshape(P // bs, bs, K * d)
    vp[1, live] = v[0, :P].reshape(P // bs, bs, K * d)
    slot = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    pos0 = torch.full((1,), P, dtype=torch.int32, device=cuda_device)
    rows = slice(P, P + tq)
    seed = tpa.past_partials(q[0, rows].contiguous(), kp, vp, 1, bt, slot,
                             pos0, tq)
    alen = torch.full((1,), tq, dtype=torch.int32, device=cuda_device)
    out = tpa.self_attention(q[0, rows].contiguous(),
                             k[0, rows].contiguous(), v[0, rows].contiguous(),
                             alen, tq, seed)
    torch.cuda.synchronize()
    assert torch.equal(out, want[0, rows])


@pytest.mark.cuda
@pytest.mark.parametrize("wd,kd", [("int4", "int8"), ("int8", "int4")])
def test_quant_engine_on_card_matches_plain_cpu_engine(cuda_device, wd, kd):
    """The quantized serving path on the card (G/H and A/B's int modes)
    against the same engine on the CPU (plain versions): the same bf16
    weights quantize to the same tree on both; logits within 5e-2 (bf16
    rounding of a 2-layer model whose logits are O(1)), and every kernel of
    the pair launched."""
    import numpy as np

    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset
    from deepspeed_tpu_torch.ops._build import KERNELS, reset_counts

    cfg = get_preset("tiny", hidden_size=256, num_heads=4, num_kv_heads=2,
                     max_seq_len=512)
    model = TransformerLM(cfg)
    params = model.init(seed=0, device="cpu")
    kw = dict(max_sequences=4, max_seq_len=512, block_size=16,
              weight_dtype=wd, kv_dtype=kd)
    engines = {d: InferenceEngineV2(model, params, device=d, **kw)
               for d in ("cpu", "cuda")}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (5, 40)]
    longp = rng.integers(1, 256, 300).astype(np.int32)   # > MAX_ATOM
    reset_counts()
    out = {}
    for d, eng in engines.items():
        a = eng.put([0, 1], prompts)
        b = eng.put([0, 1, 2], [np.array([7], np.int32),
                                np.array([9], np.int32), longp])
        c = eng.put([0, 1, 2], [np.array([3], np.int32)] * 3)
        out[d] = (a, b, c)
    for step in range(3):
        for uid, lg in out["cpu"][step].items():
            np.testing.assert_allclose(out["cuda"][step][uid], lg, atol=5e-2,
                                       rtol=5e-2)
    names = ("qmm", "qmm_stacked", f"paged_decode_{kd}", f"paged_past_{kd}")
    assert all(KERNELS[n].launches > 0 for n in names), \
        {n: k.launches for n, k in KERNELS.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
@pytest.mark.parametrize("t,pos,window,H", [
    (1, [38, 129, 2047, 0], None, 32),      # decode rows
    (1, [38, 129, 2047, 0], 300, 32),
    (4, [38, 129, 2045, 0], None, 32),      # t rep = 16: the decode regime
    (4, [38, 129, 2045, 0], 40, 32),
    (5, [38, 129, 2045, 0], None, 32),      # t rep = 20: the flash regime
    (5, [38, 129, 2045, 0], 40, 32),
    (16, [38, 129, 2040, 0], None, 8),      # rep 1: t = 16, the decode regime
    (16, [38, 129, 2040, 0], 7, 8),
    (17, [38, 129, 2040, 0], None, 8),      # rep 1: t = 17, the flash regime
    (17, [38, 129, 2040, 0], 7, 8),
    (700, [0, 1, 1500, 1800], None, 32),    # deep slots: padded rows pass 2048
    (100, [0, 64, 700, 1999], 90, 32),
    (13, [5, 0, 2040, 300], 1, 32)])
def test_kernel_i_matches_plain_on_card(cuda_device, t, pos, window, H, d):
    """Kernel I over the stacked pool at layer 1, H query heads over 8 kv
    heads, on both sides of the boundary between its regimes (t rep <= 16:
    the decode regime); rows whose positions pass the 16-block table
    included (both give a finite value there, 0 where nothing is visible).
    Held per 64-row tile, slot and head: late causal rows are small. One
    launch on the card a call (the profiler's count), and a second launch
    gives the same bits."""
    from chip_smoke import device_launches
    from deepspeed_tpu_torch.ops._build import KERNELS

    kp, vp, bt, g = _card_pools(cuda_device, lanes=8 * d)
    q = torch.randn(4, t, H, d, generator=g, device=cuda_device).bfloat16()
    ps = torch.tensor(pos, dtype=torch.int32, device=cuda_device)

    def call():
        return tpa.paged_attention(q, kp, vp, bt, ps, window=window, layer=1)

    n = KERNELS["paged_tile"].launches
    out = call()
    torch.cuda.synchronize()
    assert KERNELS["paged_tile"].launches == n + 1
    ref = tpa.plain_paged_attention(q, kp, vp, bt, ps, window=window, layer=1)
    close_tiles("I out", out, ref)
    assert torch.equal(call(), out)
    assert device_launches(torch, call) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", CARD_HEAD_DIMS)
def test_kernel_i_at_pos_0_equals_kernel_d_bitwise_on_card(cuda_device, d):
    """Kernel I's flash regime runs kernel D's tile body on the same tiles
    in the same order: a tile from position 0 over K/V in the pool gives D's
    bits on the same K/V laid out dense."""
    kp, vp, bt, g = _card_pools(cuda_device, lanes=8 * d)
    t = 333
    q = torch.randn(4, t, 32, d, generator=g, device=cuda_device).bfloat16()
    ps = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    out = tpa.paged_attention(q, kp, vp, bt, ps, layer=1)

    def dense(pool):
        return pool[1][bt.long()].reshape(4, -1, 8, d)[:, :t].contiguous()

    want, _ = tfa.flash_attention_lse(q, dense(kp), dense(vp), causal=True)
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt,shape", [
    (torch.bfloat16, torch.bfloat16, (4096, 4096)),
    (torch.bfloat16, torch.bfloat16, (2, 3, 4096)),
    (torch.float32, torch.float32, (4096, 4096)),
    (torch.bfloat16, torch.float32, (5, 2048)),
    (torch.float32, torch.bfloat16, (7, 136))])
def test_kernel_j_matches_plain_on_card(cuda_device, xdt, wdt, shape):
    """Kernel J's forward, and the gradients of ``fused_rms_norm`` (kernel
    J forward, closed-form backward) against autograd through the plain
    version."""
    from deepspeed_tpu_torch.ops import rms_norm as trn
    from deepspeed_tpu_torch.ops._build import KERNELS

    g = torch.Generator(device=cuda_device).manual_seed(shape[-1])
    D = shape[-1]
    x = (2 * torch.randn(*shape, generator=g, device=cuda_device)).to(xdt)
    w = (1 + 0.3 * torch.randn(D, generator=g, device=cuda_device)).to(wdt)
    gy = torch.randn(*shape, generator=g, device=cuda_device)
    tol = (dict(atol=1e-2, rtol=1e-2) if torch.bfloat16 in (xdt, wdt)
           else dict(atol=1e-5, rtol=1e-5))
    grads = []
    n = KERNELS["rms_norm"].launches
    for fn in (trn.fused_rms_norm,
               lambda a, b: trn.plain_rms_norm(a.reshape(-1, D), b)
               .reshape(a.shape)):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xx, ww)
        (y.float() * gy).sum().backward()
        grads.append((y.detach(), xx.grad, ww.grad))
    torch.cuda.synchronize()
    assert KERNELS["rms_norm"].launches == n + 1
    assert grads[0][0].dtype == xdt
    for got, want in zip(*grads):
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,offset", [(65536, 0), (65536, 1000),
                                         (128, 1)])
def test_kernel_k_matches_plain_on_card(cuda_device, rows, offset):
    from deepspeed_tpu_torch.ops._build import KERNELS
    from deepspeed_tpu_torch.tools import hbm_bandwidth as hb

    x = torch.arange(rows * hb.ROW, dtype=torch.float32,
                     device=cuda_device).reshape(rows, hb.ROW)
    x[1::7] *= -0.5                       # not a sum of one sign only
    n = KERNELS["hbm_stream"].launches
    got = hb.hbm_stream(x, offset)
    torch.cuda.synchronize()
    assert KERNELS["hbm_stream"].launches == n + 1
    want = hb.plain_hbm_stream(x, offset)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert float(hb.hbm_stream(x, offset + 5)) == float(got)
