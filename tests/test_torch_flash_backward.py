"""Flash attention backward of the PyTorch port against the JAX package's
Pallas backward in interpret mode (fp32 on the CPU, atol = rtol = 1e-5):
``plain_flash_backward`` against ``_bwd_pallas`` on the same out/lse/dO,
and the port's autograd path against ``jax.grad`` of ``flash_attention_lse``
/ ``flash_attention``. The card's kernels E and F are held against their
plain versions in ``test_torch_kernels_cuda.py``.

Only rows that see something are compared where the TPU kernels leave
don't-care values: with ``rel_offset < 0`` the first rows see no key, the
Pallas kernels compute p = exp(-1e30 + 1e30) = 1 there, and the port writes
zeros. Those rows get dO = 0 and dlse = 0, which keeps the TPU's dk/dv clean
of them."""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=1e-5, rtol=1e-5)

# B, T, S, H, K, d, causal, window, rel_offset, with an lse cotangent
CASES = [
    (2, 32, 32, 4, 4, 16, True, None, 0, False),     # rep 1
    (2, 32, 32, 4, 2, 16, True, None, 0, True),      # rep 2, dlse
    (1, 40, 40, 8, 2, 16, True, None, 0, False),     # rep 4, T % 64 != 0
    (2, 32, 32, 4, 1, 16, False, None, 0, True),     # non-causal
    (1, 48, 48, 4, 2, 16, True, 7, 0, False),        # window
    (1, 16, 48, 4, 2, 16, True, None, 16, True),     # rel_offset
    (1, 16, 48, 4, 2, 16, True, 20, 16, False),      # rel_offset + window
    (1, 24, 24, 4, 2, 16, True, None, -8, True),     # rows that see nothing
    (1, 70, 70, 4, 2, 8, True, None, 0, True),       # T > 64, ragged
]
IDS = [f"T{c[1]}S{c[2]}H{c[3]}K{c[4]}-{'c' if c[6] else 'nc'}-w{c[7]}-r{c[8]}"
       f"{'-dlse' if c[9] else ''}" for c in CASES]


def _inputs(case, seed=0):
    B, T, S, H, K, d, causal, window, rel, with_dlse = case
    rng = np.random.default_rng(seed + T + S + H)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, do = f(B, T, H, d), f(B, S, K, d), f(B, S, K, d), f(B, T, H, d)
    dlse = 0.5 * f(B, H, T) if with_dlse else None
    blind = max(0, -rel)              # rows that see no key
    do[:, :blind] = 0.0
    if dlse is not None:
        dlse[:, :, :blind] = 0.0
    return q, k, v, do, dlse, blind


def _t(x):
    return x.transpose(0, 2, 1, 3)


def _jax_bwd(q, k, v, do, dlse, T, S, causal, window, rel):
    """The reference's forward and backward Pallas calls, model layout."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt, dot = (jnp.asarray(_t(x)) for x in (q, k, v, do))
    kw = dict(scale=scale, causal=causal, window=window, block_q=T,
              block_k=S, interpret=True, rel_offset=rel)
    out, lse = jfa._fwd_pallas(qt, kt, vt, **kw)
    dq, dk, dv = jfa._bwd_pallas(
        qt, kt, vt, out, lse, dot,
        dlse=None if dlse is None else jnp.asarray(dlse)[..., None], **kw)
    return (_t(np.asarray(out)), np.asarray(lse)[..., 0],
            *(_t(np.asarray(g)) for g in (dq, dk, dv)))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_pallas(case):
    B, T, S, H, K, d, causal, window, rel, _ = case
    q, k, v, do, dlse, blind = _inputs(case)
    out, lse, dq, dk, dv = _jax_bwd(q, k, v, do, dlse, T, S, causal, window,
                                    rel)

    def t(x):
        return torch.from_numpy(np.array(x))

    got = tfa.plain_flash_backward(
        t(q), t(k), t(v), t(out), t(lse), t(do),
        None if dlse is None else t(dlse), causal=causal, window=window,
        rel_offset=rel)
    np.testing.assert_allclose(got[0].numpy()[:, blind:], dq[:, blind:], **TOL)
    np.testing.assert_allclose(got[1].numpy(), dk, **TOL)
    np.testing.assert_allclose(got[2].numpy(), dv, **TOL)
    # the kernel wrappers take the plain versions on CPU tensors
    delta = tfa.flash_delta(t(out), t(do), None if dlse is None else t(dlse))
    kw = dict(causal=causal, window=window, rel_offset=rel)
    np.testing.assert_array_equal(
        tfa.flash_bwd_dq(t(q), t(k), t(v), t(do), t(lse), delta, **kw).numpy(),
        got[0].numpy())
    for a, b in zip(tfa.flash_bwd_dkv(t(q), t(k), t(v), t(do), t(lse), delta,
                                      **kw), got[1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_plain_backward_zeros_rows_that_see_nothing():
    """exp(s - lse) with s = lse = -1e30 is 1 in fp32: the plain backward
    must mask p = 0 explicitly, so a row that sees no key gets dq = 0 and
    adds nothing to dk/dv, whatever its dO."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((1, 8, 2, 8), (1, 8, 2, 8), (1, 8, 2, 8),
                             (1, 8, 2, 8)))
    out, lse = tfa.plain_flash_forward(q, k, v, rel_offset=-3)
    dq, dk, dv = tfa.plain_flash_backward(q, k, v, out, lse, do,
                                          rel_offset=-3)
    assert float(dq[:, :3].abs().max()) == 0.0
    do2 = do.clone()
    do2[:, :3] = 100.0
    dq2, dk2, dv2 = tfa.plain_flash_backward(q, k, v, out, lse, do2,
                                             rel_offset=-3)
    torch.testing.assert_close(dk2, dk, atol=0, rtol=0)
    torch.testing.assert_close(dv2, dv, atol=0, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_matches_jax_grad(case):
    """d/d(q, k, v) of sum(out * W) + sum(lse * U) through the port's
    autograd function against ``jax.grad`` of the reference's
    ``flash_attention_lse`` in interpret mode."""
    B, T, S, H, K, d, causal, window, rel, with_dlse = case
    q, k, v, w, u, blind = _inputs(case, seed=1)
    if u is None:
        u = np.zeros((B, H, T), np.float32)
    kw = dict(causal=causal, window=window, rel_offset=rel)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_lse(q, k, v, interpret=True, **kw)
        return jnp.sum(o * w) + jnp.sum(lse[..., 0] * u)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention_lse(tq, tk, tv, **kw)
    ((o * torch.from_numpy(w)).sum()
     + (lse * torch.from_numpy(u)).sum()).backward()
    np.testing.assert_allclose(tq.grad.numpy()[:, blind:],
                               np.asarray(want[0])[:, blind:], **TOL)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want[2]), **TOL)


@pytest.mark.parametrize("window,K", [(None, 2), (5, 1)])
def test_flash_attention_grad_matches_jax(window, K):
    """``flash_attention`` (out only: the lse cotangent never arrives)."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, K, 16)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal(q.shape).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, window=window, interpret=True) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (tfa.flash_attention(*ts, window=window) * torch.from_numpy(w)).sum() \
        .backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def test_backward_kernel_args_reject_unsupported_head_dim():
    q = torch.zeros(1, 4, 2, 32)
    k = torch.zeros(1, 4, 2, 32)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_bwd_kernel_args(q, k, k, q, lse, lse, part="dq")


def test_kernels_e_f_source_keep_s_and_dp_in_registers():
    """No wmma (whose fragments go through shared memory for S, dP and the
    accumulators): mma.sync on ldmatrix fragments, a cp.async ring with the
    row statistics copied 4 bytes at a time, no atomics (two launches give
    the same bits), and the kernel names the profiler tools read."""
    from tests.test_torch_flash_forward import source_code

    code = source_code("flash_backward.cu")
    assert "wmma" not in code and "mma.h" not in code
    assert "flash_tile.cuh" not in code and "atomic" not in code
    for needle in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "ldmatrix.sync.aligned.m8n8.x4.shared.b16",
                   "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                   "cp.async.cg.shared.global", "cp.async.ca.shared.global",
                   "cp.async.wait_group", "flash_bwd_dq_kernel(",
                   "flash_bwd_dkv_kernel(", "dst_flash_bwd_dq_smem_bytes",
                   "dst_flash_bwd_dkv_smem_bytes"):
        assert needle in code, needle


@pytest.mark.parametrize("kernel,lib", [("flash_bwd_dq", "flash_backward"),
                                        ("flash_bwd_dkv", "flash_backward"),
                                        ("flash_fwd", "flash_forward")])
def test_chip_smoke_reads_ptxas_of_each_flash_kernel(kernel, lib):
    """chip_smoke prints (and fails on a spill of) each flash kernel's ptxas
    report per head dim: its pattern must find every instantiation's mangled
    name (d = 64, 96, 128 and 256), and no other kernel's."""
    import chip_smoke
    from deepspeed_tpu_torch.ops import CARD_HEAD_DIMS

    row = next(r for r in chip_smoke.PTXAS_REPORTS if r[1] == kernel)
    assert row[0] == lib and row[3] == CARD_HEAD_DIMS
    args = {"flash_fwd": "FwdArgs"}.get(kernel, "BwdArgs")
    names = {d: f"_ZN3dst{len(kernel) + 7}{kernel}_kernelILi{d}EEEvNS_"
                f"{len(args)}{args}E" for d in CARD_HEAD_DIMS}
    for d, name in names.items():
        assert re.search(row[2], name).group(1) == str(d)
    others = [r[2] for r in chip_smoke.PTXAS_REPORTS if r[1] != kernel]
    assert not any(re.search(p, n) for p in others for n in names.values())


def test_flash_bwd_time_refuses_to_run_without_a_card(monkeypatch):
    """The timing tool measures the card only: without one it stops before
    it builds or times anything, rather than timing the plain versions."""
    from deepspeed_tpu_torch.tools import flash_bwd_time

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        flash_bwd_time.main()
