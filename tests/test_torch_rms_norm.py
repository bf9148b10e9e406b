"""The port's ``fused_rms_norm`` (kernel J's op) against the JAX package's
(its Pallas ``_rms_kernel`` in interpret mode, custom VJP) on the CPU:
forward and the gradients of x and the weight (``jax.grad`` against
autograd) over a [2, 6, 64] input, in fp32 (atol = rtol = 1e-5) and bf16
(1e-2: both round the same fp32 results to bf16, so they differ by at most
one bf16 ulp). The op-builder registry lists the reference's op names.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import ops as jops
from deepspeed_tpu.ops.rms_norm import fused_rms_norm as jax_rms
from deepspeed_tpu_torch import ops as tops
from deepspeed_tpu_torch.ops.rms_norm import fused_rms_norm, plain_rms_norm
from tests._torch_threads import one_torch_thread  # noqa: F401

TOLS = {"float32": dict(atol=1e-5, rtol=1e-5),
        "bfloat16": dict(atol=1e-2, rtol=1e-2)}


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32) * 2.0
    w = (1.0 + 0.3 * rng.standard_normal(64)).astype(np.float32)
    g = rng.standard_normal((2, 6, 64)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    return ((jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(g, jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
             torch.from_numpy(g).to(tdt)))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_grads_match_jax(dtype):
    (jx, jw, jg), (tx, tw, tg) = _inputs(dtype)
    tol = TOLS[dtype]
    want = jax_rms(jx, jw, 1e-5)
    jdx, jdw = jax.grad(
        lambda x, w: jnp.sum((jax_rms(x, w, 1e-5) * jg).astype(jnp.float32)),
        argnums=(0, 1))(jx, jw)
    tx.requires_grad_()
    tw.requires_grad_()
    got = fused_rms_norm(tx, tw, 1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    (got.float() * tg.float()).sum().backward()
    np.testing.assert_allclose(got.detach().float().numpy(), _f32(want),
                               **tol)
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == tw.dtype
    np.testing.assert_allclose(tx.grad.float().numpy(), _f32(jdx), **tol)
    np.testing.assert_allclose(tw.grad.float().numpy(), _f32(jdw), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_closed_form_backward_matches_autograd_of_the_plain_version(dtype):
    """The custom backward (the reference's closed form) against autograd
    through :func:`plain_rms_norm`: what the card tests hold kernel J's
    gradients to."""
    _, (tx, tw, tg) = _inputs(dtype, seed=1)
    grads = []
    for fn in (lambda x, w: fused_rms_norm(x, w),
               lambda x, w: plain_rms_norm(x.reshape(-1, 64), w)
               .reshape(x.shape)):
        x, w = tx.clone().requires_grad_(), tw.clone().requires_grad_()
        (fn(x, w).float() * tg.float()).sum().backward()
        grads.append((x.grad.float(), w.grad.float()))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **TOLS[dtype])


def test_the_registry_lists_the_reference_ops():
    # the reference's registry, then its native AIO and host Adam builders
    # (``deepspeed_tpu/ops/op_builder.AsyncIOBuilder`` and
    # ``CPUAdamBuilder``) as ``async_io`` and ``cpu_adam``
    want = list(jops.ALL_OPS) + ["async_io", "cpu_adam"]
    assert list(tops.ALL_OPS) == want
    assert [n for n, _ in tops.op_report()] == want
    assert tops.get_op_builder("rms_norm").load() is fused_rms_norm
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention

    assert tops.get_op_builder("flash_attn").load() is flash_attention
    assert dict(tops.op_report()) == {"flash_attn": True, "rms_norm": True,
                                      "quantizer": False,
                                      "ring_attention": False,
                                      "async_io": True, "cpu_adam": True}
    # each refusal names its ROADMAP section 1 item by title (numbers go
    # stale as items close), and that title is an item of section 1
    roadmap = (Path(__file__).resolve().parent.parent / "ROADMAP.md"
               ).read_text().split("### 1.", 1)[1].split("### 2.", 1)[0]
    for name, item in (("quantizer", "Remainder"),
                       ("ring_attention", "Long context")):
        assert f"**{item}" in roadmap
        with pytest.raises(NotImplementedError, match=f'"{item}"'):
            tops.get_op_builder(name).load()


def test_kernel_operand_checks():
    """What kernel J does not take raises before any launch (rows of a
    multiple of 8 values, bf16/fp32, a [D] weight)."""
    from deepspeed_tpu_torch.ops.rms_norm import rms_kernel_args

    with pytest.raises(ValueError, match="multiple of 8"):
        rms_kernel_args(torch.zeros(2, 12), torch.ones(12))
    with pytest.raises(TypeError, match="bf16/fp32"):
        rms_kernel_args(torch.zeros(2, 16, dtype=torch.float16),
                        torch.ones(16))
    with pytest.raises(ValueError, match="weight"):
        rms_kernel_args(torch.zeros(2, 16), torch.ones(8))
