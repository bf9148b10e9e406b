"""Every remat policy of the port against the reference on the CPU (fp32,
the ``tiny`` preset, 2 layers, width 64): the per-leaf gradients of one
micro-batch's loss under each policy agree with the reference's ``none``
gradients to 1e-5 relative L2, and the attention op ``dstpu::flash_attn``
runs once a layer for ``none`` and the policies that keep its output
(``attn_saveable``, ``dots_and_attn_saveable``, ``offload_attn``) and
twice a layer (forward and recompute) for the rest. The offload policies
count what they send to the host; the kept products are not recomputed."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import get_preset as jax_preset
from deepspeed_tpu_torch.bridge import params_from_numpy
from deepspeed_tpu_torch.config import from_config
from deepspeed_tpu_torch.models import TransformerLM, get_preset
from deepspeed_tpu_torch.models.spec import tree_leaves
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_model import perturbed_params

B, T = 2, 16
KEEPS_ATTN = ("none", "attn_saveable", "dots_and_attn_saveable",
              "offload_attn")


@pytest.fixture(scope="module")
def reference():
    """Bridged weights, one batch and the reference's ``none`` gradients."""
    cfg = jax_preset("tiny", dtype="float32")
    jm = JaxLM(cfg)
    params = perturbed_params(jm, seed=2)
    ids = np.random.default_rng(3).integers(0, 256, (B, T)).astype(np.int32)
    grads = jax.grad(lambda p: jm.loss_fn(p, {"input_ids": ids}))(params)
    return params, ids, {k: np.asarray(v) for k, v in
                         zip(_names(grads), jax.tree_util.tree_leaves(grads))}


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k],
                                                        f"{prefix}{k}.")]
    return [prefix[:-1]]


def _port_grads(params, ids, policy, monkeypatch):
    calls = []
    plain = tfa.plain_flash_forward
    monkeypatch.setattr(tfa, "plain_flash_forward",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    model = TransformerLM(get_preset("tiny", dtype="float32",
                                     remat_policy=policy))
    p = params_from_numpy(params, device="cpu")
    leaves = list(tree_leaves(p))
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss_fn(p, {"input_ids": torch.from_numpy(ids)})
    grads = torch.autograd.grad(loss, leaves)
    return dict(zip(_names(p), grads)), len(calls)


@pytest.mark.parametrize("policy", ac.POLICIES)
def test_policy_grads_and_attention_calls(reference, policy, monkeypatch):
    params, ids, want = reference
    ac.OFFLOAD_STATS.update(bytes=0, tensors=0)
    got, calls = _port_grads(params, ids, policy, monkeypatch)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-5, (name, rel)
    L = 2
    assert calls == (L if policy in KEEPS_ATTN else 2 * L), calls
    if policy == "offload_attn":
        # out [B, T, H, d] and lse [B, H, T] of each layer, fp32
        H, d = 4, 16
        assert ac.OFFLOAD_STATS == {
            "bytes": L * 4 * (B * T * H * d + B * H * T), "tensors": 2 * L}
    elif policy == "offload_dots":
        assert ac.OFFLOAD_STATS["tensors"] == L * 7     # q k v o gate up down
    else:
        assert ac.OFFLOAD_STATS["tensors"] == 0


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func.name() in ac.DOTS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,recomputed", [
    ("full", 6), ("dots_saveable", 0), ("offload_dots", 0),
    ("attn_saveable", 6)])
def test_kept_products_are_not_recomputed(policy, recomputed):
    """The products a policy keeps are answered from the forward in the
    recompute: one block's backward runs only the backward's own products
    (2 a forward product) plus the recomputed ones: 6 of the block's 7
    under a whole recompute, which stops early once the backward has every
    tensor it saves (the last product's output is not one of them)."""
    cfg = get_preset("tiny", dtype="float32", num_layers=1)
    model = TransformerLM(cfg)
    w = model.init(seed=1, device="cpu")["layers"]
    w = {g: {n: t[0].requires_grad_(True) for n, t in sub.items()}
         for g, sub in w.items()}
    from deepspeed_tpu_torch.models.transformer import transformer_block

    x = torch.randn(B, T, 64, requires_grad=True)
    y, _ = ac.checkpoint(transformer_block, x, w, cfg, model.freqs("cpu"),
                         policy=policy)
    with _CountMM() as mode:
        y.square().sum().backward()
    assert mode.mm == 2 * 7 + recomputed


def test_config_accepts_every_policy():
    for policy in ac.POLICIES:
        assert from_config({"activation_checkpointing": {
            "policy": policy, "cpu_checkpointing": True}}) \
            .activation_checkpointing.policy == policy
    with pytest.raises(ValueError, match="unknown remat policy"):
        from_config({"activation_checkpointing": {"policy": "dots"}})
    assert dataclasses.replace(get_preset("tiny"),
                               remat_policy="offload_dots")
