"""MoE on the card at small widths (D 256, F 512, E 8, top-2, bf16
compute): the grouped block's ``ragged`` product against its ``padded``
einsum twin (the same top-k indices; output and the grads of x, router,
``w_gate``, ``w_up`` and ``w_down`` within rel L2 2e-2), two ragged
launches bit for bit, and a ``tiny-moe``-shaped model's per-leaf grads
under remat ``full`` bit-equal to ``none``'s under both dispatch algebras
(its attention launches kernels D, E and F). Marked ``cuda``, skipped
without a card. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_moe_cuda.py
"""

import dataclasses

import pytest
import torch

REL = 2e-2
CARD_MOE = {"hidden_size": 256, "num_heads": 4, "intermediate_size": 512,
            "num_experts": 8, "dtype": "bfloat16"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


@pytest.mark.cuda
def test_grouped_ragged_matches_padded_on_the_card(cuda_device,
                                                   monkeypatch):
    from deepspeed_tpu_torch import get_preset
    from deepspeed_tpu_torch.moe import sharded_moe

    cfg = get_preset("tiny-moe", **CARD_MOE, moe_dispatch="grouped")
    D, Fd, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    g = torch.Generator(cuda_device).manual_seed(3)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda_device)
                * scale).to(torch.bfloat16)

    x0 = randn(2, 96, D)
    w0 = {"router": randn(D, E, scale=D ** -0.5),
          "w_gate": randn(E, D, Fd, scale=D ** -0.5),
          "w_up": randn(E, D, Fd, scale=D ** -0.5),
          "w_down": randn(E, Fd, D, scale=Fd ** -0.5)}
    dy = randn(2, 96, D)
    picks = []
    route = sharded_moe._route

    def spy(*a, **k):
        out = route(*a, **k)
        picks.append(out[3])
        return out

    monkeypatch.setattr(sharded_moe, "_route", spy)

    def run(kernel):
        x = x0.clone().requires_grad_(True)
        w = {n: t.clone().requires_grad_(True) for n, t in w0.items()}
        y, _ = sharded_moe.grouped_moe_mlp_block(
            x, w, dataclasses.replace(cfg, moe_kernel=kernel))
        return [y, *torch.autograd.grad(y, [x, *w.values()],
                                        grad_outputs=dy)]

    ragged, padded, again = run("ragged"), run("padded"), run("ragged")
    assert torch.equal(picks[0], picks[1])
    for name, r, p, a in zip(("out", "x", *w0), ragged, padded, again):
        assert _rel(r, p) <= REL, name
        assert torch.equal(r, a), name


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["capacity", "grouped"])
def test_remat_full_grads_equal_none_on_the_card(cuda_device, dispatch):
    from deepspeed_tpu_torch import TransformerLM, get_preset
    from deepspeed_tpu_torch.models.spec import tree_leaves
    from deepspeed_tpu_torch.ops._build import KERNELS, reset_counts

    cfg = get_preset("tiny-moe", **CARD_MOE, moe_dispatch=dispatch)
    params = TransformerLM(cfg).init(seed=0, device=cuda_device)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    ids = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(1))
    out = {}
    for policy in ("none", "full"):
        model = TransformerLM(dataclasses.replace(cfg, remat_policy=policy))
        reset_counts()
        out[policy] = torch.autograd.grad(
            model.loss_fn(params, {"input_ids": ids}), leaves)
        torch.cuda.synchronize()
        assert KERNELS["flash_fwd"].launches > 0
        assert KERNELS["flash_bwd_dkv"].launches == cfg.num_layers
    for a, b in zip(out["full"], out["none"]):
        assert torch.equal(a, b)
