"""The rest of training on the card, on a ``tiny`` model (256 wide, 4
heads of 64, bf16 compute, fp32 masters; its steps launch kernels D, E and
F): every remat policy's per-leaf gradients against ``none``'s (rel L2
<= 1e-5) with kernel D launched once a layer where the policy keeps the
attention output and twice elsewhere; and one update of each new
optimizer on the card against the same update on the CPU (rel L2 of the
difference over the displacement <= 1e-5, muon's bf16 iteration 2e-2,
beyond fp32's rounding of ``p + u``, one ulp an element). Marked
``cuda``, skipped without a card. The file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_features_cuda.py
"""

import dataclasses

import pytest
import torch

CARD_TINY = {"hidden_size": 256, "num_heads": 4, "dtype": "bfloat16"}
KEEPS_ATTN = ("none", "attn_saveable", "dots_and_attn_saveable",
              "offload_attn")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


@pytest.mark.cuda
def test_every_policy_matches_none_on_the_card(cuda_device):
    from deepspeed_tpu_torch import TransformerLM, get_preset
    from deepspeed_tpu_torch.models.spec import tree_leaves
    from deepspeed_tpu_torch.ops._build import KERNELS, reset_counts
    from deepspeed_tpu_torch.runtime.activation_checkpointing import POLICIES

    cfg = get_preset("tiny", **CARD_TINY)
    params = TransformerLM(cfg).init(seed=0, device=cuda_device)
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(1))
    ref = None
    for policy in POLICIES:
        model = TransformerLM(dataclasses.replace(cfg, remat_policy=policy))
        reset_counts()
        grads = torch.autograd.grad(model.loss_fn(params, {"input_ids": ids}),
                                    leaves)
        torch.cuda.synchronize()
        want = cfg.num_layers * (1 if policy in KEEPS_ATTN else 2)
        assert KERNELS["flash_fwd"].launches == want, policy
        assert KERNELS["flash_bwd_dq"].launches == cfg.num_layers, policy
        ref = grads if ref is None else ref
        for g, w in zip(grads, ref):
            assert _rel(g, w) <= 1e-5, policy


@pytest.mark.cuda
@pytest.mark.parametrize("name,lr", [
    ("lamb", 1e-3), ("lion", 1e-4), ("adagrad", 1e-1), ("adafactor", 1e-2),
    ("rmsprop", 3e-5), ("muon", 2e-2)])
def test_optimizer_update_on_the_card_matches_the_cpu(cuda_device, name, lr):
    from deepspeed_tpu_torch.runtime.optimizers import build_optimizer

    g = torch.Generator().manual_seed(2)
    shapes = [(512, 256), (2, 256, 384), (2, 256)]
    p0 = [torch.randn(s, generator=g) * 0.02 for s in shapes]
    gs = [torch.randn(s, generator=g) * 1e-3 for s in shapes]
    new = {}
    for dev in (cuda_device, torch.device("cpu")):
        tx = build_optimizer(name, {"lr": lr}, gradient_clipping=1.0)
        ps = [p.to(dev, copy=True) for p in p0]
        state = tx.init(ps)
        for _ in range(2):
            tx.update(ps, [x.to(dev, copy=True) for x in gs], state)
        new[dev.type] = [p.cpu() for p in ps]
    gate = 2e-2 if name == "muon" else 1e-5
    for p, got, want in zip(p0, new["cuda"], new["cpu"]):
        # over the CPU's displacement, beyond fp32's rounding of p + u
        moved = (want.double() - p.double()).norm()
        ulp = torch.nextafter(want, torch.full_like(want, float("inf"))) \
            - want
        assert moved > 0
        assert float((got.double() - want.double()).norm() / moved) <= \
            gate + float(ulp.double().norm() / moved)
