"""The offload optimizer on the card at small widths (the ``tiny`` preset
at width 256, bf16 compute, fp32 masters; the attention launches kernels
D, E and F): the host buffers are page-locked, the params on the card
equal the host masters bit for bit after each step, the CPU tier tracks
on-card AdamW (first loss bit-equal, then rtol 5e-3), ``upload_overlap``
on and off and the NVMe tier (serial, depth 2) are bit-equal to the CPU
tier, ``overlap_step`` gives the synchronous engine's trajectory with
one-step-stale gradients bit for bit, the top-k split
moves unselected columns only at update boundaries, and ``shutdown``
unregisters the page-locked buffers. Marked ``cuda``, skipped without a
card. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_offload_cuda.py
"""

import numpy as np
import pytest
import torch

MODEL = dict(hidden_size=256, num_heads=4, num_kv_heads=2,
             intermediate_size=512, num_layers=2, dtype="bfloat16",
             max_seq_len=256)
CONFIG = {"train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3,
                                                    "weight_decay": 0.1}},
          "gradient_clipping": 1.0, "steps_per_print": 1000, "seed": 0}
STEPS = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def _engine(zero=None, **extra):
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch import TransformerLM, get_preset

    config = {**CONFIG, **extra}
    if zero is not None:
        config["zero_optimization"] = zero
    return tds.initialize(TransformerLM(get_preset("tiny", **MODEL)),
                          config)[0]


def _batch():
    rng = np.random.default_rng(0)
    return {"input_ids": rng.integers(0, 256, (2, 256)).astype(np.int32)}


def _steps(eng, n=STEPS):
    import itertools

    b = _batch()
    return [eng.train_batch(itertools.repeat(b)) for _ in range(n)]


def _params(eng):
    from deepspeed_tpu_torch.runtime.checkpoint import flatten_tree

    return {k: p.detach().cpu() for k, p in flatten_tree(eng.params).items()}


def _on_host(device="cpu", **kw):
    off = {"device": device}
    if "nvme_path" in kw:
        off["nvme_path"] = kw.pop("nvme_path")
    return {"offload_optimizer": off, **kw}


@pytest.mark.cuda
def test_cpu_tier_tracks_on_card_adamw_and_uploads_its_masters(cuda_device):
    ref = _steps(_engine())
    eng = _engine(_on_host())
    off = eng._offload
    assert all(t.is_pinned() for t in off.master.values())
    assert all(t.is_pinned() for t in off._grads.values())
    assert eng.opt_state == {}
    losses = []
    for _ in range(STEPS):
        losses += _steps(eng, 1)
        for name, p in _params(eng).items():
            assert torch.equal(p, off.master[f"{name}#0"].view(p.shape)), name
    assert losses[0] == ref[0]
    np.testing.assert_allclose(losses, ref, rtol=5e-3)
    rep = eng.offload_report()
    assert rep["enabled"] and rep["last_adam_ms"] > 0 and rep["last_d2h_ms"] > 0
    eng.shutdown()
    assert off._host._pinned == []


@pytest.mark.cuda
def test_upload_overlap_and_nvme_tiers_are_bit_equal(cuda_device, tmp_path):
    base = _engine(_on_host())
    want_loss, want = _steps(base), _params(base)
    state = {k: np.array(v) for k, v in base._offload.state_dict().items()}
    base.shutdown()
    runs = {"upload_overlap off": _engine(
        _on_host(), offload={"aio": {"upload_overlap": False}})}
    for depth in (0, 2):
        runs[f"nvme depth {depth}"] = _engine(
            _on_host("nvme", nvme_path=str(tmp_path / str(depth))),
            offload={"aio": {"prefetch_depth": depth}})
    for tag, eng in runs.items():
        assert _steps(eng) == want_loss, tag
        for name, p in _params(eng).items():
            assert torch.equal(p, want[name]), (tag, name)
        for k, v in eng._offload.state_dict().items():
            assert np.array_equal(v, state[k]), (tag, k)
        eng.shutdown()


def _stale_steps(eng, n=STEPS):
    """The overlapped trajectory replayed on a synchronous engine: step k's
    update takes the gradient of step k-1's forward."""
    b, prev, losses = _batch(), None, []
    for _ in range(n):
        total = 0.0
        for _ in range(eng.gradient_accumulation_steps()):
            loss = eng.forward(b)
            eng.backward(loss)
            total += float(loss.detach())
        fresh = [p.grad.detach().clone() for p in eng._leaves]
        if prev is not None:
            for p, g in zip(eng._leaves, prev):
                p.grad = g
        eng.step()
        prev = fresh
        losses.append(total / eng.gradient_accumulation_steps())
    return losses


@pytest.mark.cuda
def test_overlap_step_shifts_the_trajectory_by_one_step(cuda_device,
                                                       tmp_path):
    """The first two losses agree, the next is the synchronous run's, and
    from there each step is the synchronous engine's fed one-step-stale
    gradients, bit for bit (the plain synchronous run drifts away: ~9% by
    the third shifted step at this width and lr)."""
    sync = _steps(_engine(_on_host()))
    stale = _stale_steps(_engine(_on_host()))
    eng = _engine(_on_host(zenflow={"overlap_step": True}))
    over = _steps(eng, STEPS + 1)
    np.testing.assert_allclose(over[1], over[0], rtol=1e-6)
    np.testing.assert_allclose(over[1:3], sync[:2], rtol=2e-2)
    assert over[1:] == stale
    assert eng._offload._pending is not None
    eng.save_checkpoint(str(tmp_path))       # drains the async step first
    assert eng._offload._pending is None
    eng.shutdown()


@pytest.mark.cuda
def test_topk_split_moves_other_columns_at_boundaries_only(cuda_device):
    from deepspeed_tpu_torch.runtime.checkpoint import flatten_tree

    eng = _engine(_on_host(zenflow={"topk_ratio": 0.25, "update_interval": 2,
                                    "select_interval": 4}))
    leaf = flatten_tree(eng.params)["layers/mlp/w_down"]
    for step in range(STEPS):
        before = leaf.detach().clone()
        _steps(eng, 1)
        keep = torch.zeros(leaf.shape[-1], dtype=torch.bool, device=leaf.device)
        keep[eng._offload._idx["layers/mlp/w_down"]] = True
        delta = (leaf.detach() - before).abs()
        assert float(delta[..., keep].max()) > 0, step
        assert (float(delta[..., ~keep].max()) > 0) == ((step + 1) % 2 == 0)
    eng.shutdown()
