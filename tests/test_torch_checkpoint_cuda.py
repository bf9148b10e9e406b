"""Engine checkpoints on the card: a ``tiny`` engine (256 wide, 4 heads of
64, bf16 compute, fp32 masters; its steps launch kernels D, E and F) saves
and a second engine from another seed loads the tag -- every leaf, the
moments and the update count bit for bit, then the same losses and leaves
bit for bit; the async save's commit under ``resilience.enabled``; and
``init_inference(checkpoint=)`` giving the greedy tokens of ``params=``.
Marked ``cuda``, skipped without a card. The file imports neither JAX nor
the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_checkpoint_cuda.py
"""

import itertools

import numpy as np
import pytest
import torch

CARD_TINY = {"hidden_size": 256, "num_heads": 4, "dtype": "bfloat16"}
CONFIG = {"train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3,
                                                    "weight_decay": 0.1}},
          "scheduler": {"type": "WarmupLR",
                        "params": {"warmup_num_steps": 10}},
          "gradient_clipping": 1.0, "steps_per_print": 100}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def _model():
    from deepspeed_tpu_torch import TransformerLM, get_preset

    return TransformerLM(get_preset("tiny", **CARD_TINY))


def _engine(seed, **over):
    import deepspeed_tpu_torch as tds

    return tds.initialize(_model(), {**CONFIG, "seed": seed, **over})[0]


def _batches():
    rng = np.random.default_rng(0)
    return itertools.cycle([{"input_ids": rng.integers(0, 256, (2, 64))}
                            for _ in range(2)])


def _state(eng):
    from deepspeed_tpu_torch.runtime.checkpoint import flatten_tree

    names = list(flatten_tree(eng.params))
    out = {f"p/{n}": t.detach().cpu().clone()
           for n, t in flatten_tree(eng.params).items()}
    for key in ("mu", "nu"):
        out.update({f"{key}/{n}": t.cpu().clone()
                    for n, t in zip(names, eng.opt_state[key])})
    return out


@pytest.mark.cuda
def test_round_trip_on_the_card_bit_for_bit(cuda_device, tmp_path):
    from deepspeed_tpu_torch.ops import _build

    _build.reset_counts()
    a, it = _engine(0), _batches()
    for _ in range(2):
        a.train_batch(it)
    saved = _state(a)
    a.save_checkpoint(str(tmp_path))
    after_a = [a.train_batch(it) for _ in range(2)]
    final_a = _state(a)
    del a
    b, it = _engine(1), _batches()
    b.load_checkpoint(str(tmp_path))
    assert b.opt_state["count"] == 2 and b.global_steps == 2
    loaded = _state(b)
    assert loaded.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(loaded[k], v), k
    after_b = [b.train_batch(it) for _ in range(2)]
    assert after_b == after_a
    final_b = _state(b)
    for k, v in final_a.items():
        assert torch.equal(final_b[k], v), k
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[k] > 0, counts


@pytest.mark.cuda
def test_async_save_commits_on_the_card(cuda_device, tmp_path):
    from deepspeed_tpu_torch.resilience.manager import (STAGING_FILE,
                                                        verify_tag_dir)
    from deepspeed_tpu_torch.runtime.checkpoint import read_latest_tag

    eng, it = _engine(0, checkpoint={"async_save": True}, resilience={
        "enabled": True, "checkpoint": {"async_save": True}}), _batches()
    eng.train_batch(it)
    eng.save_checkpoint(str(tmp_path))
    eng.train_batch(it)                      # while the commit runs
    mgr = eng._primary_mgr
    eng.shutdown()
    assert mgr.async_stats["commits"] == 1 and mgr._pending_async is None
    ok, why = verify_tag_dir(str(tmp_path / "global_step1"))
    assert ok, why
    assert read_latest_tag(str(tmp_path)) == "global_step1"
    assert not (tmp_path / "global_step1" / STAGING_FILE).exists()


@pytest.mark.cuda
def test_init_inference_serves_the_checkpoint_on_the_card(cuda_device,
                                                          tmp_path):
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.runtime.checkpoint import load_params_only

    eng, it = _engine(0), _batches()
    eng.train_batch(it)
    eng.save_checkpoint(str(tmp_path))
    del eng
    ids = np.random.default_rng(3).integers(1, 256, (2, 12))
    model = _model()
    got = tds.init_inference(model, checkpoint=str(tmp_path)).generate(
        ids, max_new_tokens=16)
    params = load_params_only(str(tmp_path), device="cuda")
    want = tds.init_inference(model, params=params).generate(
        ids, max_new_tokens=16)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 28)
