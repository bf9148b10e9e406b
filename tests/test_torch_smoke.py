"""``chip_smoke.py`` on a machine without a card, the sensitivity of its
cross-path check (chunked vs whole-prompt prefill logits, relative L2 gate
``CROSS_PATH_REL_L2``), measured on the CPU with a tiny bf16 model, and its
serve-phase ``Replay`` driven through a tiny CPU engine."""

import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import paged_attention as tpa

ROOT = Path(__file__).resolve().parent.parent


def _no_card_env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="")


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_no_card_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_exits_nonzero_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _cross_path_rel_l2(heavy: bool) -> float:
    cfg = get_preset("tiny", dtype="bfloat16", num_kv_heads=2, num_layers=4,
                     max_seq_len=2048)
    eng = InferenceEngineV2(TransformerLM(cfg), max_sequences=4,
                            max_seq_len=2048, block_size=128, device="cpu")
    if heavy:
        chip_smoke.attention_heavy(eng.params)
    rng = np.random.default_rng(0)
    eng.put([0], [rng.integers(1, 256, 37).astype(np.int32)])
    long_prompt = rng.integers(1, 256, 1100).astype(np.int32)
    chunked = eng.put([0, 1], [np.array([5], np.int32), long_prompt])[1]
    whole = eng.put([2], [long_prompt])[2]
    return float(np.linalg.norm(chunked - whole) / np.linalg.norm(whole))


def test_cross_path_gate_passes_a_correct_engine():
    assert _cross_path_rel_l2(heavy=True) <= chip_smoke.CROSS_PATH_REL_L2


def test_cross_path_gate_sees_a_dropped_past_token(monkeypatch):
    """A copy of the engine whose chunk atoms lose their newest cached
    token must fail the gate by a wide margin with the rescaled
    (attention-heavy) weights, which amplify the error several times over
    the plain random init -- why chip_smoke rescales."""
    plain = tpa.plain_past_partials

    def drop_last(q, kp, vp, layer, bt, slot, pos0, tq, **kw):
        return plain(q, kp, vp, layer, bt, slot, pos0 - 1, tq, **kw)

    monkeypatch.setattr(tpa, "plain_past_partials", drop_last)
    heavy, light = _cross_path_rel_l2(True), _cross_path_rel_l2(False)
    assert heavy > 2 * chip_smoke.CROSS_PATH_REL_L2
    assert heavy > 3 * light


def _replay_run(tiny_engine):
    """chip_smoke's serve traffic at a tiny size under its ``Replay``."""
    eng = tiny_engine
    rng = np.random.default_rng(3)
    firsts = [rng.integers(1, 256, n).astype(np.int32) for n in (5, 9)]
    fresh = rng.integers(1, 256, 40).astype(np.int32)     # > MAX_ATOM = 16
    with chip_smoke.Replay(torch, tpa, tfa) as replay:
        replay.stage = "put"
        out = eng.put([0, 1], firsts)
        nxt = [int(np.argmax(out[u])) for u in (0, 1)]
        out = eng.put([0, 1, 2], [np.array([t], np.int32) for t in nxt]
                      + [fresh])
        replay.stage = "decode_batch"
        eng.decode_batch([0, 1, 2], [int(np.argmax(out[u]))
                                     for u in (0, 1, 2)], steps=3)
    return replay


@pytest.fixture
def tiny_engine():
    model = TransformerLM(get_preset("tiny", dtype="float32", num_kv_heads=2))
    model.MAX_ATOM = 16
    return InferenceEngineV2(model, max_sequences=4, max_seq_len=64,
                             block_size=8, device="cpu")


def test_replay_captures_each_stage_and_restores_the_wrappers(tiny_engine):
    originals = (tpa.decode_pool_partials, tpa.past_partials,
                 tpa.self_attention, tfa.flash_attention_lse)
    replay = _replay_run(tiny_engine)
    assert (tpa.decode_pool_partials, tpa.past_partials, tpa.self_attention,
            tfa.flash_attention_lse) == originals
    assert set(replay.captured) == chip_smoke.Replay.REQUIRED
    x, _ = replay.captured[("paged_decode", "decode_batch")]
    assert bool((x["row_pos"] != x["atom_pos0"]).any())
    errs = replay.check()
    assert set(errs) == {f"{n}/{s}" for n, s in chip_smoke.Replay.REQUIRED}
    assert max(errs.values()) == 0.0          # plain against plain on CPU


def test_replay_sees_a_faulty_decode_loop_launch(tiny_engine, monkeypatch):
    """Kernel A's outputs corrupted only inside the fused decode loop (rows
    past the pool frontier) must fail the replay."""
    real = tpa.decode_pool_partials

    @functools.wraps(real)
    def faulty(*args, **kw):
        acc, m, l = real(*args, **kw)
        if kw.get("row_pos") is not None and bool(
                (kw["row_pos"] != args[6]).any()):
            acc = acc * 1.5
        return acc, m, l

    monkeypatch.setattr(tpa, "decode_pool_partials", faulty)
    replay = _replay_run(tiny_engine)
    with pytest.raises(AssertionError, match="paged_decode .decode_batch."):
        replay.check()
