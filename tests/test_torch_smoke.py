"""``chip_smoke.py`` on a machine without a card, the sensitivity of its
cross-path check (chunked vs whole-prompt prefill logits, relative L2 gate
``CROSS_PATH_REL_L2``), measured on the CPU with a tiny bf16 model, its
serve-phase ``Replay`` driven through a tiny CPU engine, and its train
phase's ``TrainReplay`` and gradient cross-check (``GRAD_REL_L2``) driven
through a tiny CPU training engine, its per-tile gate of the
backward kernels (``close_tiles``), and its serve-quant phase's
``QuantReplay`` and weight cross-check (``WEIGHT_REL_L2``) on a tiny
quantized CPU engine, and its serve-dense phase (``dense_runs``,
``DenseReplay``, ``dense_controls``, ``dense_cross_check``:
``DENSE_REL_L2``) on a tiny fp32 CPU model, where stand-ins for kernel I and
for the dense cache's attention that drop each row's newest visible column
must be caught, and kernel I's per-tile gate."""

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
from deepspeed_tpu_torch.models import transformer as tm
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import paged_attention as tpa
from deepspeed_tpu_torch.ops import quant_matmul as tqm

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
                 tpa.self_attention, tfa.flash_forward)
    replay = _replay_run(tiny_engine)
    assert (tpa.decode_pool_partials, tpa.past_partials, tpa.self_attention,
            tfa.flash_forward) == originals
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


@pytest.fixture
def tiny_trainer():
    import deepspeed_tpu_torch as tds

    from deepspeed_tpu_torch.tools.train_profile import TRAIN_CONFIG

    model = TransformerLM(get_preset("tiny", num_kv_heads=2))
    cfg = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=2)
    return tds.initialize(model, cfg, device="cpu")[0]


def _train_batch(seed=0):
    ids = np.random.default_rng(seed).integers(0, 256, (2, 64))
    return {"input_ids": ids.astype(np.int32)}


def test_train_replay_captures_d_e_f_and_restores_the_wrappers(tiny_trainer):
    originals = (tfa.flash_forward, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    with chip_smoke.TrainReplay(torch, tfa) as replay:
        replay.stage = "train"
        tiny_trainer.train_batch(iter([_train_batch()] * 2))
    assert (tfa.flash_forward, tfa.flash_bwd_dq, tfa.flash_bwd_dkv) == \
        originals
    assert set(replay.captured) == chip_smoke.TrainReplay.REQUIRED
    errs = replay.check()
    assert max(errs.values()) == 0.0          # plain against plain on CPU


def test_train_replay_sees_a_faulty_backward_launch(tiny_trainer,
                                                    monkeypatch):
    real = tfa.flash_bwd_dkv

    @functools.wraps(real)
    def faulty(*args, **kw):
        dk, dv = real(*args, **kw)
        return dk, dv * 1.05

    monkeypatch.setattr(tfa, "flash_bwd_dkv", faulty)
    with chip_smoke.TrainReplay(torch, tfa) as replay:
        replay.stage = "train"
        tiny_trainer.train_batch(iter([_train_batch()] * 2))
    with pytest.raises(AssertionError, match="flash_bwd_dkv .train. dv"):
        replay.check()


@pytest.mark.parametrize("fault", [None, "dq", "dkv"])
def test_gradient_cross_check_sees_a_faulty_backward(fault, monkeypatch):
    """The per-leaf gradient gate (rel L2 <= GRAD_REL_L2) passes the plain
    path against itself and fails when E's or F's output is off by 5%."""
    model = TransformerLM(get_preset("tiny", num_kv_heads=2,
                                     dtype="float32"))
    params = model.init(seed=0, device="cpu")
    if fault == "dq":
        real = tfa.flash_bwd_dq
        monkeypatch.setattr(tfa, "flash_bwd_dq",
                            lambda *a, **kw: real(*a, **kw) * 1.05)
    elif fault == "dkv":
        real = tfa.flash_bwd_dkv
        monkeypatch.setattr(tfa, "flash_bwd_dkv", lambda *a, **kw: tuple(
            t * 1.05 for t in real(*a, **kw)))
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(1).items()}
    rel = chip_smoke.grad_rel_l2(torch, tfa, model, params, batch)
    if fault is None:
        assert max(rel.values()) == 0.0
    else:
        worst = max(rel[n] for n in (("wq",) if fault == "dq"
                                     else ("wk", "wv")))
        assert worst > 2 * chip_smoke.GRAD_REL_L2


def _causal_grads(T=1024, H=4, K=2, d=64, seed=0):
    """Plain fp32 (dq, dk, dv) of a causal GQA attention on seeded inputs."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((1, T, H, d))
                              .astype(np.float32)) for _ in "qo")
    k, v = (torch.from_numpy(rng.standard_normal((1, T, K, d))
                             .astype(np.float32)) for _ in "kv")
    out, lse = tfa.plain_flash_forward(q, k, v, causal=True)
    return tfa.plain_flash_backward(q, k, v, out, lse, do, causal=True)


def test_tile_gate_passes_bf16_rounding():
    """Each gradient rounded to bf16 (what the kernels' output rounding
    does) passes every tile with room to spare."""
    for name, g in zip(("dq", "dk", "dv"), _causal_grads()):
        err, scale, worst = chip_smoke.close_tiles(
            name, g.bfloat16(), g)
        assert 0 < err and worst < chip_smoke.BWD_REL / 4, (name, worst)


@pytest.mark.parametrize("grad", [0, 1, 2])
def test_tile_gate_sees_a_late_tile_fault_a_tensor_wide_gate_misses(grad):
    """Causal gradients shrink along the sequence: 10% off in the last
    quarter of the rows stays under 2e-2 x the tensor's max |plain| but
    fails the per-tile gate."""
    want = _causal_grads()[grad]
    got = want.clone()
    got[:, 3 * want.shape[1] // 4:] *= 1.1
    assert float((got - want).abs().max()) <= \
        chip_smoke.BWD_REL * float(want.abs().max())
    with pytest.raises(AssertionError, match="tiles over the gate"):
        chip_smoke.close_tiles("late", got, want)


def test_tile_gate_sees_a_late_kernel_i_fault_a_tensor_wide_gate_misses():
    """Kernel I's t=700 tile (phase 3): late causal rows average hundreds of
    columns and are small, so 5% off in the last quarter of the rows
    passes the tensor-wide atol = rtol = 2e-2 but fails the per-tile gate;
    the output rounded to bf16 passes it."""
    rng = np.random.default_rng(3)
    H, K, d, bs, nb, t = 4, 2, 128, 64, 12, 700
    q = torch.from_numpy(rng.standard_normal((1, t, H, d)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((1, nb + 1, bs, K * d))
                               .astype(np.float32)) for _ in "kv")
    bt = torch.from_numpy(rng.permutation(nb).astype(np.int32)[None])
    want = tpa.plain_paged_attention(q, kp, vp, bt, torch.zeros(1, dtype=
                                                                torch.int32))
    chip_smoke.close_tiles("I bf16", want.bfloat16(), want)
    got = want.clone()
    got[:, 3 * t // 4:] *= 1.05
    torch.testing.assert_close(got, want, atol=chip_smoke.ATOL,
                               rtol=chip_smoke.RTOL)
    with pytest.raises(AssertionError, match="tiles over the gate"):
        chip_smoke.close_tiles("late", got, want)


def _quant_engine(wd="int4", kd="int8", seed=0):
    """A tiny engine whose every matmul leaf quantizes (dims multiples of
    128), fp32 on the CPU."""
    cfg = get_preset("tiny", dtype="float32", vocab_size=512, hidden_size=128,
                     num_kv_heads=2, max_seq_len=256)
    model = TransformerLM(cfg)
    model.MAX_ATOM = 16
    params = model.init(seed=seed, device="cpu")
    return InferenceEngineV2(model, params, max_sequences=8, max_seq_len=128,
                             block_size=8, device="cpu", weight_dtype=wd,
                             kv_dtype=kd), params


def _quant_traffic(eng, replay):
    rng = np.random.default_rng(5)
    firsts = [rng.integers(1, 512, n).astype(np.int32) for n in (5, 9)]
    fresh = rng.integers(1, 512, 40).astype(np.int32)     # > MAX_ATOM = 16
    replay.stage = "put"
    out = eng.put([0, 1], firsts)
    nxt = [int(np.argmax(out[u])) for u in (0, 1)]
    replay.stage = "mixed"
    out = eng.put([0, 1, 2], [np.array([t], np.int32) for t in nxt] + [fresh])
    replay.stage = "decode_batch"
    eng.decode_batch([0, 1, 2], [int(np.argmax(out[u])) for u in (0, 1, 2)],
                     steps=3)


@pytest.mark.parametrize("wd,kd", [("int4", "int8"), ("int8", "int4")])
def test_quant_replay_captures_each_stage_and_restores_the_wrappers(wd, kd):
    eng, _ = _quant_engine(wd, kd)
    originals = (tpa.decode_pool_partials, tpa.past_partials,
                 tqm.quantized_matmul)
    with chip_smoke.QuantReplay(torch, tpa, tqm, int(kd[-1])) as replay:
        _quant_traffic(eng, replay)
    assert (tpa.decode_pool_partials, tpa.past_partials,
            tqm.quantized_matmul) == originals
    assert replay.REQUIRED <= set(replay.captured)
    x, _ = replay.captured[("qmm_stacked", "decode_batch")]
    assert x["packed"].shape[0] == 1 and x["layer"] == 0   # one layer kept
    errs = replay.check()
    assert max(errs.values()) == 0.0          # plain against plain on CPU


def test_quant_replay_sees_a_faulty_head_launch(monkeypatch):
    """Kernel G's output 5% off must fail the replay; H's stays clean."""
    real = tqm.quantized_matmul

    @functools.wraps(real)
    def faulty(x, packed, scales, bits=4, layer=None):
        out = real(x, packed, scales, bits, layer)
        return out * 1.05 if layer is None else out

    monkeypatch.setattr(tqm, "quantized_matmul", faulty)
    eng, _ = _quant_engine()
    with chip_smoke.QuantReplay(torch, tpa, tqm, 8) as replay:
        _quant_traffic(eng, replay)
    with pytest.raises(AssertionError, match=r"replay qmm \("):
        replay.check()


@pytest.mark.parametrize("bits,fault", [(8, False), (4, False), (4, True)])
def test_weight_cross_check_passes_g_h_against_their_dense_weights(
        bits, fault, monkeypatch):
    """The cross-check's reference: the quantized tree expanded to dense
    weights (untied head) serves the logits of the packed tree through G/H's
    plain version to rel L2 6.2e-3 (int8) / 7.2e-3 (int4) here, inside the
    gate -- the dense oracle rounds q x scale to bf16, G/H do not; an H whose
    products are 5% off fails it. The served tree is smaller than the dense
    one."""
    import dataclasses

    if fault:
        real = tqm.quantized_matmul
        monkeypatch.setattr(tqm, "quantized_matmul", lambda *a, **kw: real(
            *a, **kw) * (1.05 if kw.get("layer") is not None else 1.0))
    eng, params = _quant_engine(f"int{bits}", "bf16")
    ref = InferenceEngineV2(
        TransformerLM(dataclasses.replace(eng.cfg, tie_embeddings=False)),
        chip_smoke.dequantized_tree(torch, tqm, eng.params), max_sequences=8,
        max_seq_len=128, block_size=8, device="cpu")
    prompts = [np.arange(1, 31, dtype=np.int32), np.arange(7, 27,
                                                            dtype=np.int32)]
    got, want = eng.put([0, 1], prompts), ref.put([0, 1], prompts)
    rel = max(float(np.linalg.norm(got[u] - want[u]) / np.linalg.norm(want[u]))
              for u in (0, 1))
    if fault:
        assert rel > 2 * chip_smoke.WEIGHT_REL_L2
        return
    assert rel <= chip_smoke.WEIGHT_REL_L2 / 2
    assert chip_smoke.tree_bytes(eng.params) < \
        (0.6 if bits == 8 else 0.45) * chip_smoke.tree_bytes(params)


def _dense_setup():
    """A tiny fp32 model whose tree is already in the compute dtype (the
    engines must not copy it), phase 7's traffic at a tiny size."""
    cfg = get_preset("tiny", dtype="float32", num_kv_heads=2, num_layers=2,
                     max_seq_len=256)
    model = TransformerLM(cfg)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, n).astype(np.int32)
               for n in (5, 9, 30, 17)]
    v1_ids = [rng.integers(1, 256, 16).astype(np.int32) for _ in range(4)]
    kw = dict(max_sequences=8, max_seq_len=128, block_size=8, device="cpu")
    return model, model.init(seed=0, device="cpu"), prompts, v1_ids, kw


def test_dense_runs_and_cross_check_pass_correct_engines():
    model, tree, prompts, v1_ids, kw = _dense_setup()
    originals = (tpa.paged_attention,)
    res = chip_smoke.dense_runs(torch, tpa, model, tree, prompts, v1_ids, 3,
                                noise_floor=True, **kw)
    assert (tpa.paged_attention,) == originals
    assert set(res["rel"]) == {"forward", "noise", "a", "b", "c"}
    assert max(res["rel"].values()) < 1e-5          # fp32: the same function
    assert set(res["replay"]) == {"paged_tile/put"}
    assert res["generated"].shape == (4, chip_smoke.V1_NEW_TOKENS)
    originals = (tpa.paged_attention, tm._cached_attention)
    res = chip_smoke.dense_cross_check(torch, tpa, model, tree, prompts,
                                       v1_ids, 3, **kw)
    assert (tpa.paged_attention, tm._cached_attention) == originals
    assert max(res["rel"].values()) < 1e-5
    assert set(res["faulty"]) == {"a", "b", "c"}
    assert min(res["faulty"].values()) > 10 * chip_smoke.DENSE_REL_L2


def test_dense_replay_sees_a_kernel_i_that_drops_the_newest_column(
        monkeypatch):
    model, tree, prompts, v1_ids, kw = _dense_setup()
    monkeypatch.setattr(tpa, "paged_attention", functools.wraps(
        tpa.paged_attention)(chip_smoke.drops_newest_column(
            tpa.paged_attention)))
    with pytest.raises(AssertionError, match=r"replay paged_tile \(put\)"):
        chip_smoke.dense_runs(torch, tpa, model, tree, prompts, v1_ids, 2,
                              **kw)


def test_dense_gates_see_a_dense_cache_that_drops_the_newest_column(
        monkeypatch):
    """(b)'s logits and (c)'s ``generate`` steps (the dense cache's
    attention) both leave the gate when that attention drops each row's
    newest column; (a) (kernel I's path) does not move."""
    model, tree, prompts, v1_ids, kw = _dense_setup()
    monkeypatch.setattr(tm, "_cached_attention",
                        chip_smoke.cached_drops_newest_column(
                            tm._cached_attention))
    rel = chip_smoke.dense_runs(torch, tpa, model, tree, prompts, v1_ids, 2,
                                **kw)["rel"]
    assert rel["a"] < 1e-5 and rel["forward"] < 1e-5
    assert min(rel["b"], rel["c"]) > 10 * chip_smoke.DENSE_REL_L2, rel


def test_dense_cross_check_refuses_a_blind_gate(monkeypatch):
    """A stand-in that is no fault at all must make the check raise: the
    check proves on every run that its gate sees a dropped column."""
    model, tree, prompts, v1_ids, kw = _dense_setup()
    monkeypatch.setattr(chip_smoke, "drops_newest_column", lambda fn: fn)
    with pytest.raises(AssertionError, match="blind"):
        chip_smoke.dense_cross_check(torch, tpa, model, tree, prompts,
                                     v1_ids, 2, **kw)


def test_dense_cross_check_refuses_a_blind_dense_cache_control(monkeypatch):
    model, tree, prompts, v1_ids, kw = _dense_setup()
    monkeypatch.setattr(chip_smoke, "cached_drops_newest_column",
                        lambda fn: fn)
    with pytest.raises(AssertionError, match="blind.*'b'.*'c'"):
        chip_smoke.dense_cross_check(torch, tpa, model, tree, prompts,
                                     v1_ids, 2, **kw)


def test_dense_runs_refuse_a_copied_tree():
    """Phase 7 holds one tree for every engine: an fp32 tree under a bf16
    model is cast by the engine, i.e. copied, and must raise."""
    model, _, prompts, v1_ids, kw = _dense_setup()
    bf16 = TransformerLM(get_preset("tiny", dtype="bfloat16", num_layers=2,
                                    num_kv_heads=2, max_seq_len=256))
    tree = bf16.init(seed=0, device="cpu")                 # fp32 leaves
    with pytest.raises(AssertionError, match="copied"):
        chip_smoke.dense_runs(torch, tpa, bf16, tree, prompts, v1_ids, 1,
                              **kw)


@pytest.mark.parametrize("fault", [False, True])
def test_dense_gate_passes_at_2e2_and_fails_a_fault(fault):
    rel = {"a": 1e-3, "b": 1.5e-2, "c": 0.0}
    limits = dict.fromkeys("abc", chip_smoke.DENSE_REL_L2)
    if fault:
        rel["b"] = 0.3
        with pytest.raises(AssertionError, match="'b'"):
            chip_smoke.gate_rel("t", rel, limits)
    else:
        chip_smoke.gate_rel("t", rel, limits)
    # the full-depth limits: each control must clear its margin
    limits = chip_smoke.DENSE_FULL_REL_L2
    margin = chip_smoke.DENSE_FULL_CONTROL_MARGIN
    faulty = {k: 1.01 * margin * lim for k, lim in limits.items()}
    chip_smoke.gate_controls("t", faulty, limits, margin)
    faulty["a"] = 0.99 * margin * limits["a"]
    with pytest.raises(AssertionError, match="blind.*'a'"):
        chip_smoke.gate_controls("t", faulty, limits, margin)
