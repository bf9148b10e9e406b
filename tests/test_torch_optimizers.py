"""The port's lamb, lion, adagrad, adafactor, rmsprop and muon against the
reference's optax chains on the CPU (fp32): five updates of one tree with a
stacked ``[L, D, F]`` leaf, a 2-D leaf (both dims >= 128, so adafactor
factors both) and a 1-D leaf, under a warmup schedule and global-norm
clipping. The final parameters agree to 1e-6 relative (atol 1e-7). Muon's
final parameters agree to 1e-2 relative L2, and its total displacement to
2e-2: its bf16 Newton-Schulz iteration is bit-equal to the reference's on
equal bf16 products, but the two CPU GEMMs sum in different orders, and a
product that rounds to the other bf16 neighbour is amplified by the
quintic iteration (0.3-1.3% of an update here). The 1-bit names still
raise, naming their ROADMAP item."""

import re
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.optimizers import build_optimizer as jax_optimizer
from deepspeed_tpu_torch.config import from_config
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from tests._torch_threads import one_torch_thread  # noqa: F401

SHAPES = {"stack": (2, 128, 136), "w": (144, 128), "b": (24,)}
SCHED = {"warmup_min_lr": 1e-3, "warmup_max_lr": 1e-2,
         "warmup_num_steps": 3}
STEPS = 5
OPTIMIZERS = [
    ("lamb", {"weight_decay": 0.01}, 1.0),
    ("lion", {"weight_decay": 0.1, "betas": [0.9, 0.99]}, 0.0),
    ("adagrad", {}, 1.0),
    ("adafactor", {}, 0.0),
    ("rmsprop", {"momentum": 0.9}, 1.0),
    ("rmsprop", {}, 0.0),
    ("muon", {}, 1.0),
    ("muon", {"momentum": 0.9}, 0.0),
]


def _tree(seed):
    rng = np.random.default_rng(seed)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    gs = [{k: (0.5 * rng.standard_normal(s)).astype(np.float32)
           for k, s in SHAPES.items()} for _ in range(STEPS)]
    return p0, gs


@pytest.mark.parametrize("name,params,clip", OPTIMIZERS,
                         ids=[f"{o[0]}-{i}" for i, o in enumerate(OPTIMIZERS)])
def test_updates_match_optax(name, params, clip):
    p0, gs = _tree(11)
    jtx = jax_optimizer(name, params, jlr.warmup_lr(**SCHED),
                        gradient_clipping=clip)
    jp = p0
    jstate = jtx.init(jp)
    for g in gs:
        upd, jstate = jtx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    opt = build_optimizer(name, params, tlr.warmup_lr(**SCHED),
                          gradient_clipping=clip)
    tp = [torch.from_numpy(p0[k].copy()) for k in SHAPES]
    state = opt.init(tp)
    for g in gs:
        opt.update(tp, [torch.from_numpy(g[k].copy()) for k in SHAPES],
                   state)
    assert state["count"] == STEPS
    for k, t in zip(SHAPES, tp):
        got, want = t.numpy(), np.asarray(jp[k])
        assert not np.array_equal(want, p0[k]), k
        if name == "muon":
            moved = want - p0[k]
            rel = np.linalg.norm((got - p0[k]) - moved) / np.linalg.norm(moved)
            assert rel <= 2e-2, (k, rel)
            assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=k)


def test_adafactor_factors_the_two_largest_dims():
    opt = build_optimizer("adafactor", {"lr": 1e-2})
    state = opt.init([torch.zeros(SHAPES[k]) for k in SHAPES])
    rows = [None if r is None else tuple(r.shape) for r in state["v_row"]]
    cols = [None if c is None else tuple(c.shape) for c in state["v_col"]]
    assert rows == [(2, 128), (128,), None]
    assert cols == [(2, 136), (144,), None]
    assert state["v"][2].shape == SHAPES["b"]


@pytest.mark.parametrize("name", ["OneBitAdam", "zero_one_adam",
                                  "OneBitLamb"])
def test_one_bit_names_raise_naming_their_item(name):
    with pytest.raises(NotImplementedError,
                       match='"Mesh, ZeRO and tensor parallelism"'):
        build_optimizer(name, {})
    assert "**Mesh, ZeRO and tensor parallelism" in _roadmap_section_1()


def _roadmap_section_1() -> str:
    text = (Path(__file__).resolve().parent.parent / "ROADMAP.md").read_text()
    return text.split("### 1.", 1)[1].split("### 2.", 1)[0]


@pytest.mark.parametrize("raw", [
    {"elasticity": {}}, {"pipeline": {}}, {"autotuning": {}},
    {"sequence_parallel": {}}, {"monitor_config": {}}, {"compression": {}},
    {"mesh": {"tp": 2}}, {"mesh": "auto"},
    {"zero_optimization": {"zero_hpz_partition_size": 2}},
    {"zero_optimization": {"zero_quantized_weights": True}}],
    ids=lambda r: "-".join(str(k) for k in r) + "-" + "-".join(
        str(k) for v in r.values() if isinstance(v, dict) for k in v))
def test_config_refusals_name_a_roadmap_item(raw):
    with pytest.raises(NotImplementedError) as e:
        from_config(raw)
    item = re.search(r'ROADMAP section 1, "([^"]+)"', str(e.value))
    assert item, str(e.value)
    assert f"**{item.group(1)}" in _roadmap_section_1()
