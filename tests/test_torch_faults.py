"""The port's fault injector (``deepspeed_tpu_torch.resilience.faults``)
against the JAX package's on the CPU: ``FaultSpec`` parsing and its
refusals, and the firing schedule of every site -- one call sequence
through both injectors must give the same ``fired`` audit lists, the same
raised exceptions and the same returns. ``maybe_poison_grads`` fills each
gradient tensor with NaN (``torch.full_like``), and ``tear_checkpoint_dir``
damages a directory as the reference's does.
"""

import os

import numpy as np
import pytest
import torch

import deepspeed_tpu.resilience.faults as ref
import deepspeed_tpu_torch.resilience as port_pkg
import deepspeed_tpu_torch.resilience.faults as port
from tests._torch_threads import one_torch_thread  # noqa: F401

MODS = {"ref": ref, "port": port}

TABLE = [
    {"kind": "crash", "step": 3},
    {"kind": "crash", "site": "async_commit"},
    {"kind": "failed_collective", "times": 2},
    {"kind": "slow_collective", "delay_s": 0.0},
    {"kind": "io_error", "times": 2},
    {"kind": "io_error", "site": "swap_read"},
    {"kind": "torn_checkpoint", "step": 5, "mode": "truncate"},
    {"kind": "slow_decode", "delay_s": 0.0},
    {"kind": "cache_io_error", "site": "prefill"},
    {"kind": "decode_nan", "times": 1},
    {"kind": "shed_storm", "times": 2},
    {"kind": "preempt_storm", "times": 1},
    {"kind": "resume_io_error", "site": "nvme", "times": 2},
    {"kind": "replica_crash", "site": "r1"},
    {"kind": "slow_start", "site": "r0", "delay_s": 0.0},
    {"kind": "weight_load_io_error", "site": "publish"},
    {"kind": "migrate_io_error"},
    {"kind": "manifest_torn", "site": "x-7"},
    {"kind": "crash_during_pause_export", "site": "x-9"},
    {"kind": "moe_a2a_error", "site": "decode"},
    {"kind": "nan_grads", "step": 2},
]


def _schedule(mod, tmp):
    """Every site in a fixed order; each call's outcome is recorded as the
    exception's type name and message, or its return."""
    inj = mod.FaultInjector(TABLE)
    man = os.path.join(tmp, "manifest.json")
    with open(man, "wb") as f:
        f.write(b"x" * 100)
    tag = os.path.join(tmp, "tag")
    os.makedirs(tag)
    with open(os.path.join(tag, "a.bin"), "wb") as f:
        f.write(b"y" * 64)
    calls = [
        ("maybe_crash", 1), ("maybe_crash", 3), ("maybe_crash", 3),
        ("on_collective", "all_reduce"), ("on_collective", "all_reduce"),
        ("on_collective", "all_reduce"), ("on_collective", "barrier"),
        ("on_checkpoint_io", "save"), ("on_checkpoint_io", "load"),
        ("on_checkpoint_io", "async_commit"),
        ("on_checkpoint_io", "async_commit"), ("on_checkpoint_io", "save"),
        ("on_swap_io", "swap_write"), ("on_swap_io", "swap_read"),
        ("on_swap_io", "swap_read"),
        ("maybe_tear_checkpoint", tag, 4), ("maybe_tear_checkpoint", tag, 5),
        ("on_serving_step", "decode"), ("on_serving_step", "decode"),
        ("on_serving_step", "prefill"), ("on_serving_step", "prefill"),
        ("shed_forced",), ("shed_forced",), ("shed_forced",),
        ("preempt_forced",), ("preempt_forced",),
        ("on_resume_read", "host"), ("on_resume_read", "nvme"),
        ("on_resume_read", "nvme"), ("on_resume_read", "nvme"),
        ("on_replica_loop", "r0"), ("on_replica_loop", "r1"),
        ("on_replica_start", "r0"), ("on_weight_load", "warm"),
        ("on_weight_load", "publish"), ("on_migrate_read", "host"),
        ("on_migrate_read", "nvme"), ("maybe_tear_manifest", man, "x-1"),
        ("maybe_tear_manifest", man, "x-7"), ("on_pause_export", "x-1"),
        ("on_pause_export", "x-9"), ("on_pause_export", "x-9"),
        ("on_moe_dispatch", "prefill"), ("on_moe_dispatch", "decode"),
    ]
    out = []
    for name, *args in calls:
        try:
            ret = getattr(inj, name)(*args)
            out.append((name, args[-1:] if args else [], "ok", ret))
        except (mod.InjectedCrash, mod.InjectedIOError) as e:
            out.append((name, args[-1:], type(e).__name__, str(e)))
    out.append(("sizes", os.path.getsize(man),
                os.path.getsize(os.path.join(tag, "a.bin"))))
    return inj.fired, out, bool(inj), bool(mod.FaultInjector())


def test_firing_schedule_equals_reference(tmp_path):
    got = {}
    for k, mod in MODS.items():
        os.makedirs(tmp_path / k)
        got[k] = _schedule(mod, str(tmp_path / k))
    assert got["port"] == got["ref"]
    fired = got["port"][0]
    assert "crash@step:step=3" in fired
    assert fired.count("resume_io_error@resume:nvme:step=-1") == 2
    assert "manifest_torn@manifest:x-7:step=-1" in fired
    assert got["port"][1][-1] == ("sizes", 50, 32)
    assert got["port"][2:] == (True, False)


@pytest.mark.parametrize("bad,match", [
    ({"kind": "bogus"}, "unknown fault kind"),
    ({"kind": "crash", "stepp": 3}, "unknown fault spec keys"),
])
def test_spec_refusals_equal_reference(bad, match):
    msgs = []
    for mod in MODS.values():
        with pytest.raises(ValueError, match=match) as e:
            mod.FaultSpec.from_dict(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_spec_fields_and_kinds_equal_reference():
    import dataclasses

    assert port.FaultSpec.KINDS == ref.FaultSpec.KINDS
    fields = [(f.name, f.default) for f in dataclasses.fields(port.FaultSpec)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(ref.FaultSpec)]
    for d in TABLE:
        assert dataclasses.asdict(port.FaultSpec.from_dict(d)) == \
            dataclasses.asdict(ref.FaultSpec.from_dict(d))


def test_poison_grads_fills_each_tensor_with_nan():
    inj = port.FaultInjector([{"kind": "nan_grads", "step": 2}])
    grads = {"w": torch.ones(3, 4), "b": [torch.zeros(2, dtype=torch.bfloat16)]}
    assert inj.maybe_poison_grads(1, grads) is grads
    out = inj.maybe_poison_grads(2, grads)
    assert torch.isnan(out["w"]).all() and out["w"].shape == (3, 4)
    assert torch.isnan(out["b"][0]).all()
    assert out["b"][0].dtype == torch.bfloat16
    assert torch.equal(grads["w"], torch.ones(3, 4))    # input untouched
    assert inj.maybe_poison_grads(2, grads) is grads    # fired once
    rinj = ref.FaultInjector([{"kind": "nan_grads", "step": 2}])
    rinj.maybe_poison_grads(1, {"w": np.ones(3)})
    rinj.maybe_poison_grads(2, {"w": np.ones(3)})
    assert inj.fired == rinj.fired == ["nan_grads@grads:step=2"]


def test_poison_logits_and_process_injector():
    inj = port.FaultInjector([{"kind": "decode_nan"}])
    out = inj.maybe_poison_logits(np.ones((2, 5), np.float32))
    assert np.isnan(out).all() and out.shape == (2, 5)
    assert inj.maybe_poison_logits(7.0) == 7.0
    old = port_pkg.get_injector()
    try:
        mine = port_pkg.set_injector(inj)
        assert mine is inj is port.get_injector()
        fresh = port_pkg.set_injector(None)
        assert not fresh and fresh is port.get_injector()
    finally:
        port_pkg.set_injector(old)


@pytest.mark.parametrize("mode", ["truncate", "corrupt", "unlink"])
def test_tear_checkpoint_dir_equals_reference(tmp_path, mode):
    out = {}
    for k, mod in MODS.items():
        d = tmp_path / k
        os.makedirs(d / "sub")
        (d / "small.bin").write_bytes(b"a" * 10)
        (d / "sub" / "big.bin").write_bytes(bytes(range(200)))
        mod.tear_checkpoint_dir(str(d), mode=mode)
        big = d / "sub" / "big.bin"
        out[k] = (big.exists() and big.read_bytes(),
                  (d / "small.bin").read_bytes())
    assert out["port"] == out["ref"]
    with pytest.raises(ValueError, match="unknown tear mode"):
        port.tear_checkpoint_dir(str(tmp_path / "port"), mode="shred")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        port.tear_checkpoint_dir(str(tmp_path / "empty"))
