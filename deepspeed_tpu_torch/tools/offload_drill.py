"""Offload-pipeline drills on the port: fail the swap data path mid-pipeline
and exit nonzero if the clean-abort invariants break (counterpart of the
repo's ``tools/offload_drill.py``, which drives the JAX package).

Each scenario drives :class:`deepspeed_tpu_torch.offload.HostOffloadOptimizer`
on its NVMe tier (``offload/swap.py`` over the native AIO library, the
depth-2 pipeline) and, for the failure scenarios, injects one ``io_error``
at a swap site while reads, Adam and writebacks are in flight, then
asserts what the pipeline promises on failure --

* the error surfaces as ONE clean exception (no hang, no partial success),
* the buffer pool is fully returned (zero outstanding loans),
* the native AIO queue is drained (no pending ops under a dead step),
* no moment file is torn: every ``.swp`` still reads back at full size
  with finite contents,
* the same optimizer steps again once the fault is spent, and ``close()``
  after the abort is safe and idempotent.

    python -m deepspeed_tpu_torch.tools.offload_drill --list
    python -m deepspeed_tpu_torch.tools.offload_drill --scenario io-error-read
    python -m deepspeed_tpu_torch.tools.offload_drill --all --device cpu

The params live on ``--device`` (the card by default; their host tier is
page-locked there). Exit code 0 = invariants held; 1 = violated (details
on stdout as JSON).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch


def _make_optimizer(workdir, device, leaves=6, n=1 << 14, prefetch_depth=2):
    from deepspeed_tpu_torch.offload import HostOffloadOptimizer

    rng = np.random.default_rng(0)
    params = {f"l{i}": {"w": torch.from_numpy(
        rng.normal(size=(n // 64, 64)).astype(np.float32)).to(device)}
        for i in range(leaves)}
    grads = {k: {"w": torch.from_numpy(
        (rng.normal(size=(n // 64, 64)) * 0.01).astype(np.float32))
        .to(device)} for k in params}
    opt = HostOffloadOptimizer(params, lr=1e-2, nvme_path=workdir,
                               aio_threads=2, aio_chunk_mb=1,
                               prefetch_depth=prefetch_depth)
    return opt, params, grads


def _fresh_injector():
    from deepspeed_tpu_torch.resilience import set_injector

    set_injector(None)


def _moment_files_intact(opt) -> tuple:
    """Every moment file still reads back full-size and finite (an aborted
    step may leave the values one step behind -- consistency comes back
    from the checkpoint -- but no file may be torn or truncated)."""
    bad = []
    for skey in opt.master:
        for kind in (".m", ".v"):
            try:
                arr = opt.swapper.swap_in(skey + kind)
            except Exception as e:
                bad.append({"file": skey + kind, "error": repr(e)})
                continue
            if arr.shape != tuple(opt.master[skey].shape):
                bad.append({"file": skey + kind,
                            "short_read": list(arr.shape)})
            elif not np.isfinite(arr).all():
                bad.append({"file": skey + kind, "nonfinite": True})
    return (not bad), bad


def _run_io_error(workdir, device, site: str):
    from deepspeed_tpu_torch.resilience import FaultInjector, set_injector
    from deepspeed_tpu_torch.resilience.faults import InjectedIOError

    opt, params, grads = _make_optimizer(workdir, device)
    p, skipped = opt.step(grads, params, 0)          # one clean step first
    assert not skipped
    set_injector(FaultInjector(
        [{"kind": "io_error", "site": site, "times": 1}]))
    caught = None
    t0 = time.perf_counter()
    try:
        opt.step(grads, p, 1)                        # fault fires mid-pipeline
    except InjectedIOError as e:
        caught = repr(e)
    finally:
        _fresh_injector()
    abort_s = time.perf_counter() - t0
    pool = opt.swapper.pool.report()
    pending = opt.swapper.pending
    files_ok, bad_files = _moment_files_intact(opt)
    # recovery: with the fault cleared the same optimizer object can step
    recovered = False
    try:
        _, skipped = opt.step(grads, p, 2)
        recovered = not skipped
    except Exception as e:
        bad_files.append({"recovery_error": repr(e)})
    opt.close()
    opt.close()                                      # idempotent
    details = {"site": site, "caught": caught, "abort_s": round(abort_s, 3),
               "pool": pool, "native_pending": pending,
               "moment_files_intact": files_ok, "bad_files": bad_files,
               "recovered_next_step": recovered}
    ok = (caught is not None and pool["outstanding"] == 0 and pending == 0
          and files_ok and recovered)
    return ok, details


def scenario_io_error_read(workdir, device):
    """io_error at swap_read (a prefetch fails mid-pipeline) -> clean abort."""
    return _run_io_error(workdir, device, "swap_read")


def scenario_io_error_write(workdir, device):
    """io_error at swap_write (a writeback fails mid-pipeline) -> clean abort."""
    return _run_io_error(workdir, device, "swap_write")


def scenario_pool_steady_state(workdir, device):
    """Five pipelined steps after warmup: the buffer pool must not allocate
    (steady-state reuse) and every loan must return."""
    opt, params, grads = _make_optimizer(workdir, device)
    p = params
    for s in range(2):                               # warmup
        p, _ = opt.step(grads, p, s)
    baseline = opt.swapper.pool.allocations
    for s in range(2, 7):
        p, _ = opt.step(grads, p, s)
    pool = opt.swapper.pool.report()
    stall = opt._stall_fraction
    opt.close()
    details = {"baseline_allocations": baseline, "pool": pool,
               "pipeline_stall_fraction": round(stall, 4)}
    ok = (pool["allocations"] == baseline and pool["outstanding"] == 0
          and 0.0 <= stall <= 1.0)
    return ok, details


SCENARIOS = {
    "io-error-read": scenario_io_error_read,
    "io-error-write": scenario_io_error_write,
    "pool-steady-state": scenario_pool_steady_state,
}


def run_scenario(name: str, workdir=None, device="cuda") -> dict:
    from deepspeed_tpu_torch.utils import resolve_device

    fn = SCENARIOS[name]
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix=f"offload_drill_{name}_")
    t0 = time.perf_counter()
    try:
        ok, details = fn(workdir, resolve_device(device))
    except Exception as e:  # a drill crash is a failed drill
        ok, details = False, {"exception": repr(e)}
    finally:
        _fresh_injector()
    if own and ok:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"scenario": name, "ok": ok,
            "wall_s": round(time.perf_counter() - t0, 2),
            "workdir": workdir, "details": details}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", help="which drill to run")
    ap.add_argument("--all", action="store_true", help="run every scenario")
    ap.add_argument("--list", action="store_true", help="list scenarios")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh tempdir)")
    ap.add_argument("--device", default="cuda",
                    help="where the params live (default: the card)")
    args = ap.parse_args(argv)
    if args.list:
        for name, fn in SCENARIOS.items():
            print(f"{name}: {fn.__doc__.splitlines()[0]}")
        return 0
    names = list(SCENARIOS) if args.all else (
        [args.scenario] if args.scenario else None)
    if not names:
        ap.error("pass --scenario NAME, --all, or --list")
    rc = 0
    for name in names:
        verdict = run_scenario(name, workdir=args.workdir,
                               device=args.device)
        print(json.dumps(verdict, indent=2, default=str))
        if not verdict["ok"]:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
