"""Crash-and-resume drill of the training engine: the reference's
``tests/unit/test_resilience.py::test_e2e_crash_torn_checkpoint_recovery``
without the elastic agent (``elasticity/`` is not ported yet), on one
device.

A trainer runs as a subprocess with ``DSTPU_CHECKPOINT_DIR`` set, saving a
checkpoint after every step until step 6:

* run 0 tears the step-3 tag as it commits (``torn_checkpoint``) and
  hard-crashes during step 4 (``crash`` at ``global_steps == 3``, exit code
  43) before the step-4 save can land;
* run 1 loads: the torn step-3 tag fails verification and the load falls
  back to the verified step-2 tag; it heals one injected NaN step
  (``nan_grads`` at step 4) and reaches step 6, writing
  ``resilience_report.json`` and its record ``run1.json``.

    python -m deepspeed_tpu_torch.tools.crash_resume --ckpt DIR [--device cpu]

exits non-zero when an outcome differs from the reference's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict

END_STEP = 6
CRASH_EXIT = 43
SEQ = 32

#: on the card: a head dim the kernels take, in their dtype (the tiny
#: preset's width as ``tools/elastic_drill.py`` widens it)
_CARD_TINY = {"hidden_size": 256, "num_heads": 4, "dtype": "bfloat16"}


def faults(restart: int):
    """Run 0: tear the step-3 tag, then lose the host DURING step 4 (the
    crash keys on ``global_steps``, which still reads 3 inside step 4).
    Run 1: a clean run with one NaN step to heal."""
    if restart == 0:
        return [{"kind": "torn_checkpoint", "step": 3},
                {"kind": "crash", "step": 3, "hard": True,
                 "exit_code": CRASH_EXIT}]
    return [{"kind": "nan_grads", "step": 4}]


def trainer(ckpt: str, restart: int, device: str) -> Dict:
    """One incarnation of the trainer (the subprocess's body)."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch import TransformerLM, get_preset

    kw = dict(_CARD_TINY) if torch.device(device).type == "cuda" else {}
    eng, *_ = tds.initialize(TransformerLM(get_preset("tiny", **kw)), {
        "train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
        "zero_optimization": {"stage": 2},
        "resilience": {"enabled": True, "faults": faults(restart),
                       "checkpoint": {"keep_last_k": 3}},
        "steps_per_print": 100}, device=device)
    if os.path.exists(os.path.join(ckpt, "latest")):
        eng.load_checkpoint(ckpt)
    rec = {"global_batch": eng.train_batch_size(),
           "micro": eng.train_micro_batch_size_per_gpu(),
           "start_step": eng.global_steps}
    rng = np.random.default_rng(0)
    B = eng.train_micro_batch_size_per_gpu()
    while eng.global_steps < END_STEP:
        for _ in range(eng.gradient_accumulation_steps()):
            loss = eng.forward({"input_ids": rng.integers(0, 256, (B, SEQ))})
            eng.backward(loss)
        eng.step()
        eng.save_checkpoint(ckpt)
    rec["end_step"] = eng.global_steps
    rec["report"] = eng.resilience_report()
    eng.write_resilience_report(ckpt)
    eng.shutdown()
    with open(os.path.join(ckpt, f"run{restart}.json"), "w") as f:
        json.dump(rec, f)
    return rec


def drill(ckpt: str, device: str = "cuda", timeout_s: float = 600.0
          ) -> Dict:
    """Run 0 then run 1 as subprocesses on ``ckpt``; returns their exit
    codes, run 1's record and the report file."""
    os.makedirs(ckpt, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, DSTPU_CHECKPOINT_DIR=ckpt,
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    codes = []
    for restart in (0, 1):
        proc = subprocess.run(
            [sys.executable, "-m", "deepspeed_tpu_torch.tools.crash_resume",
             "--ckpt", ckpt, "--device", device, "--run", str(restart)],
            env=env, cwd=root, timeout=timeout_s, capture_output=True,
            text=True)
        codes.append(proc.returncode)
        if proc.returncode not in (0, CRASH_EXIT):
            raise RuntimeError(f"trainer run {restart} exited "
                               f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    with open(os.path.join(ckpt, "run1.json")) as f:
        run1 = json.load(f)
    with open(os.path.join(ckpt, "resilience_report.json")) as f:
        report = json.load(f)
    return {"exit_codes": codes, "run1": run1, "report": report}


def check(result: Dict) -> None:
    """The reference's outcomes; raises AssertionError naming the first
    that differs."""
    run1, rep = result["run1"], result["run1"]["report"]
    want = {
        "exit codes": (result["exit_codes"], [CRASH_EXIT, 0]),
        "run 1 start step (the verified step-2 tag)": (run1["start_step"], 2),
        "run 1 end step": (run1["end_step"], END_STEP),
        "load fallbacks": (rep["checkpoint"]["load_fallbacks"], 1),
        "healed NaN steps": (rep["guard"]["bad_steps_skipped"], 1),
        "skipped steps": (rep["skipped_steps"], 1),
        "report file's load fallbacks": (
            result["report"]["checkpoint"]["load_fallbacks"], 1),
    }
    for what, (got, exp) in want.items():
        if got != exp:
            raise AssertionError(f"crash-and-resume: {what} {got} != {exp}")
    if rep["checkpoint"]["verify_failures"] < 1:
        raise AssertionError("crash-and-resume: the torn step-3 tag was not "
                             "rejected (verify_failures 0)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--run", type=int, default=None,
                    help="run one trainer incarnation (the drill's "
                         "subprocess)")
    args = ap.parse_args(argv)
    if args.run is not None:
        trainer(args.ckpt, args.run, args.device)
        return 0
    result = drill(args.ckpt, args.device)
    check(result)
    print(json.dumps({"ok": True, **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
