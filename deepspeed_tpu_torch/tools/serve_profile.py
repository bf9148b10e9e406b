"""Where a serving step's time goes on the card: ``torch.profiler`` over
warm ``decode_batch`` and mixed ``put`` steps of the engine.

    python -m deepspeed_tpu_torch.tools.serve_profile [--preset llama3-8b]
        [--batch 6] [--steps 8] [--past 700]

Prints, for each profiled phase, the wall time per step (profiler on, so
above an unprofiled run), the device time the profiler recorded (sum of
CUDA kernel durations, one stream), the device's idle share of the wall
time, the number of kernel launches, and the top kernels by device time;
then the card's name and power limit. Weights are random
(seed 0); the numbers depend on shapes only. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch


def _device_events(prof):
    """(name, device us, count) of every kernel the profiler saw on the
    card (operator-level rows, which re-count their kernels, are left out)."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key, float(us), int(e.count)))
    return sorted(rows, key=lambda r: -r[1])


def profile_phase(name, fn, steps_per_call: int, top: int = 12) -> None:
    from torch.profiler import ProfilerActivity, profile

    fn()                                           # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_events(prof)
    dev_ms = sum(r[1] for r in rows) / 1e3
    launches = sum(r[2] for r in rows)
    print(f"[{name}] wall {wall_ms / steps_per_call:.2f} ms/step, device "
          f"{dev_ms / steps_per_call:.2f} ms/step (idle share "
          f"{1 - dev_ms / wall_ms:.3f}), {launches / steps_per_call:.0f} "
          f"kernel launches/step", flush=True)
    if not rows:
        print(f"[{name}] the profiler recorded no device time", flush=True)
    for key, us, count in rows[:top]:
        print(f"[{name}]   {us / 1e3 / steps_per_call:8.3f} ms/step "
              f"{count / steps_per_call:7.1f} calls/step  {key[:90]}",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--past", type=int, default=700,
                    help="prompt length of each sequence before decoding")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_profile needs a CUDA card")
    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset

    cfg = get_preset(args.preset, param_dtype="bfloat16")
    eng = InferenceEngineV2(TransformerLM(cfg), max_sequences=8,
                            max_seq_len=2048, block_size=128, device="cuda")
    rng = np.random.default_rng(0)
    uids = list(range(args.batch))
    eng.put(uids, [rng.integers(1, cfg.vocab_size, args.past).astype(np.int32)
                   for _ in uids])
    toks = [1] * args.batch
    profile_phase(f"decode_batch B={args.batch}",
                  lambda: eng.decode_batch(uids, toks, steps=args.steps),
                  args.steps)
    spare = 7
    chunk = rng.integers(1, cfg.vocab_size, 256).astype(np.int32)

    def mixed():
        eng.put(uids + [spare], [np.array([t], np.int32) for t in toks]
                + [chunk])
        eng.flush([spare])

    profile_phase(f"mixed put B={args.batch}+256", mixed, 1)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
