"""Where a serving step's time goes on the card: ``torch.profiler`` over
warm ``decode_batch`` and mixed ``put`` steps of the engine.

    python -m deepspeed_tpu_torch.tools.serve_profile [--preset llama3-8b]
        [--batch 6] [--steps 8] [--past 700] [--dense]

Three configurations, one after the other: the bf16 engine
(``decode_batch`` and a mixed ``put``), then Q1 and Q2, the quantized
engines of ``chip_smoke.py``'s serve-quant phase (int4 / int8 weights
through kernels G/H, an int8 / int4 KV pool through A/B's int modes):
``decode_batch`` and a 256-row chunk step (a ``put`` of the next 256
tokens of a prompt already started: every layer product goes through H at
B=256, as in the chunk steps of a mixed ``put``). Prints, for each
profiled phase, the wall time per step (profiler on, so above an
unprofiled run), the device time the profiler recorded (sum of CUDA kernel
durations, one stream), the device's idle share of the wall time, the
number of kernel launches, the top kernels by device time, and the device
time and launches of kernel A (``paged_decode_kernel``), of kernels G/H
(``qmm_rows_kernel`` at B <= 16, ``qmm_tile_kernel`` above) and of the
second pass that adds G/H's splits above 16 rows (``split_sum_kernel``;
at B <= 16 the decode kernel adds its own), of kernels B and C (the chunk
steps' past partials and seeded self flash, each pool mode; the names of
both their designs, so a parent tree profiled with this file reads the
same lines) and of kernel I; then the
card's name and power limit. ``--dense`` profiles the ``packed=False``
engine instead (kernel I, chip_smoke's phase 7 engine (a)): a ``put`` of
phase 4's four prompts (37, 128, 129 and 700 tokens: one 700-row tile)
and ``--steps`` single-token ``put`` steps of the four. Weights are random
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
    a_rows = [r for r in rows if "paged_decode_kernel" in r[0]]
    a_ms = sum(r[1] for r in a_rows) / 1e3 / steps_per_call
    a_calls = sum(r[2] for r in a_rows) / steps_per_call
    print(f"[{name}] kernel A: {a_ms:.3f} ms/step, {a_calls:.1f} calls/step",
          flush=True)
    for tag, keys in (("kernels G/H", ("qmm_",)),
                      ("G/H split sums", ("split_sum_kernel",)),
                      ("kernel B", ("paged_past_kernel", "PastMode",
                                    "PastQuantMode")),
                      ("kernel C", ("chunk_self_kernel", "SelfMode")),
                      ("kernel I", ("paged_tile", "TileMode"))):
        sel = [r for r in rows if any(k in r[0] for k in keys)]
        ms = sum(r[1] for r in sel) / 1e3 / steps_per_call
        calls = sum(r[2] for r in sel) / steps_per_call
        print(f"[{name}] {tag}: {ms:.3f} ms/step, {calls:.1f} calls/step",
              flush=True)
    return prof


def print_card() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--past", type=int, default=700,
                    help="prompt length of each sequence before decoding")
    ap.add_argument("--dense", action="store_true",
                    help="profile the packed=False engine (kernel I)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_profile needs a CUDA card")
    import gc

    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset

    cfg = get_preset(args.preset, param_dtype="bfloat16")
    if args.dense:
        eng = InferenceEngineV2(TransformerLM(cfg), max_sequences=8,
                                max_seq_len=2048, block_size=128,
                                device="cuda", packed=False)
        rng = np.random.default_rng(0)
        uids = [0, 1, 2, 3]
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                   for n in (37, 128, 129, 700)]

        def prompt_put():
            eng.put(uids, prompts)
            eng.flush(uids)

        profile_phase("dense prompt put 4 prompts", prompt_put, 1)
        eng.put(uids, prompts)
        one = [np.array([1], np.int32)] * len(uids)
        profile_phase("dense decode put B=4",
                      lambda: [eng.put(uids, one) for _ in range(args.steps)],
                      args.steps)
        print_card()
        return 0
    uids = list(range(args.batch))
    toks = [1] * args.batch
    for tag, quant in (("bf16", {}),
                       ("Q1", dict(weight_dtype="int4", kv_dtype="int8")),
                       ("Q2", dict(weight_dtype="int8", kv_dtype="int4"))):
        eng = InferenceEngineV2(TransformerLM(cfg), max_sequences=8,
                                max_seq_len=2048, block_size=128,
                                device="cuda", **quant)
        rng = np.random.default_rng(0)
        eng.put(uids, [rng.integers(1, cfg.vocab_size,
                                    args.past).astype(np.int32)
                       for _ in uids])
        profile_phase(f"{tag} decode_batch B={args.batch}",
                      lambda: eng.decode_batch(uids, toks, steps=args.steps),
                      args.steps)
        if not quant:
            spare = 7
            chunk = rng.integers(1, cfg.vocab_size, 256).astype(np.int32)

            def mixed():
                eng.put(uids + [spare], [np.array([t], np.int32)
                                         for t in toks] + [chunk])
                eng.flush([spare])

            profile_phase(f"{tag} mixed put B={args.batch}+256", mixed, 1)
        else:
            spare = 7
            eng.put([spare], [rng.integers(1, cfg.vocab_size,
                                           256).astype(np.int32)])
            chunk = rng.integers(1, cfg.vocab_size, 256).astype(np.int32)
            profile_phase(f"{tag} 256-row chunk put",
                          lambda: eng.put([spare], [chunk]), 1)
            eng.flush([spare])
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    print_card()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
