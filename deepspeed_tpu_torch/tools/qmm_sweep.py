"""Kernel H's time on the card against its contraction split count, at the
four layer products of a llama3-8b decode step.

    python -m deepspeed_tpu_torch.tools.qmm_sweep

For wqkv (D=4096, F=6144), wo (4096, 4096), w_gateup (4096, 28672) and
w_down (14336, 4096), int4 and int8, B=6: the kernel-alone time (CUDA
events, 40 launches cycling over an 8-layer stack of random packed bytes,
each layer read from HBM as in serving) for each split count, beside the
count ``qmm_splits`` picks and the bound (weight bytes / 3.35 TB/s). The
card's name and power limit come last. Needs a CUDA card.
"""

from __future__ import annotations

import itertools
import subprocess

import torch

SHAPES = (("wqkv", 4096, 6144), ("wo", 4096, 4096),
          ("w_gateup", 4096, 28672), ("w_down", 14336, 4096))
SPLITS = (1, 2, 4, 8, 16)
B, LAYERS = 6, 8


def _ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("qmm_sweep needs a CUDA card")
    from deepspeed_tpu_torch.ops import quant_matmul as qm
    from deepspeed_tpu_torch.ops import stream_ptr
    from deepspeed_tpu_torch.ops._build import KERNELS

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    kern = KERNELS["qmm_stacked"]
    for name, D, F in SHAPES:
        G = D // 128
        for bits in (4, 8):
            packed = torch.randint(-128, 128, (LAYERS, D * bits // 8, F),
                                   generator=g, device=dev, dtype=torch.int8)
            scales = (torch.rand(LAYERS, G, F, generator=g, device=dev)
                      * 1e-2).bfloat16()
            x = torch.randn(B, D, generator=g, device=dev).bfloat16()
            times = {}
            for sp in SPLITS:
                args = []
                for i in range(LAYERS):
                    out = torch.empty(B, F, dtype=torch.bfloat16, device=dev)
                    work = (torch.empty(sp, B, F, device=dev) if sp > 1
                            else None)
                    args.append((x, packed, scales, out, work, B, D, F, G,
                                 bits, sp, i, stream_ptr(x)))
                cyc = itertools.cycle(args)
                times[sp] = round(_ms(lambda: kern.launch(*next(cyc)),
                                      5 * LAYERS), 4)
            print(f"{name} int{bits} B={B} D={D} F={F}: ms by splits {times}, "
                  f"qmm_splits picks {qm.qmm_splits(B, F, G)}, bound "
                  f"{D * F * bits / 8 / 3.35e9:.4f} ms", flush=True)
            del packed, scales
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
