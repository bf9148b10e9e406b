"""Kernel H's decode path (``qmm_rows_kernel``, B <= 16) on the card
against its contraction split count, at the layer products and the head of
a llama3-8b decode step.

    python -m deepspeed_tpu_torch.tools.qmm_sweep

For wqkv (D=4096, F=6144), wo (4096, 4096), w_gateup (4096, 28672), w_down
(14336, 4096) and the head (4096, 128256), int4 and int8, B=6: the kernel's
device time for each split count (``decode_time.graph_ms``: a CUDA graph of
20 launches, each reading the next layer of a stack of random packed bytes
three times the size of L2, so every launch reads its weights from HBM as
in serving), beside the count ``qmm_splits`` picks and the bound (weight
bytes / 3.35 TB/s). The card's name and power limit come last. Needs a
CUDA card.
"""

from __future__ import annotations

import itertools
import subprocess

import torch

SHAPES = (("wqkv", 4096, 6144), ("wo", 4096, 4096),
          ("w_gateup", 4096, 28672), ("w_down", 14336, 4096),
          ("head", 4096, 128256))
SPLITS = (1, 2, 3, 4, 6, 8, 9, 12, 16, 28)
B = 6
COLD_BYTES = 150e6      # three times the H100's 50 MB L2


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("qmm_sweep needs a CUDA card")
    from deepspeed_tpu_torch.ops import quant_matmul as qm
    from deepspeed_tpu_torch.ops import stream_ptr
    from deepspeed_tpu_torch.ops._build import KERNELS
    from deepspeed_tpu_torch.tools.decode_time import graph_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    kern = KERNELS["qmm_stacked"]
    for name, D, F in SHAPES:
        G = D // 128
        for bits in (4, 8):
            layer_bytes = D * F * bits // 8
            L = max(2, -(-int(COLD_BYTES) // layer_bytes))
            packed = torch.randint(-128, 128, (L, D * bits // 8, F),
                                   generator=g, device=dev, dtype=torch.int8)
            scales = (torch.rand(L, G, F, generator=g, device=dev)
                      * 1e-2).bfloat16()
            x = torch.randn(B, D, generator=g, device=dev).bfloat16()
            times = {}
            for sp in (s for s in SPLITS if s <= G):
                lay = itertools.cycle(range(L))

                def launch():
                    out = torch.empty(B, F, dtype=torch.bfloat16, device=dev)
                    work = (torch.empty(sp, B, F, device=dev) if sp > 1
                            else None)
                    kern.launch(x, packed, scales, out, work, B, D, F, G,
                                bits, sp, next(lay), stream_ptr(x))

                times[sp] = round(graph_ms(launch), 4)
            print(f"{name} int{bits} B={B} D={D} F={F}: ms by splits {times}, "
                  f"qmm_splits picks {qm.qmm_splits(B, F, G)}, bound "
                  f"{layer_bytes / 3.35e9:.4f} ms", flush=True)
            del packed, scales
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
