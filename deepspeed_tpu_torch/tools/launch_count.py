"""How often a ``torch.profiler`` trace of one kernel call on the card
misses its records, read two ways.

    python -m deepspeed_tpu_torch.tools.launch_count [--traces 300]

Kernel C (``self_attention``, unseeded) on phi3-mini's heads (H = K = 32,
d = 96) over two 256-row atoms of seeded random bf16 rows is one launch a
call. The tool profiles that call ``--traces`` times and prints how many
traces read each count: first as a bare trace of the call (every device
record summed), then by ``chip_smoke.device_launches``, which brackets the
call with two control kernels and reads only a trace that shows both; it
also prints how many traces ``device_launches`` had to take again. The
card's name and power limit come last. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=300)
    n = ap.parse_args().traces
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import paged_attention as pa

    _build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    H, K, d, tq = 32, 32, 96, 256
    q = torch.randn(2 * tq, H, d, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(2 * tq, K, d, generator=g, device=dev).bfloat16()
            for _ in "kv")
    alen = torch.tensor([256, 200], dtype=torch.int32, device=dev)

    def call():
        return pa.self_attention(q, k, v, alen, tq)

    bare = {}
    for _ in range(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        c = sum(e.count for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA)
        bare[c] = bare.get(c, 0) + 1
    print(f"bare trace, launches read: traces {bare}", flush=True)
    taken_again = []
    chip_smoke.log = taken_again.append
    read = {}
    for _ in range(n):
        c = chip_smoke.device_launches(torch, call)
        read[c] = read.get(c, 0) + 1
    print(f"device_launches, launches read: traces {read}; traces taken "
          f"again {len(taken_again)}", flush=True)
    for msg in taken_again[:3]:
        print(f"  {msg}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
