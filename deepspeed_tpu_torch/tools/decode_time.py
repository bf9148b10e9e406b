"""Kernel A alone on the card, in each pool mode, at the serving shapes of
``chip_smoke.py``.

    python -m deepspeed_tpu_torch.tools.decode_time

Llama-3-8B's attention (H=32, K=8, d=128) over a paged pool of 128-row
blocks, 8 slots of 16 blocks, seeded random bf16 rows (int8 / int4 pools
quantized from them by ``packed_kv_append_quant``). Sets of atoms (``ATOMS``):
phase 3's eight decode atoms (pasts 38, 129, 130, 701, 301, 1101 and two
empty), a serve ``decode_batch`` step (six rows past 700, padded to
eight with empty rows, as the engine pads), phase 3's atoms over a table
cut to nine blocks (fewer CTAs of empty splits), and eight one-block pasts
(no merge). For each mode and set: the kernel's device time
(:func:`graph_ms`), its launcher in a loop on arguments prepared once
(CUDA events over 200 launches after 10 of warm-up: the host's launch
cost where that is longer), the whole wrapper, and the bound (live
rows' K/V bytes and per-token scales, the query and the outputs over 3.35
TB/s). The card's name and power limit come last. Needs a CUDA card. To
time another tree of the package (a parent commit unpacked with ``git
archive``, or a copy with one constant of ``csrc/paged_decode.cu``
edited), run this file with ``PYTHONPATH`` set to that tree: the kernels
are built from the sources of the package it imports.
"""

from __future__ import annotations

import subprocess

import torch

H, K, D, BS, NB_MAX, SLOTS = 32, 8, 128, 128, 16, 8
# name: (pasts, blocks of the table the kernel is given)
ATOMS = {"phase3": ([38, 129, 130, 701, 301, 1101, 0, 0], NB_MAX),
         "decode_batch": ([700, 701, 702, 703, 704, 705, 0, 0], NB_MAX),
         # the same atoms over a table cut to the blocks they use: fewer
         # CTAs of empty splits
         "phase3_9blocks": ([38, 129, 130, 701, 301, 1101, 0, 0], 9),
         # one split an atom: no merge
         "one_block": ([100] * 8, NB_MAX)}
HBM_BYTES_PER_S = 3.35e12


def _ms(fn, iters: int = 200) -> float:
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(launch, reps: int = 20, iters: int = 20) -> float:
    """Device time of one call of ``launch``: ``reps`` calls captured in a
    CUDA graph (the launcher's arguments made inside the capture, on its
    stream), the graph replayed ``iters`` times between CUDA events. No
    host launch cost lies between the kernels, where a loop of launches
    would time the host whenever a launch takes longer than the kernel."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    return _ms(graph.replay, iters) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("decode_time needs a CUDA card")
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops._build import KERNELS, build_all

    build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    nbp1 = SLOTS * NB_MAX + 1
    rows = [torch.randn(2, nbp1 * BS, K * D, generator=g, device=dev)
            .to(torch.bfloat16) for _ in "kv"]
    bt = (torch.randperm(nbp1 - 1, generator=g, device=dev)
          .reshape(SLOTS, NB_MAX).to(torch.int32))
    pools = {16: (*(r.reshape(2, nbp1, BS, K * D) for r in rows), {})}
    every = (torch.arange(nbp1, dtype=torch.int32, device=dev)[None],
             torch.zeros(nbp1 * BS, dtype=torch.int32, device=dev),
             torch.arange(nbp1 * BS, dtype=torch.int32, device=dev))
    for bits in (8, 4):
        lanes = K * D // (2 if bits == 4 else 1)
        kv = [torch.zeros(2, nbp1, BS, lanes, dtype=torch.int8, device=dev)
              for _ in "kv"]
        sc = torch.zeros(2, nbp1, 1, 2 * BS, device=dev)
        for which, (pool, r) in enumerate(zip(kv, rows)):
            pa.packed_kv_append_quant(pool, sc, r, *every, which, bits=bits)
        pools[bits] = (*kv, dict(kv_scale=sc, kv_bits=bits))
    q = torch.randn(8, H, D, generator=g, device=dev).to(torch.bfloat16)
    slot = torch.arange(8, dtype=torch.int32, device=dev)
    for tag, (pasts, nb) in ATOMS.items():
        pos0 = torch.tensor(pasts, dtype=torch.int32, device=dev)
        table = bt[:, :nb].contiguous()
        for bits, (kp, vp, kw) in pools.items():
            name = pa.kernel_name("paged_decode", kw.get("kv_scale"), bits)
            args, _ = pa.decode_kernel_args(q, kp, vp, 1, table, slot, pos0,
                                            **kw)
            loop = _ms(lambda: KERNELS[name].launch(*args))
            kernel = graph_ms(lambda: KERNELS[name].launch(
                *pa.decode_kernel_args(q, kp, vp, 1, table, slot, pos0,
                                       **kw)[0]))
            wrapper = _ms(lambda: pa.decode_pool_partials(
                q, kp, vp, 1, table, slot, pos0, **kw))
            row_bytes = K * D * 2 if bits == 16 else K * D * bits // 8 + 4
            nbytes = (sum(pasts) * row_bytes * 2 + q.numel() * 2
                      + 8 * H * (D + 2) * 4)
            print(f"[{tag}] {name}: kernel {kernel:.4f} ms (a loop of "
                  f"launches {loop:.4f} ms), wrapper {wrapper:.4f} ms, bound "
                  f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
