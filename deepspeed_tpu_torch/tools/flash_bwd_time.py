"""Kernels E (dq) and F (dk, dv) alone on the card, and the two together in
turns with one SDPA backward, at the training shapes of ``chip_smoke.py``.

    python -m deepspeed_tpu_torch.tools.flash_bwd_time

At Llama-3.2-1B's B=4 T=S=2048 H=32 K=8 d=64 and at d=128 (B=1), causal,
seeded random bf16 inputs: each kernel's launcher on arguments prepared
once (CUDA events over 20 launches after 3 of warm-up), its rate in TFLOP/s
(E: 6 d, F: 8 d FLOPs per live (row, column) pair and query head), then
SDPA's backward (its backend named), E+F, E+F, SDPA's backward. The
card's name and power limit come last. Needs a CUDA card. To time another
tree of the package (a parent commit unpacked with ``git archive``), run
this file with ``PYTHONPATH`` set to that tree: the kernels are built from
the sources of the package it imports. ``chip_smoke.py`` takes its SDPA
backward from here.
"""

from __future__ import annotations

import subprocess

import torch

SHAPES = (("train", 4, 2048, 32, 8, 64), ("d128", 1, 2048, 32, 8, 128))


def _ms(fn, iters: int = 20) -> float:
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


def sdpa_backward(q, k, v, do):
    """One SDPA backward (dq, dk, dv) at the shape of ``q`` [B,T,H,d] /
    ``k``, ``v`` [B,S,K,d], causal GQA: ``(fn, backend name)``, trying the
    flash, cuDNN and memory-efficient backends in turn."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    dot = do.transpose(1, 2).contiguous()
    xs = [x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v)]
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                out = sdpa(*xs, is_causal=True, enable_gqa=True)
        except RuntimeError:          # this backend does not take the call
            continue
        return (lambda: torch.autograd.grad(out, xs, dot, retain_graph=True),
                backend.name)
    raise RuntimeError("no SDPA backend takes a causal GQA call")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_time needs a CUDA card")
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops._build import KERNELS

    print(f"package: {fa.__file__}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    e, f = KERNELS["flash_bwd_dq"], KERNELS["flash_bwd_dkv"]
    for tag, B, T, H, K, d in SHAPES:
        q, do = (torch.randn(B, T, H, d, generator=g, device=dev).bfloat16()
                 for _ in "qo")
        k, v = (torch.randn(B, T, K, d, generator=g, device=dev).bfloat16()
                for _ in "kv")
        out, lse = fa.flash_forward(q, k, v, causal=True)
        ins = (q, k, v, do, lse, fa.flash_delta(out, do))
        args_e, _ = fa.flash_bwd_kernel_args(*ins, part="dq", causal=True)
        args_f, _ = fa.flash_bwd_kernel_args(*ins, part="dkv", causal=True)
        pairs = B * H * T * (T + 1) // 2
        ms_e = _ms(lambda: e.launch(*args_e))
        ms_f = _ms(lambda: f.launch(*args_f))
        both = lambda: (e.launch(*args_e), f.launch(*args_f))  # noqa: E731
        sdpa, backend = sdpa_backward(q, k, v, do)
        turns = (_ms(sdpa), _ms(both), _ms(both), _ms(sdpa))
        lib, ef = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        print(f"{tag} [B={B} T=S={T} H={H} K={K} d={d}, causal]: E "
              f"{ms_e:.4f} ms ({6 * d * pairs / ms_e / 1e9:.1f} TFLOP/s), F "
              f"{ms_f:.4f} ms ({8 * d * pairs / ms_f / 1e9:.1f} TFLOP/s); in "
              f"turns: SDPA backward ({backend}) {turns[0]:.4f}, E+F "
              f"{turns[1]:.4f}, E+F {turns[2]:.4f}, SDPA backward "
              f"{turns[3]:.4f} ms; (E+F) / SDPA {ef / lib:.2f}", flush=True)
        del q, k, v, do, out, lse, ins, args_e, args_f, sdpa
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
