#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

1. device  -- require CUDA; print the card's name and power limit;
2. build   -- compile the port's CUDA kernels from ``deepspeed_tpu_torch/
              csrc`` (one ``nvcc`` per source, in parallel), timed; print
              the ptxas report (registers, stack and spill bytes; a spill
              fails the run) and shared memory of kernels D, E and F, of
              A and B in each pool mode, of C and of I's decode and flash
              regimes per head dim (64, 96, 128, 256), of G/H's decode
              kernel per
              weight width and row tile (8 or 16 rows), and of G/H's
              multi-row kernel per weight width;
3. kernels -- kernels A-D at the serving path's Llama-3-8B shapes (H=32,
              K=8, d=128, block 128) on seeded random bf16 inputs, each held
              against its plain PyTorch version (atol = rtol = 2e-2 on
              normalised outputs, 1e-2 on m / lse; D's out per 64-row tile
              like dq/dk/dv below) and timed: the kernel alone (its
              launcher on arguments prepared once; A, B and C, shorter
              than their launch from Python, from a CUDA graph of
              launches), the whole wrapper, its
              plain version, its bound and, for D, SDPA (in turns: SDPA,
              kernel, kernel, SDPA); the int8 and int4 modes of A and B on
              the same atoms over the pools quantized by
              ``packed_kv_append_quant``; B in each pool mode and C one
              launch on the card a call (the profiler's count) and bit for
              bit against a second launch; B then C over a 1024-token
              prompt chunked at 256, 512 and 768 (its past in a shuffled
              bf16 pool) bit for bit against D over the whole prompt; G on the
              llama3-8b head (B=6, D=4096, F=128256) and H at layer 2 of a
              stack of each layer product -- wqkv (D=4096, F=6144), wo
              (4096, 4096), w_gateup (4096, 28672), w_down (14336, 4096)
              -- at B=6 and B=256, and of w_gateup at B=1 and B=16 too,
              int4 and int8, beside cuBLAS on the dense bf16 weights (the
              decode rows, B <= 16, cycle over layers and dense copies
              spanning three times L2, so every launch reads HBM, and are
              timed from CUDA graphs of launches, each call one launch on
              the card by the profiler's count; the B=256 rows cycle over
              four layers); B=256 outputs also per 64-row tile like
              dq/dk/dv below, and every output bit for bit against a
              second launch;
              then the training shapes: D (held and timed as above) and
              the backward kernels E (dq) and F (dk, dv) at Llama-3.2-1B's
              B=4 T=2048 H=32 K=8 d=64 (causal) and at d=128 (B=1),
              dq/dk/dv held per 64-row tile
              (each batch row and head: max abs error <= 2e-2 x that
              tile's max |plain|), timed likewise beside one SDPA backward
              (its backend named; E then F in turns with it, as one
              ratio); kernel I at the serve shapes (a t=1
              tile over 8 slots at A's pasts -- its decode regime, timed
              from a CUDA graph of launches -- and a t=700 tile over 4
              slots from position 0 -- its flash regime; its output held
              per 64-row tile like dq/dk/dv, each call one launch on the
              card by the profiler's count, two launches bit for bit), J
              on [4096, 4096] and [6, 4096] bf16 and [4096, 4096] fp32
              rows (forward, and the autograd backward
              against the plain version's; 1e-2 bf16, 1e-5 fp32, beside
              ``F.rms_norm``) and K on the probe's 256 MB array (relative
              1e-6, beside ``torch.sum``); A-F and I again at phi3-mini's
              heads (H = K = 32, d = 96) and pythia-1b's (H = K = 8,
              d = 256), the same checks, rows ending /d96 and /d256 (E, F
              at B=1 T=2048); then J's and K's entry points
              with the counts at 0 -- ``measure_hbm_bandwidth()``, whose
              copy and stream rates are printed beside the data sheet's
              3.35 TB/s, and the op builder's RMSNorm -- each must launch;
4. serve   -- ``InferenceEngineV2`` on ``llama3-8b`` at full width and depth
              (random bf16 weights from seed 0, rescaled so attention
              weighs in the residual stream; max_seq_len cut to 2048,
              8 slots, block 128): whole-prompt ``put`` of four prompts,
              a mixed ``put`` step (four decode tokens + two fresh prompts
              of 300 and 1100 tokens, chunked), ``decode_batch(steps=32)``
              over all six. Every kernel must launch in this phase; the
              first call of each in the two ``put`` steps, and the first
              ``decode_batch`` call of kernel A whose rows have moved past
              the pool frontier, are replayed through the plain versions;
              the 1100-token prompt's chunked last-token logits must match
              a whole-prompt ``put`` of it (relative L2 <= 2e-2, bf16);
              the engine is freed afterwards;
5. train   -- ``deepspeed_tpu_torch.initialize`` on ``llama3-1b`` at full
              width and depth (max_seq_len 2048; random fp32 master weights
              from seed 0, bf16 compute): micro-batch 4 x 2048 tokens, GA 2,
              AdamW (lr 1e-4, wd 0.1), gradient clipping 1.0; four
              ``train_batch`` steps on one fixed numpy-seeded batch, then one
              ``fused_train_step``. Every loss and grad norm must be finite,
              the last loss below the first, and kernels D, E and F must
              launch; the first launch of each is replayed through its plain
              version. Then a gradient cross-check at 2 layers of the same
              width: the gradients of wq, wk, wv, wo and the embedding
              through the kernels against those through the plain attention
              (this script swaps it in), relative L2 <= 2e-2 per leaf.
              Prints step ms, tokens/s and the model-FLOPs share of
              989 TFLOP/s (6 N + 12 L T D FLOPs per token). The model
              configuration, the engine config and the batch come from
              ``deepspeed_tpu_torch/tools/train_profile.py``, which
              profiles the same step.

6. serve-quant -- ``InferenceEngineV2`` on ``llama3-8b`` at full width
              and depth from phase 4's weights, twice, each engine freed
              after: Q1 ``weight_dtype="int4", kv_dtype="int8"`` and Q2
              ``weight_dtype="int8", kv_dtype="int4"``, on phase 4's traffic.
              G, H and the pool's A/B int modes must launch; the first
              launch of each in the whole-prompt ``put``, the mixed ``put``
              and ``decode_batch`` is replayed through its plain version.
              Prints the tokens/s, the served tree's bytes against bf16,
              peak memory, and (no gate) the whole-prompt logits' rel L2
              against phase 4's. Then the weight cross-check at 2 layers of
              the same width: int8 and int4 weights through G/H against an
              engine served the dense bf16 weights they dequantize to,
              last-token logits rel L2 <= 2e-2.

7. serve-dense -- ``llama3-8b`` at full width and depth on phase 6's weights
              (one bf16 tree that every engine shares, none copies),
              ``max_seq_len`` 2048, 8 slots, block 128: (c)
              ``init_inference(model, params=tree)`` runs ``forward`` and a
              greedy ``generate`` of 16 tokens on four 128-token prompts,
              every step's logits captured; a packed engine runs phase 4's
              four prompts in one ``put`` and 16 single-token ``put`` steps
              on its own argmax, then the four 128-token prompts and one
              ``put`` per token ``generate`` chose; (a) ``packed=False``
              (kernel I) and (b) ``paged=False`` run phase 4's traffic fed
              the same tokens, every logits vector finite, I's first launch
              replayed through ``plain_paged_attention`` per 64-row tile;
              then the op builder's RMSNorm on the card. I and J must
              launch. Against the packed engine, relative L2 of every
              logits vector: ``forward`` <= 2e-2 (the same kernels);
              (a), (b) and (c)'s ``generate`` steps within limits that lie
              between their sound readings and those of controls that
              drop each row's newest visible column from their attention
              (kernel I's wrapper for (a), the dense cache's attention for
              (b) and (c)), each control past twice its limit; the packed
              engine's own bf16 noise floor (its prompts put one at a
              time) is printed beside them. Then the same at 2 layers of
              the same width (seed-0 weights at the init scale) with the
              gate at 2e-2 for all of them. Prints the prompt put's
              tokens/s and the decode put's ms for each engine.

8. head-dims -- ``phi3-mini`` (d = 96) and ``pythia-1b`` (d = 256) at full
              width and depth (seed-0 bf16 weights, ``attention_heavy``;
              max_seq_len 2048, 8 slots, block 128) on phase 4's traffic,
              each over a bf16 pool and an int pool (phi3-mini int8,
              pythia-1b int4): finite logits, every kernel of the path
              launched, first launches replayed through the plain
              versions, chunked vs whole (bf16 pool) at rel L2 2e-2; the
              ``packed=False`` engine (kernel I) against the packed one at
              2 layers at rel L2 2e-2; training on kernels D, E, F
              (pythia-1b at full depth, phi3-mini at 2 layers; micro-batch
              2 x 2048, 3 ``train_batch`` steps): finite, falling losses,
              replays, and the 2-layer per-leaf gradient cross-check at
              2e-2. Every attention kernel must launch in this phase.

The last two lines of standard output are the ``kernels`` JSON line and the
result line ``{"ok": true, "device": {...}}``; the card's name and power
limit are printed before them. Imports neither JAX nor ``deepspeed_tpu``.
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
ATOL = RTOL = 2e-2             # normalised outputs, bf16 inputs
STAT_TOL = 1e-2                # m / lse
BWD_REL = 2e-2                 # dq/dk/dv and kernel I's output, per 64-row
                               # tile: max abs err / max |plain|
TILE = 64                      # rows of a kernel tile
CROSS_PATH_REL_L2 = 2e-2       # chunked vs whole-prompt last-token logits
GRAD_REL_L2 = 2e-2             # per-leaf grads, kernels vs plain attention
WEIGHT_REL_L2 = 2e-2           # G/H logits vs dense dequantized weights
DENSE_REL_L2 = 2e-2            # dense-tile / v1 logits vs the packed engine
DENSE_CONTROL_MARGIN = 2       # a control's reading / the gate, at least
# Phase 7 at full depth (attention_heavy bf16 weights): the packed engine's
# own bf16 noise is above DENSE_REL_L2, so each engine's limit lies between
# its sound reading and its control's (each row's newest column dropped);
# PERF.md's serve-dense entry gives both readings.
DENSE_FULL_REL_L2 = {"a": 0.15, "b": 0.45, "c": 0.3}
DENSE_FULL_CONTROL_MARGIN = 2
RMS_TOL = {"bfloat16": 1e-2, "float32": 1e-5}   # J, forward and backward
STREAM_REL = 1e-6              # K's sum vs its plain version
SERVE_KERNELS = ("paged_decode", "paged_past", "chunk_self", "flash_fwd")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    """(ms, "bytes" | "operations"): the larger of bytes over the card's
    memory rate and operations over its peak rate for their type (bf16
    tensor-core products unless ``flops_per_s`` says otherwise)."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def close(name: str, got, want, atol: float, rtol: float) -> float:
    """assert_close in fp32; returns the max abs error."""
    import torch

    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol,
                               msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def normalised(acc, l):
    """acc / l where l > 0 (rows with nothing visible compare as zero)."""
    return acc / l.clamp_min(1e-30)[..., None]


def close_tiles(name: str, got, want, rel: float = BWD_REL):
    """A gradient ``[B, T, heads, d]`` against its plain version, per
    ``TILE``-row tile of the sequence axis for each batch row and head:
    max |got - want| <= rel x max |want| over that tile (in fp32). Causal
    gradients shrink along the sequence, so one tensor-wide max would let
    late tiles off lightly. Returns ``(max abs error, max |want|, worst
    tile's max abs error / its max |want|)``."""
    import torch

    got, want = got.float(), want.float()
    B, T, H, d = want.shape
    pad = (0, 0, 0, 0, 0, -T % TILE)
    err = torch.nn.functional.pad((got - want).abs(), pad)
    ref = torch.nn.functional.pad(want.abs(), pad)
    e, s = (x.view(B, -1, TILE, H, d).amax(dim=(2, 4)) for x in (err, ref))
    bad = (e > rel * s).nonzero()
    if len(bad):
        b, t, h = bad[0].tolist()
        raise AssertionError(
            f"{name}: {len(bad)} tiles over the gate, first (batch {b}, rows "
            f"{t * TILE}.., head {h}): max abs err {float(e[b, t, h]):.3e} > "
            f"{rel} x tile max |plain| {float(s[b, t, h]):.3e}")
    worst = torch.where(s > 0, e / s.clamp_min(1e-30), 0.0).max()
    return float(err.max()), float(ref.max()), float(worst)


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def make_pool(torch, g, L, nbp1, bs, KD, dev):
    return (torch.randn(L, nbp1, bs, KD, generator=g, device=dev)
            .to(torch.bfloat16))


def timings(kernel, args, wrapper, plain, make_args=None) -> dict:
    """``ms``: the kernel alone -- its launcher on arguments prepared once
    (CUDA events see only the card's time while launches queue faster than
    the kernel runs); ``wrapper_ms``: the whole wrapper (operand checks,
    metadata, allocation, launch); ``plain_ms``: the plain version. A kernel
    shorter than its launch (A, B, C, I's decode regime) gives
    ``make_args`` (its launcher's arguments, made on the
    current stream; :func:`on_stream`): ``ms`` is then its device time from
    a CUDA graph of launches (``decode_time.graph_ms``), and ``loop_ms``
    the loop of launches, which times the host."""
    r = dict(ms=time_ms(lambda: kernel.launch(*args)),
             wrapper_ms=time_ms(wrapper), plain_ms=time_ms(plain, iters=5))
    if make_args is not None:
        from deepspeed_tpu_torch.tools.decode_time import graph_ms

        r["loop_ms"] = r["ms"]
        r["ms"] = graph_ms(lambda: kernel.launch(*make_args()))
    return r


def on_stream(args):
    """A launcher's arguments (its stream last, as every launcher of the
    port takes it) with the current stream: a CUDA graph captures only
    launches on its own stream."""
    import torch

    return (*args[:-1], torch.cuda.current_stream().cuda_stream)


def build_report(build, lib: str, kernel: str, pattern: str, variants,
                 unit: str, smem_symbol: str) -> None:
    """A kernel's ptxas report from the log of the build that made its
    library -- registers, stack frame and spill bytes per instantiation
    (``pattern`` captures its template argument from the mangled name, or
    a tuple of them) --
    beside the dynamic shared memory it launches with (``smem_symbol``, one
    int per variant). Spilled bytes fail the run."""
    import ctypes

    path = build.build_log(lib)
    report = {}
    for name, r in build.ptxas_report(path.read_text()).items():
        m = re.search(pattern, name)
        if m:
            key = tuple(int(v) for v in m.groups())
            report[key[0] if len(key) == 1 else key] = r
    smem = (ctypes.c_int * len(variants)).in_dll(build.library(lib),
                                                 smem_symbol)
    for i, v in enumerate(variants):
        r = report.get(v)
        if r is None or "spill_stores" not in r:
            raise AssertionError(f"kernel {kernel} at {unit}={v}: no ptxas "
                                 f"report in {path}")
        log(f"kernel {kernel} ptxas ({unit}={v}): {r.get('registers')} "
            f"registers, {r['stack']} bytes stack frame, "
            f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} "
            f"bytes spill loads; {smem[i]} bytes of dynamic shared memory")
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"kernel {kernel} at {unit}={v} spills "
                                 f"registers")


# Head dims the card's attention kernels are built for (the port's
# ``ops.CARD_HEAD_DIMS``; a CPU test holds the two equal)
CARD_HEAD_DIMS = (64, 96, 128, 256)

# (library, kernel, pattern of its mangled name, variants, unit, shared
# memory symbol): kernels D, E and F, A's and B's pool modes (A's int4:
# paired kv heads, then one nibble), C and I's two regimes per head dim,
# G/H's decode kernel (B <= 16) per weight width and row tile (8 or 16
# rows), and G/H's multi-row kernel (16 < B <= 256) per weight width
PTXAS_REPORTS = (
    ("paged_decode", "paged_decode",
     r"paged_decode_kernelILi16ELb0ELi(\d+)E", CARD_HEAD_DIMS, "d",
     "dst_paged_decode_smem_bytes"),
    ("paged_decode", "paged_decode_int8",
     r"paged_decode_kernelILi8ELb0ELi(\d+)E", CARD_HEAD_DIMS, "d",
     "dst_paged_decode_int8_smem_bytes"),
    ("paged_decode", "paged_decode_int4",
     r"paged_decode_kernelILi4ELb1ELi(\d+)E", CARD_HEAD_DIMS, "d",
     "dst_paged_decode_int4_smem_bytes"),
    ("paged_decode", "paged_decode_int4 one-nibble",
     r"paged_decode_kernelILi4ELb0ELi(\d+)E", CARD_HEAD_DIMS, "d",
     "dst_paged_decode_int4_smem_bytes"),
    ("paged_attention", "paged_past", r"paged_past_kernelILi16ELi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_paged_past_smem_bytes"),
    ("paged_attention", "paged_past_int8", r"paged_past_kernelILi8ELi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_paged_past_int8_smem_bytes"),
    ("paged_attention", "paged_past_int4", r"paged_past_kernelILi4ELi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_paged_past_int4_smem_bytes"),
    ("flash_attention", "chunk_self", r"chunk_self_kernelILi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_chunk_self_smem_bytes"),
    ("flash_forward", "flash_fwd", r"flash_fwd_kernelILi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_flash_fwd_smem_bytes"),
    ("flash_backward", "flash_bwd_dq", r"flash_bwd_dq_kernelILi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_flash_bwd_dq_smem_bytes"),
    ("flash_backward", "flash_bwd_dkv", r"flash_bwd_dkv_kernelILi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_flash_bwd_dkv_smem_bytes"),
    ("paged_tile", "paged_tile decode", r"paged_tile_decode_kernelILi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_paged_tile_decode_smem_bytes"),
    ("paged_tile", "paged_tile flash", r"paged_tile_kernelILi(\d+)E",
     CARD_HEAD_DIMS, "d", "dst_paged_tile_smem_bytes"),
    ("quant_matmul", "qmm_rows", r"qmm_rows_kernelILi(\d+)ELi(\d+)E",
     ((4, 1), (4, 2), (8, 1), (8, 2)), "(bits, n8 tiles)",
     "dst_qmm_rows_smem_bytes"),
    ("quant_matmul", "qmm_tile", r"qmm_tile_kernelILi(\d+)E", (4, 8),
     "bits", "dst_qmm_tile_smem_bytes"),
)


def build_reports(build) -> None:
    for row in PTXAS_REPORTS:
        build_report(build, *row)


def in_turns(kernel, args, library) -> dict:
    """A kernel beside one library call computing the same function, timed
    in turns in this call (library, kernel, kernel, library): ``ms`` and
    ``library_ms`` the mean of each pair, ``turns`` the four readings."""
    return in_turns_fn(lambda: kernel.launch(*args), library)


def in_turns_fn(fn, library) -> dict:
    """:func:`in_turns` for any call ``fn``, such as two kernels in turn."""
    readings = (time_ms(library), time_ms(fn), time_ms(fn), time_ms(library))
    return dict(ms=(readings[1] + readings[2]) / 2,
                library_ms=(readings[0] + readings[3]) / 2, turns=readings)


def flash_fwd_checks(torch, fa, KERNELS, q, k, v, tag: str) -> dict:
    """Kernel D causal on ``q`` [B,T,H,d], ``k``/``v`` [B,T,K,d]: out per
    64-row tile, batch row and head (:func:`close_tiles`), lse at
    ``STAT_TOL``; timed in turns with SDPA, beside its wrapper, its plain
    version and its bound."""
    B, T, H, d = q.shape
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    pout, plse = fa.plain_flash_forward(q, k, v, causal=True)
    tiles = {"out": close_tiles(f"D out ({tag})", out, pout)}
    close(f"D lse ({tag})", lse, plse, STAT_TOL, STAT_TOL)
    del pout, plse
    nbytes = ((q.numel() + k.numel() + v.numel() + out.numel()) * 2
              + lse.numel() * 4)
    flops = 4 * B * H * d * (T * (T + 1) // 2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    args, _ = fa.flash_kernel_args(q, k, v, causal=True)
    return dict(
        err=tiles["out"][0], tiles=tiles, bound=bound(nbytes, flops),
        **in_turns(KERNELS["flash_fwd"], args,
                   lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)),
        wrapper_ms=time_ms(lambda: fa.flash_attention_lse(q, k, v,
                                                          causal=True)),
        plain_ms=time_ms(lambda: fa.plain_flash_forward(q, k, v,
                                                        causal=True),
                         iters=5),
        shape=f"B={B} T=S={T} H={H} K={k.shape[2]} d={d}, causal")


def kernel_checks(torch, pa, fa, KERNELS, H=32, K=8, d=128, suffix="",
                  seed=1234, one_launch=True):
    """Kernels A-D and A/B's int modes at the serve phase's shapes: H query
    heads over K kv heads of head dim d (Llama-3-8B's by default); the rows'
    keys end in ``suffix``. B (each pool mode) and C: two launches give the
    same bits, and a call is one launch on the card (``launches_per_call``;
    ``one_launch`` False records the count without the gate)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bs = 128
    max_seq, n_slots = 2048, 8
    nb_max = max_seq // bs
    nbp1 = n_slots * nb_max + 1
    L = 2                      # pool depth: the work does not depend on L
    KD = K * d
    kpool, vpool = (make_pool(torch, g, L, nbp1, bs, KD, dev) for _ in "kv")
    perm = torch.randperm(nbp1 - 1, generator=g, device=dev).to(torch.int32)
    bt = perm.reshape(n_slots, nb_max).contiguous()
    layer = 1
    rows = {}

    # ---- A: 8 decode atoms at the serve phase's lengths
    pos0 = torch.tensor([38, 129, 130, 701, 301, 1101, 0, 0],
                        dtype=torch.int32, device=dev)
    slot = torch.arange(8, dtype=torch.int32, device=dev)
    q = torch.randn(8, H, d, generator=g, device=dev).to(torch.bfloat16)
    acc, m, l = pa.decode_pool_partials(q, kpool, vpool, layer, bt, slot,
                                        pos0)
    pacc, pm, pl = pa.plain_decode_partials(q, kpool, vpool, layer, bt, slot,
                                            pos0)
    live = pos0 > 0
    err = close("A out", normalised(acc, l)[live], normalised(pacc, pl)[live],
                ATOL, RTOL)
    close("A m", m[live], pm[live], STAT_TOL, STAT_TOL)
    if not (torch.all(l[~live] == 0) and torch.all(acc[~live] == 0)):
        raise AssertionError("A: atoms with pos0 == 0 must give l = acc = 0")
    cols = int(pos0.sum())
    nbytes = cols * KD * 2 * 2 + q.numel() * 2 + acc.numel() * 4 + 2 * m.numel() * 4
    flops = 4 * H * d * cols
    def a_args():
        return pa.decode_kernel_args(q, kpool, vpool, layer, bt, slot,
                                     pos0)[0]
    rows[f"paged_decode{suffix}"] = dict(
        err=err, bound=bound(nbytes, flops), library_ms=None,
        **timings(KERNELS["paged_decode"], a_args(),
                  lambda: pa.decode_pool_partials(q, kpool, vpool, layer, bt,
                                                  slot, pos0),
                  lambda: pa.plain_decode_partials(q, kpool, vpool, layer, bt,
                                                   slot, pos0), a_args),
        shape=f"A=8 atoms, H={H} K={K} d={d} bs=128, pos0 "
              + ",".join(str(int(p)) for p in pos0))

    # ---- B: two 256-token chunk atoms with a pooled past
    tq = 256
    pos0b = torch.tensor([256, 768], dtype=torch.int32, device=dev)
    slotb = torch.tensor([4, 5], dtype=torch.int32, device=dev)
    qb = torch.randn(2 * tq, H, d, generator=g, device=dev).to(torch.bfloat16)
    accb, mb, lb = pa.past_partials(qb, kpool, vpool, layer, bt, slotb, pos0b,
                                    tq)
    paccb, pmb, plb = pa.plain_past_partials(qb, kpool, vpool, layer, bt,
                                             slotb, pos0b, tq)
    err = close("B out", normalised(accb, lb), normalised(paccb, plb),
                ATOL, RTOL)
    close("B m", mb, pmb, STAT_TOL, STAT_TOL)
    launches = one_call(torch, f"B{suffix}", lambda: pa.past_partials(
        qb, kpool, vpool, layer, bt, slotb, pos0b, tq), one_launch)
    cols = int(pos0b.sum())
    nbytes = (cols * KD * 2 * 2 + qb.numel() * 2 + accb.numel() * 4
              + 2 * mb.numel() * 4)
    flops = 4 * tq * H * d * cols
    args, _ = pa.past_kernel_args(qb, kpool, vpool, layer, bt, slotb, pos0b,
                                  tq)
    rows[f"paged_past{suffix}"] = dict(
        err=err, bound=bound(nbytes, flops), library_ms=None,
        launches_per_call=launches,
        **timings(KERNELS["paged_past"], args,
                  lambda: pa.past_partials(qb, kpool, vpool, layer, bt,
                                           slotb, pos0b, tq),
                  lambda: pa.plain_past_partials(qb, kpool, vpool, layer, bt,
                                                 slotb, pos0b, tq),
                  lambda: on_stream(args)),
        shape=f"2 atoms x tq=256, H={H} K={K} d={d} bs=128, pos0 256,768")

    # ---- C: the same atoms' self flash, seeded from B's (plain) partials
    alen = torch.tensor([256, 200], dtype=torch.int32, device=dev)
    ks = torch.randn(2 * tq, K, d, generator=g, device=dev).to(torch.bfloat16)
    vs = torch.randn(2 * tq, K, d, generator=g, device=dev).to(torch.bfloat16)
    seed = (paccb, pmb, plb)
    outc = pa.self_attention(qb, ks, vs, alen, tq, seed)
    poutc = pa.plain_self_attention(qb, ks, vs, alen, tq, seed)
    err = close("C out", outc, poutc, ATOL, RTOL)
    launches = one_call(torch, f"C{suffix}", lambda: pa.self_attention(
        qb, ks, vs, alen, tq, seed), one_launch)
    pairs = sum(n * (n + 1) // 2 for n in alen.tolist())
    nbytes = ((qb.numel() + ks.numel() + vs.numel() + outc.numel()) * 2
              + (paccb.numel() + 2 * pmb.numel()) * 4)
    flops = 4 * H * d * pairs
    args, _ = pa.self_kernel_args(qb, ks, vs, alen, tq, seed)
    rows[f"chunk_self{suffix}"] = dict(
        err=err, bound=bound(nbytes, flops), library_ms=None,
        launches_per_call=launches,
        **timings(KERNELS["chunk_self"], args,
                  lambda: pa.self_attention(qb, ks, vs, alen, tq, seed),
                  lambda: pa.plain_self_attention(qb, ks, vs, alen, tq,
                                                  seed),
                  lambda: on_stream(args)),
        shape=f"2 atoms x tq=256 (alen 256,200), H={H} K={K} d={d}, "
              f"seeded")

    # ---- D: whole-prompt prefill of 4 prompts padded to T=1024
    B, T = 4, 1024
    qd = torch.randn(B, T, H, d, generator=g, device=dev).to(torch.bfloat16)
    kd = torch.randn(B, T, K, d, generator=g, device=dev).to(torch.bfloat16)
    vd = torch.randn(B, T, K, d, generator=g, device=dev).to(torch.bfloat16)
    rows[f"flash_fwd{suffix}"] = flash_fwd_checks(
        torch, fa, KERNELS, qd, kd, vd, f"serve shape{suffix}")
    rows.update(quant_pool_checks(
        torch, pa, KERNELS, kpool, vpool, layer, bt,
        decode=(q, slot, pos0), past=(qb, slotb, pos0b, tq), suffix=suffix,
        one_launch=one_launch))
    torch.cuda.synchronize()
    for name, r in rows.items():
        loop = (f", a loop of launches {r['loop_ms']:.4f} ms"
                if "loop_ms" in r else "")
        log(f"kernel {name}: max_abs_err {r['err']:.3e}, kernel "
            f"{r['ms']:.4f} ms{loop} (wrapper {r['wrapper_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
            f"{r['bound'][1]}, library {r['library_ms']}) [{r['shape']}]")
        log_tiles(name, r)
        log_turns(name, r)
    return rows


def quantize_pool(torch, pa, pool_k, pool_v, bits):
    """The bf16 pools' rows written through ``packed_kv_append_quant`` into
    int8 / int4 pools (every physical row, scratch block included), with
    their per-token scales."""
    L, nbp1, bs, KD = pool_k.shape
    dev = pool_k.device
    lanes = KD // 2 if bits == 4 else KD
    out = [torch.zeros(L, nbp1, bs, lanes, dtype=torch.int8, device=dev)
           for _ in "kv"]
    scale = torch.zeros(L, nbp1, 1, 2 * bs, device=dev)
    bt_all = torch.arange(nbp1, dtype=torch.int32, device=dev)[None]
    slot = torch.zeros(nbp1 * bs, dtype=torch.int32, device=dev)
    pos = torch.arange(nbp1 * bs, dtype=torch.int32, device=dev)
    for which, (src, dst) in enumerate(zip((pool_k, pool_v), out)):
        pa.packed_kv_append_quant(dst, scale, src.reshape(L, nbp1 * bs, KD),
                                  bt_all, slot, pos, which, bits=bits)
    return out[0], out[1], scale


def quant_pool_checks(torch, pa, KERNELS, kpool, vpool, layer, bt, decode,
                      past, suffix="", one_launch=True):
    """The int8 / int4 modes of A and B on the bf16 checks' atoms, over the
    same pools quantized by the port's append (rows' keys end in
    ``suffix``); B's as :func:`kernel_checks` holds B's bf16 mode."""
    rows = {}
    q, slot, pos0 = decode
    qb, slotb, pos0b, tq = past
    H, d = q.shape[1:]
    KD = kpool.shape[3]
    for bits in (8, 4):
        kq, vq, sc = quantize_pool(torch, pa, kpool, vpool, bits)
        kw = dict(kv_scale=sc, kv_bits=bits)
        name = pa.kernel_name("paged_decode", sc, bits)
        acc, m, l = pa.decode_pool_partials(q, kq, vq, layer, bt, slot, pos0,
                                            **kw)
        pacc, pm, pl = pa.plain_decode_partials(q, kq, vq, layer, bt, slot,
                                                pos0, **kw)
        live = pos0 > 0
        err = close(f"{name} out", normalised(acc, l)[live],
                    normalised(pacc, pl)[live], ATOL, RTOL)
        close(f"{name} m", m[live], pm[live], STAT_TOL, STAT_TOL)
        if not (torch.all(l[~live] == 0) and torch.all(acc[~live] == 0)):
            raise AssertionError(f"{name}: atoms with pos0 == 0 must give "
                                 f"l = acc = 0")
        cols = int(pos0.sum())
        pool_bytes = cols * (KD * bits // 8 + 4) * 2      # rows + scales
        nbytes = pool_bytes + q.numel() * 2 + acc.numel() * 4 \
            + 2 * m.numel() * 4
        def a_args():
            return pa.decode_kernel_args(q, kq, vq, layer, bt, slot, pos0,
                                         **kw)[0]
        rows[name + suffix] = dict(
            err=err, bound=bound(nbytes, 4 * H * d * cols), library_ms=None,
            **timings(KERNELS[name], a_args(),
                      lambda: pa.decode_pool_partials(q, kq, vq, layer, bt,
                                                      slot, pos0, **kw),
                      lambda: pa.plain_decode_partials(q, kq, vq, layer, bt,
                                                       slot, pos0, **kw),
                      a_args),
            shape=f"int{bits} pool, the bf16 A atoms")

        name = pa.kernel_name("paged_past", sc, bits)
        accb, mb, lb = pa.past_partials(qb, kq, vq, layer, bt, slotb, pos0b,
                                        tq, **kw)
        paccb, pmb, plb = pa.plain_past_partials(qb, kq, vq, layer, bt,
                                                 slotb, pos0b, tq, **kw)
        err = close(f"{name} out", normalised(accb, lb),
                    normalised(paccb, plb), ATOL, RTOL)
        close(f"{name} m", mb, pmb, STAT_TOL, STAT_TOL)
        launches = one_call(torch, f"{name}{suffix}", lambda: pa.past_partials(
            qb, kq, vq, layer, bt, slotb, pos0b, tq, **kw), one_launch)
        cols = int(pos0b.sum())
        nbytes = (cols * (KD * bits // 8 + 4) * 2 + qb.numel() * 2
                  + accb.numel() * 4 + 2 * mb.numel() * 4)
        args, _ = pa.past_kernel_args(qb, kq, vq, layer, bt, slotb, pos0b,
                                      tq, **kw)
        rows[name + suffix] = dict(
            err=err, bound=bound(nbytes, 4 * tq * H * d * cols),
            library_ms=None, launches_per_call=launches,
            **timings(KERNELS[name], args,
                      lambda: pa.past_partials(qb, kq, vq, layer, bt, slotb,
                                               pos0b, tq, **kw),
                      lambda: pa.plain_past_partials(qb, kq, vq, layer, bt,
                                                     slotb, pos0b, tq, **kw),
                      lambda: on_stream(args)),
            shape=f"int{bits} pool, the bf16 B atoms")
        del kq, vq, sc
    return rows


def one_call(torch, tag: str, call, one_launch: bool = True) -> int:
    """``call`` twice on the same inputs gives the same bits, and one call
    is one launch on the card (:func:`device_launches`; ``one_launch``
    False only counts). Returns the count."""
    first, second = call(), call()
    if not isinstance(first, tuple):
        first, second = (first,), (second,)
    if not all(torch.equal(x, y) for x, y in zip(first, second)):
        raise AssertionError(f"{tag}: two launches on the same inputs differ")
    launches = device_launches(torch, call)
    if one_launch and launches != 1:
        raise AssertionError(f"{tag}: {launches} launches on the card for "
                             f"one call, not 1")
    return launches


def chunked_equals_whole(torch, pa, fa, H=32, K=8, d=128, T=1024, tq=256,
                         bs=128, seed=5678) -> list:
    """A prompt of T tokens whose first P tokens' K/V sit in a bf16 pool
    behind a shuffled block table (P = 256, 512, 768): kernel B over the
    next tq rows at pos0 = P, then kernel C seeded from B's partials, must
    give kernel D's bits for those rows of the whole prompt. The serve
    phase's chunked-vs-whole gate rests on it. Returns the P checked."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(1, T, H, d, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(1, T, K, d, generator=g, device=dev).bfloat16()
            for _ in "kv")
    want, _ = fa.flash_forward(q, k, v, causal=True)
    nb_max, nbp1 = T // bs, 2 * T // bs + 1
    bt = torch.randperm(nbp1 - 1, generator=g, device=dev)[:nb_max]
    bt = bt.to(torch.int32).reshape(1, nb_max).contiguous()
    pools = [torch.zeros(1, nbp1, bs, K * d, dtype=torch.bfloat16,
                         device=dev) for _ in "kv"]
    for pool, x in zip(pools, (k, v)):
        pool[0, bt[0].long()] = x[0].reshape(nb_max, bs, K * d)
    slot = torch.zeros(1, dtype=torch.int32, device=dev)
    alen = torch.full((1,), tq, dtype=torch.int32, device=dev)
    checked = []
    for P in range(tq, T, tq):
        rows = slice(P, P + tq)
        pos0 = torch.full((1,), P, dtype=torch.int32, device=dev)
        qc, kc, vc = (x[0, rows].contiguous() for x in (q, k, v))
        seed_p = pa.past_partials(qc, *pools, 0, bt, slot, pos0, tq)
        out = pa.self_attention(qc, kc, vc, alen, tq, seed_p)
        if not torch.equal(out, want[0, rows]):
            diff = float((out.float() - want[0, rows].float()).abs().max())
            raise AssertionError(f"kernels B then C at pos0 = {P} differ "
                                 f"from kernel D's rows (max abs {diff:.3e})")
        checked.append(P)
    log(f"kernels B then C vs kernel D (H={H} K={K} d={d}, a {T}-token "
        f"prompt chunked at {checked} over a shuffled bf16 pool): bit for "
        f"bit")
    return checked


def device_launches(torch, fn, traces: int = 3) -> int:
    """Kernels the card ran for one call of ``fn``, counted by
    ``torch.profiler`` (a ``Kernel`` record counts wrapper calls only).

    CUPTI now and then hands the profiler no records for a short trace (a
    one-launch call once read 0 launches). So a control kernel
    (``torch.cuda._sleep``'s ``spin_kernel``) runs just before and just
    after the call, and only a trace that shows both is read; another is
    taken otherwise, and after ``traces`` incomplete ones the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for n in range(1, traces + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
        control = sum(e.count for e in events if "spin_kernel" in e.key)
        if control == 2:
            return sum(e.count for e in events) - control
        log(f"device_launches: trace {n} of {traces} shows {control} of the "
            f"2 control kernels; not read")
    raise AssertionError(f"the profiler missed the control kernels in "
                         f"{traces} traces: no launch count")


def qmm_row(torch, qm, KERNELS, x, packed, scales, bits, layer, shape,
            dense, one_launch=True, cycle=4):
    """G (``layer`` None) or H on one product, held against the plain
    version -- per 64-row tile as well when there are more rows than one
    tile (``close_tiles``), and bit for bit against a second launch -- and
    timed beside cuBLAS on the dense bf16 weights ``dense`` (one matrix a
    layer, cycled). H's launches cycle over ``cycle`` layers of the stack
    from layer ``layer``. At B <= 16 the decode kernel is shorter than its
    launch from Python: its time (and cuBLAS's) comes from a CUDA graph of
    launches (``decode_time.graph_ms``; ``loop_ms`` is the loop of
    launches), and the call must be one launch on the card
    (``one_launch``; ``launches_per_call`` counts it)."""
    from deepspeed_tpu_torch.tools.decode_time import graph_ms

    name = "qmm" if layer is None else "qmm_stacked"
    out = qm.quantized_matmul(x, packed, scales, bits=bits, layer=layer)
    ref = qm.plain_quantized_matmul(x, packed, scales, bits, layer)
    err = close(f"{name} int{bits} {shape}", out, ref, ATOL, RTOL)
    B, D = x.shape
    G, F = scales.shape[-2:]
    extra = {}
    if B > TILE:
        extra["tiles"] = {"out": close_tiles(
            f"{name} int{bits} {shape}", out.view(1, B, 1, F),
            ref.view(1, B, 1, F))}
    again = qm.quantized_matmul(x, packed, scales, bits=bits, layer=layer)
    if not torch.equal(again, out):
        raise AssertionError(f"{name} int{bits} {shape}: two launches on the "
                             f"same inputs differ")
    nbytes = B * D * 2 + D * F * bits // 8 + G * F * 2 + B * F * 2
    kern = KERNELS[name]
    layers = [None] if layer is None else [
        (layer + i) % packed.shape[0] for i in range(cycle)]
    lay, mats = itertools.cycle(layers), itertools.cycle(dense)
    args = [qm.qmm_kernel_args(x, packed, scales, bits, layer=i)[0]
            for i in layers]
    cyc = itertools.cycle(args)
    n = 5 * len(layers)
    t = dict(ms=time_ms(lambda: kern.launch(*next(cyc)), iters=n),
             wrapper_ms=time_ms(lambda: qm.quantized_matmul(
                 x, packed, scales, bits=bits, layer=next(lay)), iters=n),
             plain_ms=time_ms(lambda: qm.plain_quantized_matmul(
                 x, packed, scales, bits, layer), iters=5))
    if B <= 16:
        t["loop_ms"] = t["ms"]
        t["ms"] = graph_ms(lambda: kern.launch(*qm.qmm_kernel_args(
            x, packed, scales, bits, layer=next(lay))[0]))
        lib = graph_ms(lambda: torch.matmul(x, next(mats)))
        extra["launches_per_call"] = device_launches(
            torch, lambda: qm.quantized_matmul(x, packed, scales, bits=bits,
                                               layer=layer))
        if one_launch and extra["launches_per_call"] != 1:
            raise AssertionError(
                f"{name} int{bits} {shape}: {extra['launches_per_call']} "
                f"launches on the card for one call, not 1")
    else:
        lib = time_ms(lambda: torch.matmul(x, next(mats)))
    return dict(err=err, bound=bound(nbytes, 2.0 * B * D * F),
                library_ms=lib, library="torch.matmul (cuBLAS), dense bf16",
                shape=shape, splits=qm.qmm_splits(B, F, G), **extra, **t)


# llama3-8b's four quantized layer products (D, F): H runs each at B=256 in
# the serve-quant phase's 256-row chunk steps and at B=6 in its decode steps
QMM_LEAVES = (("w_gateup", 4096, 28672), ("wqkv", 4096, 6144),
              ("wo", 4096, 4096), ("w_down", 14336, 4096))
# phase 3's rows of each product: every decode product at B=6, w_gateup
# also at B=1 and B=16 (the decode kernel's two row tiles' ends), and every
# product at B=256 (the multi-row kernel)
QMM_ROWS = {"w_gateup": (6, 1, 16, 256), "wqkv": (6, 256), "wo": (6, 256),
            "w_down": (6, 256)}
L2_BYTES = 50e6                # H100 L2 cache
COLD_BYTES = 3 * L2_BYTES      # what a cycle of weights spans at least


def qmm_checks(torch, qm, KERNELS, one_launch=True):
    """G on the llama3-8b head (B=6, D=4096, F=128256); H on each layer
    product of a stack at layer 2 at the rows of ``QMM_ROWS``; int4 and
    int8, from seeded random weights quantized by the port. The decode rows
    (B <= 16) cycle over enough layers, and cuBLAS over enough dense copies,
    that each launch reads its weights from HBM, as in serving (the stack
    spans ``COLD_BYTES``, three times L2); the B=256 rows cycle over four
    layers."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5678)
    D, V = 4096, 128256
    xs = {B: torch.randn(B, D, generator=g, device=dev).bfloat16()
          for B in (1, 6, 16, 256)}
    rows = {}
    head = torch.randn(D, V, generator=g, device=dev) / D ** 0.5
    for bits in (4, 8):
        p, sc = qm.quantize_matmul_weight(head, bits=bits)
        sc = sc.bfloat16()
        dense = [qm.dequantize_matmul_weight(p, sc, bits, D)]
        rows[f"qmm/int{bits}"] = qmm_row(
            torch, qm, KERNELS, xs[6], p, sc, bits, None,
            f"llama3-8b head: B=6 D={D} F={V}, int{bits}", dense, one_launch)
        del p, sc, dense
    del head
    for bits in (4, 8):
        for leaf, DL, F in QMM_LEAVES:
            L = max(4, -(-int(COLD_BYTES) // (DL * F * bits // 8)))
            ps, ss = [], []
            for _ in range(L):
                w = torch.randn(DL, F, generator=g, device=dev) / DL ** 0.5
                p, sc = qm.quantize_matmul_weight(w, bits=bits)
                ps.append(p)
                ss.append(sc.bfloat16())
            stack = (torch.stack(ps), torch.stack(ss))
            del ps, ss, w
            nd = -(-int(COLD_BYTES) // (DL * F * 2))
            dense = [qm.dequantize_matmul_weight(stack[0][(2 + i) % L],
                                                 stack[1][(2 + i) % L],
                                                 bits, DL)
                     for i in range(nd)]
            for B in QMM_ROWS[leaf]:
                x = (xs[B] if DL == D else
                     torch.randn(B, DL, generator=g, device=dev).bfloat16())
                key = f"qmm_stacked/int{bits}/B{B}"
                rows[key if leaf == "w_gateup" else f"{key}/{leaf}"] = \
                    qmm_row(torch, qm, KERNELS, x, *stack, bits, 2,
                            f"{leaf}, layer 2 of {L if B <= 16 else 4}: "
                            f"B={B} D={DL} F={F}, int{bits}",
                            dense if B <= 16 else dense[:1], one_launch,
                            cycle=L if B <= 16 else 4)
            del stack, dense
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for name, r in rows.items():
        tiles = (f", worst 64-row tile err / tile max |plain| "
                 f"{r['tiles']['out'][2]:.3e} (gate {BWD_REL})"
                 if "tiles" in r else "")
        graph = (f", a graph of launches (loop {r['loop_ms']:.4f} ms), "
                 f"{r['launches_per_call']} launch(es) a call"
                 if "loop_ms" in r else "")
        log(f"kernel {name}: max_abs_err {r['err']:.3e}{tiles}, kernel "
            f"{r['ms']:.4f} ms{graph} (wrapper {r['wrapper_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
            f"{r['bound'][1]}, library {r['library_ms']:.4f} ms cuBLAS; "
            f"{r['splits']} split(s), kernel / cuBLAS "
            f"{r['ms'] / r['library_ms']:.2f}, kernel / bound "
            f"{r['ms'] / r['bound'][0]:.2f}) [{r['shape']}]")
    return rows


# phase 3's head-dim rows: phi3-mini's heads (H = K = 32, d = 96) and
# pythia-1b's (H = K = 8, d = 256), the rows' keys ending in /d96, /d256
HEAD_DIM_SHAPES = (("/d96", 32, 32, 96), ("/d256", 8, 8, 256))


def backward_checks(torch, fa, KERNELS):
    """Kernel D at the training shape, and kernels E and F at the training
    shape (d = 64), at d = 128 and at the head-dim shapes (d = 96, 256; B=1,
    T = 2048), against their plain versions."""
    from deepspeed_tpu_torch.tools.flash_bwd_time import sdpa_backward
    from deepspeed_tpu_torch.tools.train_profile import TRAIN_SEQ

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    rows = {}
    shapes = [("train", (4, TRAIN_SEQ, 32, 8, 64)),
              ("d128", (1, TRAIN_SEQ, 32, 8, 128))]
    shapes += [(sfx[1:], (1, TRAIN_SEQ, H, K, d))
               for sfx, H, K, d in HEAD_DIM_SHAPES]
    for tag, (B, T, H, K, d) in shapes:
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).bfloat16()

        q, do, k, v = rnd(B, T, H, d), rnd(B, T, H, d), rnd(B, T, K, d), \
            rnd(B, T, K, d)
        shape = f"B={B} T=S={T} H={H} K={K} d={d}, causal"
        pairs = B * H * T * (T + 1) // 2          # live (row, col) per head
        if tag == "train":
            rows["flash_fwd/train"] = flash_fwd_checks(
                torch, fa, KERNELS, q, k, v, "train shape")
        out, lse = fa.flash_forward(q, k, v, causal=True)
        delta = fa.flash_delta(out, do)
        ins = (q, k, v, do, lse, delta)
        dq = fa.flash_bwd_dq(*ins, causal=True)
        dk, dv = fa.flash_bwd_dkv(*ins, causal=True)
        tiles_dq = {"dq": close_tiles(f"E dq ({tag})", dq,
                                      fa.plain_flash_bwd_dq(*ins,
                                                            causal=True))}
        pdk, pdv = fa.plain_flash_bwd_dkv(*ins, causal=True)
        tiles_dkv = {"dk": close_tiles(f"F dk ({tag})", dk, pdk),
                     "dv": close_tiles(f"F dv ({tag})", dv, pdv)}
        del pdk, pdv
        sdpa_bwd, backend = sdpa_backward(q, k, v, do)
        in_bytes = (q.numel() + k.numel() + v.numel() + do.numel()) * 2 \
            + (lse.numel() + delta.numel()) * 4
        args_e, _ = fa.flash_bwd_kernel_args(*ins, part="dq", causal=True)
        args_f, _ = fa.flash_bwd_kernel_args(*ins, part="dkv", causal=True)
        # E then F, the whole backward, in turns with SDPA's whole backward
        pair = in_turns_fn(
            lambda: (KERNELS["flash_bwd_dq"].launch(*args_e),
                     KERNELS["flash_bwd_dkv"].launch(*args_f)), sdpa_bwd)
        lib = pair["library_ms"]
        e_plus_f = dict(ms=pair["ms"], library_ms=lib,
                        ratio=pair["ms"] / lib)
        log(f"kernels E+F ({tag}) in turns with one SDPA backward "
            f"({backend}): library {pair['turns'][0]:.4f}, E+F "
            f"{pair['turns'][1]:.4f}, E+F {pair['turns'][2]:.4f}, library "
            f"{pair['turns'][3]:.4f} ms; (E+F) / SDPA backward "
            f"{e_plus_f['ratio']:.2f} [{shape}]")
        rows[f"flash_bwd_dq/{tag}"] = dict(
            err=tiles_dq["dq"][0], tiles=tiles_dq, library_ms=lib,
            library=backend, shape=shape, e_plus_f=e_plus_f,
            bound=bound(in_bytes + dq.numel() * 2, 6 * d * pairs),
            **timings(KERNELS["flash_bwd_dq"], args_e,
                      lambda: fa.flash_bwd_dq(*ins, causal=True),
                      lambda: fa.plain_flash_bwd_dq(*ins, causal=True)))
        rows[f"flash_bwd_dkv/{tag}"] = dict(
            err=max(t[0] for t in tiles_dkv.values()), tiles=tiles_dkv,
            library_ms=lib, library=backend, shape=shape, e_plus_f=e_plus_f,
            bound=bound(in_bytes + (dk.numel() + dv.numel()) * 2,
                        8 * d * pairs),
            **timings(KERNELS["flash_bwd_dkv"], args_f,
                      lambda: fa.flash_bwd_dkv(*ins, causal=True),
                      lambda: fa.plain_flash_bwd_dkv(*ins, causal=True)))
        del q, k, v, do, out, lse, delta, ins, dq, dk, dv, args_e, args_f
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for name, r in rows.items():
        log(f"kernel {name}: max_abs_err {r['err']:.3e}, kernel "
            f"{r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
            f"{r['bound'][1]}, library {r['library_ms']} "
            f"{r.get('library', 'SDPA')}) [{r['shape']}]")
        log_tiles(name, r)
        log_turns(name, r)
    return rows


def log_tiles(name: str, r: dict) -> None:
    """A row's :func:`close_tiles` readings, one line per tensor."""
    for t, (err, scale, worst) in r.get("tiles", {}).items():
        log(f"kernel {name} {t}: max abs err {err:.3e}, max |plain| "
            f"{scale:.3e}, worst {TILE}-row tile err / tile max |plain| "
            f"{worst:.3e} (gate {BWD_REL})")


def log_turns(name: str, r: dict) -> None:
    """A row's :func:`in_turns` readings and the kernel / library ratio."""
    if "turns" in r:
        lib0, k0, k1, lib1 = r["turns"]
        log(f"kernel {name} in turns: library {lib0:.4f}, kernel {k0:.4f}, "
            f"kernel {k1:.4f}, library {lib1:.4f} ms; kernel / library "
            f"{r['ms'] / r['library_ms']:.2f}")


def tile_checks(torch, pa, KERNELS, H=32, K=8, d=128, suffix="", seed=9012):
    """Kernel I at the serve shapes (H=32, K=8, d=128 by default, block 128,
    16 blocks a slot): a t=1 tile over 8 slots at kernel A's pasts (38-1101,
    two empty; the decode regime at rep <= 16), and a t=700 tile over 4
    slots from position 0 (phase 7's prompt step; the flash regime). Held
    per 64-row tile, slot and head (:func:`close_tiles`): late causal rows
    average hundreds of columns and are small, so one tensor-wide tolerance
    would let a fault in the late columns pass. Each call must be one launch
    on the card (``launches_per_call``, the profiler's count) and two
    launches must give the same bits. The t=1 tile is shorter than its
    launch from Python: its kernel time comes from a CUDA graph of launches
    (``loop_ms``: the loop). The rows' keys end in ``suffix``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bs, nb_max, n_slots = 128, 16, 8
    nbp1 = n_slots * nb_max + 1
    kpool, vpool = (make_pool(torch, g, 2, nbp1, bs, K * d, dev) for _ in "kv")
    bt = torch.randperm(nbp1 - 1, generator=g, device=dev).to(
        torch.int32).reshape(n_slots, nb_max).contiguous()
    S, layer, rows = nb_max * bs, 1, {}
    for key, t, pos in (("paged_tile", 700, [0, 0, 0, 0]),
                        ("paged_tile/decode", 1,
                         [38, 129, 130, 701, 301, 1101, 0, 0])):
        ps = torch.tensor(pos, dtype=torch.int32, device=dev)
        B = len(pos)
        q = torch.randn(B, t, H, d, generator=g, device=dev).bfloat16()
        btb = bt[:B].contiguous()

        def call():
            return pa.paged_attention(q, kpool, vpool, btb, ps, layer=layer)

        out = call()
        ref = pa.plain_paged_attention(q, kpool, vpool, btb, ps, layer=layer)
        tag = f"I (t={t}{suffix})"
        tiles = {"out": close_tiles(f"{tag} out", out, ref)}
        launches = one_call(torch, tag, call)
        cols = sum(min(p + t, S) for p in pos)       # KV rows read per slot
        pairs = sum(min(p + i, S - 1) + 1 for p in pos for i in range(t))
        nbytes = cols * K * d * 2 * 2 + (q.numel() + out.numel()) * 2

        def make_args():
            return pa.paged_tile_kernel_args(q, kpool, vpool, btb, ps,
                                             layer=layer)[0]

        rows[key + suffix] = dict(
            err=tiles["out"][0], tiles=tiles, launches_per_call=launches,
            bound=bound(nbytes, 4 * H * d * pairs), library_ms=None,
            **timings(KERNELS["paged_tile"], make_args(), call,
                      lambda: pa.plain_paged_attention(q, kpool, vpool, btb,
                                                       ps, layer=layer),
                      make_args if t == 1 else None),
            shape=f"B={B} t={t}, H={H} K={K} d={d} bs=128, pos "
                  + ",".join(map(str, pos)))
        del q, out, ref
    return rows


def rms_checks(torch, rn, KERNELS):
    """Kernel J on llama3-8b rows (D=4096): [4096, 4096] and [6, 4096] bf16
    with a bf16 weight, [4096, 4096] fp32 with an fp32 weight; forward
    against the plain version and the gradients of ``fused_rms_norm``
    (kernel J forward, closed-form backward) against autograd through the
    plain version, at ``RMS_TOL``; timed beside ``F.rms_norm``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3456)
    D, rows = 4096, {}
    for key, n, dt in (("rms_norm", 4096, torch.bfloat16),
                       ("rms_norm/decode", 6, torch.bfloat16),
                       ("rms_norm/fp32", 4096, torch.float32)):
        tol = RMS_TOL[str(dt).replace("torch.", "")]
        x = (2 * torch.randn(n, D, generator=g, device=dev)).to(dt)
        w = (1 + 0.3 * torch.randn(D, generator=g, device=dev)).to(dt)
        gy = torch.randn(n, D, generator=g, device=dev)
        got = []
        for fn in (rn.fused_rms_norm, rn.plain_rms_norm):
            xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = fn(xx, ww)
            (y.float() * gy).sum().backward()
            got.append((y.detach(), xx.grad, ww.grad))
        errs = [close(f"J {part} ({key})", a, b, tol, tol)
                for part, a, b in zip(("out", "dx", "dw"), *got)]
        nbytes = (2 * x.numel() + w.numel()) * x.element_size()
        lib = time_ms(lambda: torch.nn.functional.rms_norm(x, (D,), w, 1e-5))
        args, _ = rn.rms_kernel_args(x, w)
        rows[key] = dict(
            err=errs[0], grad_err=max(errs[1:]), library_ms=lib,
            library="torch.nn.functional.rms_norm",
            bound=bound(nbytes, 4 * x.numel(), FP32_FLOPS_PER_S),
            **timings(KERNELS["rms_norm"], args,
                      lambda: rn.rms_norm_forward(x, w),
                      lambda: rn.plain_rms_norm(x, w)),
            shape=f"[{n}, {D}] {str(dt).replace('torch.', '')}")
        del x, w, gy, got
    return rows


def stream_checks(torch, hb, KERNELS):
    """Kernel K on the probe's array (256 MB fp32, ``arange``, five times
    the L2) against its plain version (relative ``STREAM_REL``), timed
    beside ``torch.sum``."""
    x = torch.arange(64 * 1024 * 1024, dtype=torch.float32,
                     device="cuda").reshape(-1, hb.ROW)
    got, want = hb.hbm_stream(x, 3), hb.plain_hbm_stream(x, 3)
    err = abs(float(got) - float(want))
    if not err <= STREAM_REL * abs(float(want)):
        raise AssertionError(f"K: sum {float(got)} vs plain {float(want)}")
    args, _ = hb.hbm_stream_kernel_args(x, 3)
    row = dict(err=err, library_ms=time_ms(lambda: torch.sum(x)),
               library="torch.sum",
               bound=bound(x.numel() * 4, x.numel(), FP32_FLOPS_PER_S),
               **timings(KERNELS["hbm_stream"], args,
                         lambda: hb.hbm_stream(x, 3),
                         lambda: hb.plain_hbm_stream(x, 3)),
               shape="[65536, 1024] fp32 (256 MB), 1024 chunks of 64 rows")
    del x
    return {"hbm_stream": row}


def probe_checks(torch, pa, KERNELS, reset_counts):
    """Phase 3's I/J/K rows, then J's and K's own entry points run with the
    counts set to 0 just before: ``measure_hbm_bandwidth()`` (K) and the
    op builder's ``fused_rms_norm`` forward and backward on a decode-step
    hidden state (J). Returns (rows, the entry points' launches, rates)."""
    from deepspeed_tpu_torch.ops import get_op_builder
    from deepspeed_tpu_torch.ops import rms_norm as rn
    from deepspeed_tpu_torch.tools import hbm_bandwidth as hb

    rows = tile_checks(torch, pa, KERNELS)
    for sfx, H, K, d in HEAD_DIM_SHAPES:
        rows.update(tile_checks(torch, pa, KERNELS, H, K, d, sfx,
                                seed=9012 + d))
    rows.update(rms_checks(torch, rn, KERNELS))
    rows.update(stream_checks(torch, hb, KERNELS))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()
    rates = hb.measure_hbm_bandwidth()
    x = torch.randn(6, 4096, device="cuda").bfloat16().requires_grad_()
    w = torch.ones(4096, device="cuda").bfloat16().requires_grad_()
    get_op_builder("rms_norm").load()(x, w).float().sum().backward()
    torch.cuda.synchronize()
    counts = {k: KERNELS[k].launches for k in ("rms_norm", "hbm_stream")}
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"entry points never launched {missing}")
    for name, r in rows.items():
        extra = (f", grads max abs err {r['grad_err']:.3e}"
                 if "grad_err" in r else "")
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms {r['library']}")
        log(f"kernel {name}: max_abs_err {r['err']:.3e}{extra}, kernel "
            f"{r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
            f"{r['bound'][1]}, library {lib}) [{r['shape']}]")
        log_tiles(name, r)
    log(f"probe [{card_line()}]: measure_hbm_bandwidth copy_rw "
        f"{rates['copy_rw_gbps']:.1f} GB/s, stream_read (kernel K) "
        f"{rates['stream_read_gbps']:.1f} GB/s, data sheet 3350 GB/s; "
        f"entry-point launches {counts}")
    return rows, counts, rates


# ---------------------------------------------------------------------------
# phase 4: serve Llama-3-8B through the engine
# ---------------------------------------------------------------------------

class Replay:
    """Wraps the four kernel wrappers for the serve phase (module attributes,
    restored on exit) and captures one launch of each per stage -- inputs
    cloned, a pool as the one layer read -- to replay through the plain
    version afterwards. Stage ``put``: the first call of each kernel.
    Stage ``decode_batch``: the first call of kernel A whose rows sit past
    the pool frontier (``row_pos != atom_pos0``: the fused decode loop's
    tail steps)."""

    REQUIRED = {("paged_decode", "put"), ("paged_past", "put"),
                ("chunk_self", "put"), ("flash_fwd", "put"),
                ("paged_decode", "decode_batch")}

    def __init__(self, torch, pa, fa):
        self.torch = torch
        self.stage = None
        self.captured = {}
        self.tiles = {}        # backward kernels: close_tiles' readings
        self.target_of = {}    # captured kernel -> its wrapper's target
        self.targets = self.make_targets(pa, fa)

    @staticmethod
    def make_targets(pa, fa):
        """kernel name -> (module, wrapper attribute, plain version)"""
        return {
            "paged_decode": (pa, "decode_pool_partials",
                             pa.plain_decode_partials),
            "paged_past": (pa, "past_partials", pa.plain_past_partials),
            "chunk_self": (pa, "self_attention", pa.plain_self_attention),
            "flash_fwd": (fa, "flash_forward", fa.plain_flash_forward),
        }

    def __enter__(self):
        for name, (mod, attr, _) in self.targets.items():
            setattr(mod, attr, self._wrap(name, getattr(mod, attr)))
        return self

    def __exit__(self, *exc):
        for mod, attr, _ in self.targets.values():
            setattr(mod, attr, getattr(mod, attr).__wrapped__)

    def kernel_of(self, target, x):
        """The kernel a call of ``target``'s wrapper launched (None: none):
        A's and B's wrappers over an int pool launch its int mode."""
        if x.get("kv_scale") is not None:
            return f"{target}_int{x['kv_bits']}"
        return target

    def _wanted(self, target, name, x) -> bool:
        if name is None or (name, self.stage) in self.captured:
            return False
        if self.stage == "decode_batch" and target == "paged_decode":
            return (x["row_pos"] is not None
                    and bool((x["row_pos"] != x["atom_pos0"]).any()))
        return True

    def _wrap(self, target, fn):
        sig = inspect.signature(fn)
        torch = self.torch

        def clone(v):
            if isinstance(v, torch.Tensor):
                return v.clone()
            return tuple(t.clone() for t in v) if isinstance(v, tuple) else v

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            x = dict(bound.arguments)
            name = self.kernel_of(target, x)
            if self._wanted(target, name, x):
                i = x.get("layer")
                names = [n for n in ("k_pool", "v_pool", "kv_scale", "packed",
                                     "scales") if x.get(n) is not None]
                if i is not None and names:    # keep the one layer read
                    for n in names:
                        x[n] = x[n][i:i + 1]
                    x["layer"] = 0
                outs = out if isinstance(out, tuple) else (out,)
                self.target_of[name] = target
                self.captured[(name, self.stage)] = (
                    {k: clone(v) for k, v in x.items()}, clone(outs))
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    def check(self):
        missing = self.REQUIRED - set(self.captured)
        if missing:
            raise AssertionError(f"no launch captured for "
                                 f"{sorted(missing)}")
        errs = {}
        for (name, stage), (x, out) in sorted(self.captured.items()):
            plain = self.targets[self.target_of[name]][2]
            ref = plain(**x)
            tag = f"replay {name} ({stage})"
            if name.startswith(("paged_decode", "paged_past")):
                live = ref[2] > 0
                errs[f"{name}/{stage}"] = close(
                    tag, normalised(out[0], out[2])[live],
                    normalised(ref[0], ref[2])[live], ATOL, RTOL)
                close(f"{tag} m", out[1][live], ref[1][live], STAT_TOL,
                      STAT_TOL)
            elif name in ("chunk_self", "qmm", "qmm_stacked"):
                errs[f"{name}/{stage}"] = close(tag, out[0], ref, ATOL, RTOL)
            elif name == "paged_tile":
                self.tiles[f"{name}/{stage} out"] = close_tiles(
                    f"{tag} out", out[0], ref)
                errs[f"{name}/{stage}"] = self.tiles[f"{name}/{stage} out"][0]
            elif name in ("flash_bwd_dq", "flash_bwd_dkv"):
                grads = ("dq",) if name == "flash_bwd_dq" else ("dk", "dv")
                refs = ref if isinstance(ref, tuple) else (ref,)
                for t, got, want in zip(grads, out, refs):
                    self.tiles[f"{name}/{stage} {t}"] = close_tiles(
                        f"{tag} {t}", got, want)
                errs[f"{name}/{stage}"] = max(
                    self.tiles[f"{name}/{stage} {t}"][0] for t in grads)
            else:
                errs[f"{name}/{stage}"] = close(tag, out[0], ref[0], ATOL,
                                                RTOL)
                close(f"{tag} lse", out[1], ref[1], STAT_TOL, STAT_TOL)
        return errs


class QuantReplay(Replay):
    """The serve-quant phase's :class:`Replay` of the new kernels: G/H
    (``quantized_matmul``, a call that the shape rule sends to them) and
    the int modes of A/B. Stages ``put`` (whole prompts), ``mixed`` and
    ``decode_batch``; ``kv_bits`` names the pool's A/B kernels."""

    def __init__(self, torch, pa, qm, kv_bits: int):
        self.qm = qm
        super().__init__(torch, pa, qm)
        dec, past = (f"paged_decode_int{kv_bits}", f"paged_past_int{kv_bits}")
        self.REQUIRED = {("qmm", "put"), ("qmm", "mixed"),
                         ("qmm_stacked", "mixed"), (dec, "mixed"),
                         (past, "mixed"), ("qmm", "decode_batch"),
                         ("qmm_stacked", "decode_batch"),
                         (dec, "decode_batch")}

    @staticmethod
    def make_targets(pa, qm):
        return {
            "paged_decode": (pa, "decode_pool_partials",
                             pa.plain_decode_partials),
            "paged_past": (pa, "past_partials", pa.plain_past_partials),
            "qmm": (qm, "quantized_matmul", qm.plain_quantized_matmul),
        }

    def kernel_of(self, target, x):
        if target == "qmm":
            if not self.qm.uses_kernel(x["x"], x["scales"]):
                return None
            return "qmm" if x["layer"] is None else "qmm_stacked"
        if x["kv_scale"] is None:
            return None
        return f"{target}_int{x['kv_bits']}"


class TrainReplay(Replay):
    """The train phase's :class:`Replay`: kernels D, E and F, the first
    launch of each (stage ``train``)."""

    REQUIRED = {("flash_fwd", "train"), ("flash_bwd_dq", "train"),
                ("flash_bwd_dkv", "train")}

    def __init__(self, torch, fa):
        super().__init__(torch, None, fa)

    @staticmethod
    def make_targets(pa, fa):
        return {
            "flash_fwd": (fa, "flash_forward", fa.plain_flash_forward),
            "flash_bwd_dq": (fa, "flash_bwd_dq", fa.plain_flash_bwd_dq),
            "flash_bwd_dkv": (fa, "flash_bwd_dkv", fa.plain_flash_bwd_dkv),
        }


def attention_heavy(params) -> None:
    """Rescale the random weights so attention weighs in the residual
    stream. At the reference init the token-local MLP outweighs a
    near-uniform attention average, so an attention fault barely moves the
    logits: a chunked prefill that drops one past token lands right at the
    cross-path gate (``tests/test_torch_smoke.py``). Sharper scores (wq x 4),
    a louder attention output (wo x 8) and a quieter MLP (w_down x 0.125)
    make the same fault fail the gate several times over. In place, on the
    served params."""
    params["layers"]["attn"]["wq"].mul_(4.0)
    params["layers"]["attn"]["wo"].mul_(8.0)
    params["layers"]["mlp"]["w_down"].mul_(0.125)


def serve_prompts(V):
    """The serve phases' prompts (numpy seed 0): four whole prompts of 37,
    128, 129 and 700 tokens, then two fresh ones of 300 and 1100."""
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(1, V, n).astype(np.int32)

    return [prompt(n) for n in (37, 128, 129, 700)], [prompt(300),
                                                      prompt(1100)]


def check_logits(out, V):
    for uid, lg in out.items():
        if not np.all(np.isfinite(lg)) or lg.shape != (V,):
            raise AssertionError(f"uid {uid}: logits not finite / shape "
                                 f"{lg.shape}")


def serve(torch, pa, fa, KERNELS, reset_counts):
    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset

    cfg = get_preset("llama3-8b", param_dtype="bfloat16")
    model = TransformerLM(cfg)
    t0 = time.perf_counter()
    eng = InferenceEngineV2(model, max_sequences=8, max_seq_len=2048,
                            block_size=128, device="cuda", seed=0)
    attention_heavy(eng.params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for grp in (eng.params["embed"],
                                         eng.params["final_norm"])
                   for p in grp.values())
    n_params += sum(p.numel() for grp in eng.params["layers"].values()
                    for p in grp.values())
    pool_gb = 2 * eng.cache["k"].numel() * 2 / 1e9
    log(f"serve: llama3-8b D={cfg.hidden_size} L={cfg.num_layers} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} F={cfg.intermediate_size} "
        f"V={cfg.vocab_size}: {n_params / 1e9:.3f}B params, KV pool "
        f"{pool_gb:.2f} GB, built in {time.perf_counter() - t0:.1f} s")
    V = cfg.vocab_size

    def finite(out):
        check_logits(out, V)

    firsts, fresh = serve_prompts(V)
    torch.cuda.synchronize()
    reset_counts()
    with Replay(torch, pa, fa) as replay:
        replay.stage = "put"
        t = time.perf_counter()
        out1 = eng.put([0, 1, 2, 3], firsts)
        dt_prefill = time.perf_counter() - t
        finite(out1)
        nxt = [int(np.argmax(out1[u])) for u in range(4)]

        t = time.perf_counter()
        out2 = eng.put([0, 1, 2, 3, 4, 5],
                       [np.array([x], np.int32) for x in nxt] + fresh)
        dt_mixed = time.perf_counter() - t
        finite(out2)
        nxt = [int(np.argmax(out2[u])) for u in range(6)]

        replay.stage = "decode_batch"
        t = time.perf_counter()
        toks = eng.decode_batch(list(range(6)), nxt, steps=32)
        dt_decode = time.perf_counter() - t
    counts = {name: KERNELS[name].launches for name in SERVE_KERNELS}
    for u, tk in toks.items():
        if tk.shape != (32,) or tk.min() < 0 or tk.max() >= V:
            raise AssertionError(f"uid {u}: bad decoded tokens {tk}")
    missing = [n for n, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the serve phase: "
                             f"{missing} (counts {counts})")
    log(f"serve: launches {counts}")

    # cross-path: chunked 1100-token prefill vs one whole-prompt put
    whole = eng.put([6], [fresh[1]])[6]
    chunked = out2[5]
    rel = float(np.linalg.norm(chunked - whole) / np.linalg.norm(whole))
    log(f"serve: 1100-token prompt, chunked vs whole-prompt last logits: "
        f"rel L2 {rel:.3e}, max abs {np.abs(chunked - whole).max():.3e}, "
        f"argmax {int(np.argmax(chunked))} vs {int(np.argmax(whole))}")
    if not rel <= CROSS_PATH_REL_L2:
        raise AssertionError(f"cross-path mismatch: rel L2 {rel} > "
                             f"{CROSS_PATH_REL_L2}")
    replay_errs = replay.check()
    log(f"serve: captured launches replayed vs plain, max abs err "
        f"{replay_errs}")
    name = torch.cuda.get_device_name(0)
    n_prefill = sum(len(p) for p in firsts)
    n_mixed = 4 + sum(len(p) for p in fresh)
    log(f"serve [{name}]: whole-prompt prefill {n_prefill / dt_prefill:.1f} "
        f"tokens/s ({n_prefill} tokens, {dt_prefill * 1e3:.1f} ms, first "
        f"step of the process), mixed chunked step {n_mixed / dt_mixed:.1f} "
        f"tokens/s ({dt_mixed * 1e3:.1f} ms), decode_batch "
        f"{6 * 32 / dt_decode:.1f} tokens/s (6 x 32, {dt_decode * 1e3:.1f} "
        f"ms)")
    eng.flush(list(range(7)))
    return counts, out1


# ---------------------------------------------------------------------------
# phase 6: serve Llama-3-8B with int8/int4 weights and an int8/int4 KV pool
# ---------------------------------------------------------------------------

QUANT_ENGINES = (("Q1", "int4", "int8"), ("Q2", "int8", "int4"))
QUANT_KERNELS = ("qmm", "qmm_stacked", "paged_decode_int8",
                 "paged_decode_int4", "paged_past_int8", "paged_past_int4")


def tree_bytes(tree) -> int:
    """Bytes of a parameter tree (tensors and QuantizedWeights)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.nbytes


def serve_params(torch, cfg):
    """Phase 4's weights: seed-0 random bf16 on the card, rescaled by
    :func:`attention_heavy`."""
    from deepspeed_tpu_torch import TransformerLM

    params = TransformerLM(cfg).init(seed=0, device="cuda")
    attention_heavy(params)
    return params


def dequantized_tree(torch, qm, params):
    """A quantized serving tree with every QuantizedWeight expanded to the
    dense bf16 weight it stands for (``dequantize_matmul_weight``, per
    layer), held in the scales' (compute) dtype; the head becomes an untied
    ``lm_head``."""
    from deepspeed_tpu_torch.models.transformer import QuantizedWeight

    def dense(qw):
        ps, ss = ((qw.packed, qw.scales) if qw.packed.ndim == 2
                  else (qw.packed.unbind(0), qw.scales.unbind(0)))
        if qw.packed.ndim == 2:
            w = qm.dequantize_matmul_weight(ps, ss, qw.bits, qw.din)
        else:
            w = torch.stack([qm.dequantize_matmul_weight(p, sc, qw.bits,
                                                         qw.din)
                             for p, sc in zip(ps, ss)])
        return w.to(qw.scales.dtype)

    layers = {grp: {n: dense(w) if isinstance(w, QuantizedWeight) else w
                    for n, w in sub.items()}
              for grp, sub in params["layers"].items()}
    out = {k: v for k, v in params.items() if k not in ("layers",
                                                         "lm_head_q")}
    out["layers"] = layers
    out["lm_head"] = dense(params["lm_head_q"])
    return out


def weight_cross_check(torch, qm, KERNELS):
    """int8 and int4 weights through G/H against an engine served the dense
    bf16 weights they dequantize to, at 2 layers of llama3-8b's width
    (seed-0 weights at the reference init scale): the last-token logits of
    a whole-prompt ``put`` (2 prompts, 256 rows: H takes every layer
    product, G the head), rel L2 <= WEIGHT_REL_L2."""
    import dataclasses

    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset

    cfg = dataclasses.replace(get_preset("llama3-8b", param_dtype="bfloat16"),
                              num_layers=2)
    kw = dict(max_sequences=4, max_seq_len=512, block_size=128,
              device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (100, 60)]
    rel = {}
    for bits in (8, 4):
        params = TransformerLM(cfg).init(seed=0, device="cuda")
        eng = InferenceEngineV2(TransformerLM(cfg), params,
                                weight_dtype=f"int{bits}", **kw)
        del params
        n = {k: KERNELS[k].launches for k in ("qmm", "qmm_stacked")}
        got = eng.put([0, 1], prompts)
        if any(KERNELS[k].launches == c for k, c in n.items()):
            raise AssertionError("weight cross-check: G/H did not launch")
        ref_eng = InferenceEngineV2(
            TransformerLM(dataclasses.replace(cfg, tie_embeddings=False)),
            dequantized_tree(torch, qm, eng.params), **kw)
        want = ref_eng.put([0, 1], prompts)
        rel[f"int{bits}"] = max(
            float(np.linalg.norm(got[u] - want[u]) / np.linalg.norm(want[u]))
            for u in (0, 1))
        del eng, ref_eng
        gc.collect()
        torch.cuda.empty_cache()
    log(f"serve-quant: weight cross-check at 2 layers, G/H vs dense bf16 "
        f"dequantized weights, last-token logits rel L2 {rel} (gate "
        f"{WEIGHT_REL_L2})")
    bad = {k: r for k, r in rel.items() if not r <= WEIGHT_REL_L2}
    if bad:
        raise AssertionError(f"weight cross-check: rel L2 {bad} > "
                             f"{WEIGHT_REL_L2}")
    return rel


def serve_quant(torch, pa, qm, KERNELS, reset_counts, bf16_logits):
    """``InferenceEngineV2`` on llama3-8b at full width and depth from phase
    4's weights, Q1 (int4 weights, int8 pool) then Q2 (int8 weights, int4
    pool), each on phase 4's traffic under a :class:`QuantReplay`, then
    freed; then the weight cross-check. Returns launches per kernel, summed
    over the two engines."""
    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset

    cfg = get_preset("llama3-8b", param_dtype="bfloat16")
    V = cfg.vocab_size
    firsts, fresh = serve_prompts(V)
    name = torch.cuda.get_device_name(0)
    total = dict.fromkeys(QUANT_KERNELS, 0)
    for tag, wd, kd in QUANT_ENGINES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = serve_params(torch, cfg)
        dense_bytes = tree_bytes(params)
        eng = InferenceEngineV2(TransformerLM(cfg), params, max_sequences=8,
                                max_seq_len=2048, block_size=128,
                                device="cuda", weight_dtype=wd, kv_dtype=kd)
        del params
        gc.collect()
        torch.cuda.synchronize()
        q_bytes = tree_bytes(eng.params)
        pool_gb = sum(t.numel() * t.element_size()
                      for t in eng.cache.values()) / 1e9
        log(f"serve-quant {tag}: weight_dtype={wd} kv_dtype={kd}: served "
            f"tree {q_bytes / 1e9:.3f} GB against {dense_bytes / 1e9:.3f} GB "
            f"bf16 ({q_bytes / dense_bytes:.4f}), KV pool {pool_gb:.3f} GB, "
            f"built in {time.perf_counter() - t0:.1f} s")
        bits = int(kd[-1])
        reset_counts()
        with QuantReplay(torch, pa, qm, bits) as replay:
            replay.stage = "put"
            t = time.perf_counter()
            out1 = eng.put([0, 1, 2, 3], firsts)
            dt_prefill = time.perf_counter() - t
            check_logits(out1, V)
            nxt = [int(np.argmax(out1[u])) for u in range(4)]
            replay.stage = "mixed"
            t = time.perf_counter()
            out2 = eng.put([0, 1, 2, 3, 4, 5],
                           [np.array([x], np.int32) for x in nxt] + fresh)
            dt_mixed = time.perf_counter() - t
            check_logits(out2, V)
            nxt = [int(np.argmax(out2[u])) for u in range(6)]
            replay.stage = "decode_batch"
            t = time.perf_counter()
            toks = eng.decode_batch(list(range(6)), nxt, steps=32)
            dt_decode = time.perf_counter() - t
        counts = {k: KERNELS[k].launches for k in QUANT_KERNELS}
        for u, tk in toks.items():
            if tk.shape != (32,) or tk.min() < 0 or tk.max() >= V:
                raise AssertionError(f"{tag} uid {u}: bad decoded tokens {tk}")
        want = {"qmm", "qmm_stacked", f"paged_decode_{kd}",
                f"paged_past_{kd}"}
        missing = [k for k in want if counts[k] == 0]
        if missing:
            raise AssertionError(f"serve-quant {tag}: kernels never launched: "
                                 f"{missing} (counts {counts})")
        errs = replay.check()
        rel = {u: float(np.linalg.norm(out1[u] - bf16_logits[u])
                        / np.linalg.norm(bf16_logits[u])) for u in range(4)}
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_prefill = sum(len(p) for p in firsts)
        n_mixed = 4 + sum(len(p) for p in fresh)
        log(f"serve-quant {tag}: launches {counts}; captured launches "
            f"replayed vs plain, max abs err {errs}")
        log(f"serve-quant {tag}: whole-prompt last-token logits vs phase "
            f"4's bf16 engine, rel L2 {rel} (no gate: quantization error)")
        log(f"serve-quant {tag} [{name}]: whole-prompt prefill "
            f"{n_prefill / dt_prefill:.1f} tokens/s ({dt_prefill * 1e3:.1f} "
            f"ms), mixed chunked step {n_mixed / dt_mixed:.1f} tokens/s "
            f"({dt_mixed * 1e3:.1f} ms), decode_batch "
            f"{6 * 32 / dt_decode:.1f} tokens/s (6 x 32, "
            f"{dt_decode * 1e3:.1f} ms), peak memory {peak:.2f} GB")
        for k, c in counts.items():
            total[k] += c
        del eng, replay
    gc.collect()
    torch.cuda.empty_cache()
    weight_cross_check(torch, qm, KERNELS)
    return total


# ---------------------------------------------------------------------------
# phase 7: the dense-tile and dense-cache engines and init_inference's v1
# ---------------------------------------------------------------------------

DENSE_ENGINES = (("a", dict(packed=False)), ("b", dict(paged=False)))
DENSE_DECODE_PUTS = 16
V1_NEW_TOKENS = 16


class DenseReplay(Replay):
    """Phase 7's :class:`Replay` of kernel I: its first launch (stage
    ``put``: the prompt step's tile) through ``plain_paged_attention``,
    held per 64-row tile like phase 3's."""

    REQUIRED = {("paged_tile", "put")}

    @staticmethod
    def make_targets(pa, fa):
        return {"paged_tile": (pa, "paged_attention",
                               pa.plain_paged_attention)}


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def max_rel_l2(got, want) -> float:
    """The largest :func:`rel_l2` over every uid of every ``put``."""
    return max(rel_l2(o[u], w[u]) for o, w in zip(got, want) for u in w)


def dense_traffic(eng, prompts, steps: int, feeds=None, first_uid: int = 0):
    """``prompts`` (uids ``first_uid``..) in one ``put``, then ``steps``
    single-token ``put`` steps of every uid, fed ``feeds[s]`` or, without
    ``feeds``, the engine's own argmax. Returns (logits of every put, the
    tokens fed, the prompt put's seconds, each decode put's seconds)."""
    uids = list(range(first_uid, first_uid + len(prompts)))
    t = time.perf_counter()
    outs = [eng.put(uids, prompts)]
    t_prompt = time.perf_counter() - t
    fed, t_dec = [], []
    for s in range(steps):
        toks = (feeds[s] if feeds is not None
                else [int(np.argmax(outs[-1][u])) for u in uids])
        fed.append(toks)
        t = time.perf_counter()
        outs.append(eng.put(uids, [np.array([x], np.int32) for x in toks]))
        t_dec.append(time.perf_counter() - t)
    return outs, fed, t_prompt, t_dec


def v1_generate(eng, ids, new_tokens: int):
    """``eng.generate`` (greedy) with the last-row logits of every
    ``forward_with_cache`` step captured: the prompt step, then one step
    per new token but the last. Returns (the new tokens [B, n], each
    step's logits as ``{row: [V]}``, seconds; the capture's copy to the
    host is inside the time)."""
    model, steps = eng.module, []
    real = model.forward_with_cache

    def capture(params, input_ids, cache):
        logits, cache = real(params, input_ids, cache)
        last = logits[:, -1].float().cpu().numpy()
        steps.append(dict(enumerate(last)))
        return logits, cache

    model.forward_with_cache = capture
    try:
        t = time.perf_counter()
        gen = eng.generate(ids, max_new_tokens=new_tokens)
        dt = time.perf_counter() - t
    finally:
        del model.forward_with_cache
    T, V = ids.shape[1], model.cfg.vocab_size
    if gen.shape != (len(ids), T + new_tokens) or gen.min() < 0 \
            or gen.max() >= V or not np.array_equal(gen[:, :T], ids):
        raise AssertionError(f"serve-dense (c): bad generate output "
                             f"{gen.shape}")
    return gen[:, T:], steps, dt


@contextlib.contextmanager
def swapped(mod, attr, make):
    """``mod.attr`` replaced by ``make(mod.attr)`` inside the block."""
    real = getattr(mod, attr)
    setattr(mod, attr, make(real))
    try:
        yield
    finally:
        setattr(mod, attr, real)


def drops_newest_column(fn):
    """A faulty kernel-I stand-in ((a)): ``fn`` with every row's newest
    visible column (its own position) dropped."""
    def faulty(q, k_pool, v_pool, block_tables, pos, window=None, layer=0):
        return fn(q, k_pool, v_pool, block_tables, pos - 1, window, layer)
    return faulty


def cached_drops_newest_column(fn):
    """A faulty ``_cached_attention`` stand-in ((b) and (c)): ``fn`` with
    every row's newest visible column dropped from its mask."""
    def faulty(q, k, v, valid):
        kept = valid.clone()
        kept[..., :-1] &= valid[..., 1:]
        kept[..., -1] = False
        return fn(q, k, v, kept)
    return faulty


def free_card(torch, device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def owns_no_copy(tree, params, tag: str) -> None:
    a, b = tree["layers"]["attn"]["wq"], params["layers"]["attn"]["wq"]
    if a.data_ptr() != b.data_ptr():
        raise AssertionError(f"serve-dense ({tag}): the engine copied the "
                             f"weight tree")


def dense_engine(torch, model, tree, tag: str, device, v1: bool = False,
                 **kw):
    """A fresh engine on ``tree`` (the last one freed first):
    ``init_inference``'s with ``v1``, else ``InferenceEngineV2(**kw)``."""
    import deepspeed_tpu_torch as tds

    free_card(torch, device)
    if v1:
        eng = tds.init_inference(model, params=tree, device=device)
    else:
        eng = tds.InferenceEngineV2(model, tree, device=device, **kw)
    owns_no_copy(tree, eng.params, tag)
    return eng


def dense_runs(torch, pa, model, tree, prompts, v1_ids, steps: int,
               device="cuda", noise_floor: bool = False, **engine_kw):
    """Phase 7's engines on one weight tree, on any device. First (c)
    ``init_inference(model, params=tree)``: ``forward``'s last-row logits
    of ``v1_ids`` and a greedy ``generate`` of ``V1_NEW_TOKENS`` with every
    step's logits captured. Then a packed engine runs the traffic (feeding
    its own argmax), and ``v1_ids`` as a whole-prompt ``put`` followed by
    one single-token ``put`` per token ``generate`` chose; with
    ``noise_floor`` a second packed engine runs the same traffic with the
    prompts put one at a time (other batch shapes, the same function: its
    distance from the first is the bf16 noise of this model); then (a)
    ``packed=False`` under a :class:`DenseReplay` and (b) ``paged=False``
    run the traffic fed the first engine's tokens. Engines share ``tree``
    (none copies it; checked) and each is freed before the next. Returns
    ``rel`` (the largest relative L2 of any logits vector against the
    packed engine's: ``forward``, (c)'s ``generate`` steps, (a), (b),
    ``noise``), I's replay errors and tiles, timings, the generated tokens
    and ``ref``, the packed engine's readings for :func:`dense_controls`;
    raises on a copy, a non-finite logit or a bad ``generate`` output."""
    def engine(tag, **kw):
        return dense_engine(torch, model, tree, tag, device, **kw,
                            **engine_kw)

    V = model.cfg.vocab_size
    uids = list(range(len(prompts)))
    v1_first = len(prompts)
    ids = np.stack(v1_ids)
    res = {"engines": {}, "rel": {}}
    # (c) first: its greedy tokens feed the packed engine's v1 puts
    eng = engine("c", v1=True)
    fwd = eng.forward(ids)[:, -1].float().cpu().numpy()
    free_card(torch, device)
    gen, got_c, dt = v1_generate(eng, ids, V1_NEW_TOKENS)
    res["generated"], res["engines"]["c"] = gen, (dt, None)
    del eng
    eng = engine("packed")
    want, feeds, tp, td = dense_traffic(eng, prompts, steps)
    want_c, _, _, _ = dense_traffic(eng, list(v1_ids), V1_NEW_TOKENS - 1,
                                    feeds=gen.T, first_uid=v1_first)
    res["engines"]["packed"] = (tp, td)
    del eng
    # (c)'s rows are 0.., the packed engine's v1 uids v1_first..
    want_c = [{u - v1_first: x for u, x in w.items()} for w in want_c]
    res["rel"]["forward"] = max_rel_l2([dict(enumerate(fwd))], want_c)
    res["rel"]["c"] = max_rel_l2(got_c, want_c)
    if noise_floor:
        eng = engine("noise")
        got = [{}]
        for u, prompt in zip(uids, prompts):
            got[0].update(eng.put([u], [prompt]))
        for toks in feeds:
            got.append(eng.put(uids, [np.array([x], np.int32)
                                      for x in toks]))
        res["rel"]["noise"] = max_rel_l2(got, want)
        del eng, got
    for tag, kw in DENSE_ENGINES:
        eng = engine(tag, **kw)
        replay = DenseReplay(torch, pa, None)
        with replay:
            replay.stage = "put"
            got, _, tp, td = dense_traffic(eng, prompts, steps, feeds)
        for outs in got:
            check_logits(outs, V)
        res["rel"][tag] = max_rel_l2(got, want)
        res["engines"][tag] = (tp, td)
        if tag == "a":
            res["replay"], res["replay_tiles"] = replay.check(), replay.tiles
        del eng, got, replay
    free_card(torch, device)
    res["ref"] = dict(want=want, feeds=feeds, want_c=want_c, ids=ids)
    return res


def dense_controls(torch, pa, model, tree, prompts, ref, device="cuda",
                   **engine_kw):
    """(a), (b) and (c) of :func:`dense_runs` again, with each row's newest
    visible column dropped from their attention (:func:`drops_newest_column`
    in place of kernel I's wrapper, :func:`cached_drops_newest_column` in
    place of the dense cache's ``_cached_attention``; (c) as its prompt
    step), each against the packed engine's readings ``ref``: the rel L2 a
    gate must tell apart from the sound one, per engine."""
    from deepspeed_tpu_torch.models import transformer as tm

    faults = {"a": (pa, "paged_attention", drops_newest_column),
              "b": (tm, "_cached_attention", cached_drops_newest_column)}
    want, feeds = ref["want"], ref["feeds"]
    faulty = {}
    for tag, kw in DENSE_ENGINES:
        eng = dense_engine(torch, model, tree, f"{tag}, faulty", device,
                           **kw, **engine_kw)
        with swapped(*faults[tag]):
            got, _, _, _ = dense_traffic(eng, prompts, len(feeds), feeds)
        faulty[tag] = max_rel_l2(got, want)
        del eng, got
    eng = dense_engine(torch, model, tree, "c, faulty", device, v1=True)
    with swapped(*faults["b"]):
        _, got, _ = v1_generate(eng, ref["ids"], 1)
    faulty["c"] = max_rel_l2(got, ref["want_c"][:1])
    del eng, got
    free_card(torch, device)
    return faulty


def gate_rel(tag: str, rel: dict, limits: dict) -> None:
    """Every ``rel[k]`` within ``limits[k]``."""
    bad = {k: rel[k] for k, lim in limits.items() if not rel[k] <= lim}
    if bad:
        raise AssertionError(f"{tag}: logits vs the packed engine, rel L2 "
                             f"{bad} over the limits {limits}")


def gate_controls(tag: str, faulty: dict, limits: dict, margin: float):
    """Every control's reading past ``margin`` x its gate's limit: the
    gate sees a dropped column."""
    blind = {k: faulty[k] for k, lim in limits.items()
             if k in faulty and not faulty[k] > margin * lim}
    if blind:
        raise AssertionError(f"{tag}: the gate is blind: attention that "
                             f"drops the newest column gives rel L2 {blind}, "
                             f"not past {margin} x the limits {limits}")


def dense_cross_check(torch, pa, model, tree, prompts, v1_ids, steps: int,
                      device="cuda", **engine_kw):
    """Phase 7's gate at ``DENSE_REL_L2`` where bf16 noise
    leaves it room (a shallow model of the served width, weights at the
    reference init scale): ``forward``, (c)'s ``generate`` steps, (a) and
    (b) against the packed engine, each rel L2 <= ``DENSE_REL_L2``, and
    each control (:func:`dense_controls`) past ``DENSE_CONTROL_MARGIN`` x the
    gate. Returns :func:`dense_runs`' result."""
    res = dense_runs(torch, pa, model, tree, prompts, v1_ids, steps,
                     device=device, **engine_kw)
    res["faulty"] = dense_controls(torch, pa, model, tree, prompts,
                                   res["ref"], device=device, **engine_kw)
    limits = dict.fromkeys(("forward", "a", "b", "c"), DENSE_REL_L2)
    gate_rel("serve-dense cross-check", res["rel"], limits)
    gate_controls("serve-dense cross-check", res["faulty"], limits,
                  DENSE_CONTROL_MARGIN)
    return res


def serve_dense(torch, pa, KERNELS, reset_counts):
    """Phase 7 at llama3-8b's full width and depth on phase 6's weights
    (one bf16 tree, seed 0, ``attention_heavy``), ``max_seq_len`` 2048, 8
    slots, block 128: phase 4's four prompts, 16 decode puts, v1 on four
    128-token prompts, each engine's control, then the op builder's RMSNorm
    on the card. Gates: every logits vector finite, I's first launch
    against its plain version per tile, ``forward`` within
    ``DENSE_REL_L2`` of the packed engine (the same kernels at the same
    shapes), (a), (b) and (c)'s ``generate`` steps within
    ``DENSE_FULL_REL_L2`` of the packed engine and each control past
    ``DENSE_FULL_CONTROL_MARGIN`` x its limit, I and J launched. Then
    :func:`dense_cross_check` at 2 layers of the same width. Returns the
    phase's launches per kernel."""
    import dataclasses

    from deepspeed_tpu_torch import TransformerLM, get_preset
    from deepspeed_tpu_torch.ops import get_op_builder
    from deepspeed_tpu_torch.ops import rms_norm as rn

    cfg = get_preset("llama3-8b", param_dtype="bfloat16")
    model = TransformerLM(cfg)
    tree = serve_params(torch, cfg)
    firsts, _ = serve_prompts(cfg.vocab_size)
    rng = np.random.default_rng(2)
    v1_ids = [rng.integers(1, cfg.vocab_size, 128).astype(np.int32)
              for _ in range(4)]
    kw = dict(max_sequences=8, max_seq_len=2048, block_size=128)
    torch.cuda.synchronize()
    reset_counts()
    res = dense_runs(torch, pa, model, tree, firsts, v1_ids,
                     DENSE_DECODE_PUTS, noise_floor=True, **kw)
    x = torch.randn(4, 128, cfg.hidden_size, device="cuda").bfloat16()
    w = tree["final_norm"]["scale"]
    y = get_op_builder("rms_norm").load()(x, w)
    close("J via the op builder", y.reshape(-1, cfg.hidden_size),
          rn.plain_rms_norm(x.reshape(-1, cfg.hidden_size), w),
          RMS_TOL["bfloat16"], RMS_TOL["bfloat16"])
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in KERNELS.items() if k.launches}
    res["faulty"] = dense_controls(torch, pa, model, tree, firsts,
                                   res.pop("ref"), **kw)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    rel, faulty = res["rel"], res["faulty"]
    log(f"serve-dense: launches {counts}; kernel I's first launch replayed "
        f"vs plain, max abs err {res['replay']}, (max abs err, max |plain|, "
        f"worst {TILE}-row tile err / tile max |plain|) "
        f"{res['replay_tiles']} (gate {BWD_REL})")
    log(f"serve-dense at full depth, logits vs the packed engine, rel L2: "
        f"forward {rel['forward']:.3e} (gate {DENSE_REL_L2}); "
        + "; ".join(f"({k}) {rel[k]:.3e} (gate {DENSE_FULL_REL_L2[k]}, "
                    f"control {faulty[k]:.3e})" for k in "abc")
        + f"; the packed engine's own noise floor {rel['noise']:.3e}")
    names = {"packed": "packed (reference)", "a": "(a) packed=False",
             "b": "(b) paged=False"}
    n_prompt = sum(len(p) for p in firsts)
    for tag, (tp, td) in res["engines"].items():
        if tag == "c":
            log(f"serve-dense (c) init_inference(...).generate [{card}]: 4 x "
                f"128 prompts, {V1_NEW_TOKENS} new tokens each in "
                f"{tp * 1e3:.1f} ms ({4 * V1_NEW_TOKENS / tp:.1f} tokens/s)")
            continue
        log(f"serve-dense {names[tag]} [{card}]: prompt put "
            f"{n_prompt / tp:.1f} tokens/s ({n_prompt} tokens, "
            f"{tp * 1e3:.1f} ms), decode put {np.mean(td) * 1e3:.2f} ms "
            f"mean / {np.median(td) * 1e3:.2f} ms median over {len(td)} "
            f"(4 sequences)")
    gate_rel("serve-dense", rel, {"forward": DENSE_REL_L2,
                                  **DENSE_FULL_REL_L2})
    gate_controls("serve-dense", faulty, DENSE_FULL_REL_L2,
                  DENSE_FULL_CONTROL_MARGIN)
    if not counts.get("paged_tile") or not counts.get("rms_norm"):
        raise AssertionError(f"serve-dense: kernel I or J never launched "
                             f"(counts {counts})")
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    model2 = TransformerLM(cfg2)
    res2 = dense_cross_check(
        torch, pa, model2, model2.init(seed=0, device="cuda"), firsts,
        v1_ids, 4, **kw)
    log(f"serve-dense cross-check at 2 layers (seed-0 weights at the init "
        f"scale): logits vs the packed engine, rel L2 {res2['rel']} (gate "
        f"{DENSE_REL_L2}); controls (newest column dropped) "
        f"{res2['faulty']} (past {DENSE_CONTROL_MARGIN} x the gate)")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 5: train Llama-3.2-1B through initialize
# ---------------------------------------------------------------------------

class plain_attention:
    """Swaps kernels D, E and F's wrappers for their plain versions (module
    attributes, restored on exit): the attention of the gradient
    cross-check's reference run."""

    def __init__(self, fa):
        self.fa = fa
        self.saved = {}

    def __enter__(self):
        for mod, attr, plain in TrainReplay.make_targets(None,
                                                         self.fa).values():
            self.saved[attr] = getattr(mod, attr)
            setattr(mod, attr, plain)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.fa, attr, fn)


def grad_rel_l2(torch, fa, model, params, batch):
    """Relative L2, per leaf, of the gradients of wq, wk, wv, wo and the
    embedding through the kernels' wrappers against those through the plain
    attention (``params`` gain ``requires_grad``)."""
    attn = params["layers"]["attn"]
    leaves = {n: attn[n] for n in ("wq", "wk", "wv", "wo")}
    leaves["embed"] = params["embed"]["tokens"]
    for t in leaves.values():
        t.requires_grad_()

    def grads():
        loss = model.loss_fn(params, batch)
        return torch.autograd.grad(loss, list(leaves.values()))

    got = grads()
    with plain_attention(fa):
        want = grads()
    return {n: float((g.float() - w.float()).norm() / w.float().norm())
            for n, g, w in zip(leaves, got, want)}


def grad_cross_check(torch, fa, batch):
    """The gradient cross-check at 2 layers of Llama-3.2-1B's width."""
    import dataclasses

    from deepspeed_tpu_torch import TransformerLM
    from deepspeed_tpu_torch.tools.train_profile import train_model_config

    model = TransformerLM(dataclasses.replace(train_model_config(),
                                              num_layers=2))
    params = model.init(seed=0, device="cuda")
    ids = {"input_ids": torch.from_numpy(batch["input_ids"]).cuda()}
    rel = grad_rel_l2(torch, fa, model, params, ids)
    log(f"train: gradient cross-check at 2 layers, kernels vs plain "
        f"attention, rel L2 {rel}")
    bad = {n: r for n, r in rel.items() if not r <= GRAD_REL_L2}
    if bad:
        raise AssertionError(f"gradient cross-check: rel L2 {bad} > "
                             f"{GRAD_REL_L2}")
    return rel


def train(torch, fa, KERNELS, reset_counts):
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch import TransformerLM
    from deepspeed_tpu_torch.models.spec import num_params
    from deepspeed_tpu_torch.tools.train_profile import (TRAIN_CONFIG,
                                                         TRAIN_SEQ,
                                                         fixed_batch,
                                                         train_model_config)

    cfg = train_model_config()
    t0 = time.perf_counter()
    eng, *_ = tds.initialize(TransformerLM(cfg), dict(TRAIN_CONFIG))
    torch.cuda.synchronize()
    n = num_params(eng.params)
    log(f"train: llama3-1b D={cfg.hidden_size} L={cfg.num_layers} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} F={cfg.intermediate_size} "
        f"V={cfg.vocab_size}: {n / 1e9:.3f}B params (fp32 master, "
        f"{cfg.dtype} compute), built in {time.perf_counter() - t0:.1f} s")
    micro = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    ga = TRAIN_CONFIG["gradient_accumulation_steps"]
    batch = fixed_batch(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_s = [], [], []
    reset_counts()
    with TrainReplay(torch, fa) as replay:
        replay.stage = "train"
        for _ in range(4):
            t = time.perf_counter()
            losses.append(eng.train_batch(itertools.repeat(batch)))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            norms.append(eng.get_global_grad_norm())
        t = time.perf_counter()
        losses.append(float(eng.fused_train_step(
            {"input_ids": np.concatenate([batch["input_ids"]] * ga)})))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        norms.append(eng.get_global_grad_norm())
    counts = {name: KERNELS[name].launches for name in TRAIN_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"train: losses {losses}, grad norms {norms}, launches {counts}, "
        f"peak memory {peak_gb:.1f} GB")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"train: non-finite loss or grad norm: "
                             f"{losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: last loss {losses[-1]} not below the "
                             f"first {losses[0]}")
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the train phase: "
                             f"{missing} (counts {counts})")
    replay_errs = replay.check()
    log(f"train: captured launches replayed vs plain, max abs err "
        f"{replay_errs}; (max abs err, max |plain|, worst {TILE}-row tile "
        f"err / tile max |plain|) {replay.tiles} (gate {BWD_REL})")
    tokens = micro * ga * TRAIN_SEQ
    flops_per_token = 6 * n + 12 * cfg.num_layers * TRAIN_SEQ \
        * cfg.hidden_size
    steady = float(np.median(step_s[1:]))
    tps = tokens / steady
    log(f"train [{torch.cuda.get_device_name(0)}]: step ms "
        f"{[round(s * 1e3, 1) for s in step_s]} (4 train_batch, then "
        f"fused_train_step; the first includes warm-up), median of the "
        f"last four {steady * 1e3:.1f} ms = {tps:.1f} tokens/s "
        f"({tokens} tokens/step), model-FLOPs share "
        f"{tps * flops_per_token / BF16_FLOPS_PER_S:.4f} of 989 TFLOP/s "
        f"({flops_per_token / 1e9:.3f} GFLOP/token)")
    del eng, replay
    gc.collect()
    torch.cuda.empty_cache()
    grad_cross_check(torch, fa, batch)
    return counts


# ---------------------------------------------------------------------------
# phase 8: head dims 96 and 256 -- phi3-mini and pythia-1b served and trained
# ---------------------------------------------------------------------------

# each preset with the int pool it is served over beside its bf16 one: the
# two presets run both of A's and B's int modes at a new head dim
HEAD_DIM_PRESETS = (("phi3-mini", "int8"), ("pythia-1b", "int4"))
# layers trained at full width (None: the preset's depth): phi3-mini's fp32
# master weights and AdamW state alone take ~61 GB at its 32 layers
HEAD_DIM_TRAIN_LAYERS = {"phi3-mini": 2, "pythia-1b": None}
HEAD_DIM_TRAIN_STEPS = 3
HEAD_DIM_DENSE_PUTS = 4


def head_dim_serve(torch, pa, fa, KERNELS, reset_counts, name, int_kv):
    """``InferenceEngineV2`` on ``name`` at full width and depth (seed-0 bf16
    weights rescaled by :func:`attention_heavy`; max_seq_len 2048, 8 slots,
    block 128), once over a bf16 pool and once over ``int_kv``, each engine
    on phase 4's traffic under a :class:`Replay` of the path's first
    launches (A, B, C, D or A's and B's int modes), then freed. Gates:
    finite logits, valid tokens, every kernel of the path launched, the
    replays, and (bf16 pool) the 1100-token prompt chunked against a whole-
    prompt ``put`` at ``CROSS_PATH_REL_L2``. Returns launches per kernel."""
    from deepspeed_tpu_torch import InferenceEngineV2, TransformerLM, get_preset
    from deepspeed_tpu_torch.models.spec import num_params

    cfg = get_preset(name, param_dtype="bfloat16")
    model = TransformerLM(cfg)
    tree = serve_params(torch, cfg)
    V = cfg.vocab_size
    firsts, fresh = serve_prompts(V)
    card = torch.cuda.get_device_name(0)
    log(f"head-dims serve: {name} D={cfg.hidden_size} L={cfg.num_layers} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} d={cfg.head_dim} "
        f"F={cfg.intermediate_size} V={V} ({cfg.arch}, rope_pct "
        f"{cfg.rope_pct}, parallel block {cfg.parallel_block}): "
        f"{num_params(tree) / 1e9:.3f}B params")
    total = {}
    for kv in ("bf16", int_kv):
        free_card(torch, "cuda")
        eng = InferenceEngineV2(model, tree, max_sequences=8,
                                max_seq_len=2048, block_size=128,
                                device="cuda", kv_dtype=kv)
        tail = "" if kv == "bf16" else f"_{kv}"
        dec, past = f"paged_decode{tail}", f"paged_past{tail}"
        path = (dec, past, "chunk_self", "flash_fwd")
        torch.cuda.synchronize()
        reset_counts()
        replay = Replay(torch, pa, fa)
        replay.REQUIRED = {(dec, "put"), (past, "put"), ("chunk_self", "put"),
                           ("flash_fwd", "put"), (dec, "decode_batch")}
        with replay:
            replay.stage = "put"
            t = time.perf_counter()
            out1 = eng.put([0, 1, 2, 3], firsts)
            dt_prefill = time.perf_counter() - t
            check_logits(out1, V)
            nxt = [int(np.argmax(out1[u])) for u in range(4)]
            t = time.perf_counter()
            out2 = eng.put([0, 1, 2, 3, 4, 5],
                           [np.array([x], np.int32) for x in nxt] + fresh)
            dt_mixed = time.perf_counter() - t
            check_logits(out2, V)
            nxt = [int(np.argmax(out2[u])) for u in range(6)]
            replay.stage = "decode_batch"
            t = time.perf_counter()
            toks = eng.decode_batch(list(range(6)), nxt, steps=32)
            dt_decode = time.perf_counter() - t
        counts = {k: KERNELS[k].launches for k in path}
        for u, tk in toks.items():
            if tk.shape != (32,) or tk.min() < 0 or tk.max() >= V:
                raise AssertionError(f"head-dims {name} {kv}: uid {u}: bad "
                                     f"decoded tokens {tk}")
        missing = [k for k, c in counts.items() if c == 0]
        if missing:
            raise AssertionError(f"head-dims {name} {kv}: kernels never "
                                 f"launched: {missing} (counts {counts})")
        cross = ""
        if kv == "bf16":
            whole = eng.put([6], [fresh[1]])[6]
            rel = rel_l2(out2[5], whole)
            cross = (f"; 1100-token prompt chunked vs whole, last logits rel "
                     f"L2 {rel:.3e} (gate {CROSS_PATH_REL_L2})")
            if not rel <= CROSS_PATH_REL_L2:
                raise AssertionError(f"head-dims {name}: cross-path rel L2 "
                                     f"{rel} > {CROSS_PATH_REL_L2}")
        errs = replay.check()
        log(f"head-dims serve {name} kv_dtype={kv}: launches {counts}; "
            f"captured launches replayed vs plain, max abs err {errs}{cross}")
        n_prefill = sum(len(p) for p in firsts)
        n_mixed = 4 + sum(len(p) for p in fresh)
        log(f"head-dims serve {name} kv_dtype={kv} [{card}]: whole-prompt "
            f"prefill {n_prefill / dt_prefill:.1f} tokens/s "
            f"({dt_prefill * 1e3:.1f} ms), mixed chunked step "
            f"{n_mixed / dt_mixed:.1f} tokens/s ({dt_mixed * 1e3:.1f} ms), "
            f"decode_batch {6 * 32 / dt_decode:.1f} tokens/s (6 x 32, "
            f"{dt_decode * 1e3:.1f} ms)")
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c
        del eng, replay
    del tree
    free_card(torch, "cuda")
    return total


def head_dim_dense(torch, pa, KERNELS, reset_counts, name):
    """Kernel I's engine (``packed=False``) against the packed engine at 2
    layers of ``name``'s width (seed-0 weights at the init scale): phase
    4's four prompts in one ``put``, then ``HEAD_DIM_DENSE_PUTS``
    single-token ``put`` steps fed the packed engine's argmax; every logits
    vector within ``DENSE_REL_L2`` (relative L2) of the packed engine's and
    I's first launch replayed per 64-row tile. Returns I's launches."""
    import dataclasses

    from deepspeed_tpu_torch import TransformerLM, get_preset

    cfg = dataclasses.replace(get_preset(name, param_dtype="bfloat16"),
                              num_layers=2)
    model = TransformerLM(cfg)
    tree = model.init(seed=0, device="cuda")
    firsts, _ = serve_prompts(cfg.vocab_size)
    kw = dict(max_sequences=8, max_seq_len=2048, block_size=128)
    eng = dense_engine(torch, model, tree, f"{name} packed", "cuda", **kw)
    want, feeds, _, _ = dense_traffic(eng, firsts, HEAD_DIM_DENSE_PUTS)
    del eng
    eng = dense_engine(torch, model, tree, f"{name} (a)", "cuda",
                       packed=False, **kw)
    reset_counts()
    replay = DenseReplay(torch, pa, None)
    with replay:
        replay.stage = "put"
        got, _, _, _ = dense_traffic(eng, firsts, HEAD_DIM_DENSE_PUTS, feeds)
    launches = KERNELS["paged_tile"].launches
    for outs in got:
        check_logits(outs, cfg.vocab_size)
    rel = max_rel_l2(got, want)
    errs = replay.check()
    del eng, replay, tree
    free_card(torch, "cuda")
    log(f"head-dims dense {name} at 2 layers: packed=False (kernel I, "
        f"{launches} launches) vs the packed engine, rel L2 {rel:.3e} (gate "
        f"{DENSE_REL_L2}); I's first launch replayed vs plain {errs}")
    if not rel <= DENSE_REL_L2:
        raise AssertionError(f"head-dims dense {name}: rel L2 {rel} > "
                             f"{DENSE_REL_L2}")
    if not launches:
        raise AssertionError(f"head-dims dense {name}: kernel I never "
                             f"launched")
    return {"paged_tile": launches}


def head_dim_train(torch, fa, KERNELS, reset_counts, name):
    """``initialize`` on ``name`` at full width (depth
    ``HEAD_DIM_TRAIN_LAYERS``), max_seq_len 2048, random fp32 master weights
    from seed 0, bf16 compute, phase 5's config at micro-batch 2 and GA 1:
    ``HEAD_DIM_TRAIN_STEPS`` ``train_batch`` steps on one numpy-seeded
    micro-batch [2, 2048] under a :class:`TrainReplay` of D, E and F. Gates:
    finite losses and grad norms, the last loss below the first, D, E and F
    launched, the replays; then the per-leaf gradient cross-check (kernels
    vs plain attention) at 2 layers of the same width at ``GRAD_REL_L2``.
    Returns launches per kernel."""
    import dataclasses

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch import TransformerLM, get_preset
    from deepspeed_tpu_torch.models.spec import num_params
    from deepspeed_tpu_torch.tools.train_profile import TRAIN_CONFIG, TRAIN_SEQ

    cfg = get_preset(name, max_seq_len=TRAIN_SEQ)
    if HEAD_DIM_TRAIN_LAYERS[name]:
        cfg = dataclasses.replace(cfg, num_layers=HEAD_DIM_TRAIN_LAYERS[name])
    micro = 2
    eng, *_ = tds.initialize(TransformerLM(cfg), dict(
        TRAIN_CONFIG, train_micro_batch_size_per_gpu=micro,
        gradient_accumulation_steps=1))
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (micro, TRAIN_SEQ)).astype(np.int32)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_s = [], [], []
    reset_counts()
    with TrainReplay(torch, fa) as replay:
        replay.stage = "train"
        for _ in range(HEAD_DIM_TRAIN_STEPS):
            t = time.perf_counter()
            losses.append(eng.train_batch(itertools.repeat(batch)))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            norms.append(eng.get_global_grad_norm())
    counts = {k: KERNELS[k].launches for k in TRAIN_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = num_params(eng.params)
    log(f"head-dims train {name} D={cfg.hidden_size} L={cfg.num_layers} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} d={cfg.head_dim}: "
        f"{n / 1e9:.3f}B params, losses {losses}, grad norms {norms}, "
        f"launches {counts}, peak memory {peak:.1f} GB, step ms "
        f"{[round(x * 1e3, 1) for x in step_s]} "
        f"[{torch.cuda.get_device_name(0)}]")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"head-dims train {name}: non-finite loss or "
                             f"grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"head-dims train {name}: last loss "
                             f"{losses[-1]} not below the first {losses[0]}")
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"head-dims train {name}: kernels never "
                             f"launched: {missing} (counts {counts})")
    errs = replay.check()
    log(f"head-dims train {name}: captured launches replayed vs plain, max "
        f"abs err {errs}; (max abs err, max |plain|, worst {TILE}-row tile "
        f"err / tile max |plain|) {replay.tiles} (gate {BWD_REL})")
    del eng, replay
    free_card(torch, "cuda")
    model = TransformerLM(dataclasses.replace(cfg, num_layers=2))
    params = model.init(seed=0, device="cuda")
    ids = {"input_ids": torch.from_numpy(batch["input_ids"]).cuda()}
    rel = grad_rel_l2(torch, fa, model, params, ids)
    del params
    free_card(torch, "cuda")
    log(f"head-dims train {name}: gradient cross-check at 2 layers, kernels "
        f"vs plain attention, rel L2 {rel} (gate {GRAD_REL_L2})")
    bad = {k: r for k, r in rel.items() if not r <= GRAD_REL_L2}
    if bad:
        raise AssertionError(f"head-dims train {name}: gradient cross-check "
                             f"rel L2 {bad} > {GRAD_REL_L2}")
    return counts


def head_dims(torch, pa, fa, KERNELS, reset_counts):
    """Phase 8: each of ``HEAD_DIM_PRESETS`` served (:func:`head_dim_serve`),
    its dense-tile engine checked (:func:`head_dim_dense`) and trained
    (:func:`head_dim_train`). Every attention kernel runs here at d = 96
    or d = 256 and must launch. Returns the phase's launches per kernel."""
    total = {}
    for name, int_kv in HEAD_DIM_PRESETS:
        for counts in (
                head_dim_serve(torch, pa, fa, KERNELS, reset_counts, name,
                               int_kv),
                head_dim_dense(torch, pa, KERNELS, reset_counts, name),
                head_dim_train(torch, fa, KERNELS, reset_counts, name)):
            for k, c in counts.items():
                total[k] = total.get(k, 0) + c
    want = {"paged_decode", "paged_decode_int8", "paged_decode_int4",
            "paged_past", "paged_past_int8", "paged_past_int4", "chunk_self",
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_tile"}
    missing = sorted(k for k in want if not total.get(k))
    if missing:
        raise AssertionError(f"head-dims: kernels never launched {missing}")
    log(f"head-dims: launches {total}")
    return total


def main() -> int:
    # the train phase follows the 8B serve phase in one process
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    card = card_line()
    log(f"device: {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")

    t = time.perf_counter()
    spent = _build.build_all()
    log(f"build: {time.perf_counter() - t:.1f} s {spent} -> "
        f"{_build.build_dir()}")
    build_reports(_build)

    rows = kernel_checks(torch, pa, fa, _build.KERNELS)
    chunked_equals_whole(torch, pa, fa)
    for sfx, H, K, d in HEAD_DIM_SHAPES:
        rows.update(kernel_checks(torch, pa, fa, _build.KERNELS, H, K, d, sfx,
                                  seed=1234 + d))
    rows.update(qmm_checks(torch, qm, _build.KERNELS))
    rows.update(backward_checks(torch, fa, _build.KERNELS))
    probe_rows, probed, _ = probe_checks(torch, pa, _build.KERNELS,
                                         _build.reset_counts)
    rows.update(probe_rows)
    served, bf16_logits = serve(torch, pa, fa, _build.KERNELS,
                                _build.reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    trained = train(torch, fa, _build.KERNELS, _build.reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    quant = serve_quant(torch, pa, qm, _build.KERNELS, _build.reset_counts,
                        bf16_logits)
    gc.collect()
    torch.cuda.empty_cache()
    dense = serve_dense(torch, pa, _build.KERNELS, _build.reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    head = head_dims(torch, pa, fa, _build.KERNELS, _build.reset_counts)

    def entry(r):
        e = {"max_abs_err": r["err"], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
             "bound_by": r["bound"][1], "library_ms": r["library_ms"],
             "wrapper_ms": r["wrapper_ms"], "shape": r["shape"]}
        if "library" in r:
            e["library"] = r["library"]
        if "tiles" in r:
            e["worst_tile_rel"] = {t: x[2] for t, x in r["tiles"].items()}
            e["tile_rel_gate"] = BWD_REL
        if "grad_err" in r:
            e["grad_max_abs_err"] = r["grad_err"]
        if "splits" in r:
            e["splits"] = r["splits"]
        if "loop_ms" in r:                   # A-C, G/H at B <= 16, I at
                                             # t=1: a CUDA graph
            e["loop_ms"] = r["loop_ms"]
        if "launches_per_call" in r:         # G/H at B <= 16, I
            e["launches_per_call"] = r["launches_per_call"]
        if "turns" in r:
            e["turns_ms"] = dict(zip(("library", "kernel", "kernel_again",
                                      "library_again"), r["turns"]))
        if "e_plus_f" in r:                  # E then F vs SDPA's backward
            e["e_plus_f"] = r["e_plus_f"]
        return e

    kernels = []
    for name, k in _build.KERNELS.items():
        by_phase = {p: c[name] for p, c in (("kernels", probed),
                                             ("serve", served),
                                             ("train", trained),
                                             ("serve_quant", quant),
                                             ("serve_dense", dense),
                                             ("head_dims", head))
                    if c.get(name)}
        e = {"name": name, "route": "cuda", "source": k.source,
             "replaces": k.replaces, "launches": sum(by_phase.values()),
             "launches_by_phase": by_phase}
        variants = [k for k in rows if k.startswith(f"{name}/int")]
        if name in rows:                     # A-D, I-K, A/B's int modes
            e.update(entry(rows[name]))
            if f"{name}/train" in rows:
                e["at_train_shape"] = entry(rows[f"{name}/train"])
            more = {r.split("/", 1)[1]: entry(rows[r]) for r in rows
                    if r.startswith(f"{name}/") and r != f"{name}/train"}
            if more:                         # I at t=1, J's other shapes
                e["variants"] = more
        elif variants:                       # G, H: int4 (at B=6) first
            e.update(entry(rows[variants[0]]))
            e["variants"] = {k.split("/", 1)[1]: entry(rows[k])
                             for k in variants[1:]}
        else:                                # E, F: training shape, d=128
            e.update(entry(rows[f"{name}/train"]))   # then d=96 and d=256
            e["library"] = rows[f"{name}/train"]["library"]
            for tag in ("d128", "d96", "d256"):
                e[f"at_{tag}"] = entry(rows[f"{name}/{tag}"])
        kernels.append(e)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
