#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):

1. device  -- require CUDA; print the card's name and power limit;
2. build   -- compile the port's CUDA kernels from ``deepspeed_tpu_torch/
              csrc`` (one ``nvcc`` per source, in parallel), timed;
3. kernels -- kernels A-D at the serving path's Llama-3-8B shapes (H=32,
              K=8, d=128, block 128) on seeded random bf16 inputs, each held
              against its plain PyTorch version (atol = rtol = 2e-2 on
              normalised outputs, 1e-2 on m / lse) and timed: the kernel
              alone (its launcher on arguments prepared once), the whole
              wrapper, its plain version, its bound and, for D, SDPA;
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
              a whole-prompt ``put`` of it (relative L2 <= 2e-2, bf16).

The last two lines of standard output are the ``kernels`` JSON line and the
result line ``{"ok": true, "device": {...}}``; the card's name and power
limit are printed before them. Imports neither JAX nor ``deepspeed_tpu``.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
ATOL = RTOL = 2e-2             # normalised outputs, bf16 inputs
STAT_TOL = 1e-2                # m / lse
CROSS_PATH_REL_L2 = 2e-2       # chunked vs whole-prompt last-token logits


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


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
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


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def make_pool(torch, g, L, nbp1, bs, KD, dev):
    return (torch.randn(L, nbp1, bs, KD, generator=g, device=dev)
            .to(torch.bfloat16))


def timings(kernel, args, wrapper, plain) -> dict:
    """``ms``: the kernel alone -- its launcher on arguments prepared once
    (CUDA events see only the card's time while launches queue faster than
    the kernel runs); ``wrapper_ms``: the whole wrapper (operand checks,
    metadata, allocation, launch); ``plain_ms``: the plain version."""
    return dict(ms=time_ms(lambda: kernel.launch(*args)),
                wrapper_ms=time_ms(wrapper),
                plain_ms=time_ms(plain, iters=5))


def kernel_checks(torch, pa, fa, KERNELS):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    H, K, d, bs = 32, 8, 128, 128
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
    args, _ = pa.decode_kernel_args(q, kpool, vpool, layer, bt, slot, pos0)
    rows["paged_decode"] = dict(
        err=err, bound=bound(nbytes, flops), library_ms=None,
        **timings(KERNELS["paged_decode"], args,
                  lambda: pa.decode_pool_partials(q, kpool, vpool, layer, bt,
                                                  slot, pos0),
                  lambda: pa.plain_decode_partials(q, kpool, vpool, layer, bt,
                                                   slot, pos0)),
        shape="A=8 atoms, H=32 K=8 d=128 bs=128, pos0 "
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
    cols = int(pos0b.sum())
    nbytes = (cols * KD * 2 * 2 + qb.numel() * 2 + accb.numel() * 4
              + 2 * mb.numel() * 4)
    flops = 4 * tq * H * d * cols
    args, _ = pa.past_kernel_args(qb, kpool, vpool, layer, bt, slotb, pos0b,
                                  tq)
    rows["paged_past"] = dict(
        err=err, bound=bound(nbytes, flops), library_ms=None,
        **timings(KERNELS["paged_past"], args,
                  lambda: pa.past_partials(qb, kpool, vpool, layer, bt,
                                           slotb, pos0b, tq),
                  lambda: pa.plain_past_partials(qb, kpool, vpool, layer, bt,
                                                 slotb, pos0b, tq)),
        shape="2 atoms x tq=256, H=32 K=8 d=128 bs=128, pos0 256,768")

    # ---- C: the same atoms' self flash, seeded from B's (plain) partials
    alen = torch.tensor([256, 200], dtype=torch.int32, device=dev)
    ks = torch.randn(2 * tq, K, d, generator=g, device=dev).to(torch.bfloat16)
    vs = torch.randn(2 * tq, K, d, generator=g, device=dev).to(torch.bfloat16)
    seed = (paccb, pmb, plb)
    outc = pa.self_attention(qb, ks, vs, alen, tq, seed)
    poutc = pa.plain_self_attention(qb, ks, vs, alen, tq, seed)
    err = close("C out", outc, poutc, ATOL, RTOL)
    pairs = sum(n * (n + 1) // 2 for n in alen.tolist())
    nbytes = ((qb.numel() + ks.numel() + vs.numel() + outc.numel()) * 2
              + (paccb.numel() + 2 * pmb.numel()) * 4)
    flops = 4 * H * d * pairs
    args, _ = pa.self_kernel_args(qb, ks, vs, alen, tq, seed)
    rows["chunk_self"] = dict(
        err=err, bound=bound(nbytes, flops), library_ms=None,
        **timings(KERNELS["chunk_self"], args,
                  lambda: pa.self_attention(qb, ks, vs, alen, tq, seed),
                  lambda: pa.plain_self_attention(qb, ks, vs, alen, tq,
                                                  seed)),
        shape="2 atoms x tq=256 (alen 256,200), H=32 K=8 d=128, seeded")

    # ---- D: whole-prompt prefill of 4 prompts padded to T=1024
    B, T = 4, 1024
    qd = torch.randn(B, T, H, d, generator=g, device=dev).to(torch.bfloat16)
    kd = torch.randn(B, T, K, d, generator=g, device=dev).to(torch.bfloat16)
    vd = torch.randn(B, T, K, d, generator=g, device=dev).to(torch.bfloat16)
    outd, lse = fa.flash_attention_lse(qd, kd, vd, causal=True)
    poutd, plse = fa.plain_flash_forward(qd, kd, vd, causal=True)
    err = close("D out", outd, poutd, ATOL, RTOL)
    close("D lse", lse, plse, STAT_TOL, STAT_TOL)
    nbytes = ((qd.numel() + kd.numel() + vd.numel() + outd.numel()) * 2
              + lse.numel() * 4)
    flops = 4 * B * H * d * (T * (T + 1) // 2)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qd, kd, vd))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    args, _ = fa.flash_kernel_args(qd, kd, vd, causal=True)
    rows["flash_fwd"] = dict(
        err=err, bound=bound(nbytes, flops), library_ms=lib,
        **timings(KERNELS["flash_fwd"], args,
                  lambda: fa.flash_attention_lse(qd, kd, vd, causal=True),
                  lambda: fa.plain_flash_forward(qd, kd, vd, causal=True)),
        shape="B=4 T=S=1024 H=32 K=8 d=128, causal")
    torch.cuda.synchronize()
    for name, r in rows.items():
        log(f"kernel {name}: max_abs_err {r['err']:.3e}, kernel "
            f"{r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
            f"{r['bound'][1]}, library {r['library_ms']}) [{r['shape']}]")
    return rows


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
        self.targets = {
            "paged_decode": (pa, "decode_pool_partials",
                             pa.plain_decode_partials),
            "paged_past": (pa, "past_partials", pa.plain_past_partials),
            "chunk_self": (pa, "self_attention", pa.plain_self_attention),
            "flash_fwd": (fa, "flash_attention_lse", fa.plain_flash_forward),
        }

    def __enter__(self):
        for name, (mod, attr, _) in self.targets.items():
            setattr(mod, attr, self._wrap(name, getattr(mod, attr)))
        return self

    def __exit__(self, *exc):
        for mod, attr, _ in self.targets.values():
            setattr(mod, attr, getattr(mod, attr).__wrapped__)

    def _wanted(self, name, x) -> bool:
        if (name, self.stage) in self.captured:
            return False
        if self.stage == "decode_batch":
            return (x["row_pos"] is not None
                    and bool((x["row_pos"] != x["atom_pos0"]).any()))
        return True

    def _wrap(self, name, fn):
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
            if self._wanted(name, x):
                if "k_pool" in x:
                    i = x["layer"]
                    x["k_pool"] = x["k_pool"][i:i + 1]
                    x["v_pool"] = x["v_pool"][i:i + 1]
                    x["layer"] = 0
                outs = out if isinstance(out, tuple) else (out,)
                self.captured[(name, self.stage)] = (
                    {k: clone(v) for k, v in x.items()}, clone(outs))
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    def check(self):
        missing = self.REQUIRED - set(self.captured)
        if missing:
            raise AssertionError(f"serve phase: no launch captured for "
                                 f"{sorted(missing)}")
        errs = {}
        for (name, stage), (x, out) in sorted(self.captured.items()):
            plain = self.targets[name][2]
            ref = plain(**x)
            tag = f"replay {name} ({stage})"
            if name in ("paged_decode", "paged_past"):
                live = ref[2] > 0
                errs[f"{name}/{stage}"] = close(
                    tag, normalised(out[0], out[2])[live],
                    normalised(ref[0], ref[2])[live], ATOL, RTOL)
                close(f"{tag} m", out[1][live], ref[1][live], STAT_TOL,
                      STAT_TOL)
            elif name == "chunk_self":
                errs[f"{name}/{stage}"] = close(tag, out[0], ref, ATOL, RTOL)
            else:
                errs[f"{name}/{stage}"] = close(tag, out[0], ref[0], ATOL,
                                                RTOL)
                close(f"{tag} lse", out[1], ref[1], STAT_TOL, STAT_TOL)
        return errs


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
    rng = np.random.default_rng(0)
    V = cfg.vocab_size

    def prompt(n):
        return rng.integers(1, V, n).astype(np.int32)

    def finite(out):
        for uid, lg in out.items():
            if not np.all(np.isfinite(lg)) or lg.shape != (V,):
                raise AssertionError(f"uid {uid}: logits not finite / shape "
                                     f"{lg.shape}")

    firsts = [prompt(n) for n in (37, 128, 129, 700)]
    fresh = [prompt(300), prompt(1100)]
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
    counts = {name: k.launches for name, k in KERNELS.items()}
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
    return counts


def main() -> int:
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

    card = card_line()
    log(f"device: {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")

    t = time.perf_counter()
    spent = _build.build_all()
    log(f"build: {time.perf_counter() - t:.1f} s {spent} -> "
        f"{_build.build_dir()}")

    rows = kernel_checks(torch, pa, fa, _build.KERNELS)
    counts = serve(torch, pa, fa, _build.KERNELS, _build.reset_counts)

    kernels = []
    for name, k in _build.KERNELS.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": counts[name],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "wrapper_ms": r["wrapper_ms"],
            "shape": r["shape"]})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
