"""Where a training step's time goes on the card: ``torch.profiler`` over
one warm ``train_batch`` step of the train configuration below.

    python -m deepspeed_tpu_torch.tools.train_profile \
        [--remat-policy POLICY] [--optimizer NAME] [--lr LR]

The configuration is the one ``chip_smoke.py``'s train phase drives, and
both read it from here: ``llama3-1b`` at full width and depth
(``max_seq_len`` ``TRAIN_SEQ``), random fp32 master weights from seed 0,
bf16 compute, ``TRAIN_CONFIG`` (micro-batch 4, GA 2, AdamW with clipping)
and one fixed numpy-seeded micro-batch (``fixed_batch``). ``--remat-policy``
(any name of ``runtime/activation_checkpointing.py`` ``POLICIES``) and
``--optimizer`` (with ``--lr``; weight decay and clipping are kept) replace
the configuration's ``none`` and AdamW.

Prints the wall time per step (profiler on, so above an unprofiled run),
the device time the profiler recorded (sum of CUDA kernel durations, one
stream), the device's idle share of the wall time, the number of kernel
launches, the top kernels by device time and the share of the attention
kernels D, E and F; then the card's name and power limit. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from deepspeed_tpu_torch.tools.serve_profile import (_device_events,
                                                     print_card,
                                                     profile_phase)

TRAIN_PRESET = "llama3-1b"
TRAIN_SEQ = 2048
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 4,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4,
                                              "weight_decay": 0.1}},
    "gradient_clipping": 1.0,
    "steps_per_print": 1000,
    "seed": 0,
}

# kernel-name fragments of the port's attention kernels in profiler rows
ATTENTION_KERNELS = {"D": "flash_fwd_kernel", "E": "flash_bwd_dq_kernel",
                     "F": "flash_bwd_dkv_kernel"}


def train_model_config():
    """The model configuration: ``TRAIN_PRESET`` at ``TRAIN_SEQ``."""
    from deepspeed_tpu_torch import get_preset

    return get_preset(TRAIN_PRESET, max_seq_len=TRAIN_SEQ)


def fixed_batch(vocab_size: int) -> dict:
    """The one micro-batch every step trains on: ``input_ids`` [micro,
    TRAIN_SEQ] int32 from numpy seed 0."""
    rng = np.random.default_rng(0)
    micro = TRAIN_CONFIG["train_micro_batch_size_per_gpu"]
    return {"input_ids": rng.integers(0, vocab_size, (micro, TRAIN_SEQ))
            .astype(np.int32)}


def train_config(remat_policy: str = "none", optimizer: str = None,
                 lr: float = None) -> dict:
    """``TRAIN_CONFIG`` with another remat policy and/or optimizer (its
    ``params`` keep the weight decay; ``lr`` replaces the learning rate)."""
    config = {**TRAIN_CONFIG,
              "activation_checkpointing": {"policy": remat_policy}}
    opt = TRAIN_CONFIG["optimizer"]
    params = dict(opt["params"], **({"lr": lr} if lr is not None else {}))
    config["optimizer"] = {"type": optimizer or opt["type"],
                           "params": params}
    return config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--remat-policy", default="none")
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--lr", type=float, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_profile needs a CUDA card")
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch import TransformerLM

    cfg = train_model_config()
    config = train_config(args.remat_policy, args.optimizer, args.lr)
    eng, *_ = tds.initialize(TransformerLM(cfg), config)
    batch = fixed_batch(cfg.vocab_size)
    prof = profile_phase(
        f"train_batch {TRAIN_PRESET} L={cfg.num_layers} "
        f"{TRAIN_CONFIG['train_micro_batch_size_per_gpu']}x{TRAIN_SEQ} "
        f"ga={TRAIN_CONFIG['gradient_accumulation_steps']} "
        f"remat={args.remat_policy} opt={config['optimizer']['type']}",
        lambda: eng.train_batch(itertools.repeat(batch)), 1)
    rows = _device_events(prof)
    total = sum(r[1] for r in rows)
    for tag, frag in ATTENTION_KERNELS.items():
        us = sum(r[1] for r in rows if frag in r[0])
        n = sum(r[2] for r in rows if frag in r[0])
        print(f"[attention] kernel {tag}: {us / 1e3:.3f} ms/step "
              f"({us / max(total, 1e-9):.3f} of device time), {n} "
              f"launches/step", flush=True)
    print_card()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
