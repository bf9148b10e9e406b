"""Phase 3's kernel rows of a parent tree and of this one, in turns on one
card, and whether their A, D, E, F and I kernels and G/H's multi-row kernel
compiled to the same SASS.

    python -m deepspeed_tpu_torch.tools.parent_turns build/parent

The parent is a checkout unpacked with ``git archive`` into a directory
that ``.gitignore`` lists. Each reading runs in a process of its own from
its tree -- that tree's ``chip_smoke.py`` ``backward_checks`` (D, E and F at
their default shapes), and this tree's ``kernel_checks`` (A-D and A/B's
int modes at llama3-8b's heads, d = 128, and at d = 64, 96 and 256: B in
each pool mode and C at every card head dim), ``qmm_checks`` (G/H at every
row of phase 3) and ``tile_checks`` (I's t = 1 and t = 700 rows at every
head dim), so both trees are timed at the same rows by the same code, and
its package, whose libraries build from its sources -- in the order
parent, this, this, parent. Prints each row's four kernel ms and the ratio
of the means (this / parent), with the launches on the card a call
(profiler count) of B, C, G/H at B <= 16 and I in each tree; then, for
each instantiation of kernels A, D, E, F and I and each of
``qmm_tile_kernel<4/8>``, whether ``cuobjdump -sass`` of the two builds is
identical (instruction offsets and the padding of lines aside; a function
of one build only is named so); the card's name and power limit come last.
Needs a CUDA card and the toolkit's ``cuobjdump``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]
# library: the functions whose SASS is compared
CARD_DIMS = r"Li(64|96|128|256)E"
SASS = {"paged_decode": CARD_DIMS, "flash_forward": CARD_DIMS,
        "flash_backward": CARD_DIMS, "paged_tile": CARD_DIMS,
        "quant_matmul": r"qmm_tile_kernel"}
# kernel_checks' shapes beside its default (llama3-8b's heads, d = 128):
# (row suffix, H, K, d)
SHAPES = (("/d64", 32, 8, 64), ("/d96", 32, 32, 96), ("/d256", 8, 8, 256))


def rows(root: str) -> dict:
    """Run in the tree ``root``: its phase-3 rows (kernel ms, and the
    launches a call of B, C, G/H at B <= 16 and I) and the paths of its
    libraries."""
    import importlib.util

    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    spec = importlib.util.spec_from_file_location("chip_smoke_this",
                                                  THIS / "chip_smoke.py")
    this = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(this)
    _build.build_all()
    got = this.kernel_checks(torch, pa, fa, _build.KERNELS, one_launch=False)
    for sfx, H, K, d in SHAPES:
        got.update(this.kernel_checks(torch, pa, fa, _build.KERNELS, H, K, d,
                                      sfx, seed=1234 + d, one_launch=False))
    got.update(chip_smoke.backward_checks(torch, fa, _build.KERNELS))
    got.update(this.tile_checks(torch, pa, _build.KERNELS))
    for sfx, H, K, d in this.HEAD_DIM_SHAPES:
        got.update(this.tile_checks(torch, pa, _build.KERNELS, H, K, d, sfx,
                                    seed=9012 + d))
    got.update(this.qmm_checks(torch, qm, _build.KERNELS, one_launch=False))
    return {"ms": {k: r["ms"] for k, r in got.items()},
            "launches": {k: r["launches_per_call"] for k, r in got.items()
                         if "launches_per_call" in r},
            "libs": {n: str(_build._lib_path(n)) for n in SASS}}


def reading(root: Path) -> dict:
    out = subprocess.run([sys.executable, __file__, "--rows", str(root)],
                         capture_output=True, text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def sass(path: str) -> dict:
    """Each function's SASS in a library: its instructions and their
    encodings, without the offsets, each run of blanks one space
    (``cuobjdump`` pads every line to the longest instruction of the
    library)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    return {name: re.sub(r"[ \t]+", " ",
                         re.sub(r"/\*[0-9a-f]{4}\*/", "", body)).strip()
            for name, body in zip(parts[1::2], parts[2::2])}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--rows":
        print(json.dumps(rows(sys.argv[2])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("parent_turns needs a CUDA card")
    parent = Path(sys.argv[1]).resolve()
    order = (parent, THIS, THIS, parent)
    got = [reading(root) for root in order]
    for name in got[0]["ms"]:
        ms = [g["ms"][name] for g in got]
        ratio = (ms[1] + ms[2]) / (ms[0] + ms[3])
        calls = (f"; launches a call: parent {got[0]['launches'][name]}, "
                 f"this {got[1]['launches'][name]}"
                 if name in got[0]["launches"] else "")
        print(f"row {name}: parent {ms[0]:.4f} {ms[3]:.4f}, this {ms[1]:.4f} "
              f"{ms[2]:.4f} ms; this / parent {ratio:.3f}{calls}")
    for lib, pattern in SASS.items():
        old, new = sass(got[0]["libs"][lib]), sass(got[1]["libs"][lib])
        for fn in sorted(f for f in {**old, **new} if re.search(pattern, f)):
            if fn not in new or fn not in old:
                state = f"only in {'parent' if fn in old else 'this tree'}"
            else:
                state = "identical" if new[fn] == old[fn] else "differs"
            print(f"sass {lib} {fn}: {state}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
