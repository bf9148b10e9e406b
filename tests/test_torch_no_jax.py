"""The PyTorch port stands alone: no module of ``deepspeed_tpu_torch`` and no
line of ``chip_smoke.py`` imports JAX or the JAX package, statically or at
run time."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu")


def _port_files():
    files = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import deepspeed_tpu_torch, deepspeed_tpu_torch.bridge\n"
        "import deepspeed_tpu_torch.ops.flash_attention\n"
        "import deepspeed_tpu_torch.ops.paged_attention\n"
        "import deepspeed_tpu_torch.ops.quant_matmul\n"
        "import deepspeed_tpu_torch.ops.rms_norm\n"
        "import deepspeed_tpu_torch.inference.quant\n"
        "import deepspeed_tpu_torch.inference.engine\n"
        "import deepspeed_tpu_torch.tools.hbm_bandwidth\n"
        "import deepspeed_tpu_torch.config, deepspeed_tpu_torch.runtime\n"
        "import deepspeed_tpu_torch.runtime.engine\n"
        "import deepspeed_tpu_torch.tools.train_profile\n"
        "import deepspeed_tpu_torch.tools.serve_profile\n"
        "import deepspeed_tpu_torch.tools.qmm_sweep\n"
        "import deepspeed_tpu_torch.tools.flash_bwd_time\n"
        "import deepspeed_tpu_torch.tools.launch_count\n"
        "import chip_smoke\n"
        "new = set(sys.modules) - before\n"
        f"bad = sorted(m for m in new if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN!r}))\n"
        "assert not bad, bad\n")
    path = [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)
