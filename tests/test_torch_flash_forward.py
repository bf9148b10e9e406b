"""Kernel D's plain version and its build record.

``plain_flash_forward`` is what the card's kernel D
(``csrc/flash_forward.cu``) is held against, so it is held here against the
JAX package's ``flash_attention_lse`` in interpret mode (fp32 on the CPU,
atol = rtol = 1e-5) on the shapes where the kernel's tiling has edges: T
smaller than one 64-row tile of queries, T not a multiple of it, S != T
without a causal mask, a positive ``rel_offset``, and a negative one under a window
whose first rows see nothing. Where nothing is visible the Pallas kernel
computes p = exp(-1e30 + 1e30) = 1 and returns the mean of the columns it
walked, the port zeros: ``out`` is compared on the rows that see something,
``lse`` on every row (both give -1e30 in fp32 there). The card tests are in
``test_torch_kernels_cuda.py``."""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=1e-5, rtol=1e-5)
ROOT = Path(__file__).resolve().parent.parent

# B, T, S, H, K, d, causal, window, rel_offset
CASES = [
    (1, 37, 37, 4, 2, 16, True, None, 0),       # T below one 64-row tile
    (1, 40, 40, 2, 1, 128, True, None, 0),      # d = 128
    (2, 333, 333, 4, 1, 16, True, None, 0),     # T % 64 != 0
    (1, 150, 150, 4, 2, 64, True, 64, 0),       # window, d = 64
    (1, 20, 33, 4, 2, 16, False, None, 0),      # S != T, no causal mask
    (1, 100, 130, 2, 2, 64, False, None, 0),
    (1, 64, 128, 4, 2, 16, True, None, 64),     # rel_offset > 0
    (1, 70, 70, 4, 2, 16, True, 50, -20),       # the first 20 rows see nothing
]
IDS = [f"B{c[0]}T{c[1]}S{c[2]}H{c[3]}K{c[4]}d{c[5]}-{'c' if c[6] else 'nc'}"
       f"-w{c[7]}-r{c[8]}" for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_matches_pallas_on_edge_shapes(case):
    B, T, S, H, K, d, causal, window, rel = case
    rng = np.random.default_rng(T * 7 + S + d)
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, K, d)).astype(np.float32)
    v = rng.standard_normal((B, S, K, d)).astype(np.float32)
    o_j, lse_j = jfa.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, rel_offset=rel, interpret=True)
    o_t, lse_t = tfa.plain_flash_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, rel_offset=rel)
    sees = tfa._keep(T, S, causal, window, rel, "cpu").any(dim=1).numpy()
    assert sees.any()
    np.testing.assert_allclose(o_t.numpy()[:, sees], np.asarray(o_j)[:, sees],
                               **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], **TOL)
    if not sees.all():                 # the port's contract where blind
        assert float(o_t[:, ~torch.from_numpy(sees)].abs().max()) == 0.0
        assert np.all(lse_t.numpy()[:, :, ~sees] == np.float32(-1e30))


def test_kernel_d_record_names_the_new_source():
    rec = _build.KERNELS["flash_fwd"]
    assert rec.lib == "flash_forward"
    assert rec.source == "deepspeed_tpu_torch/csrc/flash_forward.cu"
    assert (ROOT / rec.source).is_file()
    assert rec.replaces == "deepspeed_tpu/ops/flash_attention.py:66"
    path, line = rec.replaces.split(":")
    src = (ROOT / path).read_text().splitlines()
    assert src[int(line) - 1].startswith("def _fwd_kernel(")
    chunk = _build.KERNELS["chunk_self"]
    assert chunk.lib == "flash_attention"
    assert chunk.source == "deepspeed_tpu_torch/csrc/flash_attention.cu"


class _FakeLib:
    """Records which launchers ``_declare`` gives argument types."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, types.SimpleNamespace())


def _declared(lib: str):
    fake = _FakeLib()
    _build._declare(fake, lib)
    return fake.fns


def test_declare_puts_kernel_d_on_its_own_library():
    assert set(_declared("flash_forward")) == {"dst_flash_fwd"}
    assert set(_declared("flash_attention")) == {"dst_chunk_self"}
    fwd = _declared("flash_forward")["dst_flash_fwd"]
    assert len(fwd.argtypes) == 16        # the launcher's C signature
    for lib in _build._SOURCES:           # every launcher is declared
        names = {f"dst_{k.name}" for k in _build.KERNELS.values()
                 if k.lib == lib}
        assert names <= set(_declared(lib)), lib


def test_kernel_d_source_keeps_s_p_o_in_registers():
    """No wmma (whose fragments go through shared memory for S and O):
    mma.sync on ldmatrix fragments, K/V through a cp.async ring, zero-fill
    of rows past the range by the copy's src-size."""
    code = source_code("flash_forward.cu")
    assert "wmma" not in code and "mma.h" not in code
    assert "flash_tile.cuh" not in code
    for needle in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "ldmatrix.sync.aligned.m8n8.x4.shared.b16",
                   "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                   "cp.async.cg.shared.global", "cp.async.wait_group"):
        assert needle in code, needle


def source_code(name: str) -> str:
    """``csrc/<name>`` without comments, each ``#include "<header>"`` of the
    package's own headers followed by that header's code."""
    csrc = ROOT / "deepspeed_tpu_torch/csrc"
    lines = []
    for line in (csrc / name).read_text().splitlines():
        code = line.split("//")[0]
        lines.append(code)
        m = re.match(r'\s*#include "([^"]+)"', code)
        if m:
            lines.append(source_code(m.group(1)))
    return "\n".join(lines)


def test_every_included_header_is_hashed_into_the_library_name():
    """A library is rebuilt when its name's hash changes: every header a
    source includes from ``csrc`` must be among the hashed files."""
    csrc = ROOT / "deepspeed_tpu_torch/csrc"
    for path in sorted(csrc.glob("*.cu*")):
        for inc in re.findall(r'#include "([^"]+)"', path.read_text()):
            assert inc in _build._HEADERS, (path.name, inc)


def test_ptxas_report_reads_kernel_d_instantiations():
    """chip_smoke prints kernel D's registers and spill bytes from its build
    log through this parser; the log below is synthetic, in ptxas's own
    format, with another kernel between D's two instantiations."""
    d128 = "_ZN3dst16flash_fwd_kernelILi128EEEvNS_7FwdArgsE"
    d64 = "_ZN3dst16flash_fwd_kernelILi64EEEvNS_7FwdArgsE"
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{d128}' for 'sm_90a'",
        f"ptxas info    : Function properties for {d128}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 254 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 32 registers",
        f"ptxas info    : Compiling entry function '{d64}' for 'sm_90a'",
        f"ptxas info    : Function properties for {d64}",
        "    48 bytes stack frame, 44 bytes spill stores, 48 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
    ])
    assert _build.ptxas_report(log) == {
        d128: dict(stack=0, spill_stores=0, spill_loads=0, registers=254),
        "_Z5otherv": dict(stack=8, spill_stores=8, spill_loads=8,
                          registers=32),
        d64: dict(stack=48, spill_stores=44, spill_loads=48, registers=128)}


def test_build_log_is_named_by_its_library_hash():
    """The log chip_smoke reads is the one written by the build of the
    library it loads: an edited source gets another hash, hence another
    log, and a cached library never reads a later build's log."""
    for name in _build._SOURCES:
        lib, log = _build._lib_path(name), _build.build_log(name)
        assert log.parent == lib.parent
        assert log.name == lib.name[:-len(".so")] + ".build.log"
