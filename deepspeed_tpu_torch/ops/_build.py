"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers: a source builds in seconds, not minutes). Libraries are
built at first use from the package's own sources, all missing ones at once
in parallel, into ``build/deepspeed_tpu_torch/`` at the root of the checkout,
named by a hash of the sources and flags so an edited source rebuilds.
``ctypes`` and ``subprocess`` are imported lazily: importing this module on a
CPU-only machine does nothing.

Every kernel of the serving path has a :class:`Kernel` record in
:data:`KERNELS`. :meth:`Kernel.launch` is the one place a kernel is launched:
it calls the launcher, raises on a non-zero return code and adds one to
``launches``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from pathlib import Path
from typing import Dict

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = {"paged_attention": "paged_attention.cu",
            "flash_attention": "flash_attention.cu"}
_HEADERS = ("flash_tile.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, object] = {}


class Kernel:
    """One hand-written kernel: its launcher ``dst_<name>`` in
    ``csrc/<lib>.cu``, the TPU kernel it replaces, and its launch count."""

    __slots__ = ("name", "lib", "source", "replaces", "launches")

    def __init__(self, name: str, lib: str, replaces: str):
        self.name = name
        self.lib = lib
        self.source = f"deepspeed_tpu_torch/csrc/{_SOURCES[lib]}"
        self.replaces = replaces
        self.launches = 0

    def launch(self, *args) -> None:
        """Call the launcher with ``args`` in its C order (a tensor stands
        for its data pointer), raise when it returns a non-zero
        ``cudaError_t`` -- a refused launch never runs, and no later
        synchronise would report it -- and count the launch."""
        fn = getattr(library(self.lib), f"dst_{self.name}")
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args))
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with "
                               f"cudaError_t {rc}")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    Kernel("paged_decode", "paged_attention",
           "deepspeed_tpu/ops/paged_attention.py:420"),
    Kernel("paged_past", "paged_attention",
           "deepspeed_tpu/ops/paged_attention.py:782"),
    Kernel("chunk_self", "flash_attention",
           "deepspeed_tpu/ops/paged_attention.py:891"),
    Kernel("flash_fwd", "flash_attention",
           "deepspeed_tpu/ops/flash_attention.py:66"),
)}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def build_dir() -> Path:
    return _CSRC.parent.parent / "build" / "deepspeed_tpu_torch"


def _nvcc() -> str:
    import shutil

    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                           "port's CUDA kernels are built on the machine with "
                           "the card")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in (_SOURCES[name],) + _HEADERS:
        h.update((_CSRC / fn).read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all at once.
    Returns seconds spent per library built now (empty when all cached).
    Raises with the compiler's output when a build fails."""
    import subprocess

    with _lock:
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        todo = {n: _lib_path(n) for n in _SOURCES if not _lib_path(n).exists()}
        procs = {}
        t0 = time.perf_counter()
        nvcc = _nvcc()
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
                   str(_CSRC / _SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, path)
        spent: Dict[str, float] = {}
        failed = []
        for name, (proc, tmp, path) in procs.items():
            log, _ = proc.communicate()
            spent[name] = time.perf_counter() - t0
            (out_dir / f"{name}.build.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return spent


def library(name: str):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu`` (built if needed),
    with argument types declared for every exported launcher."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    import ctypes

    path = _lib_path(name)
    if not path.exists():
        build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _declare(lib, name)
            _libs[name] = lib
    return lib


def _declare(lib, name: str) -> None:
    import ctypes

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "paged_attention": {
            # q kpool vpool layer nbp1 bs H K hd bt nb_max slot pos0 rowpos
            # lo nblk A window scale acc m l stream
            "dst_paged_decode": [P, P, P, I, I, I, I, I, I, P, I, P, P, P, P,
                                 P, I, I, F, P, P, P, P],
            # q kpool vpool layer nbp1 bs H K hd bt nb_max slot pos0 lo nblk
            # A tq window scale acc m l stream
            "dst_paged_past": [P, P, P, I, I, I, I, I, I, P, I, P, P, P, P,
                               I, I, I, F, P, P, P, P],
        },
        "flash_attention": {
            # q ks vs alen m0 l0 a0 out A tq H K hd window scale stream
            "dst_chunk_self": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, F,
                               P],
            # q k v out lse B T S H K hd causal window rel scale stream
            "dst_flash_fwd": [P, P, P, P, P, I, I, I, I, I, I, I, I, I, F,
                              P],
        },
    }[name]
    for fn, args in sigs.items():
        f = getattr(lib, fn)
        f.argtypes = args
        f.restype = ctypes.c_int
