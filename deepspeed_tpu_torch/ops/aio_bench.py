"""NVMe/AIO perf sweep CLI + autotuner (counterpart of
``deepspeed_tpu/ops/aio_bench.py``), over the port's
:class:`~deepspeed_tpu_torch.offload.swap.AsyncTensorSwapper` and the
repo's ``csrc/aio.cpp``.

Parity target: DeepSpeed's DeepNVMe perf tools
(``deepspeed/nvme/perf_run_sweep.py`` / ``ds_io`` benchmarks): sweep IO size ×
thread count × chunk size over the native aio layer and report read/write
bandwidth. :func:`autotune_config` is the closed loop — a short sweep (cached
per swap-dir device) whose winner the swapper adopts automatically when
``offload.aio.autotune`` is on.

Usage:
    python -m deepspeed_tpu_torch.ops.aio_bench --path /tmp/aio --sizes 1,8,64 \
        --threads 1,2,4 --chunks 0,4,16 --json
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import List, Optional

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


def sweep(path: str, sizes_mb: List[int], threads: List[int],
          repeats: int = 3, o_direct: bool = True,
          chunks_mb: Optional[List[int]] = None) -> List[dict]:
    """``o_direct=True`` (default) bypasses the page cache so the numbers
    reflect the DEVICE, not memcpy (the reference ds_io does the same; the
    native layer falls back to buffered IO on filesystems without O_DIRECT
    support, e.g. tmpfs — pass --buffered to measure the cached path).
    ``chunks_mb`` entries are per-op IO sizes (0 = whole tensor in one op);
    chunking lets a single large tensor spread across the threadpool."""
    from deepspeed_tpu_torch.offload.swap import AsyncTensorSwapper

    results = []
    for size_mb in sizes_mb:
        arr = np.random.default_rng(0).random(size_mb * (1 << 20) // 8)
        arr = arr.astype(np.float64)
        for nt in threads:
            for chunk in (chunks_mb or [0]):
                eff_chunk = chunk if chunk > 0 else size_mb
                d = os.path.join(path, f"s{size_mb}t{nt}c{chunk}")
                os.makedirs(d, exist_ok=True)
                sw = AsyncTensorSwapper(d, num_threads=nt, o_direct=o_direct,
                                        chunk_mb=eff_chunk)
                try:
                    # write bandwidth (repeats files in flight → overlap)
                    t0 = time.perf_counter()
                    for r in range(repeats):
                        sw.swap_out(f"w{r}", arr)
                    sw.wait()
                    wt = time.perf_counter() - t0
                    # read bandwidth
                    t0 = time.perf_counter()
                    tickets = [sw.swap_in_start(f"w{r}")
                               for r in range(repeats)]
                    for t in tickets:
                        t.wait()
                    rt = time.perf_counter() - t0
                    for t in tickets:
                        t.release()
                finally:
                    sw.close()
                    shutil.rmtree(d, ignore_errors=True)
                total_mb = size_mb * repeats
                results.append({"size_mb": size_mb, "threads": nt,
                                "chunk_mb": eff_chunk, "o_direct": o_direct,
                                "write_MBps": round(total_mb / wt, 1),
                                "read_MBps": round(total_mb / rt, 1)})
    return results


# ---------------------------------------------------------------------------
# self-tuning swap configuration
# ---------------------------------------------------------------------------

_DEFAULT_CACHE = os.path.join(tempfile.gettempdir(), "dstpu_aio_autotune.json")


def autotune_config(swap_dir: str, cache_path: Optional[str] = None,
                    force: bool = False, o_direct: bool = False) -> dict:
    """Best (threads, chunk_mb) for the device backing ``swap_dir``.

    Runs a SHORT sweep (one 16 MB tensor across a thread × chunk grid,
    seconds not minutes) on first use and caches the winner keyed by the
    swap dir's ``st_dev`` + IO mode — a later process on the same disk
    loads the cached result instead of re-benchmarking. The sweep runs in
    the SAME IO mode the caller will use (``o_direct``): a buffered sweep
    would score page-cache memcpy and pick an arbitrary config for an
    O_DIRECT swapper. The score is read bandwidth (the pipeline's critical
    leg: prefetch feeds the Adam stage) with write bandwidth as the
    tiebreaker."""
    os.makedirs(swap_dir, exist_ok=True)
    cache_path = cache_path or _DEFAULT_CACHE
    dev_key = f"{os.stat(swap_dir).st_dev}:{'od' if o_direct else 'buf'}"
    cache = {}
    if os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                cache = json.load(f)
        except Exception:
            cache = {}
    if not force and dev_key in cache:
        return cache[dev_key]
    bench_dir = os.path.join(swap_dir, ".aio_autotune")
    try:
        results = sweep(bench_dir, sizes_mb=[16], threads=[1, 2, 4, 8],
                        repeats=2, o_direct=o_direct, chunks_mb=[0, 4, 16])
    finally:
        shutil.rmtree(bench_dir, ignore_errors=True)
    best = max(results, key=lambda r: (r["read_MBps"], r["write_MBps"]))
    entry = {"threads": best["threads"], "chunk_mb": best["chunk_mb"],
             "read_MBps": best["read_MBps"], "write_MBps": best["write_MBps"],
             "swept_at": time.time(), "device": dev_key}
    cache[dev_key] = entry
    try:  # atomic store — concurrent trainers race benignly (same answer)
        tmp = cache_path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=2)
        os.replace(tmp, cache_path)
    except Exception as e:
        logger.warning(f"aio autotune cache write failed: {e}")
    logger.info(f"aio autotune: threads={entry['threads']} "
                f"chunk_mb={entry['chunk_mb']} "
                f"(read {entry['read_MBps']} MB/s) for device {dev_key}")
    return entry


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="aio_bench", description=__doc__)
    p.add_argument("--path", default="/tmp/dstpu_aio_bench")
    p.add_argument("--sizes", default="1,8,64",
                   help="comma-separated IO sizes in MB")
    p.add_argument("--threads", default="1,2,4")
    p.add_argument("--chunks", default="0",
                   help="comma-separated per-op chunk sizes in MB (0 = whole"
                        " tensor in one op)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--buffered", action="store_true",
                   help="use the page cache instead of O_DIRECT")
    p.add_argument("--autotune", action="store_true",
                   help="run the short autotune sweep for --path and print "
                        "the cached winner")
    p.add_argument("--json", action="store_true", help="print one JSON line")
    args = p.parse_args(argv)
    os.makedirs(args.path, exist_ok=True)
    if args.autotune:
        print(json.dumps(autotune_config(args.path, force=True,
                                         o_direct=not args.buffered)))
        return 0
    res = sweep(args.path, [int(s) for s in args.sizes.split(",")],
                [int(t) for t in args.threads.split(",")], args.repeats,
                o_direct=not args.buffered,
                chunks_mb=[int(c) for c in args.chunks.split(",")])
    if args.json:
        best = max(res, key=lambda r: r["read_MBps"])
        print(json.dumps({"results": res, "best": best}))
    else:
        print(f"{'size_MB':>8} {'threads':>8} {'chunk_MB':>9} "
              f"{'write_MB/s':>12} {'read_MB/s':>12}")
        for r in res:
            print(f"{r['size_mb']:>8} {r['threads']:>8} {r['chunk_mb']:>9} "
                  f"{r['write_MBps']:>12} {r['read_MBps']:>12}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
