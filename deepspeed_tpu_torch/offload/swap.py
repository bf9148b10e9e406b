"""Async tensor swapping to local SSD / NVMe (counterpart of
``deepspeed_tpu/offload/swap.py``).

Arrays move host <-> file through the native AIO threadpool of the repo's
``csrc/aio.cpp`` (built with ``g++`` at first use by the ``async_io`` op
builder, :func:`deepspeed_tpu_torch.ops._build.host_library`; a failed
build raises, there is no pure-Python stand-in):

* every IO goes through a reusable aligned bounce buffer from a
  :class:`PinnedBufferPool` (page-locked with ``pin=True``, so a copy to the
  card runs at the link's rate); the caller's array is copied in at submit
  time, so two writes of one name never alias an in-flight buffer;
* ``swap_out`` / ``swap_in_start`` return a :class:`SwapTicket` waited on
  individually (``ds_aio_wait_op``); :meth:`AsyncTensorSwapper.wait` is the
  barrier over everything;
* arrays larger than ``chunk_bytes`` split into chunk-sized ops at file
  offsets, spread over the threadpool;
* every ticket is an async ``aio/swap_op`` track on the event bus (submit
  to reap), feeds the ``offload/*`` registry families (latency, bytes,
  errors) when it completes, and its submission is a fault-injector site
  (``swap_read`` / ``swap_write``).

* ``autotune=True`` adopts the best thread count x chunk size from a short
  :func:`deepspeed_tpu_torch.ops.aio_bench.autotune_config` sweep, cached
  per swap device; a failed sweep leaves the defaults (``autotuned`` None).
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.observability.events import get_bus
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["AsyncTensorSwapper", "PinnedBuffer", "PinnedBufferPool",
           "SwapTicket"]

_ALIGN = 4096  # O_DIRECT requires block-aligned buffers, sizes, and offsets
_DEFAULT_THREADS = 4
_DEFAULT_CHUNK_MB = 8


def _padded(nbytes: int) -> int:
    return max(_ALIGN, -(-nbytes // _ALIGN) * _ALIGN)


class PinnedBuffer:
    """One aligned host buffer owned by a :class:`PinnedBufferPool`:
    ``data`` is a ``_ALIGN``-aligned uint8 numpy view of a torch tensor
    (page-locked when ``pin``)."""

    __slots__ = ("raw", "data", "capacity", "offset")

    def __init__(self, capacity: int, pin: bool = False):
        raw = torch.empty(capacity + _ALIGN, dtype=torch.uint8,
                          pin_memory=pin)
        arr = raw.numpy()
        off = (-arr.ctypes.data) % _ALIGN
        self.raw = raw
        self.data = arr[off:off + capacity]
        self.capacity = capacity
        self.offset = off

    def tensor(self, nbytes: int) -> torch.Tensor:
        """The first ``nbytes`` of ``data`` as a uint8 torch tensor (sharing
        ``raw``'s storage, so page-locked with it)."""
        return self.raw[self.offset:self.offset + nbytes]

    def addr(self, offset: int = 0) -> ctypes.c_void_p:
        return ctypes.c_void_p(self.data.ctypes.data + offset)


class PinnedBufferPool:
    """Reusable aligned bounce buffers. ``get`` best-fits the smallest
    cached buffer that covers the request (never one over twice the need);
    a miss allocates. ``put`` recycles up to ``max_cached`` buffers.
    ``pin`` page-locks new buffers (needs a CUDA build of torch)."""

    def __init__(self, max_cached: int = 32, pin: bool = False):
        self.max_cached = max_cached
        self.pin = pin
        self._free: List[PinnedBuffer] = []  #: guarded_by: _lock
        self._lock = threading.Lock()
        self.allocations = 0     #: guarded_by: _lock
        self.reuses = 0          #: guarded_by: _lock
        self.outstanding = 0     #: guarded_by: _lock
        self.bytes_allocated = 0  #: guarded_by: _lock

    def get(self, nbytes: int) -> PinnedBuffer:
        need = _padded(nbytes)
        with self._lock:
            best = None
            for b in self._free:
                if need <= b.capacity <= 2 * need and \
                        (best is None or b.capacity < best.capacity):
                    best = b
            if best is not None:
                self._free.remove(best)
                self.reuses += 1
                self.outstanding += 1
                return best
            self.allocations += 1
            self.bytes_allocated += need
            self.outstanding += 1
        return PinnedBuffer(need, self.pin)

    def put(self, buf: PinnedBuffer) -> None:
        with self._lock:
            # a buffer recycled twice would go to two owners (live IO
            # aliased): identity check
            if any(b is buf for b in self._free):
                raise RuntimeError(
                    "PinnedBuffer returned to the pool twice (double put)")
            self.outstanding -= 1
            if len(self._free) < self.max_cached:
                self._free.append(buf)
            else:
                self.bytes_allocated -= buf.capacity

    def report(self) -> Dict[str, int]:
        with self._lock:
            return {"allocations": self.allocations, "reuses": self.reuses,
                    "outstanding": self.outstanding,
                    "cached": len(self._free),
                    "bytes_allocated": self.bytes_allocated}


class SwapTicket:
    """One in-flight swap (possibly many chunked native ops). ``wait()``
    blocks on this ticket's ops only; a read ticket returns a view over its
    pooled buffer, loaned until :meth:`release`. Write tickets return their
    buffer inside ``wait()``."""

    __slots__ = ("swapper", "tid", "kind", "name", "op_ids", "buf", "nbytes",
                 "shape", "dtype", "t_submit", "_done", "_released", "_view",
                 "_failed", "_eid")

    def __init__(self, swapper: "AsyncTensorSwapper", tid: int, kind: str,
                 name: str, op_ids: List[int], buf: PinnedBuffer, nbytes: int,
                 shape: Optional[tuple] = None, dtype=None):
        self.swapper = swapper
        self.tid = tid
        self.kind = kind                  # "r" | "w"
        self.name = name
        self.op_ids = op_ids
        self.buf = buf
        self.nbytes = nbytes
        self.shape = shape
        self.dtype = dtype
        self.t_submit = time.perf_counter()
        self._done = False
        self._released = False
        self._failed = False   # a reaped chunk errored (sticky across polls)
        self._view: Optional[np.ndarray] = None
        # async event-track id (observability.tracing): submit -> reap is
        # the op's in-flight window on the trace timeline
        self._eid: Optional[int] = None
        bus = get_bus()
        if bus.enabled:
            self._eid = bus.new_id()
            bus.async_begin("aio", "swap_op", self._eid,
                            args={"kind": kind, "name": name,
                                  "bytes": nbytes,
                                  "chunks": len(op_ids)})

    def _emit_end(self, error: bool, barrier: bool = False) -> None:
        """Close the ticket's async event track exactly once."""
        if self._eid is None:
            return
        bus = get_bus()
        if bus.enabled:
            bus.async_end("aio", "swap_op", self._eid,
                          args={"kind": self.kind, "error": error,
                                "barrier": barrier})
        self._eid = None

    @property
    def done(self) -> bool:
        return self._done

    def poll(self) -> bool:
        """Non-blocking completion probe; reaps finished ops as it goes."""
        if self._done:
            return True
        lib, h = self.swapper.lib, self.swapper.handle
        remaining = []
        for oid in self.op_ids:
            st = lib.ds_aio_poll_op(h, ctypes.c_int64(oid))
            if st == 0:
                remaining.append(oid)
            elif st < 0:
                self._failed = True
        self.op_ids = remaining
        if remaining:
            return False
        self._complete(self._failed)
        return True

    def wait(self) -> Optional[np.ndarray]:
        """Block until this ticket's ops finish; read tickets return the
        array view (valid until :meth:`release`)."""
        if not self._done:
            lib, h = self.swapper.lib, self.swapper.handle
            failed = self._failed
            for oid in self.op_ids:
                if lib.ds_aio_wait_op(h, ctypes.c_int64(oid)) != 0:
                    failed = True
            self.op_ids = []
            self._complete(failed)
        return self._view

    def _complete(self, failed: bool) -> None:
        self._done = True
        sw = self.swapper
        sw._inflight.pop(self.tid, None)
        elapsed_ms = (time.perf_counter() - self.t_submit) * 1e3
        self._emit_end(failed)
        if failed:
            self._release_buf()
            sw._record_io(self.kind, self.nbytes, elapsed_ms, error=True)
            raise IOError(
                f"async {'read' if self.kind == 'r' else 'write'} of "
                f"{self.name!r} failed in {sw.swap_dir}")
        sw._record_io(self.kind, self.nbytes, elapsed_ms, error=False)
        if self.kind == "r":
            self._view = (self.buf.data[:self.nbytes].view(self.dtype)
                          .reshape(self.shape))
            sw._loans[self.tid] = self
        else:
            self._release_buf()

    def release(self) -> None:
        """Return a read ticket's pooled buffer (idempotent; implies wait)."""
        if not self._done:
            self.wait()
        self._view = None
        self.swapper._loans.pop(self.tid, None)
        self._release_buf()

    def _release_buf(self) -> None:
        if not self._released and self.buf is not None:
            self._released = True
            self.swapper.pool.put(self.buf)
            self.buf = None


class AsyncTensorSwapper:
    """Write/read named host arrays to files asynchronously.

    ``o_direct=True`` bypasses the page cache (padded, aligned IO);
    ``chunk_mb`` caps the per-op IO size; ``num_threads=0`` / ``chunk_mb=0``
    mean "auto": the autotuned config when ``autotune=True``, else the
    defaults (4 threads, 8 MB). ``namespace`` scopes the files to a
    subdirectory of ``swap_dir``."""

    def __init__(self, swap_dir: str, num_threads: int = 0,
                 o_direct: bool = False, chunk_mb: int = 0,
                 autotune: bool = False, autotune_cache: str = "",
                 pool: Optional[PinnedBufferPool] = None,
                 namespace: str = ""):
        from deepspeed_tpu_torch.ops import get_op_builder

        if namespace:
            swap_dir = os.path.join(swap_dir, namespace)
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        self.o_direct = o_direct
        self.autotuned: Optional[dict] = None
        if autotune and (num_threads <= 0 or chunk_mb <= 0):
            try:
                from deepspeed_tpu_torch.ops.aio_bench import autotune_config

                self.autotuned = autotune_config(
                    swap_dir, cache_path=autotune_cache or None,
                    o_direct=o_direct)
                if num_threads <= 0:
                    num_threads = int(self.autotuned["threads"])
                if chunk_mb <= 0:
                    chunk_mb = int(self.autotuned["chunk_mb"])
            except Exception as e:   # autotune must never block the caller
                logger.warning(f"aio autotune failed ({e}); using defaults")
        self.num_threads = num_threads if num_threads > 0 else _DEFAULT_THREADS
        self.chunk_bytes = _padded(
            (chunk_mb if chunk_mb > 0 else _DEFAULT_CHUNK_MB) * (1 << 20))
        self.lib = get_op_builder("async_io").load()
        self.handle = self.lib.ds_aio_handle_create(self.num_threads)
        self.pool = pool if pool is not None else PinnedBufferPool()
        self._meta: Dict[str, tuple] = {}
        # in-flight tickets by ticket id, not name: two swap_outs of one
        # name each pin their own buffer until their own ops complete
        self._inflight: Dict[int, SwapTicket] = {}
        # completed read tickets whose buffer is loaned until release()
        self._loans: Dict[int, SwapTicket] = {}
        self._next_tid = 0
        self._metrics = None  # lazy: offload/* instruments

    # ------------------------------------------------------------------
    def _path(self, name: str) -> bytes:
        return os.path.join(self.swap_dir,
                            name.replace("/", "_") + ".swp").encode()

    def _instruments(self):
        if self._metrics is None:
            from deepspeed_tpu_torch.observability.registry import (
                exponential_bounds, get_registry)

            reg = get_registry()
            ms_bounds = [b / 16 for b in exponential_bounds()]  # 16µs..~2s
            self._metrics = {
                "r_ms": reg.histogram("offload/swap_in_ms",
                                      "swap read submit→complete latency",
                                      bounds=ms_bounds),
                "w_ms": reg.histogram("offload/swap_out_ms",
                                      "swap write submit→complete latency",
                                      bounds=ms_bounds),
                "r_bytes": reg.counter("offload/bytes_read",
                                       "bytes read from swap files"),
                "w_bytes": reg.counter("offload/bytes_written",
                                       "bytes written to swap files"),
                "errors": reg.counter("offload/io_errors",
                                      "failed swap IO tickets"),
            }
        return self._metrics

    def _record_io(self, kind: str, nbytes: int, elapsed_ms: float,
                   error: bool) -> None:
        m = self._instruments()
        if error:
            m["errors"].inc()
            return
        if kind == "r":
            m["r_ms"].observe(elapsed_ms)
            m["r_bytes"].inc(nbytes)
        else:
            m["w_ms"].observe(elapsed_ms)
            m["w_bytes"].inc(nbytes)

    def _fire_fault(self, site: str) -> None:
        from deepspeed_tpu_torch.resilience.faults import get_injector

        get_injector().on_swap_io(site)

    def _submit_chunks(self, kind: str, path: bytes, buf: PinnedBuffer,
                       nbytes: int, ids: List[int],
                       base: int = 0) -> List[int]:
        """Split ``nbytes`` of ``buf`` (from buffer offset ``base``) into
        chunk-sized native ops at file offsets, appending each op id to the
        caller's ``ids`` as it is queued (so a failure mid-loop leaves the
        queued ids visible to the caller's cleanup)."""
        submit = (self.lib.ds_aio_submit_pread if kind == "r"
                  else self.lib.ds_aio_submit_pwrite)
        od = 1 if self.o_direct else 0
        off = 0
        while off < nbytes:
            n = min(self.chunk_bytes, nbytes - off)
            ids.append(submit(self.handle, path, buf.addr(base + off),
                              ctypes.c_int64(n), ctypes.c_int64(off), od))
            off += n
        return ids

    def _release_failed_submit(self, op_ids: List[int],
                               buf: PinnedBuffer) -> None:
        """Reap any chunks already queued against ``buf`` before it returns
        to the pool (recycling it with ops in flight would alias live IO).
        Never raises."""
        try:
            for oid in op_ids:
                self.lib.ds_aio_wait_op(self.handle, ctypes.c_int64(oid))
        except Exception:
            pass
        self.pool.put(buf)

    def _new_ticket(self, kind: str, name: str, op_ids: List[int],
                    buf: PinnedBuffer, nbytes: int, shape=None,
                    dtype=None) -> SwapTicket:
        self._next_tid += 1
        t = SwapTicket(self, self._next_tid, kind, name, op_ids, buf, nbytes,
                       shape, dtype)
        self._inflight[t.tid] = t
        return t

    # ------------------------------------------------------------------
    def adopt_meta(self, name: str, shape, dtype) -> None:
        """Register shape/dtype for a swap file written by another swapper
        (metadata lives in memory, files on disk). Raises
        ``FileNotFoundError`` when the file is missing or shorter than the
        metadata claims."""
        shape = tuple(int(s) for s in shape)
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        path = self._path(name).decode()
        try:
            have = os.path.getsize(path)
        except OSError as e:
            raise FileNotFoundError(f"swap file for {name!r} missing: "
                                    f"{e}") from e
        if have < nbytes:
            raise FileNotFoundError(
                f"swap file for {name!r} torn: {have} < {nbytes} bytes")
        self._meta[name] = (shape, dtype)

    def has_meta(self, name: str) -> bool:
        return name in self._meta

    def swap_out(self, name: str, array: np.ndarray) -> SwapTicket:
        """Copy ``array`` into a pooled buffer and submit an async (chunked)
        write; the caller's array is free for reuse at once."""
        self._fire_fault("swap_write")
        arr = np.ascontiguousarray(array)
        self._meta[name] = (tuple(arr.shape), arr.dtype)
        nbytes = arr.nbytes
        io_bytes = _padded(nbytes) if self.o_direct else nbytes
        buf = self.pool.get(io_bytes)
        ids: List[int] = []
        try:
            buf.data[:nbytes] = arr.view(np.uint8).reshape(-1)
            if io_bytes > nbytes:
                buf.data[nbytes:io_bytes] = 0
            self._submit_chunks("w", self._path(name), buf, io_bytes, ids)
            return self._new_ticket("w", name, ids, buf, nbytes)
        except BaseException:
            self._release_failed_submit(ids, buf)
            raise

    def swap_in_start(self, name: str) -> SwapTicket:
        """Submit an async (chunked) read into a pooled buffer; ``wait()``
        yields the array (call ``release()`` once consumed)."""
        self._fire_fault("swap_read")
        shape, dtype = self._meta[name]
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        io_bytes = _padded(nbytes) if self.o_direct else nbytes
        buf = self.pool.get(io_bytes)
        ids: List[int] = []
        try:
            self._submit_chunks("r", self._path(name), buf, io_bytes, ids)
            return self._new_ticket("r", name, ids, buf, nbytes, shape,
                                    dtype)
        except BaseException:
            self._release_failed_submit(ids, buf)
            raise

    def swap_in_start_many(self, names: List[str]):
        """One ticket reading several files into one pooled buffer at
        aligned segment offsets. Returns ``(ticket, segments)`` with
        ``segments[name] = (buffer_offset, nbytes)`` into the flat uint8
        view ``ticket.wait()`` yields."""
        self._fire_fault("swap_read")
        segments: Dict[str, tuple] = {}
        total = 0
        for name in names:
            shape, dtype = self._meta[name]
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            segments[name] = (total, nbytes)
            total += _padded(nbytes)      # aligned starts keep O_DIRECT legal
        buf = self.pool.get(total)
        ids: List[int] = []
        try:
            for name in names:
                base, nbytes = segments[name]
                io_bytes = _padded(nbytes) if self.o_direct else nbytes
                self._submit_chunks("r", self._path(name), buf, io_bytes,
                                    ids, base=base)
            return (self._new_ticket("r", f"batch[{len(names)}]", ids, buf,
                                     total, (total,), np.uint8), segments)
        except BaseException:
            self._release_failed_submit(ids, buf)
            raise

    def discard(self, name: str) -> None:
        """Forget a swapped array: drop its metadata and best-effort remove
        its file. No ops of ``name`` may be in flight."""
        self._meta.pop(name, None)
        try:
            os.remove(self._path(name))
        except OSError:
            pass

    def swap_in(self, name: str) -> np.ndarray:
        """Blocking read returning an owned array."""
        t = self.swap_in_start(name)
        try:
            out = np.array(t.wait())     # owned copy: the buffer recycles
        finally:
            if t.done:                   # a raising wait() released it
                t.release()
        return out

    # ------------------------------------------------------------------
    def wait(self) -> None:
        """Barrier: drain every submitted op and finalise all tickets (read
        tickets keep their loaned buffer until ``release()``). Raises on any
        failed op; then no in-flight read ticket gets a view (the barrier
        cannot tell which one failed)."""
        if not getattr(self, "handle", None):
            return
        errors = int(self.lib.ds_aio_wait(self.handle))
        now = time.perf_counter()
        sticky = 0
        for t in list(self._inflight.values()):
            t.op_ids = []
            t._done = True
            t._emit_end(bool(errors or t._failed), barrier=True)
            if errors or t._failed:
                if t._failed:
                    sticky += 1
                    self._record_io(t.kind, t.nbytes,
                                    (now - t.t_submit) * 1e3, error=True)
                t._view = None
                t._release_buf()
            elif t.kind == "w":
                self._record_io("w", t.nbytes, (now - t.t_submit) * 1e3,
                                error=False)
                t._release_buf()
            else:
                self._record_io("r", t.nbytes, (now - t.t_submit) * 1e3,
                                error=False)
                t._view = (t.buf.data[:t.nbytes].view(t.dtype)
                           .reshape(t.shape))
                self._loans[t.tid] = t
        self._inflight.clear()
        if errors or sticky:
            if errors:
                self._instruments()["errors"].inc(errors)
            raise IOError(f"{errors + sticky} async IO operations failed "
                          f"in {self.swap_dir}")

    def abort(self) -> None:
        """Error-path cleanup: drain the native queue, drop every ticket and
        return all pooled buffers, read loans included. Never raises."""
        try:
            if self.handle:
                self.lib.ds_aio_wait(self.handle)
        except Exception:
            pass
        for t in list(self._inflight.values()) + list(self._loans.values()):
            t.op_ids = []
            t._done = True
            t._emit_end(True, barrier=True)
            t._view = None
            t._release_buf()
        self._inflight.clear()
        self._loans.clear()

    @property
    def pending(self) -> int:
        if not getattr(self, "handle", None):
            return 0
        return int(self.lib.ds_aio_pending(self.handle))

    def bandwidth(self) -> Dict[str, float]:
        """Measured read/write rates from the native per-direction stats
        (bytes over the union of in-flight windows)."""
        if not getattr(self, "handle", None):
            return {"read_bytes": 0, "write_bytes": 0,
                    "read_MBps": 0.0, "write_MBps": 0.0}
        out = (ctypes.c_int64 * 4)()
        self.lib.ds_aio_stats(self.handle, out)
        rb, rns, wb, wns = out[0], out[1], out[2], out[3]
        return {
            "read_bytes": int(rb), "write_bytes": int(wb),
            "read_MBps": round(rb / 1e6 / (rns / 1e9), 1) if rns else 0.0,
            "write_MBps": round(wb / 1e6 / (wns / 1e9), 1) if wns else 0.0,
        }

    def report(self) -> Dict:
        return {
            "threads": self.num_threads,
            "chunk_mb": self.chunk_bytes >> 20,
            "o_direct": self.o_direct,
            "autotuned": self.autotuned,
            "pending_ops": self.pending if self.handle else 0,
            "inflight_tickets": len(self._inflight),
            "loaned_read_buffers": len(self._loans),
            "pool": self.pool.report(),
            **self.bandwidth(),
        }

    def close(self) -> None:
        """Idempotent shutdown: drain pending ops, release buffers, destroy
        the native handle."""
        if not getattr(self, "handle", None):
            return
        self.abort()
        self.lib.ds_aio_handle_destroy(ctypes.c_void_p(self.handle))
        self.handle = None

    def __del__(self):  # best effort: don't leak native threads
        try:
            self.close()
        except Exception:
            pass
