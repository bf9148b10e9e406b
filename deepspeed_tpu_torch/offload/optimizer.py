"""Host-offloaded optimizer step (ZeRO-Offload) with an optional NVMe state
tier (ZeRO-Infinity) and ZenFlow's two modes (counterpart of
``deepspeed_tpu/offload/optimizer.py``).

The fp32 master weights and Adam moments live in host RAM (the moments,
with ``nvme_path``, in files), the update runs in the native C++ loop of
``csrc/cpu_adam.cpp`` (:class:`DeepSpeedCPUAdam`), and only the updated
params go back to the device. The engine routes its step here when
``zero_optimization.offload_optimizer.device`` is ``cpu`` or ``nvme``.

One device, one shard a leaf: ``_layout[name]`` holds the leaf's one
full-extent key, and host buffers are keyed ``name#0`` as the reference's
are, so the state dict and the NVMe file names match its own.

A step on a CUDA engine: the global norm of the device grads (the
cascade-sum ``global_norm`` of ``runtime/optimizers.py``); clipping, when
it applies, scales the device grads by the reference's ``clip / (norm +
1e-6)`` (the same fp32 product its host multiply makes); one
non-blocking device-to-host copy a leaf into a page-locked grad buffer;
the C++ Adam a leaf; a non-blocking host-to-device copy of each updated
master into the engine's param in place. With ``upload_overlap`` the
Adam runs on a worker thread and the caller uploads each leaf as soon as
it is updated; with ``nvme_path`` the depth-k pipeline reads leaf i+k's
moments while leaf i updates and leaf i-1's are written back.

ZenFlow: ``overlap_step`` runs the whole host step on a worker, applied at
the next step boundary (1-step bounded staleness);
:class:`ZenFlowSelectiveOptimizer` updates the top-k gradient columns on
the device every step and the rest through the host Adam every
``update_interval`` steps.
"""

from __future__ import annotations

import logging
import os
import queue as _queue
import time
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.offload.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.offload.swap import AsyncTensorSwapper
from deepspeed_tpu_torch.runtime.optimizers import global_norm

logger = logging.getLogger("deepspeed_tpu_torch")

__all__ = ["HostOffloadOptimizer", "ZenFlowSelectiveOptimizer"]


def _leaf_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(name, leaf)]`` of a nested dict, names ``/``-joined (the
    reference's ``tree_flatten_with_path`` names), in insertion order."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k, v in tree.items():
            out += _leaf_paths(v, f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _unpin(pinned: list) -> None:
    cudart = torch.cuda.cudart()
    for t in pinned:
        cudart.cudaHostUnregister(t.data_ptr())
    pinned.clear()


class _HostBuffers:
    """fp32 host buffers of exact size, page-locked when ``pin``.

    Pinning tens of GB takes seconds, so every buffer is made once, at
    construction. ``torch.empty(pin_memory=True)`` would round each one up
    to a power of two (and cache it after it is freed): an 18 GB set of
    masters could take 24 GB or more. These are plain allocations
    registered with ``cudaHostRegister`` and unregistered by :meth:`close`
    (or when the owner is collected)."""

    def __init__(self, owner, pin: bool):
        self.pin = pin
        self._pinned: list = []
        self._fin = weakref.finalize(owner, _unpin, self._pinned) \
            if pin else None

    def empty(self, shape) -> torch.Tensor:
        t = torch.empty(shape, dtype=torch.float32)
        if self.pin and t.numel():
            rc = int(torch.cuda.cudart().cudaHostRegister(
                t.data_ptr(), t.numel() * 4, 0))
            if rc != 0:
                raise RuntimeError(f"cudaHostRegister of {t.numel() * 4} "
                                   f"bytes failed with cudaError_t {rc}")
            self._pinned.append(t)
        return t

    def close(self) -> None:
        if self._fin is not None:
            self._fin()


class HostOffloadOptimizer:
    def __init__(self, params: Any, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 gradient_clipping: float = 0.0, schedule_fn=None,
                 nvme_path: Optional[str] = None, aio_threads: int = 2,
                 overlap_step: bool = False, aio_chunk_mb: int = 0,
                 prefetch_depth: int = 2, aio_autotune: bool = False,
                 aio_o_direct: bool = False, aio_autotune_cache: str = "",
                 upload_overlap: bool = True):
        self.adam = DeepSpeedCPUAdam(lr=lr, betas=betas, eps=eps,
                                     weight_decay=weight_decay)
        self.schedule_fn = schedule_fn
        self.base_lr = lr
        self.gradient_clipping = gradient_clipping
        self.overlap = overlap_step
        self._worker = ThreadPoolExecutor(max_workers=1) if overlap_step else None
        self._pending = None  # (Future, params) of the in-flight async step
        self._last_gnorm = float("nan")
        # depth of the NVMe read-ahead pipeline; 0 = strictly serial (the
        # bit-exactness oracle)
        self.prefetch_depth = max(0, int(prefetch_depth))
        # upload finished leaves while later leaves are still in the host
        # Adam: the Adam runs on a worker (the C++ call releases the GIL),
        # the uploads on the caller's thread
        self._upload_overlap = bool(upload_overlap) and not overlap_step
        self._adam_pool: Optional[ThreadPoolExecutor] = None
        self._adam_ms = 0.0
        self._upload_ms = 0.0
        self._d2h_ms = 0.0
        self._stall_fraction = 0.0
        self._obs_instruments = None
        self.swapper = (AsyncTensorSwapper(os.path.join(nvme_path, "opt_states"),
                                           num_threads=aio_threads,
                                           chunk_mb=aio_chunk_mb,
                                           o_direct=aio_o_direct,
                                           autotune=aio_autotune,
                                           autotune_cache=aio_autotune_cache)
                        if nvme_path else None)
        leaves = _leaf_paths(params)
        self.device = leaves[0][1].device
        cuda = self.device.type == "cuda"
        self._host = _HostBuffers(self, pin=cuda)
        self._d2h_events = None       # (start, end) of the last grad copy
        self._d2h_t = 0.0             # its host time (a CPU engine)
        # self._layout[name] = [(index_key, devices)]: one full-extent key
        # a leaf on one device; shard key "name#0" addresses its buffers
        self._layout: Dict[str, list] = {}
        self._shapes: Dict[str, tuple] = {}
        self.master: Dict[str, torch.Tensor] = {}   # keyed "name#i"
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self._grads: Dict[str, torch.Tensor] = {}   # device-to-host landing
        self._init_writes = deque()  # bounded in-flight init/load writebacks
        for name, leaf in leaves:
            self._shapes[name] = tuple(leaf.shape)
            self._layout[name] = [(tuple((0, s) for s in leaf.shape), None)]
            skey = f"{name}#0"
            master = self._host.empty(leaf.shape)
            master.copy_(leaf.detach())     # a copy: never the live param
            self._init_shard(skey, master)
            self._grads[skey] = self._host.empty(leaf.shape)
        if self.swapper is not None:
            self.swapper.wait()
            self._init_writes.clear()
        total = sum(a.numel() for a in self.master.values())
        logger.info("host offload optimizer: %.1fM fp32 master params in %d "
                    "shards (%s moments, %s host buffers)", total / 1e6,
                    len(self.master), "nvme" if self.swapper else "cpu",
                    "page-locked" if cuda else "pageable")

    def _init_shard(self, skey: str, master: torch.Tensor) -> None:
        self.master[skey] = master
        if self.swapper is not None:
            zeros = np.zeros(master.shape, np.float32)
            self._init_writes.append(self.swapper.swap_out(skey + ".m", zeros))
            self._init_writes.append(self.swapper.swap_out(skey + ".v", zeros))
            # reap old init writes so the bulk zero-write never loans more
            # than a window of pooled buffers
            while len(self._init_writes) > 32:
                self._init_writes.popleft().wait()
        else:
            self.m[skey] = torch.zeros_like(master)
            self.v[skey] = torch.zeros_like(master)

    # ------------------------------------------------------------------
    def step(self, grads: Any, params: Any, step_num: int):
        """Update the masters from the device grads and copy them into
        ``params`` (in place); returns ``(params, skipped)``.

        ``skipped=True`` (a non-finite grad norm, fp16 overflow) leaves
        every state untouched. With ``upload_overlap`` the host Adam runs
        on a worker while this thread uploads each leaf as soon as it is
        updated."""
        host_grads, order, gnorm = self._prepare(grads)
        if not (self._upload_overlap and len(order) > 1
                and np.isfinite(gnorm)):
            skipped = self._host_work(host_grads, order, step_num, gnorm)
            if skipped:
                return params, True
            return self._upload(params), False
        if self._adam_pool is None:
            self._adam_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="offload-adam")
        done_q: "_queue.Queue[str]" = _queue.Queue()
        fut = self._adam_pool.submit(self._host_work, host_grads, order,
                                     step_num, gnorm, done_q.put)
        new_params = self._upload_streamed(params, order, done_q, fut)
        if fut.result():  # unreachable (gnorm pre-checked) -- kept as a guard
            return params, True
        return new_params, False

    def _prepare(self, grads):
        """The global norm of the device grads, clipping on the device, and
        the copy of each grad into its host buffer (caller's thread). A
        non-finite norm copies nothing: the step is skipped."""
        flat = _leaf_paths(grads)
        gnorm = self._device_gnorm(grads)
        if not np.isfinite(gnorm):
            return {}, [], gnorm
        scale = None
        if self.gradient_clipping > 0 and gnorm > self.gradient_clipping:
            scale = self.gradient_clipping / (gnorm + 1e-6)
        host_grads, order = self._snapshot_grads(flat, scale)
        return host_grads, order, gnorm

    def _snapshot_grads(self, flat, scale: Optional[float] = None):
        """Device-to-host copy of each grad leaf into its page-locked
        buffer, non-blocking, then an event recorded after the last copy.
        The host Adam waits on that event before it reads a buffer
        (:meth:`_host_work`). The engine drops its ``.grad`` tensors after
        this call: the next backward's allocations reuse their memory only
        in stream order, after these copies."""
        host_grads: Dict[str, torch.Tensor] = {}
        order: List[str] = []
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        with torch.no_grad():
            for name, g in flat:
                skey = f"{name}#0"
                g = g.detach()
                if scale is not None:
                    # the reference's host ``g * scale``: fp32 grads times
                    # the fp32 scale, the same product on the device
                    g = g.float().mul_(scale)
                buf = self._grads[skey]
                buf.copy_(g.reshape(buf.shape), non_blocking=cuda)
                host_grads[skey] = buf
                order.append(skey)
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._d2h_events = (start, end)
        else:
            self._d2h_t = time.perf_counter() - t0
        return host_grads, order

    def _device_gnorm(self, grads) -> float:
        """Global grad norm of the device grads: the cascade sum of
        ``runtime/optimizers.py`` (``vector_norm`` is off by ~1% on large
        fp32 leaves on the CPU). Caller's thread."""
        return float(global_norm([g.detach() for _, g in _leaf_paths(grads)]))

    def _wait_d2h(self) -> None:
        """Block until the last grad copy has landed in the host buffers
        (the host Adam must not read them before)."""
        ev = self._d2h_events
        if ev is not None:
            ev[1].synchronize()
            self._d2h_ms = ev[0].elapsed_time(ev[1])
        else:
            self._d2h_ms = self._d2h_t * 1e3

    def _host_work(self, host_grads, order, step_num, gnorm: float,
                   done_cb=None) -> bool:
        """The fused Adam over the host buffers (host work only -- safe on
        a worker thread; ``gnorm`` and clipping were done on the caller's).
        ``done_cb(shard_key)`` fires as each shard's update lands (the
        streamed-upload consumer). Returns skipped."""
        lr = float(self.schedule_fn(step_num)) if self.schedule_fn else self.base_lr
        self._last_gnorm = gnorm
        if not np.isfinite(gnorm):
            return True
        self._wait_d2h()
        self._run_adam(host_grads, order, lr, done_cb)
        return False

    def _run_adam(self, host_grads: Dict[str, torch.Tensor], order: List[str],
                  lr: float, done_cb=None) -> None:
        self.adam.step_count += 1
        t_loop = time.perf_counter()
        stall = 0.0
        if self.swapper is None:
            # sequential per leaf: each C++ call already spreads over every
            # host core (omp parallel for in csrc/cpu_adam.cpp)
            for name in order:
                self.adam.step(self.master[name].view(-1),
                               host_grads[name].view(-1),
                               self.m[name].view(-1), self.v[name].view(-1),
                               lr=lr, increment=False)
                if done_cb is not None:
                    done_cb(name)
        elif self.prefetch_depth <= 0:
            # strictly serial swap path: read -> Adam -> write -> barrier per
            # leaf; the oracle the pipeline must match bit for bit
            for name in order:
                t0 = time.perf_counter()
                m = self.swapper.swap_in(name + ".m")
                v = self.swapper.swap_in(name + ".v")
                stall += time.perf_counter() - t0
                self.adam.step(self.master[name].view(-1),
                               host_grads[name].view(-1),
                               m.reshape(-1), v.reshape(-1), lr=lr,
                               increment=False)
                t0 = time.perf_counter()
                self.swapper.swap_out(name + ".m", m).wait()
                self.swapper.swap_out(name + ".v", v).wait()
                stall += time.perf_counter() - t0
                if done_cb is not None:
                    done_cb(name)
        else:
            self._run_adam_pipelined(host_grads, order, lr, done_cb)
            return
        total = time.perf_counter() - t_loop
        self._record_adam(total, stall)

    def _run_adam_pipelined(self, host_grads, order, lr, done_cb) -> None:
        """Depth-k swap pipeline: read leaf i+k, Adam leaf i, write leaf i-1
        concurrently. Per-leaf updates are independent, so the result is
        bit-identical to the serial path."""
        sw = self.swapper
        k = self.prefetch_depth
        reads: Dict[str, tuple] = {}
        writes = deque()
        stall = 0.0
        t_loop = time.perf_counter()

        def prefetch(j: int) -> None:
            n = order[j]
            reads[n] = (sw.swap_in_start(n + ".m"),
                        sw.swap_in_start(n + ".v"))

        try:
            for j in range(min(k, len(order))):
                prefetch(j)
            nxt = min(k, len(order))
            for name in order:
                if nxt < len(order):
                    prefetch(nxt)
                    nxt += 1
                mt, vt = reads.pop(name)
                t0 = time.perf_counter()
                m = mt.wait()
                v = vt.wait()
                stall += time.perf_counter() - t0
                self.adam.step(self.master[name].view(-1),
                               host_grads[name].view(-1),
                               m.reshape(-1), v.reshape(-1), lr=lr,
                               increment=False)
                # swap_out copies into a fresh pooled write buffer, so the
                # read loan can return to the pool at once
                writes.append(sw.swap_out(name + ".m", m))
                writes.append(sw.swap_out(name + ".v", v))
                mt.release()
                vt.release()
                # reap old writebacks lazily: bounds the pool loan-out at
                # ~2 leaves of writes + k leaves of reads
                while len(writes) > 4 * k:
                    t0 = time.perf_counter()
                    writes.popleft().wait()
                    stall += time.perf_counter() - t0
                if done_cb is not None:
                    done_cb(name)
            while writes:
                t0 = time.perf_counter()
                writes.popleft().wait()
                stall += time.perf_counter() - t0
        except BaseException:
            # clean abort: drain the native queue and return every pooled
            # buffer (read loans included) before propagating
            sw.abort()
            raise
        total = time.perf_counter() - t_loop
        self._record_adam(total, stall)

    def _record_adam(self, total_s: float, stall_s: float) -> None:
        self._adam_ms = total_s * 1e3
        self._stall_fraction = (stall_s / total_s) if total_s > 0 else 0.0
        obs = self._obs()
        if obs is not None:
            obs["adam_ms"].observe(self._adam_ms)
            if self.swapper is not None:
                obs["stall"].set(self._stall_fraction)

    def _obs(self):
        """``offload/*`` instruments in the process registry (lazy)."""
        if self._obs_instruments is None:
            from deepspeed_tpu_torch.observability.registry import get_registry

            reg = get_registry()
            self._obs_instruments = {
                "adam_ms": reg.histogram(
                    "offload/adam_ms", "host Adam loop duration"),
                "upload_ms": reg.histogram(
                    "offload/upload_ms", "masters→device upload"),
                "stall": reg.gauge(
                    "offload/pipeline_stall_fraction",
                    "fraction of the Adam loop blocked on swap IO"),
            }
        return self._obs_instruments

    @torch.no_grad()
    def _upload_leaf(self, name: str, leaf) -> None:
        """One leaf's master into the engine's param, in place (a
        non-blocking copy from the page-locked master on CUDA)."""
        leaf.copy_(self.master[f"{name}#0"].view(leaf.shape),
                   non_blocking=self.device.type == "cuda")

    def _uploads_landed(self) -> None:
        """Wait for the non-blocking host-to-device copies: they read the
        page-locked masters, which the next step's Adam writes in place.
        (It also makes ``upload_ms`` the transfer's wall time.)"""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()

    def _upload(self, params: Any):
        """Masters -> device for every leaf (the non-overlapped path)."""
        t0 = time.perf_counter()
        for name, leaf in _leaf_paths(params):
            self._upload_leaf(name, leaf)
        self._uploads_landed()
        self._record_upload(time.perf_counter() - t0)
        return params

    def _upload_streamed(self, params: Any, order: List[str], done_q, fut):
        """Consume shard-completion events from the Adam worker and upload
        each leaf the moment its last shard is updated: the upload of early
        leaves overlaps the Adam of later ones. Caller's thread."""
        leaf_map = dict(_leaf_paths(params))
        pending: Dict[str, int] = {}
        for skey in order:
            name = skey.rsplit("#", 1)[0]
            pending[name] = pending.get(name, 0) + 1
        t_up = 0.0
        while pending:
            try:
                skey = done_q.get(timeout=0.2)
            except _queue.Empty:
                if fut.done():
                    fut.result()  # surface the worker's exception
                    for name in list(pending):  # defensive tail flush
                        t0 = time.perf_counter()
                        self._upload_leaf(name, leaf_map[name])
                        t_up += time.perf_counter() - t0
                        del pending[name]
                continue
            name = skey.rsplit("#", 1)[0]
            pending[name] -= 1
            if pending[name] == 0:
                del pending[name]
                t0 = time.perf_counter()
                self._upload_leaf(name, leaf_map[name])
                t_up += time.perf_counter() - t0
        fut.result()  # re-raise late worker failures before committing
        t0 = time.perf_counter()
        self._uploads_landed()
        self._record_upload(t_up + time.perf_counter() - t0)
        return params

    def _record_upload(self, seconds: float) -> None:
        self._upload_ms = seconds * 1e3
        obs = self._obs()
        if obs is not None:
            obs["upload_ms"].observe(self._upload_ms)

    # ------------------------------------------------------------------
    # ZenFlow overlap: async step with 1-step bounded staleness
    # ------------------------------------------------------------------
    def step_async(self, grads: Any, params: Any, step_num: int) -> None:
        """Launch the host Adam in the background; :meth:`finish_pending`
        (the engine calls it at the next step boundary) uploads its
        result, so the host step overlaps the device's next forward and
        backward. The norm, clipping and the grad copies are issued here,
        the upload at collect time, both on the caller's thread.

        The C++ loop's OpenMP threads then share the host's cores with
        the thread that launches the next forward and backward."""
        assert self._pending is None, "previous async step not collected"
        host_grads, order, gnorm = self._prepare(grads)
        fut = self._worker.submit(self._host_work, host_grads, order, step_num,
                                  gnorm)
        self._pending = (fut, params)

    def finish_pending(self):
        """Block on the in-flight async step; returns ``(params, skipped)``
        or None when nothing is pending. Must be called before reading the
        params for checkpointing or eval (the engine does)."""
        if self._pending is None:
            return None
        fut, params = self._pending
        skipped = fut.result()
        self._pending = None
        if skipped:
            return params, True
        return self._upload(params), False

    # ------------------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """Snapshot of the offload data path: tier layout, pipeline
        configuration, the last step's stage timings (grad copy, Adam,
        upload), the measured stall fraction and the swapper's state."""
        rep: Dict[str, Any] = {
            "device": "nvme" if self.swapper is not None else "cpu",
            "shards": len(self.master),
            "master_params_m": round(
                sum(a.numel() for a in self.master.values()) / 1e6, 3),
            "overlap_step": self.overlap,
            "upload_overlap": self._upload_overlap,
            "prefetch_depth": self.prefetch_depth,
            "last_d2h_ms": round(self._d2h_ms, 3),
            "last_adam_ms": round(self._adam_ms, 3),
            "last_upload_ms": round(self._upload_ms, 3),
            "pipeline_stall_fraction": round(self._stall_fraction, 4),
        }
        if self.swapper is not None:
            rep["swapper"] = self.swapper.report()
        return rep

    def close(self) -> None:
        """Release the worker pools, then the AIO handle (a worker mid-step
        may still be submitting swap ops), then the page-locked host
        buffers. Idempotent."""
        if self._adam_pool is not None:
            self._adam_pool.shutdown(wait=True)
            self._adam_pool = None
        if self._worker is not None:
            self._worker.shutdown(wait=True)
            self._worker = None
        if self.swapper is not None:
            self.swapper.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._host.close()

    def state_dict(self) -> Dict[str, np.ndarray]:
        """``step``, ``master/<path>``, ``m/<path>`` and ``v/<path>``, as
        numpy arrays: the masters and the CPU tier's moments are views of
        the live buffers (the next step writes them; copy to keep)."""
        return self._state_dict_base()

    def _shard_get(self, kind: str, skey: str) -> np.ndarray:
        if kind == "master":
            return self.master[skey].numpy()
        if self.swapper is not None:
            return self.swapper.swap_in(f"{skey}.{kind}")
        return getattr(self, kind)[skey].numpy()

    def _set_full_leaf(self, kind: str, name: str, val: np.ndarray) -> None:
        skey = f"{name}#0"
        piece = np.ascontiguousarray(
            np.asarray(val, np.float32).reshape(self._shapes[name]))
        if kind == "master":
            self.master[skey].copy_(torch.from_numpy(piece))
        elif self.swapper is not None:
            self._init_writes.append(
                self.swapper.swap_out(f"{skey}.{kind}", piece))
            while len(self._init_writes) > 32:
                self._init_writes.popleft().wait()
        else:
            getattr(self, kind)[skey].copy_(torch.from_numpy(piece))

    def _state_dict_base(self) -> Dict[str, np.ndarray]:
        assert self._pending is None, (
            "flush the async step (engine.step boundary) before checkpointing")
        out = {"step": np.int64(self.adam.step_count)}
        for name in self._layout:   # one shard, the full leaf, a name
            for kind in ("master", "m", "v"):
                out[f"{kind}/{name}"] = self._shard_get(kind, f"{name}#0")
        return out

    def load_state_dict(self, sd: Dict[str, np.ndarray]) -> None:
        self.adam.step_count = int(sd["step"])
        for key, val in sd.items():
            if key == "step":
                continue
            kind, name = key.split("/", 1)
            if name in self._layout:
                self._set_full_leaf(kind, name, val)
        if self.swapper is not None:
            self.swapper.wait()
            self._init_writes.clear()


# ---------------------------------------------------------------------------
# ZenFlow importance-based top-k gradient split
# ---------------------------------------------------------------------------

class ZenFlowSelectiveOptimizer(HostOffloadOptimizer):
    """ZenFlow's selective path (the reference's, after
    ``runtime/zenflow/zenflow_stage_1_and_2.py`` ``update_selected_channels``
    + ``ZenFlowSelectiveAdamW``): per leaf of two or more dims, the
    ``topk_ratio`` most important gradient columns (importance = sum |g|
    per column of the last dim) update on the device every step through a
    selective Adam, while the other columns' gradients accumulate on the
    device and go through the host Adam only every ``update_interval``
    steps. Columns are reselected every ``select_interval`` steps, and the
    selective moments restart then (the upstream one migrates them: the
    reference's documented divergence, kept). Leaves of one dim update on
    the device every step.

    Between update boundaries the device params own the selected columns
    (and the dense leaves) and the host masters the other columns; the
    boundary step re-synchronises both. The selection, the selective
    Adam and the accumulator are plain torch on the device (the
    reference's are jitted XLA programs, not Pallas kernels)."""

    def __init__(self, params: Any, topk_ratio: float = 0.1,
                 select_interval: int = 16, update_interval: int = 4,
                 full_warm_up_rounds: int = 0, **kw):
        assert 0.0 < topk_ratio <= 1.0
        super().__init__(params, **kw)
        self.topk_ratio = float(topk_ratio)
        self.select_interval = int(select_interval)
        self.update_interval = int(update_interval)
        self.warmup = int(full_warm_up_rounds)
        flat = dict(_leaf_paths(params))
        # leaves with a splittable column axis; tiny trailing dims stay dense
        self._sel_names = sorted(n for n, l in flat.items()
                                 if l.ndim >= 2 and l.shape[-1] >= 8)
        self._full_names = sorted(set(flat) - set(self._sel_names))
        self._k = {n: max(1, int(round(self.topk_ratio * flat[n].shape[-1])))
                   for n in self._sel_names}

        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        # device state: selective + dense moments, unimportant accumulator
        self._idx: Optional[Dict[str, torch.Tensor]] = None  # [k] columns
        self._msel = {n: zeros(tuple(flat[n].shape[:-1]) + (self._k[n],))
                      for n in self._sel_names}
        self._vsel = {n: torch.zeros_like(t) for n, t in self._msel.items()}
        self._mfull = {n: zeros(flat[n].shape) for n in self._full_names}
        self._vfull = {n: torch.zeros_like(t) for n, t in self._mfull.items()}
        self._acc = {n: zeros(flat[n].shape) for n in self._sel_names}
        self._t_sel = 0           # selective-Adam step count (reset on select)
        self._last_select = 0
        logger.info("zenflow selective: topk_ratio=%s update_interval=%d "
                    "select_interval=%d, %d split leaves, %d dense leaves",
                    topk_ratio, update_interval, select_interval,
                    len(self._sel_names), len(self._full_names))

    def _lr(self, step_num: int) -> float:
        return (float(self.schedule_fn(step_num)) if self.schedule_fn
                else self.base_lr)

    # ---- the selection and the selective step (device) ------------------
    def _select_columns(self, flat_g) -> Dict[str, torch.Tensor]:
        idx = {}
        for n in self._sel_names:
            g = flat_g[n].detach().float()
            imp = g.abs().sum(dim=tuple(range(g.ndim - 1)))
            top = torch.topk(imp, self._k[n]).indices
            idx[n] = torch.sort(top).values
        return idx

    @torch.no_grad()
    def _selective_step(self, flat_p, flat_g, lr: float, gnorm: float) -> None:
        """One selective device step, in place: Adam on the selected
        columns and on every dense leaf; the other columns' (clipped)
        gradients accumulate."""
        b1, b2 = self.adam.betas
        eps, wd = self.adam.eps, self.adam.weight_decay
        # the bias corrections in fp32, as the reference's program has them
        t = np.float32(self._t_sel)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        clip = self.gradient_clipping
        scale = min(1.0, clip / (gnorm + 1e-6)) if clip > 0 else 1.0

        def adam(p, g, m, v):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g.square()
            u = (m / bc1) / ((v / bc2).sqrt() + eps) + wd * p
            return p - lr * u, m, v

        for n in self._sel_names:
            g = flat_g[n].detach().float() * scale
            idx = self._idx[n]
            p = flat_p[n]
            upd, self._msel[n], self._vsel[n] = adam(
                p.float().index_select(-1, idx), g.index_select(-1, idx),
                self._msel[n], self._vsel[n])
            p.index_copy_(-1, idx, upd.to(p.dtype))
            self._acc[n].add_(g.index_fill_(-1, idx, 0.0))
        for n in self._full_names:
            g = flat_g[n].detach().float() * scale
            p = flat_p[n]
            upd, self._mfull[n], self._vfull[n] = adam(
                p.float(), g, self._mfull[n], self._vfull[n])
            p.copy_(upd.to(p.dtype))

    # ---- the step ----------------------------------------------------
    def step(self, grads: Any, params: Any, step_num: int):
        if step_num < self.warmup:
            return super().step(grads, params, step_num)
        flat_g = dict(_leaf_paths(grads))
        flat_p = dict(_leaf_paths(params))
        if self._idx is None:
            # first selective step: masters are in sync (constructor/warmup)
            self._select(flat_g, step_num)
        gnorm = self._device_gnorm(grads)
        self._last_gnorm = gnorm
        if not np.isfinite(gnorm):
            # skip before anything moves: no state absorbed the bad step
            return params, True
        self._t_sel += 1
        self._selective_step(flat_p, flat_g, self._lr(step_num), gnorm)
        if (step_num + 1) % self.update_interval == 0:
            self._boundary(flat_p, flat_g, step_num)
        return params, False

    def _select(self, flat_g, step_num: int) -> None:
        self._idx = self._select_columns(flat_g)
        for t in (*self._msel.values(), *self._vsel.values()):
            t.zero_()
        self._t_sel = 0
        self._last_select = step_num

    @torch.no_grad()
    def _boundary(self, flat_p, flat_g, step_num) -> None:
        """Apply the accumulated unimportant gradients through the host
        Adam, re-synchronise masters and device params, and (only here,
        when both sides agree) reselect columns when due."""
        # host Adam over the accumulated (summed) unimportant grads; the
        # selected columns carry zero grad and are overwritten from the
        # device below
        host_grads, order = self._snapshot_grads(
            [(n, self._acc[n]) for n in self._sel_names])
        self._wait_d2h()
        lr = self._lr(step_num)
        self.adam.step_count += 1
        for sk in order:
            if self.swapper is not None:  # nvme moments tier
                m = self.swapper.swap_in(sk + ".m")
                v = self.swapper.swap_in(sk + ".v")
            else:
                m, v = self.m[sk], self.v[sk]
            self.adam.step(self.master[sk].view(-1), host_grads[sk].view(-1),
                           m.reshape(-1), v.reshape(-1), lr=lr,
                           increment=False)
            if self.swapper is not None:
                self.swapper.swap_out(sk + ".m", m)
                self.swapper.swap_out(sk + ".v", v)
        if self.swapper is not None:
            self.swapper.wait()
        for n in self._sel_names:
            p = flat_p[n]
            keep = torch.zeros(p.shape[-1], dtype=torch.bool,
                               device=self.device)
            keep[self._idx[n]] = True
            master = self.master[f"{n}#0"].to(self.device)
            p.copy_(torch.where(keep, p, master.to(p.dtype)))
        # refresh the masters so both column sets are current on the host
        for n in (*self._sel_names, *self._full_names):
            self.master[f"{n}#0"].copy_(flat_p[n])
        for t in self._acc.values():
            t.zero_()
        if step_num + 1 - self._last_select >= self.select_interval:
            self._select(flat_g, step_num + 1)

    # ---- checkpoint ---------------------------------------------------
    def state_dict(self):
        out = self._state_dict_base()
        out["zf/t_sel"] = np.int64(self._t_sel)
        out["zf/last_select"] = np.int64(self._last_select)

        def host(t):
            return t.detach().cpu().numpy()

        for n in self._sel_names:
            if self._idx is not None:
                out["zf/idx/" + n] = host(self._idx[n]).astype(np.int32)
            out["zf/msel/" + n] = host(self._msel[n])
            out["zf/vsel/" + n] = host(self._vsel[n])
            out["zf/acc/" + n] = host(self._acc[n])
        for n in self._full_names:
            out["zf/mfull/" + n] = host(self._mfull[n])
            out["zf/vfull/" + n] = host(self._vfull[n])
        return out

    def load_state_dict(self, sd):
        zf = {k: v for k, v in sd.items() if k.startswith("zf/")}
        super().load_state_dict({k: v for k, v in sd.items()
                                 if not k.startswith("zf/")})
        self._t_sel = int(zf.pop("zf/t_sel", 0))
        self._last_select = int(zf.pop("zf/last_select", 0))
        idx = {}
        for key, val in zf.items():
            _, kind, name = key.split("/", 2)
            t = torch.from_numpy(np.array(val)).to(self.device)
            if kind == "idx":
                idx[name] = t.long()
            else:
                getattr(self, "_" + kind)[name] = t.float()
        self._idx = idx or None

