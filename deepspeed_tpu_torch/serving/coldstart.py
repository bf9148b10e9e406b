"""Fast cold start for serving replicas: AIO-streamed weights and a reused
model module (counterpart of ``deepspeed_tpu/serving/coldstart.py``).

A cold replica build initializes (or loads) the full weight tree and, for a
quantized engine, quantizes it. :class:`WarmStartCache` skips that work
for a respawn:

* **weights** ride the AIO ticket path: each leaf of the served tree is
  persisted once (``publish``) through :class:`~deepspeed_tpu_torch.
  offload.swap.AsyncTensorSwapper` under a content key, and a respawn
  streams ALL leaves back with ONE batched ticket (``swap_in_start_many``:
  aligned segments in one pooled buffer, page-locked when the card is
  there) and uploads each leaf to the engine's device straight from that
  buffer. A quantized engine publishes its quantized tree, so a warm build
  skips the quantization too. The manifest records each leaf's tree path,
  shape and dtype (the reference's schema): a cache one package publishes
  loads in the other. bf16 leaves are stored as their 16-bit pattern and
  recorded as ``"bfloat16"``; a :class:`~deepspeed_tpu_torch.models.
  transformer.QuantizedWeight` is four leaves under ``q`` path steps
  (``packed``, ``scales``, ``bits``, ``din``).

* **the module**: the process-local module table is keyed like the mesh
  winner store -- ``winner_key(model_signature, world, device_kind)`` -- so
  one process serving two model shapes never cross-wires them, and the key
  doubles as the on-disk weight namespace. The reference reuses the module
  because its compiled programs hang off it. The port compiles nothing per
  engine (its kernels are built once into the build directory and loaded
  from there by every process), so ``executable_cache=True`` only logs
  that.

Every failure in the warm path (missing, torn or corrupt manifest or swap
file, injected ``weight_load_io_error``) falls back to the cold path with
a warning: a damaged cache never sinks a respawn.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.autotuning.mesh_store import (device_kind as
                                                       _device_kind)
from deepspeed_tpu_torch.autotuning.mesh_store import winner_key
from deepspeed_tpu_torch.models.transformer import QuantizedWeight
from deepspeed_tpu_torch.parallel.cost_model import (ModelProfile,
                                                     model_signature)
from deepspeed_tpu_torch.resilience.faults import get_injector
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["WarmStartCache", "evict_module", "warm_key"]

MANIFEST_SCHEMA = 1

# process-local module table: one module instance per warm key
_MODULES: Dict[str, Any] = {}

# the fields a QuantizedWeight flattens into (path steps of kind "q")
_QW_FIELDS = ("bits", "din", "packed", "scales")

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "bool": torch.bool}


def warm_key(model, world: Optional[int] = None,
             device_kind: Optional[str] = None) -> str:
    """The (model signature, world, device kind) cache key, the shape the
    mesh winner store uses, so one identity names a model's artifacts
    everywhere. ``world`` defaults to the cards torch sees (1 on a machine
    without one) and ``device_kind`` to the card's name (``"cpu"``
    without one)."""
    prof = ModelProfile.from_model(model)
    sig = (model_signature(prof) if prof is not None
           else f"model-{type(model).__name__}")
    if world is None:
        world = max(1, torch.cuda.device_count())
    if device_kind is None:
        device_kind = _device_kind()
    return winner_key(sig, world, device_kind, 0)


def evict_module(key: str) -> bool:
    """Drop the process-local module for ``key``. Only drills and tests
    need this, to measure a genuine cold build in a warm process."""
    return _MODULES.pop(key, None) is not None


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf's bytes are read as: bf16 (which numpy lacks
    without ``ml_dtypes``) as its 16-bit pattern."""
    return np.dtype(np.int16 if name == "bfloat16" else name)


def _torch_dtype(name: str) -> torch.dtype:
    if name in _TORCH_DTYPES:
        return _TORCH_DTYPES[name]
    return getattr(torch, np.dtype(name).name)


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and the dtype name the manifest records
    (a bf16 tensor as its 16-bit pattern, named ``bfloat16``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """Deterministic (path, leaf) pairs for a nested dict/list/tuple tree
    (the shape ``TransformerLM.init`` returns). Dict keys are sorted so
    publish and load enumerate leaves in the same order; a QuantizedWeight
    becomes its four fields under ``q`` steps."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], prefix + (("d", k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, prefix + (("i", i),)))
        return out
    if isinstance(tree, QuantizedWeight):
        return [(prefix + (("q", f),), getattr(tree, f)) for f in _QW_FIELDS]
    return [(prefix, tree)]


def _unflatten(pairs: List[Tuple[List, Any]]):
    """Rebuild the nested tree from manifest (path, leaf) pairs. Lists come
    back as lists (index steps), dicts as dicts, ``q`` steps as a
    QuantizedWeight."""
    if len(pairs) == 1 and not pairs[0][0]:
        return pairs[0][1]
    root: Dict = {}
    for path, leaf in pairs:
        node = root
        for step in path[:-1]:
            node = node.setdefault(tuple(step), {})
        node[tuple(path[-1])] = leaf

    def materialize(node):
        if not isinstance(node, dict):
            return node
        kinds = {k[0] for k in node}
        if kinds == {"i"}:
            return [materialize(node[("i", i)]) for i in range(len(node))]
        if kinds == {"q"}:
            return QuantizedWeight(node[("q", "packed")],
                                   node[("q", "scales")],
                                   int(node[("q", "bits")]),
                                   int(node[("q", "din")]))
        return {k[1]: materialize(v) for k, v in node.items()}

    return materialize(root)


class WarmStartCache:
    """Persisted weights and process-local modules for fast respawn.

    One instance per fleet; not thread-safe by design: the
    :class:`~deepspeed_tpu_torch.serving.fleet.FleetController` builds
    replicas from one control thread.
    """

    def __init__(self, cache_dir: str, swapper=None,
                 executable_cache: bool = False):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self._swapper = swapper          # lazy: the AIO library loads once
        self._reader = None              # page-locked reads for the card
        self.counters: Dict[str, int] = {
            "publishes": 0, "publish_failures": 0, "warm_loads": 0,
            "warm_load_failures": 0, "cold_builds": 0, "warm_builds": 0,
        }
        #: the last warm load: bytes streamed, ms to read them, ms of the
        #: read and the upload together
        self.last_load: Dict[str, float] = {}
        if executable_cache:
            logger.info("serving: executable_cache has nothing to persist "
                        "here: the kernels are built once into the build "
                        "directory, which every process loads")

    # ------------------------------------------------------------------
    # storage plumbing
    # ------------------------------------------------------------------
    def _swap(self):
        if self._swapper is None:
            from deepspeed_tpu_torch.offload.swap import AsyncTensorSwapper

            self._swapper = AsyncTensorSwapper(self.cache_dir,
                                               namespace="weights")
        return self._swapper

    def _read_swap(self, device: torch.device):
        """The swapper a load reads through: for a CUDA device one whose
        single cached buffer is page-locked, so each leaf uploads from it
        at the link's rate and the next warm load reuses it."""
        if device.type != "cuda":
            return self._swap()
        if self._reader is None:
            from deepspeed_tpu_torch.offload.swap import (AsyncTensorSwapper,
                                                          PinnedBufferPool)

            self._reader = AsyncTensorSwapper(
                self.cache_dir, namespace="weights",
                pool=PinnedBufferPool(max_cached=1, pin=True))
        return self._reader

    @staticmethod
    def _slug(key: str) -> str:
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def manifest_path(self, key: str) -> str:
        return os.path.join(self.cache_dir,
                            f"weights_{self._slug(key)}.json")

    def has_params(self, key: str) -> bool:
        return os.path.exists(self.manifest_path(key))

    def module_for(self, key: str):
        """The cached module instance, if any."""
        return _MODULES.get(key)

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------
    def publish(self, key: str, params) -> bool:
        """Persist a host copy of ``params`` for ``key``: every leaf goes
        through the AIO write path, then the manifest lands by atomic
        tempfile + rename -- a reader sees the COMPLETE manifest or none,
        and each leaf's size is re-checked at adopt time, so a torn or
        concurrent write degrades to a cold start, never a crash.
        Best-effort: returns False (with a warning) on any failure."""
        try:
            get_injector().on_weight_load("publish")
            sw = self._swap()
            slug = self._slug(key)
            leaves = []
            for i, (path, leaf) in enumerate(_flatten(params)):
                arr, dtype = _host_array(leaf)
                name = f"{slug}/leaf{i}"
                sw.swap_out(name, arr)
                leaves.append({"name": name, "path": [list(s) for s in path],
                               "shape": list(arr.shape), "dtype": dtype})
            sw.wait()                    # barrier: data durable before index
            manifest = {"schema": MANIFEST_SCHEMA, "key": key,
                        "leaves": leaves}
            mp = self.manifest_path(key)
            tmp = mp + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(manifest, f)
            os.replace(tmp, mp)
            self.counters["publishes"] += 1
            return True
        except Exception as e:           # never sink the build that served
            self.counters["publish_failures"] += 1
            logger.warning(f"serving: warm-weight publish for {key!r} "
                           f"failed: {e!r}")
            return False

    def load_params(self, key: str, device="cpu"):
        """Stream the persisted weights back as ONE batched AIO ticket and
        rebuild the tree of tensors on ``device``, each leaf copied once,
        from the ticket's buffer (before its release) to ``device``.
        Raises ``OSError`` / ``ValueError`` on a missing, torn or corrupt
        cache; callers fall back to the cold path."""
        get_injector().on_weight_load("warm")
        device = torch.device(device)
        t0 = time.perf_counter()
        with open(self.manifest_path(key), "r", encoding="utf-8") as f:
            manifest = json.load(f)
        if not (isinstance(manifest, dict)
                and manifest.get("schema") == MANIFEST_SCHEMA
                and isinstance(manifest.get("leaves"), list)
                and manifest.get("leaves")):
            raise ValueError(f"warm-weight manifest for {key!r} is not a "
                             f"schema-{MANIFEST_SCHEMA} leaf index")
        sw = self._read_swap(device)
        leaves = manifest["leaves"]
        for leaf in leaves:
            sw.adopt_meta(leaf["name"], leaf["shape"],
                          _storage_dtype(leaf["dtype"]))
        ticket, segments = sw.swap_in_start_many(
            [leaf["name"] for leaf in leaves])
        try:
            flat = ticket.wait()         # one pooled buffer, all segments
            read_ms = (time.perf_counter() - t0) * 1e3
            pairs = []
            for leaf in leaves:
                off, nbytes = segments[leaf["name"]]
                shape = [int(s) for s in leaf["shape"]]
                store = _storage_dtype(leaf["dtype"])
                n = nbytes // store.itemsize
                t = (torch.frombuffer(flat, dtype=_torch_dtype(store.name),
                                      count=n, offset=off) if n
                     else torch.empty(0, dtype=_torch_dtype(store.name)))
                t = t.reshape(shape)
                if leaf["dtype"] == "bfloat16":
                    t = t.view(torch.bfloat16)
                # the one copy: out of the loaned buffer, onto the device
                pairs.append((leaf["path"], t.to(device, copy=True)))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            ticket.release()
        self.last_load = {"bytes": float(ticket.nbytes), "read_ms": read_ms,
                          "ms": (time.perf_counter() - t0) * 1e3}
        self.counters["warm_loads"] += 1
        return _unflatten(pairs)

    # ------------------------------------------------------------------
    # the respawn path
    # ------------------------------------------------------------------
    def build_engine(self, key: str, model_factory: Callable[[], Any],
                     engine_kw: Optional[Dict] = None,
                     publish: bool = True):
        """Build an :class:`InferenceEngineV2` for ``key``: warm when both
        halves hit (cached module, manifest of the AIO weight stream), cold
        otherwise -- and a cold build publishes its served tree so the NEXT
        respawn is warm. Returns ``(engine, info)`` with ``info =
        {"source": "warm"|"cold", "ms": build_ms}`` (the card synchronised
        before the clock stops)."""
        from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
        from deepspeed_tpu_torch.utils import resolve_device

        kw = dict(engine_kw or {})
        device = resolve_device(kw.get("device", "cuda"))
        t0 = time.perf_counter()
        module = _MODULES.get(key)
        params = None
        if self.has_params(key):
            try:
                params = self.load_params(key, device=device)
            except (OSError, ValueError, KeyError) as e:
                self.counters["warm_load_failures"] += 1
                logger.warning(f"serving: warm weight load for {key!r} "
                               f"failed ({e!r}); falling back to cold "
                               f"start")
                params = None
        warm = module is not None and params is not None
        if module is None:
            module = model_factory()
        engine = InferenceEngineV2(module, params=params, **kw)
        _MODULES[key] = module
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        if warm:
            self.counters["warm_builds"] += 1
        else:
            self.counters["cold_builds"] += 1
            if publish and params is None:
                self.publish(key, engine.params)
        return engine, {"source": "warm" if warm else "cold",
                        "ms": round(ms, 1)}

    def report(self) -> Dict:
        return {"cache_dir": self.cache_dir,
                "cached_modules": len(_MODULES),
                "counters": dict(self.counters)}

    def close(self) -> None:
        """Release the swappers' native handles and buffers (idempotent)."""
        for sw in (self._swapper, self._reader):
            if sw is not None:
                sw.close()
        self._swapper = self._reader = None
