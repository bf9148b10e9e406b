"""Checkpoint save/load of the training engine (counterpart of
``deepspeed_tpu/runtime/checkpoint.py``).

The reference's on-disk contract, with a PyTorch payload in place of Orbax:

* a tag directory ``<save_dir>/global_step{N}`` (or the caller's tag) and a
  ``latest`` pointer file, written atomically and only once the data is
  durable (fsync'd), so a crash mid-save leaves the previous tag resumable;
* ``meta.json`` with the reference's keys (``global_steps``,
  ``global_samples``, ``micro_steps``, ``skipped_steps``, ``zero_stage``,
  ``mesh_axes`` -- every axis 1 on one device -- ``client_state`` and
  ``lr_scheduler``);
* the payload under ``<tag>/state/``: one file per tree -- ``params.pt``,
  ``opt_state.pt``, ``scaler.pt`` -- each a flat dict of CPU tensors keyed
  by the ``/``-joined leaf path (the names :func:`consolidate_to_fp32`
  returns; the optimizer's moments as ``mu/<leaf path>``, its update count
  as ``count``), written with ``torch.save`` and read back with
  ``torch.load(weights_only=True)``: no pickled objects. Every leaf
  round-trips bit for bit.

* with the offload optimizer (``engine._offload``), its host tier as
  ``<tag>/host_optimizer.npz`` with the reference's keys (``step``,
  ``master/<path>``, ``m/<path>``, ``v/<path>``; ZenFlow's ``zf/*`` too),
  so either package reads the other's by name; the device
  ``opt_state.pt`` is then empty, as the reference's is.

``checkpoint.async_save`` keeps the reference's split: the device-to-host
copy happens in the caller, the file writes and the ``latest`` commit on a
non-daemon thread; :func:`finalize_pending` joins it and re-raises its
error. The caller's stage also copies the host optimizer tier: the next
step's C++ Adam writes the masters and moments in place. :func:`consolidate_to_fp32` and :func:`save_16bit_model` write
``.npz`` files under the reference's names, so either package reads the
other's by name.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import log_dist, logger

LATEST_FILE = "latest"
STATE_DIR = "state"
HOST_OPTIMIZER_FILE = "host_optimizer.npz"
TREES = ("params", "opt_state", "scaler")

__all__ = ["HOST_OPTIMIZER_FILE", "LATEST_FILE", "consolidate_to_fp32", "finalize_pending",
           "flatten_tree", "load_checkpoint", "load_params_only",
           "read_latest_tag", "save_16bit_model", "save_checkpoint",
           "unflatten_tree", "write_latest_atomic"]


def _tag_dir(save_dir: str, tag: str) -> str:
    return os.path.abspath(os.path.join(save_dir, tag))


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested dict as ``{"a/b/c": leaf}``, in insertion order (the
    reference's ``tree_flatten_with_path`` names)."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_tree`."""
    tree: Dict[str, Any] = {}
    for name, leaf in flat.items():
        node = tree
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def write_latest_atomic(save_dir: str, tag: str) -> None:
    """Atomically point ``latest`` at ``tag``: a crash mid-write can never
    leave a truncated/empty pointer, so readers see either the old committed
    tag or the new one."""
    from deepspeed_tpu_torch.utils.io import atomic_write_text

    atomic_write_text(os.path.join(os.path.abspath(save_dir), LATEST_FILE),
                      tag)


def finalize_pending(engine) -> None:
    """Block until an in-flight async save commits (and its ``latest`` is
    written), re-raising the commit thread's error. ``latest`` only ever
    points at a fully written checkpoint, so a crash mid-async-save leaves
    the previous checkpoint resumable."""
    pending = getattr(engine, "_pending_ckpt", None)
    if pending is None:
        return
    engine._pending_ckpt = None
    commit_thread, error_box = pending
    commit_thread.join()
    if error_box:
        raise error_box[0]


# ---- the engine's trees as flat dicts of host tensors -----------------------

def _to_host(t: torch.Tensor) -> torch.Tensor:
    # a copy even on the CPU: the engine updates its tensors in place
    return t.detach().to("cpu", copy=True)


def _leaf_names(engine) -> List[str]:
    return list(flatten_tree(engine.params))


def _host_state(engine) -> Dict[str, Dict[str, torch.Tensor]]:
    """The device-to-host copy of the three trees."""
    names = _leaf_names(engine)
    opt: Dict[str, torch.Tensor] = {}
    for key, val in engine.opt_state.items():
        if isinstance(val, list):           # per-leaf moments, leaf order
            if val and len(val) != len(names):
                raise ValueError(f"optimizer state {key!r} has {len(val)} "
                                 f"leaves, the params {len(names)}")
            for name, t in zip(names, val):
                opt[f"{key}/{name}"] = _to_host(t)
        else:                               # the update count
            opt[key] = torch.tensor(int(val), dtype=torch.int64)
    scaler = engine.scaler_state
    return {
        "params": {n: _to_host(t)
                   for n, t in flatten_tree(engine.params).items()},
        "opt_state": opt,
        "scaler": {"scale": torch.tensor(float(scaler["scale"]),
                                         dtype=torch.float64),
                   "good_steps": torch.tensor(int(scaler["good_steps"]),
                                              dtype=torch.int64)},
    }


def _write_tree(path: str, flat: Dict[str, torch.Tensor]) -> None:
    with open(path, "wb") as f:
        torch.save(flat, f)
        f.flush()
        os.fsync(f.fileno())


def _host_optimizer_state(engine, copy: bool) -> Optional[Dict[str, Any]]:
    """The offload optimizer's state dict (None without one). ``copy``: own
    arrays, not views of the buffers the next step's Adam writes."""
    off = getattr(engine, "_offload", None)
    if off is None:
        return None
    sd = off.state_dict()
    return {k: np.array(v, copy=True) for k, v in sd.items()} if copy else sd


def _write_npz(path: str, arrays: Dict[str, Any]) -> None:
    with open(path, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())


def _read_tree(tag_dir: str, tree: str, device) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.join(tag_dir, STATE_DIR, f"{tree}.pt"),
                      map_location=device, weights_only=True)


def _meta(engine, client_state: Optional[Dict]) -> Dict[str, Any]:
    from deepspeed_tpu_torch.parallel.cost_model import MESH_AXES

    sched = engine.lr_scheduler
    return {
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "micro_steps": engine.micro_steps,
        "skipped_steps": engine.skipped_steps,
        "zero_stage": engine.zero_stage,
        "mesh_axes": {ax: 1 for ax in MESH_AXES},
        "client_state": client_state or {},
        "lr_scheduler": (sched.state_dict()
                         if hasattr(sched, "state_dict") else None),
    }


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict] = None,
                    write_latest: bool = True) -> str:
    """Write a tagged checkpoint + ``latest`` pointer.

    ``latest`` is written only after the data is durably committed --
    immediately for sync saves, from the commit thread for async saves --
    and any prior in-flight async save is finalized first so IO errors are
    never silently dropped. ``write_latest=False`` leaves the pointer to a
    caller that interposes its own commit step (the resilience
    ``CheckpointManager`` writes a manifest first, then moves ``latest``).
    """
    finalize_pending(engine)
    tag = tag or f"global_step{engine.global_steps}"
    path = _tag_dir(save_dir, tag)
    state_dir = os.path.join(path, STATE_DIR)
    os.makedirs(state_dir, exist_ok=True)
    async_save = bool(engine.config.checkpoint.async_save)
    host = _host_state(engine)     # synchronous device -> host copy
    # the host optimizer tier lives outside the device trees; an async
    # save copies it now, before the next step's Adam writes it in place
    host_opt = _host_optimizer_state(engine, copy=async_save)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(_meta(engine, client_state), f, indent=2, default=str)

    def _write():
        for tree in TREES:
            _write_tree(os.path.join(state_dir, f"{tree}.pt"), host[tree])
        if host_opt is not None:
            _write_npz(os.path.join(path, HOST_OPTIMIZER_FILE), host_opt)
        if write_latest:
            write_latest_atomic(save_dir, tag)

    if async_save:
        import atexit
        import weakref

        error_box: list = []

        def _commit():
            try:
                _write()
                log_dist(f"committed async checkpoint {path}")
            except Exception as e:  # re-raised to the caller by finalize_pending
                error_box.append(e)
                logger.exception(f"async checkpoint commit failed for {path}")

        # non-daemon: interpreter exit joins the thread, so the final save of
        # a run always gets its 'latest' pointer; atexit additionally
        # surfaces commit errors if the user never saves/loads again
        t = threading.Thread(target=_commit, daemon=False, name="ckpt-commit")
        t.start()
        engine._pending_ckpt = (t, error_box)
        ref = weakref.ref(engine)
        atexit.register(lambda: finalize_pending(ref()) if ref() else None)
    else:
        _write()
    log_dist(f"saved checkpoint {path} (async={async_save})")
    return path


def read_latest_tag(load_dir: str) -> Optional[str]:
    p = os.path.join(load_dir, LATEST_FILE)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return f.read().strip()


@torch.no_grad()
def _copy_into(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"checkpoint leaf {name}: {tuple(src.shape)} "
                         f"{src.dtype} does not fit the engine's "
                         f"{tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def _restore_params(engine, flat: Dict[str, torch.Tensor]) -> None:
    mine = flatten_tree(engine.params)
    if set(flat) != set(mine):
        raise ValueError(f"checkpoint params {sorted(set(flat) ^ set(mine))}"
                         " differ from the engine's")
    for name, leaf in mine.items():
        _copy_into(leaf, flat[name], name)


def _restore_opt_state(engine, flat: Dict[str, torch.Tensor]) -> None:
    names = _leaf_names(engine)
    want = set()
    for key, val in engine.opt_state.items():
        if not isinstance(val, list):
            want.add(key)
        elif val:
            want.update(f"{key}/{n}" for n in names)
    if set(flat) != want:
        raise ValueError(f"checkpoint optimizer state "
                         f"{sorted(set(flat) ^ want)[:5]} differs from the "
                         "engine's optimizer")
    for key, val in engine.opt_state.items():
        if isinstance(val, list):
            for name, t in zip(names, val):
                _copy_into(t, flat[f"{key}/{name}"], f"{key}/{name}")
        else:
            engine.opt_state[key] = int(flat[key])


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True):
    """Restore into the engine's own tensors, on its device. Returns
    ``(path, client_state)``, or ``(None, {})`` without a ``latest``."""
    finalize_pending(engine)
    tag = tag or read_latest_tag(load_dir)
    if tag is None:
        logger.warning(f"no 'latest' file in {load_dir}; nothing restored")
        return None, {}
    path = _tag_dir(load_dir, tag)
    _restore_params(engine, _read_tree(path, "params", engine.device))
    scaler = _read_tree(path, "scaler", "cpu")
    engine.scaler_state = {"scale": float(scaler["scale"]),
                           "good_steps": int(scaler["good_steps"])}
    if load_optimizer_states:
        _restore_opt_state(engine, _read_tree(path, "opt_state",
                                              engine.device))
        host_path = os.path.join(path, HOST_OPTIMIZER_FILE)
        if getattr(engine, "_offload", None) is not None \
                and os.path.exists(host_path):
            with np.load(host_path) as z:
                engine._offload.load_state_dict(dict(z))
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        engine.global_steps = int(meta.get("global_steps", 0))
        engine.global_samples = int(meta.get("global_samples", 0))
        engine.micro_steps = int(meta.get("micro_steps", 0))
        engine.skipped_steps = int(meta.get("skipped_steps", 0))
        if meta.get("lr_scheduler") and hasattr(engine.lr_scheduler,
                                                "load_state_dict"):
            engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
    log_dist(f"loaded checkpoint {path}")
    return path, meta.get("client_state", {})


def _resolve_tag(load_dir: str, tag: Optional[str]) -> str:
    tag = tag or read_latest_tag(load_dir)
    if tag is None:
        raise FileNotFoundError(f"no checkpoint 'latest' tag under {load_dir}")
    return tag


def consolidate_to_fp32(load_dir: str, tag: Optional[str] = None,
                        output_file: Optional[str] = None
                        ) -> Dict[str, np.ndarray]:
    """The checkpoint's params as a flat fp32 host dict keyed by the
    ``/``-joined leaf path (``zero_to_fp32.py`` parity); ``output_file``
    also writes it as ``.npz``. Works offline -- no engine required."""
    flat = _read_tree(_tag_dir(load_dir, _resolve_tag(load_dir, tag)),
                      "params", "cpu")
    out = {name: t.float().numpy() for name, t in flat.items()}
    if output_file:
        np.savez(output_file, **out)
        log_dist(f"wrote consolidated fp32 state to {output_file}")
    return out


def load_params_only(load_dir: str, tag: Optional[str] = None,
                     device="cpu") -> Dict[str, Any]:
    """Just the parameter tree of an engine checkpoint, on ``device`` -- the
    ``init_inference(checkpoint=...)`` loading surface. Offline: no
    engine."""
    flat = _read_tree(_tag_dir(load_dir, _resolve_tag(load_dir, tag)),
                      "params", device)
    return unflatten_tree(flat)


def save_16bit_model(engine, save_dir: str,
                     filename: str = "model_fp16.npz") -> str:
    """Consolidated 16-bit export of the engine's params (``.npz`` has no
    bf16; fp16 is the portable 16-bit container, as in the reference)."""
    os.makedirs(save_dir, exist_ok=True)
    out = os.path.join(save_dir, filename)
    flat = {name: t.detach().to("cpu", torch.float32).numpy()
            .astype(np.float16)
            for name, t in flatten_tree(engine.params).items()}
    np.savez(out, **flat)
    return out
