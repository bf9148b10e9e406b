"""Measured-best mesh persistence, the ``mesh: "auto"`` backing store
(counterpart of ``deepspeed_tpu/autotuning/mesh_store.py``).

The mesh autotuner measures candidate shapes and records the winner keyed by
``(model signature, world size, device kind, zero stage)``; an engine config
that says ``"mesh": "auto"`` then adopts the measured-best shape for *this*
model on *this* hardware under *this* sharding regime without re-tuning —
a shape tuned at stage 3 (where the fsdp gather dominates) must not leak
into a stage-0 run whose best shape is pure dp. Cache misses fall back to
the cost model's top prediction (calibrated from the bench ledger when
scaling curves exist) — never to a silent re-measure at engine init. The
port's config still refuses ``mesh: "auto"`` (ROADMAP section 1, "Mesh,
ZeRO and tensor parallelism"); the serving warm-start cache keys on
:func:`winner_key`.

File format (one JSON object)::

    {"schema": 1,
     "winners": {"<sig>|w<world>|<device_kind>|z<stage>": {
         "mesh": {"fsdp": 4, "tp": 2}, "metric": 1234.5,
         "metric_name": "samples_per_sec", "source": "measured",
         "iso_time": "..."}}}

Writes are atomic (tempfile + rename) so concurrent tuners cannot tear the
store; last writer wins, which is correct for a cache of measurements.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.parallel.cost_model import (CostModel,
                                                     ModelProfile,
                                                     calibrated_cost_model,
                                                     enumerate_meshes,
                                                     model_signature)
from deepspeed_tpu_torch.utils.logging import log_dist

STORE_SCHEMA = 1
_DEFAULT_STORE = os.path.join(tempfile.gettempdir(),
                              "dstpu_mesh_winners.json")


def store_path(explicit: Optional[str] = None) -> str:
    return (explicit or os.environ.get("DSTPU_MESH_CACHE") or _DEFAULT_STORE)


def winner_key(sig: str, world: int, device_kind: str,
               zero_stage: int = 0) -> str:
    return f"{sig}|w{int(world)}|{device_kind}|z{int(zero_stage)}"


class WinnerStore:
    """Tiny JSON winner cache with atomic writes."""

    def __init__(self, path: Optional[str] = None):
        self.path = store_path(path)

    def _load(self) -> Dict[str, Any]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                data = json.load(f)
            if isinstance(data, dict) and data.get("schema") == STORE_SCHEMA \
                    and isinstance(data.get("winners"), dict):
                return data
        except (OSError, json.JSONDecodeError):
            pass
        return {"schema": STORE_SCHEMA, "winners": {}}

    def get(self, sig: str, world: int, device_kind: str,
            zero_stage: int = 0) -> Optional[Dict[str, Any]]:
        return self._load()["winners"].get(
            winner_key(sig, world, device_kind, zero_stage))

    def put(self, sig: str, world: int, device_kind: str,
            mesh: Dict[str, int], metric: float,
            metric_name: str = "samples_per_sec",
            source: str = "measured",
            zero_stage: int = 0) -> Dict[str, Any]:
        data = self._load()
        rec = {"mesh": {k: int(v) for k, v in mesh.items() if int(v) > 1},
               "metric": float(metric), "metric_name": metric_name,
               "source": source,
               "iso_time": time.strftime("%Y-%m-%dT%H:%M:%S")}
        data["winners"][winner_key(sig, world, device_kind, zero_stage)] = rec
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(data, f, indent=1)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return rec


def device_kind(device=None) -> str:
    """The device kind a winner is keyed by: the card's name
    (``torch.cuda.get_device_name``) for a CUDA device, ``"cpu"`` for the
    CPU. ``device`` defaults to the card when there is one."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def resolve_auto_axis_sizes(n_devices: int,
                            profile: Optional[ModelProfile],
                            winner_cache: Optional[str] = None,
                            kind: Optional[str] = None,
                            cost_model: Optional[CostModel] = None,
                            zero_stage: int = 0,
                            micro_batch: int = 1) -> Dict[str, int]:
    """The ``mesh: "auto"`` resolution ladder: measured winner → cost-model
    top prediction → all-dp. Returns axis_sizes for :func:`build_mesh`.
    ``zero_stage`` / ``micro_batch`` are the engine config's actual values
    — the fallback ranking must weigh the fsdp param gather and overhead
    amortization the way the real run will, not under defaults."""
    if n_devices <= 1:
        return {"dp": max(1, int(n_devices))}
    if profile is None:
        log_dist("mesh=auto: model not introspectable; falling back to "
                 f"dp={n_devices}")
        return {"dp": n_devices}
    sig = model_signature(profile)
    kind = kind or device_kind()
    rec = WinnerStore(winner_cache).get(sig, n_devices, kind,
                                        zero_stage=zero_stage)
    if rec and rec.get("mesh") is not None:
        log_dist(f"mesh=auto: adopting measured winner {rec['mesh']} "
                 f"({rec.get('metric', 0):.1f} {rec.get('metric_name', '')}"
                 f" on {kind}, w={n_devices})")
        return dict(rec["mesh"]) or {"dp": n_devices}
    cm = cost_model or calibrated_cost_model()
    cands = enumerate_meshes(n_devices, profile)
    if not cands:
        return {"dp": n_devices}
    ranked = cm.rank_by_throughput(profile, cands, zero_stage=zero_stage,
                                   micro_batch=micro_batch)
    best = ranked[0][0] or {"dp": n_devices}
    log_dist(f"mesh=auto: no measured winner for ({sig}, w={n_devices}, "
             f"{kind}); adopting cost-model prediction {best} "
             f"(calibrated_from={cm.bw.calibrated_from} ledger points)")
    return best
