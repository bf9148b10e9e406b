"""Autotuning (counterpart of ``deepspeed_tpu/autotuning``). Ported so far:
the measured-best mesh store (``mesh_store.py``) that the serving
warm-start cache keys on; the tuner and its scheduler are ROADMAP section
1, "Mesh, ZeRO and tensor parallelism"."""

from deepspeed_tpu_torch.autotuning.mesh_store import (  # noqa: F401
    WinnerStore, device_kind, resolve_auto_axis_sizes,
)
