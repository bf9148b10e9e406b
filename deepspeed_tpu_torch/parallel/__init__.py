"""Parallelism (counterpart of ``deepspeed_tpu/parallel``). Ported so far:
the analytic mesh cost model, which the serving warm-start cache and the
mesh winner store key on. The device mesh, sharding and ZeRO++ are ROADMAP
section 1, "Mesh, ZeRO and tensor parallelism"."""

from deepspeed_tpu_torch.parallel.cost_model import (  # noqa: F401
    MESH_AXES,
    CostModel,
    LinkBandwidths,
    ModelProfile,
    collective_volumes,
    enumerate_meshes,
    fit_bandwidths,
    model_signature,
    rank_meshes,
)
