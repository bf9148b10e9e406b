"""Mixture-of-Experts on one device (counterpart of ``deepspeed_tpu/moe``):
top-k gating, the capacity and dropless grouped dispatch algebras
(:mod:`~deepspeed_tpu_torch.moe.sharded_moe`) and the AutoEP expert-load
tracker and placement planner (:mod:`~deepspeed_tpu_torch.moe.balancer`).
Expert parallelism waits for a mesh (ROADMAP section 1, "Mesh, ZeRO and
tensor parallelism")."""

from deepspeed_tpu_torch.moe.balancer import (  # noqa: F401
    ExpertLoadTracker, RebalancePlan, apply_placement, placement_tables,
    plan_rebalance,
)
from deepspeed_tpu_torch.moe.sharded_moe import (  # noqa: F401
    MOE_KERNELS, MoE, grouped_moe_mlp_block, moe_block_for, moe_kernel_support,
    moe_mlp_block, resolve_moe_kernel, set_expert_tracker, top1_gating,
    topk_gating,
)
