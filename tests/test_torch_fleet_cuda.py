"""The elastic fleet on the card: the four drills of
``deepspeed_tpu_torch/tools/elastic_drill.py`` on a ``tiny`` model (256
wide, 4 heads of 64, bf16) with int4 weights and an int8 pool, every
replica built through one ``WarmStartCache``; each drill holds its
invariants, and the replicas' steps launch kernels G/H and A/B over the
int8 pool (their launch counters). Marked ``cuda``, skipped without a
card. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_fleet_cuda.py
"""

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", ["replica-crash-mid-storm",
                                      "burst-autoscale", "rolling-swap",
                                      "cold-start-bench"])
def test_elastic_drill_on_the_card(scenario, cuda_device, tmp_path):
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.tools.elastic_drill import Setup, run_scenario

    _build.reset_counts()
    verdict = run_scenario(scenario, workdir=str(tmp_path), setup=Setup(
        device="cuda", weight_dtype="int4", kv_dtype="int8"))
    assert verdict["ok"], verdict
    counts = {k: v.launches for k, v in _build.KERNELS.items()}
    for k in ("qmm_stacked", "paged_decode_int8"):
        assert counts[k] > 0, counts
    if scenario == "cold-start-bench":
        d = verdict["details"]
        assert d["warm_tree_equals_published"]
        assert d["cold_start_ms"] > 0 and d["warm_start_ms"] > 0
