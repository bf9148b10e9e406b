"""The data-efficiency pipeline (counterpart of
``deepspeed_tpu/runtime/data_pipeline/``): the curriculum scheduler, the
curriculum-aware sampler, the memory-mapped indexed dataset, the
sequence-parallel loader adapter and token-budget batches with their LR
rule. Host-side numpy throughout: the engine truncates batches to the
curriculum's difficulty before they reach the device."""

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum import CurriculumScheduler  # noqa: F401
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampler import (  # noqa: F401
    DataEfficiencySampler,
)
from deepspeed_tpu_torch.runtime.data_pipeline.indexed_dataset import (  # noqa: F401
    MMapIndexedDataset, MMapIndexedDatasetBuilder,
)
from deepspeed_tpu_torch.runtime.data_pipeline.sp_dataloader import (  # noqa: F401
    SPDataLoaderAdapter,
)
from deepspeed_tpu_torch.runtime.data_pipeline.variable_batch import (  # noqa: F401
    VariableBatchDataLoader, VariableBatchLRSchedule, batch_by_tokens,
    lr_scale_for_batch,
)
