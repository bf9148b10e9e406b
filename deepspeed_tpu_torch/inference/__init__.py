"""Serving engine and its host-side bookkeeping (counterpart of
``deepspeed_tpu/inference``)."""

from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2  # noqa: F401
from deepspeed_tpu_torch.inference.ragged import (  # noqa: F401
    BlockedAllocator, CapacityError, PrefixCache, SequenceDescriptor,
    SequenceManager)
from deepspeed_tpu_torch.inference.speculative import ngram_draft  # noqa: F401
