"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu`` for one
NVIDIA H100 (Hopper, ``sm_90a``).

The package mirrors ``deepspeed_tpu``'s layout so each module has an obvious
counterpart, and never imports JAX or ``deepspeed_tpu``. Every TPU (Pallas)
kernel on a ported path is a hand-written CUDA kernel here, built at first
use from ``csrc/``, with a plain PyTorch version beside it. Entry points run
on the card unless a caller passes ``device="cpu"``.

Ported so far: the serving path of ``InferenceEngineV2`` (bf16 weights and
KV pool, one device, greedy decoding).
"""

from deepspeed_tpu_torch.inference import (CapacityError,  # noqa: F401
                                           InferenceEngineV2)
from deepspeed_tpu_torch.models import (TransformerConfig,  # noqa: F401
                                        TransformerLM, get_preset)

__version__ = "0.1.0"
