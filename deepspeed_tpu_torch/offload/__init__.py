"""Host and NVMe offload (counterpart of ``deepspeed_tpu/offload``): the
async tensor swapper over the native AIO library."""

from deepspeed_tpu_torch.offload.swap import (  # noqa: F401
    AsyncTensorSwapper, PinnedBuffer, PinnedBufferPool, SwapTicket)
