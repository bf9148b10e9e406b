"""Host and NVMe offload (counterpart of ``deepspeed_tpu/offload``): the
host C++ Adam (``cpu_adam``), the offloaded optimizer step with its NVMe
tier and ZenFlow's two modes (``optimizer``), and the async tensor swapper
over the native AIO library (``swap``). The engine routes its step here
when ``zero_optimization.offload_optimizer.device`` is ``cpu`` or
``nvme``."""

from deepspeed_tpu_torch.offload.cpu_adam import DeepSpeedCPUAdam  # noqa: F401
from deepspeed_tpu_torch.offload.swap import (  # noqa: F401
    AsyncTensorSwapper, PinnedBuffer, PinnedBufferPool, SwapTicket)
from deepspeed_tpu_torch.offload.optimizer import (  # noqa: F401
    HostOffloadOptimizer, ZenFlowSelectiveOptimizer)
