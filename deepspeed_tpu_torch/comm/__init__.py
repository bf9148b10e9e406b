"""Collective communication (counterpart of ``deepspeed_tpu/comm``).

Ported so far: the comms logger (:mod:`~deepspeed_tpu_torch.comm.logger`),
which the training engine reads for its ``train/comm_ms`` gauge. The
collectives themselves (``comm/comm.py``) come with meshes (ROADMAP section
1, "Mesh, ZeRO and tensor parallelism"); on one device no host collective
runs, so the logger records nothing.
"""

from deepspeed_tpu_torch.comm.logger import (CommsLogger,  # noqa: F401
                                             comms_logger, timed_op)

__all__ = ["comms_logger"]
