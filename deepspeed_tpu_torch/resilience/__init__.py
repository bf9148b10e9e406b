"""Resilience layer (counterpart of ``deepspeed_tpu/resilience``).

Ported so far: :mod:`~deepspeed_tpu_torch.resilience.faults`, the
deterministic fault injector whose sites the serving engine, the KV tier
store and the NVMe swapper consult. The retry policy, the checkpoint
manager, the step guard, the coordinator and the heartbeat watchdog are not
ported yet (ROADMAP section 1, "The rest of training").
"""

from deepspeed_tpu_torch.resilience.faults import (FaultInjector, FaultSpec,
                                                   InjectedCrash,
                                                   InjectedIOError,
                                                   get_injector, set_injector,
                                                   tear_checkpoint_dir)

__all__ = ["FaultInjector", "FaultSpec", "InjectedCrash", "InjectedIOError",
           "get_injector", "set_injector", "tear_checkpoint_dir"]
