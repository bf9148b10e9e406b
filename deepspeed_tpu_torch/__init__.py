"""deepspeed_tpu_torch: the PyTorch/CUDA port of ``deepspeed_tpu`` for one
NVIDIA H100 (Hopper, ``sm_90a``).

The package mirrors ``deepspeed_tpu``'s layout so each module has an obvious
counterpart, and never imports JAX or ``deepspeed_tpu``. Every TPU (Pallas)
kernel on a ported path is a hand-written CUDA kernel here, built at first
use from ``csrc/``, with a plain PyTorch version beside it. Entry points run
on the card unless a caller passes ``device="cpu"``.

Ported so far, all on one device:
- the serving paths of ``InferenceEngineV2``: the packed paged engine (bf16,
  int8 or int4 weights and KV pool; greedy or sampled ``decode_batch``; the
  radix prefix cache with host / NVMe KV tiers, n-gram speculative
  decoding, pause / resume and durable export / adopt), the dense-tile
  ``packed=False`` engine over the same pool and the dense-cache
  ``paged=False`` engine;
- :func:`init_inference` and its v1 ``InferenceEngine`` (``forward``,
  ``generate`` with greedy, temperature, top-k and top-p sampling);
- the training path of :func:`initialize` (fp32 master weights, bf16 or
  fp32 compute, flash attention forward and backward on the card), with
  engine checkpoints (``runtime/checkpoint.py``), the resilience layer
  (``resilience/``: checkpoint manager, step guard, retries, coordinator,
  heartbeat watchdog), ``runtime/sanity.py`` and ``utils/tensor_fragment``;
  :func:`init_inference` serves an engine checkpoint; ZeRO-Offload
  (``offload/``: the optimizer's fp32 masters and Adam moments on the
  host or NVMe, updated by the host C++ loop, with ZenFlow's overlapped
  step and top-k split);
- the op-builder registry (``ops.get_op_builder``: flash attention, the
  fused RMSNorm, the ``async_io`` library of the NVMe swapper,
  ``offload.swap``, and the ``cpu_adam`` host optimizer library) and the card's measured memory rates
  (``tools.hbm_bandwidth``).
Every TPU kernel of the reference has a hand-written counterpart here.
"""

from deepspeed_tpu_torch.inference import (CapacityError,  # noqa: F401
                                           InferenceEngineV2)
from deepspeed_tpu_torch.models import (TransformerConfig,  # noqa: F401
                                        TransformerLM, get_preset)

__version__ = "0.2.0"


def initialize(model=None, config=None, model_parameters=None,
               training_data=None, lr_scheduler=None, device="cuda",
               collate_fn=None):
    """Build the training engine (counterpart of
    ``deepspeed_tpu.initialize``).

    Args:
        model: an object with ``init(seed, device) -> params`` and
            ``loss_fn(params, batch) -> loss`` (e.g. :class:`TransformerLM`).
        config: dict, path to a JSON file, or a ``DeepSpeedTpuConfig``.
        model_parameters: optional parameter tree (tensors or numpy arrays,
            e.g. from :mod:`deepspeed_tpu_torch.bridge`) to start from
            instead of ``model.init(config.seed)``; the engine copies it.
        training_data: optional dataset for the engine-managed data loader.
        lr_scheduler: optional schedule fn ``step -> lr`` (overrides the
            config's scheduler).
        device: ``"cuda"`` (default) or ``"cpu"`` for the plain versions.

    Returns:
        ``(engine, optimizer, training_dataloader, lr_scheduler)``, the
        reference's 4-tuple.
    """
    from deepspeed_tpu_torch.config import from_config
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedTpuEngine

    engine = DeepSpeedTpuEngine(
        model=model, config=from_config(config),
        model_parameters=model_parameters, training_data=training_data,
        lr_scheduler=lr_scheduler, collate_fn=collate_fn, device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def init_inference(model=None, config=None, checkpoint=None, dtype=None,
                   **kwargs):
    """Build the v1 inference engine (counterpart of
    ``deepspeed_tpu.init_inference``): ``kwargs`` go to
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
    (``params``, ``max_seq_len``, ``device``, the card unless ``"cpu"``).
    ``dtype="int8"``/``"int4"`` serves quantized weights (kernels G/H);
    ``config`` goes through :func:`~deepspeed_tpu_torch.config.from_config`
    (a mesh axis above 1 raises there).

    ``checkpoint`` names an engine checkpoint directory (written by the
    training engine's ``save_checkpoint``; pass the ``model``): its params
    load onto the engine's device. A HuggingFace checkpoint directory
    (``config.json`` + safetensors) is not ported yet and raises."""
    import os

    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    if checkpoint is not None and "params" not in kwargs:
        if os.path.exists(os.path.join(checkpoint, "config.json")):
            raise NotImplementedError(
                "init_inference(checkpoint=<HF checkpoint dir>) is not "
                "ported yet: it needs models/hf.py (ROADMAP section 1, "
                '"Remainder"); engine checkpoint dirs load')
        if model is None:
            raise ValueError(
                "init_inference(checkpoint=<engine checkpoint>) needs "
                "the model; only HF checkpoint dirs are self-describing")
        from deepspeed_tpu_torch.runtime.checkpoint import load_params_only
        from deepspeed_tpu_torch.utils import resolve_device

        kwargs["params"] = load_params_only(
            checkpoint, device=resolve_device(kwargs.get("device", "cuda")))
    return InferenceEngine(model=model, config=config, dtype=dtype, **kwargs)
