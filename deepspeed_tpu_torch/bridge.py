"""Weight bridge: the JAX package's parameter tree, as numpy arrays, into the
port's parameters.

The port keeps the JAX tree and orientation unchanged -- ``embed.tokens
[V, D]``, optional ``embed.pos [max_seq, D]``, stacked ``layers.{ln1,ln2}
.scale [L, D]`` (and ``.bias`` for layernorm), ``layers.attn.w{q,k,v,o}
[L, Din, Dout]`` with optional biases, ``layers.mlp.w_{gate,up,down}``
(``b_up``/``b_down``), ``final_norm`` and an optional ``lm_head [D, V]`` --
so every matmul weight stays ``[Din, Dout]`` and the model computes
``x @ w``: nothing is transposed. Leaves keep their dtype (bfloat16 arrays
from ``ml_dtypes`` and int8 arrays included); the engine later casts fp32
leaves to the compute dtype, as the reference's ``_serve_cast`` does.

A quantized tree bridges whole: any object with ``packed``, ``scales``,
``bits`` and ``din`` attributes (the reference's ``QuantizedWeight`` after
``jax.device_get``, matched by its attributes, not its class) becomes the
port's :class:`~deepspeed_tpu_torch.models.transformer.QuantizedWeight`, and
a paged cache dict carries its int8 pools and ``kv_scale`` like any leaf, as
a dense cache dict (``init_kv_cache``: ``k``/``v`` ``[L, B, S, K, d]`` and
the int32 ``pos``) carries its three.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":            # ml_dtypes: no numpy bridge
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if not arr.flags.writeable:                 # e.g. jax.device_get output
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def params_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays (e.g. ``jax.device_get(params)``) -> the
    same nested dict of tensors on ``device`` (the card unless the caller
    asks for the CPU; raises where there is no card)."""
    from deepspeed_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if all(hasattr(tree, a) for a in ("packed", "scales", "bits", "din")):
        from deepspeed_tpu_torch.models.transformer import QuantizedWeight

        return QuantizedWeight(_leaf(tree.packed, device),
                               _leaf(tree.scales, device), int(tree.bits),
                               int(tree.din))
    return _leaf(tree, device)
