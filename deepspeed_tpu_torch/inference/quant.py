"""Serving-time weight quantization (counterpart of
``deepspeed_tpu/inference/quant.py``).

The engine swaps the big matmul leaves of the layer stack, and an int copy
of the LM head, for packed :class:`~deepspeed_tpu_torch.models.transformer.
QuantizedWeight` nodes; every forward path reaches them through the model's
``linear()`` seam and runs the fused dequant-matmul kernels G/H
(``ops/quant_matmul.py``), reading 2x (int8) / 4x (int4) fewer weight bytes
per decode step. The embedding gather keeps the table in the compute dtype:
it reads B rows a step, not all of [V, D].
"""

from __future__ import annotations

import torch

QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "wqkv", "w_gateup")


def quantize_serving_params(params, cfg, bits: int):
    """``params`` (already in the compute dtype) with the quantizable leaves
    replaced; new dicts along the touched paths, the caller's tree is left
    as it was. q/k/v and gate|up are fused first (``wqkv``, ``w_gateup``:
    one product instead of three / two), then each stacked leaf whose dims
    are multiples of 128 is quantized layer by layer with per-128-row-group
    scales kept in the compute dtype; other leaves stay dense. The head is
    quantized from ``embed.tokens.T`` (tied: the table stays for the
    gather) or ``lm_head`` (untied: the dense head is dropped)."""
    from deepspeed_tpu_torch.models.transformer import (QuantizedWeight,
                                                        torch_dtype)
    from deepspeed_tpu_torch.ops.quant_matmul import quantize_matmul_weight

    cdt = torch_dtype(cfg.dtype)

    def q_stacked(w):            # [L, Din, F] -> stacked QuantizedWeight
        if w.ndim != 3 or w.shape[1] % 128 or w.shape[2] % 128:
            return w             # odd geometries stay dense
        ps = [quantize_matmul_weight(w[i].float(), bits=bits)
              for i in range(w.shape[0])]
        return QuantizedWeight(torch.stack([p for p, _ in ps]),
                               torch.stack([s.to(cdt) for _, s in ps]),
                               bits, w.shape[1])

    layers = dict(params["layers"])
    attn = dict(layers["attn"])
    if all(k in attn for k in ("wq", "wk", "wv")) and attn["wq"].ndim == 3:
        attn["wqkv"] = torch.cat([attn.pop("wq"), attn.pop("wk"),
                                  attn.pop("wv")], dim=-1)
        if "bq" in attn:
            attn["bqkv"] = torch.cat([attn.pop("bq"), attn.pop("bk"),
                                      attn.pop("bv")], dim=-1)
    layers["attn"] = attn
    mlp = dict(layers["mlp"])
    if any(leaf.ndim == 4 for leaf in mlp.values()):
        raise NotImplementedError("quantizing MoE expert stacks is not "
                                  "ported (MoE layers are not ported yet)")
    if "w_gate" in mlp and "w_up" in mlp and "b_up" not in mlp:
        mlp["w_gateup"] = torch.cat([mlp.pop("w_gate"), mlp.pop("w_up")],
                                    dim=-1)
    layers["mlp"] = mlp
    for grp in ("attn", "mlp"):
        layers[grp] = {name: (q_stacked(leaf) if name in QUANT_LEAVES
                              else leaf)
                       for name, leaf in layers[grp].items()}
    params = {**params, "layers": layers}
    head = (params["embed"]["tokens"].T if cfg.tie_embeddings
            else params["lm_head"])
    D, V = head.shape
    if D % 128 == 0 and V % 128 == 0:
        packed, scales = quantize_matmul_weight(head.float(), bits=bits)
        params["lm_head_q"] = QuantizedWeight(packed, scales.to(cdt), bits, D)
        if not cfg.tie_embeddings:
            # keeping the dense head would hold the memory the
            # quantization exists to free
            params.pop("lm_head", None)
    return params


def parse_weight_dtype(dtype) -> str:
    """An ``init_inference``-style dtype (string, numpy or torch dtype, or
    scalar type) as a ``weight_dtype`` string: ``int8``, ``int4`` or
    ``bf16`` for anything else."""
    if dtype is None:
        return "bf16"
    if isinstance(dtype, str):
        s = dtype
    else:
        try:
            import numpy as np

            s = np.dtype(dtype).name      # np.int8 / "int8"
        except TypeError:
            s = str(dtype).replace("torch.", "")
    return s if s in ("int8", "int4") else "bf16"
