"""Named model presets (counterpart of ``deepspeed_tpu/models/presets.py``;
the same configurations, on the port's :class:`TransformerConfig`)."""

from __future__ import annotations

import dataclasses

from deepspeed_tpu_torch.models.transformer import TransformerConfig

PRESETS = {
    # tiny configs for tests
    "tiny": TransformerConfig(vocab_size=256, hidden_size=64, num_layers=2,
                              num_heads=4, max_seq_len=64, arch="llama"),
    "tiny-gpt2": TransformerConfig(vocab_size=256, hidden_size=64, num_layers=2,
                                   num_heads=4, max_seq_len=64, arch="gpt2"),
    "tiny-moe": TransformerConfig(vocab_size=256, hidden_size=64, num_layers=2,
                                  num_heads=4, max_seq_len=64, arch="llama",
                                  num_experts=4, top_k=2),
    "gpt2-125m": TransformerConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                                   num_heads=12, max_seq_len=1024, arch="gpt2"),
    "gpt2-1.3b": TransformerConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                                   num_heads=16, max_seq_len=2048, arch="gpt2"),
    "llama3-1b": TransformerConfig(vocab_size=128256, hidden_size=2048, num_layers=16,
                                   num_heads=32, num_kv_heads=8, intermediate_size=8192,
                                   max_seq_len=8192, arch="llama", rope_theta=500000.0),
    "llama3-8b": TransformerConfig(vocab_size=128256, hidden_size=4096, num_layers=32,
                                   num_heads=32, num_kv_heads=8, intermediate_size=14336,
                                   max_seq_len=8192, arch="llama", rope_theta=500000.0),
    "llama3-70b": TransformerConfig(vocab_size=128256, hidden_size=8192, num_layers=80,
                                    num_heads=64, num_kv_heads=8, intermediate_size=28672,
                                    max_seq_len=8192, arch="llama", rope_theta=500000.0),
    "mixtral-8x7b": TransformerConfig(vocab_size=32000, hidden_size=4096, num_layers=32,
                                      num_heads=32, num_kv_heads=8, intermediate_size=14336,
                                      max_seq_len=8192, arch="llama", num_experts=8,
                                      top_k=2),
    "mistral-7b": TransformerConfig(vocab_size=32000, hidden_size=4096,
                                    num_layers=32, num_heads=32, num_kv_heads=8,
                                    intermediate_size=14336, max_seq_len=32768,
                                    arch="llama", tie_embeddings=False,
                                    sliding_window=4096),
    "qwen2-7b": TransformerConfig(vocab_size=152064, hidden_size=3584,
                                  num_layers=28, num_heads=28, num_kv_heads=4,
                                  intermediate_size=18944, max_seq_len=32768,
                                  arch="llama", rope_theta=1000000.0,
                                  tie_embeddings=False, norm_eps=1e-6,
                                  qkv_bias=True),
    "phi3-mini": TransformerConfig(vocab_size=32064, hidden_size=3072,
                                   num_layers=32, num_heads=32, num_kv_heads=32,
                                   intermediate_size=8192, max_seq_len=4096,
                                   arch="llama", tie_embeddings=False),
    "falcon-7b": TransformerConfig(vocab_size=65024, hidden_size=4544,
                                   num_layers=32, num_heads=71, num_kv_heads=1,
                                   intermediate_size=18176, max_seq_len=2048,
                                   arch="gpt2", norm="layernorm",
                                   activation="gelu_exact", use_rope=True,
                                   learned_pos=False, parallel_block=True,
                                   parallel_shared_norm=True),
    "pythia-1b": TransformerConfig(vocab_size=50304, hidden_size=2048,
                                   num_layers=16, num_heads=8,
                                   intermediate_size=8192, max_seq_len=2048,
                                   arch="gpt2", use_rope=True, learned_pos=False,
                                   rope_pct=0.25, parallel_block=True,
                                   qkv_bias=True, proj_bias=True,
                                   activation="gelu_exact",
                                   tie_embeddings=False),
    "opt-1.3b": TransformerConfig(vocab_size=50272, hidden_size=2048,
                                  num_layers=24, num_heads=32,
                                  intermediate_size=8192, max_seq_len=2048,
                                  arch="gpt2", activation="relu",
                                  qkv_bias=True, proj_bias=True),
}


def get_preset(name: str, **overrides) -> TransformerConfig:
    cfg = PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
