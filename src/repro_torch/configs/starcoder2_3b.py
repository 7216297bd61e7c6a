"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, sliding-window 4096 [arXiv:2402.19173; hf]."""

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_SWA = LayerSpec(mixer="attn", attn_kind="swa")

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    pattern=(_SWA,),
    pattern_repeats=30,
    window=4096,
    norm="layernorm",
    mlp="gelu",
    rope_theta=1e6,
    tie_embeddings=True,
    max_seq=16384,
    subquadratic=True,  # SWA-4096 -> long_500k runs
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern_repeats=2,
    window=16,
    max_seq=512,
)
