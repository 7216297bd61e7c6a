"""stablelm-1.6b [dense]: 24L d_model=2048 32H (MHA kv=32) d_ff=5632
vocab=100352 [hf:stabilityai/stablelm-2-1_6b; unverified].

LayerNorm, gated-SiLU MLP, partial rotary (25%).
"""

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_FULL = LayerSpec(mixer="attn", attn_kind="full")

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    pattern=(_FULL,),
    pattern_repeats=24,
    norm="layernorm",
    mlp="swiglu",
    rope_theta=1e4,
    partial_rotary=0.25,
    tie_embeddings=False,
    max_seq=4096,
    subquadratic=False,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern_repeats=2,
    max_seq=512,
)
