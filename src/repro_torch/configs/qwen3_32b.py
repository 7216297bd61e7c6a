"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_FULL = LayerSpec(mixer="attn", attn_kind="full")

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    pattern=(_FULL,),
    pattern_repeats=64,
    qk_norm=True,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1e6,
    tie_embeddings=False,
    max_seq=40960,
    subquadratic=False,  # pure full attention -> long_500k skipped
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
    max_seq=512,
)
