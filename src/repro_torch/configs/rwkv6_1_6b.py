"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536 —
Finch, data-dependent decay [arXiv:2404.05892; unverified].

32 heads x 64 head_dim time-mix; squared-ReLU channel-mix.
"""

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_RWKV = LayerSpec(mixer="rwkv", attn_kind="none", use_rope=False)

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    pattern=(_RWKV,),
    pattern_repeats=24,
    ssm_heads=32,
    norm="layernorm",
    mlp="relu2",
    pos_embedding="none",
    tie_embeddings=False,
    max_seq=1 << 20,
    subquadratic=True,  # linear recurrence -> long_500k runs
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    ssm_heads=4,
    d_ff=128,
    vocab_size=256,
    pattern_repeats=2,
    max_seq=512,
)
