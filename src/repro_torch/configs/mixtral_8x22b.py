"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088; hf].

Every layer: SWA-4096 attention + 8-expert top-2 MoE FFN with planned
(canonical-order, capacity-bounded) dispatch.
"""

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_MOE = LayerSpec(mixer="attn", attn_kind="swa", is_moe=True)

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    pattern=(_MOE,),
    pattern_repeats=56,
    window=4096,
    num_experts=8,
    experts_per_token=2,
    expert_d_ff=16384,
    capacity_factor=1.25,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1e6,
    tie_embeddings=False,
    max_seq=65536,
    subquadratic=True,  # SWA-4096
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    expert_d_ff=128,
    num_experts=4,
    experts_per_token=2,
    vocab_size=256,
    pattern_repeats=2,
    window=16,
    max_seq=512,
)
