"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, MoE 128 experts top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48 layers = 12 x [3 chunked-local(8192) + 1 global-NoPE], MoE every second
layer (iRoPE + interleaved MoE, Llama-4 scheme). Early fusion is a STUB:
precomputed fused-image embeddings (``extras["vision_embeds"]``; the
seeded stand-ins of ``models.model.random_extras``) replace the first
``early_fusion_tokens`` positions.
"""

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_CHUNK_DENSE = LayerSpec(mixer="attn", attn_kind="chunked")
_CHUNK_MOE = LayerSpec(mixer="attn", attn_kind="chunked", is_moe=True)
_NOPE_MOE = LayerSpec(mixer="attn", attn_kind="full", use_rope=False,
                      is_moe=True)

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    pattern=(_CHUNK_DENSE, _CHUNK_MOE, _CHUNK_DENSE, _NOPE_MOE),
    pattern_repeats=12,
    window=8192,  # attention-chunk size
    num_experts=128,
    experts_per_token=1,
    expert_d_ff=8192,
    moe_shared_expert=True,
    capacity_factor=1.25,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=5e5,
    tie_embeddings=False,
    early_fusion_tokens=64,  # stub fused-image prefix
    max_seq=1 << 20,
    # chunked attention; global-NoPE layers decode linearly -> long_500k runs
    subquadratic=True,
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
    experts_per_token=1,
    vocab_size=256,
    pattern_repeats=1,
    window=32,
    early_fusion_tokens=4,
    max_seq=512,
)
