"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision;
unverified].

40 layers = 8 x [4 self-attn + 1 cross-attn-only]; the vision encoder is a
STUB: the caller passes precomputed patch embeddings
[B, vision_tokens, d_model] as ``extras["vision_embeds"]``
(``models.model.random_extras`` makes them from a seed), consumed by the
gated cross-attention layers.
"""

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_FULL = LayerSpec(mixer="attn", attn_kind="full")
_CROSS = LayerSpec(mixer="attn", attn_kind="none", has_cross=True,
                   use_rope=False)

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    pattern=(_FULL, _FULL, _FULL, _FULL, _CROSS),
    pattern_repeats=8,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=5e5,
    tie_embeddings=False,
    gated_cross=True,
    vision_tokens=1024,  # stub: precomputed patch embeddings
    max_seq=131072,
    subquadratic=False,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pattern=(_FULL, _CROSS),
    pattern_repeats=2,
    vision_tokens=8,
    max_seq=512,
)
