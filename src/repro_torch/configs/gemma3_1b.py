"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global, 128k [hf:google/gemma-3-1b-pt; unverified].

26 layers = 4 x [5 local(SWA-512) + 1 global] + 2 local tail.
Local layers use rope_theta=1e4, globals 1e6 (gemma3 scheme).
"""

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(mixer="attn", attn_kind="swa")
_GLOBAL = LayerSpec(mixer="attn", attn_kind="full")

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    pattern_repeats=4,
    tail=(_LOCAL, _LOCAL),
    window=512,
    qk_norm=True,
    norm="rmsnorm",
    mlp="geglu",
    rope_theta=1e4,
    rope_theta_global=1e6,
    tie_embeddings=True,
    max_seq=131072,
    # 5:1 sliding-window; global layers decode linearly per token ->
    # long_500k runs
    subquadratic=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    num_heads=2,
    num_kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    pattern=(_LOCAL, _GLOBAL),
    pattern_repeats=2,
    tail=(_LOCAL,),
    window=16,
    max_seq=512,
)
