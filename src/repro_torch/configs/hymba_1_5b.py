"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676; hf].

Each layer runs a SWA attention branch and a selective-SSM branch in
parallel on the same input, averaging normalized outputs. Simplifications
vs the full paper recipe (the JAX package's, kept): meta tokens omitted;
all layers SWA-1024 (the real model keeps 3 global layers).
"""

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_HYB = LayerSpec(mixer="hybrid", attn_kind="swa")

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    pattern=(_HYB,),
    pattern_repeats=32,
    window=1024,
    ssm_state=16,
    ssm_heads=25,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1e4,
    tie_embeddings=True,
    max_seq=1 << 20,
    subquadratic=True,  # hybrid: SSM state + SWA -> long_500k runs
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    ssm_heads=4,
    ssm_state=4,
    d_ff=128,
    vocab_size=256,
    pattern_repeats=2,
    window=16,
    max_seq=512,
)
