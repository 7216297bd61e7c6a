"""whisper-tiny [audio]: enc-dec 4L+4L d_model=384 6H d_ff=1536 vocab=51865
— conv frontend STUB [arXiv:2212.04356; unverified].

The caller passes precomputed frame embeddings [B, 1500, d_model] as
``extras["audio_frames"]`` (the conv1d+GELU frontend is a stub;
``models.model.random_extras`` makes them from a seed). Decoder uses
learned positions; the real model has 448 target positions — the table is
sized from the requested shape so decode cells lower (the JAX package's
deviation, kept field for field). Decoder layers: causal self-attn + (ungated) cross-attn.
"""

import dataclasses

from repro_torch.configs.base import LayerSpec, ModelConfig

_DEC = LayerSpec(mixer="attn", attn_kind="full", use_rope=False,
                 has_cross=True)

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    pattern=(),
    pattern_repeats=0,
    tail=(_DEC, _DEC, _DEC, _DEC),
    norm="layernorm",
    mlp="gelu",
    pos_embedding="learned",
    tie_embeddings=True,
    gated_cross=False,
    encoder_layers=4,
    audio_frames=1500,
    max_seq=32768,  # sized for the decode_32k cell (real model: 448)
    subquadratic=False,  # full-attention decoder -> long_500k skipped
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    tail=(_DEC, _DEC),
    encoder_layers=2,
    audio_frames=16,
    max_seq=512,
)
