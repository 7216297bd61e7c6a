"""Model config schema: the port's copy of ``repro.configs.base``.

A model is a repeating *layer pattern* (the smallest heterogeneous unit,
e.g. gemma3's [5x local, 1x global]) run ``pattern_repeats`` times, plus
a ``tail``. The dataclasses are field-for-field those of the JAX
package, so a test can build one from the other. The registry lists all
ten architectures, and each resolves. ``SHAPES`` are the dry run's input
shapes, ``applicable_shapes`` those an arch takes.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

# ---------------------------------------------------------------------------
# Layer / model specs
# ---------------------------------------------------------------------------

ATTN_KINDS = ("full", "swa", "chunked", "none")
MIXERS = ("attn", "rwkv", "hybrid")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer position within the repeating pattern."""

    mixer: str = "attn"  # 'attn' | 'rwkv' | 'hybrid'
    attn_kind: str = "full"  # 'full' | 'swa' | 'chunked' | 'none'
    use_rope: bool = True
    is_moe: bool = False
    has_cross: bool = False  # cross-attention (VLM / enc-dec decoder)

    def __post_init__(self):
        assert self.mixer in MIXERS, self.mixer
        assert self.attn_kind in ATTN_KINDS, self.attn_kind


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | moe | vlm | audio
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...]
    pattern_repeats: int
    tail: tuple[LayerSpec, ...] = ()

    # attention details
    window: int = 0  # SWA window / attention-chunk size
    rope_theta: float = 1e4
    rope_theta_global: float | None = None  # for mixed local/global RoPE
    partial_rotary: float = 1.0
    qk_norm: bool = False

    # block details
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    mlp: str = "swiglu"  # 'swiglu' | 'gelu' | 'geglu' | 'relu2'
    tie_embeddings: bool = False
    pos_embedding: str = "rope"  # 'rope' | 'learned' | 'none'

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    expert_d_ff: int = 0
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25
    # 'planned' = canonical-order capacity dispatch (the paper's P2);
    # 'dense' = every expert computes every token (no-planning baseline)
    moe_mode: str = "planned"
    # >1: hierarchical per-shard plans (each DP shard plans/dispatches its
    # own tokens locally — single-owner end-to-end, see models/moe.py)
    moe_dispatch_shards: int = 0
    # use-site ZeRO-3 gather of expert weights (helps EP banks; see §Perf)
    moe_weight_gather: bool = False

    # SSM / hybrid (RWKV6 / Hymba)
    ssm_state: int = 0
    ssm_heads: int = 0

    # cross-attention gating (llama3.2 tanh-gates new cross layers; whisper
    # does not gate)
    gated_cross: bool = True
    # SWA/chunked decode KV cache as a ring buffer of window size (a P2-style
    # static allocation plan; big memory win — off by default so the
    # baseline/optimized delta is visible in §Perf)
    swa_ring_cache: bool = False

    # multimodal stubs
    vision_tokens: int = 0  # cross-attn KV token count (llama3.2-vision)
    early_fusion_tokens: int = 0  # prefix fusion token count (llama4)
    audio_frames: int = 0  # whisper encoder frames (precomputed stub)
    encoder_layers: int = 0  # whisper encoder depth

    max_seq: int = 131072
    dtype: str = "bfloat16"

    # Sub-quadratic? (decides long_500k applicability per the assignment)
    subquadratic: bool = False
    # logical-axis -> mesh-axis rule overrides for this arch
    sharding_overrides: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.pattern_repeats + len(self.tail)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND."""
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads

        def attn_params():
            return d * hd * (n_q + 2 * n_kv) + n_q * hd * d

        def mlp_params(ff):
            mult = 3 if self.mlp in ("swiglu", "geglu") else 2
            return mult * d * ff

        def layer_params(spec: LayerSpec):
            p = 0
            if spec.mixer in ("attn", "hybrid") and spec.attn_kind != "none":
                p += attn_params()
            if spec.mixer in ("rwkv", "hybrid"):
                # time-mix: r,k,v,g,w projections + output
                p += 6 * d * d // (2 if spec.mixer == "hybrid" else 1)
            if spec.has_cross:
                p += attn_params()
            if spec.is_moe:
                p += self.num_experts * mlp_params(self.expert_d_ff or self.d_ff)
                if self.moe_shared_expert:
                    p += mlp_params(self.expert_d_ff or self.d_ff)
                p += d * self.num_experts  # router
            else:
                p += mlp_params(self.d_ff)
            return p

        total = sum(layer_params(s) for s in self.pattern) * self.pattern_repeats
        total += sum(layer_params(s) for s in self.tail)
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.encoder_layers:
            total += self.encoder_layers * (attn_params() + mlp_params(self.d_ff))
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params for MoE 6*N_active*D accounting."""
        if not any(s.is_moe for s in self.pattern + self.tail):
            return self.param_count()
        d = self.d_model
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        ff = self.expert_d_ff or self.d_ff
        dead_per_moe_layer = (
            (self.num_experts - self.experts_per_token) * mult * d * ff
        )
        n_moe = (
            sum(s.is_moe for s in self.pattern) * self.pattern_repeats
            + sum(s.is_moe for s in self.tail)
        )
        return self.param_count() - n_moe * dead_per_moe_layer


ARCHS = (
    "qwen3-32b",
    "gemma3-1b",
    "stablelm-1.6b",
    "starcoder2-3b",
    "rwkv6-1.6b",
    "llama-3.2-vision-11b",
    "hymba-1.5b",
    "whisper-tiny",
    "mixtral-8x22b",
    "llama4-maverick-400b-a17b",
)

# ---------------------------------------------------------------------------
# Input shapes (assigned per-arch shape set)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# each architecture's config module
_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "gemma3-1b": "gemma3_1b",
    "stablelm-1.6b": "stablelm_1_6b",
    "starcoder2-3b": "starcoder2_3b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "hymba-1.5b": "hymba_1_5b",
    "whisper-tiny": "whisper_tiny",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
}


def list_archs() -> tuple[str, ...]:
    return ARCHS


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _load(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _load(name).SMOKE


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shape cells that apply to this arch (long_500k needs sub-quadratic;
    pure full-attention archs skip it per the assignment)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.subquadratic:
            continue
        out.append(s.name)
    return out
