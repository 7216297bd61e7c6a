"""Layer blocks and whole-model assembly, for the attention mixer with a
dense MLP or a MoE FFN and the rwkv mixer (the port of
``repro.models.transformer``).

The JAX package stacks each pattern position's weights over
``pattern_repeats`` and scans them; the port keeps one plain dict of
tensors per layer in ``params["layers"]``, in the scan's order: for each
repeat r the pattern positions l0, l1, ...; then the tail
(``layer_specs``). Other mixers and features raise
``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S

_LATER = "a later slice of the LM substrate (ROADMAP Queue 1, item 13)"


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot build yet."""
    unported = []
    for spec in cfg.pattern + cfg.tail:
        if spec.mixer == "hybrid":
            unported.append(("the hybrid mixer", _LATER))
        elif spec.attn_kind == "none" and spec.mixer != "rwkv":
            unported.append(("attn_kind 'none'", _LATER))
        if spec.has_cross:
            unported.append(("cross-attention", _LATER))
    if cfg.moe_dispatch_shards > 1 and any(
            s.is_moe for s in cfg.pattern + cfg.tail):
        unported.append(("per-shard MoE dispatch (moe_dispatch_shards > 1)",
                         MOE.DISTRIBUTION))
    if cfg.encoder_layers:
        unported.append(("the encoder", _LATER))
    if cfg.pos_embedding == "learned":
        unported.append(("learned position embeddings", _LATER))
    if cfg.early_fusion_tokens:
        unported.append(("early-fusion tokens", _LATER))
    if unported:
        what, where = unported[0]
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet; it comes with {where}")


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    """Every layer's spec in execution order (the JAX scan's order)."""
    return list(cfg.pattern) * cfg.pattern_repeats + list(cfg.tail)


# ---------------------------------------------------------------------------
# per-layer params
# ---------------------------------------------------------------------------
def attn_spec(cfg: ModelConfig, spec: LayerSpec) -> L.AttnSpec:
    theta = cfg.rope_theta
    if spec.attn_kind == "full" and cfg.rope_theta_global is not None:
        theta = cfg.rope_theta_global
    return L.AttnSpec(
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        kind=spec.attn_kind,
        window=cfg.window,
        use_rope=spec.use_rope and cfg.pos_embedding == "rope",
        rope_theta=theta,
        partial_rotary=cfg.partial_rotary,
        qk_norm=cfg.qk_norm,
    )


def init_layer(cfg: ModelConfig, spec: LayerSpec, device, gen):
    dt = getattr(torch, cfg.dtype)
    d = cfg.d_model
    if spec.mixer == "rwkv":
        return {
            "ln_tm": L.init_norm(cfg.norm, d, dt, device),
            "tm": S.init_rwkv_timemix(d, cfg.ssm_heads, cfg.head_dim, dt,
                                      device, gen),
            "ln_cm": L.init_norm(cfg.norm, d, dt, device),
            "cm": S.init_rwkv_channelmix(d, cfg.d_ff, dt, device, gen),
        }
    p = {
        "ln_attn": L.init_norm(cfg.norm, d, dt, device),
        "attn": L.init_attn(d, attn_spec(cfg, spec), dt, device, gen),
        "ln_mlp": L.init_norm(cfg.norm, d, dt, device),
    }
    if spec.is_moe:
        p["moe"] = MOE.init_moe(
            d, cfg.expert_d_ff or cfg.d_ff, cfg.num_experts, dt, device, gen,
            mlp_kind=cfg.mlp, shared_expert=cfg.moe_shared_expert)
    else:
        p["mlp"] = L.init_mlp(cfg.mlp, d, cfg.d_ff, dt, device, gen)
    return p


# ---------------------------------------------------------------------------
# layer application (full sequence: prefill)
# ---------------------------------------------------------------------------
def _mlp_or_moe(x, p, cfg, spec, kernel_impl="auto"):
    """The FFN half of an attention layer: (out, aux); ``kernel_impl``
    picks kernel B3 for a MoE layer's dispatch plan."""
    h = L.apply_norm(cfg.norm, x, p["ln_mlp"])
    if spec.is_moe:
        return MOE.apply_moe(
            h, p["moe"], top_k=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor, mlp_kind=cfg.mlp,
            mode=cfg.moe_mode, dispatch_shards=cfg.moe_dispatch_shards,
            weight_gather=cfg.moe_weight_gather, kernel_impl=kernel_impl)
    return L.apply_mlp(cfg.mlp, h, p["mlp"]), 0.0


def rwkv_layer(x, p, cfg, tm_x, cm_x, state, *, kernel_impl="auto",
               state_out=None):
    """An rwkv layer (time mix, then channel mix) over x [B,S,D] from the
    token-shift rows ``tm_x``/``cm_x`` [B,D] and the time mix's state.
    Returns (x, {"tm_x", "cm_x", "state"} after x); ``state_out`` as in
    ``ssm.rwkv_timemix``."""
    h = L.apply_norm(cfg.norm, x, p["ln_tm"])
    o, tmx, st = S.rwkv_timemix(h, tm_x, state, p["tm"],
                                kernel_impl=kernel_impl, state_out=state_out)
    x = x + o
    h = L.apply_norm(cfg.norm, x, p["ln_cm"])
    o, cmx = S.rwkv_channelmix(h, cm_x, p["cm"])
    return x + o, {"tm_x": tmx, "cm_x": cmx, "state": st}


def apply_layer(x, p, cfg, spec, *, want_cache=False, kernel_impl="auto"):
    """One layer over the whole sequence, from an empty cache. Returns (x,
    aux, cache entry or None); the entry holds an attention layer's k and
    v [B,S,Nkv,hd], an rwkv layer's ``tm_x``, ``cm_x`` and ``state``."""
    if spec.mixer == "rwkv":
        B = x.shape[0]
        z = torch.zeros((B, cfg.d_model), dtype=x.dtype, device=x.device)
        st0 = torch.zeros((B, cfg.ssm_heads, cfg.head_dim, cfg.head_dim),
                          dtype=torch.float32, device=x.device)
        x, newc = rwkv_layer(x, p, cfg, z, z, st0, kernel_impl=kernel_impl)
        return x, 0.0, (newc if want_cache else None)
    h = L.apply_norm(cfg.norm, x, p["ln_attn"])
    o, (k, v) = L.self_attention(h, p["attn"], attn_spec(cfg, spec),
                                 kernel_impl=kernel_impl)
    x = x + o
    o, aux = _mlp_or_moe(x, p, cfg, spec, kernel_impl)
    return x + o, aux, ({"k": k, "v": v} if want_cache else None)


# ---------------------------------------------------------------------------
# whole-model params
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random weights from ``seed`` on ``device`` (a ``torch.Generator``
    there), with the JAX package's shapes and scales; the numbers differ
    from JAX's (``models.convert.params_from_numpy`` takes those)."""
    check_ported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    d = cfg.d_model
    params = {
        "tok_embed": L.normal((cfg.vocab_size, d), 0.02, dt, device, gen),
        "final_norm": L.init_norm(cfg.norm, d, dt, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal((d, cfg.vocab_size), 1.0 / math.sqrt(d),
                                     dt, device, gen)
    params["layers"] = [init_layer(cfg, spec, device, gen)
                        for spec in layer_specs(cfg)]
    return params


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------
def _embed(params, cfg, tokens):
    return params["tok_embed"][tokens]


def _lm_head(params, cfg, x):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["tok_embed"])
    return x @ params["lm_head"]


def forward(params, cfg: ModelConfig, tokens, *, kernel_impl="auto"):
    """Full-sequence forward. Returns (hidden [B,S,D], aux_loss)."""
    check_ported(cfg)
    x = _embed(params, cfg, tokens)
    aux_total = 0.0
    for p, spec in zip(params["layers"], layer_specs(cfg)):
        x, a, _ = apply_layer(x, p, cfg, spec, kernel_impl=kernel_impl)
        aux_total = aux_total + a
    x = L.apply_norm(cfg.norm, x, params["final_norm"])
    return x, aux_total
