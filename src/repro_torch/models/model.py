"""Serving facade: decode-cache layout, prefill and one decode step (the
port of ``repro.models.model``'s serving part).

A cache is a dict: ``pos`` int32[B] and ``layers``, one dict per layer in
execution order: an attention layer's ``k``/``v`` [B, clen, Nkv, hd]
(and ``kpos`` int32[B, clen] for a ring cache), an rwkv layer's
token-shift rows ``tm_x``/``cm_x`` [B, D] and its time mix's ``state``
[B, H, hd, hd] f32. ``decode_step`` updates it IN PLACE and returns it;
``prefill`` builds a new one.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    return TF.init_params(cfg, seed, device)


def _ring(cfg, spec):
    return cfg.swa_ring_cache and spec.attn_kind in ("swa", "chunked")


def _layer_cache_spec(cfg: ModelConfig, spec: LayerSpec, batch, cache_len):
    """{name: (shape, dtype)} of one layer's decode cache."""
    dt = getattr(torch, cfg.dtype)
    if spec.mixer == "rwkv":
        hd = cfg.head_dim
        return {"tm_x": ((batch, cfg.d_model), dt),
                "cm_x": ((batch, cfg.d_model), dt),
                "state": ((batch, cfg.ssm_heads, hd, hd), torch.float32)}
    ring = _ring(cfg, spec)
    clen = min(cache_len, cfg.window) if ring else cache_len
    kv = (batch, clen, cfg.num_kv_heads, cfg.head_dim)
    c = {"k": (kv, dt), "v": (kv, dt)}
    if ring:
        c["kpos"] = ((batch, clen), torch.int32)
    return c


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int):
    """{"pos": ..., "layers": [{name: (shape, dtype)}]} of the cache."""
    TF.check_ported(cfg)
    return {
        "pos": ((batch,), torch.int32),
        "layers": [_layer_cache_spec(cfg, sp, batch, cache_len)
                   for sp in TF.layer_specs(cfg)],
    }


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device="cuda"):
    """Zero k/v, token-shift rows and states; ``kpos`` -1 (unwritten);
    ``pos`` 0."""
    spec = cache_spec(cfg, batch, cache_len)

    def mk(shape, dtype):
        if dtype == torch.int32:
            return torch.full(shape, -1, dtype=dtype, device=device)
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
        "layers": [{name: mk(*s) for name, s in entry.items()}
                   for entry in spec["layers"]],
    }


def prefill(params, cfg: ModelConfig, tokens, cache_len=None,
            kernel_impl="auto"):
    """Process the prompt (tokens int[B,S]) and build the decode cache.
    Returns (logits [B,1,V] of the last position, cache)."""
    B, S = tokens.shape
    cache_len = cache_len or S
    cache = init_cache(cfg, B, cache_len, tokens.device)
    x = TF._embed(params, cfg, tokens)
    for p, spec, entry in zip(params["layers"], TF.layer_specs(cfg),
                              cache["layers"]):
        x, _, newc = TF.apply_layer(x, p, cfg, spec, want_cache=True,
                                    kernel_impl=kernel_impl)
        if spec.mixer == "rwkv":
            for name, t in newc.items():
                entry[name].copy_(t)
            continue
        k, v = newc["k"], newc["v"]
        if _ring(cfg, spec):
            take = min(S, entry["k"].shape[1])
            entry["k"][:, :take] = k[:, S - take:]
            entry["v"][:, :take] = v[:, S - take:]
            entry["kpos"][:, :take] = torch.arange(
                S - take, S, dtype=torch.int32, device=tokens.device)[None]
        else:
            entry["k"][:, :S] = k
            entry["v"][:, :S] = v
    x = L.apply_norm(cfg.norm, x, params["final_norm"])
    logits = TF._lm_head(params, cfg, x[:, -1:, :])
    cache["pos"].fill_(S)
    return logits, cache


def _decode_layer(x, p, cfg, spec, entry, pos, kernel_impl):
    """One layer for one token; updates ``entry`` in place."""
    if spec.mixer == "rwkv":
        x, newc = TF.rwkv_layer(x, p, cfg, entry["tm_x"], entry["cm_x"],
                                entry["state"], kernel_impl=kernel_impl,
                                state_out=entry["state"])
        entry["tm_x"].copy_(newc["tm_x"])
        entry["cm_x"].copy_(newc["cm_x"])
        return x
    h = L.apply_norm(cfg.norm, x, p["ln_attn"])
    o = L.decode_attention(h, p["attn"], TF.attn_spec(cfg, spec), entry["k"],
                           entry["v"], pos, ring=_ring(cfg, spec),
                           cache_kpos=entry.get("kpos"))
    x = x + o
    o, _ = TF._mlp_or_moe(x, p, cfg, spec, kernel_impl)
    return x + o


def decode_step(params, cfg: ModelConfig, cache, token, kernel_impl="auto"):
    """One decode step for the whole batch. token: int[B,1].
    ``kernel_impl`` picks kernel B5 for an rwkv layer's step and kernel
    B3 for a MoE layer's dispatch plan (``repro_torch.kernels.use_kernel``);
    attention decodes in plain PyTorch.

    Returns (logits [B,1,V], cache), the cache updated in place.
    """
    pos = cache["pos"]
    x = params["tok_embed"][token]
    for p, spec, entry in zip(params["layers"], TF.layer_specs(cfg),
                              cache["layers"]):
        x = _decode_layer(x, p, cfg, spec, entry, pos, kernel_impl)
    cache["pos"] += 1
    x = L.apply_norm(cfg.norm, x, params["final_norm"])
    return TF._lm_head(params, cfg, x), cache
