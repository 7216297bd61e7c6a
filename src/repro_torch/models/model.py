"""Serving facade: decode-cache layout, prefill and one decode step (the
port of ``repro.models.model``'s serving part).

A cache is a dict: ``pos`` int32[B] and ``layers``, one dict per layer in
execution order: a self-attention layer's ``k``/``v`` [B, clen, Nkv, hd]
(and ``kpos`` int32[B, clen] for a ring cache), a hybrid layer's Mamba
``state`` [B, H, hd, N] f32 beside them, a cross layer's ``ck``/``cv``
[B, T, Nkv, hd] (T = ``vision_tokens`` or ``audio_frames``), an rwkv
layer's token-shift rows ``tm_x``/``cm_x`` [B, D] and its time mix's
``state`` [B, H, hd, hd] f32. ``decode_step`` updates it IN PLACE and
returns it; ``prefill`` builds a new one.

``extras`` carries the inputs beside the tokens: ``vision_embeds``
[B, vision_tokens, D] for llama-3.2-vision's cross layers, or [B,
early_fusion_tokens, D] for llama4-maverick's early-fusion prefix (the
prompt's first rows; ``decode_step`` embeds no prefix, as the JAX
package's does not), ``audio_frames`` [B, audio_frames, D] for whisper's
encoder.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as TF
from repro_torch.sharding import ctx


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    return TF.init_params(cfg, seed, device)


def param_axes(cfg: ModelConfig):
    return TF.param_axes(cfg)


def abstract_params(cfg: ModelConfig):
    """``init_params``'s tree on the ``meta`` device: every leaf's shape
    and dtype, no weight allocated (llama4-maverick's full config has
    400 B parameters)."""
    return TF.init_params(cfg, device="meta")


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
    c = {}
    if TF.has_self_attention(spec):
        ring = _ring(cfg, spec)
        clen = min(cache_len, cfg.window) if ring else cache_len
        kv = (batch, clen, cfg.num_kv_heads, cfg.head_dim)
        c["k"] = c["v"] = (kv, dt)
        if ring:
            c["kpos"] = ((batch, clen), torch.int32)
    if spec.mixer == "hybrid":
        c["state"] = (TF.ssm_state_shape(cfg, batch), torch.float32)
    if spec.has_cross:
        t = cfg.vision_tokens or cfg.audio_frames or 1
        c["ck"] = c["cv"] = ((batch, t, cfg.num_kv_heads, cfg.head_dim), dt)
    return c


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int):
    """{"pos": ..., "layers": [{name: (shape, dtype)}]} of the cache."""
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


def random_extras(cfg: ModelConfig, batch: int, seed: int, device):
    """Unit-normal stand-ins for the stub frontends' outputs, from
    ``seed``, in the config's dtype: ``vision_embeds`` [batch,
    vision_tokens, D] (or [batch, early_fusion_tokens, D] for an
    early-fusion arch, as the JAX package's ``input_specs`` has it)
    and/or ``audio_frames`` [batch, audio_frames, D]; {} for an arch
    that takes neither."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, n in (("vision_embeds",
                     cfg.early_fusion_tokens or cfg.vision_tokens),
                    ("audio_frames", cfg.audio_frames)):
        if n:
            out[name] = torch.randn((batch, n, cfg.d_model), generator=gen,
                                    device=device).to(getattr(torch,
                                                              cfg.dtype))
    return out


def _fill_entry(cfg, spec, entry, newc, S_):
    """Write one layer's prefill outputs into its cache entry: k/v (the
    last window of them, with their positions, in a ring cache), then
    whichever of ``tm_x``, ``cm_x``, ``state``, ``ck``, ``cv`` the layer
    made."""
    if "k" in entry:
        k, v = newc["k"], newc["v"]
        if _ring(cfg, spec):
            take = min(S_, entry["k"].shape[1])
            entry["k"][:, :take] = k[:, S_ - take:]
            entry["v"][:, :take] = v[:, S_ - take:]
            entry["kpos"][:, :take] = torch.arange(
                S_ - take, S_, dtype=torch.int32, device=k.device)[None]
        else:
            entry["k"][:, :S_] = k
            entry["v"][:, :S_] = v
    for name in ("tm_x", "cm_x", "state", "ck", "cv"):
        if name in newc:
            entry[name].copy_(newc[name])


def prefill(params, cfg: ModelConfig, tokens, extras=None, cache_len=None,
            kernel_impl="auto"):
    """Process the prompt (tokens int[B,S]; ``extras`` as the module says)
    and build the decode cache. Returns (logits [B,1,V] of the last
    position, cache).

    A prompt shorter than an early-fusion prefix raises ValueError: the
    prefix makes the sequence longer than the prompt, whose length the
    cache takes, and the JAX package's prefill raises there too."""
    extras = extras or {}
    B, S_ = tokens.shape
    nf = cfg.early_fusion_tokens
    if nf and "vision_embeds" in extras and S_ < nf:
        raise ValueError(f"{cfg.name}: a prompt of {S_} tokens is shorter "
                         f"than the {nf}-row early-fusion prefix")
    cache_len = cache_len or S_
    cache = init_cache(cfg, B, cache_len, tokens.device)
    if ctx.is_dtensor(tokens):  # under a mesh: the rules' cache layout
        from repro_torch.sharding import policies as SH

        mesh, rules = ctx.active()
        cache = SH.distribute(cache, SH.cache_sharding(cfg, mesh, rules,
                                                       cache))
    x = ctx.constrain(TF._embed(params, cfg, tokens, extras), TF._RESID)
    cross = TF._cross_tokens(params, cfg, extras, kernel_impl)
    for p, spec, entry in zip(params["layers"], TF.layer_specs(cfg),
                              cache["layers"]):
        x, _, newc = TF.apply_layer(x, p, cfg, spec, cross_tokens=cross,
                                    want_cache=True, kernel_impl=kernel_impl)
        x = ctx.constrain(x, TF._RESID)
        _fill_entry(cfg, spec, entry, newc, S_)
    x = L.apply_norm(cfg.norm, x, params["final_norm"])
    logits = TF._lm_head(params, cfg, x[:, -1:, :])
    cache["pos"].fill_(S_)
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
    sp = TF.attn_spec(cfg, spec)
    if TF.has_self_attention(spec):
        h = L.apply_norm(cfg.norm, x, p["ln_attn"])
        o = L.decode_attention(h, p["attn"], sp, entry["k"], entry["v"], pos,
                               ring=_ring(cfg, spec),
                               cache_kpos=entry.get("kpos"))
        if spec.mixer == "hybrid":
            o2, st = S.mamba_head(h, entry["state"], p["ssm"])
            entry["state"].copy_(st)
            o = 0.5 * (o + o2)
        x = x + o
    if spec.has_cross:
        h = L.apply_norm(cfg.norm, x, p["ln_cross"])
        o = L.cross_attention_cached(h, p["cross"], sp, entry["ck"],
                                     entry["cv"])
        x = x + TF.gated(o, p)
    o, _ = TF._mlp_or_moe(x, p, cfg, spec, kernel_impl)
    return x + o


def decode_step(params, cfg: ModelConfig, cache, token, extras=None,
                kernel_impl="auto"):
    """One decode step for the whole batch. token: int[B,1]. ``extras``
    is taken for the JAX signature's sake and unused, as there: the cross
    layers read their ``ck``/``cv`` from the cache. ``kernel_impl`` picks
    kernel B5 for an rwkv layer's step and kernel B3 for a MoE layer's
    dispatch plan (``repro_torch.kernels.use_kernel``); attention, the
    Mamba head and cross-attention decode in plain PyTorch.

    Returns (logits [B,1,V], cache), the cache updated in place.
    """
    pos = cache["pos"]
    x = params["tok_embed"][token]
    if cfg.pos_embedding == "learned":
        # past the table's end every position reads its last row
        x = x + params["pos_embed"][torch.clamp(pos, max=cfg.max_seq - 1)
                                    ][:, None]
    x = ctx.constrain(x, TF._RESID)
    for p, spec, entry in zip(params["layers"], TF.layer_specs(cfg),
                              cache["layers"]):
        x = _decode_layer(x, p, cfg, spec, entry, pos, kernel_impl)
    cache["pos"] += 1
    x = L.apply_norm(cfg.norm, x, params["final_norm"])
    return TF._lm_head(params, cfg, x), cache


# ---------------------------------------------------------------------------
# input specs per (arch x shape) cell: meta tensors
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape) -> dict:
    """Abstract inputs for a dry-run cell, on the ``meta`` device (no
    allocation). Keys depend on the shape's kind:

      train:   batch={tokens, targets[, extras]}
      prefill: tokens[, extras]
      decode:  cache (``cache_spec``'s tree), token
    """
    from repro_torch.configs.base import SHAPES

    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S_ = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    def extras():
        ex = {}
        if cfg.vision_tokens:
            ex["vision_embeds"] = meta((B, cfg.vision_tokens, cfg.d_model),
                                       dt)
        if cfg.early_fusion_tokens:
            ex["vision_embeds"] = meta(
                (B, cfg.early_fusion_tokens, cfg.d_model), dt)
        if cfg.audio_frames:
            ex["audio_frames"] = meta((B, cfg.audio_frames, cfg.d_model), dt)
        return ex

    ex = extras()
    if shape.kind == "train":
        batch = {"tokens": meta((B, S_), torch.int32),
                 "targets": meta((B, S_), torch.int32)}
        if ex:
            batch["extras"] = ex
        return {"batch": batch}
    if shape.kind == "prefill":
        out = {"tokens": meta((B, S_), torch.int32)}
        if ex:
            out["extras"] = ex
        return out
    spec = cache_spec(cfg, B, S_)
    cache = {"pos": meta(*spec["pos"]),
             "layers": [{k: meta(*v) for k, v in entry.items()}
                        for entry in spec["layers"]]}
    return {"cache": cache, "token": meta((B, 1), torch.int32)}
